"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness.py`` is the
run. What belongs to one configuration, traffic mix or metric is found by
its name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (the
program's entry and keyword arguments, the bandwidths, the staged
breakdown it names), ``staged/<name>.py`` (a ``run`` that times one query
stage by stage), ``limits/<cell>.json``, ``metrics/<metric>.py`` (a
``read(record)``). The
yardstick lives here too: the inputs (``gen/``), the plain reference and
the comparison that decides ``correct`` (``reference/``, ``check.py``), the
least time counted from the inputs (``roofline.py``, ``peaks.json``) and
the reading of the device trace (``devtrace.py``). ``control.py`` reads
what each limit was set from. Nothing here imports JAX or the JAX package.
"""
