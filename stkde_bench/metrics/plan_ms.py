"""The tile kernel's host plan, ``kernels/stkde_tile.py::_prepare``: the
loads, ``plan_segments`` and the pinned copy of its table, ms on the host
clock of the ``stkde.tile.plan`` span (median over the profiled queries)."""
from stkde_bench import spans


def read(rec):
    return spans.per_query(rec, spans.host_ms("stkde.tile.plan"))
