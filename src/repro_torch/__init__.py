"""repro_torch — Parallel Space-Time Kernel Density Estimation in PyTorch/CUDA.

The port of the ``repro`` package to PyTorch on NVIDIA Hopper. It imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and never
``repro``. The sub-packages mirror the reference's layout:

  core        geometry, kernel functions, datasets, bucketing, PB scatter,
              VB / VB-DEC gold standards, api (one-shot and chunked)
  kernels     the hand-written CUDA tile kernel, its plain version, its build script
  data        point streams and chunking for the chunked path
  obs         spans, counters/gauges/histograms, the shared timer
  resilience  typed errors, fault injection, retry, the progress journal,
              the finite-output check
  convert     state carried across from the reference (domain, bucket arrays)

Entry points take ``device=None`` meaning ``"cuda"``; with no CUDA device
that raises ``KernelUnavailableError``. Pass ``device="cpu"`` to run the
plain versions on the host.
"""
__version__ = "0.1.0"
