"""repro_torch — Parallel Space-Time Kernel Density Estimation in PyTorch/CUDA.

The port of the ``repro`` package to PyTorch on NVIDIA Hopper. It imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and never
``repro``. The sub-packages mirror the reference's layout:

  core        geometry, kernel functions, datasets, bucketing, PB scatter,
              VB / VB-DEC gold standards, coloring, the strategy planner,
              api (one-shot and chunked, one device or a mesh)
  kernels     the hand-written CUDA tile kernel, its plain version, its build script
  distributed meshes of shards, their collectives, the seven multi-device
              strategies, LPT placement, the language models' sharding
              rules
  data        the synthetic token stream of the language models; point
              streams and chunking for the chunked path
  obs         spans, counters/gauges/histograms, the shared timer, the
              planner's reconciliation
  resilience  typed errors, fault injection, retry, the progress journal,
              the finite-output check, the degrade ladder
  models      the ten language-model architectures (plain PyTorch ops;
              the MoE layer's expert-parallel all-to-all on a mesh)
  configs     their configurations and the ``reduced`` smoke variants
  serve       the language-model serving engine (slot-swap continuous
              batching, bucketed), partial STKDE answers from a journal
  train       optimizer, train step (one device or a mesh), checkpoints,
              the training runner, int8 gradient compression
  launch      the train and serve command lines, production mesh shapes,
              shape cells, roofline arithmetic
  convert     state carried across from the reference (domain, bucket
              arrays, language-model weights and optimizer moments)

Entry points take ``device=None`` meaning ``"cuda"``; with no CUDA device
that raises ``KernelUnavailableError``. Pass ``device="cpu"`` to run the
plain versions on the host.
"""
__version__ = "0.1.0"
