"""The one shared benchmark timer.

``timeit`` does warmup, waiting for the device and span/metric recording in
one place. PyTorch returns from a CUDA call before the card has finished, so
a result that holds CUDA tensors is waited for (``torch.cuda.synchronize``
on their devices) before the clock is read; a result on the CPU, or a plain
Python value, is not waited for and never initialises CUDA.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, List, Optional

import torch

from . import metrics, trace


def _cuda_devices(x: Any, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    elif hasattr(x, "pieces"):          # distributed.sharding.Sharded
        for v in x.pieces.flat:
            _cuda_devices(v, found)
    return found


def block_until_ready(x: Any) -> Any:
    """Wait until the card has finished every CUDA tensor in ``x`` (walking
    tuples, lists, dicts and the pieces of sharded leaves); identity for
    anything else."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
        trace.count_sync()
    return x


@dataclasses.dataclass
class TimingResult:
    name: str
    times: List[float]                 # per-rep seconds, in run order

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return statistics.fmean(self.times)

    @property
    def median(self) -> float:
        return statistics.median(self.times)


def timeit(
    fn: Callable[[], Any],
    reps: int = 3,
    warmup: int = 1,
    name: Optional[str] = None,
    block: bool = True,
    **attrs,
) -> TimingResult:
    """Time ``fn()`` over ``reps`` measured calls after ``warmup`` calls.

    Each measured rep is recorded as a span ``bench.<name>`` (attr
    ``rep=i``) and observed into histogram ``<name>_s`` when ``name`` is
    given. Returns all rep times; callers pick ``.best`` (min) or
    ``.median``.
    """
    label = name or getattr(fn, "__name__", "anon")
    for _ in range(max(0, warmup)):
        out = fn()
        if block:
            block_until_ready(out)
    times = []
    hist = metrics.histogram(f"{label}_s") if name else None
    for i in range(max(1, reps)):
        with trace.span(f"bench.{label}", rep=i, **attrs):
            t0 = time.perf_counter()
            out = fn()
            if block:
                block_until_ready(out)
            dt = time.perf_counter() - t0
        times.append(dt)
        if hist is not None:
            hist.observe(dt)
    return TimingResult(name=label, times=times)
