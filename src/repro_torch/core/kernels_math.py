"""Kernel (distance-decay) functions for STKDE.

The paper's inline formulas are typo'd versions of the product Epanechnikov
kernels used by the gold standard it cites ([HDTC16], [NY10]); we implement
the literature forms:

    ks(u, v) = 2/pi * (1 - (u^2 + v^2))^2        for u^2 + v^2 < 1, else 0
    kt(w)    = 3/4  * (1 - w^2)                  for |w| < 1,       else 0

Both are kept pluggable: every algorithm takes ``ks`` / ``kt`` callables so
alternative kernels can be swapped in. The structural property every
algorithm relies on is *separability*:
``contribution(X, Y, T) = Ks(X, Y) * Kt(T)``.

The CUDA kernels (tile and scatter) cannot call a Python function: they
switch on an integer id. ``KERNEL_IDS`` maps each callable above to that id; ``spatial_kernel_id``
/ ``temporal_kernel_id`` look one up and refuse a callable the kernel does
not know.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..resilience.errors import KernelUnavailableError

Array = torch.Tensor
SpatialKernel = Callable[[Array, Array], Array]
TemporalKernel = Callable[[Array], Array]


def ks_epanechnikov(u: Array, v: Array) -> Array:
    """2-D quartic (Epanechnikov-type) spatial kernel, zero outside unit disk."""
    r2 = u * u + v * v
    val = (2.0 / math.pi) * torch.square(1.0 - r2)
    return torch.where(r2 < 1.0, val, 0.0)


def kt_epanechnikov(w: Array) -> Array:
    """1-D Epanechnikov temporal kernel, zero outside |w| < 1."""
    val = 0.75 * (1.0 - w * w)
    return torch.where(torch.abs(w) < 1.0, val, 0.0)


def ks_paper_verbatim(u: Array, v: Array) -> Array:
    """The paper's inline formula, kept for completeness/ablation.

    ``pi/2 (1-u)^2 (1-v)^2`` with the support restricted (as the paper's
    summation condition says) to the unit disk. Not zero at the edge of its
    support.
    """
    r2 = u * u + v * v
    val = (math.pi / 2.0) * torch.square(1.0 - u) * torch.square(1.0 - v)
    return torch.where(r2 < 1.0, val, 0.0)


def kt_paper_verbatim(w: Array) -> Array:
    val = 0.75 * torch.square(1.0 - w)
    return torch.where(torch.abs(w) < 1.0, val, 0.0)


DEFAULT_KS: SpatialKernel = ks_epanechnikov
DEFAULT_KT: TemporalKernel = kt_epanechnikov

# The integers `csrc/stkde_tile.cu` and `csrc/stkde_scatter.cu` switch on
# (KS_* / KT_* there).
KERNEL_IDS: Dict[Callable, int] = {
    ks_epanechnikov: 0,
    ks_paper_verbatim: 1,
    kt_epanechnikov: 0,
    kt_paper_verbatim: 1,
}
_SPATIAL = (ks_epanechnikov, ks_paper_verbatim)
_TEMPORAL = (kt_epanechnikov, kt_paper_verbatim)


def _kernel_id(fn: Callable, known, role: str) -> int:
    if fn not in known:
        names = ", ".join(f.__name__ for f in known)
        raise KernelUnavailableError(
            f"the CUDA kernels have no id for {role}="
            f"{getattr(fn, '__name__', fn)!r} (it knows: {names}); run it on "
            "CPU tensors, where the plain version takes any callable"
        )
    return KERNEL_IDS[fn]


def spatial_kernel_id(ks: SpatialKernel) -> int:
    return _kernel_id(ks, _SPATIAL, "ks")


def temporal_kernel_id(kt: TemporalKernel) -> int:
    return _kernel_id(kt, _TEMPORAL, "kt")


def known_to_kernels(ks: SpatialKernel, kt: TemporalKernel) -> bool:
    """Whether the CUDA kernels have an id for both ``ks`` and ``kt``."""
    return ks in _SPATIAL and kt in _TEMPORAL


def normalization(n: int, hs: float, ht: float) -> float:
    """1 / (n hs^2 ht) — folded into Ks by the PB-SYM algorithms."""
    return 1.0 / (float(n) * hs * hs * ht)
