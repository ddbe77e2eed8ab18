"""The kernel functions and the normalisation: frozen copies.

Copied from ``repro_torch/core/kernels_math.py`` (the literature forms of the
product Epanechnikov kernels the paper cites):

    ks(u, v) = 2/pi * (1 - (u^2 + v^2))^2        for u^2 + v^2 < 1, else 0
    kt(w)    = 3/4  * (1 - w^2)                  for |w| < 1,       else 0

and the density's factor ``1 / (n hs^2 ht)``. They work in the dtype of their
arguments, so the reference evaluates them in float64.
"""
from __future__ import annotations

import math

import torch

KS_PEAK = 2.0 / math.pi
KT_PEAK = 0.75


def ks_epanechnikov(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    r2 = u * u + v * v
    return torch.where(r2 < 1.0, KS_PEAK * torch.square(1.0 - r2), 0.0)


def kt_epanechnikov(w: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(w) < 1.0, KT_PEAK * (1.0 - w * w), 0.0)


def normalization(n: int, hs: float, ht: float) -> float:
    return 1.0 / (float(n) * hs * hs * ht)
