"""The comparison that decides ``correct``.

One number per grid: the largest gap between the program's grid ``p`` and
the reference's ``r`` over every voxel, each gap measured against the
voxel's own reference value or, where that is smaller, against a quarter of
one point's peak contribution ``tau``:

    grid_err = max over voxels of |p - r| / max(|r|, tau)

Where real density lies the number is a relative error, which a grid
computed in a lower precision misses by the rounding of its terms; where the
reference is (near) zero, as in the tiles that hold no point, it is the
absolute value there in units of ``tau``. A non-finite voxel reads ``inf``.
The limit of each cell, and the readings it was set from, are in
``limits/<cell>.json``.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .reference.kernels import KS_PEAK, KT_PEAK, normalization
from .reference.pbsym import Box, block_density, selections

# program(xs, ys, points of the block) -> the block of its grid
Blocks = Callable[[slice, slice, torch.Tensor], torch.Tensor]


def tau(box: Box, n: int) -> float:
    """A quarter of one point's peak contribution to the density."""
    return 0.25 * KS_PEAK * KT_PEAK * normalization(n, box.hs, box.ht)


def grid_err(program: Blocks, points: np.ndarray, box: Box,
             device) -> float:
    """``grid_err`` of the blocks that ``program`` gives (any float dtype,
    any device) against the float64 reference worked out from ``points``."""
    n = len(points)
    scale = tau(box, n)
    worst = 0.0
    for xs, ys, sel in selections(points, box, device):
        ref = block_density(sel, box, (xs.start, xs.stop),
                            (ys.start, ys.stop), n, "float64")
        got = program(xs, ys, sel).to(ref.device, torch.float64)
        if not bool(torch.isfinite(got).all()):
            return math.inf
        gap = (got - ref).abs() / ref.abs().clamp_min(scale)
        worst = max(worst, float(gap.max()))
    return worst


def of_grid(grid: torch.Tensor) -> Blocks:
    """The blocks of a whole grid ``(Gx, Gy, Gt)`` the program returned."""
    return lambda xs, ys, sel: grid[xs, ys, :]


def control(box: Box, n: int) -> Blocks:
    """The control in the program's place: the reference in TF32."""
    return lambda xs, ys, sel: block_density(
        sel, box, (xs.start, xs.stop), (ys.start, ys.stop), n, "tf32")
