"""Plain PB-SYM density, block by block: what the benchmark holds the
program's grids against.

PB-SYM (the paper's Algorithm 3) adds, for every point ``p``, the outer
product of its spatial disk ``Ks_p[X, Y]`` and its temporal bar
``Kt_p[T]``. Over a block of columns ``(X, Y)`` and the whole of ``T`` that
sum is one matrix product: ``block = Ks^T @ Kt`` over the points whose
support reaches the block. Each block is worked out from the points alone,
in float64, with plain tensor operations, and handed to the caller, so that
a grid of any size is compared without a second grid in memory.

``precision="tf32"`` is the control: the same sum with every ``Ks`` and
``Kt`` value rounded to TF32 (10 bits of mantissa) before the products, and
float32 sums, which is what a contraction in one TF32 pass computes. It must
fail the comparison that the program passes.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

from .kernels import ks_epanechnikov, kt_epanechnikov, normalization

PRECISIONS = ("float64", "tf32")


class Box(NamedTuple):
    """The grid of a query: voxel ``(X, Y, T)`` samples the domain at its
    centre ``origin + (index + 0.5) * res``; ``hs``, ``ht`` in domain
    units."""

    Gx: int
    Gy: int
    Gt: int
    sres: float
    tres: float
    hs: float
    ht: float
    ox: float = 0.0
    oy: float = 0.0
    ot: float = 0.0

    @property
    def voxels(self) -> int:
        return self.Gx * self.Gy * self.Gt


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _centres(lo: int, hi: int, origin: float, res: float,
             dtype, device) -> torch.Tensor:
    idx = torch.arange(lo, hi, dtype=torch.float64, device=device)
    return (origin + (idx + 0.5) * res).to(dtype)


def block_density(pts: torch.Tensor, box: Box, xs: Tuple[int, int],
                  ys: Tuple[int, int], n_total: int, precision: str,
                  budget: int = 1 << 25) -> torch.Tensor:
    """Density of columns ``xs[0]:xs[1]`` x ``ys[0]:ys[1]`` over all of T,
    from ``pts`` (float32, ``(P, 3)``, on the device it runs on) of a set of
    ``n_total`` points: float64, or float32 for the control."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    dev = pts.device
    dt = torch.float64 if precision == "float64" else torch.float32
    xc = _centres(*xs, box.ox, box.sres, dt, dev)
    yc = _centres(*ys, box.oy, box.sres, dt, dev)
    tc = _centres(0, box.Gt, box.ot, box.tres, dt, dev)
    hs = torch.tensor(box.hs, dtype=dt, device=dev)
    ht = torch.tensor(box.ht, dtype=dt, device=dev)
    norm = normalization(n_total, box.hs, box.ht)
    bx, by = len(xc), len(yc)
    out = torch.zeros((bx * by, box.Gt), dtype=dt, device=dev)
    step = max(64, budget // (bx * by + box.Gt))
    for p0 in range(0, len(pts), step):
        p = pts[p0:p0 + step].to(dt)
        u = (xc[None, :] - p[:, 0:1]) / hs                       # (P, bx)
        v = (yc[None, :] - p[:, 1:2]) / hs                       # (P, by)
        w = (tc[None, :] - p[:, 2:3]) / ht                       # (P, Gt)
        ks = (ks_epanechnikov(u[:, :, None], v[:, None, :]) * norm
              ).reshape(len(p), bx * by)
        kt = kt_epanechnikov(w)
        if precision == "tf32":
            # products of two TF32 values are exact in float32
            ks, kt = round_tf32(ks), round_tf32(kt)
        out += ks.T @ kt
    return out.reshape(bx, by, box.Gt)


def selections(points: np.ndarray, box: Box, device, block: int = 32
               ) -> Iterator[Tuple[slice, slice, torch.Tensor]]:
    """``(xslice, yslice, points)`` for every block of ``block`` x ``block``
    columns of the grid: the points (float32, on ``device``) whose support
    can reach the block, selected by their coordinates."""
    pts = torch.as_tensor(np.ascontiguousarray(points, dtype=np.float32)
                          ).to(device)
    px = pts[:, 0].to(torch.float64)
    py = pts[:, 1].to(torch.float64)
    for x0 in range(0, box.Gx, block):
        x1 = min(x0 + block, box.Gx)
        lo, hi = box.ox + x0 * box.sres, box.ox + x1 * box.sres
        in_x = torch.nonzero((px > lo - box.hs) & (px < hi + box.hs)
                             ).reshape(-1)
        pyx = py[in_x]
        for y0 in range(0, box.Gy, block):
            y1 = min(y0 + block, box.Gy)
            lo, hi = box.oy + y0 * box.sres, box.oy + y1 * box.sres
            sel = in_x[(pyx > lo - box.hs) & (pyx < hi + box.hs)]
            yield slice(x0, x1), slice(y0, y1), pts[sel]
