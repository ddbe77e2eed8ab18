"""The least time a query could take, counted from its inputs alone.

A query's work is fixed by its points and its domain, whatever implements
it: every (point, voxel) pair inside the grid at which both ``Ks`` and
``Kt`` are non-zero costs a multiply and an add, every point is read once
(12 bytes) and every voxel of the grid written once (4 bytes). No tile
shape, padding, replication or split of the arithmetic enters the count,
so a program that walks fewer zeros lowers its time and not its yardstick.

    operations = 2 * support pairs
    bytes      = 12 * n + 4 * Gx * Gy * Gt
    least time = max(operations / peak FLOP/s, bytes / peak bytes/s)

The peaks are the card's data sheet's (``peaks.json``); a card not in that
table has no least time, and the metrics that need one are left out.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .reference.pbsym import Box

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def _in_open_interval(lo: torch.Tensor, hi: torch.Tensor,
                      size: int) -> torch.Tensor:
    """How many integers ``k`` in ``[0, size)`` satisfy ``lo < k < hi``."""
    first = torch.clamp(torch.floor(lo) + 1, min=0)
    last = torch.clamp(torch.ceil(hi) - 1, max=size - 1)
    return torch.clamp(last - first + 1, min=0)


def support_pairs(points: np.ndarray, box: Box, device="cpu",
                  block: int = 1 << 16) -> int:
    """(point, voxel) pairs inside the grid where ``u^2 + v^2 < 1`` and
    ``|w| < 1``, in float64: per point, the voxels of the temporal bar
    times, per column ``X`` of the disk, the rows ``Y`` of its chord."""
    pts = torch.as_tensor(np.ascontiguousarray(points, dtype=np.float32)
                          ).to(device, torch.float64)
    f64 = dict(dtype=torch.float64, device=pts.device)
    span = int(np.ceil(2 * box.hs / box.sres)) + 2
    offs = torch.arange(span, **f64)
    total = 0
    for p0 in range(0, len(pts), block):
        p = pts[p0:p0 + block]
        # voxels T of the bar: |ot + (T + 0.5) tres - t| < ht
        t = (p[:, 2] - box.ot) / box.tres - 0.5
        nt = _in_open_interval(t - box.ht / box.tres, t + box.ht / box.tres,
                               box.Gt)
        # columns X with |x_c - x| < hs, then the chord in Y at each
        x = (p[:, 0:1] - box.ox) / box.sres - 0.5
        X = torch.floor(x - box.hs / box.sres) + 1 + offs        # (B, span)
        dx = box.ox + (X + 0.5) * box.sres - p[:, 0:1]
        inside = (dx.abs() < box.hs) & (X >= 0) & (X < box.Gx)
        ry = torch.sqrt(torch.clamp(box.hs * box.hs - dx * dx, min=0.0))
        y = (p[:, 1:2] - box.oy) / box.sres - 0.5
        ny = _in_open_interval(y - ry / box.sres, y + ry / box.sres, box.Gy)
        nxy = torch.where(inside, ny, 0.0).sum(dim=1)
        total += int((nxy * nt).sum())
    return total


def peaks(kind: str) -> Optional[dict]:
    """The data sheet's peaks of the card named ``kind``, if the table has
    it."""
    return json.loads(PEAKS.read_text()).get(kind)


def least_time(points: np.ndarray, box: Box, kind: str,
               device="cpu") -> Optional[dict]:
    """The least time of one query on the card ``kind``: seconds, which of
    operations or bytes bounds it, and the counts it came from."""
    peak = peaks(kind)
    if peak is None:
        return None
    pairs = support_pairs(points, box, device)
    ops = 2 * pairs
    nbytes = 12 * len(points) + 4 * box.voxels
    t_ops = ops / peak["flops_per_s"]
    t_bytes = nbytes / peak["bytes_per_s"]
    return {"seconds": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "support_pairs": pairs, "operations": ops, "bytes": nbytes,
            "operations_s": t_ops, "bytes_s": t_bytes}
