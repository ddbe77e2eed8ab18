"""Plain PyTorch version of the tile kernel.

``stkde_tiles_ref`` computes exactly what the CUDA tile kernel computes —
per-tile density via the PB-SYM separable contraction — with plain tensor
operations on whatever device its inputs live on. It is the allclose target
for the kernel on the card and the path every CPU test runs, and is itself
cross-validated against ``core.pb`` (an independent formulation).

It reads the packed overlap buckets the kernel reads, walks the tiles one by
one and each tile's run of points in panels, so its memory is bounded by one
``(panel, bx, by)`` block however many points a tile holds.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import bucketing
from ..core.geometry import Domain
from ..core import kernels_math as km


def stkde_tiles_ref(
    points: torch.Tensor,   # (copies, 3) f32, packed overlap buckets
    offsets: torch.Tensor,  # (ntiles + 1,) int64: each tile's run
    dom: Domain,
    tile: Tuple[int, int, int],
    n_total: int,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    panel: int = 2048,
) -> torch.Tensor:
    """Padded density grid (ntx*bx, nty*by, ntt*bt); slice to dom.grid_shape.

    Tile ``t``'s points are ``points[offsets[t]:offsets[t + 1]]``; the tiles
    are ``bucketing.num_tiles(dom, tile)``, in row-major order.
    """
    bx, by, bt = tile
    ntx, nty, ntt = bucketing.num_tiles(dom, tile)
    if offsets.shape != (ntx * nty * ntt + 1,):
        raise ValueError(
            f"offsets must hold {ntx * nty * ntt + 1} values for "
            f"{ntx}x{nty}x{ntt} tiles; got {tuple(offsets.shape)}")
    dev = points.device
    norm = km.normalization(n_total, dom.hs, dom.ht)

    ix = torch.arange(bx, dtype=torch.float32, device=dev)
    iy = torch.arange(by, dtype=torch.float32, device=dev)
    it = torch.arange(bt, dtype=torch.float32, device=dev)
    # device tensors, so that the divisions are true ones on CUDA too (a
    # Python scalar divisor becomes a multiplication by its reciprocal there)
    hs = torch.tensor(dom.hs, dtype=torch.float32, device=dev)
    ht = torch.tensor(dom.ht, dtype=torch.float32, device=dev)
    runs = offsets.cpu().tolist()

    out = torch.zeros((ntx, bx, nty, by, ntt, bt), dtype=torch.float32,
                      device=dev)
    t = 0
    for ti in range(ntx):
        xc = dom.ox + ((float(ti) * bx + ix) + 0.5) * dom.sres
        for tj in range(nty):
            yc = dom.oy + ((float(tj) * by + iy) + 0.5) * dom.sres
            for tk in range(ntt):
                tc = dom.ot + ((float(tk) * bt + it) + 0.5) * dom.tres
                first, stop = runs[t], runs[t + 1]
                t += 1
                acc = out[ti, :, tj, :, tk, :]
                for p0 in range(first, stop, panel):
                    pts = points[p0:min(p0 + panel, stop)]
                    u = (xc[None, :] - pts[:, 0:1]) / hs      # (P, bx)
                    v = (yc[None, :] - pts[:, 1:2]) / hs      # (P, by)
                    w = (tc[None, :] - pts[:, 2:3]) / ht      # (P, bt)
                    Ks = ks(u[:, :, None], v[:, None, :]) * norm  # (P,bx,by)
                    Kt = kt(w)                                    # (P, bt)
                    acc += torch.einsum("pxy,pt->xyt", Ks, Kt)
    return out.reshape(ntx * bx, nty * by, ntt * bt)
