"""Plain PyTorch version of the tile kernel.

``stkde_tiles_ref`` computes exactly what the CUDA tile kernel computes —
per-tile density via the PB-SYM separable contraction — with plain tensor
operations on whatever device its inputs live on. It is the allclose target
for the kernel on the card and the path every CPU test runs, and is itself
cross-validated against ``core.pb`` (an independent formulation).

It walks the tiles one by one and each tile's candidate points in panels, so
its memory is bounded by one ``(panel, bx, by)`` block however large the
buckets are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.geometry import Domain
from ..core import kernels_math as km


def stkde_tiles_ref(
    pts_tiles: torch.Tensor,    # (ntx, nty, ntt, cap, 3) f32, overlap-bucketed
    valid_tiles: torch.Tensor,  # (ntx, nty, ntt, cap) f32 {0, 1}
    dom: Domain,
    tile: Tuple[int, int, int],
    n_total: int,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    counts: Optional[torch.Tensor] = None,  # (ntx, nty, ntt) true tile loads
    panel: int = 2048,
) -> torch.Tensor:
    """Padded density grid (ntx*bx, nty*by, ntt*bt); slice to dom.grid_shape.

    With ``counts`` (a bucket holds its valid points first) a tile's walk
    stops after its last valid point; every term is still multiplied by
    ``valid``, and the terms left out are exact zeros, so the sum is the same.
    """
    bx, by, bt = tile
    ntx, nty, ntt, cap = pts_tiles.shape[:4]
    dev = pts_tiles.device
    norm = km.normalization(n_total, dom.hs, dom.ht)

    ix = torch.arange(bx, dtype=torch.float32, device=dev)
    iy = torch.arange(by, dtype=torch.float32, device=dev)
    it = torch.arange(bt, dtype=torch.float32, device=dev)
    # device tensors, so that the divisions are true ones on CUDA too (a
    # Python scalar divisor becomes a multiplication by its reciprocal there)
    hs = torch.tensor(dom.hs, dtype=torch.float32, device=dev)
    ht = torch.tensor(dom.ht, dtype=torch.float32, device=dev)
    loads = None if counts is None else counts.cpu().tolist()

    out = torch.zeros((ntx, bx, nty, by, ntt, bt), dtype=torch.float32,
                      device=dev)
    for ti in range(ntx):
        xc = dom.ox + ((float(ti) * bx + ix) + 0.5) * dom.sres
        for tj in range(nty):
            yc = dom.oy + ((float(tj) * by + iy) + 0.5) * dom.sres
            for tk in range(ntt):
                tc = dom.ot + ((float(tk) * bt + it) + 0.5) * dom.tres
                lim = cap if loads is None else min(cap, loads[ti][tj][tk])
                acc = out[ti, :, tj, :, tk, :]
                for p0 in range(0, lim, panel):
                    pts = pts_tiles[ti, tj, tk, p0:min(p0 + panel, lim)]
                    vld = valid_tiles[ti, tj, tk, p0:min(p0 + panel, lim)]
                    u = (xc[None, :] - pts[:, 0:1]) / hs      # (P, bx)
                    v = (yc[None, :] - pts[:, 1:2]) / hs      # (P, by)
                    w = (tc[None, :] - pts[:, 2:3]) / ht      # (P, bt)
                    Ks = ks(u[:, :, None], v[:, None, :]) * norm  # (P,bx,by)
                    Kt = kt(w) * vld[:, None]                     # (P, bt)
                    acc += torch.einsum("pxy,pt->xyt", Ks, Kt)
    return out.reshape(ntx * bx, nty * by, ntt * bt)
