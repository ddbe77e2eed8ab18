"""Voxel-based STKDE algorithms: VB (gold standard) and VB-DEC.

``VB`` follows Algorithm 1 of the paper verbatim: for every voxel, scan all
points, test the cylinder condition, and accumulate the kernel product.
Complexity Theta(Gx*Gy*Gt*n) — it exists as the correctness gold standard and
as the slow baseline of Table 3.

``VB-DEC`` is the paper's improved voxel-based variant: points are bucketed
into bandwidth-sized cells so each voxel only tests points that can reach it
(the 3x3x3 neighborhood of its cell). It shares the bucketing substrate with
the tile kernel (``core/bucketing.py``).

Both are plain PyTorch on whatever device they are given. The reference
computes a whole time slice ``(Gx, Gy, n)`` or every tile at once; here the
work is cut into panels of at most ``budget_elems`` values (points of a
slice, tiles of VB-DEC) so that a full-size row of Table 2 fits on one card.
Quotients that feed a support test divide by 0-dim tensors on the device,
so they are true divisions on CUDA too.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .geometry import Domain
from . import kernels_math as km
from . import bucketing
from .pb import _as_points


def _scalar(x: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _vb_slice(u, v, w, valid, ks, kt):
    """Density of one temporal slice, (Gx, Gy), over one panel of points.

    u: (Gx, p), v: (Gy, p) spatial offsets / hs; w: (p,) temporal offsets /
    ht; valid: (p,). The cylinder test is evaluated per voxel exactly as
    Algorithm 1 does.
    """
    ksv = ks(u[:, None, :], v[None, :, :])            # (Gx, Gy, p)
    ktv = kt(w)                                       # (p,)
    contrib = ksv * (ktv * valid)[None, None, :]
    return contrib.sum(dim=-1)


def vb(
    points,
    dom: Domain,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    budget_elems: int = 1 << 26,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Gold-standard voxel-based STKDE. Returns a (Gx, Gy, Gt) fp32 grid on
    ``device`` (``None`` means ``"cuda"``).

    Each slice sums its points in panels of at most ``budget_elems //
    (Gx*Gy)`` points; a panel is summed as the reference sums a slice, and
    the panels' sums are added in point order.
    """
    pts = _as_points(points, device)
    dev = pts.device
    n = pts.shape[0]
    Gx, Gy, Gt = dom.grid_shape
    hs, ht = _scalar(dom.hs, dev), _scalar(dom.ht, dev)
    xc = dom.voxel_centers_x(dev)
    yc = dom.voxel_centers_y(dev)
    tcs = dom.voxel_centers_t(dev)
    valid = torch.ones((n,), dtype=torch.float32, device=dev)
    norm = km.normalization(n, dom.hs, dom.ht)
    u = (xc[:, None] - pts[None, :, 0]) / hs         # (Gx, n)
    v = (yc[:, None] - pts[None, :, 1]) / hs         # (Gy, n)
    step = max(1, budget_elems // (Gx * Gy))
    out = torch.empty((Gx, Gy, Gt), dtype=torch.float32, device=dev)
    for it in range(Gt):
        w = (tcs[it] - pts[:, 2]) / ht               # (n,)
        s = None
        for a in range(0, n, step):
            b = min(a + step, n)
            part = _vb_slice(u[:, a:b], v[:, a:b], w[a:b], valid[a:b], ks,
                             kt)
            s = part if s is None else s + part
        out[:, :, it] = s * norm
    return out


def _vb_dec_impl(pts_tiles: torch.Tensor, valid_tiles: torch.Tensor,
                 dom: Domain, ks, kt, tile, n_total: int,
                 budget_elems: int) -> torch.Tensor:
    """Per-tile VB over bucketed candidate points, batches of tiles at once.

    pts_tiles: (ntx, nty, ntt, cap, 3); valid: (ntx, nty, ntt, cap).
    """
    bx, by, bt = tile
    ntx, nty, ntt, cap = valid_tiles.shape
    dev = pts_tiles.device
    norm = km.normalization(n_total, dom.hs, dom.ht)
    hs, ht = _scalar(dom.hs, dev), _scalar(dom.ht, dev)
    ntiles = ntx * nty * ntt
    pts = pts_tiles.reshape(ntiles, cap, 3)
    vld = valid_tiles.reshape(ntiles, cap)
    ids = torch.arange(ntiles, device=dev)
    tix, tiy, tit = ids // (nty * ntt), (ids // ntt) % nty, ids % ntt
    ax = torch.arange(bx, dtype=torch.float32, device=dev)
    ay = torch.arange(by, dtype=torch.float32, device=dev)
    at = torch.arange(bt, dtype=torch.float32, device=dev)
    tiles = torch.empty((ntiles, bx, by, bt), dtype=torch.float32,
                        device=dev)
    step = max(1, budget_elems // (bx * by * cap))
    for a in range(0, ntiles, step):
        s = slice(a, min(a + step, ntiles))
        p = pts[s]                                              # (T, cap, 3)
        # voxel centers of these tiles
        xc = dom.ox + ((tix[s] * bx)[:, None] + ax + 0.5) * dom.sres
        yc = dom.oy + ((tiy[s] * by)[:, None] + ay + 0.5) * dom.sres
        tc = dom.ot + ((tit[s] * bt)[:, None] + at + 0.5) * dom.tres
        u = (xc[:, :, None] - p[:, None, :, 0]) / hs            # (T, bx, cap)
        v = (yc[:, :, None] - p[:, None, :, 1]) / hs            # (T, by, cap)
        w = (tc[:, :, None] - p[:, None, :, 2]) / ht            # (T, bt, cap)
        ksv = ks(u[:, :, None, :], v[:, None, :, :])       # (T, bx, by, cap)
        ktv = kt(w) * vld[s][:, None, :]                        # (T, bt, cap)
        tiles[s] = torch.einsum("sxyp,stp->sxyt", ksv, ktv) * norm
    grid = tiles.reshape(ntx, nty, ntt, bx, by, bt).permute(
        0, 3, 1, 4, 2, 5).reshape(ntx * bx, nty * by, ntt * bt)
    return grid[: dom.Gx, : dom.Gy, : dom.Gt]


def vb_dec(
    points,
    dom: Domain,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    tile: Optional[tuple] = None,
    cap: Optional[int] = None,
    budget_elems: int = 1 << 26,
    device: DeviceLike = None,
) -> torch.Tensor:
    """VB with bandwidth-sized point decomposition (paper's VB-DEC).

    Buckets points with cylinder overlap into tiles (>= bandwidth sized) on
    the host, then runs the voxel scan per tile against only candidate
    points, on ``device`` (``None`` means ``"cuda"``), in batches of tiles
    whose ``(tiles, bx, by, cap)`` panel holds at most ``budget_elems``
    values (at least one tile). Each tile's contraction is one
    ``einsum("xyp,tp->xyt")``, as in the reference.
    """
    dev = resolve_device(device)
    pts = np.asarray(points, dtype=np.float32)
    if tile is None:
        tile = bucketing.default_tile(dom)
    b = bucketing.bucket_points_overlap(pts, dom, tile, cap=cap)
    return _vb_dec_impl(
        torch.from_numpy(b.points).to(dev),
        torch.from_numpy(b.valid.astype(np.float32)).to(dev),
        dom, ks, kt, tuple(tile), pts.shape[0], budget_elems,
    )
