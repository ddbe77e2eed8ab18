"""Point -> tile bucketing (host-side data preparation).

The tiled STKDE paths (the CUDA tile kernel and, later, the DD/PD
strategies and VB-DEC) all consume *capacity-padded dense buckets*: a
(ntx, nty, ntt, cap, 3) array of points plus a validity mask. Scatter becomes
dense per-tile compute. A tile's valid points come first in its bucket, so
``counts`` tells a consumer where the real points end.

Two bucketing modes:
  * ``home``    — each point appears exactly once, in the tile containing its
                  voxel (work-efficient; used by PD / owner-computes).
  * ``overlap`` — each point appears in every tile its bandwidth cylinder's
                  bounding box intersects (DD-style replication; makes each
                  tile self-contained at the cost of cut-cylinder work
                  overhead — the exact overhead the paper measures in Fig. 9).

Each mode has two implementations of one algorithm: numpy arrays are
bucketed on the host, as the reference does, and a torch tensor is bucketed
on its own device (the CUDA main path copies its ``(n, 3)`` points to the
card once and builds the buckets there). Both give the same bits: voxels
in float64, copies enumerated point-major over the same offsets, a stable
sort on the tile id, loads from a bincount.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..obs import trace as obs_trace
from .geometry import Domain


Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class Buckets:
    """Numpy arrays when bucketed on the host, tensors on the points' device
    when bucketed from a tensor."""

    points: Array  # (ntx, nty, ntt, cap, 3) float32
    valid: Array   # (ntx, nty, ntt, cap) bool
    counts: Array  # (ntx, nty, ntt) int64 — true per-tile loads
    tile: Tuple[int, int, int]
    cap: int
    mode: str
    copies: int = 0  # point copies in all buckets: the sum of ``counts``
    n_source: int = 1

    @property
    def ntiles(self) -> Tuple[int, int, int]:
        return tuple(int(d) for d in self.points.shape[:3])

    @property
    def replication_factor(self) -> float:
        """Average copies per point (1.0 for home; >1 measures DD overhead)."""
        return self.copies / max(1, self.n_source)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_tile(dom: Domain) -> Tuple[int, int, int]:
    """A tile at least as large as the bandwidth cylinder bbox, 8-aligned."""
    bx = min(round_up(dom.Gx, 8), round_up(2 * dom.Hs + 1, 8))
    by = min(round_up(dom.Gy, 8), round_up(2 * dom.Hs + 1, 8))
    bt = min(round_up(dom.Gt, 4), round_up(2 * dom.Ht + 1, 4))
    return (bx, by, bt)


def num_tiles(dom: Domain, tile: Tuple[int, int, int]) -> Tuple[int, int, int]:
    bx, by, bt = tile
    return (
        math.ceil(dom.Gx / bx),
        math.ceil(dom.Gy / by),
        math.ceil(dom.Gt / bt),
    )


def _point_voxels_np(pts: np.ndarray, dom: Domain) -> np.ndarray:
    idx = np.floor(
        (pts - np.array([dom.ox, dom.oy, dom.ot]))
        / np.array([dom.sres, dom.sres, dom.tres])
    ).astype(np.int64)
    hi = np.array([dom.Gx - 1, dom.Gy - 1, dom.Gt - 1])
    return np.clip(idx, 0, hi)


def _densify(
    tile_ids: np.ndarray,
    pts_rep: np.ndarray,
    nt: Tuple[int, int, int],
    cap: Optional[int],
    n_source: int,
    tile: Tuple[int, int, int],
    mode: str,
) -> Buckets:
    """Build the capacity-padded dense layout from (point copy -> tile id)."""
    ntx, nty, ntt = nt
    ntiles_flat = ntx * nty * ntt
    counts = np.bincount(tile_ids, minlength=ntiles_flat)
    true_cap = int(counts.max()) if counts.size else 0
    if cap is None:
        cap = max(8, round_up(max(true_cap, 1), 8))
    elif true_cap > cap:
        raise ValueError(
            f"bucket capacity {cap} < max tile load {true_cap}; "
            "raise cap or use a finer decomposition"
        )
    order = np.argsort(tile_ids, kind="stable")
    sorted_ids = tile_ids[order]
    sorted_pts = pts_rep[order]
    # position of each copy within its bucket
    starts = np.zeros(ntiles_flat + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(len(sorted_ids)) - starts[sorted_ids]

    points = np.zeros((ntiles_flat, cap, 3), dtype=np.float32)
    valid = np.zeros((ntiles_flat, cap), dtype=bool)
    points[sorted_ids, within] = sorted_pts
    valid[sorted_ids, within] = True

    return Buckets(
        points=points.reshape(ntx, nty, ntt, cap, 3),
        valid=valid.reshape(ntx, nty, ntt, cap),
        counts=counts.reshape(ntx, nty, ntt),
        tile=tile,
        cap=cap,
        mode=mode,
        copies=len(tile_ids),
        n_source=n_source,
    )


def _point_voxels_torch(pts: torch.Tensor, dom: Domain) -> torch.Tensor:
    """``_point_voxels_np`` on the points' device, with the same bits: the
    float32 points widen to float64 and are divided by a float64 tensor
    (not a Python scalar, which CUDA would turn into a multiplication by
    its reciprocal)."""
    f64 = dict(dtype=torch.float64, device=pts.device)
    origin = torch.tensor([dom.ox, dom.oy, dom.ot], **f64)
    res = torch.tensor([dom.sres, dom.sres, dom.tres], **f64)
    idx = torch.floor((pts.to(torch.float64) - origin) / res).to(torch.int64)
    hi = torch.tensor([dom.Gx - 1, dom.Gy - 1, dom.Gt - 1],
                      dtype=torch.int64, device=pts.device)
    return torch.clamp(idx, min=torch.zeros_like(hi), max=hi)


def _densify_torch(
    tile_ids: torch.Tensor,
    pts_rep: torch.Tensor,
    nt: Tuple[int, int, int],
    cap: Optional[int],
    n_source: int,
    tile: Tuple[int, int, int],
    mode: str,
) -> Buckets:
    """``_densify`` on the device of ``tile_ids``: the stable sort keeps each
    bucket in the order of the copies, as ``np.argsort(kind="stable")``.
    The largest load is the one number read back here; the number of copies
    is ``tile_ids``' length, known on the host."""
    ntx, nty, ntt = nt
    ntiles_flat = ntx * nty * ntt
    dev = tile_ids.device
    counts = torch.bincount(tile_ids, minlength=ntiles_flat)
    true_cap = int(counts.max()) if counts.numel() else 0
    if cap is None:
        cap = max(8, round_up(max(true_cap, 1), 8))
    elif true_cap > cap:
        raise ValueError(
            f"bucket capacity {cap} < max tile load {true_cap}; "
            "raise cap or use a finer decomposition"
        )
    sorted_ids, order = torch.sort(tile_ids, stable=True)
    sorted_pts = pts_rep[order]
    starts = torch.zeros(ntiles_flat + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    within = torch.arange(len(sorted_ids), device=dev) - starts[sorted_ids]

    points = torch.zeros((ntiles_flat, cap, 3), dtype=torch.float32,
                         device=dev)
    valid = torch.zeros((ntiles_flat, cap), dtype=torch.bool, device=dev)
    points[sorted_ids, within] = sorted_pts
    valid[sorted_ids, within] = True

    return Buckets(
        points=points.reshape(ntx, nty, ntt, cap, 3),
        valid=valid.reshape(ntx, nty, ntt, cap),
        counts=counts.reshape(ntx, nty, ntt),
        tile=tile,
        cap=cap,
        mode=mode,
        copies=len(tile_ids),
        n_source=n_source,
    )


def _home_ids(vox, tile, nt):
    tx = vox[:, 0] // tile[0]
    ty = vox[:, 1] // tile[1]
    tt = vox[:, 2] // tile[2]
    return (tx * nt[1] + ty) * nt[2] + tt


def bucket_points_home(
    pts: Array,
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: Optional[int] = None,
) -> Buckets:
    """Each point assigned once, to the tile containing its voxel. A tensor
    is bucketed on its device, anything else on the host."""
    on_device = isinstance(pts, torch.Tensor)
    pts = (pts.to(torch.float32) if on_device
           else np.asarray(pts, dtype=np.float32))
    nt = num_tiles(dom, tile)
    with obs_trace.span("bucketing.home",
                        device=pts.device if on_device else None) as sp:
        if on_device:
            ids = _home_ids(_point_voxels_torch(pts, dom), tile, nt)
            b = _densify_torch(ids, pts, nt, cap, len(pts), tile, "home")
        else:
            ids = _home_ids(_point_voxels_np(pts, dom), tile, nt)
            b = _densify(ids, pts, nt, cap, len(pts), tile, "home")
        if sp.recording:
            sp.set(n=len(pts), tiles=f"{nt[0]}x{nt[1]}x{nt[2]}", cap=b.cap)
        return b


def bucket_points_overlap(
    pts: Array,
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: Optional[int] = None,
) -> Buckets:
    """Each point assigned to every tile its cylinder bbox intersects. A
    tensor is bucketed on its device, anything else on the host."""
    on_device = isinstance(pts, torch.Tensor)
    pts = (pts.to(torch.float32) if on_device
           else np.asarray(pts, dtype=np.float32))
    n = len(pts)
    nt = num_tiles(dom, tile)
    with obs_trace.span("bucketing.overlap",
                        device=pts.device if on_device else None) as sp:
        overlap = _bucket_overlap_torch if on_device else _bucket_overlap
        b = overlap(pts, dom, tile, nt, cap, n)
        if sp.recording:
            sp.set(n=n, tiles=f"{nt[0]}x{nt[1]}x{nt[2]}", cap=b.cap,
                   replication=round(b.replication_factor, 3),
                   copies=b.copies)
        return b


def _bucket_overlap(pts, dom, tile, nt, cap, n) -> Buckets:
    vox = _point_voxels_np(pts, dom)
    lo = np.empty((n, 3), dtype=np.int64)
    hi = np.empty((n, 3), dtype=np.int64)
    H = np.array([dom.Hs, dom.Hs, dom.Ht])
    B = np.array(tile)
    NT = np.array(nt)
    lo[:] = np.clip((vox - H) // B, 0, NT - 1)
    hi[:] = np.clip((vox + H) // B, 0, NT - 1)
    span = hi - lo + 1                       # (n, 3)
    smax = span.max(axis=0)                  # max span per dim

    # enumerate all (ox, oy, ot) offsets up to smax and mask invalid ones
    offs = np.stack(
        np.meshgrid(
            np.arange(smax[0]), np.arange(smax[1]), np.arange(smax[2]),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 3)                          # (S, 3)
    tids = lo[:, None, :] + offs[None, :, :]  # (n, S, 3)
    ok = (offs[None, :, :] < span[:, None, :]).all(axis=-1)  # (n, S)
    flat = (tids[..., 0] * nt[1] + tids[..., 1]) * nt[2] + tids[..., 2]
    sel = ok.reshape(-1)
    ids = flat.reshape(-1)[sel]
    pts_rep = np.broadcast_to(pts[:, None, :], tids.shape).reshape(-1, 3)[sel]
    return _densify(ids, pts_rep, nt, cap, n, tile, "overlap")


def _bucket_overlap_torch(pts, dom, tile, nt, cap, n) -> Buckets:
    """``_bucket_overlap`` on the points' device, the copies in the same
    point-major order."""
    dev = pts.device
    i64 = dict(dtype=torch.int64, device=dev)
    vox = _point_voxels_torch(pts, dom)
    H = torch.tensor([dom.Hs, dom.Hs, dom.Ht], **i64)
    B = torch.tensor(tile, **i64)
    top = torch.tensor(nt, **i64) - 1
    zero = torch.zeros_like(top)
    lo = torch.clamp(torch.div(vox - H, B, rounding_mode="floor"), zero, top)
    hi = torch.clamp(torch.div(vox + H, B, rounding_mode="floor"), zero, top)
    span = hi - lo + 1                                       # (n, 3)
    smax = [int(s) for s in span.amax(dim=0).tolist()]

    offs = torch.stack(torch.meshgrid(
        *(torch.arange(s, **i64) for s in smax), indexing="ij"),
        dim=-1).reshape(-1, 3)                               # (S, 3)
    tids = lo[:, None, :] + offs[None, :, :]                 # (n, S, 3)
    ok = (offs[None, :, :] < span[:, None, :]).all(dim=-1)   # (n, S)
    flat = (tids[..., 0] * nt[1] + tids[..., 1]) * nt[2] + tids[..., 2]
    sel = ok.reshape(-1)
    ids = flat.reshape(-1)[sel]
    pts_rep = pts.repeat_interleave(offs.shape[0], dim=0)[sel]
    return _densify_torch(ids, pts_rep, nt, cap, n, tile, "overlap")
