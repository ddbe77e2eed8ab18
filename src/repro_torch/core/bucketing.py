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

This preparation is host-side numpy by design: in production it runs in the
per-host data pipeline (like tokenization), not on the accelerator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from ..obs import trace as obs_trace
from .geometry import Domain


@dataclasses.dataclass
class Buckets:
    points: np.ndarray  # (ntx, nty, ntt, cap, 3) float32
    valid: np.ndarray   # (ntx, nty, ntt, cap) bool
    counts: np.ndarray  # (ntx, nty, ntt) int64 — true per-tile loads
    tile: Tuple[int, int, int]
    cap: int
    mode: str

    @property
    def ntiles(self) -> Tuple[int, int, int]:
        return self.points.shape[:3]

    @property
    def replication_factor(self) -> float:
        """Average copies per point (1.0 for home; >1 measures DD overhead)."""
        total = int(self.counts.sum())
        return total / max(1, self._n_source)

    _n_source: int = 1


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

    b = Buckets(
        points=points.reshape(ntx, nty, ntt, cap, 3),
        valid=valid.reshape(ntx, nty, ntt, cap),
        counts=counts.reshape(ntx, nty, ntt),
        tile=tile,
        cap=cap,
        mode=mode,
    )
    b._n_source = n_source
    return b


def bucket_points_home(
    pts: np.ndarray,
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: Optional[int] = None,
) -> Buckets:
    """Each point assigned once, to the tile containing its voxel."""
    pts = np.asarray(pts, dtype=np.float32)
    nt = num_tiles(dom, tile)
    with obs_trace.span("bucketing.home", n=len(pts),
                        tiles=f"{nt[0]}x{nt[1]}x{nt[2]}") as sp:
        vox = _point_voxels_np(pts, dom)
        tx = vox[:, 0] // tile[0]
        ty = vox[:, 1] // tile[1]
        tt = vox[:, 2] // tile[2]
        ids = (tx * nt[1] + ty) * nt[2] + tt
        b = _densify(ids, pts, nt, cap, len(pts), tile, "home")
        sp.set(cap=b.cap)
        return b


def bucket_points_overlap(
    pts: np.ndarray,
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: Optional[int] = None,
) -> Buckets:
    """Each point assigned to every tile its cylinder bbox intersects."""
    pts = np.asarray(pts, dtype=np.float32)
    n = len(pts)
    nt = num_tiles(dom, tile)
    with obs_trace.span("bucketing.overlap", n=n,
                        tiles=f"{nt[0]}x{nt[1]}x{nt[2]}") as sp:
        b = _bucket_overlap(pts, dom, tile, nt, cap, n)
        sp.set(cap=b.cap, replication=round(b.replication_factor, 3))
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
