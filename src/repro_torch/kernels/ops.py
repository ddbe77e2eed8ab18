"""Public wrappers around the CUDA tile kernel.

``stkde_tiled(points, dom)`` is the tile path of single-device STKDE:
host-side overlap bucketing -> copy to the device -> tile kernel -> slice to
the domain grid. On CPU tensors the plain version runs in the kernel's place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import convert
from .._device import DeviceLike
from ..core.geometry import Domain
from ..core import bucketing
from ..core import kernels_math as km
from . import ref as _ref
from .stkde_tile import stkde_tiles_cuda


def default_tile(dom: Domain) -> Tuple[int, int, int]:
    """Tile shape of the tile path: ``bx, by <= 32``, ``bt <= 16``, each a
    multiple of 8.

    These are the reference's shapes, kept so that both packages bucket
    alike; a 32x32x16 tile is 1024 columns of 16 sums, four columns to each
    of the kernel's 256 threads. They have not been tuned on the card yet.
    """
    bx = int(min(bucketing.round_up(dom.Gx, 8), 32))
    by = int(min(bucketing.round_up(dom.Gy, 8), 32))
    bt = int(min(bucketing.round_up(dom.Gt, 8), 16))
    return (bx, by, bt)


def prepare_tiles(
    points: np.ndarray,
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: Optional[int] = None,
    chunk: int = 256,
) -> Tuple[bucketing.Buckets, int]:
    """Host side of the tile path: overlap-bucket the points, pad ``cap`` to
    a multiple of ``chunk`` and halve ``chunk`` until it divides ``cap``.
    Returns the padded buckets and the effective chunk."""
    pts = np.asarray(points, dtype=np.float32)
    b = bucketing.bucket_points_overlap(pts, dom, tile, cap=cap)
    cap_eff = bucketing.round_up(b.cap, min(chunk, bucketing.round_up(b.cap, 8)))
    if cap_eff != b.cap:
        pad = cap_eff - b.cap
        b.points = np.pad(b.points, ((0, 0),) * 3 + ((0, pad), (0, 0)))
        b.valid = np.pad(b.valid, ((0, 0),) * 3 + ((0, pad),))
        b.cap = cap_eff
    chunk_eff = min(chunk, cap_eff)
    # make chunk divide cap
    while cap_eff % chunk_eff:
        chunk_eff //= 2
    return b, chunk_eff


def stkde_tiled(
    points: np.ndarray,
    dom: Domain,
    tile: Optional[Tuple[int, int, int]] = None,
    cap: Optional[int] = None,
    chunk: int = 256,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    use_ref: bool = False,
    mode: str = "auto",
    device: DeviceLike = None,
) -> torch.Tensor:
    """STKDE density grid via the tiled PB-SYM kernel, on ``device``
    (``None`` means ``"cuda"``).

    ``mode`` ("auto" | "reference" | "compiled") selects what runs — see
    ``stkde_tiles_cuda``. ``use_ref=True`` calls the plain version directly.
    The kernel is given the tiles' true loads, so a tile's walk ends with its
    last real point and not at the padded capacity.
    """
    n = len(points)
    if tile is None:
        tile = default_tile(dom)
    b, chunk_eff = prepare_tiles(points, dom, tile, cap=cap, chunk=chunk)
    t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap,
                                 device=device)
    if use_ref:
        padded = _ref.stkde_tiles_ref(t.pts_tiles, t.valid_tiles, dom, tile,
                                      n, ks, kt, counts=t.counts)
    else:
        padded = stkde_tiles_cuda(
            t.pts_tiles, t.valid_tiles, dom, tile, t.cap, n, chunk_eff,
            ks, kt, mode=mode, counts=t.counts,
        )
    return padded[: dom.Gx, : dom.Gy, : dom.Gt]
