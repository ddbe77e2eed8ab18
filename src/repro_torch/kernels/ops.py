"""Public wrappers around the CUDA tile kernel.

``stkde_tiled(points, dom)`` is the tile path of single-device STKDE: copy
the ``(n, 3)`` points to the device -> overlap bucketing there, packed ->
tile kernel -> slice to the domain grid. On the CPU the plain version runs in
the kernel's place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import convert
from .._device import DeviceLike, points_to_device, resolve_device
from ..obs import trace as obs_trace
from ..core.geometry import Domain
from ..core import bucketing
from ..core import kernels_math as km
from . import ref as _ref
from .stkde_tile import stkde_tiles_cuda


def default_tile(dom: Domain) -> Tuple[int, int, int]:
    """Tile shape of the tile path: ``bx, by <= 32``, ``bt <= 16``, each a
    multiple of 8.

    These are the reference's shapes, kept so that both packages bucket
    alike; a 32x32x16 tile is 1024 columns of 16 sums, one pass of the
    kernel's 8 warps x 8 strips of 16 columns. They have not been tuned on
    the card yet.
    """
    bx = int(min(bucketing.round_up(dom.Gx, 8), 32))
    by = int(min(bucketing.round_up(dom.Gy, 8), 32))
    bt = int(min(bucketing.round_up(dom.Gt, 8), 16))
    return (bx, by, bt)


def prepare_tiles(
    points,
    dom: Domain,
    tile: Tuple[int, int, int],
    chunk: int = 256,
) -> Tuple[bucketing.PackedBuckets, int]:
    """Overlap-bucket the points and pack them. Returns the packed buckets
    and the plain version's panel: ``chunk``, or the longest run rounded up
    to 8 where that is shorter. A tensor is bucketed on its device;
    anything else on the host, as numpy arrays."""
    b = bucketing.bucket_points_packed(points, dom, tile)
    return b, min(chunk, bucketing.round_up(max(b.max_load, 1), 8))


def stkde_tiled(
    points: np.ndarray,
    dom: Domain,
    tile: Optional[Tuple[int, int, int]] = None,
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
    The points are copied to the device once and bucketed there into packed
    buckets; the bucketing copies the tiles' loads back to the host once
    (the longest run), and the kernel's work plan is made there from the
    offsets, copied back once.
    """
    n = len(points)
    if tile is None:
        tile = default_tile(dom)
    dev = resolve_device(device)
    b, chunk_eff = prepare_tiles(points_to_device(points, dev), dom, tile,
                                 chunk=chunk)
    with obs_trace.span("stkde.tile.inputs", device=dev):
        t = convert.buckets_to_torch(b.points, b.offsets, b.counts, tile,
                                     b.max_load, device=dev)
    if use_ref:
        padded = _ref.stkde_tiles_ref(t.points, t.offsets, dom, tile, n, ks,
                                      kt, panel=chunk_eff)
    else:
        padded = stkde_tiles_cuda(
            t.points, t.offsets, dom, tile, t.cap, n, chunk_eff, ks, kt,
            mode=mode,
        )
    return padded[: dom.Gx, : dom.Gy, : dom.Gt]
