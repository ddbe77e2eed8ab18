"""Public wrappers around the CUDA tile kernel.

``stkde_tiled(points, dom)`` is the tile path of single-device STKDE: copy
the ``(n, 3)`` points to the device -> overlap bucketing there -> tile
kernel -> slice to the domain grid. On the CPU the plain version runs in the
kernel's place.
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
    cap: Optional[int] = None,
    chunk: int = 256,
) -> Tuple[bucketing.Buckets, int]:
    """Overlap-bucket the points, pad ``cap`` to a multiple of ``chunk`` and
    halve ``chunk`` until it divides ``cap``. Returns the padded buckets and
    the effective chunk. A tensor is bucketed and padded on its device;
    anything else on the host, as numpy arrays."""
    b = bucketing.bucket_points_overlap(points, dom, tile, cap=cap)
    cap_eff = bucketing.round_up(b.cap, min(chunk, bucketing.round_up(b.cap, 8)))
    if cap_eff != b.cap:
        pad = cap_eff - b.cap
        on_device = isinstance(b.points, torch.Tensor)
        with obs_trace.span("bucketing.pad", device=b.points.device
                            if on_device else None) as sp:
            if on_device:
                b.points = torch.nn.functional.pad(b.points, (0, 0, 0, pad))
                b.valid = torch.nn.functional.pad(b.valid, (0, pad))
            else:
                b.points = np.pad(b.points,
                                  ((0, 0),) * 3 + ((0, pad), (0, 0)))
                b.valid = np.pad(b.valid, ((0, 0),) * 3 + ((0, pad),))
            if sp.recording:
                sp.set(cap=b.cap, to=cap_eff)
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
    The points are copied to the device once and bucketed there. The kernel
    is given the tiles' true loads on the host (one copy of ``ntiles`` ints
    back from the device), so a tile's walk ends with its last real point
    and not at the padded capacity.
    """
    n = len(points)
    if tile is None:
        tile = default_tile(dom)
    dev = resolve_device(device)
    b, chunk_eff = prepare_tiles(points_to_device(points, dev), dom, tile,
                                 cap=cap, chunk=chunk)
    with obs_trace.span("stkde.tile.inputs", device=dev):
        t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile,
                                     b.cap, device=dev)
        counts = t.counts if use_ref else t.counts.cpu()
    if use_ref:
        padded = _ref.stkde_tiles_ref(t.pts_tiles, t.valid_tiles, dom, tile,
                                      n, ks, kt, counts=counts)
    else:
        padded = stkde_tiles_cuda(
            t.pts_tiles, t.valid_tiles, dom, tile, t.cap, n, chunk_eff,
            ks, kt, mode=mode, counts=counts,
        )
    return padded[: dom.Gx, : dom.Gy, : dom.Gt]
