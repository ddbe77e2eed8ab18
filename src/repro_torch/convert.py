"""State carried across from the reference package.

Nothing here imports the reference: a domain is read by attribute from any
object that has the ten fields, and bucket arrays arrive as numpy arrays, so
that a parity test can hand both packages the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.geometry import Domain


def domain_from_reference(dom: Any) -> Domain:
    """The port's ``Domain`` with the fields of ``dom`` (any object that has
    ``gx gy gt sres tres hs ht ox oy ot``)."""
    return Domain(**{
        f.name: float(getattr(dom, f.name))
        for f in dataclasses.fields(Domain)
    })


class TileInputs(NamedTuple):
    """What the tile kernel and its plain version take, on one device."""

    pts_tiles: torch.Tensor    # (ntx, nty, ntt, cap, 3) float32
    valid_tiles: torch.Tensor  # (ntx, nty, ntt, cap) float32 {0, 1}
    counts: torch.Tensor       # (ntx, nty, ntt) int32 true tile loads
    tile: Tuple[int, int, int]
    cap: int


def buckets_to_torch(points: np.ndarray, valid: np.ndarray,
                     counts: np.ndarray, tile: Tuple[int, int, int],
                     cap: int, device: DeviceLike = None) -> TileInputs:
    """Turn numpy ``Buckets`` arrays (``points``, ``valid``, ``counts``) into
    the tensors the tile kernel takes. ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 5 or points.shape[3:] != (cap, 3):
        raise ValueError(
            f"points must be (ntx, nty, ntt, {cap}, 3); got {points.shape}")
    if valid.shape != points.shape[:4] or counts.shape != points.shape[:3]:
        raise ValueError(
            f"valid {valid.shape} / counts {counts.shape} do not match "
            f"points {points.shape}")
    return TileInputs(
        torch.from_numpy(points).to(dev),
        torch.from_numpy(np.ascontiguousarray(valid, dtype=np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int32)).to(dev),
        tuple(int(b) for b in tile),
        int(cap),
    )
