"""State carried across from the reference package.

Nothing here imports the reference: a domain is read by attribute from any
object that has the ten fields, bucket arrays arrive as numpy arrays (or
tensors), and language-model parameters and optimizer moments as trees of
numpy arrays, so that a parity test can hand both packages the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.bucketing import padded_name
from .core.geometry import Domain
from .train.optimizer import OptState


def domain_from_reference(dom: Any) -> Domain:
    """The port's ``Domain`` with the fields of ``dom`` (any object that has
    ``gx gy gt sres tres hs ht ox oy ot``)."""
    return Domain(**{
        f.name: float(getattr(dom, f.name))
        for f in dataclasses.fields(Domain)
    })


class TileInputs(NamedTuple):
    """What the tile kernel and its plain version take, on one device: the
    packed buckets (``core/bucketing.py::PackedBuckets``)."""

    points: torch.Tensor   # (copies, 3) float32, tile after tile
    offsets: torch.Tensor  # (ntiles + 1,) int64: where each tile's run starts
    counts: torch.Tensor   # (ntx, nty, ntt) int32 tile loads
    tile: Tuple[int, int, int]
    cap: int               # the longest run

    # The padded layout's names, kept only for the benchmark's staged copy
    # of the tile branch (stkde_bench/staged/tile.py); each read warns.
    @property
    def pts_tiles(self) -> torch.Tensor:
        padded_name("TileInputs.pts_tiles", "points")
        return self.points

    @property
    def valid_tiles(self) -> torch.Tensor:
        padded_name("TileInputs.valid_tiles", "offsets")
        return self.offsets


def buckets_to_torch(points, offsets, counts, tile: Tuple[int, int, int],
                     cap: int, device: DeviceLike = None) -> TileInputs:
    """Turn packed buckets' arrays (``points``, ``offsets``, ``counts``:
    numpy arrays, or tensors) into the tensors the tile kernel takes.
    ``device=None`` means ``"cuda"``. Tensors already on the device are not
    copied; nothing of ``ntiles x cap`` is made. ``reference_buckets``
    packs the reference's padded arrays."""
    dev = resolve_device(device)
    points, offsets = torch.as_tensor(points), torch.as_tensor(offsets)
    counts = torch.as_tensor(counts)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (copies, 3); got {points.shape}")
    if counts.ndim != 3 or offsets.shape != (counts.numel() + 1,):
        raise ValueError(
            f"offsets {tuple(offsets.shape)} / counts {tuple(counts.shape)} "
            f"do not make ntiles + 1 offsets of (ntx, nty, ntt) tiles")
    return TileInputs(
        points.to(dev, torch.float32).contiguous(),
        offsets.to(dev, torch.int64).contiguous(),
        counts.to(dev, torch.int32).contiguous(),
        tuple(int(b) for b in tile),
        int(cap),
    )


def reference_buckets(points, valid, counts):
    """The reference's padded buckets (``points`` (ntx, nty, ntt, cap, 3),
    ``valid``, ``counts``: numpy arrays) packed as the port's tile branch
    holds them: each bucket's valid slots in order, tile after tile, and the
    offsets of the runs. Returns ``(points, offsets, counts)``."""
    points, valid = np.asarray(points), np.asarray(valid, dtype=bool)
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts.reshape(-1), out=offsets[1:])
    return points[valid], offsets, counts


def lm_params_from_reference(tree: Any, device: DeviceLike = None) -> Any:
    """The port's language-model parameters from the reference's
    ``init_params`` tree (nested dicts of arrays, per-layer weights stacked
    on a leading L axis; hand it over as numpy arrays). The port keeps the
    same tree, so each leaf becomes a tensor on ``device`` (``None`` means
    ``"cuda"``) with the same dtype and bits."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_reference(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def opt_state_from_reference(opt_state: Any, device: DeviceLike = None):
    """The port's ``train.optimizer.OptState`` from the reference's (any
    object with ``mu``, ``nu``, ``step``; hand the moments over as numpy
    trees): the same moments, bit for bit, and the step counter as a 0-dim
    int32 tensor, on ``device`` (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)
    return OptState(
        mu=lm_params_from_reference(opt_state.mu, dev),
        nu=lm_params_from_reference(opt_state.nu, dev),
        step=torch.tensor(int(np.asarray(opt_state.step)),
                          dtype=torch.int32, device=dev),
    )
