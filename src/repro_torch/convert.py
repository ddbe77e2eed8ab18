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
    """What the tile kernel and its plain version take, on one device."""

    pts_tiles: torch.Tensor    # (ntx, nty, ntt, cap, 3) float32
    valid_tiles: torch.Tensor  # (ntx, nty, ntt, cap) float32 {0, 1}
    counts: torch.Tensor       # (ntx, nty, ntt) int32 true tile loads
    tile: Tuple[int, int, int]
    cap: int


def buckets_to_torch(points, valid, counts, tile: Tuple[int, int, int],
                     cap: int, device: DeviceLike = None) -> TileInputs:
    """Turn ``Buckets`` arrays (``points``, ``valid``, ``counts``: numpy
    arrays, or tensors) into the tensors the tile kernel takes.
    ``device=None`` means ``"cuda"``. Tensors already on the device are not
    copied."""
    dev = resolve_device(device)
    points = torch.as_tensor(points)
    if points.ndim != 5 or tuple(points.shape[3:]) != (cap, 3):
        raise ValueError(
            f"points must be (ntx, nty, ntt, {cap}, 3); got {points.shape}")
    valid, counts = torch.as_tensor(valid), torch.as_tensor(counts)
    if valid.shape != points.shape[:4] or counts.shape != points.shape[:3]:
        raise ValueError(
            f"valid {tuple(valid.shape)} / counts {tuple(counts.shape)} do "
            f"not match points {tuple(points.shape)}")
    return TileInputs(
        points.to(dev, torch.float32).contiguous(),
        valid.to(dev, torch.float32).contiguous(),
        counts.to(dev, torch.int32).contiguous(),
        tuple(int(b) for b in tile),
        int(cap),
    )


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
