"""The two collectives the strategies use, between shards of one controller.

A sharded value is a numpy object array of tensors, one per shard, whose
array axes are mesh axes (in the order the strategy names them); each
tensor lives on its shard's device. Both collectives visit shards in
row-major order and add in that order, so a result has the same bits on
every run, whatever the devices. A tensor moves between shards with
``.to(device)``: device to device, never through the host unless a shard
lives there.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def psum(shards: np.ndarray, dims: Union[int, Sequence[int]]) -> np.ndarray:
    """Sum ``shards`` over the array axes ``dims``: one group per position
    of the other axes, its members added in row-major order onto the
    group's first member's device. Returns the array of group sums (the
    summed axes removed; a 0-d array when all are summed). Unlike
    ``jax.lax.psum``, which leaves a copy of the sum on every member, the
    controller keeps one."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    keep = [d for d in range(shards.ndim) if d not in dims]
    grouped = np.transpose(shards, keep + list(dims))
    out_shape = grouped.shape[: len(keep)]
    out = np.empty(out_shape, dtype=object)
    for idx in np.ndindex(out_shape):
        members = grouped[idx].reshape(-1)
        acc = members[0]
        for m in members[1:]:
            acc = acc + m.to(acc.device)
        out[idx] = acc
    return out


def ppermute(bands: np.ndarray, devices: np.ndarray, dim: int,
             shift: int) -> np.ndarray:
    """Move each shard's band ``shift`` positions along array axis ``dim``
    (+1: from shard k to k+1; -1: from k to k-1). A shard nobody sends to
    receives zeros, as with ``jax.lax.ppermute``. ``devices`` holds each
    receiving shard's device. Every received band is a new tensor, so later
    in-place adds on the sender do not reach it."""
    out = np.empty(bands.shape, dtype=object)
    size = bands.shape[dim]
    for idx in np.ndindex(bands.shape):
        src = list(idx)
        src[dim] -= shift
        if 0 <= src[dim] < size:
            out[idx] = bands[tuple(src)].to(devices[idx], copy=True)
        else:
            out[idx] = torch.zeros_like(bands[idx], device=devices[idx])
    return out
