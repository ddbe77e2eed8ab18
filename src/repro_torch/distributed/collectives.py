"""Collectives between shards of one controller.

A sharded value is a numpy object array of tensors, one per shard, whose
array axes are mesh axes (in the order the caller names them); each tensor
lives on its shard's device. Every collective visits shards in row-major
order and reduces in that order, so a result has the same bits on every
run, whatever the devices. A tensor moves between shards with
``.to(device)``: device to device, never through the host unless a shard
lives there. ``psum`` and ``ppermute`` serve the STKDE strategies;
``all_to_all``, ``all_gather`` and ``pmax`` the expert-parallel MoE layer,
the parameter placement of ``sharding`` and the compressed gradient sum of
``train.grad_compress``. All are built of ``torch`` ops that autograd
differentiates (``.to``, indexing, ``torch.cat``, ``torch.stack``, adds).
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def shard_array(values) -> np.ndarray:
    """A 1-d object array of tensors, one per shard (filled one by one:
    numpy would otherwise try to turn the tensors into arrays)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _groups(shards: np.ndarray, dims: Union[int, Sequence[int]]):
    """The groups of ``shards`` over the array axes ``dims``: the output
    shape (the other axes) and, per output position, the members in
    row-major order."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    keep = [d for d in range(shards.ndim) if d not in dims]
    grouped = np.transpose(shards, keep + list(dims))
    out_shape = grouped.shape[: len(keep)]
    for idx in np.ndindex(out_shape):
        yield out_shape, idx, list(grouped[idx].reshape(-1))


def _reduce(shards: np.ndarray, dims, op) -> np.ndarray:
    out = None
    for shape, idx, members in _groups(shards, dims):
        if out is None:
            out = np.empty(shape, dtype=object)
        acc = members[0]
        for m in members[1:]:
            acc = op(acc, m.to(acc.device))
        out[idx] = acc
    return out


def psum(shards: np.ndarray, dims: Union[int, Sequence[int]]) -> np.ndarray:
    """Sum ``shards`` over the array axes ``dims``: one group per position
    of the other axes, its members added in row-major order onto the
    group's first member's device. Returns the array of group sums (the
    summed axes removed; a 0-d array when all are summed). Unlike
    ``jax.lax.psum``, which leaves a copy of the sum on every member, the
    controller keeps one."""
    return _reduce(shards, dims, torch.add)


def pmax(shards: np.ndarray, dims: Union[int, Sequence[int]]) -> np.ndarray:
    """Elementwise maximum of ``shards`` over the array axes ``dims``, on
    each group's first member's device (``psum``'s layout)."""
    return _reduce(shards, dims, torch.maximum)


def all_gather(pieces: np.ndarray, dim: int) -> torch.Tensor:
    """The pieces of an object array concatenated along tensor dim ``dim``
    in row-major order of the array (``jax.lax.all_gather(..., tiled=True)``
    over the array's axes), on the first piece's device. Callers gather
    over some mesh axes and keep others by handing in a sub-array."""
    flat = list(np.asarray(pieces, dtype=object).reshape(-1))
    dev = flat[0].device
    return torch.cat([p.to(dev) for p in flat], dim=dim)


def all_to_all(send: np.ndarray, dim: int) -> np.ndarray:
    """Exchange over the array axis ``dim`` (``jax.lax.all_to_all`` with
    ``split_axis=0, concat_axis=0, tiled=False``): along that axis, shard
    ``j``'s tensor has a leading axis of the group's size, and shard ``m``
    receives ``stack_j(send[j][m])`` on its own device. One group per
    position of the other array axes."""
    out = np.empty(send.shape, dtype=object)
    n = send.shape[dim]
    for idx in np.ndindex(send.shape):
        m = idx[dim]
        dev = send[idx].device
        row = []
        for j in range(n):
            src = list(idx)
            src[dim] = j
            row.append(send[tuple(src)][m].to(dev))
        out[idx] = torch.stack(row)
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
