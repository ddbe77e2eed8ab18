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

``counting()`` adds up, while it is open, the bytes each receiving device
(or mesh position, ``mesh.position_of``) gets per collective kind: the
counterpart of the reference's ``launch.roofline.parse_collective_bytes``,
with its keys. A tensor that stays where it is moves nothing.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Union

import numpy as np
import torch

from . import mesh as _mesh

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


class ByteCount:
    """Bytes received per receiver and collective kind, and the number of
    collective calls per kind."""

    def __init__(self):
        self.received: Dict[object, Dict[str, float]] = {}
        self.calls = {k: 0 for k in KINDS}

    def result(self) -> Dict[str, float]:
        """``parse_collective_bytes``' keys for the receiver that gets the
        most bytes (per kind, ``total``, ``n_ops``: the calls of every
        receiver), and ``receivers``: how many received anything."""
        busiest = max(self.received.values(), default={},
                      key=lambda r: sum(r.values()))
        out = {k: float(busiest.get(k, 0.0)) for k in KINDS}
        out["total"] = sum(out[k] for k in KINDS)
        out["n_ops"] = sum(self.calls.values())
        out["receivers"] = len(self.received)
        return out


_COUNTER = [None]


@contextlib.contextmanager
def counting():
    """Count the collectives' bytes while open: yields a ``ByteCount``."""
    prev, _COUNTER[0] = _COUNTER[0], ByteCount()
    try:
        yield _COUNTER[0]
    finally:
        _COUNTER[0] = prev


def _key(x):
    pos = _mesh.position_of(x)
    if pos is not None:
        return pos
    return x.device if isinstance(x, torch.Tensor) else torch.device(x)


def _call(kind: str) -> None:
    if _COUNTER[0] is not None:
        _COUNTER[0].calls[kind] += 1


def _move(t: torch.Tensor, device, kind: str) -> torch.Tensor:
    """``t.to(device)``, its bytes counted as ``kind`` traffic into
    ``device`` when a counter is open and ``t`` lives elsewhere."""
    c = _COUNTER[0]
    if c is not None:
        dst = _key(device)
        if _key(t) != dst:
            got = c.received.setdefault(dst, {})
            got[kind] = got.get(kind, 0.0) + t.numel() * t.element_size()
    return t.to(device)


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
    _call("all-reduce")
    out = None
    for shape, idx, members in _groups(shards, dims):
        if out is None:
            out = np.empty(shape, dtype=object)
        acc = members[0]
        dev = _mesh.device_of(acc)
        for m in members[1:]:
            acc = op(acc, _move(m, dev, "all-reduce"))
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
    _call("all-gather")
    flat = list(np.asarray(pieces, dtype=object).reshape(-1))
    dev = _mesh.device_of(flat[0])
    return torch.cat([_move(p, dev, "all-gather") for p in flat], dim=dim)


def all_to_all(send: np.ndarray, dim: int) -> np.ndarray:
    """Exchange over the array axis ``dim`` (``jax.lax.all_to_all`` with
    ``split_axis=0, concat_axis=0, tiled=False``): along that axis, shard
    ``j``'s tensor has a leading axis of the group's size, and shard ``m``
    receives ``stack_j(send[j][m])`` on its own device. One group per
    position of the other array axes."""
    _call("all-to-all")
    out = np.empty(send.shape, dtype=object)
    n = send.shape[dim]
    for idx in np.ndindex(send.shape):
        m = idx[dim]
        dev = _mesh.device_of(send[idx])
        row = []
        for j in range(n):
            src = list(idx)
            src[dim] = j
            row.append(_move(send[tuple(src)][m], dev, "all-to-all"))
        out[idx] = torch.stack(row)
    return out


def ppermute(bands: np.ndarray, devices: np.ndarray, dim: int,
             shift: int) -> np.ndarray:
    """Move each shard's band ``shift`` positions along array axis ``dim``
    (+1: from shard k to k+1; -1: from k to k-1). A shard nobody sends to
    receives zeros, as with ``jax.lax.ppermute``. ``devices`` holds each
    receiving shard's device. Every received band is a new tensor, so later
    in-place adds on the sender do not reach it."""
    _call("collective-permute")
    out = np.empty(bands.shape, dtype=object)
    size = bands.shape[dim]
    for idx in np.ndindex(bands.shape):
        src = list(idx)
        src[dim] -= shift
        if 0 <= src[dim] < size:
            band = bands[tuple(src)]
            moved = _move(band, devices[idx], "collective-permute")
            # a new tensor even where nothing moved
            out[idx] = moved.clone() if moved is band else moved
        else:
            out[idx] = torch.zeros_like(bands[idx], device=devices[idx])
    return out
