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
``train.grad_compress``; ``all_reduce``, ``pmax_row`` and ``all_gather_row``
(a copy of the result on every member of a row of positions) the tensor
parallel layers, ``broadcast_row`` the row decode's one-member results,
``exchange`` (an all-to-all of uneven parts) the row's column trades,
``reduce_scatter`` the row's column sums and ``reduce_scatter_into`` (its
members one at a time, the sums kept in the pieces) the sharded train
step's gradients. All are built
of ``torch`` ops that autograd differentiates (``.to``, indexing,
``torch.cat``, ``torch.stack``, adds).

``counting()`` adds up, while it is open, the bytes each receiving device
(or mesh position, ``mesh.position_of``) gets per collective kind: the
counterpart of the reference's ``launch.roofline.parse_collective_bytes``,
with its keys. A tensor that stays where it is moves nothing. A moved
tensor that autograd differentiates counts again in backward, where its
gradient moves back to the sender under the same kind.
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


def _count(dst, t: torch.Tensor, kind: str) -> None:
    c = _COUNTER[0]
    if c is not None:
        got = c.received.setdefault(dst, {})
        got[kind] = got.get(kind, 0.0) + t.numel() * t.element_size()


def _move(t: torch.Tensor, device, kind: str) -> torch.Tensor:
    """``t.to(device)``, its bytes counted as ``kind`` traffic into
    ``device`` when a counter is open and ``t`` lives elsewhere; its
    gradient's bytes into ``t``'s place when backward moves it back."""
    if _COUNTER[0] is None:
        return t.to(device)
    src, dst = _key(t), _key(device)
    if src == dst:
        return t.to(device)
    _count(dst, t, kind)
    out = t.to(device)
    if out.requires_grad:
        out.register_hook(lambda g: _count(src, g, kind))
    return out


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


def all_gather(pieces: np.ndarray, dim: int, device=None) -> torch.Tensor:
    """The pieces of an object array concatenated along tensor dim ``dim``
    in row-major order of the array (``jax.lax.all_gather(..., tiled=True)``
    over the array's axes), on ``device`` (default: the first piece's).
    Callers gather over some mesh axes and keep others by handing in a
    sub-array."""
    _call("all-gather")
    flat = list(np.asarray(pieces, dtype=object).reshape(-1))
    dev = _mesh.device_of(flat[0]) if device is None else device
    return torch.cat([_move(p, dev, "all-gather") for p in flat], dim=dim)


def reduce_scatter(shards: np.ndarray, dims: Union[int, Sequence[int]],
                   dim: int, devices: np.ndarray) -> np.ndarray:
    """``psum`` over the array axes ``dims`` followed by a cut of tensor dim
    ``dim`` into ``n = devices.shape[-1]`` equal pieces, bit for bit: piece
    ``i`` of a group is the sum, in row-major order of the members, of
    their ``i``-th slices, added on ``devices[group + (i,)]``
    (``jax.lax.psum_scatter(..., tiled=True)``, the sum of one slice made
    where it stays). ``devices`` has the other axes' shape and then ``n``;
    so has the result."""
    _call("reduce-scatter")
    out = np.empty(devices.shape, dtype=object)
    n = devices.shape[-1]
    for _, idx, members in _groups(shards, dims):
        c = members[0].shape[dim] // n
        for i in range(n):
            dev = devices[idx + (i,)]
            acc = None
            for m in members:
                part = _move(m.narrow(dim, i * c, c), dev, "reduce-scatter")
                acc = part if acc is None else acc + part
            out[idx + (i,)] = acc
    return out


def reduce_scatter_into(pairs, first: bool) -> None:
    """One member's turn in a ``reduce_scatter`` whose sums stay where
    their pieces live: for each ``(part, into)`` of ``pairs`` (the member's
    slice of a piece, the piece's running sum), ``part`` moved to
    ``into``'s device and added into it in place; ``first``: the member
    that opens the sums, its parts copied in. Members taking their turns
    in row-major order give ``reduce_scatter``'s bits, and no member's
    whole tensor waits for the others'."""
    _call("reduce-scatter")
    for part, into in pairs:
        moved = _move(part, _mesh.device_of(into), "reduce-scatter")
        if first:
            into.copy_(moved)
        else:
            into.add_(moved)


# ------------------------------------------- over a row of positions (TP)
def _everywhere(t: torch.Tensor, devices) -> list:
    """``t`` on its own device and a copy on each other member's."""
    return [_move(t, d, "all-reduce") for d in devices]


def all_reduce(parts: Sequence[torch.Tensor], devices) -> list:
    """The sum of one tensor per member of a row of positions (``devices``,
    in order): ``psum`` onto the first member, then a copy on every member
    (``jax.lax.psum``'s layout, the same bits at every member). Autograd's
    backward sums the copies' gradients on the first member and sends that
    sum back to every part."""
    return _everywhere(psum(shard_array(parts), 0).item(), devices)


def pmax_row(parts: Sequence[torch.Tensor], devices) -> list:
    """``all_reduce``'s layout for the elementwise maximum (``pmax``)."""
    return _everywhere(pmax(shard_array(parts), 0).item(), devices)


def all_gather_row(parts: Sequence[torch.Tensor], dim: int, devices) -> list:
    """The members' tensors concatenated along ``dim`` in order, on every
    member's device (``jax.lax.all_gather(..., tiled=True)``: each member
    receives the others' parts and keeps its own)."""
    _call("all-gather")
    return [torch.cat([_move(p, d, "all-gather") for p in parts], dim=dim)
            for d in devices]


def broadcast_row(t: torch.Tensor, devices) -> list:
    """``t``, which lives at one member of a row of positions, on every
    member's device (its own copy where it is; a received copy elsewhere,
    counted as ``collective-permute`` traffic)."""
    _call("collective-permute")
    return [_move(t, d, "collective-permute") for d in devices]


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


def exchange(send, devices) -> list:
    """An all-to-all of uneven parts: ``send[i][j]`` what sender ``i``
    sends to ``devices[j]`` (``None``: nothing), moved there. Senders and
    receivers need not be the same members, nor as many (a row sending its
    columns to every position that holds a piece of a cache). Returns, per
    receiver, the parts it got in the senders' order; a part that is
    already where it goes is not moved. Counted as ``all-to-all``."""
    _call("all-to-all")
    return [[_move(s[j], d, "all-to-all") for s in send if s[j] is not None]
            for j, d in enumerate(devices)]


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
