"""Parameter / activation / cache placement rules on a ``Mesh`` of shards.

The reference's ``distributed/sharding.py``, rule for rule. Mesh axes:
("pod", "data", "model") multi-pod or ("data", "model") single pod.
  * pod    — pure data parallelism (gradient sum across pods)
  * data   — batch sharding + FSDP (ZeRO-3) parameter sharding
  * model  — tensor parallelism (Megatron col/row), expert parallelism,
             and KV-cache sequence sharding for decode

Rules are path-based over the plain-dict parameter trees of ``models/``. A
leaf whose rank is one above its rule gets a leading ``None`` (the
stacked-layer axis). Any axis whose size does not divide the dimension falls
back to ``None``: placement never changes numerics.

A spec is a ``P``, the counterpart of ``jax.sharding.PartitionSpec``. Where
the reference hands a spec tree to XLA (``NamedSharding``), the port places
the pieces itself: ``shard_tree`` cuts each leaf into one piece per mesh
position along its spec's axes, each on its shard's device (a ``Sharded``
leaf), and ``gather_tree`` puts the leaves back together through
``collectives.all_gather``. ``Zero3`` is the sharded train step's side of
it: a stacked leaf gathered a layer at a time (``gather_layer``) and each
gradient cut into sums that live with the pieces.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import numpy as np
import torch

from . import collectives
from . import mesh as _mesh
from .mesh import Mesh

FSDP = "data"
TP = "model"

COL = (FSDP, TP)      # (d_in, d_out) column parallel
ROW = (TP, FSDP)      # row parallel


class P(tuple):
    """A partition spec: one entry per tensor dimension, ``None`` (whole),
    an axis name, or a tuple of axis names (split over their product,
    row-major). A one-name tuple is stored as the name, as
    ``jax.sharding.PartitionSpec`` stores it, so equal placements compare
    equal."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    @staticmethod
    def axes_of(entry) -> Tuple[str, ...]:
        """The mesh axes one entry splits its dimension over."""
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def mesh_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec splits over, in order of appearance."""
        return tuple(a for e in self for a in P.axes_of(e))


# ordered (path-suffix, base-spec) rules; first match wins
# NOTE embed/head: vocab over TP only (the reference's measurement: an
# FSDP-sharded embed dim makes the logits matmul contract over a
# data-sharded axis)
_RULES = [
    (("embed", "tok"), (TP, None)),          # vocab x embed
    (("head",), (None, TP)),                 # embed x vocab
    # rwkv channel-mix: wk (D,F) col, wv (F,D) row, wr (D,D) col
    (("cmix", "wv"), ROW),
    # MoE: experts over TP (expert parallelism), d_model over FSDP
    (("moe", "router"), (FSDP, None)),
    (("moe", "wg"), (TP, FSDP, None)),
    (("moe", "wu"), (TP, FSDP, None)),
    (("moe", "wo"), (TP, None, FSDP)),
    # MLA up-projections: latent x (H*dh) — heads over TP
    (("w_uk",), (None, TP)),
    (("w_uv",), (None, TP)),
    (("w_dkv",), (FSDP, None)),
    (("w_krope",), (FSDP, None)),
    # SSM
    (("in_proj",), COL),
    (("out_proj",), ROW),
    (("conv_w",), (None, None)),
    (("conv_b",), (None,)),
    (("A_log",), (TP,)),
    (("ssm", "D"), (TP,)),
    (("dt_bias",), (TP,)),
    (("ssm", "norm"), (TP,)),
    # rwkv time-mix head params
    (("u",), (TP, None)),
    # generic projections
    (("wq",), COL), (("wk",), COL), (("wv",), COL),
    (("wg",), COL), (("wu",), COL), (("wi",), COL),
    (("wr",), COL),
    (("wo",), ROW),
]


def _size(mesh: Mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes]))


def _match(path: Tuple[str, ...], rule: Tuple[str, ...]) -> bool:
    return len(path) >= len(rule) and tuple(path[-len(rule):]) == rule


def _divisible(spec, shape, mesh: Mesh) -> P:
    """Drop axes that don't divide their dimension (or exceed rank)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        out.append(ax if shape[i] % _size(mesh, P.axes_of(ax)) == 0
                   else None)
    return P(*out)


def _map_with_path(fn, tree, path=()):
    """``fn(path_names, leaf)`` over a tree of dicts, lists / tuples and
    NamedTuples; the names are the dict keys, the NamedTuple field names and
    the list positions, as the reference's ``_path_names`` gives them. A
    ``None`` subtree stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, k), path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape)) if hasattr(leaf, "shape") else 0


def fsdp_only_param_specs(params, mesh: Mesh):
    """FSDP-only (ZeRO-3) parameter sharding: no tensor parallelism. Each
    leaf is sharded on its largest dimension divisible by the full
    (data x model) axis set, falling back to "data" only, then
    replicated."""
    axes_full = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    size_full = _size(mesh, axes_full)
    size_data = mesh.shape.get("data", 1)

    def leaf(_, arr):
        shape = tuple(arr.shape)
        if not shape:
            return P()
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % size_full == 0:
                spec = [None] * len(shape)
                spec[i] = axes_full
                return P(*spec)
        for i in order:
            if "data" in mesh.axis_names and shape[i] % size_data == 0:
                spec = [None] * len(shape)
                spec[i] = "data"
                return P(*spec)
        return P()

    return _map_with_path(leaf, params)


def param_specs(params, mesh: Mesh, fsdp: bool = True):
    """Spec tree matching the parameter tree."""
    have_fsdp = fsdp and FSDP in mesh.axis_names

    def leaf(names, arr):
        base = None
        for rule, spec in _RULES:
            if _match(names, rule):
                base = spec
                break
        if base is None:
            return P()                                     # replicated
        if not have_fsdp:
            base = tuple(None if a == FSDP else a for a in base)
        if TP not in mesh.axis_names:
            base = tuple(None if a == TP else a for a in base)
        ndim = _ndim(arr)
        # stacked-layer leading axis
        if ndim == len(base) + 1:
            base = (None,) + base
        elif ndim != len(base):
            return P()
        return _divisible(base, tuple(arr.shape), mesh)

    return _map_with_path(leaf, params)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes used to shard the global batch."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_specs(batch: dict, mesh: Mesh, include_model: bool = False):
    """Specs for a training batch: leading dim over (pod, data[, model]),
    the longest axis tuple that divides it first, then shorter ones — the
    batch is never replicated just because one extra axis doesn't divide."""
    bd = batch_axes(mesh)
    candidates = []
    if include_model and TP in mesh.axis_names:
        candidates.append(bd + (TP,))
    candidates.append(bd)
    while len(candidates[-1]) > 1:
        candidates.append(candidates[-1][:-1])

    def leaf(_, arr):
        shape = tuple(arr.shape)
        spec = [None] * len(shape)
        for axes in candidates:
            if shape and shape[0] % _size(mesh, axes) == 0:
                spec[0] = axes
                break
        return P(*spec)

    return _map_with_path(leaf, batch)


def _state_leaf(mesh: Mesh, bd, bd_size: int, tp, names, shape) -> list:
    """The reference's rule for one leaf of its decode state, whose caches
    are stacked on a leading L (or site) axis: batch is dim 1, the cached
    sequence dim 2."""
    ndim = len(shape)
    spec = [None] * ndim
    if "cross" in names and ndim == 3:   # enc_out (B, S_enc, D)
        if shape[0] % bd_size == 0:
            spec[0] = bd
        return spec
    if ndim >= 2:
        if shape[1] % bd_size == 0:
            spec[1] = bd
            seq_axes = (tp,)
        else:
            seq_axes = tuple(a for a in (bd + ((tp,) if tp else ()))
                             if a is not None) or (None,)
        is_seq_cache = any(n in names for n in ("k", "v", "c_kv", "k_rope"))
        if is_seq_cache and ndim >= 3:
            ax = seq_axes if len(seq_axes) > 1 else seq_axes[0]
            if ax is not None and shape[2] % _size(mesh, P.axes_of(ax)) == 0:
                spec[2] = ax
    return spec


def decode_state_specs(cfg, state, mesh: Mesh):
    """Specs for a ``models.model.DecodeState``: batch over (pod, data) when
    divisible, the cache's sequence over "model" (plus what of (pod, data)
    the batch could not use — the flash-decoding layout for long-context
    decode).

    The port keeps one cache per layer (and per shared-attention site) in a
    list, batch first; the reference stacks them on a leading L axis. Each
    list entry gets the reference's spec of the stacked leaf without its
    leading (never sharded) entry. The encoder tuple ``cross`` has the
    reference's layout and gets its specs unchanged; the int cursors
    (``index``, a lockstep ``step``) get ``P()``."""
    bd = batch_axes(mesh)
    bd_size = _size(mesh, bd)
    tp = TP if TP in mesh.axis_names else None

    def stacked(names, arr):        # an entry of the per-layer lists
        if not isinstance(arr, torch.Tensor) or arr.ndim == 0:
            return P()
        shape = (1,) + tuple(arr.shape)
        return P(*_state_leaf(mesh, bd, bd_size, tp, names, shape)[1:])

    def whole(names, arr):          # cross and step: the reference's layout
        if not isinstance(arr, torch.Tensor) or arr.ndim == 0:
            return P()
        return P(*_state_leaf(mesh, bd, bd_size, tp, names, tuple(arr.shape)))

    return type(state)(
        layer=_map_with_path(stacked, state.layer, ("layer",)),
        shared=_map_with_path(stacked, state.shared, ("shared",)),
        cross=_map_with_path(whole, state.cross, ("cross",)),
        step=whole(("step",), state.step),
    )


# ------------------------------------------------------------ placement
class Sharded:
    """One leaf cut into pieces by ``spec`` over ``mesh``.

    ``pieces`` is a numpy object array with one array axis per mesh axis of
    the spec (in the order the spec names them); each piece is a tensor on
    the device of its mesh position (``Mesh.devices_of``: replicas sit on
    the position at index 0 of the axes the spec does not name). A
    replicated leaf is a 0-d array holding one piece. Pieces are separate
    tensors even when they share a device, so an in-place update of one
    reaches no other."""

    __slots__ = ("pieces", "spec", "mesh", "shape", "dtype")

    def __init__(self, pieces: np.ndarray, spec: P, mesh: Mesh, shape,
                 dtype: torch.dtype):
        self.pieces = pieces
        self.spec = spec
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"pieces={self.pieces.shape})")


def _spec_devices(spec: P, mesh: Mesh) -> np.ndarray:
    axes = spec.mesh_axes()
    return np.asarray(mesh.devices_of(axes), dtype=object).reshape(
        tuple(mesh.shape[a] for a in axes))


def _cut(t: torch.Tensor, spec: P, mesh: Mesh, idx, skip: int = -1):
    """The piece of ``t`` at pieces index ``idx``: each spec entry (but
    entry ``skip``) narrows its dim to its axes' row-major position."""
    k = 0
    for dim, entry in enumerate(spec):
        names = P.axes_of(entry)
        if not names:
            continue
        if dim != skip:
            sizes = [mesh.shape[a] for a in names]
            pos = int(np.ravel_multi_index(idx[k:k + len(names)], sizes))
            n = t.shape[dim] // int(np.prod(sizes))
            t = t.narrow(dim, pos * n, n)
        k += len(names)
    return t


def _place(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device, copy=True,
                         memory_format=torch.contiguous_format)


def shard(x: torch.Tensor, spec: P, mesh: Mesh) -> Sharded:
    """Cut ``x`` by ``spec`` into pieces on ``mesh``'s devices. Entry ``i``
    of the spec splits dim ``i`` over its axes' product, row-major (the
    first named axis outermost), as XLA lays out ``NamedSharding``."""
    devices = _spec_devices(spec, mesh)
    pieces = np.empty(devices.shape, dtype=object)
    for idx in np.ndindex(devices.shape):
        with _mesh.at(devices[idx]):
            pieces[idx] = _place(_cut(x, spec, mesh, idx), devices[idx])
    return Sharded(pieces, spec, mesh, x.shape, x.dtype)


def _batch_entry(spec: P, axes) -> Optional[Tuple[int, int]]:
    """(dim, first pieces-array axis) of the spec entry that splits over
    exactly ``axes``, or ``None``."""
    k = 0
    for dim, entry in enumerate(spec):
        names = P.axes_of(entry)
        if names and names == tuple(axes):
            return dim, k
        k += len(names)
    return None


def _block_pieces(leaf: Sharded, axes, k: int):
    """The pieces of batch block ``k`` of a leaf split over ``axes`` (the
    batch axes' array axes dropped) and the spec without that entry; or
    ``None`` for a leaf not split over ``axes``."""
    hit = _batch_entry(leaf.spec, axes)
    if hit is None:
        return None
    dim, a = hit
    sizes = [leaf.mesh.shape[x] for x in axes]
    sub = leaf.pieces[(slice(None),) * a + tuple(
        slice(i, i + 1) for i in np.unravel_index(k, sizes))]
    sub = sub.reshape(sub.shape[:a] + sub.shape[a + len(axes):])
    return sub, P(*(None if d == dim else e for d, e in enumerate(leaf.spec)))


def batch_block(leaf: Sharded, axes, k: int, n: int,
                device) -> torch.Tensor:
    """The rows of batch shard ``k`` (of ``n``, over the mesh ``axes`` that
    split the batch) of a ``Sharded`` leaf, whole in every other dim, on
    ``device``: only that block's pieces are gathered. A leaf that is not
    split over ``axes`` is gathered whole (it must then be one block)."""
    block = _block_pieces(leaf, axes, k)
    if block is None:
        if n != 1:
            raise NotImplementedError(
                f"a leaf of spec {leaf.spec} is not split over the batch "
                f"axes {tuple(axes)} of {n} shards")
        return gather(leaf, device)
    sub, spec = block
    return gather(Sharded(sub, spec, leaf.mesh, (), leaf.dtype), device)


def _over_lines(spec: P, mesh: Mesh) -> bool:
    """Does ``spec`` split a dim over the batch axes and "model" jointly:
    a cache's sequence where the batch is not split (``long_500k``'s
    layout, ``decode_state_specs``)?"""
    want = batch_axes(mesh) + (TP,)
    return len(want) > 1 and any(P.axes_of(e) == want for e in spec)


def _spec_leaves(specs):
    if isinstance(specs, P):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    elif isinstance(specs, (list, tuple)):
        for v in specs:
            yield from _spec_leaves(v)


def cache_row(specs, mesh: Mesh, axes, row) -> tuple:
    """The positions that hold batch shard ``row``'s cache pieces, in
    sequence order (``mesh.tensor_parallel``'s ``lines``): the row itself;
    or, where the batch is not split (no batch ``axes``) and ``specs``
    split a cache's sequence over the batch axes and "model", every
    position of those axes, row-major (the row, at batch index 0, first)."""
    if not axes and any(_over_lines(s, mesh) for s in _spec_leaves(specs)):
        return tuple(np.asarray(mesh.devices_of(batch_axes(mesh) + (TP,)),
                                dtype=object).reshape(-1))
    return tuple(row)


def row_block(leaf: Sharded, axes, k: int, n: int, row, lines=None) -> list:
    """Batch shard ``k``'s block of a ``Sharded`` leaf at each position of
    its row over "model" (``row``: the block's positions in "model"
    order), nothing gathered: where the spec splits a dim over "model"
    besides the batch over ``axes`` (a cache's sequence), each position's
    own piece, the tensor itself (a decode step writes it in place); a
    leaf split over the batch only, its block's piece at the row's first
    position, where the replicas sit (``None`` at the others); a leaf
    split over nothing, its block's ``n``-th of the rows: copied to every
    position where it is a per-row cursor (1-d), else at the row's first
    position as a leaf split over the batch only.

    ``lines`` (``cache_row``, when longer than the row): a batch that is
    not split, whose caches' sequence is split over the batch axes and
    "model"; such a leaf gives its piece at every position of ``lines``,
    and every other list is padded with ``None`` (a cursor copied) to
    their length."""
    M = len(row)
    out = lines or row
    block = _block_pieces(leaf, axes, k)
    if block is None:
        if not leaf.spec.mesh_axes():
            t = leaf.pieces.reshape(()).item()
            rows = t.shape[0] // n
            t = t.narrow(0, k * rows, rows)
            if t.ndim == 1:
                return [t.to(d) for d in out]
            return [t.to(row[0])] + [None] * (len(out) - 1)
        if not axes and n == 1 and _over_lines(leaf.spec, leaf.mesh):
            pieces = list(leaf.pieces.reshape(-1))
            if len(pieces) != len(out):
                raise ValueError(f"{len(pieces)} pieces of spec {leaf.spec} "
                                 f"on {len(out)} positions of lines")
            return pieces
        raise NotImplementedError(
            f"a leaf of spec {leaf.spec} on a row: not split over the "
            f"batch axes {tuple(axes)}")
    sub, spec = block
    rest = spec.mesh_axes()
    pad = [None] * (len(out) - M)
    if not rest:
        return [sub.reshape(()).item()] + [None] * (M - 1) + pad
    if rest != (TP,):
        raise NotImplementedError(
            f"a leaf of spec {leaf.spec} on a row: split over {rest} "
            f"besides the batch")
    return list(sub) + pad


def _shape_of(pieces: np.ndarray, spec: P, mesh: Mesh) -> list:
    first = pieces.flat[0]
    return [first.shape[d] * _size(mesh, P.axes_of(e))
            for d, e in enumerate(spec)] + list(first.shape[len(spec):])


def shard_rows(blocks: list, spec: P, mesh: Mesh, axes) -> Sharded:
    """The inverse of ``row_block``: ``blocks[k][j]`` batch shard ``k``'s
    tensor at position ``j`` of its row (of its ``lines``), made into the
    pieces of ``spec`` where they lie (nothing copied or moved): each
    position's own piece where the spec splits over "model" besides the
    batch, or over the batch axes and "model" with the batch not split;
    the row's first position's where it splits over the batch only; a leaf
    split over nothing is the blocks' first positions' rows joined
    (``all_gather``) on the mesh's first device."""
    hit = _batch_entry(spec, axes)
    devices = _spec_devices(spec, mesh)
    pieces = np.empty(devices.shape, dtype=object)
    if hit is None:
        if not spec.mesh_axes():
            whole = collectives.all_gather(
                collectives.shard_array([b[0] for b in blocks]), 0,
                mesh.first_device)
            one = np.empty((), dtype=object)
            one[()] = whole
            return Sharded(one, spec, mesh, whole.shape, whole.dtype)
        if axes or len(blocks) != 1 or not _over_lines(spec, mesh):
            raise NotImplementedError(
                f"spec {spec} on rows: not split over the batch axes "
                f"{tuple(axes)}")
        for j, idx in enumerate(np.ndindex(devices.shape)):
            pieces[idx] = blocks[0][j]
        return Sharded(pieces, spec, mesh, _shape_of(pieces, spec, mesh),
                       pieces.flat[0].dtype)
    _, a = hit
    names = spec.mesh_axes()
    t = names.index(TP) if TP in names else None
    sizes = [mesh.shape[x] for x in axes]
    for idx in np.ndindex(devices.shape):
        k = int(np.ravel_multi_index(idx[a:a + len(axes)], sizes))
        pieces[idx] = blocks[k][idx[t] if t is not None else 0]
    return Sharded(pieces, spec, mesh, _shape_of(pieces, spec, mesh),
                   pieces.flat[0].dtype)


def shard_blocks(blocks, spec: P, mesh: Mesh, axes) -> Sharded:
    """The inverse of ``batch_block``: the batch shards' row blocks (in
    row-major order over ``axes``) cut by ``spec`` into pieces on their
    positions, each piece from its own block (no block is joined whole).
    A spec that does not split over ``axes`` takes one block whole."""
    hit = _batch_entry(spec, axes)
    if hit is None:
        if len(blocks) != 1:
            raise NotImplementedError(
                f"spec {spec} does not split over the batch axes "
                f"{tuple(axes)} of {len(blocks)} shards")
        return shard(blocks[0], spec, mesh)
    dim, a = hit
    sizes = [mesh.shape[x] for x in axes]
    devices = _spec_devices(spec, mesh)
    pieces = np.empty(devices.shape, dtype=object)
    for idx in np.ndindex(devices.shape):
        block = blocks[int(np.ravel_multi_index(idx[a:a + len(axes)],
                                                sizes))]
        with _mesh.at(devices[idx]):
            pieces[idx] = _place(_cut(block, spec, mesh, idx, skip=dim),
                                 devices[idx])
    shape = list(blocks[0].shape)
    shape[dim] *= len(blocks)
    return Sharded(pieces, spec, mesh, shape, blocks[0].dtype)


def gather(leaf: Sharded, device=None, index=None) -> torch.Tensor:
    """The whole tensor of a ``Sharded`` leaf, on ``device`` (default: the
    device of its first piece). Dims are put back from the last spec entry
    to the first, each through ``collectives.all_gather`` over the array
    axes of that entry onto ``device``; a replicated leaf gives its one
    piece itself.

    ``index`` (mesh axis -> position) gathers over the other axes only: an
    entry that splits over an axis of ``index`` keeps the piece at that
    position (the tensor-parallel step's "model" piece of a position,
    gathered over the batch axes). A leaf that does not split over such an
    axis is whole, as GSPMD leaves it at every position."""
    arr, spec = leaf.pieces, leaf.spec
    if index:
        sel, entries = [], []
        for e in spec:
            names = P.axes_of(e)
            hit = [n for n in names if n in index]
            if hit and len(names) != 1:
                raise NotImplementedError(
                    f"a piece at {index} of spec {spec}: {names} split one "
                    f"dim jointly")
            sel.extend([index[hit[0]]] if hit else [slice(None)] * len(names))
            entries.append(None if hit else e)
        arr = arr[tuple(sel) + (Ellipsis,)]
        spec = P(*entries)
    for dim in reversed(range(len(spec))):
        n = len(P.axes_of(spec[dim]))
        if not n:
            continue
        lead = arr.shape[:arr.ndim - n]
        out = np.empty(lead, dtype=object)
        for idx in np.ndindex(lead):
            out[idx] = collectives.all_gather(arr[idx], dim, device)
        arr = out
    t = arr.reshape(()).item()
    return t if device is None else t.to(device)


def split_dim(spec: P, axis: str) -> Optional[int]:
    """The tensor dim ``spec`` splits over mesh ``axis``, or ``None``."""
    for dim, e in enumerate(spec):
        if axis in P.axes_of(e):
            return dim
    return None


def gather_layer(leaf: Sharded, i: int, device=None,
                 index=None) -> torch.Tensor:
    """Layer ``i`` of a stacked ``Sharded`` leaf (axis 0 the layers, which
    ``param_specs`` never splits), as ``gather`` gives the whole leaf: the
    pieces' ``[i]`` views gathered over the spec's other axes onto
    ``device`` (``collectives.all_gather``), an ``index`` axis keeping its
    position's piece."""
    if leaf.spec and leaf.spec[0] is not None:
        raise NotImplementedError(
            f"a layer of a stacked leaf of spec {leaf.spec}: its layer axis "
            f"is split")
    views = np.empty(leaf.pieces.shape, dtype=object)
    for idx in np.ndindex(views.shape):
        views[idx] = leaf.pieces[idx][i]
    return gather(Sharded(views, P(*leaf.spec[1:]), leaf.mesh,
                          leaf.shape[1:], leaf.dtype), device, index)


# ------------------------------------------------------------ ZeRO-3
def _dict_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _dict_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _dict_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _dict_leaves(v)
    else:
        yield tree


class _Sums:
    """One ``Sharded`` leaf's gradient in a ZeRO-3 step: one tensor per
    piece, the piece's size, where the piece lives (made at the leaf's
    first gradient), summed in place as backward makes each layer's (or,
    ``layer=None``, the whole leaf's) gradient at each batch shard; and
    the layers whose sum has begun."""

    __slots__ = ("leaf", "pieces", "begun")

    def __init__(self, leaf: Sharded):
        self.leaf = leaf
        self.pieces = None
        self.begun = set()

    def gather(self, layer, device, index) -> torch.Tensor:
        with _mesh.at(device):
            if layer is None:
                return gather(self.leaf, device, index)
            return gather_layer(self.leaf, layer, device, index)

    def add(self, layer, targets, grads) -> None:
        """One batch shard's gradient of ``layer`` (one per target position
        ``(device, index)``, each of ``gather``'s shape there) cut into the
        pieces and added where they live: a position's own "model" piece
        cut over the other axes; a leaf not split by ``index`` first
        summed over the positions in order (``psum``: a tensor-parallel
        row's sum) and then cut. Batch shards that add in row-major order
        give ``collectives.reduce_scatter``'s bits."""
        leaf = self.leaf
        if self.pieces is None:
            self.pieces = np.empty(leaf.pieces.shape, dtype=object)
            for idx in np.ndindex(leaf.pieces.shape):
                self.pieces[idx] = torch.empty_like(leaf.pieces[idx])
        spec = leaf.spec if layer is None else P(*leaf.spec[1:])
        names = spec.mesh_axes()
        if len(grads) > 1 and not any(n in (targets[0][1] or ())
                                      for n in names):
            grads = [collectives.psum(collectives.shard_array(grads),
                                      0).item()]
            targets = targets[:1]
        pairs = []
        for g, (_, index) in zip(grads, targets):
            index = index or {}
            sub = P(*(None if any(n in index for n in P.axes_of(e)) else e
                      for e in spec))
            for idx in np.ndindex(self.pieces.shape):
                if any(index.get(n, k) != k for n, k in zip(names, idx)):
                    continue
                into = self.pieces[idx]
                pairs.append((_cut(g, sub, leaf.mesh, tuple(
                    k for n, k in zip(names, idx) if n not in index)),
                    into if layer is None else into[layer]))
        collectives.reduce_scatter_into(pairs, layer not in self.begun)
        self.begun.add(layer)

    def result(self) -> Sharded:
        """The summed pieces; a layer (a leaf) no gradient reached is
        zeros, as ``jax.value_and_grad`` gives."""
        leaf = self.leaf
        out = np.empty(leaf.pieces.shape, dtype=object)
        for idx in np.ndindex(out.shape):
            piece = leaf.pieces[idx]
            with _mesh.at(_mesh.device_of(piece)):
                if self.pieces is None:
                    out[idx] = torch.zeros_like(piece)
                    continue
                out[idx] = self.pieces[idx]
                if None not in self.begun:
                    for i in range(leaf.shape[0]):
                        if i not in self.begun:
                            out[idx][i].zero_()
        return Sharded(out, leaf.spec, leaf.mesh, leaf.shape, leaf.dtype)


class _Gather(torch.autograd.Function):
    """A leaf's layer (the whole leaf: ``layer=None``) gathered onto each
    target position, and in backward its gradient cut into the leaf's
    pieces and added where they live (``_Sums.add``), then freed: no
    gradient the size of a gathered leaf outlives its layer's backward.
    ``anchor`` is a tensor that requires grad, so that the outputs do."""

    @staticmethod
    def forward(ctx, anchor, sums, layer, targets):
        ctx.sums, ctx.layer, ctx.targets = sums, layer, targets
        # an alias: a piece handed out as it is stays a leaf of no graph
        return tuple(sums.gather(layer, dev, index).detach()
                     for dev, index in targets)

    @staticmethod
    def backward(ctx, *grads):
        with _mesh.tracked():
            ctx.sums.add(ctx.layer, ctx.targets, grads)
        return None, None, None, None


def _gathered(sums, layer, targets, anchor) -> list:
    """A subtree's ``layer`` (``None``: its whole leaves) gathered through
    ``_Gather`` onto every target: one tree per target."""
    outs = _dict_map(lambda s: _Gather.apply(anchor, s, layer, targets), sums)
    return [_dict_map(lambda o: o[j], outs) for j in range(len(targets))]


class Layers:
    """A stacked subtree of a ZeRO-3 step's parameters (axis 0 the layers)
    as the model's block loops take it: ``layer(i)`` gathers layer ``i`` of
    each leaf onto every target position (one tree per target), and its
    backward cuts that layer's gradient into the pieces. A block takes its
    layer inside its checkpoint (``models.transformer``), so that the
    checkpoint keeps no gathered weight and the recompute gathers again."""

    def __init__(self, sums, targets, anchor):
        self.sums, self.targets, self.anchor = sums, targets, anchor

    @property
    def depth(self) -> int:
        return next(_dict_leaves(self.sums)).leaf.shape[0]

    def layer(self, i: int) -> list:
        return _gathered(self.sums, i, self.targets, self.anchor)


class Zero3:
    """One sharded train step's parameters and gradients, ZeRO-3 as GSPMD
    compiles the reference's scanned step: ``trees(targets)`` hands a batch
    shard its parameter trees, one per target position ``(device,
    index)`` (a tensor-parallel row's, ``index={"model": j}``, or one
    device's, ``index=None``): each ``stacked`` subtree as ``Layers``,
    gathered a layer at a time inside the blocks, each other leaf gathered
    now; backward adds each gradient into the leaf's pieces as it is made
    (``_Sums``, the owner of the step's accumulators), and ``grads()``
    gives them as ``Sharded`` leaves cut as the parameters are."""

    def __init__(self, params, stacked=()):
        self.sums = _dict_map(_Sums, params)
        self.stacked = tuple(stacked)
        first = next(_dict_leaves(params)).mesh.first_device
        with _mesh.at(first):
            self.anchor = torch.zeros((), device=first, requires_grad=True)

    def trees(self, targets) -> list:
        targets = list(targets)
        out = [{} for _ in targets]
        for key, sub in self.sums.items():
            per = ([Layers(sub, targets, self.anchor)] * len(targets)
                   if key in self.stacked
                   else _gathered(sub, None, targets, self.anchor))
            for t, p in zip(out, per):
                t[key] = p
        return out

    def grads(self):
        return _dict_map(lambda s: s.result(), self.sums)


def shard_tree(tree, specs, mesh: Mesh):
    """Every tensor leaf of ``tree`` cut by its spec in ``specs`` (the same
    tree of ``P``), as ``Sharded`` leaves: the reference's
    ``jax.device_put(tree, make_sharding(specs, mesh))``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(shard_tree(getattr(tree, k), getattr(specs, k),
                                       mesh) for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return shard(tree, specs, mesh)
    return tree


def gather_tree(tree):
    """The inverse of ``shard_tree``: every ``Sharded`` leaf gathered whole
    on its first piece's device; other leaves as they are."""
    if isinstance(tree, Sharded):
        return gather(tree)
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(getattr(tree, k))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return tree


def batch_block_tree(tree, axes, k: int, n: int, device):
    """``batch_block`` of every ``Sharded`` leaf of ``tree``; other leaves
    as they are."""
    if isinstance(tree, Sharded):
        return batch_block(tree, axes, k, n, device)
    if isinstance(tree, dict):
        return {key: batch_block_tree(v, axes, k, n, device)
                for key, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(batch_block_tree(getattr(tree, f), axes, k, n,
                                             device) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(batch_block_tree(v, axes, k, n, device)
                          for v in tree)
    return tree


def row_block_tree(tree, axes, k: int, n: int, row, lines=None) -> list:
    """``row_block`` of every ``Sharded`` leaf of ``tree``: one tree per
    position of ``row`` (of ``lines``, where given); other leaves as they
    are at every position."""
    L = len(lines or row)
    if isinstance(tree, Sharded):
        return row_block(tree, axes, k, n, row, lines)
    if isinstance(tree, dict):
        parts = {key: row_block_tree(v, axes, k, n, row, lines)
                 for key, v in tree.items()}
        return [{key: parts[key][j] for key in parts} for j in range(L)]
    if hasattr(tree, "_fields"):
        parts = [row_block_tree(getattr(tree, f), axes, k, n, row, lines)
                 for f in tree._fields]
        return [type(tree)(*(p[j] for p in parts)) for j in range(L)]
    if isinstance(tree, (list, tuple)):
        parts = [row_block_tree(v, axes, k, n, row, lines) for v in tree]
        return [type(tree)(p[j] for p in parts) for j in range(L)]
    return [tree] * L


def shard_rows_tree(blocks: list, specs, mesh: Mesh, axes):
    """``shard_rows`` leaf by leaf: ``blocks[k]`` batch shard ``k``'s trees,
    one per position of its row or lines (the structure of the first
    position's; a subtree another position does not hold is ``None``
    there); a non-tensor leaf is the first block's first position's."""
    def sub(t, get):
        return None if t is None else get(t)

    def walk(trees, sp):
        first = trees[0][0]
        if isinstance(first, torch.Tensor):
            return shard_rows(trees, sp, mesh, axes)
        if isinstance(first, dict):
            return {key: walk([[sub(t, lambda t: t[key]) for t in r]
                               for r in trees], sp[key])
                    for key in first}
        if hasattr(first, "_fields"):
            return type(first)(*(walk([[sub(t, lambda t: getattr(t, f))
                                        for t in r] for r in trees],
                                      getattr(sp, f))
                                 for f in first._fields))
        if isinstance(first, (list, tuple)):
            return type(first)(walk([[sub(t, lambda t: t[i]) for t in r]
                                     for r in trees], sp[i])
                               for i in range(len(first)))
        return first

    return walk(blocks, specs)


def shard_blocks_tree(blocks: list, specs, mesh: Mesh, axes):
    """``shard_blocks`` leaf by leaf over the batch shards' trees (one tree
    of one structure each) and their specs; a non-tensor leaf is the first
    block's."""
    def walk(trees, sp):
        first = trees[0]
        if isinstance(first, torch.Tensor):
            return shard_blocks(list(trees), sp, mesh, axes)
        if isinstance(first, dict):
            return {k: walk([t[k] for t in trees], sp[k]) for k in first}
        if hasattr(first, "_fields"):
            return type(first)(*(walk([getattr(t, k) for t in trees],
                                      getattr(sp, k))
                                 for k in first._fields))
        if isinstance(first, (list, tuple)):
            return type(first)(walk([t[i] for t in trees], sp[i])
                               for i in range(len(first)))
        return first

    return walk(blocks, specs)


# ------------------------------------------------------------ hint context
# Model code is mesh-agnostic; distribution-sensitive spots ask for
# placement hints through this context. The port has no sharded tensor type
# for a hint to constrain, so ``hint`` gives its input back; what the active
# mesh changes is the MoE layer's path (``transformer.apply_channel`` runs
# ``moe.moe_apply_a2a`` under it, as the reference does).
_HINT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_hint_mesh", default=None
)


@contextlib.contextmanager
def hint_mesh(mesh: Mesh):
    tok = _HINT_MESH.set(mesh)
    try:
        yield
    finally:
        _HINT_MESH.reset(tok)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``hint_mesh``, or ``None``."""
    return _HINT_MESH.get()


def hint_spec(shape, *axes, mesh: Optional[Mesh] = None) -> Optional[P]:
    """The spec the reference's ``hint`` would constrain a value of
    ``shape`` to under ``mesh`` (default: the active hint mesh; ``None``
    when there is none).

    ``axes`` entries: None | "batch" (-> (pod, data) as divisible) |
    "seq" (-> "model", plus any batch axes the batch dim could not use —
    matching ``decode_state_specs``' cache layout for batch=1 long-context)
    | "model" | explicit axis name. Axes that don't divide are dropped.
    """
    mesh = mesh if mesh is not None else _HINT_MESH.get()
    if mesh is None:
        return None
    shape = tuple(shape)
    spec = []
    batch_used = True
    for i, a in enumerate(axes):
        if a is None:
            spec.append(None)
            continue
        if a == "batch":
            bd = batch_axes(mesh)
            ok = bool(bd) and shape[i] % _size(mesh, bd) == 0
            batch_used = ok
            spec.append(bd if ok else None)
            continue
        if a == "seq":
            cands = []
            if not batch_used:
                cands.append(batch_axes(mesh) + ((TP,) if TP in
                                                 mesh.axis_names else ()))
            if TP in mesh.axis_names:
                cands.append((TP,))
            chosen = None
            for cand in cands:
                cand = tuple(c for c in cand if c)
                if cand and shape[i] % _size(mesh, cand) == 0:
                    chosen = cand if len(cand) > 1 else cand[0]
                    break
            spec.append(chosen)
            continue
        if a in mesh.axis_names and shape[i] % mesh.shape[a] == 0:
            spec.append(a)
        else:
            spec.append(None)
    return P(*spec)


def hint(x, *axes):
    """The reference's ``with_sharding_constraint(x, P(*axes))`` under an
    active hint mesh: here ``x`` itself, with or without a mesh (its spec
    is ``hint_spec(x.shape, *axes)``)."""
    return x
