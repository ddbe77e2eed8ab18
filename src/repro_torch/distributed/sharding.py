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
``collectives.all_gather``.
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


def batch_block(leaf: Sharded, axes, k: int, n: int,
                device) -> torch.Tensor:
    """The rows of batch shard ``k`` (of ``n``, over the mesh ``axes`` that
    split the batch) of a ``Sharded`` leaf, whole in every other dim, on
    ``device``: only that block's pieces are gathered. A leaf that is not
    split over ``axes`` is gathered whole (it must then be one block)."""
    hit = _batch_entry(leaf.spec, axes)
    if hit is None:
        if n != 1:
            raise NotImplementedError(
                f"a leaf of spec {leaf.spec} is not split over the batch "
                f"axes {tuple(axes)} of {n} shards")
        return gather(leaf, device)
    dim, a = hit
    sizes = [leaf.mesh.shape[x] for x in axes]
    sub = leaf.pieces[(slice(None),) * a + tuple(
        slice(i, i + 1) for i in np.unravel_index(k, sizes))]
    sub = sub.reshape(sub.shape[:a] + sub.shape[a + len(axes):])
    spec = P(*(None if d == dim else e for d, e in enumerate(leaf.spec)))
    return gather(Sharded(sub, spec, leaf.mesh, (), leaf.dtype), device)


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


def gather(leaf: Sharded, device=None) -> torch.Tensor:
    """The whole tensor of a ``Sharded`` leaf, on ``device`` (default: the
    device of its first piece). Dims are put back from the last spec entry
    to the first, each through ``collectives.all_gather`` over the array
    axes of that entry; a replicated leaf gives its one piece itself."""
    arr = leaf.pieces
    for dim in reversed(range(len(leaf.spec))):
        n = len(P.axes_of(leaf.spec[dim]))
        if not n:
            continue
        lead = arr.shape[:arr.ndim - n]
        out = np.empty(lead, dtype=object)
        for idx in np.ndindex(lead):
            out[idx] = collectives.all_gather(arr[idx], dim)
        arr = out
    t = arr.reshape(()).item()
    return t if device is None else t.to(device)


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
