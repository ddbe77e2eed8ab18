"""Ahead-of-time dry run of every (arch x shape x mesh) cell on fake tensors:
the reference's ``launch/dryrun.py``, with ``FakeTensorMode`` in place of
XLA's lower-and-compile on fake devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch NAME ...] [--shape NAME ...] [--mesh single|multi|both]
        [--delta] [--stkde] [--skip-existing] [--out results/torch/dryrun]

A cell builds the port's own step for its shape (``build_train``: the
sharded train step; ``build_prefill`` / ``build_decode``: the sharded
prefill and decode steps, ``sharded_prefill`` / ``sharded_decode``) on
the production mesh (16 x 16, or 2 x 16 x 16), and ``account`` runs it
once under ``FakeTensorMode``: shapes, dtypes and devices, no storage, no
card touched. What a cell records (one JSON per cell, written atomically,
with the reference's keys):

* ``memory``: live storage bytes per mesh position (a storage once, however
  many views share it; saved-for-backward tensors live until backward
  frees them), the fullest position's high-water mark split into its
  arguments (the placed state and inputs), outputs and temporaries;
  ``fits_hbm`` compares it with the H100's capacity.
* ``cost.flops``: every op's count by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``), over every position: the
  matmul family and convolutions only, elementwise work is not counted.
  ``cost.bytes``: every op's input and output tensor bytes, summed as
  XLA's "bytes accessed" sums its ops' operand and result sizes (view ops,
  free in XLA too, are not counted).
* ``collectives``: the bytes the busiest position receives per collective
  kind, counted by ``distributed.collectives.counting`` (the port's
  collectives are Python functions that see every tensor they move).

Every position of a production mesh sits on one fake ``meta`` device and
the mesh carries a position identity (``Mesh(positions=True)``): a
``torch.device`` index has 8 bits, so 256 or 512 distinct fake devices do
not exist. The accounting places each new storage at the position of its
op's inputs, or where a mesh position's device object is passed (``.to``,
``device=``), or at the position whose work runs now
(``distributed.mesh.at``); a ``.to`` between two positions is a copy on the
target, and its backward a copy back. ``tests/test_torch_dryrun.py`` holds
this to the count with each position on its own ``meta:k`` device.

What is tensor-parallel and what is not (ROADMAP §C.7): the train step of
every ``tp`` config (attention, MLA or not, with a swiglu, gelu or MoE
channel; any such config whose batch is not split over "model") runs each
batch shard over its row of positions, each position computing with its
"model" pieces, as a GSPMD compile partitions it: Megatron's column / row
splits, MLA's heads, ``E/M`` whole experts a position (dbrx's all-to-all
inside the row under the hint mesh), the embedding, head and
cross-entropy by vocabulary. An ``fsdp`` config (zamba2, rwkv6, smollm,
starcoder2) splits its batch over "model" and computes whole leaves per
batch shard, as the reference's layout does. Either way the step is
ZeRO-3, as GSPMD compiles the reference's scanned step: each block gathers
its own layer over "data" inside its checkpoint (again in the recompute)
and backward cuts that layer's gradient into piece-size sums at the
pieces' positions as it makes it (``sharding.Zero3``), so the count sees
a gathered layer freed after its block, the sums at the pieces, and each
layer's cut as ``reduce-scatter`` traffic. The sharded prefill and decode
of every config
``tp_covers(cfg, serving=True)`` takes (serving splits the weights over
"model": the ``tp`` configs, and zamba2 and rwkv6 with Mamba2's packed
``in_proj`` and heads, RWKV6's projections and heads and zamba2's shared
attention sites split as ``param_specs`` splits them) run each batch shard
on its row of positions too, the cache's sequence split over the row (the
reference's flash-decoding layout), the recurrent states, which
``decode_state_specs`` splits by batch only, at the row's first position.
A batch of one (``long_500k``) is one row whose caches lie over every
position of ``(data, model)``: the positions outside the row score their
lines and join the combine. The cells report the port's own figure. A
moved tensor's gradient counts as traffic too (``collectives``). No
number here was measured on a card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS
from ..distributed import collectives
from ..distributed import mesh as mesh_lib
from ..distributed import sharding
from ..models import model as model_lib
from ..models import moe
from ..models.transformer import tree_map
from ..train import OptimizerConfig
from ..train import optimizer as opt_lib
from ..train.train_step import (_tp_applies, make_sharded_train_step,
                                row_pieces, shard_train_state)
from . import roofline as rl
from . import specs as specs_lib
from .mesh import make_production_mesh

# torch.cuda.get_device_properties(0).total_memory on "NVIDIA H100 80GB
# HBM3" (torch 2.11.0+cu128), read on the card
HBM_PER_CHIP = 85_017_493_504
CHIP = "NVIDIA H100 80GB HBM3"
# the H100 SXM's published dense bf16 rate, HBM3 rate and NVLink rate per
# direction: the roofline's hardware (not measured here)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

FAKE = torch.device("meta")
_DEVICE = torch.ops.prim.device.default    # a query, not an op


# ------------------------------------------------------------- accounting
class _Move(torch.autograd.Function):
    """A ``.to`` between two positions of one fake device: a copy at the
    target, and in backward a copy back at the source, as ``.to`` between
    two devices is."""

    @staticmethod
    def forward(ctx, t, tracker, dst, src, dtype, fmt):
        ctx.tracker, ctx.src, ctx.dtype = tracker, src, t.dtype
        with tracker.forcing(dst):
            return t.to(dtype=dtype, memory_format=fmt, copy=True)

    @staticmethod
    def backward(ctx, g):
        with ctx.tracker.forcing(ctx.src):
            return g.to(dtype=ctx.dtype, copy=True), None, None, None, None, \
                None


def _device_position(x) -> Optional[int]:
    return (mesh_lib.position_of(x) if isinstance(x, torch.device)
            else None)


class _Placer(TorchFunctionMode):
    """The position identity's half above autograd: a mesh position's
    device object passed to a torch function places what it creates there,
    and ``Tensor.to`` such an object from another position is a ``_Move``."""

    def __init__(self, tracker: "_Tracker"):
        super().__init__()
        self.tracker = tracker

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dst = None
        for a in (*args, *kwargs.values()):
            dst = _device_position(a)
            if dst is not None:
                break
        if dst is None:
            out = func(*args, **kwargs)
            # a constructor (torch.tensor) may build its tensor below the
            # modes: it is where the current work runs
            self.tracker.adopt(out)
            return out
        if func is torch._C.TensorBase.to and isinstance(args[0],
                                                         torch.Tensor):
            t = args[0]
            src = self.tracker.position(t)
            if t.device.type == FAKE.type and src != dst:
                dtype = kwargs.get("dtype")
                for a in args[1:]:
                    if isinstance(a, torch.dtype):
                        dtype = a
                dtype = dtype or t.dtype
                fmt = kwargs.get("memory_format", torch.preserve_format)
                if t.requires_grad and torch.is_grad_enabled():
                    return _Move.apply(t, self.tracker, dst, src, dtype, fmt)
                with self.tracker.forcing(dst):
                    return t.to(dtype=dtype, memory_format=fmt, copy=True)
        with self.tracker.forcing(dst):
            out = func(*args, **kwargs)
        # a constructor (torch.tensor) may build its tensor below the modes
        self.tracker.adopt(out, dst)
        return out


def _flat(values) -> list:
    """The tensors among ``values`` and in their lists and tuples (an op's
    arguments or results: no deeper nesting)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, sharding.Sharded):
        yield from (p for p in tree.pieces.flat)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _Tracker(TorchDispatchMode):
    """Live storage bytes per position, their high-water marks and the
    bytes every op reads and writes. A storage is placed once, when an op
    first returns it: at the position being forced (``forcing``), else at
    its op's first placed input's, else at ``mesh.at``'s current one, else
    (backward, outside any ``at``) at the last op's. With ``by_device`` (no
    position identity) a storage's position is its fake device's index."""

    def __init__(self, by_device: bool):
        super().__init__()
        self.by_device = by_device
        self.live: Dict[int, tuple] = {}       # id(storage) -> (pos, bytes)
        self.held: Dict[Any, int] = {}         # pos -> live bytes
        self.peak: Dict[Any, int] = {}
        self.largest: Dict[Any, int] = {}      # pos -> largest storage
        self.forced = None
        self.last = None                       # the last op's input position
        self.bytes_accessed = 0.0
        self.flops = 0
        self.closed = False

    # -- placement
    @contextlib.contextmanager
    def forcing(self, pos):
        prev, self.forced = self.forced, pos
        try:
            yield
        finally:
            self.forced = prev

    def position(self, t: torch.Tensor):
        entry = self.live.get(id(t.untyped_storage()))
        return entry[0] if entry is not None else None

    def _add(self, st, pos) -> None:
        n = st.nbytes()
        self.live[id(st)] = (pos, n)
        self.held[pos] = self.held.get(pos, 0) + n
        if n > self.largest.get(pos, 0):
            self.largest[pos] = n
        if self.held[pos] > self.peak.get(pos, 0):
            self.peak[pos] = self.held[pos]
        weakref.finalize(st, self._free, id(st))

    def _free(self, key) -> None:
        if self.closed:
            return
        pos, n = self.live.pop(key)
        self.held[pos] -= n

    def adopt(self, tree, pos=None) -> None:
        """Place the storages of ``tree``'s tensors not yet placed: by their
        device, or at ``pos``, or at the current position."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in self.live and t.device.type == FAKE.type:
                self._add(st, self._device_pos(t) if self.by_device
                          else pos if pos is not None
                          else mesh_lib.current_position())

    @staticmethod
    def _device_pos(t: torch.Tensor):
        return t.device.index or 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:
            return out
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = _flat(args) + _flat(kwargs.values())
        outs = _flat((out,))
        if outs and not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        pos = self.forced
        if pos is None and not self.by_device:
            for t in ins:
                pos = self.position(t)
                if pos is not None:
                    self.last = pos
                    break
            if pos is None:
                pos = mesh_lib.current_position()
            if pos is None:
                # made from nothing outside any ``at``: backward's formulas
                # make such scalars beside the gradient they work on
                pos = self.last
        for o in outs:
            st = o.untyped_storage()
            if id(st) in self.live or o.device.type != FAKE.type:
                continue
            self._add(st, self._device_pos(o) if self.by_device else pos)
        return out


def _fake_like(tree, device=FAKE):
    """Every tensor leaf of ``tree`` made anew on ``device`` with its shape,
    strides and dtype (a fake tensor under the active ``FakeTensorMode``)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                   dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _fake_like(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_fake_like(getattr(tree, k), device)
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_like(v, device) for v in tree)
    return tree


def account(fn: Callable, *args, place: Optional[Callable] = None,
            mesh=None) -> dict:
    """Run ``fn(*place(*args))`` (or ``fn(*args)``) once under a fresh
    ``FakeTensorMode`` and account it: ``args`` give only shapes, strides
    and dtypes (any tensors: real, meta or fake), each made anew as a fake
    tensor on the fake ``meta`` device. ``place`` (the sharded state's
    placement) runs first; what it leaves live are the arguments.

    ``mesh``: the mesh ``fn`` and ``place`` run on. One made with
    ``positions=True`` is accounted per position (its devices all the fake
    device); one of distinct ``meta:k`` devices per device; ``None`` means
    one device.

    Returns ``memory`` (the fullest position's ``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``temp_size_in_bytes`` = ``temp_per_device``
    = peak minus arguments, ``peak_bytes``; ``per_position`` peaks;
    ``largest_storage``: the largest storage each position made while
    ``fn`` ran), ``cost`` (``flops``, ``bytes``), ``collectives``,
    ``seconds`` and ``ops``."""
    by_device = mesh is None or not mesh.has_positions
    t0 = time.perf_counter()
    tracker = _Tracker(by_device)
    with FakeTensorMode(allow_non_fake_inputs=True), contextlib.ExitStack() \
            as stack:
        fargs = _fake_like(args)
        if not by_device:
            stack.enter_context(mesh_lib.tracking(
                mesh, tracker.position, lambda: _Placer(tracker)))
            stack.enter_context(_Placer(tracker))
        stack.enter_context(tracker)
        if place is not None:
            fargs = place(*fargs)
        tracker.adopt(fargs)
        args_held = dict(tracker.held)
        tracker.peak = dict(tracker.held)
        tracker.largest = {}
        tracker.bytes_accessed = 0.0
        tracker.flops = 0
        with collectives.counting() as count:
            out = fn(*fargs)
        outs = {}
        seen = set()
        for t in _tensors(out):
            st = t.untyped_storage()
            entry = tracker.live.get(id(st))
            if entry is None or id(st) in seen:
                continue
            seen.add(id(st))
            outs[entry[0]] = outs.get(entry[0], 0) + entry[1]
        result_coll = count.result()
        tracker.closed = True
        del out, fargs
    fullest = max(tracker.peak, key=lambda p: (tracker.peak[p], str(p)),
                  default=0)
    peak = tracker.peak.get(fullest, 0)
    arg = args_held.get(fullest, 0)
    return {
        "memory": {
            "argument_size_in_bytes": int(arg),
            "output_size_in_bytes": int(outs.get(fullest, 0)),
            "temp_size_in_bytes": int(peak - arg),
            "temp_per_device": int(peak - arg),
            "peak_bytes": int(peak),
            "fullest_position": str(fullest),
            "per_position": {str(k): int(v)
                             for k, v in sorted(tracker.peak.items(),
                                                key=lambda kv: str(kv[0]))},
            "largest_storage": {str(k): int(v) for k, v in sorted(
                tracker.largest.items(), key=lambda kv: str(kv[0]))},
        },
        "cost": {"flops": float(tracker.flops),
                 "bytes": float(tracker.bytes_accessed)},
        "collectives": result_coll,
        "seconds": time.perf_counter() - t0,
    }


# ------------------------------------------------------------- cell builders
class Cell(NamedTuple):
    """A built cell: ``fn(*place(*args))`` is the step; ``args`` are whole
    shape-only tensors (meta), ``place`` cuts them onto the mesh."""
    fn: Callable
    place: Callable
    args: tuple


def _batch_shards(mesh, tokens, include_model: bool = False):
    """The batch shards' devices (row-major) and rows each, as
    ``data_specs`` splits ``tokens``'s leading dim; and the mesh axes."""
    spec = sharding.data_specs({"t": tokens}, mesh,
                               include_model=include_model)["t"]
    axes = sharding.P.axes_of(spec[0])
    devs = np.asarray(mesh.devices_of(axes), dtype=object).reshape(-1)
    return devs, tokens.shape[0] // len(devs), axes


def _shard_dispatch(cfg, n_shards: int, n_tokens: int, prev, dev, k: int):
    """Batch shard ``k``'s ``moe.Dispatch`` for a MoE config on several
    batch shards (the global capacity, the offsets carried from ``prev``),
    else ``None``."""
    if cfg.mlp != "moe" or n_shards == 1:
        return None
    return moe.Dispatch(n_tokens, prev.carried(dev) if prev is not None
                        else (), shard=k)


def _dispatching(d):
    return moe.global_dispatch(d) if d is not None else \
        contextlib.nullcontext()


# which path the sharded prefill and decode took, one count a call: "row"
# (each batch shard on its row of "model" positions, the cache split by
# sequence) or "whole leaves" (read and cleared by callers that must know)
serve_paths: collections.Counter = collections.Counter()


def _row_grid(mesh, axes) -> np.ndarray:
    """The batch shards' rows of "model" positions: (shards, M)."""
    return np.asarray(mesh.devices_of(tuple(axes) + (sharding.TP,)),
                      dtype=object).reshape(-1, mesh.shape[sharding.TP])


def _whole_vocab(cfg, logits, row):
    """A row's logits whole on its first position: the positions' ranges
    of the vocabulary gathered there (a whole head's logits as they are)."""
    if logits[0].shape[-1] == cfg.vocab:
        return logits[0]
    return collectives.all_gather(collectives.shard_array(logits), -1, row[0])


def _rows_prefill(cfg, mesh, max_seq, state_specs, params, batch):
    _, rows, axes = _batch_shards(mesh, batch["tokens"])
    grid = _row_grid(mesh, axes)
    n_tok = batch["tokens"].numel()
    logits, states, disp = [], [], None
    for k, row in enumerate(map(tuple, grid)):
        lines = sharding.cache_row(state_specs, mesh, axes, row)
        with mesh_lib.at(row[0]), mesh_lib.tensor_parallel(row, lines):
            disp = _shard_dispatch(cfg, len(grid), n_tok, disp, row[0], k)
            ps = row_pieces(params, row)
            parts = mesh_lib.each(lambda dev: {
                n: v.narrow(0, k * rows, rows).to(dev)
                for n, v in batch.items()}, row)
            kw = {n: [p[n] for p in parts] for n in parts[0] if n != "tokens"}
            with _dispatching(disp):
                lg, st = model_lib.prefill_tp(
                    cfg, ps, [p["tokens"] for p in parts], max_seq, **kw)
            del ps
            logits.append(_whole_vocab(cfg, lg, row))
        states.append(st)
    return (collectives.all_gather(collectives.shard_array(logits), 0),
            sharding.shard_rows_tree(states, state_specs, mesh, axes))


def _rows_decode(cfg, mesh, state_specs, params, state, token):
    _, rows, axes = _batch_shards(mesh, token)
    grid = _row_grid(mesh, axes)
    logits, states, disp = [], [], None
    for k, row in enumerate(map(tuple, grid)):
        lines = sharding.cache_row(state_specs, mesh, axes, row)
        with mesh_lib.at(row[0]), mesh_lib.tensor_parallel(row, lines):
            disp = _shard_dispatch(cfg, len(grid), token.numel(), disp,
                                   row[0], k)
            ps = row_pieces(params, row)
            st = sharding.row_block_tree(state, axes, k, len(grid), row,
                                         lines)
            toks = mesh_lib.each(
                lambda dev: token.narrow(0, k * rows, rows).to(dev), row)
            with _dispatching(disp):
                lg, st = model_lib.decode_step_tp(cfg, ps, toks, st)
            del ps
            logits.append(_whole_vocab(cfg, lg, row))
        states.append(st)
    return (collectives.all_gather(collectives.shard_array(logits), 0),
            sharding.shard_rows_tree(states, state_specs, mesh, axes))


def sharded_prefill(cfg, mesh, max_seq: int, state_specs):
    """The sharded prefill step the reference's jit with ``in_shardings``
    computes: ``(params, batch) -> (logits, state)``. ``params`` are
    ``Sharded`` leaves, ``batch`` whole tensors (``tokens``, and the
    frontend's stubs), split into batch shards by ``data_specs``; a MoE
    config's shards run under ``moe.global_dispatch``, so the capacity and
    slots are the global batch's. The logits come back whole on the first
    batch shard's device, the decode state cut by ``state_specs``
    (``decode_state_specs``).

    The layout decides the path, as for the train step
    (``train_step._tp_applies(..., serving=True)``): where the config is
    one ``transformer.tp_covers(cfg, serving=True)`` takes, "model" has
    more than one position and a leaf's spec splits it, each batch shard
    runs ``model.prefill_tp`` on its row of "model" positions with each
    position's pieces, and each position of ``sharding.cache_row`` (the
    row, or with a batch that is not split every position the cache lies
    on) keeps the lines of its piece of the cache (the flash-decoding
    layout; "row" in ``serve_paths``).
    Otherwise each batch shard gathers the parameters whole at its
    position and runs the one-device ``prefill`` on its rows, and the
    state is cut from each shard's rows ("whole leaves")."""
    def fn(params, batch):
        if _tp_applies(cfg, mesh, params, False, serving=True):
            serve_paths["row"] += 1
            return _rows_prefill(cfg, mesh, max_seq, state_specs, params,
                                 batch)
        serve_paths["whole leaves"] += 1
        devs, rows, axes = _batch_shards(mesh, batch["tokens"])
        n_tok = batch["tokens"].numel()
        logits, states, disp = [], [], None
        for k, dev in enumerate(devs):
            with mesh_lib.at(dev):
                disp = _shard_dispatch(cfg, len(devs), n_tok, disp, dev, k)
                here = tree_map(lambda p: sharding.gather(p, dev), params)
                part = {n: v.narrow(0, k * rows, rows).to(dev)
                        for n, v in batch.items()}
                with _dispatching(disp):
                    lg, st = model_lib.prefill(cfg, here, part.pop("tokens"),
                                               max_seq, **part)
                del here
            logits.append(lg)
            states.append(st)
        return (collectives.all_gather(collectives.shard_array(logits), 0),
                sharding.shard_blocks_tree(states, state_specs, mesh, axes))

    return fn


def sharded_decode(cfg, mesh, state_specs):
    """The sharded decode step: ``(params, state, token) -> (logits,
    state)`` with ``state`` cut by ``state_specs``.

    On rows (``sharded_prefill``'s rule): each batch shard's positions
    take their own pieces of the state (``sharding.row_block_tree``:
    nothing gathered) and run ``model.decode_step_tp`` (the queries
    gathered over the row, each position scoring its own lines, the
    flash-decoding combine), the new line written in place into the
    piece that holds the cursor; the state comes back as those pieces
    (``sharding.shard_rows_tree``), so the caller's are updated as
    ``decode_step`` updates its caches. Otherwise each batch shard
    gathers the parameters and its rows of the state (only its block's
    pieces) at its position, runs the one-device ``decode_step`` and its
    new rows are cut back into new pieces."""
    def fn(params, state, token):
        if _tp_applies(cfg, mesh, params, False, serving=True):
            serve_paths["row"] += 1
            return _rows_decode(cfg, mesh, state_specs, params, state, token)
        serve_paths["whole leaves"] += 1
        devs, rows, axes = _batch_shards(mesh, token)
        logits, states, disp = [], [], None
        for k, dev in enumerate(devs):
            with mesh_lib.at(dev):
                disp = _shard_dispatch(cfg, len(devs), token.numel(), disp,
                                       dev, k)
                here = tree_map(lambda p: sharding.gather(p, dev), params)
                st = sharding.batch_block_tree(state, axes, k, len(devs), dev)
                with _dispatching(disp):
                    lg, st = model_lib.decode_step(
                        cfg, here, token.narrow(0, k * rows, rows).to(dev),
                        st)
                del here
            logits.append(lg)
            states.append(st)
        return (collectives.all_gather(collectives.shard_array(logits), 0),
                sharding.shard_blocks_tree(states, state_specs, mesh, axes))

    return fn


def _whole_on(mesh):
    """A placement of whole tensors on the mesh's first device (a copy)."""
    def place(tree):
        dev = mesh.first_device
        return tree_map(lambda t: t.to(dev, copy=True)
                        if isinstance(t, torch.Tensor) else t, tree)
    return place


def _train_state_specs(cfg, params, mesh):
    if cfg.train_parallelism == "fsdp":
        return sharding.fsdp_only_param_specs(params, mesh)
    return sharding.param_specs(params, mesh, fsdp=True)


def build_train(cfg, mesh, shape) -> Cell:
    """The sharded train step (``make_sharded_train_step``) under the hint
    mesh; parameters and moments placed by ``param_specs(fsdp=True)``, or
    for an ``fsdp`` config by ``fsdp_only_param_specs`` with the batch
    split over the model axis too (``data_specs(include_model=True)``)."""
    ocfg = OptimizerConfig(total_steps=10_000)
    fsdp = cfg.train_parallelism == "fsdp"
    step = make_sharded_train_step(cfg, ocfg, mesh, batch_over_model=fsdp)
    params = specs_lib.param_specs_abstract(cfg)
    opt = opt_lib.OptState(
        mu=tree_map(lambda a: torch.empty(a.shape, device=FAKE), params),
        nu=tree_map(lambda a: torch.empty(a.shape, device=FAKE), params),
        step=torch.empty((), dtype=torch.int32, device=FAKE))
    batch = specs_lib.train_input_specs(cfg, shape)
    whole = _whole_on(mesh)

    def place(params, opt, batch):
        p, o = shard_train_state(params, opt, mesh,
                                 specs=_train_state_specs(cfg, params, mesh))
        return p, o, whole(batch)

    def fn(params, opt, batch):
        with sharding.hint_mesh(mesh):
            return step(params, opt, batch)

    return Cell(fn, place, (params, opt, batch))


def _serve_fsdp(cfg, mesh) -> bool:
    """Serving shards params over data too when one TP shard won't fit."""
    tp = mesh.shape.get("model", 1)
    return cfg.param_count() * 4 / tp > 8e9


def _decode_state_specs(cfg, batch: int, max_seq: int, dtype, mesh):
    """``decode_state_specs`` of a global decode state, from meta tensors
    (no storage)."""
    with torch._subclasses.fake_tensor.unset_fake_temporarily():
        state = model_lib.init_decode_state(cfg, batch, max_seq, dtype,
                                            device=FAKE)
    return sharding.decode_state_specs(cfg, state, mesh)


def build_prefill(cfg, mesh, shape) -> Cell:
    """``sharded_prefill`` of ``shape.global_batch`` prompts of
    ``shape.seq_len`` tokens, fp32 parameters placed by
    ``param_specs(fsdp=_serve_fsdp(...))``, under the hint mesh."""
    params = specs_lib.param_specs_abstract(cfg)
    inputs = specs_lib.prefill_input_specs(cfg, shape)
    dt = getattr(torch, cfg.compute_dtype)
    s_specs = _decode_state_specs(cfg, shape.global_batch, shape.seq_len, dt,
                                  mesh)
    step = sharded_prefill(cfg, mesh, shape.seq_len, s_specs)
    p_specs = sharding.param_specs(params, mesh, fsdp=_serve_fsdp(cfg, mesh))
    whole = _whole_on(mesh)

    def place(params, inputs):
        return sharding.shard_tree(params, p_specs, mesh), whole(inputs)

    def fn(params, inputs):
        with sharding.hint_mesh(mesh):
            return step(params, inputs)

    return Cell(fn, place, (params, inputs))


def build_decode(cfg, mesh, shape) -> Cell:
    """``sharded_decode`` of one token against a ``shape.seq_len`` cache:
    bf16 weights (a serving copy; fp32 norms and vectors), the state placed
    by ``decode_state_specs``, under the hint mesh."""
    params = tree_map(
        lambda a: torch.empty(a.shape, dtype=torch.bfloat16, device=FAKE)
        if a.dtype == torch.float32 and a.ndim >= 2 else a,
        specs_lib.param_specs_abstract(cfg))
    io = specs_lib.decode_input_specs(cfg, shape)
    p_specs = sharding.param_specs(params, mesh, fsdp=_serve_fsdp(cfg, mesh))
    s_specs = sharding.decode_state_specs(cfg, io["state"], mesh)
    step = sharded_decode(cfg, mesh, s_specs)
    whole = _whole_on(mesh)

    def place(params, state, token):
        return (sharding.shard_tree(params, p_specs, mesh),
                sharding.shard_tree(state, s_specs, mesh), whole(token))

    def fn(params, state, token):
        with sharding.hint_mesh(mesh):
            return step(params, state, token)

    return Cell(fn, place, (params, io["state"], io["token"]))


def _build(cfg, mesh, shape) -> Cell:
    if shape.kind == "train":
        return build_train(cfg, mesh, shape)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape)
    return build_decode(cfg, mesh, shape)


def run_built(cell: Cell, mesh) -> dict:
    """``account`` of a built cell on its mesh."""
    return account(cell.fn, *cell.args, place=cell.place, mesh=mesh)


# ------------------------------------------------------------------- runner
def _cuts(cfg, shape, published_cfg, published_shape) -> dict:
    """The fields of ``cfg`` (and the shape cell) that differ from the
    published ones, each as [published, run]."""
    out = {}
    if published_cfg is not None:
        for f in dataclasses.fields(cfg):
            a, b = getattr(published_cfg, f.name), getattr(cfg, f.name)
            if a != b:
                out[f.name] = [a, b]
    if published_shape is not None and shape != published_shape:
        out["shape"] = [list(dataclasses.astuple(published_shape)),
                        list(dataclasses.astuple(shape))]
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             delta: bool = False, skip_existing: bool = False, cfg=None,
             shape=None, mesh=None) -> dict:
    """One (arch x shape x mesh) cell, its JSON written to
    ``outdir/mesh_kind/arch__shape.json``. ``cfg``, ``shape`` and ``mesh``
    override the arch's config, the shape cell and the production mesh
    (a test's small ones, or a published config cut in depth:
    ``cfg=ARCHS[arch].replace(n_layers=2)``); the JSON's ``reduced`` then
    lists each field that differs, as [published, run]."""
    cfg = cfg or ARCHS[arch]
    shape = shape or specs_lib.SHAPES[shape_name]
    tag = f"{mesh_kind}/{arch}__{shape_name}"
    path = os.path.join(outdir, mesh_kind, f"{arch}__{shape_name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "ok": False}
    reduced = _cuts(cfg, shape, ARCHS.get(arch),
                    specs_lib.SHAPES.get(shape_name))
    if reduced:
        result["reduced"] = reduced
    ok, why = specs_lib.cell_applicable(cfg, shape)
    if not ok:
        result.update(skipped=True, reason=why, ok=True)
        _write(path, result)
        print(f"[dryrun] {tag}: SKIP ({why})")
        return result

    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                        device=FAKE, positions=True)
        chips = mesh.size
        t0 = time.perf_counter()
        cell = _build(cfg, mesh, shape)
        t_build = time.perf_counter() - t0
        acc = run_built(cell, mesh)
        mem = acc["memory"]
        total_dev_bytes = (mem["argument_size_in_bytes"]
                           + mem["temp_per_device"])
        result.update(
            ok=True,
            chips=chips,
            build_s=round(t_build, 2),
            account_s=round(acc["seconds"], 2),
            memory=mem,
            fits_hbm=bool(total_dev_bytes < HBM_PER_CHIP),
            hbm_per_chip=HBM_PER_CHIP,
            chip=CHIP,
            cost=acc["cost"],
            collectives=acc["collectives"],
            counted_by="fake-tensor accounting for " + CHIP + " (no card "
            "touched); flops: matmul family only (FlopCounterMode)",
        )
        result["model_flops"] = rl.model_flops_estimate(
            cfg, shape.kind, shape.seq_len, shape.global_batch)
        result["algo_flops"] = rl.algo_flops(
            cfg, shape.kind, shape.seq_len, shape.global_batch)
        result["algo_hbm_bytes"] = rl.algo_hbm_bytes(
            cfg, shape.kind, shape.seq_len, shape.global_batch)
        if delta:
            result["delta"] = _depth_delta(cfg, mesh, shape, acc)
        _finalize_roofline(result, chips)
        print(f"[dryrun] {tag}: OK account={acc['seconds']:.1f}s "
              f"mem/dev={total_dev_bytes / 1e9:.2f}GB "
              f"coll/dev={acc['collectives']['total'] / 1e9:.3f}GB")
    except Exception as e:
        result.update(error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {e}")
    _write(path, result)
    return result


def _depth_delta(cfg, mesh, shape, full: dict) -> dict:
    """The reference's shallow twins (depths ``r + p`` and ``r + 2p``) and
    their extrapolation to the full depth. The port's loops are unrolled,
    so the full cell already counts every layer: here the extrapolation is
    a check that the count is linear in depth, with its error against the
    full count."""
    p = max(1, cfg.shared_attn_every)
    r = cfg.first_dense_layers
    d1, d2 = r + p, r + 2 * p
    out = {}
    for d in (d1, d2):
        sub = cfg.replace(n_layers=d, n_enc_layers=min(d, cfg.n_enc_layers)
                          if cfg.enc_dec else 0)
        acc = run_built(_build(sub, mesh, shape), mesh)
        out[f"d{d}"] = {"flops": acc["cost"]["flops"],
                        "bytes": acc["cost"]["bytes"],
                        "coll": acc["collectives"]["total"]}
    L = cfg.n_layers
    out["extrapolated"] = {
        k: rl.delta_extrapolate(out[f"d{d1}"][k], out[f"d{d2}"][k], d1, d2, L)
        for k in ("flops", "bytes", "coll")}
    counted = {"flops": full["cost"]["flops"], "bytes": full["cost"]["bytes"],
               "coll": full["collectives"]["total"]}
    out["rel_err_vs_full"] = {
        k: abs(out["extrapolated"][k] - v) / v if v else 0.0
        for k, v in counted.items()}
    out["depths"] = [d1, d2]
    return out


def _roof(flops, bts, coll, chips, model_flops) -> dict:
    return rl.Roofline(flops=flops, hbm_bytes=bts, coll_bytes_per_dev=coll,
                       chips=chips, peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
                       link_bw=LINK_BW, model_flops=model_flops).to_dict()


def _finalize_roofline(result: dict, chips: int):
    """Three-term roofline on the H100's published rates: the analytic
    algorithm counts with the counted collectives (``roofline``), and the
    counted flops and bytes (``roofline_raw_hlo``: the reference's key; here
    the fake-tensor count, which covers every layer)."""
    coll = result["collectives"]["total"]
    mf = result.get("model_flops", 0.0)
    result["roofline"] = _roof(result["algo_flops"], result["algo_hbm_bytes"],
                               coll, chips, mf)
    result["roofline_raw_hlo"] = _roof(result["cost"]["flops"],
                                       result["cost"]["bytes"], coll, chips,
                                       mf)


# -------------------------------------------------------------- STKDE cells
def run_stkde_cell(instance_name: str, strategy: str, mesh_kind: str,
                   outdir: str, skip_existing: bool = False,
                   mesh=None) -> dict:
    """Dry-run the paper's own technique: the port's ``build_*`` of
    ``distributed.stkde_dist`` on fake bucket arrays of the reference's
    shapes and ``cap`` formula (no point is made). ``mesh`` overrides the
    production mesh of ``mesh_kind`` (a test's small one)."""
    from ..core.datasets import INSTANCES
    from ..distributed import stkde_dist as sd

    inst = INSTANCES[instance_name]
    dom = inst.domain()
    tag = f"{mesh_kind}/stkde_{strategy}_{instance_name}"
    path = os.path.join(outdir, mesh_kind,
                        f"stkde_{strategy}__{instance_name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    result = {"arch": f"stkde-{strategy}", "shape": instance_name,
              "mesh": mesh_kind, "ok": False}
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                        device=FAKE, positions=True)
        chips = mesh.size
        axes = ("data", "model")
        A, B = mesh.shape["data"], mesh.shape["model"]
        cap = max(8, int(np.ceil(4.0 * inst.n / (A * B) / 8)) * 8)
        f32 = torch.float32
        if strategy == "pd_xyt":
            if "pod" not in mesh.shape:
                result.update(skipped=True, ok=True,
                              reason="3-axis decomposition needs the "
                              "multi-pod mesh")
                _write(path, result)
                return result
            R = mesh.shape["pod"]
            fn = sd.build_pd_xyt(dom, mesh, ("pod", "data", "model"), inst.n)
            args = (torch.empty((R, A, B, cap, 3), dtype=f32, device=FAKE),
                    torch.empty((R, A, B, cap), dtype=f32, device=FAKE))
        elif strategy in ("pd", "pd_xt"):
            rep = "pod" if "pod" in mesh.shape else None
            builder = sd.build_pd_xt if strategy == "pd_xt" else sd.build_pd
            fn = builder(dom, mesh, axes, inst.n, rep_axis=rep)
            lead = (mesh.shape["pod"],) if rep else ()
            args = (torch.empty(lead + (A, B, cap, 3), dtype=f32,
                                device=FAKE),
                    torch.empty(lead + (A, B, cap), dtype=f32, device=FAKE))
        elif strategy == "dd":
            fn = sd.build_dd(dom, mesh, axes, inst.n)
            args = (torch.empty((A, B, cap, 3), dtype=f32, device=FAKE),
                    torch.empty((A, B, cap), dtype=f32, device=FAKE))
        else:  # dr
            npad = int(np.ceil(inst.n / chips)) * chips
            fn = sd.build_dr(dom, mesh, axes, inst.n)
            args = (torch.empty((npad, 3), dtype=f32, device=FAKE),)
        whole = _whole_on(mesh)
        acc = account(fn, *args, place=lambda *a: tuple(map(whole, a)),
                      mesh=mesh)
        mem = acc["memory"]
        total_dev = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        result.update(
            ok=True, chips=chips, account_s=round(acc["seconds"], 2),
            memory={k: mem[k] for k in ("argument_size_in_bytes",
                                        "temp_size_in_bytes", "peak_bytes",
                                        "fullest_position")},
            fits_hbm=bool(total_dev < HBM_PER_CHIP), hbm_per_chip=HBM_PER_CHIP,
            chip=CHIP, cost=acc["cost"], collectives=acc["collectives"],
            grid_voxels=dom.grid_voxels, n_points=inst.n, cap=cap,
        )
        result["roofline"] = _roof(
            result["cost"]["flops"], result["cost"]["bytes"],
            acc["collectives"]["total"], chips,
            2.0 * inst.n * dom.cylinder_voxels)
        print(f"[dryrun] {tag}: OK account={acc['seconds']:.1f}s "
              f"mem/dev={total_dev / 1e9:.2f}GB")
    except Exception as e:
        result.update(error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {e}")
    _write(path, result)
    return result


def _write(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(tmp, path)


STKDE_DRYRUN_INSTANCES = ["eBird_Hr-Hb", "eBird_Lr-Hb", "Flu_Hr-Hb",
                          "PollenUS_VHr-Lb"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=sorted(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(specs_lib.SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--delta", action="store_true",
                    help="shallow twins and their extrapolation, as a check "
                    "of the full count")
    ap.add_argument("--stkde", action="store_true",
                    help="also dry-run STKDE strategies at production scale")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    failures = []
    for mesh_kind in meshes:
        for arch in args.arch:
            for shape in args.shape:
                r = run_cell(arch, shape, mesh_kind, args.out,
                             delta=args.delta and mesh_kind == "single",
                             skip_existing=args.skip_existing)
                if not r.get("ok"):
                    failures.append((mesh_kind, arch, shape))
        if args.stkde:
            for inst in STKDE_DRYRUN_INSTANCES:
                strats = ("pd", "pd_xt", "dd") if mesh_kind == "single" \
                    else ("pd", "pd_xt", "pd_xyt", "dd")
                for strat in strats:
                    r = run_stkde_cell(inst, strat, mesh_kind, args.out,
                                       skip_existing=args.skip_existing)
                    if not r.get("ok"):
                        failures.append((mesh_kind, f"stkde-{strat}", inst))
    print(f"\n[dryrun] done; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
