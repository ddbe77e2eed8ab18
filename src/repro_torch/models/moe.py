"""Mixture-of-Experts: top-k routing with fixed expert capacity.

Sort-free deterministic dispatch: tokens pick top-k experts; each (token,
slot) gets a position within its expert via a cumulative one-hot count;
tokens beyond expert capacity are dropped (their combine weight is zeroed) —
GShard semantics. Shared experts (DeepSeek) run densely over all tokens.

The load-balance auxiliary loss (Switch-style) is returned beside the
output. ``moe_apply`` is the reference's ``moe_impl="gspmd"`` path;
under ``global_dispatch`` it is one batch shard's part of that path on the
global batch (the sharded train step runs the shards in turn and adds up
``global_aux``);
``moe_apply_a2a`` its expert-parallel all-to-all over the shards of a
``Mesh``, which ``transformer.apply_channel`` runs for a config with
``moe_impl="a2a"`` under an active ``sharding.hint_mesh`` (without one such
a config runs ``moe_apply``, as the reference does).

On a tensor-parallel row (``distributed.mesh.tensor_parallel``, the
sharded train step) each position holds ``E/M`` whole experts:
``moe_apply_tp`` is ``moe_apply`` over the row (every position routes
every token, runs its own experts, ``all_reduce`` adds the partials) and
``moe_apply_a2a_tp`` the all-to-all inside the row.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

import numpy as np

from ..distributed import collectives
from ..distributed import mesh as _mesh
from ..distributed import sharding as _sh
from . import layers

_F32 = torch.float32


def moe_init(gen: torch.Generator, cfg) -> dict:
    D = cfg.d_model
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    p = {
        "router": layers.dense_init(gen, (D, E), scale=0.5),
        "wg": layers.dense_init(gen, (E, D, Fe)),
        "wu": layers.dense_init(gen, (E, D, Fe)),
        "wo": layers.dense_init(gen, (E, Fe, D), scale=out_scale),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["shared"] = {
            "wg": layers.dense_init(gen, (D, Fs)),
            "wu": layers.dense_init(gen, (D, Fs)),
            "wo": layers.dense_init(gen, (Fs, D), scale=out_scale),
        }
    return p


def _route(xt, router, K: int):
    """Router softmax, top-k and renormalised gates: (probs (T, E), gate
    values (T, K), expert ids (T, K))."""
    logits = xt.to(_F32) @ router.to(_F32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)       # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)             # renormalize
    return probs, gate_vals, expert_idx


def _capacity(n: int, cfg, groups: int) -> int:
    """Slots per group (expert or destination rank) for ``n`` tokens: the
    reference's ``max(8, ceil8(ceil(n K cf / groups)))``."""
    c = int(math.ceil(n * cfg.top_k * cfg.capacity_factor / groups))
    return max(8, -(-c // 8) * 8)


def _slots(idx, groups: int, cap: int, offset=None):
    """Position of each (token, slot) within its group by a running count
    (after ``offset[g]`` slots of group ``g`` that earlier tokens took), and
    whether it fits: (keep, safe position)."""
    oh = F.one_hot(idx, groups)                                # (T*K, G)
    pos = torch.gather(torch.cumsum(oh, dim=0) - oh, 1, idx[:, None])[:, 0]
    if offset is not None:
        pos = pos + offset[idx]
    keep = pos < cap
    return keep, torch.where(keep, pos, cap - 1)


# ------------------------------------------------- global dispatch by shard
class Dispatch:
    """One batch shard's part of a MoE dispatch over the global batch, for
    ``global_dispatch``.

    ``n_tokens`` is the global batch's token count, which sets the expert
    capacity. ``offsets[l]`` is, for the ``l``-th ``moe_apply`` call of the
    forward, the ``(E,)`` int64 count of (token, slot)s that the earlier
    batch shards (the global tokens before this shard's) sent to each
    expert; empty for the first shard. ``shard`` is the shard's row-major
    index over the mesh's batch axes (``moe_apply_a2a`` exchanges among
    that batch shard's ranks). The forward fills, per call, ``counts``
    (this shard's own ``(E,)`` counts; ``moe_apply`` only), ``me_sum``
    (its router probabilities summed over its tokens, in the autograd
    graph) and ``ce_sum`` (its top-1 choices counted, fp32)."""

    def __init__(self, n_tokens: int, offsets: Sequence[torch.Tensor] = (),
                 shard: int = 0):
        self.n_tokens = int(n_tokens)
        self.offsets = list(offsets)
        self.shard = shard
        self.counts: List[torch.Tensor] = []
        self.me_sum: List[torch.Tensor] = []
        self.ce_sum: List[torch.Tensor] = []

    @property
    def calls(self) -> int:
        """The MoE calls this shard's forward has made so far."""
        return len(self.me_sum)

    def replay(self, start: int) -> "Dispatch":
        """A fresh ``Dispatch`` that runs the calls from ``start`` on again
        as the forward ran them (the same capacity, offsets and shard),
        filling its own lists: what a recomputed block (``remat``) runs
        under, so that it neither appends to this one nor shifts its
        offsets."""
        return Dispatch(self.n_tokens, self.offsets[start:], self.shard)

    def carried(self, device) -> List[torch.Tensor]:
        """The next batch shard's ``offsets``, on ``device``: this shard's
        added to its own (the exclusive scan over the shards)."""
        if not self.offsets:
            return [c.to(device) for c in self.counts]
        return [(o + c).to(device) for o, c in zip(self.offsets,
                                                    self.counts)]


_DISPATCH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_dispatch", default=None)
_ROUTES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_routes", default=None)


@contextlib.contextmanager
def global_dispatch(d: Dispatch):
    """Run ``moe_apply`` as batch shard ``d`` of the global batch: the
    capacity from ``d.n_tokens``, each (token, slot)'s position within its
    expert offset by ``d.offsets``, so the keep masks and slots are the
    global call's rows for this shard's tokens. The returned aux is zero;
    ``global_aux`` forms the global one from the shards' ``Dispatch``es."""
    tok = _DISPATCH.set(d)
    try:
        yield d
    finally:
        _DISPATCH.reset(tok)


@contextlib.contextmanager
def recording_routes():
    """Collect the routing of every ``moe_apply`` call made inside: a list
    with one dict per call, in call order, of ``(T, K)`` tensors
    ``expert`` (ids), ``keep`` (bool) and ``slot`` (position within the
    expert, ``C - 1`` where dropped)."""
    out: List[dict] = []
    tok = _ROUTES.set(out)
    try:
        yield out
    finally:
        _ROUTES.reset(tok)


def recompute_context():
    """At a checkpointed block's forward: a context manager for its
    recompute, which autograd runs during backward, outside the caller's
    ``global_dispatch`` and ``recording_routes`` (and maybe on another
    thread). It re-enters a ``replay`` of the dispatch active now (from
    the next call on) and records no routes, so the recompute takes the
    forward's capacity, offsets and path and appends nothing."""
    disp = _DISPATCH.get()
    start = disp.calls if disp is not None else 0

    @contextlib.contextmanager
    def again():
        toks = (_DISPATCH.set(disp.replay(start) if disp is not None
                              else None), _ROUTES.set(None))
        try:
            yield
        finally:
            _ROUTES.reset(toks[1])
            _DISPATCH.reset(toks[0])

    return again()


def global_aux(cfg, shards: Sequence[Dispatch], device) -> torch.Tensor:
    """The global batch's load-balance loss from its shards' ``Dispatch``es
    (in row-major order): per ``moe_apply`` call ``coef E sum(me ce)`` with
    ``me``, ``ce`` the shards' sums added in order on ``device`` over the
    global token count, summed over the calls in order (the forward's
    aux)."""
    E = cfg.n_experts
    t = torch.tensor(float(shards[0].n_tokens), dtype=_F32, device=device)
    aux = torch.zeros((), dtype=_F32, device=device)
    for layer in range(len(shards[0].me_sum)):
        me, ce = (collectives.psum(collectives.shard_array(
            [getattr(d, k)[layer] for d in shards]), 0).item() / t
            for k in ("me_sum", "ce_sum"))
        aux = aux + cfg.router_aux_coef * E * torch.sum(me * ce)
    return aux


def moe_apply(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). Under ``global_dispatch``, this
    call is one batch shard of the global batch (its aux is zero)."""
    disp: Optional[Dispatch] = _DISPATCH.get()
    y, aux = _routed(cfg, p, x, disp, disp.calls if disp else 0, True)
    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(cfg, p["shared"], _tokens(x))
    return y.reshape(x.shape), aux


def _tokens(x):
    """(B, S, D) -> (B S, D)."""
    return x.reshape(-1, x.shape[-1])


def _routed(cfg, p, x, disp: Optional[Dispatch], call: int, record: bool,
            lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of ``moe_apply`` (no shared ones): every token
    routed over all ``E`` experts by the whole router, the experts run
    those of ``p["wg"]`` / ``wu`` / ``wo``: all ``E``, or ``E_here`` of
    them from expert ``lo`` on (a position's piece over "model"), whose
    output is then the partial sum of the (token, slot)s routed to them.
    Under ``disp``, the call is its ``call``-th; only a ``record`` call
    fills the ``Dispatch`` and ``recording_routes`` and forms the aux
    (zero otherwise). Returns the output as (B S, D) and the aux."""
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    E_here = p["wg"].shape[0]
    T = B * S
    xt = x.reshape(T, D)

    probs, gate_vals, expert_idx = _route(xt, p["router"], K)
    top1 = F.one_hot(expert_idx[:, 0], E).to(_F32)
    flat_e = expert_idx.reshape(-1)                            # (T*K,)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    if disp is None:
        if record:
            # Switch-style load-balance loss
            me = probs.mean(0)                                 # (E,)
            ce = top1.mean(0)
            aux = cfg.router_aux_coef * E * torch.sum(me * ce)
        C, off = _capacity(T, cfg, E), None
    else:
        # the global call's capacity and slots: this shard's tokens come
        # after the earlier shards' in the global order (the buffer holds
        # only this shard's tokens, at their global positions)
        off = disp.offsets[call] if disp.offsets else None
        if off is not None:
            off = off.to(_mesh.device_of(x))
        C = _capacity(disp.n_tokens, cfg, E)
        if record:
            disp.me_sum.append(probs.sum(0))
            disp.ce_sum.append(top1.sum(0))
            # bincount's counts, in a shape that does not depend on the
            # values (a dry run's fake tensors have none)
            disp.counts.append(torch.zeros(E, dtype=torch.int64,
                                           device=x.device).index_add_(
                0, flat_e, torch.ones_like(flat_e)))

    # ---- capacity dispatch ------------------------------------------------
    keep, safe_pos = _slots(flat_e, E, C, off)
    rec = _ROUTES.get()
    if record and rec is not None:
        rec.append({"expert": expert_idx.detach(),
                    "keep": keep.reshape(T, K),
                    "slot": safe_pos.reshape(T, K)})
    gate_keep = torch.where(keep.reshape(T, K), gate_vals.to(_F32), 0.0)
    here = flat_e
    if E_here != E:
        # this position's experts only: the others' (token, slot)s add
        # zeros to its buffer and get a zero gate
        here = flat_e - lo
        mine = (here >= 0) & (here < E_here)
        keep = keep & mine
        here = torch.where(mine, here, 0)
        gate_keep = torch.where(mine.reshape(T, K), gate_keep, 0.0)

    # scatter tokens into (E_here, C, D) buffers
    src = torch.repeat_interleave(xt, K, dim=0)                # (T*K, D)
    src = torch.where(keep[:, None], src, 0)
    buf = torch.zeros((E_here, C, D), dtype=dt, device=x.device)
    buf.index_put_((here, safe_pos), src, accumulate=True)    # dup-safe: add

    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", buf, p["wu"].to(dt))
    yb = torch.einsum("ecf,efd->ecd", g * u, p["wo"].to(dt))   # (E, C, D)

    y_tok = yb[here, safe_pos].reshape(T, K, D)
    y = torch.einsum("tkd,tk->td", y_tok.to(_F32), gate_keep).to(dt)
    return y, aux


# the splits ``moe_apply_tp`` and ``moe_apply_a2a_tp`` took, one count a
# call: "whole layer" (every expert at every position), "experts over the
# row" (each position its ``E/M``) or "a2a in the row" (read and cleared
# by callers that must know which ran)
tp_splits: collections.Counter = collections.Counter()


def _shared_tp(cfg, ps, xs):
    """The shared experts at each position of the row: the whole MLP, or
    (column / row split) each position's partial sum; and whether split."""
    outs = _mesh.each(lambda p, x: layers.mlp_apply(cfg, p["shared"],
                                                    _tokens(x)), ps, xs)
    return outs, ps[0]["shared"]["wo"].shape[0] != (
        cfg.n_shared_experts * cfg.d_ff_expert)


def _row_sum(routed, routed_split: bool, cfg, ps, xs):
    """Each position's output: its routed output plus the shared experts',
    the split parts' partial sums added over the row by one
    ``all_reduce`` (routed and shared folded into it when both are
    split), whole parts added after it, routed first, as ``moe_apply``
    adds them."""
    row = _mesh.tp_row()
    if not cfg.n_shared_experts:
        return collectives.all_reduce(routed, row) if routed_split \
            else routed
    shared, shared_split = _shared_tp(cfg, ps, xs)
    if routed_split and shared_split:
        return collectives.all_reduce(_mesh.each(torch.add, routed, shared),
                                      row)
    if routed_split:
        routed = collectives.all_reduce(routed, row)
    if shared_split:
        shared = collectives.all_reduce(shared, row)
    return _mesh.each(torch.add, routed, shared)


def moe_apply_tp(cfg, ps, xs):
    """``moe_apply`` over the row of ``distributed.mesh.tp_row()`` (the
    reference's GSPMD form with the experts over "model"): one parameter
    tree and one input (the batch shard's tokens, replicated) per position.

    Every position routes every token with its whole router, so the routes
    are the same at each. A position whose ``wg`` / ``wu`` / ``wo`` hold
    ``E/M`` experts fills an ``(E/M, C, D)`` buffer for them only, runs
    them and combines only the (token, slot)s routed to them; the shared
    experts are column / row split. ``all_reduce`` adds the row's partial
    sums. Under ``global_dispatch`` the capacity and each expert's slot
    offsets are the global batch's, and the row records its router sums,
    counts and routes once (from its first position). Experts left whole
    (``E`` not divided) run whole at every position. Returns each
    position's output and the aux (zero under a dispatch) on the row's
    first position; counts its split in ``tp_splits``."""
    disp: Optional[Dispatch] = _DISPATCH.get()
    call = disp.calls if disp is not None else 0
    E_here = ps[0]["wg"].shape[0]
    split = E_here != cfg.n_experts
    tp_splits["experts over the row" if split else "whole layer"] += 1
    outs = _mesh.each(
        lambda j, p, x: _routed(cfg, p, x, disp, call, j == 0,
                                j * E_here if split else 0),
        range(len(ps)), ps, xs)
    ys = _row_sum([y for y, _ in outs], split, cfg, ps, xs)
    return [y.reshape(x.shape) for y, x in zip(ys, xs)], outs[0][1]


def expert_load_counts(cfg, p, x) -> torch.Tensor:
    """Per-expert top-1 token counts (for the LPT placement analysis)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).to(_F32) @ p["router"].to(_F32)
    top1 = torch.argmax(logits, -1)
    return torch.bincount(top1, minlength=cfg.n_experts)


# ---------------------------------------------------------------- a2a MoE
def a2a_applies(cfg, x_shape, mesh) -> bool:
    """Whether ``moe_apply_a2a`` exchanges over ``mesh`` for an input of
    ``x_shape``; otherwise it is ``moe_apply`` (the reference's rule)."""
    B, S = x_shape[0], x_shape[1]
    bd = _sh.batch_axes(mesh)
    M = mesh.shape.get(_sh.TP, 1)
    n_bd = int(np.prod([mesh.shape[a] for a in bd])) if bd else 1
    return not (M == 1 or cfg.n_experts % M or (B * S // max(n_bd, 1)) % M)


def _at_each(devs: np.ndarray):
    """Each rank ``(b, m)`` of ``devs``, its position the current one
    (``mesh.at``) while the caller's loop body runs for it."""
    for b, m in np.ndindex(devs.shape):
        with _mesh.at(devs[b, m]):
            yield b, m


def _a2a_exchange(cfg, devs: np.ndarray, x_my: np.ndarray,
                  ranks: np.ndarray, dt) -> Tuple[np.ndarray, ...]:
    """The reference's ``shard_map`` body over the ranks ``devs`` (batch
    shards x "model"), exchanging within each batch shard's row: rank
    ``(b, m)`` routes its ``T2`` tokens ``x_my[b, m]`` with the router of
    ``ranks[b, m]`` (a dict of ``router`` and its ``E/M`` experts' ``wg``
    / ``wu`` / ``wo``), fills one ``(C2, D)`` send buffer per destination
    rank, ``all_to_all`` exchanges them, runs each local expert on the
    whole received buffer and selects per row (the reference's
    overcompute), a second ``all_to_all`` sends the results back and the
    gates weight them. Records the routes (one entry for all the ranks, in
    token order). Returns each rank's ``(T2, D)`` output and its router
    sums ``me_sum`` / ``ce_sum``."""
    n_bd, M = devs.shape
    D = x_my[0, 0].shape[-1]
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E // M
    T2 = x_my[0, 0].shape[0]
    C2 = _capacity(T2, cfg, M)
    route = np.empty(devs.shape, dtype=object)
    send = np.empty(devs.shape, dtype=object)
    send_e = np.empty(devs.shape, dtype=object)
    me_sum = np.empty(devs.shape, dtype=object)
    ce_sum = np.empty(devs.shape, dtype=object)
    picked = []
    for b, m in _at_each(devs):
        dev = devs[b, m]
        x = x_my[b, m]
        probs, gate_vals, eidx = _route(x, ranks[b, m]["router"], K)
        me_sum[b, m] = probs.sum(0)
        ce_sum[b, m] = F.one_hot(eidx[:, 0], E).to(_F32).sum(0)

        flat_e = eidx.reshape(-1)                              # (T2*K,)
        dest = flat_e // E_loc                                 # rank
        e_loc = flat_e % E_loc                                 # local expert
        keep, safe_pos = _slots(dest, M, C2)
        picked.append((eidx, keep, safe_pos))
        gate_keep = torch.where(keep.reshape(T2, K), gate_vals.to(_F32),
                                0.0)
        src = torch.repeat_interleave(x, K, dim=0)
        src = torch.where(keep[:, None], src, 0)
        # a dropped (token, slot) adds zeros to a slot at most one kept one
        # fills, so the sum is exact in any order
        send[b, m] = torch.zeros((M, C2, D), dtype=dt, device=dev).index_put(
            (dest, safe_pos), src, accumulate=True)
        flat_slot = dest * C2 + safe_pos
        send_e[b, m] = torch.zeros(M * C2, dtype=torch.int64,
                                   device=dev).scatter_reduce(
            0, flat_slot, torch.where(keep, e_loc, 0), "amax").reshape(M, C2)
        route[b, m] = (dest, safe_pos, gate_keep)
    rec = _ROUTES.get()
    if rec is not None:
        first = devs[0, 0]
        rec.append({key: torch.cat([r[i].to(first).reshape(T2, K)
                                    for r in picked])
                    for i, key in enumerate(("expert", "keep", "slot"))})

    recv = collectives.all_to_all(send, 1)
    recv_e = collectives.all_to_all(send_e, 1)
    out = np.empty(devs.shape, dtype=object)
    for b, m in _at_each(devs):
        tok = recv[b, m].reshape(M * C2, D)
        sel = recv_e[b, m].reshape(-1)
        wg, wu, wo = (ranks[b, m][k] for k in ("wg", "wu", "wo"))

        def one_expert(le):
            g = F.silu(tok @ wg[le].to(dt))
            u = tok @ wu[le].to(dt)
            return (g * u) @ wo[le].to(dt)

        yb = one_expert(0)
        for le in range(1, E_loc):
            yb = torch.where((sel == le)[:, None], one_expert(le), yb)
        out[b, m] = yb.reshape(M, C2, D)

    back = collectives.all_to_all(out, 1)
    y_my = np.empty(devs.shape, dtype=object)
    for b, m in _at_each(devs):
        dest, safe_pos, gate_keep = route[b, m]
        y_tok = back[b, m][dest, safe_pos].reshape(T2, K, D)
        y_my[b, m] = torch.einsum("tkd,tk->td", y_tok.to(_F32),
                                  gate_keep).to(dt)
    return y_my, me_sum, ce_sum


def _a2a_aux(cfg, disp: Optional[Dispatch], me_sum, ce_sum, n_tokens: int,
             device) -> torch.Tensor:
    """The a2a's load-balance aux from its ranks' router sums (``psum``
    over all of them, in row-major order): from the global means over
    ``n_tokens``, or, under ``disp``, the sums recorded there and zero."""
    me, ce = (collectives.psum(a, tuple(range(a.ndim))).item()
              for a in (me_sum, ce_sum))
    if disp is not None:
        disp.me_sum.append(me)
        disp.ce_sum.append(ce)
        return torch.zeros((), dtype=_F32, device=device)
    t = torch.tensor(float(n_tokens), dtype=_F32, device=me.device)
    return (cfg.router_aux_coef * cfg.n_experts
            * torch.sum((me / t) * (ce / t))).to(device)


def moe_apply_a2a(cfg, p, x, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with an explicit all-to-all exchange between the
    shards of ``mesh``, the reference's ``shard_map`` path, on whole
    leaves (``moe_apply_a2a_tp`` is its form on a tensor-parallel row).

    The tokens are split over the batch axes, then over "model": each rank
    takes its ``T2`` tokens and its ``E/M`` experts' slice of the whole
    weights, and ``_a2a_exchange`` runs the reference's body over every
    batch shard's row; ``all_gather`` over "model", then over the batch
    axes, makes the output whole. The load-balance aux uses global means (a
    sum over every shard, over ``T``). Shards run one after another in
    row-major order on their devices. Falls back to ``moe_apply`` when the
    reference does (``a2a_applies``). ``recording_routes`` gets one entry
    per call: the ranks' expert ids, keep masks and slots (within the
    destination rank's buffer) in token order.

    Under ``global_dispatch``, ``x`` is batch shard ``d.shard``'s rows of
    the global batch: only that batch shard's ranks exchange (each rank's
    tokens, capacity and experts are the global call's), its router sums
    go to the ``Dispatch`` and the returned aux is zero (``global_aux``
    forms it)."""
    disp: Optional[Dispatch] = _DISPATCH.get()
    bd = _sh.batch_axes(mesh)
    n_bd = int(np.prod([mesh.shape[a] for a in bd])) if bd else 1
    # under a dispatch the global batch is n_bd blocks like x
    g_shape = (tuple(x.shape) if disp is None
               else (x.shape[0] * n_bd,) + tuple(x.shape[1:]))
    if not a2a_applies(cfg, g_shape, mesh):
        return moe_apply(cfg, p, x)
    M = mesh.shape[_sh.TP]
    devs = np.asarray(mesh.devices_of(bd + (_sh.TP,)),
                      dtype=object).reshape(n_bd, M)
    if disp is not None:
        devs = devs[disp.shard:disp.shard + 1]
        n_bd = 1
    B, S, D = x.shape
    T = B * S
    if T % n_bd:
        raise ValueError(f"{T} tokens do not split over the batch axes "
                         f"{bd} of size {n_bd}")
    E_loc = cfg.n_experts // M
    T_loc = T // n_bd
    T2 = T_loc // M
    xt = _tokens(x)
    x_my = np.empty(devs.shape, dtype=object)
    ranks = np.empty(devs.shape, dtype=object)
    for b, m in _at_each(devs):
        dev = devs[b, m]
        lo = b * T_loc + m * T2
        x_my[b, m] = xt[lo:lo + T2].to(dev)
        ranks[b, m] = {"router": p["router"].to(dev),
                       **{k: p[k][m * E_loc:(m + 1) * E_loc].to(dev)
                          for k in ("wg", "wu", "wo")}}
    y_my, me_sum, ce_sum = _a2a_exchange(cfg, devs, x_my, ranks, x.dtype)
    aux = _a2a_aux(cfg, disp, me_sum, ce_sum, T, x.device)
    y_loc = np.empty(n_bd, dtype=object)
    for b in range(n_bd):
        y_loc[b] = collectives.all_gather(y_my[b], 0)          # (T_loc, D)
    y = collectives.all_gather(y_loc, 0).to(x.device).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(cfg, p["shared"], x)
    return y, aux


def moe_apply_a2a_tp(cfg, ps, xs, mesh):
    """``moe_apply_a2a`` inside the tensor-parallel row of
    ``distributed.mesh.tp_row()`` (the batch shard's "model" group of
    ``mesh``, the hint mesh): one parameter tree and one input (the batch
    shard's tokens, replicated) per position. Each position takes its
    ``T2`` slice of the tokens from its own copy, routes them with its
    whole router, exchanges with ``all_to_all`` within the row, runs its
    ``E/M`` experts from its own pieces of ``wg`` / ``wu`` / ``wo``, sends
    back, and ``all_gather_row`` gives every position the batch shard's
    output; the shared experts as in ``moe_apply_tp``. The row is batch
    shard ``d.shard`` of ``global_dispatch`` (its router sums recorded
    there once; aux zero) or, without one, the mesh's only batch shard.
    Falls back to ``moe_apply_tp`` where ``moe_apply_a2a`` falls back to
    ``moe_apply``. Returns each position's output and the aux on the row's
    first position; counts "a2a in the row" in ``tp_splits``."""
    disp: Optional[Dispatch] = _DISPATCH.get()
    n_bd = int(np.prod([mesh.shape[a] for a in _sh.batch_axes(mesh)]))
    if disp is None and n_bd != 1:
        raise ValueError("a row of a mesh of several batch shards runs its "
                         "a2a under global_dispatch")
    if not a2a_applies(cfg, (xs[0].shape[0] * n_bd,) + tuple(
            xs[0].shape[1:]), mesh):
        return moe_apply_tp(cfg, ps, xs)
    row = _mesh.tp_row()
    M = len(row)
    tp_splits["a2a in the row"] += 1
    B, S, D = xs[0].shape
    T2 = B * S // M
    devs = np.empty((1, M), dtype=object)
    x_my = np.empty((1, M), dtype=object)
    ranks = np.empty((1, M), dtype=object)
    for m, (dev, p, x) in enumerate(zip(row, ps, xs)):
        devs[0, m], ranks[0, m] = dev, p
        x_my[0, m] = _tokens(x).narrow(0, m * T2, T2)
    y_my, me_sum, ce_sum = _a2a_exchange(cfg, devs, x_my, ranks,
                                         xs[0].dtype)
    aux = _a2a_aux(cfg, disp, me_sum, ce_sum, B * S, row[0])
    ys = collectives.all_gather_row(list(y_my[0]), 0, row)
    if cfg.n_shared_experts:
        ys = _row_sum(ys, False, cfg, ps, xs)
    return [y.reshape(x.shape) for y, x in zip(ys, xs)], aux
