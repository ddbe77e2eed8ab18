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
"""
from __future__ import annotations

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
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    disp: Optional[Dispatch] = _DISPATCH.get()

    probs, gate_vals, expert_idx = _route(xt, p["router"], K)
    top1 = F.one_hot(expert_idx[:, 0], E).to(_F32)
    flat_e = expert_idx.reshape(-1)                            # (T*K,)
    if disp is None:
        # Switch-style load-balance loss
        me = probs.mean(0)                                     # (E,)
        ce = top1.mean(0)
        aux = cfg.router_aux_coef * E * torch.sum(me * ce)
        C, off = _capacity(T, cfg, E), None
    else:
        # the global call's capacity and slots: this shard's tokens come
        # after the earlier shards' in the global order (the buffer holds
        # only this shard's tokens, at their global positions)
        off = disp.offsets[disp.calls] if disp.offsets else None
        disp.me_sum.append(probs.sum(0))
        disp.ce_sum.append(top1.sum(0))
        aux = torch.zeros((), dtype=_F32, device=x.device)
        C = _capacity(disp.n_tokens, cfg, E)
        # bincount's counts, in a shape that does not depend on the values
        # (a dry run's fake tensors have none)
        disp.counts.append(torch.zeros(E, dtype=torch.int64,
                                       device=x.device).index_add_(
            0, flat_e, torch.ones_like(flat_e)))

    # ---- capacity dispatch ------------------------------------------------
    keep, safe_pos = _slots(flat_e, E, C, off)
    rec = _ROUTES.get()
    if rec is not None:
        rec.append({"expert": expert_idx.detach(),
                    "keep": keep.reshape(T, K),
                    "slot": safe_pos.reshape(T, K)})
    gate_keep = torch.where(keep.reshape(T, K), gate_vals.to(_F32), 0.0)

    # scatter tokens into (E, C, D) buffers
    src = torch.repeat_interleave(xt, K, dim=0)                # (T*K, D)
    src = torch.where(keep[:, None], src, 0)
    buf = torch.zeros((E, C, D), dtype=dt, device=x.device)
    buf.index_put_((flat_e, safe_pos), src, accumulate=True)  # dup-safe: add

    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", buf, p["wu"].to(dt))
    yb = torch.einsum("ecf,efd->ecd", g * u, p["wo"].to(dt))   # (E, C, D)

    y_tok = yb[flat_e, safe_pos].reshape(T, K, D)
    y = torch.einsum("tkd,tk->td", y_tok.to(_F32), gate_keep).to(dt)

    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(cfg, p["shared"], xt)
    return y.reshape(B, S, D), aux


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


def moe_apply_a2a(cfg, p, x, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with an explicit all-to-all exchange between the
    shards of ``mesh``, the reference's ``shard_map`` path.

    The tokens are split over the batch axes, then over "model": each rank
    routes its ``T2`` tokens (``moe_apply``'s softmax, top-k and
    renormalisation), fills one ``(C2, D)`` send buffer per destination
    rank (``C2`` slots, ``_capacity(T2, cfg, M)``), ``all_to_all``
    exchanges them, each rank runs every one of its ``E/M`` local experts
    on the whole received buffer and selects per row (the reference's
    overcompute), a second ``all_to_all`` sends the results back, the gates
    weight them and ``all_gather`` over "model" makes each batch shard's
    output whole. The load-balance aux uses global means (a sum over every
    shard, over ``T``). Shards run one after another in row-major order on
    their devices; the weights are whole tensors, each rank reading its
    experts' slice. Falls back to ``moe_apply`` when the reference does
    (``a2a_applies``). ``recording_routes`` gets one entry per call: the
    ranks' expert ids, keep masks and slots (within the destination
    rank's buffer) in token order.

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
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    if T % n_bd:
        raise ValueError(f"{T} tokens do not split over the batch axes "
                         f"{bd} of size {n_bd}")
    E_loc = E // M
    T_loc = T // n_bd
    T2 = T_loc // M
    C2 = _capacity(T2, cfg, M)
    xt = x.reshape(T, D)

    shape = (n_bd, M)
    route = np.empty(shape, dtype=object)
    send = np.empty(shape, dtype=object)
    send_e = np.empty(shape, dtype=object)
    me_sum = np.empty(shape, dtype=object)
    ce_sum = np.empty(shape, dtype=object)
    picked = []
    for b, m in _at_each(devs):
        dev = devs[b, m]
        lo = b * T_loc + m * T2
        x_my = xt[lo:lo + T2].to(dev)
        probs, gate_vals, eidx = _route(x_my, p["router"].to(dev), K)
        me_sum[b, m] = probs.sum(0)
        ce_sum[b, m] = F.one_hot(eidx[:, 0], E).to(_F32).sum(0)

        flat_e = eidx.reshape(-1)                              # (T2*K,)
        dest = flat_e // E_loc                                 # rank
        e_loc = flat_e % E_loc                                 # local expert
        keep, safe_pos = _slots(dest, M, C2)
        picked.append((eidx, keep, safe_pos))
        gate_keep = torch.where(keep.reshape(T2, K), gate_vals.to(_F32),
                                0.0)
        src = torch.repeat_interleave(x_my, K, dim=0)
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

    if disp is None:
        # load-balance aux from the global means
        t = torch.tensor(float(T), dtype=_F32, device=devs[0, 0])
        me = collectives.psum(me_sum, (0, 1)).item() / t
        ce = collectives.psum(ce_sum, (0, 1)).item() / t
        aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    else:
        disp.me_sum.append(collectives.psum(me_sum, (0, 1)).item())
        disp.ce_sum.append(collectives.psum(ce_sum, (0, 1)).item())
        aux = torch.zeros((), dtype=_F32, device=x.device)

    recv = collectives.all_to_all(send, 1)
    recv_e = collectives.all_to_all(send_e, 1)
    out = np.empty(shape, dtype=object)
    for b, m in _at_each(devs):
        dev = devs[b, m]
        tok = recv[b, m].reshape(M * C2, D)
        sel = recv_e[b, m].reshape(-1)
        wg, wu, wo = (p[k][m * E_loc:(m + 1) * E_loc].to(dev)
                      for k in ("wg", "wu", "wo"))

        def one_expert(le):
            g = F.silu(tok @ wg[le].to(dt))
            u = tok @ wu[le].to(dt)
            return (g * u) @ wo[le].to(dt)

        yb = one_expert(0)
        for le in range(1, E_loc):
            yb = torch.where((sel == le)[:, None], one_expert(le), yb)
        out[b, m] = yb.reshape(M, C2, D)

    back = collectives.all_to_all(out, 1)
    y_my = np.empty(shape, dtype=object)
    for b, m in _at_each(devs):
        dest, safe_pos, gate_keep = route[b, m]
        y_tok = back[b, m][dest, safe_pos].reshape(T2, K, D)
        y_my[b, m] = torch.einsum("tkd,tk->td", y_tok.to(_F32),
                                  gate_keep).to(dt)
    y_loc = np.empty(n_bd, dtype=object)
    for b in range(n_bd):
        y_loc[b] = collectives.all_gather(y_my[b], 0)          # (T_loc, D)
    y = collectives.all_gather(y_loc, 0).to(x.device).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(cfg, p["shared"], x)
    return y, aux.to(x.device)
