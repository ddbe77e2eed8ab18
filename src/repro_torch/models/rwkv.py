"""RWKV-6 ("Finch") token mixer — data-dependent decay linear attention.

Per head (dh-dim keys/values), per-channel decay w_t ∈ (0,1):

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ                 S: (dh_k, dh_v)
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

Chunk-parallel formulation: the intra-chunk pairwise decay exponent
``cw_{t-1} - cw_i ≤ 0`` is materialized per (T, T, channel) tile — exact and
overflow-free (a rank-1 factorization is NOT numerically safe with
data-dependent decays); inter-chunk terms ride a state carried over a loop
of chunks (the reference's ``lax.scan``).

Decode is the exact recurrence on a constant-size state.

The ``*_tp`` functions are the same on a tensor-parallel row
(``distributed.mesh.tensor_parallel``), the leaves split as the
reference's layout splits them: the time mix's ``wr`` / ``wk`` / ``wv`` /
``wg`` and the channel mix's ``wk`` / ``wr`` by column, both ``wo`` / ``wv``
by row, ``u`` by head where the heads divide the row. A column split need
not fall between heads (40 heads of 64 on 16 positions).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed import collectives
from ..distributed import mesh as _mesh
from . import layers

_F32 = torch.float32
LORA_MIX = 32
LORA_DECAY = 64


class RWKVCache(NamedTuple):
    shift_tmix: torch.Tensor   # (B, D) previous token (time-mix)
    shift_cmix: torch.Tensor   # (B, D) previous token (channel-mix)
    wkv: torch.Tensor          # (B, H, dh, dh) fp32 state
    index: int


def _dims(cfg):
    D = cfg.d_model
    dh = 64
    return D, D // dh, dh


def tmix_init(gen: torch.Generator, cfg) -> dict:
    D, H, dh = _dims(cfg)
    dev = gen.device
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

    def full(shape, v):
        return torch.full(shape, v, dtype=_F32, device=dev)

    p = {
        "mu_base": full((D,), 0.5),
        "wo": layers.dense_init(gen, (D, D), scale=out_scale),
        "u": torch.zeros((H, dh), dtype=_F32, device=dev),
        "w0": full((D,), -1.5),
        "w_A": layers.dense_init(gen, (D, LORA_DECAY), scale=0.1),
        "w_B": layers.dense_init(gen, (LORA_DECAY, D), scale=0.1),
        "ln_w": layers.norm_init(D, dev),
    }
    for c in ("r", "k", "v", "g"):
        p[f"w{c}"] = layers.dense_init(gen, (D, D))
        p[f"mu_{c}"] = full((D,), 0.5)
        p[f"mix_A_{c}"] = layers.dense_init(gen, (D, LORA_MIX), scale=0.1)
        p[f"mix_B_{c}"] = layers.dense_init(gen, (LORA_MIX, D), scale=0.1)
    return p


def cmix_init(gen: torch.Generator, cfg) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    dev = gen.device
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    return {
        "mu_k": torch.full((D,), 0.5, dtype=_F32, device=dev),
        "mu_r": torch.full((D,), 0.5, dtype=_F32, device=dev),
        "wk": layers.dense_init(gen, (D, Fd)),
        "wv": layers.dense_init(gen, (Fd, D), scale=out_scale),
        "wr": layers.dense_init(gen, (D, D)),
    }


def _token_shift(x, prev):
    """x: (B,S,D); prev: (B,D) last token of previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(p, c, x, xprev):
    """RWKV6 data-dependent lerp for channel c."""
    dt = x.dtype
    base = x + (xprev - x) * p["mu_base"].to(dt)
    mix = p[f"mu_{c}"].to(dt) + torch.tanh(
        base @ p[f"mix_A_{c}"].to(dt)) @ p[f"mix_B_{c}"].to(dt)
    return x + (xprev - x) * mix


def _decay_log(p, x, xprev, lo: int = 0, hi: Optional[int] = None):
    """Per-channel log-decay  lw = -exp(w0 + lora(x))  (negative), of
    channels ``[lo, hi)`` (default all)."""
    dt = x.dtype
    base = x + (xprev - x) * p["mu_base"].to(dt)
    w0, w_B = p["w0"], p["w_B"]
    if hi is not None:
        w0, w_B = w0[lo:hi], w_B[:, lo:hi]
    wr = w0.to(_F32) + (
        torch.tanh(base @ p["w_A"].to(dt)) @ w_B.to(dt)).to(_F32)
    return -torch.exp(wr)                                 # (B,S,D)


def _group_norm_heads(y, weight, H, eps=64e-5):
    """Per-head layernorm of (B,S,H,dh) flattened output (RWKV ln_x)."""
    B, S, _, dh = y.shape
    y32 = y.to(_F32)
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, unbiased=False)
    out = (y32 - mu) * torch.rsqrt(var + eps)
    return out.reshape(B, S, H * dh) * (1.0 + weight.to(_F32))


def _projections(p, x, xprev):
    dt = x.dtype
    r = _ddlerp(p, "r", x, xprev) @ p["wr"].to(dt)
    k = _ddlerp(p, "k", x, xprev) @ p["wk"].to(dt)
    v = _ddlerp(p, "v", x, xprev) @ p["wv"].to(dt)
    g = F.silu(_ddlerp(p, "g", x, xprev) @ p["wg"].to(dt))
    return r, k, v, g, _decay_log(p, x, xprev)


def _wkv_chunks(r, k, v, lw, u, T: int):
    """The chunked wkv recurrence of ``h`` heads: ``r``, ``k``, ``v``,
    ``lw`` (B, S, h dh), ``u`` (h, dh) fp32, chunks of ``T``. Returns y
    (B, S, h, dh) fp32 and the final state (B, h, dh, dh)."""
    B, S, _ = r.shape
    H, dh = u.shape
    nc = S // T
    rc = r.reshape(B, nc, T, H, dh)
    kc = k.reshape(B, nc, T, H, dh)
    vc = v.reshape(B, nc, T, H, dh)
    lwc = lw.reshape(B, nc, T, H, dh)
    cw = torch.cumsum(lwc, dim=2)                         # inclusive
    mask_strict = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                        device=r.device), diagonal=-1)

    state = torch.zeros((B, H, dh, dh), dtype=_F32, device=r.device)
    ys = []
    for c in range(nc):
        rq, kq, vq = (a[:, c].to(_F32) for a in (rc, kc, vc))
        cwq, lwq = cw[:, c], lwc[:, c]                    # (B,T,H,dh)
        cw_last = cwq[:, -1]                              # (B,H,dh)
        ecw = cwq - lwq                                   # exclusive cumsum
        # intra-chunk: A[t,i] = Σ_c r_t[c] k_i[c] exp(cw_{t-1,c} - cw_{i,c})
        # for i < t; the pairwise exponent is <= 0 (cw is decreasing)
        diff = ecw[:, :, None] - cwq[:, None, :, :]       # (B,T,T,H,dh)
        att = torch.einsum("bthc,bihc,btihc->bhti", rq, kq,
                           torch.exp(torch.clamp(diff, max=0.0)))
        att = torch.where(mask_strict[None, None], att, 0.0)
        y_intra = torch.einsum("bhti,bihd->bthd", att, vq)
        # diagonal u-bonus
        diag = torch.einsum("bthc,hc,bthc->bth", rq, u, kq)
        y_u = diag[..., None] * vq
        # inter: y_t += (r_t ⊙ exp(ecw_t)) @ S_prev   (ecw <= 0: safe)
        y_inter = torch.einsum("bthc,bhcd->bthd", rq * torch.exp(ecw), state)
        # state update:  S' = exp(cw_last) S + Σ_i k_i exp(cw_last - cw_i) v_i
        k_upd = kq * torch.exp(cw_last[:, None] - cwq)
        state = torch.exp(cw_last)[..., None] * state + torch.einsum(
            "bthc,bthd->bhcd", k_upd, vq)
        ys.append(y_intra + y_u + y_inter)
    return torch.stack(ys, dim=1).reshape(B, S, H, dh), state


def _wkv_step(r, k, v, lw, u, s):
    """One step of the recurrence: ``r``, ``k``, ``v``, ``lw`` (B, h dh),
    ``u`` (h, dh) fp32, ``s`` (B, h, dh, dh). Returns y (B, h, dh) fp32
    and the new state."""
    B = r.shape[0]
    H, dh = u.shape
    lw = lw.reshape(B, H, dh)
    r = r.reshape(B, H, dh).to(_F32)
    k = k.reshape(B, H, dh).to(_F32)
    v = v.reshape(B, H, dh).to(_F32)
    y = torch.einsum("bhc,bhcd->bhd", r, s) + torch.einsum(
        "bhc,hc,bhc,bhd->bhd", r, u, k, v)
    s_new = torch.exp(lw)[..., None] * s + torch.einsum("bhc,bhd->bhcd", k, v)
    return y, s_new


def _chunk(cfg, S: int) -> int:
    T = cfg.rwkv_chunk
    while S % T:
        T //= 2
    return T


def tmix_apply(cfg, p, x, shift_prev=None, return_state: bool = False):
    """Time-mix over a full sequence (training / prefill)."""
    dt = x.dtype
    B, S, D = x.shape
    _, H, dh = _dims(cfg)
    if shift_prev is None:
        shift_prev = torch.zeros((B, D), dtype=dt, device=x.device)
    xprev = _token_shift(x, shift_prev)
    r, k, v, g, lw = _projections(p, x, xprev)
    y, state = _wkv_chunks(r, k, v, lw, p["u"].to(_F32), _chunk(cfg, S))
    y = _group_norm_heads(y, p["ln_w"], H).to(dt)
    out = (y * g) @ p["wo"].to(dt)
    if return_state:
        return out, state
    return out


def cmix_apply(cfg, p, x, shift_prev=None) -> torch.Tensor:
    dt = x.dtype
    B, S, D = x.shape
    if shift_prev is None:
        shift_prev = torch.zeros((B, D), dtype=dt, device=x.device)
    xprev = _token_shift(x, shift_prev)
    xk = x + (xprev - x) * p["mu_k"].to(dt)
    xr = x + (xprev - x) * p["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
    return torch.sigmoid(xr @ p["wr"].to(dt)) * (kk @ p["wv"].to(dt))


# --------------------------------------------------------------- decode
def init_cache(cfg, batch: int, dtype, device=None) -> RWKVCache:
    D, H, dh = _dims(cfg)
    return RWKVCache(
        shift_tmix=torch.zeros((batch, D), dtype=dtype, device=device),
        shift_cmix=torch.zeros((batch, D), dtype=dtype, device=device),
        wkv=torch.zeros((batch, H, dh, dh), dtype=_F32, device=device),
        index=0)


def tmix_decode(cfg, p, x, cache: RWKVCache) -> Tuple[torch.Tensor,
                                                      RWKVCache]:
    """x: (B, 1, D) single-token time-mix."""
    dt = x.dtype
    _, H, dh = _dims(cfg)
    xprev = cache.shift_tmix[:, None].to(dt)
    r, k, v, g, lw = _projections(p, x, xprev)
    y, s_new = _wkv_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                         p["u"].to(_F32), cache.wkv)
    y = _group_norm_heads(y[:, None], p["ln_w"], H).to(dt)
    out = (y * g) @ p["wo"].to(dt)
    return out, cache._replace(
        shift_tmix=x[:, 0].to(cache.shift_tmix.dtype), wkv=s_new,
        index=cache.index + 1)


def cmix_decode(cfg, p, x, cache: RWKVCache) -> Tuple[torch.Tensor,
                                                      RWKVCache]:
    out = cmix_apply(cfg, p, x, shift_prev=cache.shift_cmix.to(x.dtype))
    return out, cache._replace(shift_cmix=x[:, 0].to(cache.shift_cmix.dtype))


# ------------------------------------------------------------ on a TP row
def _tmix_tp(cfg, ps, xs, xprevs, states=None):
    """The time mix over the row from each position's shifted input:
    ``states`` ``None`` (a whole sequence, chunked) or each position's
    heads' wkv state (one decode step). Each position projects its
    columns of ``r``, ``k``, ``v`` and ``g``; one ``layers.columns_tp``
    exchange fetches the columns of its heads that its neighbours hold (a
    halo, at most the two boundary heads'); the decay comes from the
    whole ``w0`` / ``w_A`` / ``w_B`` for its heads' channels. It runs the
    recurrence and the per-head norm on its heads, keeps its own columns,
    gates them with its ``g`` and multiplies its rows of ``wo``;
    ``all_reduce`` adds the partial outputs. Returns them and each
    position's heads' new state."""
    row = _mesh.tp_row()
    M = len(row)
    D, H, dh = _dims(cfg)
    plan = layers.head_plan(M, D, dh)

    def project(p, x, xp):
        dt = x.dtype
        return (torch.stack([_ddlerp(p, c, x, xp) @ p[f"w{c}"].to(dt)
                             for c in "rkv"]),
                F.silu(_ddlerp(p, "g", x, xp) @ p["wg"].to(dt)))

    proj = _mesh.each(project, ps, xs, xprevs)
    rkv = layers.columns_tp([a for a, _ in proj], D,
                            [[(h0 * dh, h1 * dh)] for _, (h0, h1), _ in plan])

    def local(j, pl, p, x, xp, rkv, g, s):
        (c0, c1), (h0, h1), _ = pl
        dt = x.dtype
        lw = _decay_log(p, x, xp, h0 * dh, h1 * dh)
        u = layers.piece_of(p["u"], j, h0, h1, H).to(_F32)
        r, k, v = rkv
        if s is None:
            y, s = _wkv_chunks(r, k, v, lw, u, _chunk(cfg, x.shape[1]))
        else:
            y, s = _wkv_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0], u, s)
            y = y[:, None]
        ln_w = layers.piece_of(p["ln_w"], j, h0 * dh, h1 * dh, D)
        y = _group_norm_heads(y, ln_w, h1 - h0).to(dt)
        y = y.narrow(-1, c0 - h0 * dh, c1 - c0)
        g = layers.piece_of(g, j, c0, c1, D, dim=-1)
        return (y * g) @ layers.piece_of(p["wo"], j, c0, c1, D).to(dt), s

    res = _mesh.each(local, range(M), plan, ps, xs, xprevs, rkv,
                     [g for _, g in proj], states or [None] * M)
    return (collectives.all_reduce([o for o, _ in res], row),
            [s for _, s in res], plan)


def tmix_apply_tp(cfg, ps, xs, return_state: bool = False):
    """``tmix_apply`` (from a zero shift) over the row of
    ``distributed.mesh.tp_row()``, the leaves split as the reference's
    layout splits them: ``wr`` / ``wk`` / ``wv`` / ``wg`` by column,
    ``wo`` by row, ``u`` by head where the heads divide the row (whole
    otherwise), the LoRAs, mixes, ``w0`` and ``ln_w`` whole (``_tmix_tp``).
    With ``return_state`` also returns the row's final wkv state, at its
    first position (``decode_state_specs`` splits it by batch only)."""
    dt = xs[0].dtype
    xprevs = _mesh.each(lambda x: _token_shift(x, torch.zeros(
        (x.shape[0], x.shape[2]), dtype=dt, device=x.device)), xs)
    outs, states, plan = _tmix_tp(cfg, ps, xs, xprevs)
    if return_state:
        return outs, layers.heads_home(states, plan, 1)
    return outs


def _shift_tp(cache_home, field: str, xs):
    """The row's previous token (the first position's ``field``) at every
    position (``broadcast_row``), in the compute dtype."""
    prev = getattr(cache_home, field)
    return _mesh.each(lambda p, x: p[:, None].to(x.dtype),
                      collectives.broadcast_row(prev, _mesh.tp_row()), xs)


def tmix_decode_tp(cfg, ps, xs, caches):
    """``tmix_decode`` over the row: ``caches`` one ``RWKVCache`` per
    position, the row's at its first position (``None`` fields at the
    others). The previous token goes to every position, the first
    position sends each its heads' wkv state (``collectives.exchange``),
    ``_tmix_tp`` steps them, and the new states go home. Returns one
    output per position and the caches in that layout."""
    row = _mesh.tp_row()
    home = caches[0]
    D, _, dh = _dims(cfg)
    states = layers.heads_out(home.wkv, layers.head_plan(len(row), D, dh),
                              1)
    outs, states, plan = _tmix_tp(cfg, ps, xs,
                                  _shift_tp(home, "shift_tmix", xs), states)
    with _mesh.at(row[0]):
        shift = xs[0][:, 0].to(home.shift_tmix.dtype, copy=True)
    new = [home._replace(shift_tmix=shift,
                         wkv=layers.heads_home(states, plan, 1),
                         index=home.index + 1)]
    return outs, new + [c._replace(index=home.index + 1) for c in caches[1:]]


def _cmix_tp(cfg, ps, xs, xprevs):
    """The channel mix over the row: ``wk`` split by column and ``wv`` by
    row give each position a partial sum of the value ``relu(x_k wk)^2
    wv``; ``wr`` split by column gives its columns of ``r``. Each position
    takes its columns' slice of the summed value (``reduce_scatter``),
    multiplies its ``sigmoid(r)`` and ``all_gather_row`` joins the row's
    slices. Leaves left whole are used whole (the value summed by
    ``all_reduce`` where only ``wr`` is whole)."""
    row = _mesh.tp_row()
    M = len(row)
    D, Fd = cfg.d_model, cfg.d_ff

    def parts(p, x, xp):
        dt = x.dtype
        xk = x + (xp - x) * p["mu_k"].to(dt)
        xr = x + (xp - x) * p["mu_r"].to(dt)
        kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
        return torch.sigmoid(xr @ p["wr"].to(dt)), kk @ p["wv"].to(dt)

    res = _mesh.each(parts, ps, xs, xprevs)
    rs, vs = [r for r, _ in res], [v for _, v in res]
    split_r = rs[0].shape[-1] != D
    if ps[0]["wv"].shape[0] != Fd:
        if split_r:
            vs = list(collectives.reduce_scatter(
                collectives.shard_array(vs), 0, -1,
                np.asarray(row, dtype=object)))
        else:
            vs = collectives.all_reduce(vs, row)
    if not split_r:
        return _mesh.each(torch.mul, rs, vs)
    outs = _mesh.each(lambda j, r, v: r * layers.piece_of(
        v, j, *layers.span(j, M, D), D, dim=-1), range(M), rs, vs)
    return collectives.all_gather_row(outs, -1, row)


def cmix_apply_tp(cfg, ps, xs):
    """``cmix_apply`` (from a zero shift) over the row (``_cmix_tp``)."""
    dt = xs[0].dtype
    return _cmix_tp(cfg, ps, xs, _mesh.each(lambda x: _token_shift(
        x, torch.zeros((x.shape[0], x.shape[2]), dtype=dt,
                       device=x.device)), xs))


def cmix_decode_tp(cfg, ps, xs, caches):
    """``cmix_decode`` over the row, ``tmix_decode_tp``'s cache layout:
    the previous token from the first position, the new one kept there."""
    home = caches[0]
    outs = _cmix_tp(cfg, ps, xs, _shift_tp(home, "shift_cmix", xs))
    with _mesh.at(_mesh.tp_row()[0]):
        shift = xs[0][:, 0].to(home.shift_cmix.dtype, copy=True)
    return outs, [home._replace(shift_cmix=shift)] + list(caches[1:])
