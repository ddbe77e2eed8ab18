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
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

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


def _decay_log(p, x, xprev):
    """Per-channel log-decay  lw = -exp(w0 + lora(x))  (negative)."""
    dt = x.dtype
    base = x + (xprev - x) * p["mu_base"].to(dt)
    wr = p["w0"].to(_F32) + (
        torch.tanh(base @ p["w_A"].to(dt)) @ p["w_B"].to(dt)).to(_F32)
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


def tmix_apply(cfg, p, x, shift_prev=None, return_state: bool = False):
    """Time-mix over a full sequence (training / prefill)."""
    dt = x.dtype
    B, S, D = x.shape
    _, H, dh = _dims(cfg)
    T = cfg.rwkv_chunk
    while S % T:
        T //= 2
    if shift_prev is None:
        shift_prev = torch.zeros((B, D), dtype=dt, device=x.device)
    xprev = _token_shift(x, shift_prev)
    r, k, v, g, lw = _projections(p, x, xprev)

    nc = S // T
    rc = r.reshape(B, nc, T, H, dh)
    kc = k.reshape(B, nc, T, H, dh)
    vc = v.reshape(B, nc, T, H, dh)
    lwc = lw.reshape(B, nc, T, H, dh)
    cw = torch.cumsum(lwc, dim=2)                         # inclusive
    u = p["u"].to(_F32)
    mask_strict = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                        device=x.device), diagonal=-1)

    state = torch.zeros((B, H, dh, dh), dtype=_F32, device=x.device)
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
    y = torch.stack(ys, dim=1).reshape(B, S, H, dh)
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
    B, _, D = x.shape
    _, H, dh = _dims(cfg)
    xprev = cache.shift_tmix[:, None].to(dt)
    r, k, v, g, lw = _projections(p, x, xprev)
    lw = lw[:, 0].reshape(B, H, dh)
    r = r.reshape(B, H, dh).to(_F32)
    k = k.reshape(B, H, dh).to(_F32)
    v = v.reshape(B, H, dh).to(_F32)
    u = p["u"].to(_F32)
    s = cache.wkv
    y = torch.einsum("bhc,bhcd->bhd", r, s) + torch.einsum(
        "bhc,hc,bhc,bhd->bhd", r, u, k, v)
    s_new = torch.exp(lw)[..., None] * s + torch.einsum("bhc,bhd->bhcd", k, v)
    y = _group_norm_heads(y[:, None], p["ln_w"], H).to(dt)
    out = (y * g) @ p["wo"].to(dt)
    return out, cache._replace(
        shift_tmix=x[:, 0].to(cache.shift_tmix.dtype), wkv=s_new,
        index=cache.index + 1)


def cmix_decode(cfg, p, x, cache: RWKVCache) -> Tuple[torch.Tensor,
                                                      RWKVCache]:
    out = cmix_apply(cfg, p, x, shift_prev=cache.shift_cmix.to(x.dtype))
    return out, cache._replace(shift_cmix=x[:, 0].to(cache.shift_cmix.dtype))
