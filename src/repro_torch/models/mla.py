"""Multi-head Latent Attention (DeepSeek-V2) — compressed-KV attention.

Train/prefill uses the naive (expanded) formulation; decode uses the
*absorbed* formulation: the up-projections w_uk / w_uv are folded into the
query / output sides so the cache stays in latent space (kv_lora + rope dims
per token instead of 2·H·dh) and no per-step expansion of the cache occurs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from . import layers
from .attention import NEG, decode_mask, write_rows

_F32 = torch.float32


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S_max, kv_lora)
    k_rope: torch.Tensor   # (B, S_max, rope_dims)
    index: int


def mla_init(gen: torch.Generator, cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    r, dn, dv = cfg.kv_lora, cfg.qk_nope_dims, cfg.v_head_dim
    dr = cfg.qk_rope_dims
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    return {
        "wq": layers.dense_init(gen, (D, H * (dn + dr))),
        "w_dkv": layers.dense_init(gen, (D, r)),
        "w_krope": layers.dense_init(gen, (D, dr)),
        "kv_norm": layers.norm_init(r, gen.device),
        "w_uk": layers.dense_init(gen, (r, H * dn)),
        "w_uv": layers.dense_init(gen, (r, H * dv)),
        "wo": layers.dense_init(gen, (H * dv, D), scale=out_scale),
    }


def _batched(positions):
    """(S,) positions shared across the batch -> (1, S); (B, S) per-row
    positions as they are."""
    return positions if positions.ndim == 2 else positions[None]


def _project_q(cfg, p, x, positions):
    """positions: (S,) shared across the batch, or (B, S) per-row."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dims, cfg.qk_rope_dims
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, _batched(positions), cfg.rope_theta)
    return q_nope, q_rope


def latent_kv(cfg, p, x, positions):
    """The cached latents of ``x``: ``c_kv`` (B, S, r) and the roped shared
    key ``k_rope`` (B, S, dr); positions (S,) or (B, S)."""
    dt = x.dtype
    c_kv = layers.rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
    k_rope = layers.apply_rope(
        (x @ p["w_krope"].to(dt))[:, :, None, :], _batched(positions),
        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_apply(cfg, p, x, positions, causal: bool = True) -> torch.Tensor:
    """Naive (expanded) MLA for train / prefill."""
    dt = x.dtype
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dims, cfg.qk_rope_dims, cfg.v_head_dim
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = latent_kv(cfg, p, x, positions)
    k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, dn)
    v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
         + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    s = s.to(_F32)
    if causal:
        mask = positions[:, None] >= positions[None, :]
        s = torch.where(mask[None, None], s, NEG)
    probs = torch.softmax(s, -1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(B, S, H * dv) @ p["wo"].to(dt)


def init_cache(cfg, batch: int, max_seq: int, dtype,
               device=None) -> MLACache:
    z = dict(dtype=dtype, device=device)
    return MLACache(
        c_kv=torch.zeros((batch, max_seq, cfg.kv_lora), **z),
        k_rope=torch.zeros((batch, max_seq, cfg.qk_rope_dims), **z),
        index=0)


def mla_decode(cfg, p, x, cache: MLACache,
               positions=None) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-matrix decode: scores and values in latent space; the new
    latent line is written into the cache in place. Every row is at the
    shared cursor ``cache.index``, or, with ``positions`` (B,), at its own
    (continuous batching; a row at or past the cache's end writes
    nothing, as in ``attention.attn_decode``)."""
    dt = x.dtype
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dims, cfg.qk_rope_dims, cfg.v_head_dim,
                     cfg.kv_lora)
    idx = cache.index
    pos = (torch.full((1,), idx, device=x.device) if positions is None
           else positions[:, None])
    q_nope, q_rope = _project_q(cfg, p, x, pos)
    c_new, kr_new = latent_kv(cfg, p, x, pos)
    if positions is None:
        cache.c_kv[:, idx] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[:, idx] = kr_new[:, 0].to(cache.k_rope.dtype)
    else:
        write_rows(cache.c_kv, positions, c_new[:, 0])
        write_rows(cache.k_rope, positions, kr_new[:, 0])
    # absorb w_uk into the query:  q_lat[h, r] = q_nope[h, dn] @ w_uk[r, h, dn]
    w_uk = p["w_uk"].to(dt).reshape(r, H, dn)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)     # (B,1,H,r)
    scale = 1.0 / math.sqrt(dn + dr)
    c_kv = cache.c_kv.to(dt)
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat, c_kv)
         + torch.einsum("bqhd,bkd->bhqk", q_rope, cache.k_rope.to(dt))
         ) * scale
    s = s.to(_F32)
    s = torch.where(decode_mask(c_kv.shape[1], idx, positions, 0, x.device),
                    s, NEG)
    probs = torch.softmax(s, -1).to(dt)
    ctx = torch.einsum("bhqk,bkr->bqhr", probs, c_kv)        # latent ctx
    w_uv = p["w_uv"].to(dt).reshape(r, H, dv)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)
    out = out.reshape(B, 1, H * dv) @ p["wo"].to(dt)
    return out, cache._replace(index=idx + 1)
