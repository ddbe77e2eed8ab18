"""Multi-head Latent Attention (DeepSeek-V2) — compressed-KV attention.

Train/prefill uses the naive (expanded) formulation; decode uses the
*absorbed* formulation: the up-projections w_uk / w_uv are folded into the
query / output sides so the cache stays in latent space (kv_lora + rope dims
per token instead of 2·H·dh) and no per-step expansion of the cache occurs.
"""
from __future__ import annotations

import collections
import math
from typing import NamedTuple, Tuple

import torch

from ..distributed import collectives
from ..distributed import mesh as _mesh
from . import layers
from .attention import (NEG, decode_mask, flash_combine, piece_lines,
                        write_line, write_rows)

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


def _split_q(cfg, q, positions):
    """Projected queries (B, S, H (dn + dr)) -> (q_nope, roped q_rope);
    positions: (S,) shared across the batch, or (B, S) per-row."""
    B, S, _ = q.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dims, cfg.qk_rope_dims
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, _batched(positions), cfg.rope_theta)
    return q_nope, q_rope


def _project_q(cfg, p, x, positions):
    """positions: (S,) shared across the batch, or (B, S) per-row."""
    return _split_q(cfg, x @ p["wq"].to(x.dtype), positions)


def latent_kv(cfg, p, x, positions):
    """The cached latents of ``x``: ``c_kv`` (B, S, r) and the roped shared
    key ``k_rope`` (B, S, dr); positions (S,) or (B, S)."""
    dt = x.dtype
    c_kv = layers.rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
    k_rope = layers.apply_rope(
        (x @ p["w_krope"].to(dt))[:, :, None, :], _batched(positions),
        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _attend(cfg, q, k_nope, v, k_rope, positions, causal: bool):
    """The expanded attention of projected queries (B, S, H (dn + dr)),
    keys (B, S, H dn), values (B, S, H dv) and the shared roped key (B, S,
    dr), ``cfg``'s ``H``; returns (B, S, H dv) before ``wo``."""
    dt = q.dtype
    B, S = q.shape[:2]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dims, cfg.qk_rope_dims, cfg.v_head_dim
    q_nope, q_rope = _split_q(cfg, q, positions)
    k_nope = k_nope.reshape(B, S, H, dn)
    v = v.reshape(B, S, H, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
         + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    s = s.to(_F32)
    if causal:
        mask = positions[:, None] >= positions[None, :]
        s = torch.where(mask[None, None], s, NEG)
    probs = torch.softmax(s, -1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(B, S, H * dv)


def mla_apply(cfg, p, x, positions, causal: bool = True) -> torch.Tensor:
    """Naive (expanded) MLA for train / prefill."""
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    c_kv, k_rope = latent_kv(cfg, p, x, positions)
    out = _attend(cfg, q, c_kv @ p["w_uk"].to(dt), c_kv @ p["w_uv"].to(dt),
                  k_rope, positions, causal)
    return out @ p["wo"].to(dt)


# the splits ``mla_apply_tp`` took, one count a call: "whole layer",
# "whole heads" or "through a head"; and "flash-decoding", one count an
# ``mla_decode_tp`` call (read and cleared by callers that must know which
# ran)
tp_splits: collections.Counter = collections.Counter()


def mla_apply_tp(cfg, ps, xs, positions, causal: bool = True):
    """``mla_apply`` over the row of ``distributed.mesh.tp_row()``: one
    parameter tree, input and position vector per position, one output per
    position.

    ``wq`` is column-parallel, ``w_uk`` / ``w_uv`` column-split by heads and
    ``wo`` row-parallel, while ``w_dkv``, ``w_krope`` and ``kv_norm`` are
    whole: each position computes the whole latent ``c_kv`` and ``k_rope``.
    Where the splits give every position whole heads, each computes its
    heads' queries, keys, values and scores, applies its rows of ``wo``,
    and ``all_reduce`` adds the rows. Where a split cuts through a head,
    the projections' columns are gathered whole at every position
    (``all_gather_row``), the attention computed there whole, and only
    ``wo``'s row split divides the work. Leaves left whole give every
    position the whole layer. Each call counts its split in
    ``tp_splits``."""
    row = _mesh.tp_row()
    M = len(row)
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dims, cfg.qk_rope_dims, cfg.v_head_dim
    width = {"wq": H * (dn + dr), "w_uk": H * dn, "w_uv": H * dv}
    split = {k: ps[0][k].shape[-1] != w for k, w in width.items()}
    wo_split = ps[0]["wo"].shape[0] != H * dv
    if not (any(split.values()) or wo_split):
        tp_splits["whole layer"] += 1
        return _mesh.each(lambda p, x, pos: mla_apply(cfg, p, x, pos, causal),
                          ps, xs, positions)
    if H % M == 0 and all(split.values()) and wo_split:
        tp_splits["whole heads"] += 1
        local = cfg.replace(n_heads=H // M, n_kv_heads=H // M)
        outs = _mesh.each(
            lambda p, x, pos: mla_apply(local, p, x, pos, causal),
            ps, xs, positions)
        return collectives.all_reduce(outs, row)
    tp_splits["through a head"] += 1

    def project(name, inputs):
        """The projection's columns, gathered whole where split."""
        cols = _mesh.each(lambda p, x: x @ p[name].to(x.dtype), ps, inputs)
        return collectives.all_gather_row(cols, -1, row) if split[name] \
            else cols

    latents = _mesh.each(lambda p, x, pos: latent_kv(cfg, p, x, pos),
                         ps, xs, positions)
    c_kv = [c for c, _ in latents]
    q, k, v = (project("wq", xs), project("w_uk", c_kv),
               project("w_uv", c_kv))
    n = ps[0]["wo"].shape[0]

    def rows_of_wo(j, p, q, k, v, lat, pos):
        o = _attend(cfg, q, k, v, lat[1], pos, causal)
        if wo_split:
            o = o.narrow(-1, j * n, n)
        return o @ p["wo"].to(o.dtype)

    outs = _mesh.each(rows_of_wo, range(M), ps, q, k, v, latents, positions)
    return collectives.all_reduce(outs, row) if wo_split else outs


def mla_fill_tp(cfg, ps, xs, caches, positions):
    """The MLA latents of each position's lines into its cache piece:
    ``w_dkv``, ``w_krope`` and ``kv_norm`` are whole at every position."""
    if len(caches) != len(xs):
        raise NotImplementedError(
            f"MLA prefill with the latent cache on {len(caches)} positions "
            f"besides a row of {len(xs)}")
    P = caches[0].c_kv.shape[1]
    S = xs[0].shape[1]

    def fill(j, p, x, c, pos):
        first, n = piece_lines(j, P, S)
        c_kv, k_rope = latent_kv(cfg, p, x.narrow(1, first, n),
                                 pos.narrow(0, first, n))
        c.c_kv[:, :n] = c_kv.to(c.c_kv.dtype)
        c.k_rope[:, :n] = k_rope.to(c.k_rope.dtype)
        return c._replace(index=S)

    return _mesh.each(fill, range(len(caches)), ps, xs, caches, positions)


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


def mla_decode_tp(cfg, ps, xs, caches, positions=None):
    """``mla_decode`` over the row of ``distributed.mesh.tp_row()`` with
    the latent cache split by sequence over the row (the reference's
    flash-decoding layout): one parameter tree, input (B, 1, D) and
    ``MLACache`` piece (``c_kv`` (B, S_max/M, r), ``k_rope`` (B, S_max/M,
    dr)) per position, position ``j``'s piece holding lines ``[j S_max/M,
    (j + 1) S_max/M)``; ``positions`` as ``attention.attn_decode_tp``'s.

    ``w_dkv``, ``w_krope`` and ``kv_norm`` are whole, so every position
    computes the new latent line and the piece that holds the cursor
    writes it. With ``wq``, ``w_uk``, ``w_uv`` and ``wo`` split into whole
    heads, each position computes its heads' absorbed ``q_lat`` and roped
    ``q_rope`` and ``all_gather_row`` gives every position all of them
    (``q`` replicated over "model"). Each position scores every head
    against its own latent lines, ``attention.flash_combine`` makes the
    softmax over the pieces and their latent context, and each position
    applies its heads' ``w_uv`` and rows of ``wo``; ``all_reduce`` adds
    them. Leaves left whole give every position the whole layer; a split
    through a head raises. Returns one output per position and the pieces
    (written in place) with the cursor advanced."""
    row = _mesh.tp_row()
    M = len(row)
    if len(caches) != M:
        raise NotImplementedError(
            f"MLA decode with the latent cache on {len(caches)} positions "
            f"besides a row of {M}")
    H = cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dims, cfg.qk_rope_dims, cfg.v_head_dim,
                     cfg.kv_lora)
    idx = caches[0].index
    P = caches[0].c_kv.shape[1]
    if positions is None and not 0 <= idx < P * M:
        raise IndexError(f"decode cursor {idx} outside a cache of {P * M} "
                         "lines")
    positions = positions or [None] * M
    hq = ps[0]["w_uk"].shape[-1] // dn
    split = hq != H
    if split and not (H % M == 0 and hq == H // M
                      and ps[0]["wq"].shape[-1] == hq * (dn + dr)
                      and ps[0]["w_uv"].shape[-1] == hq * dv
                      and ps[0]["wo"].shape[0] == hq * dv):
        raise NotImplementedError(
            f"MLA decode on a row of {M} needs whole heads a position "
            f"({H} heads)")
    local = cfg.replace(n_heads=hq, n_kv_heads=hq)
    tp_splits["flash-decoding"] += 1

    def queries(j, p, x, cache, pos):
        dt = x.dtype
        at = (torch.full((1,), idx, device=x.device) if pos is None
              else pos[:, None])
        q_nope, q_rope = _project_q(local, p, x, at)
        c_new, kr_new = latent_kv(cfg, p, x, at)
        write_line(cache.c_kv, idx, pos, c_new[:, 0], j * P)
        write_line(cache.k_rope, idx, pos, kr_new[:, 0], j * P)
        w_uk = p["w_uk"].to(dt).reshape(r, hq, dn)
        return torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk), q_rope

    qs = _mesh.each(queries, range(M), ps, xs, caches, positions)
    q_lat, q_rope = [q for q, _ in qs], [q for _, q in qs]
    if split:
        q_lat = collectives.all_gather_row(q_lat, 2, row)
        q_rope = collectives.all_gather_row(q_rope, 2, row)

    def partial(j, x, q_lat, q_rope, cache, pos):
        dt = x.dtype
        s = (torch.einsum("bqhr,bkr->bhqk", q_lat, cache.c_kv.to(dt))
             + torch.einsum("bqhd,bkd->bhqk", q_rope, cache.k_rope.to(dt))
             ) * (1.0 / math.sqrt(dn + dr))
        return torch.where(decode_mask(P, idx, pos, 0, x.device, j * P),
                           s.to(_F32), NEG)

    scores = _mesh.each(partial, range(M), xs, q_lat, q_rope, caches,
                        positions)
    ctx = flash_combine(scores, _mesh.each(lambda x, c: c.c_kv.to(x.dtype),
                                           xs, caches),
                        "bhqk,bkr->bqhr", xs[0].dtype, row)

    def output(j, p, c):
        dt = c.dtype
        if split:
            c = c.narrow(2, j * hq, hq)
        w_uv = p["w_uv"].to(dt).reshape(r, hq, dv)
        out = torch.einsum("bqhr,rhd->bqhd", c, w_uv)
        return out.reshape(c.shape[0], 1, hq * dv) @ p["wo"].to(dt)

    outs = _mesh.each(output, range(M), ps, ctx)
    if split:
        outs = collectives.all_reduce(outs, row)
    return outs, [c._replace(index=idx + 1) for c in caches]
