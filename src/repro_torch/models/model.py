"""Model facade: forward / prefill / decode_step over a decode state.

The decode state holds one cache per layer (a list; the reference stacks
them on a leading L axis for its ``lax.scan``), the shared-attention site
caches of a hybrid, and the encoder's cross K/V of an encoder-decoder. The
reference's ``lax.cond`` on a layer's shared-attention flag is a Python
branch here. Attention caches are written in place, so a decode step
updates the state it is given and returns it with the cursors advanced.

``step`` is the sequence cursor: a Python int when every row is at the
same position (bucketed serving), or a (B,) int64 tensor on the state's
device when each row keeps its own (slot-swap continuous batching:
``init_decode_state(per_row=True)``, ``write_slot``,
``prefill(state=, slot=)``). The reference stacks its caches on a leading L
axis, so its batch axis is 1; here each cache is a layer's own, and its
batch axis is 0.

``prefill_tp`` and ``decode_step_tp`` are ``prefill`` and ``decode_step``
on a tensor-parallel row (``distributed.mesh.tensor_parallel``) for the
configs ``transformer.tp_covers(cfg, serving=True)``, with the reference's
flash-decoding cache layout: one parameter tree (the position's "model"
pieces) per position of the row and one ``DecodeState`` per position that
holds a piece of the caches (``mesh.cache_row()``: the row, or every
position of the batch axes and "model" where the batch is not split),
whose attention caches hold the lines of the position's sequence piece
(``decode_state_specs`` splits the cache's sequence over "model", or over
the batch axes and "model"). What that layout splits by batch only or
leaves whole over "model" lives in the row's first position's state: the
recurrent layers' states (mamba2's conv window and SSM state, rwkv6's
shifts and wkv state), the encoder's cross K/V (whisper).
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..distributed import collectives
from ..distributed import mesh as _mesh
from . import attention, layers, mla, rwkv, ssm, transformer
from .transformer import apply_channel, encode

_F32 = torch.float32


class DecodeState(NamedTuple):
    layer: List[Any]          # per-layer caches (KVCache / MLACache / ...)
    shared: Optional[List[attention.KVCache]]   # per-site caches (zamba2)
    cross: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    #                           (enc_out, K (L,B,S_enc,Hkv,dh), V) (whisper)
    step: Any                 # int: one cursor for every row; or (B,)
    #                           int64 tensor: one per row (continuous)


# ------------------------------------------------------------ cache builders
def _layer_cache(cfg, batch: int, max_seq: int, dtype, device):
    """One layer's decode cache for this config's mixer."""
    if cfg.mixer == "attn":
        if cfg.mla:
            return mla.init_cache(cfg, batch, max_seq, dtype, device)
        return attention.init_cache(cfg, batch, max_seq, dtype, device)
    if cfg.mixer == "mamba2":
        return ssm.init_cache(cfg, batch, dtype, device)
    if cfg.mixer == "rwkv6":
        return rwkv.init_cache(cfg, batch, dtype, device)
    raise ValueError(cfg.mixer)


def init_decode_state(cfg, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None,
                      per_row: bool = False) -> DecodeState:
    """A fresh decode cache pool, every row at position 0. ``per_row=True``
    makes ``step`` a (B,) int64 tensor, so that every row keeps its own
    sequence position (slot-swap serving); the per-layer ``index`` cursors
    are then not read."""
    layer = [_layer_cache(cfg, batch, max_seq, dtype, device)
             for _ in range(cfg.n_layers)]
    shared = None
    if cfg.shared_attn_every > 0:
        shared = [attention.init_cache(cfg, batch, max_seq, dtype, device)
                  for _ in range(cfg.attn_sites)]
    cross = None
    if cfg.enc_dec:
        dt = layers.dtype_of(cfg.compute_dtype)
        Hkv, dh = cfg.n_kv_heads, cfg.head_dim
        z = dict(dtype=dt, device=device)
        cross = (
            torch.zeros((batch, cfg.enc_seq, cfg.d_model), **z),
            torch.zeros((cfg.n_layers, batch, cfg.enc_seq, Hkv, dh), **z),
            torch.zeros((cfg.n_layers, batch, cfg.enc_seq, Hkv, dh), **z),
        )
    step = (torch.zeros((batch,), dtype=torch.int64, device=device)
            if per_row else 0)
    return DecodeState(layer=layer, shared=shared, cross=cross, step=step)


# ----------------------------------------------------------------- decode
def _mixer_decode(cfg, bp, x, cache, positions=None):
    if cfg.mixer == "attn":
        if cfg.mla:
            return mla.mla_decode(cfg, bp["mla"], x, cache,
                                  positions=positions)
        return attention.attn_decode(cfg, bp["attn"], x, cache,
                                     use_rope=cfg.use_rope,
                                     positions=positions)
    # recurrent mixers carry per-row state and no positional math: the same
    # decode serves lockstep and per-row cursors
    if cfg.mixer == "mamba2":
        return ssm.ssm_decode(cfg, bp["ssm"], x, cache)
    if cfg.mixer == "rwkv6":
        return rwkv.tmix_decode(cfg, bp["tmix"], x, cache)
    raise ValueError(cfg.mixer)


def _cross_context(cfg, q, k, v):
    """The cross-attention context (B, 1, H dh) of projected queries q
    (B, 1, H dh) against the encoder's K/V (B, S_enc, Hkv, dh)."""
    dt = q.dtype
    B = q.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    q = q.reshape(B, 1, H, dh)
    kk = attention._repeat_kv(k.to(dt), cfg.q_per_kv)
    vv = attention._repeat_kv(v.to(dt), cfg.q_per_kv)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
    probs = torch.softmax(s.to(_F32), -1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    return out.reshape(B, 1, H * dh)


def _cross_decode(cfg, bp, x, k, v):
    """Cross-attention against precomputed encoder K/V (whisper decode)."""
    p = bp["xattn"]
    return _cross_context(cfg, x @ p["wq"].to(x.dtype), k, v) @ \
        p["wo"].to(x.dtype)


def decode_step(cfg, params, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V) fp32,
    the state advanced by one position; every row's, when ``state.step``
    is per row)."""
    dt = layers.dtype_of(cfg.compute_dtype)
    per_row = isinstance(state.step, torch.Tensor)
    positions = state.step if per_row else None
    x = params["embed"]["tok"].to(dt)[token]                 # (B,1,D)
    if cfg.enc_dec:
        pos_emb = layers.sinusoidal_positions(cfg.max_seq, cfg.d_model,
                                              x.device)
        if per_row:
            # the reference's gather clamps a position past the table
            rows = pos_emb[positions.clamp(max=cfg.max_seq - 1)]
            x = x + rows[:, None].to(dt)
        else:
            x = x + pos_emb[state.step:state.step + 1].to(dt)[None]
    layer_new = []
    shared = list(state.shared) if state.shared is not None else None
    for i in range(cfg.n_layers):
        bp = transformer.layer(params["blocks"], i)
        cache = state.layer[i]
        h, cache = _mixer_decode(cfg, bp,
                                 layers.apply_norm(cfg, x, bp["norm1"]),
                                 cache, positions)
        x = x + h
        if transformer.shared_site(cfg, i):
            site = transformer.site_of(cfg, i)
            sc = shared[site]
            if not per_row:
                # all sites share the same write index = step
                sc = sc._replace(index=state.step)
            h2, shared[site] = attention.attn_decode(
                cfg.replace(mixer="attn"), params["shared_attn"],
                layers.apply_norm(cfg, x, params["shared_norm"]), sc,
                use_rope=cfg.use_rope, positions=positions)
            x = x + h2
        if state.cross is not None:
            _, ck, cv = state.cross
            x = x + _cross_decode(
                cfg, bp, layers.apply_norm(cfg, x, bp["norm_x"]), ck[i],
                cv[i])
        h = layers.apply_norm(cfg, x, bp["norm2"])
        if cfg.mlp == "rwkv6_cmix":
            h, cache = rwkv.cmix_decode(cfg, bp["cmix"], h, cache)
        else:
            h, _ = apply_channel(cfg, params, bp, h, i)
        x = x + h
        layer_new.append(cache)
    x = layers.apply_norm(cfg, x, params["final_norm"])
    logits = layers.logits_from_hidden(cfg, params, x)
    return logits, DecodeState(layer=layer_new, shared=shared,
                               cross=state.cross, step=state.step + 1)


# ----------------------------------------------------------------- prefill
def _fill_attn(cfg, p_attn, x_norm, cache, positions):
    """Compute the prompt's K/V (roped K) and write them into cache[:, :S]."""
    dt = x_norm.dtype
    B, S, _ = x_norm.shape
    k = (x_norm @ p_attn["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads,
                                                cfg.head_dim)
    v = (x_norm @ p_attn["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads,
                                                cfg.head_dim)
    if cfg.use_rope:
        k = layers.apply_rope(k, positions[None], cfg.rope_theta)
    cache.k[:, :S] = k.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    return cache._replace(index=S)


def write_slot(cfg, pool: DecodeState, fresh: DecodeState,
               slot: int) -> DecodeState:
    """Copy a batch-1 decode state into row ``slot`` of a per-row pool, in
    place, and return the pool with ``step[slot]`` set to the new request's
    prompt length.

    The slot-swap primitive of continuous batching: the whole row (K/V
    lines, latent caches, recurrent state, conv buffers, the shared sites'
    caches of a hybrid) is overwritten, so nothing a previous occupant left
    behind remains. Every cache tensor has its batch on axis 0 (the
    reference's stacked caches have it on axis 1); the per-layer ``index``
    cursors are ints without a batch and stay untouched, as the reference's
    rank < 2 leaves do.
    """
    if pool.cross is not None:
        raise NotImplementedError(
            "slot-swap prefill does not support encoder-decoder states")

    def rows(pool_caches, fresh_caches):
        for pc, fc in zip(pool_caches, fresh_caches):
            for p, f in zip(pc, fc):
                if isinstance(p, torch.Tensor):
                    p[slot].copy_(f[0])

    rows(pool.layer, fresh.layer)
    if pool.shared is not None:
        rows(pool.shared, fresh.shared)
    step = pool.step.clone()
    step[slot] = int(fresh.step)
    return pool._replace(step=step)


def prefill(cfg, params, tokens: torch.Tensor, max_seq: int,
            vision_embeds=None, audio_frames=None,
            state: Optional[DecodeState] = None, slot: Optional[int] = None,
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the full prompt, returning last-position logits (B, 1, V) and the
    decode state. Attention caches hold the prompt's K/V; recurrent mixers
    keep their end-of-prompt state. Bucketed serving calls this once per
    batch; with ``state`` and ``slot`` given, ``tokens`` must be (1, S) and
    the request's fresh state is written into row ``slot`` of the per-row
    pool ``state`` (a slot swap mid-decode), which is returned."""
    if state is not None:
        if tokens.shape[0] != 1:
            raise ValueError("slot prefill expects a (1, S) prompt; got "
                             f"B={tokens.shape[0]}")
        logits, fresh = prefill(cfg, params, tokens, max_seq, vision_embeds,
                                audio_frames)
        return logits, write_slot(cfg, state, fresh, slot)
    dt = layers.dtype_of(cfg.compute_dtype)
    B = tokens.shape[0]
    dev = tokens.device
    x = transformer.embed(cfg, params, tokens, vision_embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=dev)
    state = init_decode_state(cfg, B, max_seq, dt, dev)
    enc_out = cross = None
    if cfg.enc_dec:
        enc_out = encode(cfg, params, audio_frames)
        x = x + layers.sinusoidal_positions(S, cfg.d_model, dev).to(dt)[None]
        Hkv, dh = cfg.n_kv_heads, cfg.head_dim
        xa = params["blocks"]["xattn"]
        ck = torch.stack([(enc_out @ xa["wk"][i].to(dt)).reshape(
            B, cfg.enc_seq, Hkv, dh) for i in range(cfg.n_layers)])
        cv = torch.stack([(enc_out @ xa["wv"][i].to(dt)).reshape(
            B, cfg.enc_seq, Hkv, dh) for i in range(cfg.n_layers)])
        cross = (enc_out, ck, cv)

    layer_new = []
    shared = state.shared
    for i in range(cfg.n_layers):
        bp = transformer.layer(params["blocks"], i)
        cache = state.layer[i]
        h_in = layers.apply_norm(cfg, x, bp["norm1"])
        if cfg.mixer == "attn":
            if cfg.mla:
                h = mla.mla_apply(cfg, bp["mla"], h_in, positions)
                c_kv, k_rope = mla.latent_kv(cfg, bp["mla"], h_in, positions)
                cache.c_kv[:, :S] = c_kv.to(cache.c_kv.dtype)
                cache.k_rope[:, :S] = k_rope.to(cache.k_rope.dtype)
                cache = cache._replace(index=S)
            else:
                h = attention.attn_apply(cfg, bp["attn"], h_in, positions,
                                         use_rope=cfg.use_rope)
                cache = _fill_attn(cfg, bp["attn"], h_in, cache, positions)
        elif cfg.mixer == "mamba2":
            h, cache = ssm.ssm_apply(cfg, bp["ssm"], h_in, return_cache=True)
        elif cfg.mixer == "rwkv6":
            h, wkv = rwkv.tmix_apply(cfg, bp["tmix"], h_in,
                                     return_state=True)
            cache = cache._replace(
                shift_tmix=h_in[:, -1].to(cache.shift_tmix.dtype), wkv=wkv,
                index=S)
        else:
            raise ValueError(cfg.mixer)
        x = x + h
        if transformer.shared_site(cfg, i):
            scfg = cfg.replace(mixer="attn")
            site = transformer.site_of(cfg, i)
            xn = layers.apply_norm(cfg, x, params["shared_norm"])
            x = x + attention.attn_apply(scfg, params["shared_attn"], xn,
                                         positions, use_rope=cfg.use_rope)
            shared[site] = _fill_attn(scfg, params["shared_attn"], xn,
                                      shared[site], positions)
        if cross is not None:
            x = x + attention.attn_apply(
                cfg, bp["xattn"], layers.apply_norm(cfg, x, bp["norm_x"]),
                positions, causal=False, kv_source=enc_out, use_rope=False)
        h_in2 = layers.apply_norm(cfg, x, bp["norm2"])
        if cfg.mlp == "rwkv6_cmix":
            h2 = rwkv.cmix_apply(cfg, bp["cmix"], h_in2)
            cache = cache._replace(
                shift_cmix=h_in2[:, -1].to(cache.shift_cmix.dtype))
        else:
            h2, _ = apply_channel(cfg, params, bp, h_in2, i)
        x = x + h2
        layer_new.append(cache)
    x = layers.apply_norm(cfg, x, params["final_norm"])
    logits = layers.logits_from_hidden(cfg, params, x[:, -1:])
    return logits, DecodeState(layer=layer_new, shared=shared, cross=cross,
                               step=S)


# ------------------------------------------------------- on a TP row of pieces
def _cross_kv_tp(cfg, ps, enc_outs):
    """The encoder's K and V for every layer, (L, B, S_enc, Hkv, dh) each,
    whole at the row's first position (``decode_state_specs`` leaves them
    whole over "model"): each position projects its columns, gathered
    there."""
    row = _mesh.tp_row()
    B, S_enc = enc_outs[0].shape[:2]
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    out = []
    for name in ("wk", "wv"):
        per_layer = []
        for i in range(cfg.n_layers):
            cols = _mesh.each(lambda p, e: e @ p["blocks"]["xattn"][name][i]
                              .to(e.dtype), ps, enc_outs)
            whole = cols[0] if cols[0].shape[-1] == Hkv * dh else \
                collectives.all_gather(collectives.shard_array(cols), -1,
                                       row[0])
            per_layer.append(whole.reshape(B, S_enc, Hkv, dh))
        with _mesh.at(row[0]):
            out.append(torch.stack(per_layer))
    return out


def _row_caches(cfg, B: int, P: int, dt, dev, S: int) -> DecodeState:
    """The state pieces a position of the row's cache positions starts
    with: an attention layer's ``P``-line piece (filled by prefill), a
    recurrent layer's placeholder (the row's state lives at its first
    position), the shared sites' pieces."""
    rec = {"mamba2": ssm.SSMCache(None, None, S),
           "rwkv6": rwkv.RWKVCache(None, None, None, S)}
    layer = [_layer_cache(cfg, B, P, dt, dev) if cfg.mixer == "attn"
             else rec[cfg.mixer] for _ in range(cfg.n_layers)]
    shared = None
    if cfg.shared_attn_every > 0:
        shared = [attention.init_cache(cfg, B, P, dt, dev)
                  for _ in range(cfg.attn_sites)]
    return DecodeState(layer=layer, shared=shared, cross=None, step=S)


def prefill_tp(cfg, ps, tokens, max_seq: int, vision_embeds=None,
               audio_frames=None):
    """``prefill`` on the row of ``mesh.tp_row()``: ``ps`` one parameter
    tree per position, the inputs one tensor per position (the batch
    shard's rows). The prompt runs through ``transformer.forward_tp``'s
    blocks (``transformer._block_tp``), which also fill the caches. The
    ``N`` positions of ``mesh.cache_row()`` (the row, or more) hold the
    attention caches: position ``j``'s piece lines ``[j P, (j + 1) P)`` of
    the ``max_seq``-line cache, ``P = max_seq / N``
    (``attention.attn_fill_tp``, ``mla.mla_fill_tp``); a recurrent layer's
    state (split by batch only) lands at the row's first position.
    Returns each position's
    last-position logits of its range of the vocabulary (fp32, (B, 1,
    V/M); the whole vocabulary where the head is whole) and one
    ``DecodeState`` per position of the cache row."""
    lines = _mesh.cache_row()
    N = len(lines)
    if max_seq % N and (cfg.mixer == "attn" or cfg.shared_attn_every > 0):
        raise ValueError(f"a cache of {max_seq} lines does not split over "
                         f"{N} positions")
    P = max_seq // N
    dt = layers.dtype_of(cfg.compute_dtype)
    xs = transformer.embed_tp(cfg, ps, tokens, vision_embeds)
    B, S = xs[0].shape[:2]
    if S > max_seq:
        raise ValueError(f"a prompt of {S} tokens into a cache of "
                         f"{max_seq} lines")
    positions = transformer._positions_tp(xs)
    states = _mesh.each(lambda d: _row_caches(cfg, B, P, dt, d, S), lines,
                        over=lines)
    cross = enc_outs = None
    if cfg.enc_dec:
        enc_outs = transformer.encode_tp(cfg, ps, audio_frames)
        xs = _mesh.each(lambda x: x + layers.sinusoidal_positions(
            S, cfg.d_model, x.device).to(dt)[None], xs)
        cross = (enc_outs[0], *_cross_kv_tp(cfg, ps, enc_outs))
    blocks = [p["blocks"] for p in ps]
    for i in range(cfg.n_layers):
        xs, _ = transformer._block_tp(cfg, ps, blocks, xs, positions, i,
                                      enc_outs, states)
    xs = transformer._norm_tp(cfg, [x[:, -1:] for x in xs],
                              [p["final_norm"] for p in ps])
    logits = layers.logits_from_hidden_tp(cfg, ps, xs)
    return logits, [s._replace(cross=cross) if j == 0 else s
                    for j, s in enumerate(states)]


def _mixer_decode_tp(cfg, bps, xs, caches, positions):
    """A layer's mixer for one token on the row: ``caches`` one per
    position of ``mesh.cache_row()``; a recurrent layer's state at the
    row's first position."""
    M = len(xs)
    if cfg.mixer == "mamba2":
        hs, new = ssm.ssm_decode_tp(cfg, [b["ssm"] for b in bps], xs,
                                    caches[:M])
        return hs, new + list(caches[M:])
    if cfg.mixer == "rwkv6":
        hs, new = rwkv.tmix_decode_tp(cfg, [b["tmix"] for b in bps], xs,
                                      caches[:M])
        return hs, new + list(caches[M:])
    if cfg.mla:
        return mla.mla_decode_tp(cfg, [b["mla"] for b in bps], xs, caches,
                                 positions)
    return attention.attn_decode_tp(cfg, [b["attn"] for b in bps], xs,
                                    caches, cfg.use_rope, positions)


def _cross_decode_tp(cfg, bps, xs, k, v):
    """``_cross_decode`` on the row against the encoder's K/V of one layer,
    whole at the row's first position: each position's query heads from
    its columns of ``wq``, gathered there (``B H dh`` values); the context
    computed there and sent to every position (``broadcast_row``, the same
    size); each position's rows of ``wo``, added by ``all_reduce``. The
    encoder's K/V never move."""
    row = _mesh.tp_row()
    H, dh = cfg.n_heads, cfg.head_dim
    pxs = [b["xattn"] for b in bps]
    qs = _mesh.each(lambda p, x: x @ p["wq"].to(x.dtype), pxs, xs)
    q = qs[0] if qs[0].shape[-1] == H * dh else collectives.all_gather(
        collectives.shard_array(qs), -1, row[0])
    with _mesh.at(row[0]):
        ctx = _cross_context(cfg, q, k, v)
    return attention.row_split_wo(H * dh, pxs,
                                  collectives.broadcast_row(ctx, row), row)


def decode_step_tp(cfg, ps, tokens, states):
    """``decode_step`` on the row of ``mesh.tp_row()``: ``ps`` one
    parameter tree per position, ``tokens`` one (B, 1) per position (the
    batch shard's rows), ``states`` one ``DecodeState`` per position of
    ``mesh.cache_row()`` (``prefill_tp``'s: the position's cache pieces,
    a recurrent layer's state at the row's first position; a per-row
    ``step`` a (B,) tensor at each position). Every attention layer and
    shared site runs ``attention.attn_decode_tp`` / ``mla.mla_decode_tp``
    against the pieces, written in place, a mamba2 layer
    ``ssm.ssm_decode_tp``, an rwkv6 layer ``rwkv.tmix_decode_tp`` and
    ``cmix_decode_tp``, the channel ``apply_channel_tp``, whisper's
    cross-attention ``_cross_decode_tp``. Returns each position's logits
    of its range of the vocabulary (fp32, (B, 1, V/M)) and the states
    advanced by one position."""
    dt = layers.dtype_of(cfg.compute_dtype)
    M = len(ps)
    per_row = isinstance(states[0].step, torch.Tensor)
    positions = [s.step for s in states] if per_row else None
    xs = transformer.embed_tp(cfg, ps, tokens)
    if cfg.enc_dec:
        def add_position(x, s):
            pos_emb = layers.sinusoidal_positions(cfg.max_seq, cfg.d_model,
                                                  x.device)
            if per_row:
                rows = pos_emb[s.step.clamp(max=cfg.max_seq - 1)]
                return x + rows[:, None].to(dt)
            return x + pos_emb[s.step:s.step + 1].to(dt)[None]
        xs = _mesh.each(add_position, xs, states[:M])
    blocks = [p["blocks"] for p in ps]
    norm = transformer._norm_tp
    shared = [list(s.shared) if s.shared is not None else None
              for s in states]
    layer_new = []
    for i in range(cfg.n_layers):
        bps = transformer._layer_tp(blocks, i)
        hs, caches = _mixer_decode_tp(
            cfg, bps, norm(cfg, xs, [b["norm1"] for b in bps]),
            [s.layer[i] for s in states], positions)
        xs = transformer._add(xs, hs)
        if transformer.shared_site(cfg, i):
            site = transformer.site_of(cfg, i)
            scfg = cfg.replace(mixer="attn")
            sc = [sh[site] for sh in shared]
            if not per_row:
                sc = [c._replace(index=states[0].step) for c in sc]
            hs, sc = attention.attn_decode_tp(
                scfg, [p["shared_attn"] for p in ps],
                norm(cfg, xs, [p["shared_norm"] for p in ps]), sc,
                cfg.use_rope, positions)
            for sh, c in zip(shared, sc):
                sh[site] = c
            xs = transformer._add(xs, hs)
        if states[0].cross is not None:
            _, ck, cv = states[0].cross
            xs = transformer._add(xs, _cross_decode_tp(
                cfg, bps, norm(cfg, xs, [b["norm_x"] for b in bps]), ck[i],
                cv[i]))
        h_in = norm(cfg, xs, [b["norm2"] for b in bps])
        if cfg.mlp == "rwkv6_cmix":
            hs, new = rwkv.cmix_decode_tp(cfg, [b["cmix"] for b in bps],
                                          h_in, caches[:M])
            caches = new + list(caches[M:])
        else:
            hs, _ = transformer.apply_channel_tp(cfg, ps, bps, h_in, i)
        xs = transformer._add(xs, hs)
        layer_new.append(caches)
    xs = norm(cfg, xs, [p["final_norm"] for p in ps])
    logits = layers.logits_from_hidden_tp(cfg, ps, xs)
    return logits, _mesh.each(
        lambda j, s: DecodeState(layer=[c[j] for c in layer_new],
                                 shared=shared[j], cross=s.cross,
                                 step=s.step + 1),
        range(len(states)), states, over=_mesh.cache_row())
