"""Attention: GQA self-attention (full + chunked flash-style), cross-attn,
and KV-cache decode. MLA lives in mla.py.

Layouts: activations (B, S, D); q/k/v (B, S, H, dh). KV heads are repeated
to H before the contraction, as in the reference. Everything here is plain
PyTorch ops (no library attention call): scores and the online-softmax
accumulators are fp32 where the reference makes them fp32, and masked
scores are ``-1e30``.
"""
from __future__ import annotations

import collections
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..distributed import collectives
from ..distributed import mesh as _mesh
from . import layers

_F32 = torch.float32
NEG = -1e30


class KVCache(NamedTuple):
    """One layer's dense cache. Decode writes into ``k`` / ``v`` in place;
    ``index`` is the next write position when every row of a bucket decodes
    in lockstep (a Python int; per-row decode ignores it)."""

    k: torch.Tensor       # (B, S_max, Hkv, dh)
    v: torch.Tensor       # (B, S_max, Hkv, dh)
    index: int


def attn_init(gen: torch.Generator, cfg, cross: bool = False) -> dict:
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    return {
        "wq": layers.dense_init(gen, (D, H * dh)),
        "wk": layers.dense_init(gen, (D, Hkv * dh)),
        "wv": layers.dense_init(gen, (D, Hkv * dh)),
        "wo": layers.dense_init(gen, (H * dh, D), scale=out_scale),
    }


def _split_heads(x, n, dh):
    return x.reshape(x.shape[:-1] + (n, dh))


def _repeat_kv(x, q_per_kv):
    if q_per_kv == 1:
        return x
    return torch.repeat_interleave(x, q_per_kv, dim=2)


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """(Sq, Skv) bool: which keys each query may see."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - kv_pos[None, :] < window
    return m


def _full_attn(q, k, v, q_pos, kv_pos, causal, window):
    """q: (B,Sq,H,dh), k/v: (B,Skv,H,dh). Returns (B,Sq,H,dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores.to(_F32)
    mask = _mask(q_pos, kv_pos, causal, window)
    scores = torch.where(mask[None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_attn(q, k, v, q_pos, kv_pos, causal, window, cq, ckv):
    """Double-chunked online-softmax attention (long prefill): no (Sq, Skv)
    score tensor is made, only (cq, ckv) panels; the reference's two
    ``lax.scan`` loops become Python loops over the chunks."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    nq = -(-Sq // cq)
    nk = -(-Skv // ckv)
    pq = nq * cq - Sq
    pk = nk * ckv - Skv
    pad = torch.nn.functional.pad
    q = pad(q, (0, 0, 0, 0, 0, pq))
    k = pad(k, (0, 0, 0, 0, 0, pk))
    v = pad(v, (0, 0, 0, 0, 0, pk))
    q_pos = pad(q_pos, (0, pq), value=-1)                  # masked out
    kv_pos = pad(kv_pos, (0, pk), value=2**30)             # masked out

    qc = q.reshape(B, nq, cq, H, dh).permute(1, 0, 3, 2, 4)  # (nq,B,H,cq,dh)
    kc = k.reshape(B, nk, ckv, H, dh).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, ckv, H, dh).permute(1, 0, 3, 2, 4)
    qpc = q_pos.reshape(nq, cq)
    kpc = kv_pos.reshape(nk, ckv)

    outs = []
    for qi in range(nq):
        qblk, qp = qc[qi], qpc[qi]                         # (B,H,cq,dh)
        m = torch.full((B, H, cq), -math.inf, dtype=_F32, device=q.device)
        l = torch.zeros((B, H, cq), dtype=_F32, device=q.device)
        acc = torch.zeros((B, H, cq, dh), dtype=_F32, device=q.device)
        for ki in range(nk):
            s = torch.einsum("bhqd,bhkd->bhqk", qblk, kc[ki]) * scale
            s = s.to(_F32)
            msk = _mask(qp, kpc[ki], causal, window)
            s = torch.where(msk[None, None], s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(qblk.dtype), vc[ki]).to(_F32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    out = torch.stack(outs)                                 # (nq,B,H,cq,dh)
    out = out.permute(1, 0, 3, 2, 4).reshape(B, nq * cq, H, dh)
    return out[:, :Sq]


def _attend(cfg, q, k, v, positions, causal: bool, cross: bool,
            use_rope: bool):
    """The attention of projected q (B, S, H*dh) and k / v (B, Skv, Hkv*dh)
    (``cfg``'s head counts); returns (B, S, H*dh) before ``wo``."""
    B, S = q.shape[:2]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(q, H, dh)
    k = _split_heads(k, Hkv, dh)
    v = _split_heads(v, Hkv, dh)
    kv_pos = torch.arange(k.shape[1], device=q.device) if cross \
        else positions
    if use_rope and not cross:
        q = layers.apply_rope(q, positions[None], cfg.rope_theta)
        k = layers.apply_rope(k, kv_pos[None], cfg.rope_theta)
    k = _repeat_kv(k, cfg.q_per_kv)
    v = _repeat_kv(v, cfg.q_per_kv)
    Skv = k.shape[1]
    if S * Skv > 4 * 1024 * 1024:
        out = _flash_attn(q, k, v, positions, kv_pos, causal,
                          cfg.sliding_window, cfg.attn_chunk_q,
                          cfg.attn_chunk_kv)
    else:
        out = _full_attn(q, k, v, positions, kv_pos, causal,
                         cfg.sliding_window)
    return out.reshape(B, S, H * dh)


def attn_apply(
    cfg,
    p: dict,
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (S,)
    causal: bool = True,
    kv_source: Optional[torch.Tensor] = None,   # cross-attention memory
    use_rope: bool = True,
) -> torch.Tensor:
    """Training / prefill self- or cross-attention (no cache)."""
    dt = x.dtype
    src = x if kv_source is None else kv_source
    out = _attend(cfg, x @ p["wq"].to(dt), src @ p["wk"].to(dt),
                  src @ p["wv"].to(dt), positions, causal,
                  kv_source is not None, use_rope)
    return out @ p["wo"].to(dt)


# the splits ``attn_apply_tp`` took, one count a call: "whole layer",
# "whole heads", "one KV head" or "through a head"; and "flash-decoding",
# one count an ``attn_decode_tp`` call (read and cleared by callers that
# must know which ran)
tp_splits: collections.Counter = collections.Counter()


def attn_apply_tp(cfg, ps, xs, positions, causal: bool = True,
                  kv_source=None, use_rope: bool = True):
    """``attn_apply`` over the row of ``distributed.mesh.tp_row()``: one
    parameter tree, input, position vector (and cross-attention memory)
    per position, one output per position.

    ``wq`` / ``wk`` / ``wv`` are column-parallel and ``wo`` row-parallel,
    so each position's ``wo`` rows give a partial sum of the output, added
    by ``all_reduce``. Where ``wq``'s columns split into whole query heads,
    each position attends with its own: with its own KV heads where those
    split whole too, else with the one KV head its query heads read,
    taken from ``wk`` / ``wv``'s columns gathered whole
    (``all_gather_row``). Where a split cuts through a query head, or the
    query heads of a position read more than one KV head that is not its
    own, every projection is gathered whole at every position, as a GSPMD
    reshard would, the attention computed there whole, and only ``wo``'s
    row split divides the work. Leaves left whole (a width that did not
    divide) give every position the whole layer. Each call counts its
    split in ``tp_splits``."""
    row = _mesh.tp_row()
    M = len(row)
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    srcs = xs if kv_source is None else kv_source
    cross = kv_source is not None
    width = {"wq": H * dh, "wk": Hkv * dh, "wv": Hkv * dh}

    def project(name, inputs):
        """The projection's columns, gathered whole where split."""
        cols = _mesh.each(lambda p, x: x @ p[name].to(x.dtype), ps, inputs)
        if cols[0].shape[-1] == width[name]:
            return cols
        return collectives.all_gather_row(cols, -1, row)

    def each_attn(c):
        return _mesh.each(lambda p, x, s, pos: attn_apply(
            c, p, x, pos, causal, s if cross else None, use_rope),
            ps, xs, srcs, positions)

    if ps[0]["wq"].shape[-1] == width["wq"]:
        tp_splits["whole layer"] += 1
        return each_attn(cfg)
    hq = H // M
    if H % M == 0 and Hkv % M == 0:
        tp_splits["whole heads"] += 1
        outs = each_attn(cfg.replace(n_heads=hq, n_kv_heads=Hkv // M,
                                     d_head=dh))
    elif H % M == 0 and cfg.q_per_kv % hq == 0:
        tp_splits["one KV head"] += 1
        local = cfg.replace(n_heads=hq, n_kv_heads=1, d_head=dh)
        k, v = project("wk", srcs), project("wv", srcs)

        def one_kv_head(j, p, x, k, v, pos):
            g = j * hq // cfg.q_per_kv           # the KV head it reads
            o = _attend(local, x @ p["wq"].to(x.dtype),
                        k.narrow(-1, g * dh, dh), v.narrow(-1, g * dh, dh),
                        pos, causal, cross, use_rope)
            return o @ p["wo"].to(o.dtype)

        outs = _mesh.each(one_kv_head, range(M), ps, xs, k, v, positions)
    else:
        tp_splits["through a head"] += 1
        q, k, v = project("wq", xs), project("wk", srcs), project("wv", srcs)
        n = ps[0]["wo"].shape[0]

        def rows_of_wo(j, p, q, k, v, pos):
            o = _attend(cfg, q, k, v, pos, causal, cross, use_rope)
            return o.narrow(-1, j * n, n) @ p["wo"].to(o.dtype)

        outs = _mesh.each(rows_of_wo, range(M), ps, q, k, v, positions)
    return collectives.all_reduce(outs, row)


def piece_lines(j: int, P: int, S: int) -> Tuple[int, int]:
    """The first of the ``S`` prompt lines that cache piece ``j`` of ``P``
    lines holds, and how many it holds (``narrow``'s arguments)."""
    return min(j * P, S), max(0, min(P, S - j * P))


def attn_fill_tp(cfg, ps, xs, caches):
    """The prompt's K (roped) and V into the cache pieces of a row (the
    one-device prefill's ``_fill_attn``), each piece its lines. Each
    position of the row projects its columns of ``wk`` / ``wv`` (whole KV
    heads or not) over every line, and one ``collectives.exchange`` trades
    columns for lines, so that each piece's position ends with every KV
    head of its lines; a leaf left whole gives each position of the row
    the whole projection, and a piece's lines come from one of them.
    ``caches``: one piece per position of ``mesh.cache_row()`` (the row,
    or more positions)."""
    row = _mesh.tp_row()
    lines = _mesh.cache_row()
    M, N = len(row), len(lines)
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    B, S = xs[0].shape[:2]
    P = caches[0].k.shape[1]
    for name in ("k", "v"):
        cols = _mesh.each(lambda p, x: x @ p["w" + name].to(x.dtype), ps,
                          xs)
        whole = cols[0].shape[-1] == Hkv * dh
        send = _mesh.each(lambda i, c: [
            c.narrow(1, *piece_lines(h, P, S)) if not whole or i == h % M
            else None for h in range(N)], range(M), cols)
        got = collectives.exchange(send, lines)

        def fill(j, c, parts):
            first, n = piece_lines(j, P, S)
            t = torch.cat(parts, -1).reshape(B, n, Hkv, dh)
            if name == "k" and cfg.use_rope:
                t = layers.apply_rope(t, torch.arange(
                    first, first + n, device=t.device)[None], cfg.rope_theta)
            getattr(c, name)[:, :n] = t.to(getattr(c, name).dtype)

        _mesh.each(fill, range(N), caches, got, over=lines)
    return [c._replace(index=S) for c in caches]


def init_cache(cfg, batch: int, max_seq: int, dtype,
               device=None) -> KVCache:
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    z = dict(dtype=dtype, device=device)
    return KVCache(k=torch.zeros((batch, max_seq, Hkv, dh), **z),
                   v=torch.zeros((batch, max_seq, Hkv, dh), **z), index=0)


def write_rows(buf: torch.Tensor, positions: torch.Tensor,
               new: torch.Tensor, first: int = 0) -> None:
    """Write ``new[b]`` into ``buf[b, positions[b]]`` in place, for every row
    ``b``. A position at or past ``buf.shape[1]`` is dropped, as the
    reference's ``.at[rows, positions].set(..., mode="drop")`` drops it:
    ``index_put_`` has no drop mode (an index out of range raises on the CPU
    and asserts on the card), so such a row writes back what it holds.

    ``first``: the sequence position of ``buf``'s line 0 (``buf`` one
    piece of a cache split by sequence); a row whose position lies outside
    the piece writes nothing to it."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    local = positions - first
    keep = ((local >= 0) & (local < buf.shape[1])).view(
        (-1,) + (1,) * (new.ndim - 1))
    at = local.clamp(0, buf.shape[1] - 1)
    buf[rows, at] = torch.where(keep, new.to(buf.dtype), buf[rows, at])


def write_line(buf: torch.Tensor, idx: int, positions, new: torch.Tensor,
               first: int = 0) -> None:
    """The new line ``new`` (B, ...) into a cache piece ``buf`` whose line 0
    is sequence position ``first``: at the shared cursor ``idx`` where the
    piece holds it (``positions=None``), else per row (``write_rows``)."""
    if positions is not None:
        write_rows(buf, positions, new, first)
    elif first <= idx < first + buf.shape[1]:
        buf[:, idx - first] = new.to(buf.dtype)


def decode_mask(kv_len: int, idx, positions: Optional[torch.Tensor],
                window: int, device, first: int = 0) -> torch.Tensor:
    """Which cache lines a decode step may see, shaped to broadcast over
    (B, H, 1, S_max) scores: lines ``<= idx`` (every row at the shared
    cursor ``idx``) or ``<= positions[b]`` (row ``b`` at its own), and
    within the sliding window when there is one. ``first``: the sequence
    position of the first line (a piece of a cache split by sequence)."""
    kv_pos = torch.arange(first, first + kv_len, device=device)
    cur = (torch.full((1,), idx, device=device) if positions is None
           else positions)[:, None]                              # (B|1, 1)
    valid = kv_pos[None, :] <= cur
    if window > 0:
        valid &= cur - kv_pos[None, :] < window
    return valid[:, None, None, :]


def attn_decode(
    cfg,
    p: dict,
    x: torch.Tensor,                    # (B, 1, D)
    cache: KVCache,
    use_rope: bool = True,
    positions: Optional[torch.Tensor] = None,   # (B,) per-row cursors
) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode against a dense KV cache; the new K/V line is
    written into the cache in place.

    With ``positions=None`` every row writes and reads at the shared cursor
    ``cache.index`` (bucketed serving: all rows in lockstep). With
    ``positions`` of shape (B,) each row keeps its own sequence position
    (slot-swap continuous batching, where rows at different depths share
    one cache pool) and ``cache.index`` is not read; a row at or past the
    cache's end writes nothing (``write_rows``).
    """
    dt = x.dtype
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    idx = cache.index
    q = _split_heads(x @ p["wq"].to(dt), H, dh)
    k_new = _split_heads(x @ p["wk"].to(dt), Hkv, dh)
    v_new = _split_heads(x @ p["wv"].to(dt), Hkv, dh)
    if use_rope:
        pos = (torch.full((1, 1), idx, device=x.device) if positions is None
               else positions[:, None])
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k_new = layers.apply_rope(k_new, pos, cfg.rope_theta)
    if positions is None:
        cache.k[:, idx] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, idx] = v_new[:, 0].to(cache.v.dtype)
    else:
        write_rows(cache.k, positions, k_new[:, 0])
        write_rows(cache.v, positions, v_new[:, 0])
    k = _repeat_kv(cache.k.to(dt), cfg.q_per_kv)
    v = _repeat_kv(cache.v.to(dt), cfg.q_per_kv)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.to(_F32)
    s = torch.where(decode_mask(cache.k.shape[1], idx, positions,
                                cfg.sliding_window, x.device), s, NEG)
    probs = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(B, 1, H * dh) @ p["wo"].to(dt)
    return out, cache._replace(index=idx + 1)


# ------------------------------------------- decode over a sequence-split row
def flash_combine(scores, values, spec: str, dt, row, lines=None) -> list:
    """The flash-decoding softmax over the row: ``scores`` one piece's
    masked fp32 scores (..., 1, lines) per position (the heads before),
    ``values`` its values, ``spec`` the einsum of probabilities and
    values; one of each per position of ``lines`` (the positions that
    hold the pieces, ``row`` first; default the row). ``pmax_row`` of
    the pieces' maxima gives the global max ``m``; each piece's ``exp(s
    - m)`` and its sum, added over the pieces by ``all_reduce``, give the
    global sum ``l``; each piece contracts its
    probabilities ``exp(s - m) / l``, cast to the compute dtype ``dt``
    where the one-device softmax casts them, with its values, and
    ``all_reduce`` (in fp32) adds the partial contexts. This is the
    combine ``sum_j o_j exp(m_j - m) / sum_j l_j exp(m_j - m)`` with each
    piece's terms taken at ``m`` before they are summed, so every
    probability is the one-device softmax's up to the order of one sum. A
    piece whose every line is masked (``-1e30``) adds exactly 0 while
    another piece holds a line the row may see; with none (a row past the
    cache's end under a window) every line weighs the same, as in the
    one-device softmax. Returns the context at every position of the
    row, in ``dt``, shaped as ``spec`` gives it."""
    lines = lines or row
    big = collectives.pmax_row(_mesh.each(
        lambda s: s.amax(-1, keepdim=True), scores, over=lines), lines)
    e = _mesh.each(lambda s, m: torch.exp(s - m), scores, big, over=lines)
    total = collectives.all_reduce(
        _mesh.each(lambda t: t.sum(-1, keepdim=True), e, over=lines), lines)
    parts = _mesh.each(
        lambda t, l, v: torch.einsum(spec, (t / l).to(dt), v).to(_F32),
        e, total, values, over=lines)
    return _mesh.each(lambda t: t.to(dt), collectives.all_reduce(parts, row))


def row_split_wo(width: int, ps, outs, row) -> list:
    """The output projection of each position's whole-width attention
    output ``outs`` (B, 1, width): with ``wo`` row-split, each position
    multiplies its rows' slice and ``all_reduce`` adds them; with ``wo``
    whole, each position the whole product."""
    n = ps[0]["wo"].shape[0]
    if n == width:
        return _mesh.each(lambda p, o: o @ p["wo"].to(o.dtype), ps, outs)
    return collectives.all_reduce(_mesh.each(
        lambda j, p, o: o.narrow(-1, j * n, n) @ p["wo"].to(o.dtype),
        range(len(row)), ps, outs), row)


def attn_decode_tp(cfg, ps, xs, caches, use_rope: bool = True,
                   positions=None):
    """``attn_decode`` over the row of ``distributed.mesh.tp_row()`` with
    the cache's sequence split over the row (the reference's
    flash-decoding layout, ``decode_state_specs``): one parameter tree,
    input (B, 1, D) and ``KVCache`` piece (B, S_max/M, Hkv, dh) per
    position, position ``j``'s piece holding lines ``[j S_max/M, (j + 1)
    S_max/M)``; ``positions`` ``None`` (every row at ``cache.index``) or
    one (B,) cursor tensor per position.

    The query heads and the new K/V line come from the column-split
    ``wq`` / ``wk`` / ``wv``, their columns gathered whole over the row
    (``all_gather_row``: ``q`` replicated over "model", as the reference's
    hint has it; ``B H dh`` values a step). The new line, roped at the
    cursor, is written only where a piece holds the cursor (each row's own
    with per-row cursors; a row at or past the cache's end writes
    nothing). Each position scores every head against its own lines,
    ``flash_combine`` makes the softmax over the row's pieces, and the
    row-split ``wo`` gives partial outputs that ``all_reduce`` adds. No
    cache line leaves its position. Returns one output per position and
    the pieces (written in place) with the cursor advanced.

    Where the pieces lie on more positions than the row
    (``mesh.cache_row()``: a batch that is not split, its cache's sequence
    split over the batch axes and "model"), ``caches`` and ``positions``
    have one entry per such position; the row's first position sends the
    others the queries and the new line (``broadcast_row``), and they
    score their lines and join the combine."""
    row = _mesh.tp_row()
    lines = _mesh.cache_row()
    M, N = len(row), len(lines)
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    idx = caches[0].index
    P = caches[0].k.shape[1]
    if positions is None and not 0 <= idx < P * N:
        raise IndexError(f"decode cursor {idx} outside a cache of {P * N} "
                         "lines")
    positions = positions or [None] * N
    width = {"wq": H * dh, "wk": Hkv * dh, "wv": Hkv * dh}
    tp_splits["flash-decoding"] += 1

    def project(name):
        cols = _mesh.each(lambda p, x: x @ p[name].to(x.dtype), ps, xs)
        if cols[0].shape[-1] != width[name]:
            cols = collectives.all_gather_row(cols, -1, row)
        return cols + (collectives.broadcast_row(cols[0], lines[M:])
                       if N > M else [])

    def partial(j, dt, q, k_new, v_new, cache, pos):
        q = _split_heads(q, H, dh)
        k_new = _split_heads(k_new, Hkv, dh)
        v_new = _split_heads(v_new, Hkv, dh)
        if use_rope:
            at = (torch.full((1, 1), idx, device=q.device) if pos is None
                  else pos[:, None])
            q = layers.apply_rope(q, at, cfg.rope_theta)
            k_new = layers.apply_rope(k_new, at, cfg.rope_theta)
        write_line(cache.k, idx, pos, k_new[:, 0], j * P)
        write_line(cache.v, idx, pos, v_new[:, 0], j * P)
        # query heads grouped by the KV head they read, so the piece is
        # not repeated to H heads: scores (B, Hkv, H / Hkv, 1, lines)
        q = q.reshape(q.shape[0], 1, Hkv, cfg.q_per_kv, dh)
        s = torch.einsum("bqgrd,bkgd->bgrqk", q, cache.k.to(dt)) * (
            1.0 / math.sqrt(dh))
        mask = decode_mask(P, idx, pos, cfg.sliding_window, q.device, j * P)
        return torch.where(mask[:, None], s.to(_F32), NEG)

    dt = xs[0].dtype
    scores = _mesh.each(partial, range(N), [dt] * N, project("wq"),
                        project("wk"), project("wv"), caches, positions,
                        over=lines)
    values = _mesh.each(lambda c: c.v.to(dt), caches, over=lines)
    ctx = flash_combine(scores, values, "bgrqk,bkgd->bqgrd", dt, row, lines)
    outs = _mesh.each(lambda o: o.reshape(o.shape[0], 1, H * dh), ctx)
    return (row_split_wo(H * dh, ps, outs, row),
            [c._replace(index=idx + 1) for c in caches])
