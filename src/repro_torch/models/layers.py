"""Shared neural layers: norms, RoPE, MLPs, embeddings, init helpers.

Parameters are plain nested dicts of tensors (fp32 masters) in the reference
package's tree layout; compute casts to ``cfg.compute_dtype``. Every
initialiser draws from an explicit ``torch.Generator`` on the device the
parameters are made on.

The ``*_tp`` functions are the tensor-parallel forms, run under
``distributed.mesh.tensor_parallel``: they take one parameter tree per
position of the row (each holding that position's pieces) and one
activation per position, and give one per position.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives
from ..distributed import mesh as _mesh

_F32 = torch.float32


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / ... as a torch dtype."""
    return getattr(torch, name)


# ------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init (std ``scale / sqrt(fan_in)``, cut at
    two standard deviations), as the reference's."""
    std = scale / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=_F32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * std


def embed_init(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=_F32,
                       device=gen.device) * 0.02


def norm_init(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=_F32, device=device)


# ------------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(_F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(_F32))).to(dt)


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(_F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * (1.0 + weight.to(_F32))
    if bias is not None:
        out = out + bias.to(_F32)
    return out.to(dt)


def apply_norm(cfg, x, w):
    if cfg.norm == "layernorm":
        return layer_norm(x, w, eps=cfg.norm_eps)
    return rms_norm(x, w, eps=cfg.norm_eps)


# -------------------------------------------------------------------- RoPE
def rope_freqs(dims: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dims, 2, dtype=_F32, device=device) / dims
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, dh) with dh even; positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].to(_F32) * freqs          # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, d)."""
    pos = torch.arange(seq, dtype=_F32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=_F32, device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, cfg, d_ff: Optional[int] = None) -> dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp == "gelu":
        return {"wi": dense_init(gen, (D, Fd)),
                "wo": dense_init(gen, (Fd, D), scale=out_scale)}
    return {"wg": dense_init(gen, (D, Fd)),
            "wu": dense_init(gen, (D, Fd)),
            "wo": dense_init(gen, (Fd, D), scale=out_scale)}


def mlp_apply(cfg, p, x):
    dt = x.dtype
    if "wi" in p:  # gelu (the reference's jax.nn.gelu: the tanh form)
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
        return h @ p["wo"].to(dt)
    g = F.silu(x @ p["wg"].to(dt))
    u = x @ p["wu"].to(dt)
    return (g * u) @ p["wo"].to(dt)


def mlp_apply_tp(cfg, ps, xs):
    """``mlp_apply`` over the row: ``wg`` / ``wu`` / ``wi`` column-parallel
    and ``wo`` row-parallel, so that each position's ``mlp_apply`` on its
    pieces is a partial sum of the output, summed by ``all_reduce``. A
    hidden width that did not divide leaves every leaf whole: each
    position then computes the whole MLP."""
    outs = _mesh.each(lambda p, x: mlp_apply(cfg, p, x), ps, xs)
    if ps[0]["wo"].shape[0] == cfg.d_ff:
        return outs
    return collectives.all_reduce(outs, _mesh.tp_row())


# ---------------------------------------------- pieces of a leaf on a row
def span(j: int, M: int, n: int) -> Tuple[int, int]:
    """Position ``j``'s share ``[j n / M, (j + 1) n / M)`` (floored) of
    ``n`` channels on a row of ``M``: its piece of a leaf split over the
    row, and the channels it computes where the leaf is whole."""
    return j * n // M, (j + 1) * n // M


def head_plan(M: int, n: int, dh: int) -> list:
    """Per position of a row of ``M``, for ``n`` channels in heads of
    ``dh``: its channels ``(c0, c1)`` (``span``), the heads that overlap
    them ``(h0, h1)`` (it computes those: a head cut by the split is
    computed at both of its positions) and the heads it owns ``(o0,
    o1)``, whose first channel is its own (it sends those home)."""
    out = []
    for j in range(M):
        c0, c1 = span(j, M, n)
        out.append(((c0, c1), (c0 // dh, -(-c1 // dh)),
                    (-(-c0 // dh), -(-c1 // dh))))
    return out


def heads_out(t, plan, dim: int, size: int = 1) -> list:
    """Each position's heads ``(h0, h1)`` of ``t`` (heads of ``size``
    entries along ``dim``), which lives at the row's first position, sent
    there (``collectives.exchange``)."""
    row = _mesh.tp_row()
    with _mesh.at(row[0]):
        sent = [t.narrow(dim, h0 * size, (h1 - h0) * size)
                for _, (h0, h1), _ in plan]
    return [s for s, in collectives.exchange([sent], row)]


def heads_home(parts, plan, dim: int, size: int = 1):
    """The inverse of ``heads_out``: each position's ``parts`` hold its
    heads ``(h0, h1)``; each head is taken from the position that owns it
    and joined at the row's first position (``all_gather``)."""
    own = _mesh.each(lambda pl, t: t.narrow(
        dim, (pl[2][0] - pl[1][0]) * size, (pl[2][1] - pl[2][0]) * size),
        plan, parts)
    return collectives.all_gather(collectives.shard_array(own), dim,
                                  _mesh.tp_row()[0])


def piece_of(v, j: int, lo: int, hi: int, n: int, dim: int = 0):
    """Entries ``[lo, hi)`` of an ``n``-entry dim ``dim`` of a leaf, at row
    position ``j``: ``v`` is the whole leaf (a width the row did not
    divide) or position ``j``'s piece, entries ``[j w, (j + 1) w)``."""
    w = v.shape[dim]
    first = 0 if w == n else j * w
    if not first <= lo <= hi <= first + w:
        raise NotImplementedError(
            f"entries [{lo}, {hi}) of {n} at position {j}, whose piece holds "
            f"[{first}, {first + w})")
    return v.narrow(dim, lo - first, hi - lo)


def columns_tp(cols, full: int, want):
    """The columns each position of the row needs of a column-parallel
    product ``full`` columns wide: ``cols`` each position's piece (...,
    full / M) (or the whole product, where the leaf was left whole),
    ``want`` per position a list of increasing, disjoint ``(first, stop)``
    ranges. Where the pieces are split, one ``collectives.exchange`` moves
    each range's columns from the positions that hold them (a position's
    own stay); returns, per position, the ranges' columns joined in
    order."""
    row = _mesh.tp_row()
    if cols[0].shape[-1] == full:
        return _mesh.each(lambda c, w: torch.cat(
            [c[..., a:b] for a, b in w], -1), cols, want)
    n = cols[0].shape[-1]

    def send(i, c):
        parts = []
        for w in want:
            got = [c[..., max(a, i * n) - i * n:min(b, (i + 1) * n) - i * n]
                   for a, b in w if max(a, i * n) < min(b, (i + 1) * n)]
            parts.append(torch.cat(got, -1) if got else None)
        return parts

    got = collectives.exchange(_mesh.each(send, range(len(row)), cols), row)
    return _mesh.each(lambda g: torch.cat(g, -1), got)


# --------------------------------------------------------------- embedding
def embedding_init(gen: torch.Generator, cfg) -> dict:
    return {"tok": embed_init(gen, (cfg.vocab, cfg.d_model))}


def unembed_init(gen: torch.Generator, cfg) -> Optional[torch.Tensor]:
    if cfg.tie_embeddings:
        return None
    return dense_init(gen, (cfg.d_model, cfg.vocab))


def logits_from_hidden(cfg, params, h):
    """h: (..., D) -> (..., V); fp32 logits for a stable softmax/CE."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(h.dtype).T
    else:
        w = params["head"].to(h.dtype)
    return (h @ w).to(_F32)


def logits_from_hidden_tp(cfg, ps, hs):
    """``logits_from_hidden`` at each position of the row: from its piece of
    ``head`` (embed x vocab/M) or of the tied ``embed.tok`` (vocab/M x
    embed), the logits of its range of the vocabulary; never gathered. A
    vocabulary that did not divide leaves the leaf, and the logits, whole
    at every position."""
    return _mesh.each(lambda p, h: logits_from_hidden(cfg, p, h), ps, hs)
