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
from typing import Optional

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
