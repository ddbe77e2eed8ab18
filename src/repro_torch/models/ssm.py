"""Mamba-2 (SSD) token mixer — chunked scan formulation.

State-space recurrence per head (scalar decay a_t = exp(dt_t * A)):

    h_t = a_t * h_{t-1} + dt_t * B_t ⊗ x_t          h: (P, N)
    y_t = C_t · h_t + D * x_t

Computed chunk-parallel (the SSD algorithm): within a chunk the (Q, Q)
decay-weighted C·B "attention" handles intra-chunk terms; a loop over
chunks (the reference's ``lax.scan``) carries the (H, P, N) fp32 state.

Decode is the exact single-step recurrence on a (conv window, ssm state)
cache — constant memory in context length.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import layers

_F32 = torch.float32


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_dim) rolling window
    state: torch.Tensor   # (B, H, P, N) fp32
    index: int


def _dims(cfg):
    di = cfg.d_inner_ssm
    H = cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = cfg.ssm_groups
    conv_dim = di + 2 * G * N
    return di, H, P, N, G, conv_dim


def ssm_init(gen: torch.Generator, cfg) -> dict:
    D = cfg.d_model
    di, H, P, N, G, conv_dim = _dims(cfg)
    dev = gen.device
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    lin = dict(dtype=_F32, device=dev)
    return {
        "in_proj": layers.dense_init(gen, (D, 2 * di + 2 * G * N + H)),
        "conv_w": layers.dense_init(gen, (cfg.ssm_conv, conv_dim),
                                    in_axis=0),
        "conv_b": torch.zeros((conv_dim,), **lin),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **lin)),
        "D": torch.ones((H,), **lin),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H,
                                                        **lin))),
        "norm": layers.norm_init(di, dev),
        "out_proj": layers.dense_init(gen, (di, D), scale=out_scale),
    }


def _split_in(cfg, zxbcdt):
    di, H, P, N, G, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)


def _causal_conv(xbc, w, b, window_init=None):
    """Depthwise causal conv along seq. xbc: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    if window_init is None:
        pad = torch.zeros(xbc.shape[:1] + (W - 1,) + xbc.shape[2:],
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = window_init
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+W-1, C)
    out = full[:, 0:xbc.shape[1]] * w[0].to(xbc.dtype)
    for i in range(1, W):
        out = out + full[:, i:i + xbc.shape[1]] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype)), full[:, -(W - 1):]


def ssm_apply(cfg, p, x, return_cache: bool = False):
    """Training / prefill forward. x: (B, S, D) -> (B, S, D).

    With ``return_cache`` also returns the SSMCache at end of sequence
    (prefill for decode)."""
    dt_ = x.dtype
    B_, S, D = x.shape
    di, H, P, N, G, conv_dim = _dims(cfg)
    Q = min(cfg.ssd_chunk, S)
    while S % Q:
        Q //= 2

    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xin, Bm, Cm, dt = _split_in(cfg, zxbcdt)
    w, b = p["conv_w"], p["conv_b"]
    xin, win_x = _causal_conv(xin, w[:, :di], b[:di])
    Bm, win_b = _causal_conv(Bm, w[:, di:di + G * N], b[di:di + G * N])
    Cm, win_c = _causal_conv(Cm, w[:, di + G * N:], b[di + G * N:])
    conv_window = torch.cat([win_x, win_b, win_c], dim=-1)

    dt = F.softplus(dt.to(_F32) + p["dt_bias"][None, None])   # (B,S,H)
    A = -torch.exp(p["A_log"])                                  # (H,)
    da = dt * A[None, None]                                     # (B,S,H) < 0
    xh = xin.reshape(B_, S, H, P)
    Bh = torch.repeat_interleave(Bm.reshape(B_, S, G, N), H // G, dim=2)
    Ch = torch.repeat_interleave(Cm.reshape(B_, S, G, N), H // G, dim=2)

    nc = S // Q
    cum = torch.cumsum(da.reshape(B_, nc, Q, H), dim=2)         # inclusive
    xc = xh.reshape(B_, nc, Q, H, P)
    Bc = Bh.reshape(B_, nc, Q, H, N)
    Cc = Ch.reshape(B_, nc, Q, H, N)
    dtc = dt.reshape(B_, nc, Q, H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))

    h = torch.zeros((B_, H, P, N), dtype=_F32, device=x.device)
    ys = []
    for c in range(nc):
        cumq, xq, bq, cq, dtq = cum[:, c], xc[:, c], Bc[:, c], Cc[:, c], \
            dtc[:, c]
        last = cumq[:, -1]                                       # (B,H)
        # intra: att[t,i] = (C_t·B_i) exp(cum_t - cum_i) dt_i,  i<=t
        cb = torch.einsum("bthn,bihn->bhti", cq, bq)             # (B,H,Q,Q)
        ct = cumq.transpose(1, 2)
        dec = torch.exp(ct[:, :, :, None] - ct[:, :, None, :])   # (B,H,Q,Q)
        att = cb * dec * dtq.transpose(1, 2)[:, :, None, :]
        att = torch.where(causal[None, None], att, 0.0)
        y_intra = torch.einsum("bhti,bihp->bthp", att.to(dt_), xq)
        # inter: y += exp(cum_t) C_t · h
        scale_t = torch.exp(cumq).to(dt_)                        # (B,Q,H)
        y_inter = torch.einsum("bthn,bhpn->bthp", cq * scale_t[..., None],
                               h.to(dt_))
        # state update: h' = exp(last) h + sum_i exp(last - cum_i) dt_i B_i x_i
        coef = torch.exp(last[:, None] - cumq) * dtq             # (B,Q,H)
        # B_i dt_i is fp32 (coef is); x follows it, as the reference's
        # einsum promotes a bf16 operand
        bcoef = bq * coef[..., None]
        dh = torch.einsum("bihn,bihp->bhpn", bcoef, xq.to(bcoef.dtype))
        h = torch.exp(last)[:, :, None, None] * h + dh.to(_F32)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, S, H, P)
    y = y + p["D"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(B_, S, di)
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if return_cache:
        return out, SSMCache(conv=conv_window, state=h, index=S)
    return out


def init_cache(cfg, batch: int, dtype, device=None) -> SSMCache:
    di, H, P, N, G, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, H, P, N), dtype=_F32, device=device),
        index=0)


def ssm_decode(cfg, p, x, cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token decode. x: (B, 1, D)."""
    dt_ = x.dtype
    B_ = x.shape[0]
    di, H, P, N, G, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xin, Bm, Cm, dt = _split_in(cfg, zxbcdt)
    xbc_new = torch.cat([xin, Bm, Cm], -1)                    # (B,1,conv)
    xbc, window = _causal_conv(xbc_new, p["conv_w"], p["conv_b"],
                               window_init=cache.conv)
    xin, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.to(_F32) + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    da = (dt * A[None, None])[:, 0]                           # (B,H)
    xh = xin.reshape(B_, H, P)
    Bh = torch.repeat_interleave(Bm.reshape(B_, G, N), H // G, dim=1)
    Ch = torch.repeat_interleave(Cm.reshape(B_, G, N), H // G, dim=1)
    h = cache.state * torch.exp(da)[:, :, None, None]
    h = h + torch.einsum("bhn,bhp,bh->bhpn", Bh.to(_F32), xh.to(_F32),
                         dt[:, 0])
    y = torch.einsum("bhn,bhpn->bhp", Ch.to(_F32), h)
    y = y.to(dt_) + p["D"].to(dt_)[None, :, None] * xh
    y = y.reshape(B_, 1, di)
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), SSMCache(
        conv=window, state=h, index=cache.index + 1)
