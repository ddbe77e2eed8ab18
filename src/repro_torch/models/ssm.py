"""Mamba-2 (SSD) token mixer — chunked scan formulation.

State-space recurrence per head (scalar decay a_t = exp(dt_t * A)):

    h_t = a_t * h_{t-1} + dt_t * B_t ⊗ x_t          h: (P, N)
    y_t = C_t · h_t + D * x_t

Computed chunk-parallel (the SSD algorithm): within a chunk the (Q, Q)
decay-weighted C·B "attention" handles intra-chunk terms; a loop over
chunks (the reference's ``lax.scan``) carries the (H, P, N) fp32 state.

Decode is the exact single-step recurrence on a (conv window, ssm state)
cache — constant memory in context length.

``ssm_apply_tp`` / ``ssm_decode_tp`` are the same on a tensor-parallel row
(``distributed.mesh.tensor_parallel``), the leaves split as the
reference's layout splits them: ``in_proj`` by column (a cut that falls
anywhere in its packed ``[z | x | B | C | dt]``), ``out_proj`` by row, the
heads' ``A_log`` / ``D`` / ``dt_bias`` and the norm by head.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives
from ..distributed import mesh as _mesh
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
    """The packed ``in_proj`` output as (z, the conv's channels x | B | C,
    dt)."""
    di, H, P, N, G, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)


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


def _groups_of(cfg, first: int, h: int, device):
    """The B / C group each of heads ``[first, first + h)`` reads."""
    H, G = cfg.n_ssm_heads, cfg.ssm_groups
    return torch.arange(first, first + h, device=device) // (H // G)


def _ssd(cfg, hp, xbc, dt, first: int = 0):
    """The chunked SSD scan of ``h`` heads from head ``first``, with the
    ``D`` skip: ``xbc`` (B, S, h P + 2 G N) the convolved x channels of
    those heads and every B / C channel, ``dt`` their raw steps (B, S, h),
    ``hp`` their ``A_log``, ``D`` and ``dt_bias``. Returns y (B, S, h P)
    and the final state (B, h, P, N) fp32."""
    dt_ = xbc.dtype
    B_, S, _ = xbc.shape
    di, H, P, N, G, _ = _dims(cfg)
    h = hp["A_log"].shape[0]
    Q = min(cfg.ssd_chunk, S)
    while S % Q:
        Q //= 2
    xin, Bm, Cm = torch.split(xbc, [h * P, G * N, G * N], dim=-1)
    dt = F.softplus(dt.to(_F32) + hp["dt_bias"][None, None])  # (B,S,h)
    A = -torch.exp(hp["A_log"])                                 # (h,)
    da = dt * A[None, None]                                     # (B,S,h) < 0
    xh = xin.reshape(B_, S, h, P)
    grp = _groups_of(cfg, first, h, xbc.device)
    Bh = Bm.reshape(B_, S, G, N).index_select(2, grp)
    Ch = Cm.reshape(B_, S, G, N).index_select(2, grp)

    nc = S // Q
    cum = torch.cumsum(da.reshape(B_, nc, Q, h), dim=2)         # inclusive
    xc = xh.reshape(B_, nc, Q, h, P)
    Bc = Bh.reshape(B_, nc, Q, h, N)
    Cc = Ch.reshape(B_, nc, Q, h, N)
    dtc = dt.reshape(B_, nc, Q, h)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xbc.device))

    state = torch.zeros((B_, h, P, N), dtype=_F32, device=xbc.device)
    ys = []
    for c in range(nc):
        cumq, xq, bq, cq, dtq = cum[:, c], xc[:, c], Bc[:, c], Cc[:, c], \
            dtc[:, c]
        last = cumq[:, -1]                                       # (B,h)
        # intra: att[t,i] = (C_t·B_i) exp(cum_t - cum_i) dt_i,  i<=t
        cb = torch.einsum("bthn,bihn->bhti", cq, bq)             # (B,h,Q,Q)
        ct = cumq.transpose(1, 2)
        dec = torch.exp(ct[:, :, :, None] - ct[:, :, None, :])   # (B,h,Q,Q)
        att = cb * dec * dtq.transpose(1, 2)[:, :, None, :]
        att = torch.where(causal[None, None], att, 0.0)
        y_intra = torch.einsum("bhti,bihp->bthp", att.to(dt_), xq)
        # inter: y += exp(cum_t) C_t · state
        scale_t = torch.exp(cumq).to(dt_)                        # (B,Q,h)
        y_inter = torch.einsum("bthn,bhpn->bthp", cq * scale_t[..., None],
                               state.to(dt_))
        # update: state' = exp(last) state
        #                 + sum_i exp(last - cum_i) dt_i B_i x_i
        coef = torch.exp(last[:, None] - cumq) * dtq             # (B,Q,h)
        # B_i dt_i is fp32 (coef is); x follows it, as the reference's
        # einsum promotes a bf16 operand
        bcoef = bq * coef[..., None]
        dh = torch.einsum("bihn,bihp->bhpn", bcoef, xq.to(bcoef.dtype))
        state = torch.exp(last)[:, :, None, None] * state + dh.to(_F32)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, S, h, P)
    y = y + hp["D"].to(dt_)[None, None, :, None] * xh
    return y.reshape(B_, S, h * P), state


def _ssd_step(cfg, hp, xbc, dt, state, first: int = 0):
    """One step of ``_ssd``'s recurrence: ``xbc`` (B, 1, h P + 2 G N)
    convolved, ``dt`` (B, 1, h), ``state`` (B, h, P, N). Returns y (B, 1,
    h P) and the new state."""
    dt_ = xbc.dtype
    B_ = xbc.shape[0]
    di, H, P, N, G, _ = _dims(cfg)
    h = hp["A_log"].shape[0]
    xin, Bm, Cm = torch.split(xbc, [h * P, G * N, G * N], dim=-1)
    dt = F.softplus(dt.to(_F32) + hp["dt_bias"][None, None])
    A = -torch.exp(hp["A_log"])
    da = (dt * A[None, None])[:, 0]                           # (B,h)
    xh = xin.reshape(B_, h, P)
    grp = _groups_of(cfg, first, h, xbc.device)
    Bh = Bm.reshape(B_, G, N).index_select(1, grp)
    Ch = Cm.reshape(B_, G, N).index_select(1, grp)
    s = state * torch.exp(da)[:, :, None, None]
    s = s + torch.einsum("bhn,bhp,bh->bhpn", Bh.to(_F32), xh.to(_F32),
                         dt[:, 0])
    y = torch.einsum("bhn,bhpn->bhp", Ch.to(_F32), s)
    y = y.to(dt_) + hp["D"].to(dt_)[None, :, None] * xh
    return y.reshape(B_, 1, h * P), s


def ssm_apply(cfg, p, x, return_cache: bool = False):
    """Training / prefill forward. x: (B, S, D) -> (B, S, D).

    With ``return_cache`` also returns the SSMCache at end of sequence
    (prefill for decode)."""
    dt_ = x.dtype
    z, xbc, dt = _split_in(cfg, x @ p["in_proj"].to(dt_))
    xbc, conv_window = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    y, h = _ssd(cfg, p, xbc, dt)
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if return_cache:
        return out, SSMCache(conv=conv_window, state=h, index=x.shape[1])
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
    z, xbc, dt = _split_in(cfg, x @ p["in_proj"].to(dt_))
    xbc, window = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                               window_init=cache.conv)
    y, h = _ssd_step(cfg, p, xbc, dt, cache.state)
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), SSMCache(
        conv=window, state=h, index=cache.index + 1)


# ------------------------------------------------------------ on a TP row
def _local_params(cfg, p, j: int, plan) -> dict:
    """Position ``j``'s view of the leaves by head and by channel: its
    heads' ``A_log``, ``D``, ``dt_bias`` and conv channels (with every B /
    C channel: ``conv_w`` / ``conv_b`` are whole), its channels' ``norm``
    and rows of ``out_proj``, from its pieces or the whole leaves."""
    di, H, P, _, _, _ = _dims(cfg)
    (c0, c1), (h0, h1), _ = plan[j]
    w, b = p["conv_w"], p["conv_b"]
    return {
        "A_log": layers.piece_of(p["A_log"], j, h0, h1, H),
        "D": layers.piece_of(p["D"], j, h0, h1, H),
        "dt_bias": layers.piece_of(p["dt_bias"], j, h0, h1, H),
        "conv_w": torch.cat([w[:, h0 * P:h1 * P], w[:, di:]], 1),
        "conv_b": torch.cat([b[h0 * P:h1 * P], b[di:]]),
        "norm": layers.piece_of(p["norm"], j, c0, c1, di),
        "out_proj": layers.piece_of(p["out_proj"], j, c0, c1, di),
    }


def _in_columns_tp(cfg, ps, xs, plan):
    """Each position's z (its channels), conv input (its heads' x and
    every B / C channel) and dt (its heads) of the packed ``in_proj``
    ``[z | x | B | C | dt]``: each position projects its columns, whose
    cut falls anywhere in that packing, and one ``layers.columns_tp``
    exchange gives each position the columns it needs (never the whole
    product)."""
    di, H, P, N, G, _ = _dims(cfg)
    bc = 2 * di + 2 * G * N
    cols = _mesh.each(lambda p, x: x @ p["in_proj"].to(x.dtype), ps, xs)
    want = [[(c0, c1), (di + h0 * P, di + h1 * P), (2 * di, bc),
             (bc + h0, bc + h1)] for (c0, c1), (h0, h1), _ in plan]
    got = layers.columns_tp(cols, bc + H, want)
    return _mesh.each(lambda g, pl: torch.split(g, [
        pl[0][1] - pl[0][0], (pl[1][1] - pl[1][0]) * P + 2 * G * N,
        pl[1][1] - pl[1][0]], dim=-1), got, plan)


def _gated_out_tp(cfg, lps, ys, zs):
    """``rms_norm(y * silu(z)) @ out_proj`` with ``d_inner`` split by
    channel over the row: each position's sum of squares, added by one
    ``all_reduce``, normalises its channels; its rows of ``out_proj`` give
    a partial output, added by another."""
    row = _mesh.tp_row()
    di = cfg.d_inner_ssm
    gs = _mesh.each(lambda y, z: y * F.silu(z), ys, zs)
    ss = collectives.all_reduce(_mesh.each(lambda g: torch.sum(
        torch.square(g.to(_F32)), dim=-1, keepdim=True), gs), row)

    def out(lp, g, s):
        y = (g.to(_F32) * torch.rsqrt(s / di + cfg.norm_eps)
             * (1.0 + lp["norm"].to(_F32))).to(g.dtype)
        return y @ lp["out_proj"].to(g.dtype)

    return collectives.all_reduce(_mesh.each(out, lps, gs, ss), row)


def _cache_home(cfg, plan, windows, states, index: int) -> list:
    """The row's ``SSMCache`` at its first position (``decode_state_specs``
    splits it by batch only, and the port keeps such a leaf there), from
    each position's conv window and state of its heads: each head's from
    the position that owns it, the B / C window from the first; the other
    positions' caches hold ``None``."""
    row = _mesh.tp_row()
    P = cfg.ssm_head_dim
    _, (h0, h1), _ = plan[0]
    xw = layers.heads_home(windows, plan, -1, P)
    with _mesh.at(row[0]):
        conv = torch.cat([xw, windows[0][..., (h1 - h0) * P:]], dim=-1)
    return [SSMCache(conv=conv, state=layers.heads_home(states, plan, 1),
                     index=index)] + [
        SSMCache(conv=None, state=None, index=index)] * (len(row) - 1)


def _ssm_tp(cfg, ps, xs, plan, windows=None, states=None):
    """The mixer over the row from each position's input: ``windows`` and
    ``states`` ``None`` (a whole sequence, chunked) or each position's
    heads' conv window and state (one decode step). Returns the outputs
    and each position's new windows and states."""
    M = len(ps)
    P = cfg.ssm_head_dim
    lps = _mesh.each(lambda j, p: _local_params(cfg, p, j, plan),
                     range(M), ps)
    cols = _in_columns_tp(cfg, ps, xs, plan)

    def local(pl, lp, c, w, s):
        (c0, c1), (h0, _), _ = pl
        xbc, window = _causal_conv(c[1], lp["conv_w"], lp["conv_b"],
                                   window_init=w)
        if s is None:
            y, state = _ssd(cfg, lp, xbc, c[2], h0)
        else:
            y, state = _ssd_step(cfg, lp, xbc, c[2], s, h0)
        return y.narrow(-1, c0 - h0 * P, c1 - c0), window, state

    res = _mesh.each(local, plan, lps, cols, windows or [None] * M,
                     states or [None] * M)
    outs = _gated_out_tp(cfg, lps, [r[0] for r in res],
                         [c[0] for c in cols])
    return outs, [r[1] for r in res], [r[2] for r in res]


def ssm_apply_tp(cfg, ps, xs, return_cache: bool = False):
    """``ssm_apply`` over the row of ``distributed.mesh.tp_row()``, as the
    reference's layout splits it: ``in_proj`` by column, ``out_proj`` by
    row, ``A_log``, ``D``, ``dt_bias`` and ``norm`` by head. Each position
    computes the heads that overlap its channels of ``d_inner`` (its rows
    of ``out_proj``; a head cut by that split is computed at both of its
    positions, ``layers.head_plan``): its ``in_proj`` columns, exchanged
    for its heads' z / x / dt and the whole B / C (``_in_columns_tp``),
    the conv on those channels, the chunked scan on its heads, then
    ``_gated_out_tp`` (one ``all_reduce`` of the norm's sums of squares,
    one of the partial outputs). Leaves left whole give each position the
    same channels from the whole leaf. With ``return_cache`` also returns
    one ``SSMCache`` per position: the row's at its first position
    (``_cache_home``)."""
    plan = layers.head_plan(len(ps), cfg.d_inner_ssm, cfg.ssm_head_dim)
    outs, windows, states = _ssm_tp(cfg, ps, xs, plan)
    if not return_cache:
        return outs
    return outs, _cache_home(cfg, plan, windows, states, xs[0].shape[1])


def ssm_decode_tp(cfg, ps, xs, caches):
    """``ssm_decode`` over the row (``ssm_apply_tp``'s split): ``caches``
    one per position, the row's ``SSMCache`` at its first position
    (``_cache_home``'s layout). The first position sends each position
    its heads' state and conv window (``collectives.exchange``), each
    position steps its heads, and the new windows and states go home.
    Returns one output per position and the caches in that layout."""
    row = _mesh.tp_row()
    di, P = cfg.d_inner_ssm, cfg.ssm_head_dim
    plan = layers.head_plan(len(row), di, P)
    home = caches[0]
    with _mesh.at(row[0]):
        windows = [torch.cat([home.conv[..., h0 * P:h1 * P],
                              home.conv[..., di:]], dim=-1)
                   for _, (h0, h1), _ in plan]
    windows = [w for w, in collectives.exchange([windows], row)]
    outs, windows, states = _ssm_tp(cfg, ps, xs, plan, windows,
                                    layers.heads_out(home.state, plan, 1))
    return outs, _cache_home(cfg, plan, windows, states, home.index + 1)
