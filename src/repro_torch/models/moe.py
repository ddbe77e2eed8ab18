"""Mixture-of-Experts: top-k routing with fixed expert capacity.

Sort-free deterministic dispatch: tokens pick top-k experts; each (token,
slot) gets a position within its expert via a cumulative one-hot count;
tokens beyond expert capacity are dropped (their combine weight is zeroed) —
GShard semantics. Shared experts (DeepSeek) run densely over all tokens.

The load-balance auxiliary loss (Switch-style) is returned beside the
output. This is the reference's ``moe_impl="gspmd"`` path; its expert-
parallel all-to-all (``moe_apply_a2a``) needs a mesh and is not here, so a
config with ``moe_impl="a2a"`` runs ``moe_apply``, as the reference does
when no mesh is set.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import layers

_F32 = torch.float32


def moe_init(gen: torch.Generator, cfg) -> dict:
    D = cfg.d_model
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    p = {
        "router": layers.dense_init(gen, (D, E), scale=0.5),
        "wg": layers.dense_init(gen, (E, D, Fe)),
        "wu": layers.dense_init(gen, (E, D, Fe)),
        "wo": layers.dense_init(gen, (E, Fe, D), scale=out_scale),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["shared"] = {
            "wg": layers.dense_init(gen, (D, Fs)),
            "wu": layers.dense_init(gen, (D, Fs)),
            "wo": layers.dense_init(gen, (Fs, D), scale=out_scale),
        }
    return p


def moe_apply(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    logits = xt.to(_F32) @ p["router"].to(_F32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)       # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)             # renormalize

    # Switch-style load-balance loss
    me = probs.mean(0)                                         # (E,)
    ce = F.one_hot(expert_idx[:, 0], E).to(_F32).mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # ---- capacity dispatch ------------------------------------------------
    C = int(math.ceil(T * K * cfg.capacity_factor / E))
    C = max(8, -(-C // 8) * 8)
    flat_e = expert_idx.reshape(-1)                            # (T*K,)
    # position of each (token, slot) within its expert: running count
    eo = F.one_hot(flat_e, E)                                  # (T*K, E)
    pos_in_e = torch.cumsum(eo, dim=0) - eo                    # exclusive
    pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = pos < C
    gate_keep = torch.where(keep.reshape(T, K), gate_vals.to(_F32), 0.0)

    # scatter tokens into (E, C, D) buffers
    safe_pos = torch.where(keep, pos, C - 1)
    src = torch.repeat_interleave(xt, K, dim=0)                # (T*K, D)
    src = torch.where(keep[:, None], src, 0)
    buf = torch.zeros((E, C, D), dtype=dt, device=x.device)
    buf.index_put_((flat_e, safe_pos), src, accumulate=True)  # dup-safe: add

    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", buf, p["wu"].to(dt))
    yb = torch.einsum("ecf,efd->ecd", g * u, p["wo"].to(dt))   # (E, C, D)

    y_tok = yb[flat_e, safe_pos].reshape(T, K, D)
    y = torch.einsum("tkd,tk->td", y_tok.to(_F32), gate_keep).to(dt)

    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(cfg, p["shared"], xt)
    return y.reshape(B, S, D), aux


def expert_load_counts(cfg, p, x) -> torch.Tensor:
    """Per-expert top-1 token counts (for the LPT placement analysis)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).to(_F32) @ p["router"].to(_F32)
    top1 = torch.argmax(logits, -1)
    return torch.bincount(top1, minlength=cfg.n_experts)
