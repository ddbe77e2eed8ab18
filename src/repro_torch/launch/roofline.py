"""Roofline arithmetic that needs no chip: the analytic FLOP and HBM-byte
counts of the implemented algorithm, the 6ND estimate, the depth-delta
extrapolation and the table formatter of the reference's
``launch/roofline.py``, and ``Roofline``, which turns counts into a time
bound on hardware described by its fields.

Three terms per step, in seconds:

    compute    = flops              / (chips x peak_flops)
    memory     = hbm_bytes          / (chips x hbm_bw)
    collective = coll_bytes_per_dev / link_bw

``Roofline`` has no default hardware: the caller gives the peak compute
rate, the memory bandwidth and the link bandwidth (``chip_smoke.py``
measures them on the card it runs on). The reference's parsing of
collective bytes out of post-SPMD HLO text has no counterpart here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Roofline:
    flops: float              # whole-program FLOPs (all chips)
    hbm_bytes: float          # whole-program HBM traffic (all chips)
    coll_bytes_per_dev: float
    chips: int
    peak_flops: float         # FLOP/s of one chip, for the step's dtype
    hbm_bw: float             # bytes/s of one chip's memory
    link_bw: float            # bytes/s of one link
    model_flops: float = 0.0  # analytic 6ND

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def collective_s(self) -> float:
        # per-device traffic / per-link bandwidth == total/(chips·links)
        return self.coll_bytes_per_dev / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap bound: the max term (perfect overlap of the rest)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU: useful flops / (chips · peak · step_time)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "chips": self.chips,
            "peak_flops": self.peak_flops,
            "hbm_bw": self.hbm_bw,
            "link_bw": self.link_bw,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def algo_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """FLOPs of the *implemented* algorithm (fwd; train = 3x): per-token
    terms of the mixer, the channel mixer, shared / cross attention and the
    logits, with the chunk sizes the models compute in."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    decode = shape_kind == "decode"
    tokens = batch * (1 if decode else seq)
    ctx = seq                                # cache length for decode

    per_tok = 0.0
    # ---- token mixer
    if cfg.mixer == "attn":
        if cfg.mla:
            r, dn, dr_, dv = (cfg.kv_lora, cfg.qk_nope_dims,
                              cfg.qk_rope_dims, cfg.v_head_dim)
            per_tok += 2 * D * H * (dn + dr_) + 2 * D * (r + dr_)
            if decode:
                per_tok += 2 * H * dn * r + 2 * H * r * dv
                per_tok += 2 * ctx * H * (r + dr_) + 2 * ctx * H * r
            else:
                per_tok += 2 * r * H * (dn + dv)
                per_tok += 0.5 * (2 * ctx * H * (dn + dr_)
                                  + 2 * ctx * H * dv) * 2
            per_tok += 2 * H * dv * D
        else:
            per_tok += 2 * D * H * dh + 4 * D * Hkv * dh + 2 * H * dh * D
            eff_ctx = ctx if not cfg.sliding_window else min(
                ctx, cfg.sliding_window)
            att = 4 * eff_ctx * H * dh            # scores + AV
            per_tok += att if decode else 0.5 * att
    elif cfg.mixer == "mamba2":
        di, N, P_ = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_head_dim
        Hs_ = cfg.n_ssm_heads
        G = cfg.ssm_groups
        per_tok += 2 * D * (2 * di + 2 * G * N + Hs_) + 2 * di * D
        Q = 1 if decode else cfg.ssd_chunk
        per_tok += Hs_ * (2 * Q * N + 2 * Q * P_ + 4 * N * P_)
    elif cfg.mixer == "rwkv6":
        dh6 = 64
        H6 = D // dh6
        per_tok += 5 * 2 * D * D + 2 * D * (32 * 8 + 64 * 2)
        T = 1 if decode else cfg.rwkv_chunk
        per_tok += H6 * (5 * T * dh6 + 4 * dh6 * dh6)
    # ---- shared attention (zamba2)
    if cfg.shared_attn_every > 0:
        frac = cfg.attn_sites / L
        att_proj = 2 * D * H * dh + 4 * D * Hkv * dh + 2 * H * dh * D
        att_ctx = 4 * ctx * H * dh
        per_tok += frac * (att_proj + (att_ctx if decode else 0.5 * att_ctx))
    # ---- channel mixer
    if cfg.mlp == "swiglu":
        per_tok += 6 * D * F
    elif cfg.mlp == "gelu":
        per_tok += 4 * D * F
    elif cfg.mlp == "moe":
        Fe = cfg.d_ff_expert
        per_tok += 2 * D * cfg.n_experts
        per_tok += 6 * D * Fe * cfg.top_k * cfg.capacity_factor
        per_tok += 6 * D * Fe * cfg.n_shared_experts
    elif cfg.mlp == "rwkv6_cmix":
        per_tok += 2 * D * F * 2 + 2 * D * D
    # ---- cross attention (whisper decoder)
    enc_flops = 0.0
    if cfg.enc_dec:
        per_tok += 6 * D * D + 2 * D * D            # q,o + probs paths
        per_tok += 4 * cfg.enc_seq * H * dh
        enc_per_tok = (8 * D * D + 4 * cfg.enc_seq * H * dh * 0.5
                       + 4 * D * F)
        if not decode:   # encoder runs on train/prefill only
            enc_flops = (batch * cfg.enc_seq * enc_per_tok
                         * cfg.n_enc_layers)
        # cross-KV projection of encoder states (prefill)
        if not decode:
            enc_flops += batch * cfg.enc_seq * 4 * D * D * L

    total = tokens * per_tok * L + enc_flops
    total += tokens * 2 * D * V                     # logits
    if shape_kind == "train":
        total *= 3.0                                # fwd + bwd
    return total


def algo_hbm_bytes(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """Analytic lower bound on HBM traffic per step (bytes, all chips)."""
    P_ = cfg.param_count()
    decode = shape_kind == "decode"
    tokens = batch * (1 if decode else seq)
    D, L = cfg.d_model, cfg.n_layers
    if shape_kind == "train":
        # params fp32 r/w + adam moments r/w + grads + bf16 cast reads
        par = P_ * (4 + 4 + 16 + 4 + 2)
        act = tokens * D * L * 12 * 2               # remat-era activations
        return par + act
    # inference: one pass over the (active) params (bf16 serving copy)
    # + cache traffic
    par = cfg.active_param_count() * 2
    if cfg.mixer == "attn":
        per_tok_cache = (2 * cfg.n_kv_heads * cfg.head_dim * 2
                         if not cfg.mla
                         else (cfg.kv_lora + cfg.qk_rope_dims) * 2)
        cache = batch * seq * per_tok_cache * L
    else:
        cache = 0  # state caches are negligible
        if cfg.shared_attn_every:
            cache = (batch * seq * 2 * cfg.n_kv_heads * cfg.head_dim * 2
                     * cfg.attn_sites)
    act = tokens * D * L * 8 * 2
    return par + cache + act


def model_flops_estimate(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """Analytic 'useful' FLOPs: 6·N_active·D for train, 2·N_active·D for
    inference (+ attention score terms for full-attn archs)."""
    n_active = cfg.active_param_count()
    tokens = batch * seq if shape_kind in ("train", "prefill") else batch
    mult = 6.0 if shape_kind == "train" else 2.0
    base = mult * n_active * tokens
    # quadratic attention term (full-attn archs): 2·2·S²·D_attn per example
    if cfg.mixer == "attn":
        h_dim = cfg.n_heads * cfg.head_dim
        if shape_kind in ("train", "prefill"):
            att = 2 * 2 * seq * seq * h_dim * cfg.n_layers * batch
            att *= 3 if shape_kind == "train" else 1      # fwd+bwd
        else:
            att = 2 * 2 * seq * h_dim * cfg.n_layers * batch
        base += att
    return base


def delta_extrapolate(f_d1: float, f_d2: float, d1: int, d2: int,
                      L: int) -> float:
    """total(L) = f(d1) + (L-d1)/(d2-d1) · (f(d2)-f(d1)).

    Clamped non-negative and to at least max(f_d1, f_d2): measurement noise
    can make f(d2) < f(d1), and a negative slope extrapolated by L layers
    would go below zero.
    """
    if d2 == d1:
        return f_d1
    est = f_d1 + (L - d1) / (d2 - d1) * (f_d2 - f_d1)
    return max(est, f_d1, f_d2, 0.0)


def format_table(rows: list, keys: list) -> str:
    widths = {k: max(len(k), *(len(str(r.get(k, ""))) for r in rows))
              for k in keys}
    line = " | ".join(k.ljust(widths[k]) for k in keys)
    sep = "-+-".join("-" * widths[k] for k in keys)
    body = "\n".join(
        " | ".join(str(r.get(k, "")).ljust(widths[k]) for k in keys)
        for r in rows
    )
    return f"{line}\n{sep}\n{body}"
