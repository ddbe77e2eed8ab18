"""Model configuration covering the ten language-model architectures.

One dataclass, family-specific fields; every arch in ``configs/`` instantiates
this. ``configs.reduced()`` yields the small smoke-test variant of the same
family. The field names, defaults and derived properties are the reference
package's, so a configuration means the same model in both packages. Fields
that steer the reference's XLA compilation (``remat``, ``scan_layers``,
``train_parallelism``) are kept for that reason and change nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None    # default d_model // n_heads

    # token mixer: "attn" everywhere except ssm/hybrid families
    mixer: str = "attn"             # attn | rwkv6 | mamba2
    # hybrid (zamba2): shared attention block applied every k mamba layers
    shared_attn_every: int = 0      # 0 = no shared attention

    # channel mixer
    mlp: str = "swiglu"             # swiglu | gelu | moe | rwkv6_cmix | none

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gspmd"         # "gspmd" | "a2a" (shard_map all-to-all)
    first_dense_layers: int = 0     # deepseek: layer 0 is dense

    # MLA (deepseek)
    mla: bool = False
    kv_lora: int = 0
    qk_rope_dims: int = 64
    qk_nope_dims: int = 128
    v_head_dim: int = 128

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500             # whisper: 30s audio -> 1500 frames

    # modality frontend stub
    frontend: str = "none"          # none | audio | vision
    n_vision_tokens: int = 576      # llava base-res image tokens

    # misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    use_rope: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 131_072
    sliding_window: int = 0         # 0 = full attention

    # execution
    train_parallelism: str = "tp"   # "tp" (TP over model axis) | "fsdp"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    rwkv_chunk: int = 32   # (B,T,T,H,dh) intra tensor must fit HBM
    ssd_chunk: int = 128

    # ------------------------------------------------------------- derived
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (ssm / linear-attn / hybrid)"""
        return self.mixer in ("rwkv6", "mamba2")

    @property
    def attn_sites(self) -> int:
        """Number of (shared) attention applications for hybrids."""
        if self.shared_attn_every <= 0:
            return 0
        return self.n_layers // self.shared_attn_every

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------- parameter accounting
    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND roofline and reports)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, Hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.mixer == "attn":
            per_layer += D * H * dh + 2 * D * Hkv * dh + H * dh * D
        elif self.mixer == "mamba2":
            di = self.d_inner_ssm
            conv_dim = di + 2 * self.ssm_groups * self.ssm_state
            per_layer += D * (2 * di + 2 * self.ssm_groups * self.ssm_state
                              + self.n_ssm_heads)
            per_layer += conv_dim * self.ssm_conv + di * D
        elif self.mixer == "rwkv6":
            per_layer += 4 * D * D + D * D  # r,k,v,g,o projections
            per_layer += 6 * D * 64         # token-shift / decay loras (approx)
        if self.mla:
            per_layer = D * (self.kv_lora + self.qk_rope_dims)
            per_layer += self.kv_lora * H * (self.qk_nope_dims
                                             + self.v_head_dim)
            per_layer += D * H * (self.qk_nope_dims + self.qk_rope_dims)
            per_layer += H * self.v_head_dim * D
        if self.mlp == "swiglu":
            per_layer += 3 * D * F
        elif self.mlp == "gelu":
            per_layer += 2 * D * F
        elif self.mlp == "moe":
            fe = self.d_ff_expert
            per_layer += self.n_experts * 3 * D * fe + D * self.n_experts
            per_layer += self.n_shared_experts * 3 * D * fe
        if self.shared_attn_every > 0:
            shared = D * H * dh * 2 + 2 * D * Hkv * dh  # q,o + k,v
        else:
            shared = 0
        enc = 0
        if self.enc_dec:
            enc = self.n_enc_layers * (4 * D * D + 2 * D * F)
            per_layer += 2 * D * D + D * D + D * D  # cross-attn q,k,v,o
        return emb + L * per_layer + shared + enc

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.mlp != "moe":
            return self.param_count()
        full = self.param_count()
        fe = self.d_ff_expert
        all_experts = self.n_layers * self.n_experts * 3 * self.d_model * fe
        active = self.n_layers * (
            (self.top_k + self.n_shared_experts) * 3 * self.d_model * fe
        )
        return full - all_experts + active
