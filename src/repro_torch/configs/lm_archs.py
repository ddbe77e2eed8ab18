"""The ten language-model architectures, at their published widths.

``reduced()`` gives a same-family smoke variant (small width, depth and
expert count, fp32) that runs on the CPU in the tests and on the card in
``chip_smoke.py``. The entries are the reference package's, field for field.
"""
from __future__ import annotations

from ..models.config import ModelConfig

_COMMON = dict(compute_dtype="bfloat16", param_dtype="float32", remat=True)


ARCHS = {}


def _register(cfg: ModelConfig):
    ARCHS[cfg.name] = cfg
    return cfg


# --- rwkv6-3b [ssm] 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
#     Finch — data-dependent decay [arXiv:2404.05892]
_register(ModelConfig(
    name="rwkv6-3b", family="ssm", train_parallelism="fsdp", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536,
    mixer="rwkv6", mlp="rwkv6_cmix", use_rope=False, **_COMMON,
))

# --- mistral-nemo-12b [dense] 40L d=5120 32H (GQA kv=8) ff=14336 v=131072
#     128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]
_register(ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab=131072,
    rope_theta=1e6, max_seq=131072, **_COMMON,
))

# --- smollm-360m [dense] 32L d=960 15H (GQA kv=5) ff=2560 v=49152
#     llama-arch small [hf:HuggingFaceTB/SmolLM-360M]
_register(ModelConfig(
    name="smollm-360m", family="dense", train_parallelism="fsdp", n_layers=32, d_model=960,
    n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49152,
    tie_embeddings=True, **_COMMON,
))

# --- stablelm-12b [dense] 40L d=5120 32H (GQA kv=8) ff=13824 v=100352
#     [hf:stabilityai/stablelm-2-12b]
_register(ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352,
    norm="layernorm", **_COMMON,
))

# --- starcoder2-3b [dense] 30L d=3072 24H (GQA kv=2) ff=12288 v=49152
#     GQA, RoPE, 4k sliding window [arXiv:2402.19173]
_register(ModelConfig(
    name="starcoder2-3b", family="dense", train_parallelism="fsdp", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152,
    sliding_window=4096, mlp="gelu", norm="layernorm", **_COMMON,
))

# --- zamba2-7b [hybrid] 81L d=3584 32H (GQA kv=32) ff=14336 v=32000
#     ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242]
#     Shared attention applied every 6 mamba blocks (weights shared).
_register(ModelConfig(
    name="zamba2-7b", family="hybrid", train_parallelism="fsdp", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    mixer="mamba2", ssm_state=64, ssm_head_dim=64, shared_attn_every=6,
    mlp="swiglu", **_COMMON,
))

# --- dbrx-132b [moe] 40L d=6144 48H (GQA kv=8) ff=10752 v=100352
#     16 experts top-4, fine-grained [hf:databricks/dbrx-base]
_register(ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=10752, vocab=100352,
    mlp="moe", n_experts=16, top_k=4, d_ff_expert=10752,
    moe_impl="a2a", **_COMMON,
))

# --- deepseek-v2-lite-16b [moe] 27L d=2048 16H ff=1408 v=102400
#     MLA kv_lora=512; 2 shared + 64 routed top-6 [arXiv:2405.04434]
#     (assignment note says "160 routed"; hf config and the paper's Table 1
#      give 64 routed experts for the Lite model — we follow the hf config)
_register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    mla=True, kv_lora=512, qk_rope_dims=64, qk_nope_dims=128,
    v_head_dim=128, d_head=192,
    mlp="moe", n_experts=64, top_k=6, n_shared_experts=2,
    d_ff_expert=1408, first_dense_layers=1, moe_impl="a2a", **_COMMON,
))

# --- whisper-large-v3 [audio] enc-dec 32L d=1280 20H ff=5120 v=51866
#     conv frontend is a STUB: input_specs provides frame embeddings
#     [arXiv:2212.04356]
_register(ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
    enc_dec=True, n_enc_layers=32, enc_seq=1500, frontend="audio",
    mlp="gelu", norm="layernorm", use_rope=False, **_COMMON,
))

# --- llava-next-mistral-7b [vlm] 32L d=4096 32H (GQA kv=8) ff=14336 v=32000
#     anyres tiling -> vision stub supplies patch embeddings
#     [hf:llava-hf/llava-v1.6-mistral-7b-hf]
_register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab=32000,
    frontend="vision", n_vision_tokens=576, sliding_window=4096, **_COMMON,
))


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family smoke-test variant: tiny dims, CPU-runnable."""
    kw = dict(
        n_layers=2, d_model=64, d_ff=128, vocab=512,
        compute_dtype="float32", remat=False,
        attn_chunk_q=16, attn_chunk_kv=16, rwkv_chunk=8, ssd_chunk=8,
        max_seq=256,
    )
    if cfg.mixer == "rwkv6":
        kw.update(n_heads=1, n_kv_heads=1)          # 64/64 = 1 head
    elif cfg.mixer == "mamba2":
        kw.update(n_heads=4, n_kv_heads=4, ssm_state=16, ssm_head_dim=16,
                  shared_attn_every=2 if cfg.shared_attn_every else 0,
                  d_head=None)
    else:
        q_per_kv = cfg.q_per_kv
        kw.update(n_heads=4, n_kv_heads=max(1, 4 // q_per_kv), d_head=16)
    if cfg.mlp == "moe":
        kw.update(n_experts=4, top_k=min(2, cfg.top_k), d_ff_expert=32,
                  n_shared_experts=min(1, cfg.n_shared_experts),
                  first_dense_layers=min(1, cfg.first_dense_layers))
    if cfg.mla:
        kw.update(kv_lora=32, qk_rope_dims=8, qk_nope_dims=16,
                  v_head_dim=16, d_head=24)
    if cfg.enc_dec:
        kw.update(n_enc_layers=2, enc_seq=24)
    if cfg.frontend == "vision":
        kw.update(n_vision_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(name=cfg.name + "-smoke", **kw)


def get_arch(name: str) -> ModelConfig:
    return ARCHS[name]
