"""Transformer assembly: blocks, the loop over layers, enc-dec, hybrids.

Parameters keep the reference's tree: per-layer weights are stacked on a
leading L axis (``params["blocks"][name]`` is ``(L, ...)``), and the
reference's ``lax.scan`` over that axis is a Python loop here, each layer's
weights a view ``a[i]``. ``remat`` / ``scan_layers`` steer the reference's
compilation and change nothing in this package.

Families:
  dense / moe        [attn | mla] + [swiglu | gelu | moe]
  ssm                rwkv6 (tmix + cmix)  or  mamba2 + swiglu
  hybrid (zamba2)    mamba2 stack; one *shared* attention block applied every
                     k layers (weights shared, per-site KV caches)
  audio (whisper)    encoder (bidirectional attn over stub frame embeddings)
                     + decoder with cross-attention
  vlm (llava)        decoder over [vision stub embeds ; text embeds]
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import _device
from ..distributed import sharding as _sh
from . import attention, layers, mla, moe, rwkv, ssm

_F32 = torch.float32


# ============================================================ init
def _block_init(gen, cfg, cross: bool = False) -> dict:
    dev = gen.device
    p: Dict[str, Any] = {"norm1": layers.norm_init(cfg.d_model, dev),
                         "norm2": layers.norm_init(cfg.d_model, dev)}
    if cfg.mixer == "attn":
        if cfg.mla:
            p["mla"] = mla.mla_init(gen, cfg)
        else:
            p["attn"] = attention.attn_init(gen, cfg)
    elif cfg.mixer == "mamba2":
        p["ssm"] = ssm.ssm_init(gen, cfg)
    elif cfg.mixer == "rwkv6":
        p["tmix"] = rwkv.tmix_init(gen, cfg)
    if cross:
        p["xattn"] = attention.attn_init(gen, cfg)
        p["norm_x"] = layers.norm_init(cfg.d_model, dev)
    if cfg.mlp == "moe":
        p["moe"] = moe.moe_init(gen, cfg)
    elif cfg.mlp == "rwkv6_cmix":
        p["cmix"] = rwkv.cmix_init(gen, cfg)
    elif cfg.mlp != "none":
        p["mlp"] = layers.mlp_init(gen, cfg)
    return p


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of parameter trees (nested dicts of tensors)
    of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree):
    """The tensors of a parameter tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def _stack_init(n: int, fn: Callable[[], dict]) -> dict:
    return tree_map(lambda *xs: torch.stack(xs), *[fn() for _ in range(n)])


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device: _device.DeviceLike = None, seed: int = 0) -> dict:
    """Random weights of ``cfg`` in the reference's tree, fp32, drawn on
    ``device`` (``None`` means ``"cuda"``) from ``generator`` (a new one
    seeded with ``seed`` when not given). The same generator state gives
    the same weights."""
    dev = _device.resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    params: Dict[str, Any] = {"embed": layers.embedding_init(gen, cfg)}
    if cfg.enc_dec:
        params["enc_blocks"] = _stack_init(
            cfg.n_enc_layers, lambda: _block_init(gen, cfg))
        params["enc_norm"] = layers.norm_init(cfg.d_model, dev)
        params["blocks"] = _stack_init(
            cfg.n_layers, lambda: _block_init(gen, cfg, cross=True))
    else:
        params["blocks"] = _stack_init(cfg.n_layers,
                                       lambda: _block_init(gen, cfg))
    if cfg.mlp == "moe" and cfg.first_dense_layers > 0:
        # deepseek: the first layer(s) use a dense FFN, stored separately
        params["dense_mlp"] = _stack_init(
            cfg.first_dense_layers,
            lambda: layers.mlp_init(gen, cfg.replace(mlp="swiglu")))
    if cfg.shared_attn_every > 0:
        params["shared_attn"] = attention.attn_init(
            gen, cfg.replace(mixer="attn"))
        params["shared_norm"] = layers.norm_init(cfg.d_model, dev)
    params["final_norm"] = layers.norm_init(cfg.d_model, dev)
    head = layers.unembed_init(gen, cfg)
    if head is not None:
        params["head"] = head
    return params


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def shared_site(cfg, i: int) -> bool:
    """Does the shared attention block run after layer ``i``?"""
    return (cfg.shared_attn_every > 0
            and i % cfg.shared_attn_every == cfg.shared_attn_every - 1)


# ============================================================ forward
def _apply_mixer(cfg, p, x, positions):
    if cfg.mixer == "attn":
        if cfg.mla:
            return mla.mla_apply(cfg, p["mla"], x, positions)
        return attention.attn_apply(cfg, p["attn"], x, positions,
                                    use_rope=cfg.use_rope)
    if cfg.mixer == "mamba2":
        return ssm.ssm_apply(cfg, p["ssm"], x)
    if cfg.mixer == "rwkv6":
        return rwkv.tmix_apply(cfg, p["tmix"], x)
    raise ValueError(cfg.mixer)


def apply_channel(cfg, params, p, x, layer_idx: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The channel mixer of layer ``layer_idx``; returns (out, aux). A MoE
    config's first dense layers use ``params["dense_mlp"]``, and its routed
    layers ``moe_apply``; without first dense layers, a config with
    ``moe_impl="a2a"`` under an active ``sharding.hint_mesh`` runs
    ``moe_apply_a2a`` over that mesh (the reference's routing)."""
    zero = torch.zeros((), dtype=_F32, device=x.device)
    if cfg.mlp == "moe":
        if cfg.first_dense_layers > 0 and "dense_mlp" in params:
            if layer_idx < cfg.first_dense_layers:
                dp = layer(params["dense_mlp"], layer_idx)
                return layers.mlp_apply(cfg, dp, x), zero
            return moe.moe_apply(cfg, p["moe"], x)
        if cfg.moe_impl == "a2a":
            mesh = _sh.active_mesh()
            if mesh is not None:
                return moe.moe_apply_a2a(cfg, p["moe"], x, mesh)
        return moe.moe_apply(cfg, p["moe"], x)
    if cfg.mlp == "rwkv6_cmix":
        return rwkv.cmix_apply(cfg, p["cmix"], x), zero
    if cfg.mlp == "none":
        return torch.zeros_like(x), zero
    return layers.mlp_apply(cfg, p["mlp"], x), zero


def _block_apply(cfg, params, bp, x, positions, layer_idx, enc_out=None):
    """One block: mixer + (optional shared attn / cross attn) + channel."""
    x = x + _apply_mixer(cfg, bp, layers.apply_norm(cfg, x, bp["norm1"]),
                         positions)
    if shared_site(cfg, layer_idx):
        x = x + attention.attn_apply(
            cfg.replace(mixer="attn"), params["shared_attn"],
            layers.apply_norm(cfg, x, params["shared_norm"]), positions,
            use_rope=cfg.use_rope)
    if enc_out is not None:
        x = x + attention.attn_apply(
            cfg, bp["xattn"], layers.apply_norm(cfg, x, bp["norm_x"]),
            positions, causal=False, kv_source=enc_out, use_rope=False)
    h, aux = apply_channel(cfg, params, bp,
                           layers.apply_norm(cfg, x, bp["norm2"]), layer_idx)
    return x + h, aux


def _scan_blocks(cfg, params, blocks, x, positions, enc_out=None):
    """The loop over the stacked blocks. Returns (x, aux)."""
    L = next(leaves(blocks)).shape[0]
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for i in range(L):
        x, a = _block_apply(cfg, params, layer(blocks, i), x, positions, i,
                            enc_out=enc_out)
        aux = aux + a
    return x, aux


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, S_enc, D)."""
    dt = layers.dtype_of(cfg.compute_dtype)
    S = frames.shape[1]
    x = frames.to(dt) + layers.sinusoidal_positions(
        S, cfg.d_model, frames.device).to(dt)[None]
    positions = torch.arange(S, device=frames.device)
    enc_cfg = cfg.replace(mixer="attn", mla=False, mlp="gelu")
    blocks = params["enc_blocks"]
    for i in range(next(leaves(blocks)).shape[0]):
        bp = layer(blocks, i)
        x = x + attention.attn_apply(
            enc_cfg, bp["attn"], layers.apply_norm(cfg, x, bp["norm1"]),
            positions, causal=False, use_rope=False)
        h, _ = apply_channel(enc_cfg, params, bp,
                             layers.apply_norm(cfg, x, bp["norm2"]), i)
        x = x + h
    return layers.apply_norm(cfg, x, params["enc_norm"])


def embed(cfg, params, tokens, vision_embeds=None) -> torch.Tensor:
    """Token embeddings in the compute dtype, after the vision prefix."""
    dt = layers.dtype_of(cfg.compute_dtype)
    x = params["embed"]["tok"].to(dt)[tokens]
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(dt), x], dim=1)
    return x


def forward(
    cfg,
    params,
    tokens: torch.Tensor,                         # (B, S_text) int
    vision_embeds: Optional[torch.Tensor] = None,  # (B, S_img, D) vlm stub
    audio_frames: Optional[torch.Tensor] = None,   # (B, S_enc, D) audio stub
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward. Returns (logits fp32 (B, S_total, V), aux)."""
    dt = layers.dtype_of(cfg.compute_dtype)
    x = embed(cfg, params, tokens, vision_embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    enc_out = None
    if cfg.enc_dec:
        if audio_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "audio_frames")
        enc_out = encode(cfg, params, audio_frames)
        x = x + layers.sinusoidal_positions(
            S, cfg.d_model, x.device).to(dt)[None]
    x, aux = _scan_blocks(cfg, params, params["blocks"], x, positions,
                          enc_out=enc_out)
    x = layers.apply_norm(cfg, x, params["final_norm"])
    return layers.logits_from_hidden(cfg, params, x), aux
