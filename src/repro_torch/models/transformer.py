"""Transformer assembly: blocks, the loop over layers, enc-dec, hybrids.

Parameters keep the reference's tree: per-layer weights are stacked on a
leading L axis (``params["blocks"][name]`` is ``(L, ...)``), and the
reference's ``lax.scan`` over that axis is a Python loop here, each layer's
weights a view ``a[i]``, taken by the block itself (``layer``). The sharded
train step hands a stacked subtree over as a ``sharding.Layers``, whose
``layer(i)`` gathers that layer's pieces (ZeRO-3). With ``remat`` and
``scan_layers`` set (every full config), a forward under autograd runs each
block of that loop (and of the Whisper encoder's) through a non-reentrant
``torch.utils.checkpoint``, as the reference wraps its scan body in
``jax.checkpoint``: backward keeps the blocks' inputs and recomputes one
block at a time, its layer taken (gathered) again, and the numbers do not
move. A config with ``scan_layers=False`` is not checkpointed (the
reference's unrolled loop is not), and nothing changes without autograd
(prefill, decode, serving).

Families:
  dense / moe        [attn | mla] + [swiglu | gelu | moe]
  ssm                rwkv6 (tmix + cmix)  or  mamba2 + swiglu
  hybrid (zamba2)    mamba2 stack; one *shared* attention block applied every
                     k layers (weights shared, per-site KV caches)
  audio (whisper)    encoder (bidirectional attn over stub frame embeddings)
                     + decoder with cross-attention
  vlm (llava)        decoder over [vision stub embeds ; text embeds]

``forward_tp`` is ``forward`` under ``distributed.mesh.tensor_parallel``
for the configs ``tp_covers`` (attention, MLA or not; a swiglu, gelu or
MoE channel; with ``serving``, the mamba2 and rwkv6 mixers and zamba2's
shared attention sites too): one parameter tree per position of the row,
each holding that position's "model" pieces (Megatron's column / row
splits, MLA's heads, ``E/M`` whole experts, the SSM's and RWKV's heads;
the embedding, the head and so the logits split by vocabulary), the
residual stream replicated at every position,
the row's sums through ``distributed.collectives``. Each block, remat
included, runs the whole row in lockstep (``mesh.each``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as _checkpoint

from .. import _device
from ..distributed import collectives
from ..distributed import mesh as _mesh
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


# the stacked subtrees of the parameter tree (axis 0 the layers)
STACKED = ("blocks", "enc_blocks", "dense_mlp")


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy), or of a ZeRO-3
    step's ``sharding.Layers`` on one device (gathered there)."""
    if isinstance(tree, _sh.Layers):
        (one,) = tree.layer(i)
        return one
    return tree_map(lambda a: a[i], tree)


def depth(tree) -> int:
    """The number of layers of a stacked tree or ``sharding.Layers``."""
    if isinstance(tree, _sh.Layers):
        return tree.depth
    return next(leaves(tree)).shape[0]


def shared_site(cfg, i: int) -> bool:
    """Does the shared attention block run after layer ``i``?"""
    return (cfg.shared_attn_every > 0
            and i % cfg.shared_attn_every == cfg.shared_attn_every - 1)


def site_of(cfg, i: int) -> int:
    """Index of the shared-attention site after layer ``i``."""
    return (i + 1) // cfg.shared_attn_every - 1


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


def _block_apply(cfg, params, blocks, x, positions, layer_idx,
                 enc_out=None):
    """Block ``layer_idx`` of the stacked ``blocks``: mixer + (optional
    shared attn / cross attn) + channel. It takes its layer itself, so that
    under ``remat`` the layer is taken inside the checkpoint."""
    bp = layer(blocks, layer_idx)
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


def _remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing around the
    forward; around the recompute, what the forward ran under and autograd
    does not carry into backward: the MoE dispatch (replayed, no routes
    recorded), the hint mesh and the mesh position."""
    again = [moe.recompute_context(), _mesh.recompute_context()]
    hint = _sh.active_mesh()
    if hint is not None:
        again.append(_sh.hint_mesh(hint))

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            for ctx in again:
                stack.enter_context(ctx)
            yield

    return contextlib.nullcontext(), recompute()


def _rematted(cfg) -> bool:
    """Does a forward now run its blocks through ``checkpoint``?"""
    return cfg.remat and cfg.scan_layers and torch.is_grad_enabled()


def _run_block(remat: bool, fn, *args):
    """``fn(*args)``, through ``checkpoint`` under ``remat``. A block
    function takes its stacked tree and its index and takes its layer
    itself: were the layer's tensors (a ZeRO-3 step's gathered weights)
    arguments, the checkpoint would keep them until backward; so the
    recompute takes (gathers) the layer again, as ``jax.checkpoint`` of
    the reference's scan body does."""
    if not remat:
        return fn(*args)
    return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                  context_fn=_remat_contexts)


def _scan_blocks(cfg, params, blocks, x, positions, enc_out=None):
    """The loop over the stacked blocks, each one checkpointed under
    ``remat`` (``_rematted``). Returns (x, aux)."""
    remat = _rematted(cfg)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for i in range(depth(blocks)):
        x, a = _run_block(remat, _block_apply, cfg, params, blocks, x,
                          positions, i, enc_out)
        aux = aux + a
    return x, aux


def _enc_block(cfg, enc_cfg, params, blocks, x, positions, i):
    bp = layer(blocks, i)
    x = x + attention.attn_apply(
        enc_cfg, bp["attn"], layers.apply_norm(cfg, x, bp["norm1"]),
        positions, causal=False, use_rope=False)
    h, _ = apply_channel(enc_cfg, params, bp,
                         layers.apply_norm(cfg, x, bp["norm2"]), i)
    return x + h


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, S_enc, D); each
    block checkpointed under ``remat``, as the decoder's are."""
    dt = layers.dtype_of(cfg.compute_dtype)
    S = frames.shape[1]
    x = frames.to(dt) + layers.sinusoidal_positions(
        S, cfg.d_model, frames.device).to(dt)[None]
    positions = torch.arange(S, device=frames.device)
    enc_cfg = cfg.replace(mixer="attn", mla=False, mlp="gelu")
    blocks = params["enc_blocks"]
    remat = _rematted(cfg)
    for i in range(depth(blocks)):
        x = _run_block(remat, _enc_block, cfg, enc_cfg, params, blocks, x,
                       positions, i)
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


# ============================================================ on a TP row
def tp_covers(cfg, serving: bool = False) -> bool:
    """Does the sharded train step run this config on rows
    (``forward_tp``)? Attention (MLA or not) and a swiglu, gelu or MoE
    channel, no shared attention block (whisper's encoder and
    cross-attention and llava's vision prefix included). With ``serving``:
    do the sharded prefill and decode (``model.prefill_tp`` /
    ``decode_step_tp``)? Those configs, and the mamba2 mixer with a
    swiglu or gelu channel and shared attention sites (zamba2) and the
    rwkv6 time and channel mix. The train step does not take the latter
    two: they are ``fsdp`` configs, whose batch the reference's layout
    splits over "model" with whole leaves."""
    attn = (cfg.mixer == "attn" and cfg.mlp in ("swiglu", "gelu", "moe")
            and cfg.shared_attn_every == 0)
    if not serving:
        return attn
    return attn or (cfg.mixer == "mamba2" and cfg.mlp in ("swiglu", "gelu")
                    and not cfg.enc_dec) or (
        cfg.mixer == "rwkv6" and cfg.mlp == "rwkv6_cmix"
        and cfg.shared_attn_every == 0 and not cfg.enc_dec)


def _norm_tp(cfg, xs, ws):
    return _mesh.each(lambda x, w: layers.apply_norm(cfg, x, w), xs, ws)


def _add(xs, ys):
    return _mesh.each(torch.add, xs, ys)


def _layer_tp(trees, i: int):
    """Layer ``i`` of each position's stacked tree; a ZeRO-3 step's row
    shares one ``sharding.Layers``, which gathers the layer onto every
    position of the row at once."""
    if isinstance(trees[0], _sh.Layers):
        return trees[0].layer(i)
    return [layer(t, i) for t in trees]


def _last_token_home(xs):
    """The row's last input token at its first position (an rwkv6 shift,
    which ``decode_state_specs`` splits by batch only)."""
    with _mesh.at(_mesh.tp_row()[0]):
        return xs[0][:, -1].to(xs[0].dtype, copy=True)


def _apply_mixer_tp(cfg, bps, xs, positions, caches=None):
    """``_apply_mixer`` over the row. With ``caches`` (prefill's: the
    layer's pieces, one per position of ``mesh.cache_row()``) returns
    (outputs, the pieces holding the prompt): an attention layer's lines
    in each piece, a recurrent layer's state at the row's first position
    (``decode_state_specs`` splits it by batch only), the other pieces as
    they came."""
    fill = caches is not None
    if cfg.mixer == "mamba2":
        out = ssm.ssm_apply_tp(cfg, [b["ssm"] for b in bps], xs,
                               return_cache=fill)
        return (out[0], out[1] + caches[len(xs):]) if fill else out
    if cfg.mixer == "rwkv6":
        out = rwkv.tmix_apply_tp(cfg, [b["tmix"] for b in bps], xs,
                                 return_state=fill)
        if not fill:
            return out
        home = caches[0]._replace(shift_tmix=_last_token_home(xs),
                                  wkv=out[1])
        return out[0], [home] + caches[1:]
    if cfg.mla:
        pms = [b["mla"] for b in bps]
        hs = mla.mla_apply_tp(cfg, pms, xs, positions)
        return (hs, mla.mla_fill_tp(cfg, pms, xs, caches, positions)) \
            if fill else hs
    pas = [b["attn"] for b in bps]
    hs = attention.attn_apply_tp(cfg, pas, xs, positions,
                                 use_rope=cfg.use_rope)
    return (hs, attention.attn_fill_tp(cfg, pas, xs, caches)) if fill \
        else hs


def _mixer_filling(cfg, bps, xs, positions, states, field: str, k: int):
    """``_apply_mixer_tp``; with ``states`` it also writes the prompt into
    their pieces ``getattr(state, field)[k]``, in place."""
    if states is None:
        return _apply_mixer_tp(cfg, bps, xs, positions)
    hs, new = _apply_mixer_tp(cfg, bps, xs, positions,
                              [getattr(s, field)[k] for s in states])
    for s, c in zip(states, new):
        getattr(s, field)[k] = c
    return hs


def apply_channel_tp(cfg, ps, bps, xs, layer_idx: int):
    """``apply_channel`` over the row: ``ps`` the positions' parameter
    trees, ``bps`` their layer's; returns (one output per position, aux on
    the row's first position)."""
    zero = torch.zeros((), dtype=_F32, device=xs[0].device)
    if cfg.mlp == "moe":
        moes = [b["moe"] for b in bps]
        if cfg.first_dense_layers > 0 and "dense_mlp" in ps[0]:
            if layer_idx < cfg.first_dense_layers:
                return layers.mlp_apply_tp(
                    cfg, _layer_tp([p["dense_mlp"] for p in ps], layer_idx),
                    xs), zero
            return moe.moe_apply_tp(cfg, moes, xs)
        if cfg.moe_impl == "a2a":
            mesh = _sh.active_mesh()
            if mesh is not None:
                return moe.moe_apply_a2a_tp(cfg, moes, xs, mesh)
        return moe.moe_apply_tp(cfg, moes, xs)
    if cfg.mlp == "rwkv6_cmix":
        return rwkv.cmix_apply_tp(cfg, [b["cmix"] for b in bps], xs), zero
    return layers.mlp_apply_tp(cfg, [b["mlp"] for b in bps], xs), zero


def _block_tp(cfg, ps, blocks, xs, positions, layer_idx, enc_outs=None,
              states=None):
    """``_block_apply`` over the row (``blocks``: each position's stacked
    tree); returns (xs, aux). With ``states``
    (``model.prefill_tp``'s: one ``DecodeState`` per position of
    ``mesh.cache_row()``) the block also writes the prompt into them, in
    place: its layer's and its shared site's cache pieces
    (``_apply_mixer_tp``) and an rwkv6 channel mix's shift."""
    bps = _layer_tp(blocks, layer_idx)
    xs = _add(xs, _mixer_filling(
        cfg, bps, _norm_tp(cfg, xs, [b["norm1"] for b in bps]), positions,
        states, "layer", layer_idx))
    if shared_site(cfg, layer_idx):
        xs = _add(xs, _mixer_filling(
            cfg.replace(mixer="attn"),
            [{"attn": p["shared_attn"]} for p in ps],
            _norm_tp(cfg, xs, [p["shared_norm"] for p in ps]), positions,
            states, "shared", site_of(cfg, layer_idx)))
    if enc_outs is not None:
        xs = _add(xs, attention.attn_apply_tp(
            cfg, [b["xattn"] for b in bps],
            _norm_tp(cfg, xs, [b["norm_x"] for b in bps]), positions,
            causal=False, kv_source=enc_outs, use_rope=False))
    h_in = _norm_tp(cfg, xs, [b["norm2"] for b in bps])
    hs, aux = apply_channel_tp(cfg, ps, bps, h_in, layer_idx)
    if states is not None and cfg.mlp == "rwkv6_cmix":
        home = states[0].layer[layer_idx]
        states[0].layer[layer_idx] = home._replace(
            shift_cmix=_last_token_home(h_in))
    return _add(xs, hs), aux


def _enc_block_tp(enc_cfg, blocks, xs, positions, i):
    bps = _layer_tp(blocks, i)
    xs = _add(xs, attention.attn_apply_tp(
        enc_cfg, [b["attn"] for b in bps],
        _norm_tp(enc_cfg, xs, [b["norm1"] for b in bps]), positions,
        causal=False, use_rope=False))
    return _add(xs, layers.mlp_apply_tp(
        enc_cfg, [b["mlp"] for b in bps],
        _norm_tp(enc_cfg, xs, [b["norm2"] for b in bps])))


def _positions_tp(xs):
    return _mesh.each(lambda x: torch.arange(x.shape[1], device=x.device),
                      xs)


def encode_tp(cfg, ps, frames):
    """``encode`` over the row: ``frames`` one (B, S_enc, D) per position;
    each block checkpointed under ``remat``."""
    dt = layers.dtype_of(cfg.compute_dtype)
    xs = _mesh.each(lambda f: f.to(dt) + layers.sinusoidal_positions(
        f.shape[1], cfg.d_model, f.device).to(dt)[None], frames)
    positions = _positions_tp(xs)
    enc_cfg = cfg.replace(mixer="attn", mla=False, mlp="gelu")
    blocks = [p["enc_blocks"] for p in ps]
    remat = _rematted(cfg)
    for i in range(depth(blocks[0])):
        xs = _run_block(remat, _enc_block_tp, enc_cfg, blocks, xs,
                        positions, i)
    return _norm_tp(cfg, xs, [p["enc_norm"] for p in ps])


def embed_tp(cfg, ps, tokens, vision_embeds=None):
    """``embed`` over the row, vocabulary-parallel: each position looks up
    the ids of its range of ``embed.tok`` (zeros for the others) and
    ``all_reduce`` adds the row's rows; then the vision prefix. A table
    left whole looks every id up at every position."""
    dt = layers.dtype_of(cfg.compute_dtype)
    n = ps[0]["embed"]["tok"].shape[0]

    def lookup(j, p, ids):
        w = p["embed"]["tok"].to(dt)
        if n == cfg.vocab:
            return w[ids]
        local = ids - j * n
        hit = (local >= 0) & (local < n)
        x = w[local.clamp(0, n - 1)]
        return torch.where(hit[..., None], x,
                           torch.zeros((), dtype=dt, device=x.device))

    row = _mesh.tp_row()
    xs = _mesh.each(lookup, range(len(row)), ps, tokens)
    if n != cfg.vocab:
        xs = collectives.all_reduce(xs, row)
    if vision_embeds is not None:
        xs = _mesh.each(lambda x, v: torch.cat([v.to(dt), x], dim=1), xs,
                        vision_embeds)
    return xs


def forward_tp(cfg, ps, tokens, vision_embeds=None, audio_frames=None):
    """``forward`` over the row of ``mesh.tp_row()``: ``ps`` one parameter
    tree per position, the inputs one tensor per position (the batch
    shard's rows, replicated over the row). Returns each position's fp32
    logits (B, S_total, its range of the vocabulary) and the aux (the MoE
    layers', as ``forward``'s; on the row's first position)."""
    dt = layers.dtype_of(cfg.compute_dtype)
    xs = embed_tp(cfg, ps, tokens, vision_embeds)
    positions = _positions_tp(xs)
    enc_outs = None
    if cfg.enc_dec:
        if audio_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "audio_frames")
        enc_outs = encode_tp(cfg, ps, audio_frames)
        xs = _mesh.each(lambda x: x + layers.sinusoidal_positions(
            x.shape[1], cfg.d_model, x.device).to(dt)[None], xs)
    blocks = [p["blocks"] for p in ps]
    remat = _rematted(cfg)
    aux = torch.zeros((), dtype=_F32, device=xs[0].device)
    for i in range(depth(blocks[0])):
        xs, a = _run_block(remat, _block_tp, cfg, ps, blocks, xs, positions,
                           i, enc_outs)
        aux = aux + a
    xs = _norm_tp(cfg, xs, [p["final_norm"] for p in ps])
    return layers.logits_from_hidden_tp(cfg, ps, xs), aux
