"""Port vs reference: the ten language-model architectures (``reduced``
configs, fp32), with the reference's ``init_params(cfg, PRNGKey(0))``
weights carried across by ``convert.lm_params_from_reference``.

``forward`` logits and aux, ``prefill`` logits and four teacher-forced
``decode_step`` logits are held against the reference within
``rtol=1e-4, atol=1e-5`` (fp32 sums in another order: the reference's XLA
fuses and reorders them); decode against forward as
``tests/test_arch_smoke.py::test_decode_matches_forward`` does (its bar,
5e-3 absolute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attention
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import prefill as ref_prefill

from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.models import (
    attention,
    decode_step,
    forward,
    init_params,
    layers,
    moe,
    prefill,
)
from repro_torch.resilience.errors import KernelUnavailableError

ALL = sorted(REF_ARCHS)
TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_VS_FORWARD = 5e-3
CPU = "cpu"


def _inputs(cfg, B=2, S=12, seed=7):
    """Token ids and the stub frontends' embeddings, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    kw = {}
    if cfg.frontend == "vision":
        kw["vision_embeds"] = (rng.normal(size=(
            B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.enc_dec:
        kw["audio_frames"] = (rng.normal(size=(
            B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, kw


def _torch_kw(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


@pytest.fixture(scope="module", params=ALL)
def arch(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    name = request.param
    ref_cfg = ref_reduced(REF_ARCHS[name])
    cfg = reduced(ARCHS[name])
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    return name, ref_cfg, cfg, ref_params, convert.lm_params_from_reference(
        tree, device=CPU)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ALL)
def test_configs_equal_the_references(name):
    for full in (True, False):
        ref = REF_ARCHS[name] if full else ref_reduced(REF_ARCHS[name])
        ours = get_arch(name) if full else reduced(ARCHS[name])
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for prop in ("head_dim", "q_per_kv", "d_inner_ssm", "n_ssm_heads",
                     "attn_sites", "sub_quadratic"):
            assert getattr(ours, prop) == getattr(ref, prop), prop
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()


def test_smollm_full_width():
    cfg = get_arch("smollm-360m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == (
        32, 960, 15, 5, 2560, 49152, True)


# -------------------------------------------------------------- parameters
def test_own_init_params_has_the_references_tree(arch):
    """The port's seeded init gives the reference's tree, shapes and fp32
    dtypes; one seed gives the same weights twice, another seed others."""
    name, ref_cfg, cfg, ref_params, _ = arch
    want = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    ours = init_params(cfg, device=CPU, seed=3)
    again = init_params(cfg, device=CPU, seed=3)
    other = init_params(cfg, device=CPU, seed=4)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, ref_leaf in want:
        leaf = got[jax.tree_util.keystr(path)]
        assert tuple(leaf.shape) == ref_leaf.shape, path
        assert leaf.dtype == torch.float32 and ref_leaf.dtype == jnp.float32
    assert torch.equal(ours["embed"]["tok"], again["embed"]["tok"])
    assert not torch.equal(ours["embed"]["tok"], other["embed"]["tok"])


def test_params_carried_across_bit_for_bit(arch):
    _, _, _, ref_params, params = arch
    for (path, ref_leaf), leaf in zip(
            jax.tree_util.tree_flatten_with_path(ref_params)[0],
            jax.tree_util.tree_flatten(
                jax.tree.map(lambda x: x, params))[0]):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == CPU
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref_leaf))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(KernelUnavailableError):
        init_params(reduced(ARCHS["smollm-360m"]))
    with pytest.raises(KernelUnavailableError):
        convert.lm_params_from_reference({"w": np.zeros(2, np.float32)})


# ------------------------------------------------- forward, prefill, decode
def test_forward_matches_reference(arch):
    name, ref_cfg, cfg, ref_params, params = arch
    toks, kw = _inputs(cfg)
    want, want_aux = jax.jit(lambda p, t: ref_forward(
        ref_cfg, p, t, **{k: jnp.asarray(v) for k, v in kw.items()}))(
        ref_params, jnp.asarray(toks))
    got, aux = forward(cfg, params, torch.from_numpy(toks).long(),
                       **_torch_kw(kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=name)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_prefill_and_decode_match_reference(arch):
    """Prefill the first 8 tokens, then decode the next 4 teacher-forced:
    every step's logits within TOL of the reference's, the cursor equal."""
    name, ref_cfg, cfg, ref_params, params = arch
    toks, kw = _inputs(cfg)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want, st = jax.jit(lambda p, t: ref_prefill(
        ref_cfg, p, t, max_seq=32, **jkw))(ref_params, jnp.asarray(toks[:, :8]))
    got, state = prefill(cfg, params, torch.from_numpy(toks[:, :8]).long(),
                         max_seq=32, **_torch_kw(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=f"{name} prefill")
    assert state.step == int(st.step)
    step = jax.jit(lambda p, t, s: ref_decode_step(ref_cfg, p, t, s))
    for t in range(8, 12):
        want, st = step(ref_params, jnp.asarray(toks[:, t:t + 1]), st)
        got, state = decode_step(cfg, params,
                                 torch.from_numpy(toks[:, t:t + 1]).long(),
                                 state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{name} decode {t}")
        assert state.step == int(st.step)


def test_decode_matches_forward(arch):
    """Teacher-forced decode logits == forward logits (the vision prefix,
    where there is one, is prefilled with the first tokens)."""
    name, _, cfg, _, params = arch
    toks, kw = _inputs(cfg, S=8)
    t_toks = torch.from_numpy(toks).long()
    logits, _ = forward(cfg, params, t_toks, **_torch_kw(kw))
    off = cfg.n_vision_tokens if cfg.frontend == "vision" else 0
    _, state = prefill(cfg, params, t_toks[:, :4], max_seq=16,
                       **_torch_kw(kw))
    errs = []
    for t in range(4, 8):
        lg, state = decode_step(cfg, params, t_toks[:, t:t + 1], state)
        errs.append(float((lg[:, 0] - logits[:, off + t]).abs().max()))
    assert max(errs) < DECODE_VS_FORWARD, f"{name}: decode drift {errs}"
    assert state.step == off + 8


# ------------------------------------------------------------ layer pieces
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_flash_attention_matches_reference(causal, window):
    """The chunked online-softmax attention (padded last chunks, masks)
    against the reference's, and, where the padded keys are masked, against
    the port's full attention. (Without the causal mask both packages'
    chunked attention let the last chunk's zero-padded keys into the
    softmax: a property of the reference that the port keeps.)"""
    rng = np.random.default_rng(0)
    B, Sq, Skv, H, dh = 2, 37, 45, 3, 8
    q, k, v = (rng.normal(size=(B, s, H, dh)).astype(np.float32)
               for s in (Sq, Skv, Skv))
    qp, kp = np.arange(Skv - Sq, Skv), np.arange(Skv)
    want = ref_attention._flash_attn(*map(jnp.asarray, (q, k, v, qp, kp)),
                                     causal, window, 16, 16)
    tq, tk, tv, tqp, tkp = map(torch.from_numpy, (q, k, v, qp, kp))
    got = attention._flash_attn(tq, tk, tv, tqp, tkp, causal, window, 16, 16)
    full = attention._full_attn(tq, tk, tv, tqp, tkp, causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal:
        np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    else:
        assert np.abs(got.numpy() - full.numpy()).max() > 1e-3


def test_rope_and_sinusoidal_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)[None]
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6)), **TOL)
    np.testing.assert_allclose(
        layers.sinusoidal_positions(24, 64).numpy(),
        np.asarray(ref_layers.sinusoidal_positions(24, 64)), **TOL)


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v2-lite-16b"])
def test_expert_load_counts_match_reference(name):
    ref_cfg, cfg = ref_reduced(REF_ARCHS[name]), reduced(ARCHS[name])
    tree = jax.tree.map(np.asarray, ref_init_params(ref_cfg,
                                                    jax.random.PRNGKey(0)))
    p = jax.tree.map(lambda a: a[-1], tree["blocks"]["moe"])
    x = (np.random.default_rng(2).normal(size=(2, 16, cfg.d_model))
         .astype(np.float32))
    want = ref_moe.expert_load_counts(ref_cfg, p, jnp.asarray(x))
    got = moe.expert_load_counts(
        cfg, convert.lm_params_from_reference(p, CPU), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
