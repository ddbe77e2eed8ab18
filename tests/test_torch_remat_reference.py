"""The port's per-layer ``remat`` against the reference's: the ten
``reduced`` configs with ``remat=True`` (each block of the loop over layers
checkpointed in the port, the scan body under ``jax.checkpoint`` in the
reference), loss and gradients of the port's ``make_loss_fn`` against
``jax.value_and_grad`` of the reference's, on the reference's seeded
weights, within ``tests/test_torch_train.py``'s bars: loss ``rtol=1e-5``,
gradients ``rtol=1e-4, atol=1e-5 x max|g|`` per leaf. With bf16 compute
(the full configs' dtype) the loss within ``rtol=2e-3``: bf16 keeps 8
bits, one rounding is up to 2^-8 = 3.9e-3 relative, and the packages round
in other places (measured: 5.3e-4 for zamba2, 7.9e-5 for mistral-nemo).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import init_params as ref_init_params
from repro.train import make_loss_fn as ref_make_loss_fn

from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import make_loss_fn
from repro_torch.train.train_step import value_and_grad

CPU = "cpu"
NAMES = sorted(ARCHS)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _setup(name):
    """The reference's seeded weights of reduced ``name`` with remat on,
    in both packages."""
    ref_cfg = ref_reduced(REF_ARCHS[name]).replace(remat=True)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), device=CPU)
    cfg = reduced(ARCHS[name]).replace(remat=True)
    assert cfg.scan_layers
    return ref_cfg, ref_params, cfg, params


def _batch(cfg, B=2, S=16, seed=0):
    """Zipf-like token ids, labels the next token, the frontend's stub
    inputs from numpy."""
    rng = np.random.default_rng(seed)
    toks = np.minimum(rng.zipf(1.5, (B, S)) - 1, cfg.vocab - 1)
    b = {"tokens": toks.astype(np.int32),
         "labels": np.roll(toks, -1, 1).astype(np.int32)}
    if cfg.frontend == "vision":
        b["vision_embeds"] = (rng.normal(size=(
            B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.enc_dec:
        b["audio_frames"] = (rng.normal(size=(
            B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", NAMES)
def test_remat_grads_match_the_references_remat(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    b = _batch(cfg)
    (ref_total, _), ref_grads = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(ref_cfg), has_aux=True))(
            ref_params, {k: jax.numpy.asarray(v) for k, v in b.items()})
    (total, _), grads = value_and_grad(make_loss_fn(cfg), params, _torch(b))
    np.testing.assert_allclose(float(total), float(ref_total),
                               rtol=LOSS_RTOL)
    ref_flat = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_grads), device=CPU)
    for (path, got), (_, want) in zip(_paths(grads), _paths(ref_flat)):
        w = want.numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(
                                       np.abs(w).max()), err_msg=path)


@pytest.mark.parametrize("name", ["zamba2-7b", "mistral-nemo-12b"])
def test_bf16_remat_loss_matches_the_references(name):
    """zamba2's chunked scan meets fp32 ``B dt`` with bf16 ``x`` in its state
    update, where the reference's einsum promotes to fp32."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    ref_cfg = ref_cfg.replace(compute_dtype="bfloat16")
    cfg = cfg.replace(compute_dtype="bfloat16")
    b = _batch(cfg)
    (ref_total, _), _ = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(ref_cfg), has_aux=True))(
            ref_params, {k: jax.numpy.asarray(v) for k, v in b.items()})
    (total, _), grads = value_and_grad(make_loss_fn(cfg), params, _torch(b))
    np.testing.assert_allclose(float(total), float(ref_total), rtol=2e-3)
    assert all(bool(torch.isfinite(g).all()) for _, g in _paths(grads))
