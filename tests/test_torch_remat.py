"""The port's per-layer ``remat`` (``models/transformer.py``): each block of
the loop over layers checkpointed by a non-reentrant
``torch.utils.checkpoint`` when ``cfg.remat`` and ``cfg.scan_layers`` are
set and autograd is on, as the reference wraps its scan body in
``jax.checkpoint``.

* The ten ``reduced`` configs with ``remat=True``: loss and every gradient
  bit for bit the port's ``remat=False`` ones, and fewer tensors saved for
  backward (``tests/test_torch_remat_reference.py`` holds them against the
  reference's ``jax.value_and_grad`` with ``remat=True``).
* The MoE configs on (4, 2) and (2, 2, 2) meshes through the halves of
  ``make_sharded_train_step`` (the global dispatch: one backward over every
  batch shard's graph, so every block is recomputed outside the shards'
  ``global_dispatch``): loss, gradients, parameters after the step and
  routes bit for bit the step without remat, and ``recording_routes`` holds
  one entry per MoE call of the forward (the recompute records none).
* Reduced ``dbrx-132b`` under a hint mesh, where the recompute must take the
  all-to-all route again: the same bits with and without remat, twice the
  all-to-all calls, and the global batch's one-device function (its
  all-to-all over the whole mesh) within the bars.
* The same with bf16 compute, the full configs' dtype.
* Under ``torch.no_grad()`` nothing is checkpointed and the forward is the
  same.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh, collectives
from repro_torch.distributed import sharding as sh
from repro_torch.models import forward, init_params, moe
from repro_torch.models import transformer
from repro_torch.models.transformer import leaves
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import OptimizerConfig, make_loss_fn, optimizer as opt
from repro_torch.train.train_step import (
    make_sharded_value_and_grad, shard_train_state, sharded_update,
    value_and_grad,
)

CPU = "cpu"
NAMES = sorted(ARCHS)
MOE = ["dbrx-132b", "deepseek-v2-lite-16b"]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _cfg(name):
    cfg = reduced(ARCHS[name]).replace(remat=True)
    assert cfg.scan_layers
    return cfg


def _port(name):
    """Reduced ``name`` with remat on and the port's seeded weights."""
    cfg = _cfg(name)
    return cfg, init_params(cfg, device=CPU, seed=0)


def _batch(cfg, B=2, S=16, seed=0):
    """Zipf-like token ids (a MoE then drops some (token, slot)s), labels
    the next token, the frontend's stub inputs from numpy."""
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


def _saved(fn) -> int:
    """How many tensors ``fn``'s autograd graph saves outside checkpointed
    regions (a region's own hooks take the saves inside it)."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return n[0]


def _grads(cfg, params, b):
    (total, parts), grads = value_and_grad(make_loss_fn(cfg), params, b)
    return total, parts, list(leaves(grads))


@pytest.mark.parametrize("name", NAMES)
def test_remat_step_is_bit_for_bit_and_saves_less(name):
    cfg, params = _port(name)
    b = _torch(_batch(cfg))
    t1, p1, g1 = _grads(cfg, params, b)
    t0, p0, g0 = _grads(cfg.replace(remat=False), params, b)
    assert torch.equal(t1, t0) and torch.equal(p1["aux"], p0["aux"])
    assert len(g1) == len(g0)
    for a, w in zip(g1, g0):
        assert torch.equal(a, w)
    loss = make_loss_fn(cfg)
    with_remat = _saved(lambda: loss(params_rg(params), b))
    without = _saved(lambda: make_loss_fn(cfg.replace(remat=False))(
        params_rg(params), b))
    assert with_remat < without, (with_remat, without)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_remat_step_is_bit_for_bit(name):
    """The full configs' compute dtype: with bf16 compute (fp32 masters)
    the remat step is the plain one bit for bit too (and zamba2's chunked
    scan runs: its fp32 ``B dt`` meets bf16 ``x`` in the state update)."""
    cfg, params = _port(name)
    cfg = cfg.replace(compute_dtype="bfloat16")
    b = _torch(_batch(cfg))
    t1, _, g1 = _grads(cfg, params, b)
    t0, _, g0 = _grads(cfg.replace(remat=False), params, b)
    assert torch.equal(t1, t0) and bool(torch.isfinite(t1))
    for a, w in zip(g1, g0, strict=True):
        assert torch.equal(a, w)


def params_rg(params):
    return transformer.tree_map(
        lambda a: a.detach().requires_grad_(True), params)


def _mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _sharded_step(cfg, params, b, mesh, hint=False):
    """Loss, gradients, parameters after the step and the recorded routes
    of ``make_sharded_train_step``'s two halves: its gradients
    (``make_sharded_value_and_grad``) and its update (``sharded_update``)."""
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    ps, st = shard_train_state(params, opt.init(params), mesh)
    with sh.hint_mesh(mesh) if hint else contextlib.nullcontext():
        with moe.recording_routes() as routes, \
                collectives.counting() as count:
            (total, _), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
    new_p, _, m = sharded_update(ocfg, ps, grads, st)
    return {"loss": total, "grads": [sh.gather(g) for g in leaves(grads)],
            "params": [sh.gather(p) for p in leaves(new_p)],
            "grad_norm": m["grad_norm"], "routes": routes,
            "a2a_calls": count.calls["all-to-all"]}


def _equal(got, want):
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for key in ("grads", "params"):
        for a, w in zip(got[key], want[key], strict=True):
            assert torch.equal(a, w), key
    assert len(got["routes"]) == len(want["routes"])
    for a, w in zip(got["routes"], want["routes"]):
        for key in ("expert", "keep", "slot"):
            assert torch.equal(a[key], w[key]), key


def _moe_calls(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("name", MOE)
def test_moe_sharded_remat_step_is_bit_for_bit(name, tag):
    cfg, params = _port(name)
    mesh = _mesh(tag)
    b = _torch(_batch(cfg, B=8))
    got = _sharded_step(cfg, params, b, mesh)
    want = _sharded_step(cfg.replace(remat=False), params, b, mesh)
    _equal(got, want)
    n_shards = int(np.prod(MESHES[tag][0][:-1]))
    # one entry per MoE call of each batch shard's forward: the recompute
    # in backward records nothing
    assert len(got["routes"]) == n_shards * _moe_calls(cfg)
    assert any(not bool(r["keep"].all()) for r in got["routes"])


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_dbrx_recompute_takes_the_all_to_all_under_a_hint_mesh(tag):
    cfg, params = _port("dbrx-132b")
    mesh = _mesh(tag)
    b = _torch(_batch(cfg, B=8))
    got = _sharded_step(cfg, params, b, mesh, hint=True)
    want = _sharded_step(cfg.replace(remat=False), params, b, mesh,
                         hint=True)
    _equal(got, want)
    n_shards = int(np.prod(MESHES[tag][0][:-1]))
    assert len(got["routes"]) == n_shards * _moe_calls(cfg)
    # three exchanges a layer and batch shard, again in the recompute
    assert want["a2a_calls"] == 3 * n_shards * _moe_calls(cfg)
    assert got["a2a_calls"] == 2 * want["a2a_calls"]
    # the global batch's function: the one-device step's all-to-all over
    # the whole mesh
    with sh.hint_mesh(mesh), moe.recording_routes() as routes:
        (total, _), grads = value_and_grad(make_loss_fn(cfg), params, b)
    np.testing.assert_allclose(float(got["loss"]), float(total),
                               rtol=LOSS_RTOL)
    for a, w in zip(got["grads"], leaves(grads), strict=True):
        w = w.numpy()
        np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(
                                       np.abs(w).max()))
    for key in ("expert", "keep", "slot"):
        for layer in range(_moe_calls(cfg)):
            joined = torch.cat([got["routes"][k * _moe_calls(cfg) + layer]
                                [key] for k in range(n_shards)])
            assert torch.equal(joined, routes[layer][key]), key


@pytest.mark.parametrize("name", NAMES)
def test_no_grad_forward_is_the_same_and_not_checkpointed(name, monkeypatch):
    cfg, params = _port(name)
    b = _torch(_batch(cfg))
    kw = {k: v for k, v in b.items() if k not in ("tokens", "labels")}
    with torch.no_grad():
        plain = forward(cfg.replace(remat=False), params, b["tokens"], **kw)
        monkeypatch.setattr(transformer._checkpoint, "checkpoint",
                            lambda *a, **k: pytest.fail("checkpointed"))
        got = forward(cfg, params, b["tokens"], **kw)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_unscanned_config_is_not_checkpointed(monkeypatch):
    """The reference remats only its scan body: ``scan_layers=False``
    runs the plain loop."""
    cfg, params = _port("smollm-360m")
    b = _torch(_batch(cfg))
    monkeypatch.setattr(transformer._checkpoint, "checkpoint",
                        lambda *a, **k: pytest.fail("checkpointed"))
    _grads(cfg.replace(scan_layers=False), params, b)
