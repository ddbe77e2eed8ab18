"""Port vs reference: MoE training on a mesh with more than one batch shard
(``train/train_step.py::make_sharded_value_and_grad``'s MoE branch).

The reference trains a MoE config data-parallel by ``jax.jit`` of
``make_train_step`` with ``param_specs(fsdp=True)`` and ``data_specs``
shardings: under GSPMD that is the one-device function on the global
batch, with the expert capacity from the global token count, each (token,
slot)'s place in its expert from a cumsum over the global token order, and
the load-balance loss from global means. The port's sharded step is held,
on (4, 2) and (2, 2, 2) meshes of CPU shards (which run it tensor-parallel
over "model", experts and MLA heads split: ``_tp_step``, whose own cases
are ``tests/test_torch_tp_moe.py``'s) and on an (8,) "data" mesh (no
"model" split, so whole layers a batch shard), for reduced
``dbrx-132b`` and reduced ``deepseek-v2-lite-16b``, at the config's
``capacity_factor`` and at 0.5, against

* the reference's GSPMD step and its ``jax.value_and_grad`` on the port's
  seeded weights (one 8-device subprocess for the whole file, eight
  compiles);
* the port's one-device step, with the routing of every MoE layer (expert
  ids, keep masks, slots) equal exactly.

Bars (``tests/test_torch_train_sharded.py``'s): loss ``rtol=1e-5``,
gradients ``rtol=1e-4, atol=1e-5 x max|g|`` per leaf, parameters after one
step within ``0.5 x lr``, grad norm ``rtol=1e-5``. The token ids are drawn
Zipf-like, as in text, so that the routing is skewed: every case drops
(token, slot)s, and every case checks that a capacity computed per batch
shard from its own tokens (plain data parallelism) keeps other ones.
"""
import textwrap

import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh
from repro_torch.distributed import sharding as sh
from repro_torch.models import forward, init_params, moe
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import (
    OptimizerConfig, make_loss_fn, make_train_step, optimizer as opt,
)
from repro_torch.train import train_step as tstep
from repro_torch.train.train_step import (
    make_sharded_train_step, make_sharded_value_and_grad, shard_train_state,
    value_and_grad,
)

CPU = "cpu"
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
PARAM_ATOL_LR = 0.5
GNORM_RTOL = 1e-5
NAMES = ["dbrx-132b", "deepseek-v2-lite-16b"]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "8": ((8,), ("data",))}
CAPACITY = {"config": None, "half": 0.5}
CASES = [(n, t, c) for n in NAMES for t in MESHES for c in CAPACITY]


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    # the tensor-parallel rows run many small ops: one intra-op thread
    # keeps them from waiting on cores that the other workers hold
    torch.set_num_threads(1)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _cfg(name, cap):
    cfg = reduced(ARCHS[name])
    cf = CAPACITY[cap]
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


def _mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _n_batch_shards(tag):
    shape, names = MESHES[tag]
    return int(np.prod([n for n, a in zip(shape, names) if a != "model"]))


def _batch(cfg, B=8, S=16, seed=1):
    """Zipf-like token ids (text's skew), labels the next token."""
    rng = np.random.default_rng(seed)
    toks = np.minimum(rng.zipf(1.5, (B, S)) - 1, cfg.vocab - 1)
    toks = toks.astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, sh.Sharded):
        out[prefix[:-1]] = sh.gather(tree).numpy()
    else:
        out[prefix[:-1]] = tree.detach().numpy()
    return out


def _lr():
    return float(opt.lr_at(OptimizerConfig(**OCFG), 1))


def _close(got, want, what):
    """Loss, gradients, parameters after the step, grad norm."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               err_msg=what)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(
            got["grads"][k], w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * float(np.abs(w).max()),
            err_msg=f"{what}: grad {k}")
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                   atol=PARAM_ATOL_LR * _lr(),
                                   err_msg=f"{what}: param {k}")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL, err_msg=what)


def _by_layer(routes, n_shards):
    """Recorded per-call routes of ``n_shards`` forwards in turn, joined
    per MoE layer over the shards: ``{key: [(T_global, K) per layer]}``."""
    n = len(routes) // n_shards
    assert n * n_shards == len(routes) and n > 0
    return {key: [torch.cat([routes[k * n + i][key]
                             for k in range(n_shards)])
                  for i in range(n)]
            for key in ("expert", "keep", "slot")}


def _one_device(cfg, params, b):
    ocfg = OptimizerConfig(**OCFG)
    with moe.recording_routes() as routes:
        (total, _), grads = value_and_grad(make_loss_fn(cfg), params, b)
    new_p, _, m = make_train_step(cfg, ocfg)(params, opt.init(params), b)
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p), "grad_norm": float(m["grad_norm"]),
            "routes": _by_layer(routes, 1)}


def _sharded(cfg, params, b, tag):
    mesh = _mesh(tag)
    ps, st = shard_train_state(params, opt.init(params), mesh)
    assert tstep._tp_applies(cfg, mesh, ps, False) is ("model" in mesh.shape)
    with moe.recording_routes() as routes:
        (total, parts), grads = make_sharded_value_and_grad(cfg, mesh)(ps,
                                                                       b)
    new_p, new_s, m = make_sharded_train_step(
        cfg, OptimizerConfig(**OCFG), mesh)(ps, st, b)
    assert float(m["loss"]) == float(total) and int(new_s.step) == 1
    assert float(m["aux"]) == float(parts["aux"]) > 0
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p), "grad_norm": float(m["grad_norm"]),
            "routes": _by_layer(routes, _n_batch_shards(tag))}


def _per_shard_keep(cfg, params, b, n_shards):
    """Keep masks if each batch shard sized the capacity from its own
    tokens and counted slots from zero (plain data parallelism)."""
    rows = b["tokens"].shape[0] // n_shards
    with torch.no_grad(), moe.recording_routes() as routes:
        for k in range(n_shards):
            forward(cfg, params, b["tokens"][k * rows:(k + 1) * rows])
    return _by_layer(routes, n_shards)["keep"]


# ------------------------------------------------------------ reference
REFERENCE = textwrap.dedent(
    """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec
    from repro.configs import ARCHS, reduced
    from repro.distributed import sharding
    from repro.train import (OptimizerConfig, make_loss_fn,
                             make_train_step, optimizer as opt)

    def tree(path):
        params = {{}}
        with np.load(path) as z:
            for k in z.files:
                node = params
                *p, leaf = k.split("/")
                for n in p:
                    node = node.setdefault(n, {{}})
                node[leaf] = jnp.asarray(z[k])
        return params

    out = {{}}
    for name, tag, shape, names, cf in {cases!r}:
        cfg = reduced(ARCHS[name])
        if cf is not None:
            cfg = cfg.replace(capacity_factor=cf)
        mesh = jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))
        params = tree({weights!r}[name])
        ostate = opt.init(params)
        b = np.load({batches!r}[name])
        batch = {{"tokens": jnp.asarray(b["tokens"]),
                  "labels": jnp.asarray(b["labels"])}}
        p_specs = sharding.param_specs(params, mesh, fsdp=True)
        o_specs = opt.OptState(mu=p_specs, nu=p_specs, step=PartitionSpec())
        b_specs = sharding.data_specs(batch, mesh)
        shard = lambda t, s: jax.device_put(
            t, sharding.make_sharding(s, mesh))
        train_step = make_train_step(cfg, OptimizerConfig(**{ocfg!r}))

        def step_and_grads(params, ostate, batch):
            (loss, _), grads = jax.value_and_grad(
                make_loss_fn(cfg), has_aux=True)(params, batch)
            return (*train_step(params, ostate, batch), loss, grads)

        step = jax.jit(step_and_grads,
                       in_shardings=(sharding.make_sharding(p_specs, mesh),
                                     sharding.make_sharding(o_specs, mesh),
                                     sharding.make_sharding(b_specs, mesh)))
        new_p, _, m, loss, grads = step(shard(params, p_specs),
                                        shard(ostate, o_specs),
                                        shard(batch, b_specs))
        key = f"{{name}}|{{tag}}|{{cf}}|"
        out[key + "loss"] = np.asarray(loss)
        out[key + "step_loss"] = np.asarray(m["loss"])
        out[key + "grad_norm"] = np.asarray(m["grad_norm"])
        flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
        for path, leaf in flat(grads):
            out[key + "g/" + "/".join(str(k.key) for k in path)] = (
                np.asarray(leaf))
        for path, leaf in flat(new_p):
            out[key + "p/" + "/".join(str(k.key) for k in path)] = (
                np.asarray(leaf))
    np.savez({path!r}, **out)
    print("REFERENCE DONE")
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's GSPMD step on the port's seeded weights, all eight
    cases in one subprocess."""
    d = tmp_path_factory.mktemp("moe_sharded")
    weights, batches = {}, {}
    for name in NAMES:
        cfg = reduced(ARCHS[name])
        weights[name] = str(d / f"{name}-weights.npz")
        batches[name] = str(d / f"{name}-batch.npz")
        np.savez(weights[name],
                 **_flat(init_params(cfg, device=CPU, seed=0)))
        np.savez(batches[name], **_batch(cfg))
    cases = [(n, t, MESHES[t][0], MESHES[t][1], CAPACITY[c])
             for n, t, c in CASES]
    code = REFERENCE.format(cases=cases, weights=weights, batches=batches,
                            ocfg=OCFG, path=str(d / "out.npz"))
    assert "REFERENCE DONE" in run_with_devices(code, 8)
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,tag,cap", CASES)
def test_moe_sharded_step_matches_the_reference(ref, name, tag, cap):
    cfg = _cfg(name, cap)
    params = init_params(cfg, device=CPU, seed=0)
    got = _sharded(cfg, params, _torch(_batch(cfg)), tag)
    key = f"{name}|{tag}|{CAPACITY[cap]}|"
    r = {k[len(key):]: v for k, v in ref.items() if k.startswith(key)}
    assert float(r["step_loss"]) == float(r["loss"])
    want = {"loss": float(r["loss"]), "grad_norm": float(r["grad_norm"]),
            "grads": {k[2:]: v for k, v in r.items() if k[:2] == "g/"},
            "params": {k[2:]: v for k, v in r.items() if k[:2] == "p/"}}
    _close(got, want, f"{name} on {tag}, capacity {cap}: vs the reference")


@pytest.mark.parametrize("name,tag,cap", CASES)
def test_moe_sharded_step_matches_one_device(name, tag, cap):
    cfg = _cfg(name, cap)
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    want = _one_device(cfg, params, b)
    got = _sharded(cfg, params, b, tag)
    what = f"{name} on {tag}, capacity {cap}"
    _close(got, want, what)
    for key in ("expert", "keep", "slot"):
        for g, w in zip(got["routes"][key], want["routes"][key]):
            assert torch.equal(g, w), f"{what}: {key}"
    keep = want["routes"]["keep"]
    assert sum(int((~k).sum()) for k in keep) > 0, f"{what}: no drop"
    local = _per_shard_keep(cfg, params, b, _n_batch_shards(tag))
    assert any(not torch.equal(a, k) for a, k in zip(local, keep)), (
        f"{what}: per-shard capacity keeps the same (token, slot)s")
