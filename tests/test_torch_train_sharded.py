"""Port vs reference: training on a mesh of shards
(``train/train_step.py::make_sharded_train_step``) from one controller.

The sharded step on (2, 2, 2) and (4, 2) meshes of CPU shards against the
port's one-device step, from the same weights and batch, for reduced
``mistral-nemo-12b`` and ``smollm-360m`` and one config of each other mixer
family (mamba2: ``zamba2-7b``, rwkv6, vlm, enc-dec). Bars (the one-device
train tests' where they exist):

* loss within 1e-5 relative;
* gradients before the update within ``rtol=1e-4, atol=1e-5 x max|g|`` per
  leaf (``tests/test_torch_train.py``'s bar);
* parameters after one step within ``0.5 x lr`` (lr at that step).

The same bars against the reference's sharded (GSPMD) step of
``tests/test_dryrun_machinery.py::test_train_cell_lowers_and_is_numerically_correct``
(reduced mistral on (2, 2, 2); the reference runs once for the file in an
8-device subprocess). Also: MoE on (1, 8) runs and matches (MoE on more
than one batch shard is ``tests/test_torch_train_moe_sharded.py``'s); a
dense config's sharded gradients are the row-major sum of its batch
shards' own tensor-parallel gradients, bit for bit (the TP step itself is
``tests/test_torch_tp.py``'s); a mesh of one shard is the one-device step;
``python -m repro_torch.launch.train --reduced --device cpu --model-axis 2
--steps 3`` runs; a checkpoint of a sharded run restores into the
reference's ``checkpoint.restore`` and a reference checkpoint into sharded
leaves; the runner resumes a sharded run, dense or MoE.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding as sh
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.models.transformer import tree_map
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import (
    OptimizerConfig, RunnerConfig, TrainRunner, checkpoint as ckpt,
    make_loss_fn, make_train_step, optimizer as opt,
)
from repro_torch.train import train_step as tstep
from repro_torch.train.train_step import (
    make_sharded_train_step, make_sharded_value_and_grad, shard_train_state,
    value_and_grad,
)

CPU = "cpu"
SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
PARAM_ATOL_LR = 0.5
FAMILIES = ["mistral-nemo-12b", "smollm-360m", "zamba2-7b", "rwkv6-3b",
            "llava-next-mistral-7b", "whisper-large-v3"]
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model"))}


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    elif isinstance(tree, sh.Sharded):
        out[prefix[:-1]] = sh.gather(tree).numpy()
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _batch(cfg, B=8, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.frontend == "vision":
        b["vision_embeds"] = (rng.normal(size=(
            B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.enc_dec:
        b["audio_frames"] = (rng.normal(size=(
            B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, lr, what):
    """Loss, gradients, parameters after the step."""
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
                                   atol=PARAM_ATOL_LR * lr,
                                   err_msg=f"{what}: param {k}")


def _one_device(cfg, params, b):
    ocfg = OptimizerConfig(**OCFG)
    (total, _), grads = value_and_grad(make_loss_fn(cfg), params, b)
    new_p, _, m = make_train_step(cfg, ocfg)(params, opt.init(params), b)
    assert float(m["loss"]) == float(total)
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p), "grad_norm": float(m["grad_norm"])}


def _sharded(cfg, params, b, mesh):
    ocfg = OptimizerConfig(**OCFG)
    ps, st = shard_train_state(params, opt.init(params), mesh)
    (total, _), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
    assert all(isinstance(g, sh.Sharded) for g in _leaves(grads))
    new_p, new_s, m = make_sharded_train_step(cfg, ocfg, mesh)(ps, st, b)
    assert all(isinstance(p, sh.Sharded) for p in _leaves(new_p))
    assert float(m["loss"]) == float(total) and int(new_s.step) == 1
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p), "grad_norm": float(m["grad_norm"])}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _lr():
    return float(opt.lr_at(OptimizerConfig(**OCFG), 1))


@pytest.mark.parametrize("tag", ["2x2x2", "4x2"])
@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_one_device(name, tag):
    cfg = reduced(ARCHS[name])
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    want = _one_device(cfg, params, b)
    got = _sharded(cfg, params, b, _mesh(tag))
    _close(got, want, _lr(), f"{name} on {tag}")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)


def test_three_sharded_steps_track_one_device():
    cfg = reduced(ARCHS["smollm-360m"])
    ocfg = OptimizerConfig(**OCFG)
    params = init_params(cfg, device=CPU, seed=0)
    mesh = _mesh("2x2x2")
    p1, s1 = params, opt.init(params)
    p2, s2 = shard_train_state(params, opt.init(params), mesh)
    one, many = make_train_step(cfg, ocfg), make_sharded_train_step(
        cfg, ocfg, mesh)
    for i in range(3):
        b = _torch(_batch(cfg, seed=10 + i))
        p1, s1, m1 = one(p1, s1, b)
        p2, s2, m2 = many(p2, s2, b)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
    got, want = _flat((p2, s2)), _flat((p1, s1))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=PARAM_ATOL_LR * OCFG["lr"],
                                   err_msg=k)


# ------------------------------------------------------------ reference
REFERENCE = textwrap.dedent(
    """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec
    from repro.configs import ARCHS, reduced
    from repro.distributed import sharding
    from repro.train import (OptimizerConfig, make_loss_fn,
                             make_train_step, optimizer as opt)

    cfg = reduced(ARCHS["mistral-nemo-12b"])
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,)*3)
    params = {{}}
    with np.load({weights!r}) as z:
        for k in z.files:
            node = params
            *path, leaf = k.split("/")
            for n in path:
                node = node.setdefault(n, {{}})
            node[leaf] = jnp.asarray(z[k])
    ostate = opt.init(params)
    b = np.load({batch!r})
    batch = {{"tokens": jnp.asarray(b["tokens"]),
              "labels": jnp.asarray(b["labels"])}}
    p_specs = sharding.param_specs(params, mesh, fsdp=True)
    o_specs = opt.OptState(mu=p_specs, nu=p_specs, step=PartitionSpec())
    b_specs = sharding.data_specs(batch, mesh)
    ps = jax.device_put(params, sharding.make_sharding(p_specs, mesh))
    os_ = jax.device_put(ostate, sharding.make_sharding(o_specs, mesh))
    bs = jax.device_put(batch, sharding.make_sharding(b_specs, mesh))
    train_step = make_train_step(cfg, OptimizerConfig(**{ocfg!r}))

    def step_and_grads(params, ostate, batch):
        # the reference's step, and its gradients, in one compile
        (loss, _), grads = jax.value_and_grad(
            make_loss_fn(cfg), has_aux=True)(params, batch)
        return (*train_step(params, ostate, batch), loss, grads)

    step = jax.jit(step_and_grads,
                   in_shardings=(sharding.make_sharding(p_specs, mesh),
                                 sharding.make_sharding(o_specs, mesh),
                                 sharding.make_sharding(b_specs, mesh)))
    new_p, _, m, loss, grads = step(ps, os_, bs)
    out = {{"loss": np.asarray(loss), "step_loss": np.asarray(m["loss"]),
            "grad_norm": np.asarray(m["grad_norm"])}}
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for path, leaf in flat(grads):
        out["g/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    for path, leaf in flat(new_p):
        out["p/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    np.savez({path!r}, **out)
    print("REFERENCE DONE")
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's GSPMD step on the port's seeded weights."""
    d = tmp_path_factory.mktemp("sharded")
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    np.savez(d / "batch.npz", **_batch(cfg))
    np.savez(d / "weights.npz",
             **_flat(init_params(cfg, device=CPU, seed=0)))
    code = REFERENCE.format(batch=str(d / "batch.npz"), ocfg=OCFG,
                            weights=str(d / "weights.npz"),
                            path=str(d / "out.npz"))
    assert "REFERENCE DONE" in run_with_devices(code, 8)
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def test_sharded_step_matches_the_reference_sharded_step(ref):
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    params = init_params(cfg, device=CPU, seed=0)
    got = _sharded(cfg, params, _torch(_batch(cfg)), _mesh("2x2x2"))
    want = {"loss": float(ref["loss"]),
            "grads": {k[2:]: v for k, v in ref.items() if k[:2] == "g/"},
            "params": {k[2:]: v for k, v in ref.items() if k[:2] == "p/"}}
    assert float(ref["step_loss"]) == float(ref["loss"])
    _close(got, want, _lr(), "vs the reference's GSPMD step")
    np.testing.assert_allclose(got["grad_norm"], float(ref["grad_norm"]),
                               rtol=1e-5)


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("name,tag", [("smollm-360m", "4x2"),
                                      ("mistral-nemo-12b", "2x2x2")])
def test_dense_sharded_grads_are_the_per_shard_sum(name, tag):
    """A dense config's sharded loss and gradients, which these layouts run
    tensor-parallel: each batch shard's TP gradient (its row's
    ``row_value_and_grad`` on its rows with the global counts; a leaf split
    over "model" put together from the row's pieces, another summed over
    the row in order) summed over the batch shards in row-major order, bit
    for bit (MoE's global dispatch leaves this path alone)."""
    cfg = reduced(ARCHS[name])
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    (total, parts), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
    n = int(np.prod(MESHES[tag][0][:-1]))
    M = MESHES[tag][0][-1]
    rows = b["tokens"].shape[0] // n
    n_tok = torch.tensor(float(b["labels"].numel()))
    loss_fn = tstep._global_loss_fn(cfg, n_tok, n_tok, tstep._tp_terms(cfg))
    row = (torch.device(CPU),) * M
    totals, per = [], []
    for i in range(n):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
        with mesh_lib.tensor_parallel(row):
            (t, _), g = tstep.row_value_and_grad(
                loss_fn, tstep.row_pieces(ps, row), [part] * M)
        totals.append(t)

        def whole(p, *gs):
            dim = sh.split_dim(p.spec, "model")
            return (tstep._psum_list(gs) if dim is None
                    else torch.cat(gs, dim=dim))

        per.append(tree_map(whole, ps, *g))
    want_total = tstep._psum_list(totals)
    assert total.numpy().tobytes() == want_total.numpy().tobytes()
    assert float(parts["aux"]) == 0.0
    want = _flat(tree_map(lambda *gs: tstep._psum_list(gs), *per))
    for k, v in _flat(grads).items():
        assert v.tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v2-lite-16b"])
def test_moe_on_one_batch_shard_runs_and_matches(name):
    cfg = reduced(ARCHS[name])
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    mesh = _mesh("1x8")
    specs = sh.param_specs(params, mesh, fsdp=True)
    assert any("model" in s.mesh_axes() for s in _leaves(specs))
    _close(_sharded(cfg, params, b, mesh), _one_device(cfg, params, b),
           _lr(), f"{name} on 1x8")


# ----------------------------------------------------------- edge cases
def test_one_shard_mesh_is_the_one_device_step():
    cfg = reduced(ARCHS["smollm-360m"])
    mesh = Mesh(np.full((1, 1), CPU, object), ("data", "model"))
    params = init_params(cfg, device=CPU, seed=0)
    st = opt.init(params)
    ps, ss = shard_train_state(params, st, mesh)
    assert ps is params and ss is st                       # no copies
    b = _torch(_batch(cfg))
    got = make_sharded_train_step(cfg, OptimizerConfig(**OCFG), mesh)(
        ps, ss, b)
    want = make_train_step(cfg, OptimizerConfig(**OCFG))(params, st, b)
    for k, v in _flat(want[:2]).items():
        np.testing.assert_array_equal(_flat(got[:2])[k], v)


def test_sharded_step_leaves_its_inputs_alone():
    cfg = reduced(ARCHS["smollm-360m"])
    mesh = _mesh("4x2")
    params = init_params(cfg, device=CPU, seed=0)
    ps, st = shard_train_state(params, opt.init(params), mesh)
    before = {k: v.copy() for k, v in _flat((ps, st)).items()}
    make_sharded_train_step(cfg, OptimizerConfig(**OCFG), mesh)(
        ps, st, _torch(_batch(cfg)))
    for k, v in _flat((ps, st)).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_launch_train_model_axis_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--model-axis", "2", "--steps", "3",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "'data': 1, 'model': 1" in proc.stdout      # min(2, 1 device)
    assert "final_step': 3" in proc.stdout
    assert ckpt.all_steps(str(tmp_path)) == [3]


def test_train_mesh_is_the_references():
    m = launch_train.train_mesh(CPU, 4)
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == (
        "data", "model")


# ---------------------------------------------------------- checkpoints
def test_sharded_checkpoint_restores_in_the_reference_and_back(tmp_path):
    cfg = reduced(ARCHS["smollm-360m"])
    mesh = _mesh("2x2x2")
    params = init_params(cfg, device=CPU, seed=0)
    ps, st = shard_train_state(params, opt.init(params), mesh)
    ps, st, _ = make_sharded_train_step(cfg, OptimizerConfig(**OCFG),
                                        mesh)(ps, st, _torch(_batch(cfg)))
    want = _flat((ps, st))
    # the reference's templates: its trees, of its arrays
    ref_params = tree_map(lambda t: jnp.zeros(t.shape, jnp.float32),
                          params)
    ref_state = ref_opt.init(ref_params)
    ckpt.save(str(tmp_path / "port"), 1, (ps, st))
    (rp, rs), step, _ = ref_ckpt.restore(str(tmp_path / "port"),
                                         (ref_params, ref_state))
    assert step == 1
    got = _flat((jax.tree.map(np.asarray, rp), jax.tree.map(np.asarray,
                                                             rs)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # a checkpoint the reference writes, restored into sharded leaves
    rng = np.random.default_rng(7)
    rp2 = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), ref_params)
    rs2 = ref_opt.OptState(
        mu=jax.tree.map(lambda a: a * 0.5, rp2),
        nu=jax.tree.map(lambda a: a * a, rp2),
        step=jnp.asarray(5, jnp.int32))
    ref_ckpt.save(str(tmp_path / "ref"), 5, (rp2, rs2))
    (p3, s3), step, _ = ckpt.restore(str(tmp_path / "ref"), (ps, st))
    assert step == 5 and int(s3.step) == 5
    assert all(isinstance(x, sh.Sharded) for x in _leaves(p3))
    for x, like in zip(_leaves(p3), _leaves(ps)):
        assert x.spec == like.spec and x.pieces.shape == like.pieces.shape
    got = _flat((p3, s3))
    want = _flat((jax.tree.map(np.asarray, rp2), jax.tree.map(np.asarray,
                                                               rs2)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _runner_resumes(tmp_path, name):
    """A 4-step sharded run on (4, 2) with checkpoints every 2 steps, then
    a new runner resumed from its directory: the same state, bit for
    bit."""
    cfg = reduced(ARCHS[name])
    mesh = _mesh("4x2")
    params = init_params(cfg, device=CPU, seed=0)
    step = make_sharded_train_step(cfg, OptimizerConfig(**OCFG), mesh)

    def batches(start):
        s = start
        while True:
            yield _torch(_batch(cfg, seed=100 + s))
            s += 1

    def runner(max_steps):
        ps, st = shard_train_state(params, opt.init(params), mesh)
        return TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path),
                                        ckpt_every=2, max_steps=max_steps,
                                        log_every=100),
                           step, ps, st, log=lambda _: None)

    r = runner(4)
    r.run(batches(0))
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    full = _flat((r.params, r.opt_state))
    r2 = runner(4)
    assert r2.step == 4
    assert all(isinstance(x, sh.Sharded) for x in _leaves(r2.params))
    for k, v in _flat((r2.params, r2.opt_state)).items():
        np.testing.assert_array_equal(v, full[k], err_msg=k)


def test_runner_resumes_a_sharded_run(tmp_path):
    _runner_resumes(tmp_path, "smollm-360m")


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v2-lite-16b"])
def test_runner_resumes_a_moe_sharded_run(tmp_path, name):
    _runner_resumes(tmp_path, name)
