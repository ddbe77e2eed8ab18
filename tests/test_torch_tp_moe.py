"""Port vs reference: expert parallelism and MLA heads over "model" inside
each batch shard of the sharded train step (``train/train_step.py::
_tp_step`` for ``dbrx-132b`` and ``deepseek-v2-lite-16b``).

The reference's GSPMD step splits the experts over "model" (``moe.wg`` /
``wu`` / ``wo`` hold ``E/M`` whole experts a position, the router whole)
and MLA's heads (``wq`` column-split, ``w_uk`` / ``w_uv`` by heads, ``wo``
row-split, the latent projections whole). The port runs each batch shard's
row of positions on those pieces: ``moe.moe_apply_tp`` (every position
routes every token, runs its experts, ``all_reduce`` adds the partials),
``moe.moe_apply_a2a_tp`` (dbrx under the hint mesh: the all-to-all within
the row) and ``mla.mla_apply_tp``. Held here, for reduced dbrx and
deepseek:

* the step on (4, 2), (2, 2, 2), (2, 4) and (1, 8) CPU meshes against the
  port's one-device step, at ``tests/test_torch_train_sharded.py``'s bars
  (loss ``rtol=1e-5``; gradients ``rtol=1e-4, atol=1e-5 x max|g|`` per
  leaf; parameters after one step within ``0.5 x lr``; grad norm
  ``rtol=1e-5``), at the config's capacity and at 0.5, the routing of
  every MoE layer equal exactly and at least one drop at 0.5; (1, 8)
  leaves the 4 experts whole and cuts MLA through a head;
* the step, plain and under ``hint_mesh`` (dbrx's a2a), on (4, 2) and
  (2, 2, 2) against the reference's GSPMD step (one 8-device subprocess
  for the file), at the same bars;
* dbrx's a2a inside the row against the port's whole-leaf step under the
  same hint mesh (whole layers a batch shard), routing equal exactly;
* that the path is the TP one: no position receives a whole ``moe.wg`` /
  ``wu`` / ``wo``, ``w_uk``, ``w_uv`` or ``mla.wq``;
* remat on against off, bit for bit;
* ``moe_apply_tp``, ``moe_apply_a2a_tp`` and ``mla_apply_tp`` against
  their whole forms (``PIECE_RTOL`` / ``PIECE_ATOL``).

About 43 s alone on an 8-core host, 30 s of it the reference's
subprocess; 71 s in the tier-1 ``-n 6 --dist loadfile`` run (437 s in all).
"""
import contextlib
import textwrap

import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding as sh
from repro_torch.models import init_params, mla, moe
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
PIECE_RTOL, PIECE_ATOL = 1e-5, 1e-6      # one layer against its whole form
NAMES = ["dbrx-132b", "deepseek-v2-lite-16b"]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model"))}
CAPACITY = {"config": None, "half": 0.5}
# the layers' splits on each mesh: (moe_apply_tp's, mla_apply_tp's)
SPLITS = {"1x8": ({"whole layer"}, {"through a head"})}
ROW_SPLITS = ({"experts over the row"}, {"whole heads"})
# plain and hinted on both meshes (the plain step of either config on
# either mesh is also ``tests/test_torch_train_moe_sharded.py``'s)
REF_CASES = [("dbrx-132b", "4x2", False), ("dbrx-132b", "4x2", True),
             ("dbrx-132b", "2x2x2", True),
             ("deepseek-v2-lite-16b", "2x2x2", False)]


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    torch.set_num_threads(1)
    moe.tp_splits.clear()
    mla.tp_splits.clear()
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _cfg(name, cap="config"):
    cfg = reduced(ARCHS[name])
    cf = CAPACITY[cap]
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


def _mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _n_batch_shards(tag):
    return int(np.prod(MESHES[tag][0][:-1]))


def _hinted(mesh, on: bool):
    return sh.hint_mesh(mesh) if on else contextlib.nullcontext()


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


def _same_routes(got, want, what):
    for key in ("expert", "keep", "slot"):
        assert len(got[key]) == len(want[key]) > 0, what
        for g, w in zip(got[key], want[key]):
            assert torch.equal(g, w), f"{what}: {key}"


def _one_device(cfg, params, b):
    with moe.recording_routes() as routes:
        (total, _), grads = value_and_grad(make_loss_fn(cfg), params, b)
    new_p, _, m = make_train_step(cfg, OptimizerConfig(**OCFG))(
        params, opt.init(params), b)
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p), "grad_norm": float(m["grad_norm"]),
            "routes": _by_layer(routes, 1)}


def _strip_model(specs):
    """``specs`` with "model" taken out: the whole-leaf layout."""
    if isinstance(specs, dict):
        return {k: _strip_model(v) for k, v in specs.items()}
    return sh.P(*(None if e == sh.TP else e for e in specs))


def _sharded(cfg, params, b, tag, hinted=False, tp=True):
    """The sharded step's loss, gradients, parameters after one step and
    grad norm; ``tp=False`` places the leaves without "model" (the
    whole-leaf step)."""
    mesh = _mesh(tag)
    specs = sh.param_specs(params, mesh)
    if not tp:
        specs = _strip_model(specs)
    ps, st = shard_train_state(params, opt.init(params), mesh, specs)
    assert tstep._tp_applies(cfg, mesh, ps, False) is tp
    with _hinted(mesh, hinted):
        with moe.recording_routes() as routes:
            (total, parts), grads = make_sharded_value_and_grad(cfg, mesh)(
                ps, b)
        new_p, new_s, m = make_sharded_train_step(
            cfg, OptimizerConfig(**OCFG), mesh)(ps, st, b)
    assert float(m["loss"]) == float(total) and int(new_s.step) == 1
    assert float(m["aux"]) == float(parts["aux"]) > 0
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p), "grad_norm": float(m["grad_norm"]),
            "routes": _by_layer(routes, _n_batch_shards(tag))}


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_tp_moe_step_matches_one_device(name, tag, cap):
    cfg = _cfg(name, cap)
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    what = f"{name} on {tag}, capacity {cap}"
    want = _one_device(cfg, params, b)
    got = _sharded(cfg, params, b, tag)
    _close(got, want, what)
    _same_routes(got["routes"], want["routes"], what)
    if cap == "half":
        assert sum(int((~k).sum()) for k in want["routes"]["keep"]) > 0, (
            f"{what}: no drop")
    moe_splits, mla_splits = SPLITS.get(tag, ROW_SPLITS)
    assert set(moe.tp_splits) == moe_splits, what
    assert set(mla.tp_splits) == (mla_splits if cfg.mla else set()), what


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("tag", ["4x2", "2x2x2", "2x4"])
def test_a2a_in_the_row_matches_the_whole_leaf_a2a(tag, cap):
    """dbrx under the hint mesh: the a2a inside each row of positions
    against the port's whole-leaf step (whole layers a batch shard) under
    the same mesh, whose a2a exchanges among the batch shard's ranks on
    slices of the whole weights."""
    cfg = _cfg("dbrx-132b", cap)
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    what = f"dbrx's a2a on {tag}, capacity {cap}"
    want = _sharded(cfg, params, b, tag, hinted=True, tp=False)
    moe.tp_splits.clear()
    got = _sharded(cfg, params, b, tag, hinted=True)
    assert set(moe.tp_splits) == {"a2a in the row"}
    _close(got, want, what)
    _same_routes(got["routes"], want["routes"], what)
    if cap == "half":
        assert sum(int((~k).sum()) for k in want["routes"]["keep"]) > 0, (
            f"{what}: no drop")


@pytest.mark.parametrize("name,tag,hinted", [
    ("dbrx-132b", "4x2", True), ("dbrx-132b", "2x4", False),
    ("deepseek-v2-lite-16b", "2x4", False),
    ("deepseek-v2-lite-16b", "2x2x2", True)])
def test_no_position_receives_a_whole_expert_or_head_leaf(name, tag, hinted,
                                                          monkeypatch):
    """Every "model"-split leaf reaches each position as its piece (a
    ``1 / model`` slice of the split dim), the experts' and MLA's
    head-split leaves among them: no position gathers a whole
    ``moe.wg`` / ``wu`` / ``wo``, ``w_uk``, ``w_uv`` or ``mla.wq``."""
    cfg = _cfg(name)
    mesh = _mesh(tag)
    M = mesh.shape["model"]
    params = init_params(cfg, device=CPU, seed=0)
    specs = sh.param_specs(params, mesh)
    blocks = specs["blocks"]
    kept = [blocks["moe"][k] for k in ("wg", "wu", "wo")]
    if cfg.mla:
        kept += [blocks["mla"][k] for k in ("wq", "w_uk", "w_uv")]
    assert all(sh.split_dim(s, "model") is not None for s in kept)
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    seen = []
    gather = sh.gather

    def spy_gather(leaf, device=None, index=None):
        out = gather(leaf, device, index)
        seen.append((leaf.spec, tuple(leaf.shape), index, tuple(out.shape)))
        return out

    gather_layer = sh.gather_layer

    def spy_gather_layer(leaf, i, device=None, index=None):
        # a stacked leaf's layer, with its layer axis put back
        out = gather_layer(leaf, i, device, index)
        seen.append((leaf.spec, tuple(leaf.shape), index,
                     (leaf.shape[0],) + tuple(out.shape)))
        return out

    monkeypatch.setattr(sh, "gather", spy_gather)
    monkeypatch.setattr(sh, "gather_layer", spy_gather_layer)
    with _hinted(mesh, hinted):
        make_sharded_value_and_grad(cfg, mesh)(ps, _torch(_batch(cfg)))
    assert seen and all(index is not None for _, _, index, _ in seen)
    for spec in kept:
        assert any(s == spec for s, _, _, _ in seen), spec
    for spec, whole, index, got in seen:
        want = list(whole)
        dim = sh.split_dim(spec, "model")
        if dim is not None:
            want[dim] //= M
        assert got == tuple(want), (spec, whole, index, got)


@pytest.mark.parametrize("name,hinted", [("dbrx-132b", False),
                                         ("dbrx-132b", True),
                                         ("deepseek-v2-lite-16b", False)])
def test_tp_moe_step_with_remat_equals_without_bit_for_bit(name, hinted):
    """A checkpointed block's recompute re-enters its row and its row's
    dispatch: the step with remat is the step without it, bit for bit."""
    base = _cfg(name)
    params = init_params(base, device=CPU, seed=0)
    b = _torch(_batch(base))
    mesh = _mesh("2x2x2")
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    out = {}
    for remat in (True, False):
        cfg = base.replace(remat=remat, scan_layers=True)
        with _hinted(mesh, hinted):
            (total, _), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
        out[remat] = (total, _flat(grads))
    assert out[True][0].numpy().tobytes() == out[False][0].numpy().tobytes()
    for k, v in out[False][1].items():
        assert out[True][1][k].tobytes() == v.tobytes(), k


# ------------------------------------------------------------ reference
REFERENCE = textwrap.dedent(
    """
    import contextlib
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
    for name, tag, shape, names, hinted in {cases!r}:
        cfg = reduced(ARCHS[name])
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
            with (sharding.hint_mesh(mesh) if hinted
                  else contextlib.nullcontext()):
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
        key = f"{{name}}|{{tag}}|{{hinted}}|"
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
    """The reference's GSPMD step on the port's seeded weights, plain and
    under ``hint_mesh``, all cases in one subprocess."""
    d = tmp_path_factory.mktemp("tp_moe")
    weights, batches = {}, {}
    for name in NAMES:
        cfg = _cfg(name)
        weights[name] = str(d / f"{name}-weights.npz")
        batches[name] = str(d / f"{name}-batch.npz")
        np.savez(weights[name],
                 **_flat(init_params(cfg, device=CPU, seed=0)))
        np.savez(batches[name], **_batch(cfg))
    cases = [(n, t, MESHES[t][0], MESHES[t][1], h) for n, t, h in REF_CASES]
    code = REFERENCE.format(cases=cases, weights=weights, batches=batches,
                            ocfg=OCFG, path=str(d / "out.npz"))
    assert "REFERENCE DONE" in run_with_devices(code, 8)
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,tag,hinted", REF_CASES)
def test_tp_moe_step_matches_the_reference(ref, name, tag, hinted):
    cfg = _cfg(name)
    params = init_params(cfg, device=CPU, seed=0)
    got = _sharded(cfg, params, _torch(_batch(cfg)), tag, hinted=hinted)
    if hinted:
        assert set(moe.tp_splits) == {"a2a in the row"}
    key = f"{name}|{tag}|{hinted}|"
    r = {k[len(key):]: v for k, v in ref.items() if k.startswith(key)}
    assert float(r["step_loss"]) == float(r["loss"])
    want = {"loss": float(r["loss"]), "grad_norm": float(r["grad_norm"]),
            "grads": {k[2:]: v for k, v in r.items() if k[:2] == "g/"},
            "params": {k[2:]: v for k, v in r.items() if k[:2] == "p/"}}
    _close(got, want, f"{name} on {tag}, hinted {hinted}: vs the reference")


# ------------------------------------------------------------- pieces
def _row(m):
    return tuple(torch.device(CPU) for _ in range(m))


def _per_position(tree, m, dims):
    """One tree per position: a leaf whose path ends in a key of ``dims``
    cut into ``m`` pieces along that dim, the others whole."""
    def cut(path, t, j):
        for suffix, d in dims.items():
            if path[-len(suffix):] == suffix:
                return torch.chunk(t, m, dim=d)[j]
        return t

    return [sh._map_with_path(lambda path, t: cut(path, t, j), tree)
            for j in range(m)]


# longest suffix first: the shared experts' leaves end in "wg" too
MOE_DIMS = {("shared", "wg"): 1, ("shared", "wu"): 1, ("shared", "wo"): 0,
            ("wg",): 0, ("wu",): 0, ("wo",): 0}
MLA_DIMS = {("wq",): 1, ("w_uk",): 1, ("w_uv",): 1, ("wo",): 0}


def _x(cfg, seed, B=2, S=16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=g)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_moe_over_a_row_equals_the_whole_moe(name, m):
    cfg = _cfg(name)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = _x(cfg, 3)
    want, aux_w = moe.moe_apply(cfg, p, x)
    with mesh_lib.tensor_parallel(_row(m)):
        got, aux_g = moe.moe_apply_tp(cfg, _per_position(p, m, MOE_DIMS),
                                      [x] * m)
    assert moe.tp_splits == {"experts over the row": 1}
    torch.testing.assert_close(aux_g, aux_w, rtol=PIECE_RTOL,
                               atol=PIECE_ATOL)
    for g in got:
        torch.testing.assert_close(g, want, rtol=PIECE_RTOL, atol=PIECE_ATOL)


@pytest.mark.parametrize("m", [2, 4])
def test_a2a_over_a_row_equals_the_whole_leaf_a2a(m):
    """``moe_apply_a2a_tp`` on the row's pieces against ``moe_apply_a2a``
    on the whole weights over a (1, m) mesh: the same exchange."""
    cfg = _cfg("dbrx-132b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = _x(cfg, 4)
    mesh = Mesh(np.full((1, m), CPU, dtype=object), ("data", "model"))
    want, aux_w = moe.moe_apply_a2a(cfg, p, x, mesh)
    with mesh_lib.tensor_parallel(_row(m)):
        got, aux_g = moe.moe_apply_a2a_tp(
            cfg, _per_position(p, m, MOE_DIMS), [x] * m, mesh)
    assert moe.tp_splits == {"a2a in the row": 1}
    torch.testing.assert_close(aux_g, aux_w, rtol=PIECE_RTOL,
                               atol=PIECE_ATOL)
    for g in got:
        torch.testing.assert_close(g, want, rtol=PIECE_RTOL, atol=PIECE_ATOL)


@pytest.mark.parametrize("m,path", [(2, "whole heads"), (4, "whole heads"),
                                    (8, "through a head")])
def test_mla_over_a_row_equals_the_whole_mla(m, path):
    cfg = _cfg("deepseek-v2-lite-16b")
    p = mla.mla_init(torch.Generator().manual_seed(0), cfg)
    x = _x(cfg, 5)
    pos = torch.arange(x.shape[1])
    want = mla.mla_apply(cfg, p, x, pos)
    with mesh_lib.tensor_parallel(_row(m)):
        got = mla.mla_apply_tp(cfg, _per_position(p, m, MLA_DIMS), [x] * m,
                               [pos] * m)
    assert mla.tp_splits == {path: 1}
    for g in got:
        torch.testing.assert_close(g, want, rtol=PIECE_RTOL, atol=PIECE_ATOL)
