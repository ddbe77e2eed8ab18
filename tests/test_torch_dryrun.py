"""The port's dry run (``launch/dryrun.py``) and what it stands on: the
sharded prefill and decode steps, the collective byte counter
(``distributed/collectives.py::counting``) and the position identity of a
mesh whose positions share one fake device (``distributed/mesh.py``).

The twins of ``tests/test_dryrun_machinery.py``'s four tests (the sharding
rules cover the ten archs; the sharded train cell equals the one-device
step, the reference's bar ``rtol=2e-3``; the sharded decode and prefill
cells, here on real CPU tensors, equal the one-device functions; the
collective count on a known program), plus: the accounting's peak on a
known chain of allocations, remat lowering a train cell's counted peak, a
cell's JSON keys, the skipped ``long_500k`` cells, ``--skip-existing``, an
STKDE cell and that fake mode allocates nothing
(``tests/test_torch_dryrun_positions.py`` holds the position identity to
the count with each position on its own ``meta:k`` device).
"""
import json
import resource

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill

from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh, collectives
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.transformer import leaves
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt

CPU = "cpu"
META = torch.device("meta")
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
DECODE_ARCHS = ["mistral-nemo-12b", "rwkv6-3b", "zamba2-7b",
                "deepseek-v2-lite-16b"]
REF_KEYS = {"arch", "shape", "mesh", "ok", "chips", "memory", "fits_hbm",
            "cost", "collectives", "model_flops", "algo_flops",
            "algo_hbm_bytes", "roofline", "roofline_raw_hlo"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "temp_per_device"}
COLL_KEYS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "total", "n_ops"}


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _cpu_mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _position_mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, META, dtype=object), names, positions=True)


def _device_mesh(tag):
    """Each position on its own fake device ``meta:k`` (row-major)."""
    shape, names = MESHES[tag]
    devs = np.empty(int(np.prod(shape)), dtype=object)
    for k in range(devs.size):
        devs[k] = torch.device("meta", k)
    return Mesh(devs.reshape(shape), names)


# ---------------------------------------------------- reference's four
@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharding_rules_cover_all_archs(multi_pod):
    """Every leaf of every full-size config gets a spec whose axes divide
    its dims on the production mesh (the training layouts: ``param_specs``
    and, for an ``fsdp`` config, ``fsdp_only_param_specs``), and so do the
    reduced configs on (2, 2, 2)."""
    prod = make_production_mesh(multi_pod=multi_pod, device=META)
    small = _cpu_mesh("2x2x2")
    for name, full in ARCHS.items():
        for cfg, mesh in ((full, prod), (reduced(full), small)):
            params = specs.param_specs_abstract(cfg)
            for sp in (dryrun._train_state_specs(cfg, params, mesh),
                       sh.param_specs(params, mesh, fsdp=False)):
                specs_l = list(_spec_leaves(sp))
                arrs = list(leaves(params))
                assert len(specs_l) == len(arrs), name
                for arr, spec in zip(arrs, specs_l):
                    for i, ax in enumerate(spec):
                        size = int(np.prod([mesh.shape[a]
                                            for a in sh.P.axes_of(ax)]))
                        assert arr.shape[i] % size == 0, (name, spec)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


def _batch(cfg, B=8, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, 1))}


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "smollm-360m"])
def test_train_cell_is_numerically_the_one_device_step(name):
    """``build_train`` over (2, 2, 2) on real CPU tensors against
    ``make_train_step`` (mistral: ``param_specs``; smollm, an ``fsdp``
    config: ``fsdp_only_param_specs`` and the batch over the model axis
    too): the loss within 1e-3, the parameters within the reference's
    ``rtol=atol=2e-3``."""
    cfg = reduced(ARCHS[name])
    mesh = _cpu_mesh("2x2x2")
    params = init_params(cfg, device=CPU, seed=0)
    b = _batch(cfg)
    cell = dryrun.build_train(cfg, mesh,
                              specs.ShapeCell("t", "train", 32, 8))
    p_ref, _, m_ref = make_train_step(
        cfg, OptimizerConfig(total_steps=10_000))(params, opt.init(params), b)
    p_sh, _, m_sh = cell.fn(*cell.place(params, opt.init(params), b))
    assert abs(float(m_ref["loss"]) - float(m_sh["loss"])) < 1e-3
    for a, w in zip(leaves(sh.gather_tree(p_sh)), leaves(p_ref),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-3)


def _state_close(got, want):
    for a, w in zip(_state_tensors(sh.gather_tree(got)),
                    _state_tensors(want), strict=True):
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _state_tensors(state):
    for part in (state.layer, state.shared, state.cross):
        if part is not None:
            yield from (t for t in _all(part) if isinstance(t, torch.Tensor))


def _all(tree):
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _all(v)
    else:
        yield tree


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_and_prefill_cells_are_the_one_device_functions(name):
    """``build_prefill`` (8 prompts of 16 tokens, a cache of 24) and then
    four ``build_decode`` steps over (4, 2) on real CPU tensors, against
    the one-device ``prefill`` and ``decode_step`` (logits and the
    gathered state ``rtol=1e-5, atol=1e-6``; deepseek's MoE under the
    global dispatch), and the prefill against the reference's one-device
    prefill on the same weights (``rtol=1e-4``)."""
    ref_cfg = ref_reduced(REF_ARCHS[name])
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), device=CPU)
    cfg = reduced(ARCHS[name])
    mesh = _cpu_mesh("4x2")
    toks = _batch(cfg, B=8, S=20)["tokens"].long()
    pre = dryrun.build_prefill(cfg, mesh,
                               specs.ShapeCell("p", "prefill", 16, 8))
    step = dryrun.sharded_prefill(cfg, mesh, 24, dryrun._decode_state_specs(
        cfg, 8, 24, torch.float32, mesh))
    p_sh, inputs = pre.place(params, {"tokens": toks[:, :16]})
    got16, _ = pre.fn(p_sh, inputs)
    want16, _ = prefill(cfg, params, toks[:, :16], 16)
    np.testing.assert_allclose(got16.numpy(), want16.numpy(), rtol=1e-5,
                               atol=1e-6)
    ref16, _ = ref_prefill(ref_cfg, ref_params,
                           jax.numpy.asarray(toks[:, :16].numpy()), 16)
    np.testing.assert_allclose(got16.numpy(), np.asarray(ref16), rtol=1e-4,
                               atol=1e-5)

    got, state = step(p_sh, inputs)
    want, want_state = prefill(cfg, params, toks[:, :16], 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    _state_close(state, want_state)
    dec = dryrun.build_decode(cfg, mesh,
                              specs.ShapeCell("d", "decode", 24, 8))
    p_dec, state, _ = dec.place(params, sh.gather_tree(state),
                                toks[:, 16:17])
    for t in range(16, 20):
        got, state = dec.fn(p_dec, state, toks[:, t:t + 1])
        want, want_state = decode_step(cfg, params, toks[:, t:t + 1],
                                       want_state)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name} step {t}")
    _state_close(state, want_state)


def test_collective_counter_on_a_known_program():
    """psum over "model", all_gather of column 0, all_to_all over "model"
    and ppermute +1 over "data" of (16,) fp32 pieces (64 bytes) on a (4, 2)
    mesh, under the accounting's fake mode: each position on its own
    device, and all on one device with the position identity. Worked by
    hand, position (0, 0) receives most: 64 (all-reduce, from (0, 1)) +
    3 x 64 (all-gather) + 32 (all-to-all: half a piece from (0, 1)) = 288
    bytes; nobody sends to row 0 by ppermute; every position receives
    something."""
    def program(mesh):
        def run(x):
            devs = mesh.devices
            pieces = np.empty((4, 2), dtype=object)
            for idx in np.ndindex(4, 2):
                pieces[idx] = x.to(devs[idx], copy=True)
            collectives.psum(pieces, 1)
            collectives.all_gather(pieces[:, 0], 0)
            send = np.empty((4, 2), dtype=object)
            for idx in np.ndindex(4, 2):
                send[idx] = pieces[idx].reshape(2, 8)
            collectives.all_to_all(send, 1)
            collectives.ppermute(pieces, devs, 0, 1)
        return run

    want = {"all-reduce": 64.0, "all-gather": 192.0, "reduce-scatter": 0.0,
            "all-to-all": 32.0, "collective-permute": 0.0, "total": 288.0,
            "n_ops": 4, "receivers": 8}
    for make in (_device_mesh, _position_mesh):
        mesh = make("4x2")
        acc = dryrun.account(program(mesh), torch.empty(16), mesh=mesh)
        assert acc["collectives"] == want, make
    # no counter open: nothing is counted, nothing breaks
    with torch.device("cpu"):
        program(_cpu_mesh("4x2"))(torch.zeros(16))


# ------------------------------------------------------------ accounting
def test_tracker_peak_on_a_known_chain_is_exact():
    """x (1000 fp32) in; a = 2x, b = a + 1 (12,000 bytes live), a freed;
    a view of b (no bytes), z = 0 x the view, c = the sum of z: the
    high-water mark is x + b + z + c = 12,004 bytes, the output c's 4."""
    def chain(x):
        a = x * 2
        b = a + 1
        del a
        v = b.view(10, 100)
        return (v * 0).sum()

    acc = dryrun.account(chain, torch.empty(1000))
    m = acc["memory"]
    assert m["argument_size_in_bytes"] == 4000
    assert m["peak_bytes"] == 12004 and m["temp_size_in_bytes"] == 8004
    assert m["output_size_in_bytes"] == 4
    assert acc["cost"]["flops"] == 0


def test_flops_are_the_matmul_familys():
    acc = dryrun.account(lambda a, b: a @ b, torch.empty(64, 32),
                         torch.empty(32, 16))
    assert acc["cost"]["flops"] == 2 * 64 * 32 * 16
    assert acc["cost"]["bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)


def _train_peak(cfg, S):
    params = specs.param_specs_abstract(cfg)
    state = opt.OptState(mu=params, nu=params,
                         step=torch.empty((), dtype=torch.int32, device=META))
    b = specs.train_input_specs(cfg, specs.ShapeCell("t", "train", S, 2))
    return dryrun.account(make_train_step(cfg, OptimizerConfig()), params,
                          state, b)["memory"]


def test_remat_lowers_a_train_cells_counted_peak():
    """Reduced mistral-nemo at 6 layers and 1,024 tokens: with remat the
    step keeps the blocks' inputs and one block's recompute."""
    cfg = reduced(ARCHS["mistral-nemo-12b"]).replace(n_layers=6)
    with_remat = _train_peak(cfg.replace(remat=True), 1024)
    without = _train_peak(cfg, 1024)
    assert with_remat["argument_size_in_bytes"] == \
        without["argument_size_in_bytes"]
    assert with_remat["temp_size_in_bytes"] < \
        0.6 * without["temp_size_in_bytes"], (with_remat, without)


def test_fake_mode_allocates_nothing():
    """A 16 GiB product of two 16 GiB operands is counted (48 GiB at the
    peak) while the process grows by far less, and no card is touched."""
    n = 1 << 16
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    acc = dryrun.account(lambda a, b: a @ b, torch.empty(n, n, device=META),
                         torch.empty(n, n, device=META))
    grew = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024
    assert acc["memory"]["peak_bytes"] == 3 * 4 * n * n
    assert grew < (1 << 30)
    assert not torch.cuda.is_initialized()


# ------------------------------------------------------------ cells
def _small_cell(tmp_path, **kw):
    return dryrun.run_cell(
        "smollm-360m", "train_4k", "single", str(tmp_path),
        cfg=reduced(ARCHS["smollm-360m"]).replace(remat=True),
        shape=specs.ShapeCell("train_4k", "train", 32, 8),
        mesh=_position_mesh("4x2"), **kw)


def test_cell_json_has_the_references_keys(tmp_path):
    r = _small_cell(tmp_path, delta=True)
    assert r["ok"] and REF_KEYS <= set(r) and "delta" in r
    assert MEMORY_KEYS <= set(r["memory"])
    assert {"flops", "bytes"} <= set(r["cost"])
    assert COLL_KEYS <= set(r["collectives"])
    assert r["chips"] == 8 and r["fits_hbm"] is True
    path = tmp_path / "single" / "smollm-360m__train_4k.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(r))
    # the unrolled loops count every layer: the shallow twins extrapolate
    # to the full count
    assert r["delta"]["rel_err_vs_full"]["flops"] < 1e-9
    assert r["roofline_raw_hlo"]["flops"] == r["cost"]["flops"]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_long_500k_is_skipped_for_full_attention_archs(name, tmp_path):
    cfg = ARCHS[name]
    if cfg.sub_quadratic:
        ok, _ = specs.cell_applicable(cfg, specs.SHAPES["long_500k"])
        assert ok
        return
    r = dryrun.run_cell(name, "long_500k", "single", str(tmp_path))
    assert r["ok"] and r["skipped"] and "full-attention" in r["reason"]


def test_skip_existing_resumes(tmp_path):
    """``--skip-existing`` keeps the cells written (full-size ones here,
    which would take many minutes) and runs the missing ones."""
    kept = []
    for name in ("smollm-360m", "mistral-nemo-12b"):
        done = tmp_path / "single" / f"{name}__train_4k.json"
        done.parent.mkdir(parents=True, exist_ok=True)
        done.write_text(json.dumps({"arch": name, "ok": True, "marker": 1}))
        kept.append(done)
    rc = dryrun.main(["--arch", "smollm-360m", "mistral-nemo-12b",
                      "--shape", "train_4k", "long_500k", "--mesh", "single",
                      "--out", str(tmp_path), "--skip-existing"])
    assert rc == 0
    assert all(json.loads(p.read_text())["marker"] == 1 for p in kept)
    for name in ("smollm-360m", "mistral-nemo-12b"):
        r = json.loads((tmp_path / "single" /
                        f"{name}__long_500k.json").read_text())
        assert r["ok"] and r["skipped"]


def test_stkde_cell_on_a_small_instance(tmp_path):
    """``pd`` and ``dd`` at ``Dengue_Lr-Lb`` on a (4, 2) mesh of positions:
    the reference's bucket shapes and ``cap`` formula, no point made."""
    mesh = _position_mesh("4x2")
    for strat in ("pd", "dd", "pd_xt"):
        r = dryrun.run_stkde_cell("Dengue_Lr-Lb", strat, "single",
                                  str(tmp_path), mesh=mesh)
        assert r["ok"] and r["cap"] == 5528, r
        assert r["memory"]["peak_bytes"] > 0 and r["cost"]["bytes"] > 0
    assert r["collectives"]["collective-permute"] > 0      # pd_xt's halos
