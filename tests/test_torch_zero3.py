"""ZeRO-3 in the port's sharded train step
(``train/train_step.py::_zero3_step``, ``distributed/sharding.py::Zero3``).

Every sharded train step path (the tensor-parallel rows, the whole-leaf
shards, and both MoE forms) gathers the stacked blocks' leaves over "data"
one layer at a time, inside each block (and again in its recompute under
remat), and cuts each layer's gradient into the pieces as backward makes
it, as GSPMD compiles the reference's scanned step. Held here on CPU
meshes:

* the dense tensor-parallel and whole-leaf steps, remat on and off, on two
  meshes each, equal bit for bit to the gather-everything oracle: each
  batch shard's gradients on leaves gathered whole over "data", summed
  over the shards in row-major order (a leaf not split over "model" first
  summed over its row in order);
* no stacked leaf is gathered whole; each block's leaves are gathered once
  a forward (twice under remat: the recompute gathers again); each stacked
  leaf's gradient is cut once per layer and batch shard;
* the counted peak of a position (``launch.dryrun.account``) grows by less
  than one gathered layer's weights plus gradients per added layer;
* the MoE steps within their bars against the one-device step, and equal
  bit for bit from run to run;
* ``collectives.reduce_scatter_into`` member by member is
  ``collectives.reduce_scatter``, bit for bit; a layer (a leaf) that no
  gradient reaches comes back as zeros.

About 25 s alone; the port only, no reference subprocess.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh, collectives
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs
from repro_torch.models import init_params
from repro_torch.models.transformer import STACKED, leaves, tree_map
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as tstep
from repro_torch.train.train_step import (
    make_sharded_train_step, make_sharded_value_and_grad, shard_train_state,
)

CPU = "cpu"
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
PARAM_ATOL_LR = 0.5
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4": ((4,), ("data",))}
# (config, mesh, path): "tp" the rows, "whole" an fsdp config's layout
# (fsdp_only_param_specs, the batch split over "model" too)
DENSE = [("mistral-nemo-12b", "2x2x2", "tp"),
         ("mistral-nemo-12b", "4x2", "tp"),
         ("smollm-360m", "4x2", "whole"), ("smollm-360m", "2x2x2", "whole"),
         ("zamba2-7b", "4x2", "whole")]


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    torch.set_num_threads(1)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _mesh(tag, device=CPU, positions=False):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, torch.device(device), dtype=object), names,
                positions=positions)


def _batch(cfg, B=8, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, 1))}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    t = sh.gather(tree) if isinstance(tree, sh.Sharded) else tree
    return {prefix[:-1]: t.detach().numpy()}


def _placed(name, tag, path, remat=None, **cut):
    cfg = reduced(ARCHS[name]).replace(**cut)
    if remat is not None:
        cfg = cfg.replace(remat=remat, scan_layers=True)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    specs_ = (sh.fsdp_only_param_specs(params, mesh) if path == "whole"
              else sh.param_specs(params, mesh, fsdp=True))
    ps, st = shard_train_state(params, opt.init(params), mesh, specs_)
    return cfg, mesh, params, ps, st


def _oracle(cfg, mesh, ps, b, path):
    """The gather-everything step: each batch shard's loss and gradients on
    leaves gathered whole over "data" (each position's "model" piece on a
    row), the shards summed in row-major order."""
    spec = sh.data_specs({"t": b["tokens"]}, mesh,
                         include_model=path == "whole")["t"]
    n = int(np.prod([mesh.shape[a] for a in sh.P.axes_of(spec[0])]))
    rows = b["tokens"].shape[0] // n
    n_tok = torch.tensor(float(b["labels"].numel()))
    totals, per = [], []
    for i in range(n):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
        if path == "whole":
            (t, _), g = tstep.value_and_grad(
                tstep._global_loss_fn(cfg, n_tok, n_tok),
                tree_map(sh.gather, ps), part)
        else:
            M = mesh.shape["model"]
            row = (torch.device(CPU),) * M
            with mesh_lib.tensor_parallel(row):
                (t, _), gs = tstep.row_value_and_grad(
                    tstep._global_loss_fn(cfg, n_tok, n_tok,
                                          tstep._tp_terms(cfg)),
                    tstep.row_pieces(ps, row), [part] * M)

            def whole(p, *g):
                dim = sh.split_dim(p.spec, "model")
                return (tstep._psum_list(g) if dim is None
                        else torch.cat(g, dim=dim))

            g = tree_map(whole, ps, *gs)
        totals.append(t)
        per.append(g)
    return (tstep._psum_list(totals),
            _flat(tree_map(lambda *gs: tstep._psum_list(gs), *per)))


def _vag(cfg, mesh, path):
    return make_sharded_value_and_grad(cfg, mesh,
                                       batch_over_model=path == "whole")


# -------------------------------------------------------- bit for bit
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name,tag,path", DENSE)
def test_step_is_the_gather_everything_oracle_bit_for_bit(name, tag, path,
                                                          remat):
    cfg, mesh, _, ps, _ = _placed(name, tag, path, remat)
    assert tstep._tp_applies(cfg, mesh, ps, path == "whole") is (
        path == "tp")
    b = _batch(cfg)
    (total, _), grads = _vag(cfg, mesh, path)(ps, b)
    want_total, want = _oracle(cfg, mesh, ps, b, path)
    assert total.numpy().tobytes() == want_total.numpy().tobytes()
    got = _flat(grads)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.tobytes() == want[k].tobytes(), k


# ------------------------------------------------ what is gathered and cut
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name,tag,path", [DENSE[1], DENSE[2]])
def test_blocks_gather_their_layer_and_cut_its_gradient(name, tag, path,
                                                        remat, monkeypatch):
    """No stacked leaf is gathered whole; each stacked leaf's layer is
    gathered onto each position of each batch shard once a forward, and
    once more by the recompute under remat; each stacked leaf's gradient
    is cut once per layer and batch shard, every other leaf's once per
    batch shard (``collectives.counting``'s reduce-scatter calls)."""
    cfg, mesh, _, ps, _ = _placed(name, tag, path, remat)
    stacked = {id(p) for k in STACKED if k in ps for p in leaves(ps[k])}
    n_other = sum(1 for k in ps if k not in STACKED for _ in leaves(ps[k]))
    L = cfg.n_layers
    shards = mesh.size // (mesh.shape["model"] if path == "tp" else 1)
    per_shard = mesh.shape["model"] if path == "tp" else 1
    whole, by_layer, cuts = [], {}, {}
    gather, gather_layer, add = sh.gather, sh.gather_layer, sh._Sums.add

    def spy_gather(leaf, device=None, index=None):
        whole.append(id(leaf))
        return gather(leaf, device, index)

    def spy_gather_layer(leaf, i, device=None, index=None):
        key = (id(leaf), i)
        by_layer[key] = by_layer.get(key, 0) + 1
        return gather_layer(leaf, i, device, index)

    def spy_add(self, layer, targets, grads):
        key = (id(self.leaf), layer)
        cuts[key] = cuts.get(key, 0) + 1
        return add(self, layer, targets, grads)

    monkeypatch.setattr(sh, "gather", spy_gather)
    monkeypatch.setattr(sh, "gather_layer", spy_gather_layer)
    monkeypatch.setattr(sh._Sums, "add", spy_add)
    with collectives.counting() as count:
        _vag(cfg, mesh, path)(ps, _batch(cfg))
    assert stacked and not stacked & set(whole)
    want = shards * per_shard * (2 if remat else 1)
    assert by_layer == {(k, i): want for k in stacked for i in range(L)}
    assert {k for k, _ in by_layer} == stacked
    assert all(cuts[(k, i)] == shards for k in stacked for i in range(L))
    assert len(cuts) == len(stacked) * L + n_other
    assert set(cuts.values()) == {shards}
    assert count.calls["reduce-scatter"] == shards * len(cuts)


# ------------------------------------------------------------ the peak
@pytest.mark.parametrize("name,tag,path", [("mistral-nemo-12b", "2x4", "tp"),
                                           ("smollm-360m", "4x2", "whole")])
def test_peak_grows_by_less_than_a_gathered_layer(name, tag, path):
    """``dryrun.account`` of the sharded value-and-grad (remat on, batch 8 x
    16) at depths 2 and 4 on a mesh of positions: the fullest position's
    peak grows per added layer by less than one layer's leaves gathered at
    a position plus their gradients. Reduced mistral on (2, 4), rows:
    51,200 B a layer (its saved block input, its pieces and their
    gradient sums) against a bound of 70,656 B; the step that gathered
    every layer before its forward grew by 104,448 B. Reduced smollm's
    whole leaves on (4, 2): 34,944 B against 279,552 B; that step grew by
    352,608 B."""
    mesh = _mesh(tag, "meta", positions=True)
    peaks, bound = {}, None
    for L in (2, 4):
        cfg = reduced(ARCHS[name]).replace(remat=True, n_layers=L)
        params = specs.param_specs_abstract(cfg)
        batch = specs.train_input_specs(cfg, specs.ShapeCell("c", "train",
                                                             16, 8))
        placed = (sh.fsdp_only_param_specs(params, mesh) if path == "whole"
                  else sh.param_specs(params, mesh))
        if bound is None:
            M = mesh.shape["model"] if path == "tp" else 1
            one = sum(
                p.numel() // L // (M if "model" in s.mesh_axes() else 1)
                for k in STACKED if k in params
                for p, s in zip(leaves(params[k]), leaves(placed[k])))
            bound = 2 * 4 * one

        def place(params, batch, placed=placed):
            return (sh.shard_tree(params, placed, mesh),
                    dryrun._whole_on(mesh)(batch))

        acc = dryrun.account(_vag(cfg, mesh, path), params, batch,
                             place=place, mesh=mesh)
        peaks[L] = acc["memory"]["peak_bytes"]
        assert acc["collectives"]["reduce-scatter"] > 0
    assert 0 < (peaks[4] - peaks[2]) / 2 < bound, (peaks, bound)


# ---------------------------------------------------------------- MoE
@pytest.mark.parametrize("name,tag,hinted", [
    ("dbrx-132b", "2x2x2", True), ("deepseek-v2-lite-16b", "2x2x2", False),
    ("deepseek-v2-lite-16b", "4", False)])
def test_moe_steps_keep_their_bars_and_repeat_bit_for_bit(name, tag,
                                                          hinted):
    """The MoE steps (rows on (2, 2, 2), dbrx's all-to-all inside the
    rows under the hint mesh; whole leaves on a "data"-only mesh), whose
    one backward adds the shards' layers in autograd's order, at a
    capacity that drops tokens: two runs equal bit for bit, and the step
    within the one-device step's bars (under the same hint mesh;
    ``tests/test_torch_train_moe_sharded.py``'s bars)."""
    cfg = reduced(ARCHS[name]).replace(capacity_factor=0.5)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    b = _batch(cfg)
    ocfg = OptimizerConfig(**OCFG)

    def hint():
        return sh.hint_mesh(mesh) if hinted else contextlib.nullcontext()

    runs = []
    for _ in range(2):
        ps, st = shard_train_state(params, opt.init(params), mesh)
        with hint():
            (total, _), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
            new, _, _ = make_sharded_train_step(cfg, ocfg, mesh)(ps, st, b)
        runs.append((float(total), _flat(grads), _flat(new)))
    assert runs[0][0] == runs[1][0]
    for part in (1, 2):
        for k, v in runs[0][part].items():
            assert v.tobytes() == runs[1][part][k].tobytes(), k
    with hint():
        (want, _), g1 = tstep.value_and_grad(tstep.make_loss_fn(cfg), params,
                                             b)
        p1, _, _ = make_train_step(cfg, ocfg)(params, opt.init(params), b)
    np.testing.assert_allclose(runs[0][0], float(want), rtol=LOSS_RTOL)
    for k, w in _flat(g1).items():
        np.testing.assert_allclose(
            runs[0][1][k], w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * float(np.abs(w).max()), err_msg=k)
    lr = float(opt.lr_at(ocfg, 1))
    for k, w in _flat(p1).items():
        np.testing.assert_allclose(runs[0][2][k], w, rtol=0,
                                   atol=PARAM_ATOL_LR * lr, err_msg=k)


# ------------------------------------------------------------ pieces
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_into_is_reduce_scatter_bit_for_bit(dim):
    rng = np.random.default_rng(3)
    members = [torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32)
                                * 10.0 ** s) for s in range(5)]
    devs = np.full((1, 4), torch.device(CPU), dtype=object)
    want = collectives.reduce_scatter(
        collectives.shard_array(members).reshape(5, 1), 0, dim, devs)
    into = [torch.empty_like(p) for p in torch.chunk(members[0], 4, dim=dim)]
    with collectives.counting() as count:
        for k, m in enumerate(members):
            collectives.reduce_scatter_into(
                list(zip(torch.chunk(m, 4, dim=dim), into)), k == 0)
    assert count.calls["reduce-scatter"] == len(members)
    for i in range(4):
        assert into[i].numpy().tobytes() == want[0, i].numpy().tobytes()


def test_a_layer_no_gradient_reaches_is_zeros():
    """``Zero3``'s gradients of a layer and of a leaf that the loss does
    not use are zeros (``jax.value_and_grad``'s), the used layer's the
    sum over the shards."""
    mesh = _mesh("4x2")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(3, 8, 4)).astype(np.float32))
    params = {"blocks": {"w": w},
              "unused": torch.from_numpy(np.ones(8, np.float32))}
    ps = sh.shard_tree(params, {"blocks": {"w": sh.P(None, "data", "model")},
                                "unused": sh.P("data")}, mesh)
    z = sh.Zero3(ps, STACKED)
    x = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    with torch.enable_grad():
        for dev in mesh.devices_of(("data",)):
            (t,) = z.trees([(dev, None)])
            (x @ t["blocks"].layer(1)[0]["w"]).sum().backward()
    g = _flat(z.grads())
    want = np.zeros((3, 8, 4), np.float32)
    want[1] = 4 * x.sum(0).numpy()[:, None]
    np.testing.assert_allclose(g["blocks/w"], want, rtol=1e-6)
    assert not g["blocks/w"][[0, 2]].any() and not g["unused"].any()
