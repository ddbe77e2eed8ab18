"""Port vs reference: tensor parallelism over "model" inside each batch
shard of the sharded train step (``train/train_step.py::_tp_step``).

Where the batch is not split over "model" and a leaf's spec splits it, a
config of attention (no MLA) with a swiglu or gelu MLP runs each batch
shard over its row of positions: Megatron's column / row splits, the
embedding, head, logits and cross-entropy split by vocabulary. Held here:

* the step for reduced ``mistral-nemo-12b``, ``stablelm-12b``,
  ``llava-next-mistral-7b``, ``whisper-large-v3`` and ``smollm-360m`` on
  (2, 2, 2), (4, 2), (1, 8) and (2, 4) CPU meshes against the one-device
  step, at ``tests/test_torch_train_sharded.py``'s bars (loss within 1e-5
  relative; gradients ``rtol=1e-4, atol=1e-5 x max|g|`` per leaf;
  parameters after one step within ``0.5 x lr``), and reduced mistral on
  (2, 2, 2) against the reference's GSPMD step (one 8-device subprocess);
* that the path is the TP one: every "model"-split leaf reaches a position
  as its piece, the logits as a range of the vocabulary; that the layout
  and the config pick it (mamba2, rwkv6 and a batch split over "model"
  keep the whole-leaf path; the MoE and MLA configs' step is
  ``tests/test_torch_tp_moe.py``'s);
* each TP piece against its whole counterpart: the vocabulary-parallel
  embedding, logits, cross-entropy and z-loss, the column / row MLP,
  attention split into whole heads, onto one KV head and through a head;
  ``reduce_scatter`` equal to ``psum`` then a cut, bit for bit;
* remat on against off, bit for bit;
* the memory layout of the dry run (``launch.dryrun.account``) of the
  reduced mistral train cell on a (2, 4) mesh of positions: a batch
  shard's positions within 1.5x of each other, none making a storage as
  large as a whole ``wq`` or ``head`` leaf.

About 26 s alone, most of it the reference's subprocess; 62 s in the
tier-1 ``-n 6 --dist loadfile`` run on an 8-core host that also ran four
dry-run accountings.
"""
import textwrap

import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh, collectives
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs
from repro_torch.models import attention, init_params, layers, transformer
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
PIECE_RTOL, PIECE_ATOL = 1e-5, 1e-6      # one layer against its whole form
CONFIGS = ["mistral-nemo-12b", "stablelm-12b", "llava-next-mistral-7b",
           "whisper-large-v3", "smollm-360m"]
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    torch.set_num_threads(1)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _row(m):
    return tuple(torch.device(CPU) for _ in range(m))


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, sh.Sharded):
        out[prefix[:-1]] = sh.gather(tree).numpy()
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().numpy()
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


def _lr():
    return float(opt.lr_at(OptimizerConfig(**OCFG), 1))


def _close(got, want, what):
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


def _one_device(cfg, params, b):
    (total, _), grads = value_and_grad(make_loss_fn(cfg), params, b)
    new_p, _, _ = make_train_step(cfg, OptimizerConfig(**OCFG))(
        params, opt.init(params), b)
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p)}


def _sharded(cfg, params, b, mesh):
    ps, st = shard_train_state(params, opt.init(params), mesh)
    (total, _), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
    new_p, _, m = make_sharded_train_step(cfg, OptimizerConfig(**OCFG),
                                          mesh)(ps, st, b)
    assert float(m["loss"]) == float(total)
    return {"loss": float(total), "grads": _flat(grads),
            "params": _flat(new_p)}


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_tp_step_matches_one_device(name, tag):
    cfg = reduced(ARCHS[name])
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    mesh = _mesh(tag)
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    assert tstep._tp_applies(cfg, mesh, ps, False)
    _close(_sharded(cfg, params, b, mesh), _one_device(cfg, params, b),
           f"{name} on {tag}")


@pytest.mark.parametrize("name,batch_over_model,tp", [
    ("mistral-nemo-12b", False, True), ("starcoder2-3b", False, True),
    ("smollm-360m", True, False), ("dbrx-132b", False, True),
    ("deepseek-v2-lite-16b", False, True), ("zamba2-7b", False, False),
    ("rwkv6-3b", False, False)])
def test_layout_and_config_pick_the_path(name, batch_over_model, tp):
    """The layout decides, as for GSPMD: tensor-parallel where the batch is
    not split over "model" and the config is attention (MLA or not) with a
    swiglu, gelu or MoE channel (dbrx and deepseek included); the mamba2
    and rwkv6 configs and a batch split over "model" keep the whole-leaf
    path."""
    cfg = reduced(ARCHS[name])
    mesh = _mesh("4x2")
    params = init_params(cfg, device=CPU, seed=0)
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    assert tstep._tp_applies(cfg, mesh, ps, batch_over_model) is tp


def test_tp_step_with_widths_that_do_not_divide():
    """A vocabulary and an MLP width that the model axis does not divide
    leave ``embed.tok``, ``head`` and the MLP whole at every position, as
    GSPMD leaves them: each position computes those layers whole, the
    cross-entropy on the whole vocabulary; attention still splits."""
    cfg = reduced(ARCHS["whisper-large-v3"]).replace(vocab=510, d_ff=130)
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg))
    mesh = _mesh("2x4")
    specs_ = sh.param_specs(params, mesh)
    assert "model" not in specs_["head"].mesh_axes()
    assert "model" not in specs_["blocks"]["mlp"]["wo"].mesh_axes()
    assert "model" in specs_["blocks"]["attn"]["wq"].mesh_axes()
    _close(_sharded(cfg, params, b, mesh), _one_device(cfg, params, b),
           "widths that do not divide on 2x4")


@pytest.mark.parametrize("name,tag", [("mistral-nemo-12b", "2x4"),
                                      ("smollm-360m", "4x2"),
                                      ("whisper-large-v3", "2x2x2")])
def test_tp_step_keeps_leaves_and_logits_split(name, tag, monkeypatch):
    """Every "model"-split leaf reaches each position as its piece (a
    ``1 / model`` slice of the split dim), no whole leaf of such a spec is
    gathered, and each position's logits are its range of the vocabulary."""
    cfg = reduced(ARCHS[name])
    mesh = _mesh(tag)
    M = mesh.shape["model"]
    params = init_params(cfg, device=CPU, seed=0)
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    seen, widths = [], []
    gather, logits_tp = sh.gather, layers.logits_from_hidden_tp

    def spy_gather(leaf, device=None, index=None):
        out = gather(leaf, device, index)
        seen.append((leaf.spec, tuple(leaf.shape), index, tuple(out.shape)))
        return out

    def spy_logits(*a):
        out = logits_tp(*a)
        widths.extend(lg.shape[-1] for lg in out)
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
    monkeypatch.setattr(layers, "logits_from_hidden_tp", spy_logits)
    make_sharded_value_and_grad(cfg, mesh)(ps, _torch(_batch(cfg)))
    assert seen and all(index is not None for _, _, index, _ in seen)
    assert any(sh.split_dim(spec, "model") is not None
               for spec, _, _, _ in seen)
    for spec, whole, index, got in seen:
        want = list(whole)
        dim = sh.split_dim(spec, "model")
        if dim is not None:
            want[dim] //= M
        assert got == tuple(want), (spec, whole, index, got)
    assert widths and all(w * M == cfg.vocab for w in widths)


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
    b = np.load({batch!r})
    batch = {{"tokens": jnp.asarray(b["tokens"]),
              "labels": jnp.asarray(b["labels"])}}
    p_specs = sharding.param_specs(params, mesh, fsdp=True)
    o_specs = opt.OptState(mu=p_specs, nu=p_specs, step=PartitionSpec())
    b_specs = sharding.data_specs(batch, mesh)
    put = lambda t, s: jax.device_put(t, sharding.make_sharding(s, mesh))
    train_step = make_train_step(cfg, OptimizerConfig(**{ocfg!r}))

    def step_and_grads(params, ostate, batch):
        (loss, _), grads = jax.value_and_grad(
            make_loss_fn(cfg), has_aux=True)(params, batch)
        return (*train_step(params, ostate, batch), loss, grads)

    step = jax.jit(step_and_grads,
                   in_shardings=(sharding.make_sharding(p_specs, mesh),
                                 sharding.make_sharding(o_specs, mesh),
                                 sharding.make_sharding(b_specs, mesh)))
    new_p, _, m, loss, grads = step(put(params, p_specs),
                                    put(opt.init(params), o_specs),
                                    put(batch, b_specs))
    out = {{"loss": np.asarray(loss)}}
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for path, leaf in flat(grads):
        out["g/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    for path, leaf in flat(new_p):
        out["p/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    np.savez({path!r}, **out)
    print("REFERENCE DONE")
    """
)


def test_tp_step_matches_the_reference_gspmd_step(tmp_path):
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    params = init_params(cfg, device=CPU, seed=0)
    np.savez(tmp_path / "batch.npz", **_batch(cfg))
    np.savez(tmp_path / "weights.npz", **_flat(params))
    code = REFERENCE.format(batch=str(tmp_path / "batch.npz"), ocfg=OCFG,
                            weights=str(tmp_path / "weights.npz"),
                            path=str(tmp_path / "out.npz"))
    assert "REFERENCE DONE" in run_with_devices(code, 8)
    with np.load(tmp_path / "out.npz") as z:
        ref = {k: z[k] for k in z.files}
    want = {"loss": float(ref["loss"]),
            "grads": {k[2:]: v for k, v in ref.items() if k[:2] == "g/"},
            "params": {k[2:]: v for k, v in ref.items() if k[:2] == "p/"}}
    _close(_sharded(cfg, params, _torch(_batch(cfg)), _mesh("2x2x2")),
           want, "vs the reference's GSPMD step")


# ------------------------------------------------------------- pieces
def _pieces(t, dim, m):
    return list(torch.chunk(t, m, dim=dim))


def _per_position(tree, m, splits):
    """One tree per position: leaves named in ``splits`` cut along their
    dim there, the others whole at every position."""
    out = []
    for j in range(m):
        def leaf(path, t):
            d = splits.get(path[-1])
            return t if d is None else _pieces(t, d, m)[j]
        out.append(sh._map_with_path(leaf, tree))
    return out


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_embedding_equals_the_lookup(m):
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    p = {"embed": {"tok": _rand(cfg.vocab, cfg.d_model)}}
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    with mesh_lib.tensor_parallel(_row(m)):
        got = transformer.embed_tp(cfg, _per_position(p, m, {"tok": 0}),
                                   [toks] * m)
    want = transformer.embed(cfg, p, toks)
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("tied", [False, True])
def test_vocab_parallel_logits_ce_and_z_loss(tied):
    """Each position's logits are its columns of the whole logits; the
    vocabulary-parallel NLL and ``logsumexp`` equal the one-device ones;
    so do their gradients."""
    m = 4
    cfg = reduced(ARCHS["smollm-360m" if tied else "mistral-nemo-12b"])
    assert cfg.tie_embeddings == tied
    p = ({"embed": {"tok": _rand(cfg.vocab, cfg.d_model, seed=1)}} if tied
         else {"head": _rand(cfg.d_model, cfg.vocab, seed=1) * 0.1})
    h = _rand(2, 16, cfg.d_model, seed=2)
    labels = torch.from_numpy(_batch(cfg, B=2)["labels"]).long()
    want = layers.logits_from_hidden(cfg, p, h)
    pp = _per_position(p, m, {"tok": 0, "head": 1})
    with mesh_lib.tensor_parallel(_row(m)):
        got = layers.logits_from_hidden_tp(cfg, pp, [h] * m)
        for j, lg in enumerate(got):
            torch.testing.assert_close(lg, _pieces(want, -1, m)[j],
                                       rtol=PIECE_RTOL, atol=PIECE_ATOL)
        pieces = [x.clone().requires_grad_(True)
                  for x in _pieces(want, -1, m)]
        nll, z = tstep.vocab_parallel_nll(pieces, [labels] * m)
        (nll.sum() + (z * z).sum()).backward()
    whole = want.clone().requires_grad_(True)
    w_nll = tstep._nll(whole, labels)
    w_z = torch.logsumexp(whole, dim=-1)
    (w_nll.sum() + (w_z * w_z).sum()).backward()
    torch.testing.assert_close(nll, w_nll, rtol=PIECE_RTOL, atol=PIECE_ATOL)
    torch.testing.assert_close(z, w_z, rtol=PIECE_RTOL, atol=PIECE_ATOL)
    torch.testing.assert_close(torch.cat([x.grad for x in pieces], -1),
                               whole.grad, rtol=PIECE_RTOL, atol=PIECE_ATOL)


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "whisper-large-v3"])
def test_column_row_mlp_equals_the_whole_mlp(name):
    m = 2
    cfg = reduced(ARCHS[name])
    p = layers.mlp_init(torch.Generator().manual_seed(0), cfg)
    x = _rand(2, 16, cfg.d_model, seed=3)
    with mesh_lib.tensor_parallel(_row(m)):
        got = layers.mlp_apply_tp(
            cfg, _per_position(p, m, {"wg": 1, "wu": 1, "wi": 1, "wo": 0}),
            [x] * m)
    want = layers.mlp_apply(cfg, p, x)
    for g in got:
        torch.testing.assert_close(g, want, rtol=PIECE_RTOL, atol=PIECE_ATOL)


@pytest.mark.parametrize("heads,kv,m,path", [
    (4, 4, 2, "whole heads"), (4, 2, 2, "whole heads"),
    (4, 1, 2, "one KV head"), (8, 2, 4, "one KV head"),
    (4, 1, 8, "through a head"), (6, 2, 4, "through a head")])
@pytest.mark.parametrize("cross", [False, True])
def test_tp_attention_equals_the_whole_attention(heads, kv, m, path, cross):
    cfg = reduced(ARCHS["mistral-nemo-12b"]).replace(
        n_heads=heads, n_kv_heads=kv, d_head=16, d_model=96)
    p = attention.attn_init(torch.Generator().manual_seed(0), cfg)
    x = _rand(2, 16, cfg.d_model, seed=4)
    mem = _rand(2, 12, cfg.d_model, seed=5) if cross else None
    pos = torch.arange(16)
    kw = dict(causal=not cross, use_rope=not cross)
    attention.tp_splits.clear()
    with mesh_lib.tensor_parallel(_row(m)):
        got = attention.attn_apply_tp(
            cfg, _per_position(p, m, {"wq": 1, "wk": 1, "wv": 1, "wo": 0}),
            [x] * m, [pos] * m, kv_source=[mem] * m if cross else None, **kw)
    assert attention.tp_splits == {path: 1}
    want = attention.attn_apply(cfg, p, x, pos, kv_source=mem, **kw)
    for g in got:
        torch.testing.assert_close(g, want, rtol=PIECE_RTOL, atol=PIECE_ATOL)


@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_is_psum_then_a_cut_bit_for_bit(dim):
    shards = collectives.shard_array([_rand(8, 12, seed=s) * 10 ** s
                                      for s in range(6)]).reshape(3, 2)
    devs = np.full((2, 4), torch.device(CPU), dtype=object)
    got = collectives.reduce_scatter(shards, 0, dim, devs)
    want = collectives.psum(shards, 0)
    assert got.shape == (2, 4)
    for g in range(2):
        for i, piece in enumerate(torch.chunk(want[g], 4, dim=dim)):
            assert got[g, i].numpy().tobytes() == piece.numpy().tobytes()


# -------------------------------------------------------------- remat
@pytest.mark.parametrize("name", ["mistral-nemo-12b", "whisper-large-v3"])
def test_tp_step_with_remat_equals_without_bit_for_bit(name):
    base = reduced(ARCHS[name])
    params = init_params(base, device=CPU, seed=0)
    b = _torch(_batch(base))
    mesh = _mesh("4x2")
    ps, _ = shard_train_state(params, opt.init(params), mesh)
    out = {}
    for remat in (True, False):
        cfg = base.replace(remat=remat, scan_layers=True)
        (total, _), grads = make_sharded_value_and_grad(cfg, mesh)(ps, b)
        out[remat] = (total, _flat(grads))
    assert out[True][0].numpy().tobytes() == out[False][0].numpy().tobytes()
    for k, v in out[False][1].items():
        assert out[True][1][k].tobytes() == v.tobytes(), k


# ------------------------------------------- one structure, two forms
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", [n for n in sorted(ARCHS)
                                  if transformer.tp_covers(ARCHS[n])])
def test_tp_forward_on_a_row_of_one_is_forward_bit_for_bit(name, remat):
    """``forward_tp`` repeats ``forward``'s structure for every config that
    ``tp_covers``: on a row of one position (every leaf whole) it gives
    ``forward``'s logits and MoE aux, and the loss of ``_tp_terms`` the
    one-device loss and gradients, bit for bit, so that the two forms cannot drift
    apart."""
    cfg = reduced(ARCHS[name]).replace(remat=remat, scan_layers=True)
    params = init_params(cfg, device=CPU, seed=0)
    b = _torch(_batch(cfg, B=2))
    kw = {k: b[k] for k in ("vision_embeds", "audio_frames") if k in b}
    with torch.no_grad():
        want, want_aux = transformer.forward(cfg, params, b["tokens"], **kw)
        with mesh_lib.tensor_parallel(_row(1)):
            got, got_aux = transformer.forward_tp(
                cfg, [params], [b["tokens"]],
                **{k: [v] for k, v in kw.items()})
    assert got[0].numpy().tobytes() == want.numpy().tobytes()
    assert got_aux.numpy().tobytes() == want_aux.numpy().tobytes()
    n_tok = torch.tensor(float(b["labels"].numel()))
    (t1, _), g1 = value_and_grad(tstep._global_loss_fn(cfg, n_tok, n_tok),
                                 params, b)
    with mesh_lib.tensor_parallel(_row(1)):
        (t2, _), (g2,) = tstep.row_value_and_grad(
            tstep._global_loss_fn(cfg, n_tok, n_tok, tstep._tp_terms(cfg)),
            [params], [b])
    assert t2.numpy().tobytes() == t1.numpy().tobytes()
    want_g = _flat(g1)
    for k, v in _flat(g2).items():
        assert v.tobytes() == want_g[k].tobytes(), k


# ------------------------------------------------------- memory layout
def test_dry_run_layout_keeps_positions_level_and_leaves_split():
    """The reduced mistral train cell accounted on a (2, 4) mesh of
    positions (remat on; 4 layers, since at 2 a quarter of ``head``, which
    a position holds, is a whole ``wq``'s bytes): the positions of each
    batch shard's row peak within 1.5x of each other, and none makes a
    storage as large as a whole ``wq`` (all layers) or ``head`` leaf."""
    cfg = reduced(ARCHS["mistral-nemo-12b"]).replace(remat=True, n_layers=4)
    mesh = Mesh(np.full((2, 4), torch.device("meta"), dtype=object),
                ("data", "model"), positions=True)
    acc = dryrun.run_built(dryrun._build(
        cfg, mesh, specs.ShapeCell("c", "train", 16, 8)), mesh)
    mem = acc["memory"]
    for k in range(2):
        row = [mem["per_position"][str(4 * k + j)] for j in range(4)]
        assert max(row) <= 1.5 * min(row), (k, row)
    whole = {n: int(np.prod(s)) * 4 for n, s in (
        ("wq", (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)),
        ("head", (cfg.d_model, cfg.vocab)))}
    assert len(mem["largest_storage"]) == 8
    assert max(mem["largest_storage"].values()) < min(whole.values())
    assert acc["collectives"]["all-reduce"] > 0
