"""The sharded prefill and decode of the mamba2 and rwkv6 configs (zamba2,
rwkv6) on rows of "model" positions (``launch/dryrun.py::sharded_prefill`` /
``sharded_decode``), the leaves split as the reference's layout splits
them (``sharding.param_specs``): Mamba2's packed ``in_proj`` by column and
its heads, RWKV6's projections by column (a cut need not fall between
heads) and its channel mix's ``wv`` by row, zamba2's shared attention
sites in the flash-decoding cache layout, and the batch-1 layout of
``long_500k``, whose cache ``decode_state_specs`` splits over
``(data, model)``.

Held here, on (4, 2) and (2, 4) CPU meshes:

* reduced zamba2 and rwkv6: a prefill of 16 tokens into 24 lines and 4
  decode steps on the rows against the one-device ``prefill`` /
  ``decode_step`` (logits and the gathered state at ``rtol=1e-5,
  atol=1e-6``, float64 compute, as ``tests/test_torch_serve_tp.py``); in
  float32 the rows within 1.5x of the one-device path's own distance from
  float64; the row prefill against the reference's ``prefill`` on its
  weights (``convert.lm_params_from_reference``; float32, ``rtol=1e-4,
  atol=1e-5``);
* one layer of ``ssm_apply_tp`` / ``ssm_decode_tp``, ``tmix_apply_tp`` /
  ``tmix_decode_tp`` and ``cmix_apply_tp`` / ``cmix_decode_tp`` against
  the one-device functions (float64, ``rtol=1e-5, atol=1e-6``), with a
  column piece cut through ``x`` (reduced zamba2 on a row of 2), through a
  head (reduced rwkv6's one head on 2 and on 4), and heads that do not
  divide the row (5 heads on a row of 4, both mixers);
* per-row cursors from a pool filled by ``model.write_slot``;
* a batch of one, whose shared sites' cache splits over ``(data, model)``:
  equal to one device, every position holding its lines;
* by the dry run's accounting on a mesh of positions: a decode step's
  collective bytes do not grow with the cache (no cache line leaves its
  position), also with the cache over ``(data, model)``; no position makes
  a storage as large as a whole "model"-split leaf or one site's cache
  rows of its batch shard (the whole-leaf step does);
* ``transformer.forward_tp`` on a row of 2 and 4 against ``forward``;
* the sharded train step of both configs is unchanged: whole leaves, with
  the batch over "model" (their layout) or not.

About 35 s alone (77 s beside five other pytest workers).
"""
import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill

from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.launch import dryrun, specs
from repro_torch.models import (attention, decode_step, init_params,
                                prefill, rwkv, ssm, transformer)
from repro_torch.models.model import (DecodeState, init_decode_state,
                                      write_slot)
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.train import train_step as tstep

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6                # the one-device functions' bars
REF_RTOL, REF_ATOL = 1e-4, 1e-5        # the reference's prefill
FP32_OVER_ONE_DEVICE = 1.5             # float32 rows' error / one-device's
CONFIGS = ["zamba2-7b", "rwkv6-3b"]
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
B, PROMPT, CACHE, STEPS = 8, 16, 24, 4


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    torch.set_num_threads(1)
    dryrun.serve_paths.clear()
    attention.tp_splits.clear()
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _mesh(tag, positions=False):
    dev = torch.device("meta") if positions else CPU
    return Mesh(np.full(MESHES[tag], dev, dtype=object), ("data", "model"),
                positions=positions)


def _tokens(cfg, b: int, n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, n)))


def _place(params, mesh):
    return sh.shard_tree(params, sh.param_specs(params, mesh, fsdp=False),
                         mesh)


def _strip_model(specs_):
    """A spec tree with "model" taken out: the whole-leaf layout."""
    if isinstance(specs_, dict):
        return {k: _strip_model(v) for k, v in specs_.items()}
    return sh.P(*(None if e == sh.TP else e for e in specs_))


def _f64(name, **changes):
    return reduced(ARCHS[name]).replace(compute_dtype="float64", **changes)


def _serve(cfg, params, mesh, toks, prompt, cache, steps):
    """The sharded prefill of ``toks[:, :prompt]`` into ``cache`` lines and
    ``steps`` teacher-forced sharded decode steps, beside the one-device
    functions: ``[(sharded, one-device)]`` logits and both final states."""
    b = toks.shape[0]
    dt = getattr(torch, cfg.compute_dtype)
    s_specs = dryrun._decode_state_specs(cfg, b, cache, dt, mesh)
    p_sh = _place(params, mesh)
    got, st = dryrun.sharded_prefill(cfg, mesh, cache, s_specs)(
        p_sh, {"tokens": toks[:, :prompt]})
    want, w_st = prefill(cfg, params, toks[:, :prompt], cache)
    out = [(got, want)]
    dec = dryrun.sharded_decode(cfg, mesh, s_specs)
    for t in range(prompt, prompt + steps):
        got, st = dec(p_sh, st, toks[:, t:t + 1])
        want, w_st = decode_step(cfg, params, toks[:, t:t + 1], w_st)
        out.append((got, want))
    return out, st, w_st


def _tensors(state):
    for part in (state.layer, state.shared):
        for cache in part or ():
            for t in cache:
                if isinstance(t, torch.Tensor):
                    yield t


def _close(out, st, w_st, what):
    for i, (got, want) in enumerate(out):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} call {i}")
    for a, w in zip(_tensors(sh.gather_tree(st)), _tensors(w_st),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} state")


def _assert_rows(cfg, mesh, calls: int, rows: int):
    """The row path ran every call; each attention layer or shared site of
    a decode step went through the flash-decoding combine once a row."""
    assert dict(dryrun.serve_paths) == {"row": calls}
    sites = cfg.attn_sites + (cfg.n_layers if cfg.mixer == "attn" else 0)
    assert attention.tp_splits["flash-decoding"] == (
        (calls - 1) * sites * rows)


# ------------------------------------------------ rows against one device
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_rows_are_the_one_device_functions(name, tag):
    """Prefill (16 tokens into 24 lines) and 4 decode steps on the rows
    against the one-device functions (float64 compute); the state comes
    back as ``Sharded`` pieces under ``decode_state_specs``: the shared
    sites' caches split by sequence over "model", the recurrent states by
    batch."""
    cfg = _f64(name)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    out, st, w_st = _serve(cfg, params, mesh, _tokens(cfg, B, PROMPT + STEPS),
                           PROMPT, CACHE, STEPS)
    _close(out, st, w_st, f"{name} on {tag}")
    _assert_rows(cfg, mesh, 1 + STEPS, mesh.shape["data"])
    want = sh.decode_state_specs(cfg, w_st, mesh)
    for got_c, want_c in zip(st.layer + (st.shared or []),
                             want.layer + (want.shared or []), strict=True):
        for leaf, spec in zip(got_c, want_c):
            if isinstance(leaf, sh.Sharded):
                assert leaf.spec == spec
    for cache in st.shared or []:
        assert cache.k.spec == sh.P("data", "model", None, None)
        assert cache.k.pieces.flat[0].shape[1] == (
            CACHE // mesh.shape["model"])


@pytest.mark.parametrize("name", CONFIGS)
def test_row_prefill_matches_the_reference(name):
    """The row path's prefill (float32, (4, 2)) against the reference's
    one-device prefill on its own weights."""
    ref_cfg = ref_reduced(REF_ARCHS[name])
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), device=CPU)
    cfg = reduced(ARCHS[name])
    mesh = _mesh("4x2")
    toks = _tokens(cfg, B, PROMPT)
    s_specs = dryrun._decode_state_specs(cfg, B, CACHE, torch.float32, mesh)
    got, _ = dryrun.sharded_prefill(cfg, mesh, CACHE, s_specs)(
        _place(params, mesh), {"tokens": toks})
    want, _ = ref_prefill(ref_cfg, ref_params,
                          jax.numpy.asarray(toks.numpy().astype(np.int32)),
                          CACHE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REF_RTOL,
                               atol=REF_ATOL)
    assert dict(dryrun.serve_paths) == {"row": 1}


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_float32_rows_are_as_accurate_as_one_device(name, tag):
    """In float32 the rows' logits over the prefill and 4 decode steps lie
    within 1.5x of the one-device float32 path's largest distance from the
    float64 one-device path."""
    cfg = reduced(ARCHS[name])
    params = init_params(cfg, device=CPU, seed=0)
    toks = _tokens(cfg, B, PROMPT + STEPS)
    out, _, _ = _serve(cfg, params, _mesh(tag), toks, PROMPT, CACHE, STEPS)
    c64 = cfg.replace(compute_dtype="float64")
    truth, t_st = prefill(c64, params, toks[:, :PROMPT], CACHE)
    truths = [truth]
    for t in range(PROMPT, PROMPT + STEPS):
        truth, t_st = decode_step(c64, params, toks[:, t:t + 1], t_st)
        truths.append(truth)
    err_rows = max(float((g.double() - t).abs().max())
                   for (g, _), t in zip(out, truths))
    err_one = max(float((w.double() - t).abs().max())
                  for (_, w), t in zip(out, truths))
    print(f"{name} {tag}: largest distance from float64, rows "
          f"{err_rows:.3e}, one device {err_one:.3e}")     # shown with -s
    assert err_one > 0
    assert err_rows <= FP32_OVER_ONE_DEVICE * err_one, (err_rows, err_one)


# ---------------------------------------------------------- the cases
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS + ["mistral-nemo-12b"])
def test_batch_of_one_splits_the_cache_over_data_and_model(name, tag):
    """One prompt (``long_500k``'s batch): ``decode_state_specs`` splits the
    shared sites' (an attention config's layers') cache over ``(data,
    model)``, 3 lines at each of the 8 positions, of which only the row at
    data index 0 computes; the others score their lines and join the
    combine. Prefill and 4 steps equal to one device; the recurrent states
    (split over nothing) stay at the row's first position."""
    cfg = _f64(name)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    out, st, w_st = _serve(cfg, params, mesh, _tokens(cfg, 1, PROMPT + STEPS),
                           PROMPT, CACHE, STEPS)
    _close(out, st, w_st, f"{name} batch 1 on {tag}")
    _assert_rows(cfg, mesh, 1 + STEPS, 1)
    kv = st.layer if cfg.mixer == "attn" else (st.shared or [])
    for cache in kv:
        assert cache.k.spec == sh.P(None, ("data", "model"), None, None)
        assert cache.k.pieces.shape == MESHES[tag]
        assert cache.k.pieces.flat[0].shape[1] == CACHE // 8
    for cache in st.layer if cfg.mixer != "attn" else []:
        for leaf in cache:
            if isinstance(leaf, sh.Sharded):
                assert leaf.spec == sh.P(*[None] * leaf.ndim)


@pytest.mark.parametrize("name,tag", [("zamba2-7b", "4x2"),
                                      ("rwkv6-3b", "2x4")])
def test_per_row_cursors_from_write_slot(name, tag):
    """A per-row pool filled by ``write_slot`` with 8 batch-1 prefills of
    3..17 tokens (every position of a row owns some row's next line), then
    4 decode steps on the rows, each row at its own cursor, against the
    one-device ``decode_step`` on a copy of the same pool."""
    cfg = _f64(name)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    dt = getattr(torch, cfg.compute_dtype)
    pool = init_decode_state(cfg, B, CACHE, dt, CPU, per_row=True)
    lengths = [16, 5, 11, 3, 2, 17, 8, 14]
    toks = _tokens(cfg, B, max(lengths) + STEPS)
    for slot, n in enumerate(lengths):
        _, fresh = prefill(cfg, params, toks[slot:slot + 1, :n], CACHE)
        pool = write_slot(cfg, pool, fresh, slot)

    def copy(state):
        def caches(cs):
            return None if cs is None else [
                type(c)(*(t.clone() if isinstance(t, torch.Tensor) else t
                          for t in c)) for c in cs]
        return DecodeState(layer=caches(state.layer),
                           shared=caches(state.shared), cross=None,
                           step=state.step.clone())

    w_st = copy(pool)
    s_specs = sh.decode_state_specs(cfg, pool, mesh)
    st = sh.shard_tree(pool, s_specs, mesh)
    p_sh = _place(params, mesh)
    dec = dryrun.sharded_decode(cfg, mesh, s_specs)
    out = []
    for t in range(STEPS):
        tok = toks[torch.arange(B), torch.tensor(lengths) + t][:, None]
        got, st = dec(p_sh, st, tok)
        want, w_st = decode_step(cfg, params, tok, w_st)
        out.append((got, want))
    _close(out, st, w_st, f"{name} per row")
    assert torch.equal(sh.gather(st.step), torch.tensor(lengths) + STEPS)
    assert dict(dryrun.serve_paths) == {"row": STEPS}


# ------------------------------------------------------- which path runs
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_keeps_whole_leaves(name, monkeypatch):
    """The sharded train step of these ``fsdp`` configs is unchanged:
    ``_tp_applies`` is false for training whether the batch is split over
    "model" (their layout, ``build_train``) or not, no row function runs,
    and the loss is the one-device loss; serving takes the rows on the
    same placement."""
    cfg = reduced(ARCHS[name])
    mesh = _mesh("4x2")
    params = init_params(cfg, device=CPU, seed=0)

    def refused(*a, **k):
        raise AssertionError("a row function ran in the train step")

    for fn in (tstep, "_tp_step"), (ssm, "ssm_apply_tp"), \
            (rwkv, "tmix_apply_tp"), (rwkv, "cmix_apply_tp"):
        monkeypatch.setattr(*fn, refused)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (8, 16))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    (want, _), _ = tstep.value_and_grad(tstep.make_loss_fn(cfg), params,
                                        batch)
    for over_model, p_specs in (
            (True, sh.fsdp_only_param_specs(params, mesh)),
            (False, sh.param_specs(params, mesh, fsdp=True))):
        ps = sh.shard_tree(params, p_specs, mesh)
        assert not tstep._tp_applies(cfg, mesh, ps, over_model)
        (got, _), _ = tstep.make_sharded_value_and_grad(
            cfg, mesh, batch_over_model=over_model)(ps, batch)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    ps = sh.shard_tree(params, sh.param_specs(params, mesh, fsdp=False),
                       mesh)
    assert tstep._tp_applies(cfg, mesh, ps, False, serving=True)
    assert not tstep._tp_applies(cfg, mesh, ps, True, serving=True)


# ------------------------------------------------- the dry run's counts
def _decode_cell(cfg, mesh, lines, batch=B, whole_leaves=False):
    cell = dryrun.build_decode(cfg, mesh, specs.ShapeCell(
        "d", "decode", lines, batch))
    place = cell.place
    if whole_leaves:
        def place(params, state, token):
            p_specs = _strip_model(sh.param_specs(params, mesh, fsdp=False))
            return (sh.shard_tree(params, p_specs, mesh),
                    *cell.place(params, state, token)[1:])
    return dryrun.account(cell.fn, *cell.args, place=place, mesh=mesh)


@pytest.mark.parametrize("batch", [B, 1])
def test_decode_moves_no_cache_line(batch):
    """Reduced zamba2's decode step on a (2, 4) mesh of positions, counted
    by the dry run: the busiest position receives the same bytes of every
    kind with a 1,024-line and a 4,096-line cache (queries, the combine's
    statistics, the new line, the recurrent states' heads, partial
    outputs and the logits move; no cache line does), fewer than one
    site's cache piece. With one prompt the cache lies over (data, model)
    and every position takes part."""
    cfg = reduced(ARCHS["zamba2-7b"])
    mesh = _mesh("2x4", positions=True)
    short = _decode_cell(cfg, mesh, 1024, batch)["collectives"]
    long_ = _decode_cell(cfg, mesh, 4096, batch)["collectives"]
    assert short == long_
    rows = max(1, batch // mesh.shape["data"])
    cut = mesh.shape["model"] * (1 if batch > 1 else mesh.shape["data"])
    line = cfg.n_kv_heads * cfg.head_dim * 2                 # bf16 bytes
    assert long_["total"] < rows * 4096 // cut * line * 2
    assert long_["receivers"] == 8
    if batch > 1:
        whole = _decode_cell(cfg, mesh, 4096, batch,
                             whole_leaves=True)["collectives"]
        assert whole["total"] > cfg.attn_sites * rows * 4096 * line * 2 * (
            mesh.shape["model"] - 1) // mesh.shape["model"]


@pytest.mark.parametrize("name", CONFIGS)
def test_no_position_holds_a_whole_leaf_or_cache_row(name):
    """Reduced zamba2 / rwkv6 (vocabulary 8,192, bf16) decoding against a
    4,096-line cache on a (2, 4) mesh of positions: no position makes a
    storage as large as the whole ``head`` leaf (1 MiB), or (zamba2) one
    site's K cache rows of its batch shard (2 MiB; a position's piece is
    0.5 MiB); the whole-leaf step does."""
    cfg = reduced(ARCHS[name]).replace(vocab=8192, compute_dtype="bfloat16")
    mesh = _mesh("2x4", positions=True)
    rows = B // mesh.shape["data"]
    head = cfg.d_model * cfg.vocab * 2
    bar = head
    if cfg.attn_sites:
        bar = min(head, rows * 4096 * cfg.n_kv_heads * cfg.head_dim * 2)
    got = _decode_cell(cfg, mesh, 4096)["memory"]["largest_storage"]
    assert len(got) == 8
    assert max(got.values()) < bar, got
    whole = _decode_cell(cfg, mesh, 4096, whole_leaves=True)
    assert max(whole["memory"]["largest_storage"].values()) >= bar


# ------------------------------------------------------------ one layer
def _row(M):
    return tuple(torch.device(CPU) for _ in range(M))


def _pieces(tree, M):
    """Each position's pieces of a one-layer tree, as ``param_specs``
    places them on a (1, M) mesh (``train_step.row_pieces``)."""
    mesh = Mesh(np.full((1, M), CPU, dtype=object), ("data", "model"))
    placed = sh.shard_tree(tree, sh.param_specs(tree, mesh, fsdp=False),
                           mesh)
    return tstep.row_pieces(placed, _row(M))


def _near(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def _noisy(p, g, names):
    """Leaves in ``names`` moved off their init (``D`` ones, norms zeros),
    so that a piece taken from the wrong head or channel shows."""
    return {k: v + 0.3 * torch.randn(v.shape, generator=g,
                                     dtype=v.dtype) if k in names else v
            for k, v in p.items()}


@pytest.mark.parametrize("d_model,M", [(64, 2), (64, 4), (40, 4)])
def test_ssm_layer_on_a_row_is_the_layer(d_model, M):
    """One Mamba2 layer (float64): ``ssm_apply_tp`` (16 tokens) and 3
    ``ssm_decode_tp`` steps against ``ssm_apply`` / ``ssm_decode``.
    Reduced zamba2 on 2 (``in_proj``'s 296 columns cut at 148, inside
    ``x``), on 4 (2 heads a position), and ``d_model`` 40 on 4: 5 heads of
    16 that do not divide the row (``A_log``, ``D``, ``dt_bias`` whole, a
    head shared by two positions, ``in_proj``'s 197 columns whole)."""
    cfg = _f64("zamba2-7b", d_model=d_model)
    g = torch.Generator().manual_seed(0)
    p = _noisy(ssm.ssm_init(g, cfg), g, ("D", "norm", "A_log", "dt_bias",
                                          "conv_b"))
    ps = [q["ssm"] for q in _pieces({"ssm": p}, M)]
    x = torch.randn(2, 16, d_model, generator=g, dtype=torch.float64)
    want, w_c = ssm.ssm_apply(cfg, p, x, return_cache=True)
    with mesh_lib.tensor_parallel(_row(M)):
        outs, caches = ssm.ssm_apply_tp(cfg, ps, [x] * M, return_cache=True)
    for o in outs:
        _near(o, want)
    _near(caches[0].conv, w_c.conv)
    _near(caches[0].state, w_c.state)
    assert all(c.conv is None for c in caches[1:])
    for _ in range(3):
        x1 = torch.randn(2, 1, d_model, generator=g, dtype=torch.float64)
        want, w_c = ssm.ssm_decode(cfg, p, x1, w_c)
        with mesh_lib.tensor_parallel(_row(M)):
            outs, caches = ssm.ssm_decode_tp(cfg, ps, [x1] * M, caches)
        for o in outs:
            _near(o, want)
        _near(caches[0].state, w_c.state)
        _near(caches[0].conv, w_c.conv)
        assert caches[0].index == w_c.index


@pytest.mark.parametrize("d_model,M", [(64, 2), (64, 4), (320, 4)])
def test_rwkv_layer_on_a_row_is_the_layer(d_model, M):
    """One RWKV6 block's time and channel mix (float64): ``tmix_apply_tp``
    / ``cmix_apply_tp`` (16 tokens) and 3 ``*_decode_tp`` steps against
    the one-device functions. Reduced rwkv6's one head of 64 on 2 and on
    4 positions (each holds a piece of the head and computes it whole),
    and 5 heads on 4 (80 columns a position: ``u`` whole, boundary heads
    computed at two positions)."""
    cfg = _f64("rwkv6-3b", d_model=d_model, d_ff=2 * d_model)
    g = torch.Generator().manual_seed(0)
    tp = _noisy(rwkv.tmix_init(g, cfg), g, ("u", "ln_w"))
    cp = rwkv.cmix_init(g, cfg)
    pieces = _pieces({"tmix": tp, "cmix": cp}, M)
    tps, cps = [q["tmix"] for q in pieces], [q["cmix"] for q in pieces]
    x = torch.randn(2, 16, d_model, generator=g, dtype=torch.float64)
    want, w_s = rwkv.tmix_apply(cfg, tp, x, return_state=True)
    w_cm = rwkv.cmix_apply(cfg, cp, x)
    with mesh_lib.tensor_parallel(_row(M)):
        outs, state = rwkv.tmix_apply_tp(cfg, tps, [x] * M,
                                         return_state=True)
        cms = rwkv.cmix_apply_tp(cfg, cps, [x] * M)
    for o, c in zip(outs, cms):
        _near(o, want)
        _near(c, w_cm)
    _near(state, w_s)
    one = rwkv.RWKVCache(x[:, -1], x[:, -2], w_s, 16)
    caches = [one] + [rwkv.RWKVCache(None, None, None, 16)] * (M - 1)
    for _ in range(3):
        x1 = torch.randn(2, 1, d_model, generator=g, dtype=torch.float64)
        want, one = rwkv.tmix_decode(cfg, tp, x1, one)
        w_cm, one = rwkv.cmix_decode(cfg, cp, x1, one)
        with mesh_lib.tensor_parallel(_row(M)):
            outs, caches = rwkv.tmix_decode_tp(cfg, tps, [x1] * M, caches)
            cms, caches = rwkv.cmix_decode_tp(cfg, cps, [x1] * M, caches)
        for o, c in zip(outs, cms):
            _near(o, want)
            _near(c, w_cm)
        for a, b in zip(caches[0][:3], one[:3]):
            _near(a, b)
        assert caches[0].index == one.index


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_on_a_row_is_forward(name, M):
    """``transformer.forward_tp`` (whose blocks ``prefill_tp`` runs:
    ``_apply_mixer_tp``'s mamba2 / rwkv6 branches, zamba2's shared site in
    ``_block_tp``, ``apply_channel_tp``'s channel mix) on a row of ``M``
    against ``forward`` (float64): the positions' vocabulary ranges
    joined are its logits."""
    cfg = _f64(name)
    params = init_params(cfg, device=CPU, seed=0)
    toks = _tokens(cfg, 2, 16)
    want, _ = transformer.forward(cfg, params, toks)
    with mesh_lib.tensor_parallel(_row(M)):
        got, _ = transformer.forward_tp(cfg, _pieces(params, M), [toks] * M)
    _near(torch.cat(got, -1), want)
