"""The sharded prefill and decode on rows of "model" positions
(``launch/dryrun.py::sharded_prefill`` / ``sharded_decode``): tensor-parallel
weights and the reference's flash-decoding cache layout, the cache's
sequence split over "model" (``sharding.decode_state_specs``).

Held here, on (4, 2) and (2, 4) CPU meshes:

* every config ``transformer.tp_covers`` takes (reduced mistral-nemo,
  stablelm, whisper, starcoder2, dbrx, deepseek, llava with its vision
  stub, smollm): the sharded prefill and 4 decode steps against the
  one-device ``prefill`` / ``decode_step`` on the same weights, logits and
  the gathered state at ``rtol=1e-5, atol=1e-6``, computed in float64
  (``compute_dtype``; the weights stay float32). In float32 the row-split
  ``wo`` adds its pieces' products in another order than one matmul, and
  the one-device float32 path is itself up to 3.9e-6 from float64 on
  these logits (``test_float32_rows_are_as_accurate_as_one_device``
  measures it), so no other order of the same float32 sums can be held to
  a 1e-6 ``atol``; in float32 the rows are held to within 1.5x of the
  one-device path's own distance from float64;
* the prefill against the reference's prefill, weights through
  ``convert.lm_params_from_reference`` (float32, ``rtol=1e-4,
  atol=1e-5``);
* a cursor in the first piece (the other pieces fully masked), a sliding
  window that masks whole front pieces, per-row cursors writing into
  different positions' pieces (one past the cache's end);
* that the row path ran (``dryrun.serve_paths``, the attention and MLA
  ``tp_splits["flash-decoding"]``), the state came back as ``Sharded``
  pieces under ``decode_state_specs``, mamba2 / rwkv6 take the rows too,
  and weights placed without "model" keep whole leaves;
* by the dry run's accounting on a mesh of positions: a decode step's
  collective bytes do not grow with the cache (no cache line leaves its
  position: only the queries, the combine's statistics, the new line and
  the partial outputs move), and no position makes a storage as large as
  a whole "model"-split leaf or one layer's cache row of its batch shard;
* one layer's ``attn_decode_tp`` / ``mla_decode_tp`` against
  ``attn_decode`` / ``mla_decode``: float32 at ``rtol=1e-5, atol=1e-6``;
  bfloat16 within two bfloat16 ulps of the output's largest magnitude
  (``2 x 2^-7 x max|out|``: the row-split ``wo`` rounds each piece's
  product to bfloat16 before they are added, one rounding more than one
  matmul).

About 60 s alone.
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
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs
from repro_torch.models import (attention, decode_step, init_params, mla,
                                prefill)
from repro_torch.models.model import DecodeState
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6                # the one-device functions' bars
REF_RTOL, REF_ATOL = 1e-4, 1e-5        # the reference's prefill
FP32_OVER_ONE_DEVICE = 1.5             # float32 rows' error / one-device's
BF16_ULPS = 2
CONFIGS = ["mistral-nemo-12b", "stablelm-12b", "whisper-large-v3",
           "starcoder2-3b", "dbrx-132b", "deepseek-v2-lite-16b",
           "llava-next-mistral-7b", "smollm-360m"]
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
B, PROMPT, CACHE, STEPS = 8, 16, 24, 4


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    torch.set_num_threads(1)
    dryrun.serve_paths.clear()
    attention.tp_splits.clear()
    mla.tp_splits.clear()
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _mesh(tag, positions=False):
    shape = MESHES[tag]
    dev = torch.device("meta") if positions else CPU
    return Mesh(np.full(shape, dev, dtype=object), ("data", "model"),
                positions=positions)


def _inputs(cfg, n: int, seed: int = 1):
    """(B, n) token ids and the frontend's stub embeddings, from numpy."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n)))
    kw = {}
    if cfg.frontend == "vision":
        kw["vision_embeds"] = torch.from_numpy((rng.normal(size=(
            B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.enc_dec:
        kw["audio_frames"] = torch.from_numpy((rng.normal(size=(
            B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32))
    return toks, kw


def _lines(cfg, n: int) -> int:
    """Cache lines for ``n`` text positions (after a vision prefix)."""
    return n + (cfg.n_vision_tokens if cfg.frontend == "vision" else 0)


def _strip_model(specs):
    """A spec tree with "model" taken out: the whole-leaf layout."""
    if isinstance(specs, dict):
        return {k: _strip_model(v) for k, v in specs.items()}
    return sh.P(*(None if e == sh.TP else e for e in specs))


def _place(cfg, params, mesh, whole_leaves=False):
    p_specs = sh.param_specs(params, mesh, fsdp=False)
    if whole_leaves:
        p_specs = _strip_model(p_specs)
    return sh.shard_tree(params, p_specs, mesh)


def _serve(cfg, params, mesh, toks, kw, prompt, cache, steps,
           whole_leaves=False):
    """The sharded prefill of ``toks[:, :prompt]`` into a ``cache``-line
    cache and ``steps`` sharded decode steps (teacher-forced), beside the
    one-device functions. Returns ``[(sharded, one-device)]`` logits per
    call and both final states."""
    dt = getattr(torch, cfg.compute_dtype)
    s_specs = dryrun._decode_state_specs(cfg, B, cache, dt, mesh)
    p_sh = _place(cfg, params, mesh, whole_leaves)
    got, st = dryrun.sharded_prefill(cfg, mesh, cache, s_specs)(
        p_sh, {"tokens": toks[:, :prompt], **kw})
    want, w_st = prefill(cfg, params, toks[:, :prompt], cache, **kw)
    out = [(got, want)]
    dec = dryrun.sharded_decode(cfg, mesh, s_specs)
    for t in range(prompt, prompt + steps):
        got, st = dec(p_sh, st, toks[:, t:t + 1])
        want, w_st = decode_step(cfg, params, toks[:, t:t + 1], w_st)
        out.append((got, want))
    return out, st, w_st


def _tensors(state):
    for part in (state.layer, state.cross):
        for t in _flat(part):
            if isinstance(t, torch.Tensor):
                yield t


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree


def _close(out, st, w_st, what):
    for i, (got, want) in enumerate(out):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} call {i}")
    for a, w in zip(_tensors(sh.gather_tree(st)), _tensors(w_st),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} state")


def _f64(name, **changes):
    return reduced(ARCHS[name]).replace(compute_dtype="float64", **changes)


def _assert_rows(cfg, mesh, calls: int):
    """The row path ran every call (a prefill and decode steps), each
    attention layer of a decode step through the flash-decoding combine
    once a row."""
    assert dict(dryrun.serve_paths) == {"row": calls}
    splits = mla.tp_splits if cfg.mla else attention.tp_splits
    assert splits["flash-decoding"] == (
        (calls - 1) * cfg.n_layers * mesh.shape["data"])


# ------------------------------------------------ rows against one device
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_rows_are_the_one_device_functions(name, tag):
    """Prefill (16 tokens into 24 lines) and 4 decode steps on the rows,
    logits and state against the one-device functions (float64 compute);
    the state comes back as ``Sharded`` pieces under
    ``decode_state_specs``, each cache split by sequence over "model"."""
    cfg = _f64(name)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, PROMPT + STEPS)
    cache = _lines(cfg, CACHE)
    out, st, w_st = _serve(cfg, params, mesh, toks, kw, PROMPT, cache,
                           STEPS)
    _close(out, st, w_st, f"{name} on {tag}")
    _assert_rows(cfg, mesh, 1 + STEPS)
    want_specs = sh.decode_state_specs(cfg, w_st, mesh)
    for layer, specs_of in zip(st.layer, want_specs.layer, strict=True):
        for leaf, spec in zip(layer[:2], specs_of[:2]):
            assert leaf.spec == spec and sh.TP in spec.mesh_axes()
            assert leaf.pieces.flat[0].shape[1] == (
                cache // mesh.shape["model"])


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
    toks, kw = _inputs(cfg, PROMPT)
    cache = _lines(cfg, CACHE)
    s_specs = dryrun._decode_state_specs(cfg, B, cache, torch.float32, mesh)
    got, _ = dryrun.sharded_prefill(cfg, mesh, cache, s_specs)(
        _place(cfg, params, mesh), {"tokens": toks, **kw})
    want, _ = ref_prefill(ref_cfg, ref_params,
                          jax.numpy.asarray(toks.numpy().astype(np.int32)),
                          cache, **{k: jax.numpy.asarray(v.numpy())
                                    for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REF_RTOL,
                               atol=REF_ATOL)
    assert dict(dryrun.serve_paths) == {"row": 1}


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_float32_rows_are_as_accurate_as_one_device(name, tag):
    """In float32 (the reduced configs' compute dtype) the rows' logits over
    the prefill and 4 decode steps lie within 1.5x of the one-device
    float32 path's largest distance from the float64 one-device path."""
    cfg = reduced(ARCHS[name])
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, PROMPT + STEPS)
    cache = _lines(cfg, CACHE)
    out, _, _ = _serve(cfg, params, mesh, toks, kw, PROMPT, cache, STEPS)
    c64 = cfg.replace(compute_dtype="float64")
    truth, t_st = prefill(c64, params, toks[:, :PROMPT], cache, **kw)
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


# ------------------------------------------------------------ the cases
@pytest.mark.parametrize("name", ["mistral-nemo-12b", "deepseek-v2-lite-16b"])
def test_cursor_in_the_first_piece(name):
    """A 4-token prompt into a 24-line cache on (2, 4) (pieces of 6 lines):
    the prefill and the first decode steps see only the first piece, the
    other three fully masked; the cursor then crosses into the second
    piece. Finite, and equal to the one-device functions."""
    cfg = _f64(name)
    mesh = _mesh("2x4")
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, 4 + STEPS)
    out, st, w_st = _serve(cfg, params, mesh, toks, kw, 4, CACHE, STEPS)
    assert all(torch.isfinite(g).all() for g, _ in out)
    _close(out, st, w_st, name)
    _assert_rows(cfg, mesh, 1 + STEPS)


@pytest.mark.parametrize("tag", list(MESHES))
def test_sliding_window_masks_whole_front_pieces(tag):
    """starcoder2 with a 4-line window: at cursors 16..19 of a 24-line cache
    the window masks pieces 0 and 1 of (2, 4)'s pieces of 6 (piece 0 of
    (4, 2)'s pieces of 12) whole."""
    cfg = _f64("starcoder2-3b", sliding_window=4)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, PROMPT + STEPS)
    out, st, w_st = _serve(cfg, params, mesh, toks, kw, PROMPT, CACHE,
                           STEPS)
    _close(out, st, w_st, f"window on {tag}")
    _assert_rows(cfg, mesh, 1 + STEPS)


@pytest.mark.parametrize("name,tag", [("mistral-nemo-12b", "4x2"),
                                      ("deepseek-v2-lite-16b", "2x4"),
                                      ("whisper-large-v3", "2x4")])
def test_per_row_cursors(name, tag):
    """``state.step`` a (B,) tensor: each row decodes at its own cursor and
    writes its new line into the piece that holds it (rows 0..7 at 16, 5,
    11, 23, 2, 17, 8, 20: every position of the row owns some row's line,
    and row 3 runs past the cache's end and writes nothing), 4 steps
    against the one-device ``decode_step`` on the same state."""
    cfg = _f64(name)
    mesh = _mesh(tag)
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, PROMPT + STEPS)
    _, whole = prefill(cfg, params, toks[:, :PROMPT], CACHE, **kw)
    step = torch.tensor([16, 5, 11, 23, 2, 17, 8, 20])
    whole = whole._replace(step=step)
    w_st = DecodeState(
        layer=[type(c)(*(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in c)) for c in whole.layer],
        shared=None, cross=whole.cross, step=step.clone())
    s_specs = sh.decode_state_specs(cfg, whole, mesh)
    st = sh.shard_tree(whole, s_specs, mesh)
    p_sh = _place(cfg, params, mesh)
    dec = dryrun.sharded_decode(cfg, mesh, s_specs)
    out = []
    for t in range(PROMPT, PROMPT + STEPS):
        got, st = dec(p_sh, st, toks[:, t:t + 1])
        want, w_st = decode_step(cfg, params, toks[:, t:t + 1], w_st)
        out.append((got, want))
    _close(out, st, w_st, f"{name} per row")
    assert torch.equal(sh.gather(st.step), step + STEPS)
    assert dict(dryrun.serve_paths) == {"row": STEPS}


# ------------------------------------------------------- which path runs
@pytest.mark.parametrize("name,path", [
    ("mistral-nemo-12b", "row"), ("deepseek-v2-lite-16b", "row"),
    ("rwkv6-3b", "row"), ("zamba2-7b", "row")])
def test_layout_and_config_pick_the_serving_path(name, path):
    """``tests/test_torch_dryrun.py``'s ``DECODE_ARCHS`` on (4, 2): the
    attention configs and, since the mamba2 and rwkv6 mixers run on rows
    (``tests/test_torch_serve_tp_recurrent.py``), zamba2 and rwkv6 take
    the rows (float64, equal to the one-device functions at the bars)."""
    cfg = reduced(ARCHS[name])
    if path == "row":
        cfg = cfg.replace(compute_dtype="float64")
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, PROMPT + STEPS)
    out, st, w_st = _serve(cfg, params, _mesh("4x2"), toks, kw, PROMPT,
                           CACHE, STEPS)
    _close(out, st, w_st, name)
    assert dict(dryrun.serve_paths) == {path: 1 + STEPS}


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_weights_whole_over_model_take_whole_leaves(name):
    """Weights placed without "model" (the cache still split by sequence)
    take the whole-leaf path: bit for bit the one-device functions
    (float32)."""
    cfg = reduced(ARCHS[name])
    params = init_params(cfg, device=CPU, seed=0)
    toks, kw = _inputs(cfg, PROMPT + STEPS)
    out, st, w_st = _serve(cfg, params, _mesh("2x4"), toks, kw, PROMPT,
                           CACHE, STEPS, whole_leaves=True)
    for got, want in out:
        assert torch.equal(got, want)
    assert dict(dryrun.serve_paths) == {"whole leaves": 1 + STEPS}
    assert not attention.tp_splits


# ------------------------------------------------- the dry run's counts
def _decode_cell(cfg, mesh, lines, whole_leaves=False):
    """The dry run's decode cell; with ``whole_leaves`` its weights placed
    without "model", so that it takes the whole-leaf path."""
    cell = dryrun.build_decode(cfg, mesh, specs.ShapeCell(
        "d", "decode", lines, B))
    place = cell.place
    if whole_leaves:
        def place(params, state, token):
            p_specs = _strip_model(sh.param_specs(params, mesh, fsdp=False))
            return (sh.shard_tree(params, p_specs, mesh),
                    *cell.place(params, state, token)[1:])
    return dryrun.account(cell.fn, *cell.args, place=place, mesh=mesh)


def test_decode_moves_no_cache_line():
    """Reduced mistral's decode step on a (2, 4) mesh of positions, counted
    by the dry run: the busiest position receives the same bytes of every
    collective kind with a 1,024-line and a 4,096-line cache (the queries,
    the combine's maxima and sums, the new line, the partial outputs and
    the logits move; no cache line does), and fewer than one layer's
    cache piece; the whole-leaf step gathers the other positions' pieces
    of its batch shard's rows of every layer."""
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    mesh = _mesh("2x4", positions=True)
    short = _decode_cell(cfg, mesh, 1024)["collectives"]
    long_ = _decode_cell(cfg, mesh, 4096)["collectives"]
    assert short == long_
    assert long_["all-to-all"] == 0 and long_["reduce-scatter"] == 0
    rows = B // mesh.shape["data"]
    line = cfg.n_kv_heads * cfg.head_dim * 2                 # bf16 bytes
    piece = rows * 4096 // mesh.shape["model"] * line * 2    # k and v
    assert long_["total"] < piece
    whole = _decode_cell(cfg, mesh, 4096, whole_leaves=True)["collectives"]
    M = mesh.shape["model"]
    assert whole["total"] > cfg.n_layers * piece * (M - 1)


def test_no_position_holds_a_whole_leaf_or_cache_row():
    """Reduced mistral (vocabulary 2,048, bf16 compute) decoding against a
    4,096-line cache on a (2, 4) mesh of positions: no position makes a
    storage as large as the whole ``head`` leaf or one layer's K cache
    rows of its batch shard; the whole-leaf step does."""
    cfg = reduced(ARCHS["mistral-nemo-12b"]).replace(
        vocab=2048, compute_dtype="bfloat16")
    mesh = _mesh("2x4", positions=True)
    rows = B // mesh.shape["data"]
    head = cfg.d_model * cfg.vocab * 2                       # bf16
    cache_row = rows * 4096 * cfg.n_kv_heads * cfg.head_dim * 2
    got = _decode_cell(cfg, mesh, 4096)["memory"]["largest_storage"]
    assert len(got) == 8
    assert max(got.values()) < min(head, cache_row), got
    whole = _decode_cell(cfg, mesh, 4096, whole_leaves=True)
    assert max(whole["memory"]["largest_storage"].values()) >= min(
        head, cache_row)


# ------------------------------------------------- one layer, the combine
def _split(p, M, j, rows=("wo",)):
    """Position ``j``'s pieces of one layer's leaves: ``rows`` split by
    rows, other matrices by columns, vectors whole."""
    out = {}
    for k, w in p.items():
        if w.ndim < 2 or k in ("w_dkv", "w_krope"):
            out[k] = w
            continue
        dim = 0 if k in rows else 1
        n = w.shape[dim] // M
        out[k] = w.narrow(dim, j * n, n)
    return out


def _row(M):
    return tuple(torch.device(CPU) for _ in range(M))


def _bar(dt, got, want):
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= BF16_ULPS * 2.0 ** -7 * float(want.float().abs().max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mistral-nemo-12b", "whisper-large-v3"])
def test_attn_decode_tp_is_attn_decode(name, dt):
    """One layer, 4 positions, 32-line cache: ``attn_decode_tp`` on the
    pieces against ``attn_decode`` on the whole cache, at cursors 5..24,
    and the pieces written where ``attn_decode`` writes."""
    cfg = reduced(ARCHS[name]).replace(compute_dtype=str(dt)[6:])
    p = attention.attn_init(torch.Generator().manual_seed(0), cfg)
    M, S, Hkv, dh = 4, 32, cfg.n_kv_heads, cfg.head_dim
    P = S // M
    for idx in range(5, 25):
        g = torch.Generator().manual_seed(idx)
        x = torch.randn(4, 1, cfg.d_model, generator=g).to(dt)
        k = torch.randn(4, S, Hkv, dh, generator=g).to(dt)
        v = torch.randn(4, S, Hkv, dh, generator=g).to(dt)
        one = attention.KVCache(k.clone(), v.clone(), idx)
        want, one = attention.attn_decode(cfg, p, x, one, cfg.use_rope)
        caches = [attention.KVCache(k[:, j * P:(j + 1) * P].clone(),
                                    v[:, j * P:(j + 1) * P].clone(), idx)
                  for j in range(M)]
        with mesh_lib.tensor_parallel(_row(M)):
            outs, caches = attention.attn_decode_tp(
                cfg, [_split(p, M, j) for j in range(M)], [x] * M, caches,
                cfg.use_rope)
        for o in outs:
            _bar(dt, o, want)
        assert torch.equal(torch.cat([c.k for c in caches], 1), one.k)
        assert all(c.index == idx + 1 for c in caches)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_mla_decode_tp_is_mla_decode(dt):
    """One MLA layer (reduced deepseek, 4 heads on 4 positions), 32-line
    latent cache: ``mla_decode_tp`` against ``mla_decode``, per-row cursors
    spread over the pieces."""
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"]).replace(
        compute_dtype=str(dt)[6:])
    p = mla.mla_init(torch.Generator().manual_seed(0), cfg)
    M, S = 4, 32
    P = S // M
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 1, cfg.d_model, generator=g).to(dt)
    c = torch.randn(4, S, cfg.kv_lora, generator=g).to(dt)
    kr = torch.randn(4, S, cfg.qk_rope_dims, generator=g).to(dt)
    pos = torch.tensor([3, 9, 20, 31])
    want, one = mla.mla_decode(cfg, p, x, mla.MLACache(c.clone(), kr.clone(),
                                                       0), positions=pos)
    caches = [mla.MLACache(c[:, j * P:(j + 1) * P].clone(),
                           kr[:, j * P:(j + 1) * P].clone(), 0)
              for j in range(M)]
    with mesh_lib.tensor_parallel(_row(M)):
        outs, caches = mla.mla_decode_tp(
            cfg, [_split(p, M, j) for j in range(M)], [x] * M, caches,
            [pos] * M)
    assert mla.tp_splits["flash-decoding"] == 1
    for o in outs:
        _bar(dt, o, want)
    assert torch.equal(torch.cat([c.c_kv for c in caches], 1), one.c_kv)
