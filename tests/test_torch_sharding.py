"""Port vs reference: the placement rules of ``distributed/sharding.py``.

``param_specs`` (with and without FSDP), ``fsdp_only_param_specs``,
``data_specs`` (with and without the model axis), ``decode_state_specs`` and
the hint rule are held **equal**, spec for spec, to the reference's, for
the ten configs: ``reduced`` trees on (4, 2) and (2, 2, 2) meshes, and the
full-size trees of ``launch.specs.param_specs_abstract`` on the production
shapes (16, 16) and (2, 16, 16). The reference's rules read only a mesh's
``shape`` and ``axis_names``, so its side runs in this process on a
stand-in with those two (no 256 fake devices), and its ``hint`` is asked
for the spec it would hand ``with_sharding_constraint``.

The port's decode state keeps one cache per layer, batch first, where the
reference stacks them on a leading L axis: each per-layer entry is held to
the reference's stacked spec without its leading entry.

Also the port's twins of the four cases of ``tests/test_sharding_hints.py``
and of ``test_sharding_rules_cover_all_archs`` of
``tests/test_dryrun_machinery.py``, and ``shard_tree`` / ``gather_tree``:
bit for bit, pieces on one device that share no storage.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.distributed import sharding as ref_sh
from repro.launch import specs as ref_specs
from repro.models import model as ref_model

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh
from repro_torch.distributed import sharding as sh
from repro_torch.launch import make_production_mesh
from repro_torch.launch import specs
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.model import init_decode_state

CPU = "cpu"
NAMES = sorted(REF_ARCHS)
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
SMALL, FULL = ("4x2", "2x2x2"), ("16x16", "2x16x16")


def _stand_in(shape, names):
    """What the reference's rules read of a mesh."""
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=tuple(names))


def _mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, CPU, dtype=object), names), \
        _stand_in(shape, names)


def _flat(tree, prefix=""):
    """path -> leaf for a tree of dicts (either package's), leaves being
    specs (``P`` / ``PartitionSpec``) or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _same_specs(got_tree, want_tree):
    got, want = _flat(got_tree), _flat(want_tree)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], sh.P), k
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])
    return len(want)


_TREES = {}


def _trees(name, size):
    """(port tree, reference tree) of parameters: the ``reduced`` config's
    real weights (port) and abstract ones (reference), or the full config's
    meta / abstract trees."""
    key = (name, size)
    if key not in _TREES:
        if size == "reduced":
            _TREES[key] = (init_params(reduced(ARCHS[name]), device=CPU,
                                       seed=0),
                           ref_specs.param_specs_abstract(
                               ref_reduced(REF_ARCHS[name])))
        else:
            _TREES[key] = (specs.param_specs_abstract(ARCHS[name]),
                           ref_specs.param_specs_abstract(REF_ARCHS[name]))
    return _TREES[key]


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("tag", SMALL + FULL)
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_the_reference(name, tag):
    size = "reduced" if tag in SMALL else "full"
    ours, theirs = _trees(name, size)
    mesh, stand_in = _mesh(tag)
    for fsdp in (True, False):
        _same_specs(sh.param_specs(ours, mesh, fsdp=fsdp),
                    ref_sh.param_specs(theirs, stand_in, fsdp=fsdp))
    _same_specs(sh.fsdp_only_param_specs(ours, mesh),
                ref_sh.fsdp_only_param_specs(theirs, stand_in))


def test_abstract_params_have_the_references_tree():
    """``param_specs_abstract`` (meta tensors from a shape-only walk of the
    init) gives the reference's ``eval_shape`` tree: same paths, shapes and
    dtypes, and no storage."""
    for name in NAMES:
        ours, theirs = _trees(name, "full")
        got, want = _flat(ours), _flat(theirs)
        assert set(got) == set(want), name
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), (name, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)


def test_sharding_rules_cover_all_archs():
    """Every param leaf gets a valid spec; sharded axes divide dims (the
    reference's case, on the port's (2, 2, 2) mesh)."""
    mesh, _ = _mesh("2x2x2")
    for name in NAMES:
        ours, _ = _trees(name, "reduced")
        flat_p = _flat(ours)
        flat_s = _flat(sh.param_specs(ours, mesh, fsdp=True))
        assert set(flat_p) == set(flat_s), name
        for k, arr in flat_p.items():
            spec = flat_s[k]
            assert len(spec) <= arr.ndim
            for i, ax in enumerate(spec):
                if ax is None:
                    continue
                size = np.prod([mesh.shape[a] for a in sh.P.axes_of(ax)])
                assert arr.shape[i] % size == 0, (name, arr.shape, spec)


# ------------------------------------------------------------------- data
def _batches(cfg, B, S):
    b = {"tokens": np.zeros((B, S), np.int32),
         "labels": np.zeros((B, S), np.int32)}
    if cfg.frontend == "vision":
        b["vision_embeds"] = np.zeros((B, cfg.n_vision_tokens, 8),
                                      np.float32)
    if cfg.enc_dec:
        b["audio_frames"] = np.zeros((B, cfg.enc_seq, 8), np.float32)
    b["scalar"] = np.zeros((), np.float32)
    return b


@pytest.mark.parametrize("tag", SMALL + FULL)
def test_data_specs_equal_the_reference(tag):
    mesh, stand_in = _mesh(tag)
    n = 0
    for name in NAMES:
        cfg = reduced(ARCHS[name])
        for B in (512, 256, 64, 16, 8, 6, 4, 2, 1):
            b = _batches(cfg, B, 4)
            for inc in (False, True):
                n += _same_specs(
                    sh.data_specs(b, mesh, include_model=inc),
                    ref_sh.data_specs(b, stand_in, include_model=inc))
    assert n > 0


# ----------------------------------------------------------- decode state
def _state_specs_equal(cfg, ref_cfg, B, S, mesh, stand_in, per_row=False):
    ours = init_decode_state(cfg, B, S, torch.bfloat16, device="meta",
                             per_row=per_row)
    theirs = jax.eval_shape(lambda: ref_model.init_decode_state(
        ref_cfg, B, S, jnp.bfloat16, per_row=per_row))
    got = sh.decode_state_specs(cfg, ours, mesh)
    want = ref_sh.decode_state_specs(ref_cfg, theirs, stand_in)
    for field in ("layer", "shared"):
        w = getattr(want, field)
        g = getattr(got, field)
        if w is None:
            assert g is None
            continue
        for per_layer in g:
            assert per_layer._fields == w._fields
            for f in w._fields:
                assert tuple(getattr(per_layer, f)) == tuple(
                    getattr(w, f))[1:], (field, f)
    if want.cross is None:
        assert got.cross is None
    else:
        assert [tuple(s) for s in got.cross] == [tuple(s)
                                                 for s in want.cross]
    assert tuple(got.step) == tuple(want.step)


@pytest.mark.parametrize("tag", SMALL)
@pytest.mark.parametrize("name", NAMES)
def test_decode_state_specs_equal_the_reference_reduced(name, tag):
    mesh, stand_in = _mesh(tag)
    cfg, ref_cfg = reduced(ARCHS[name]), ref_reduced(REF_ARCHS[name])
    for B, S in ((8, 64), (4, 32), (2, 64), (1, 64), (3, 24)):
        _state_specs_equal(cfg, ref_cfg, B, S, mesh, stand_in)
    _state_specs_equal(cfg, ref_cfg, 8, 64, mesh, stand_in, per_row=True)


@pytest.mark.parametrize("tag", FULL)
def test_decode_state_specs_equal_the_reference_full(tag):
    mesh, stand_in = _mesh(tag)
    for name in NAMES:
        cfg = ARCHS[name]
        for cell in ("decode_32k", "long_500k"):
            c = specs.SHAPES[cell]
            _state_specs_equal(cfg, REF_ARCHS[name], c.global_batch,
                               c.seq_len, mesh, stand_in)


# ------------------------------------------------------------------ hints
def _ref_hint_spec(monkeypatch, stand_in, shape, axes):
    """The spec the reference's ``hint`` hands ``with_sharding_constraint``
    (both it and ``NamedSharding`` stubbed to give the spec back)."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    monkeypatch.setattr(ref_sh, "NamedSharding", lambda m, s: s)
    with ref_sh.hint_mesh(stand_in):
        return ref_sh.hint(np.zeros(shape, np.int8), *axes)


HINT_CASES = [
    ((8, 4), ("batch", "model")),
    ((3, 4), ("batch", "model")),
    ((8, 64, 4, 2), ("batch", "seq", None, None)),
    ((1, 64, 4, 2), ("batch", "seq", None, None)),
    ((1, 48, 4, 2), ("batch", "seq", None, None)),
    ((2, 512, 16), ("batch", "seq", "model")),
    ((6, 30), ("batch", "seq")),
    ((16, 3), (None, "seq")),
    ((32, 16), ("data", "model")),
    ((5, 7), ("pod", "data")),
    ((4, 4), ("pod", None)),
    ((256, 32), ("batch", None)),
    ((512, 1024, 8), ("batch", "seq", None)),
]


@pytest.mark.parametrize("tag", SMALL + FULL)
def test_hint_spec_equals_the_reference(monkeypatch, tag):
    mesh, stand_in = _mesh(tag)
    for shape, axes in HINT_CASES:
        want = _ref_hint_spec(monkeypatch, stand_in, shape, axes)
        assert sh.hint_spec(shape, *axes) is None           # no mesh
        with sh.hint_mesh(mesh):
            got = sh.hint_spec(shape, *axes)
        assert tuple(got) == tuple(want), (shape, axes, got, want)
        assert tuple(sh.hint_spec(shape, *axes, mesh=mesh)) == tuple(want)


def test_hint_is_noop_without_mesh():
    x = torch.ones((4, 8))
    assert sh.hint(x, "batch", "model") is x  # literally untouched
    assert sh.active_mesh() is None


def test_hint_applies_under_mesh():
    mesh = sh.Mesh(np.full((4, 2), CPU, dtype=object), ("data", "model"))
    x = torch.ones((8, 4))
    with sh.hint_mesh(mesh):
        assert sh.active_mesh() is mesh
        assert sh.hint_spec(x.shape, "batch", "model") == sh.P("data",
                                                               "model")
        assert sh.hint(x * 2, "batch", "model").equal(x * 2)
    assert sh.active_mesh() is None


def test_hint_drops_nondivisible_axes():
    mesh = sh.Mesh(np.full((4, 2), CPU, dtype=object), ("data", "model"))
    with sh.hint_mesh(mesh):
        # dim0=3 not divisible by 4 -> dropped; dim1=4 divisible by 2
        assert sh.hint_spec((3, 4), "batch", "model") == sh.P(None, "model")


def test_decode_consistency_with_hints_active():
    """Hints must not change decode numerics (only placement)."""
    cfg = reduced(ARCHS["mistral-nemo-12b"])
    params = init_params(cfg, device=CPU, seed=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 8)))
    _, st = prefill(cfg, params, toks, max_seq=32)
    ref, _ = decode_step(cfg, params, toks[:, :1], st)
    _, st = prefill(cfg, params, toks, max_seq=32)
    mesh = sh.Mesh(np.full((4, 2), CPU, dtype=object), ("data", "model"))
    with sh.hint_mesh(mesh):
        got, _ = decode_step(cfg, params, toks[:, :1], st)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_spec_normalises_like_partition_spec():
    from jax.sharding import PartitionSpec

    for entries in ((("data",), None), (("pod", "data"), "model"), (),
                    (None, ("model",))):
        assert tuple(sh.P(*entries)) == tuple(PartitionSpec(*entries))
    assert sh.P(("data",), None) == sh.P("data", None)
    assert sh.P(("pod", "data"), "model").mesh_axes() == ("pod", "data",
                                                          "model")


# ------------------------------------------------------------- placement
def test_production_mesh_shapes():
    for multi_pod, tag in ((False, "16x16"), (True, "2x16x16")):
        m = make_production_mesh(multi_pod=multi_pod, device=CPU)
        shape, names = MESHES[tag]
        assert m.devices.shape == shape and m.axis_names == names
        assert {str(d) for d in m.devices.flat} == {CPU}


@pytest.mark.parametrize("tag", SMALL)
@pytest.mark.parametrize("name", ["smollm-360m", "dbrx-132b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_shard_then_gather_is_bit_exact(name, tag):
    params, _ = _trees(name, "reduced")
    mesh, _ = _mesh(tag)
    specs_tree = sh.param_specs(params, mesh, fsdp=True)
    placed = sh.shard_tree(params, specs_tree, mesh)
    back = sh.gather_tree(placed)
    flat_p, flat_s, flat_b = _flat(params), _flat(placed), _flat(back)
    n_split = 0
    for k, v in flat_p.items():
        leaf = flat_s[k]
        assert isinstance(leaf, sh.Sharded)
        assert leaf.shape == v.shape and leaf.dtype == v.dtype
        assert leaf.pieces.shape == tuple(
            mesh.shape[a] for a in leaf.spec.mesh_axes())
        assert flat_b[k].dtype == v.dtype and torch.equal(flat_b[k], v), k
        ptrs = {p.data_ptr() for p in leaf.pieces.flat}
        assert len(ptrs) == leaf.pieces.size       # no piece is a view
        assert v.data_ptr() not in ptrs
        n_split += leaf.pieces.size > 1
    assert n_split > 0


def test_pieces_on_one_device_do_not_alias():
    mesh, _ = _mesh("2x2x2")
    w = torch.arange(64.0).reshape(8, 8)
    leaf = sh.shard(w, sh.P(("pod", "data"), "model"), mesh)
    assert leaf.pieces.shape == (2, 2, 2)
    before = [p.clone() for p in leaf.pieces.flat]
    leaf.pieces[0, 0, 0].add_(1000.0)
    for i, p in enumerate(leaf.pieces.flat):
        if i:
            assert torch.equal(p, before[i])
    assert torch.equal(w, torch.arange(64.0).reshape(8, 8))
    # the row-major order of the split: (pod, data) over rows, model cols
    np.testing.assert_array_equal(leaf.pieces[1, 0, 1].numpy(),
                                  w[4:6, 4:8].numpy())
    rep = sh.shard(w, sh.P(), mesh)
    assert rep.pieces.shape == () and torch.equal(sh.gather(rep), w)
