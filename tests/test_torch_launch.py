"""Port vs reference: ``launch/``'s chip-free parts.

``SHAPES`` and ``cell_applicable`` equal the reference's for the ten
configs; the ``train`` / ``prefill`` / ``decode`` input specs (meta tensors
in the port, ``ShapeDtypeStruct`` in the reference) have the reference's
shapes and dtypes (the port's decode state keeps one cache per layer where
the reference stacks them: each layer's entry is the reference's stacked
leaf without its leading L); ``algo_flops``, ``algo_hbm_bytes`` and
``model_flops_estimate`` equal the reference's to ``rtol=1e-12`` for the ten
full configs x the four shape cells; ``Roofline`` given the reference's
hardware numbers gives the reference's terms; ``delta_extrapolate``'s clamps
and ``format_table``'s text match; ``make_production_mesh`` has the
reference's shapes and axis names. Everything here is pure arithmetic on
both sides and runs in this process.
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import roofline as ref_rl
from repro.launch import specs as ref_specs

from repro_torch.configs import ARCHS
from repro_torch.launch import make_production_mesh
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs

NAMES = sorted(REF_ARCHS)
CELLS = sorted(ref_specs.SHAPES)


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def test_shapes_and_applicability_equal_the_reference():
    assert sorted(specs.SHAPES) == CELLS
    for k in CELLS:
        a, b = specs.SHAPES[k], ref_specs.SHAPES[k]
        assert (a.name, a.kind, a.seq_len, a.global_batch) == (
            b.name, b.kind, b.seq_len, b.global_batch)
    for name in NAMES:
        for k in CELLS:
            assert specs.cell_applicable(ARCHS[name], specs.SHAPES[k]) == \
                ref_specs.cell_applicable(REF_ARCHS[name],
                                          ref_specs.SHAPES[k])


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_input_specs_have_the_references_shapes_and_dtypes(kind):
    ours_fn = getattr(specs, f"{kind}_input_specs")
    theirs_fn = getattr(ref_specs, f"{kind}_input_specs")
    for name in NAMES:
        for k in CELLS:
            ours = ours_fn(ARCHS[name], specs.SHAPES[k])
            theirs = theirs_fn(REF_ARCHS[name], ref_specs.SHAPES[k])
            assert sorted(ours) == sorted(theirs)
            for key, t in theirs.items():
                assert ours[key].device.type == "meta"
                assert tuple(ours[key].shape) == tuple(t.shape), (name, key)
                assert _dtype(ours[key]) == str(t.dtype), (name, key)


def test_decode_input_specs_have_the_references_shapes_and_dtypes():
    for name in NAMES:
        for k in ("decode_32k", "long_500k"):
            ours = specs.decode_input_specs(ARCHS[name], specs.SHAPES[k])
            theirs = ref_specs.decode_input_specs(REF_ARCHS[name],
                                                  ref_specs.SHAPES[k])
            tok, rtok = ours["token"], theirs["token"]
            assert tuple(tok.shape) == tuple(rtok.shape)
            assert _dtype(tok) == str(rtok.dtype) == "int32"
            st, rst = ours["state"], theirs["state"]
            for field in ("layer", "shared"):
                ref_field = getattr(rst, field)
                if ref_field is None:
                    assert getattr(st, field) is None
                    continue
                for cache in getattr(st, field):
                    for f in ref_field._fields:
                        want = getattr(ref_field, f)
                        got = getattr(cache, f)
                        if f == "index":       # the port's cursor is an int
                            assert isinstance(got, int)
                            continue
                        assert got.device.type == "meta"
                        assert tuple(got.shape) == tuple(want.shape)[1:], (
                            name, field, f)
                        assert _dtype(got) == str(want.dtype), (name, f)
            if rst.cross is None:
                assert st.cross is None
            else:
                for got, want in zip(st.cross, rst.cross):
                    assert tuple(got.shape) == tuple(want.shape)
                    assert _dtype(got) == str(want.dtype)


@pytest.mark.parametrize("name", NAMES)
def test_roofline_arithmetic_equals_the_reference(name):
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    for k in CELLS:
        c = specs.SHAPES[k]
        args = (c.kind, c.seq_len, c.global_batch)
        for fn in ("algo_flops", "algo_hbm_bytes", "model_flops_estimate"):
            got = getattr(rl, fn)(cfg, *args)
            want = getattr(ref_rl, fn)(ref_cfg, *args)
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       err_msg=f"{fn} {k}")
    # small shapes too (decode of one token, a short train)
    for args in (("decode", 128, 1), ("train", 256, 8), ("prefill", 64, 3)):
        for fn in ("algo_flops", "algo_hbm_bytes", "model_flops_estimate"):
            np.testing.assert_allclose(getattr(rl, fn)(cfg, *args),
                                       getattr(ref_rl, fn)(ref_cfg, *args),
                                       rtol=1e-12)


def test_roofline_terms_equal_the_reference_on_its_hardware():
    """``Roofline`` has no hardware of its own: given the reference's
    constants it gives the reference's terms."""
    hw = dict(peak_flops=ref_rl.PEAK_FLOPS, hbm_bw=ref_rl.HBM_BW,
              link_bw=ref_rl.ICI_BW)
    for name in NAMES:
        cfg = ARCHS[name]
        for k in CELLS:
            c = specs.SHAPES[k]
            args = (c.kind, c.seq_len, c.global_batch)
            counts = dict(flops=rl.algo_flops(cfg, *args),
                          hbm_bytes=rl.algo_hbm_bytes(cfg, *args),
                          coll_bytes_per_dev=3.5e9, chips=256,
                          model_flops=rl.model_flops_estimate(cfg, *args))
            got = rl.Roofline(**counts, **hw).to_dict()
            want = ref_rl.Roofline(**counts).to_dict()
            for key, w in want.items():
                if isinstance(w, str):
                    assert got[key] == w
                else:
                    np.testing.assert_allclose(got[key], w, rtol=1e-12,
                                               err_msg=key)
            for key, v in hw.items():
                assert got[key] == v
    with pytest.raises(TypeError):
        rl.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes_per_dev=0.0,
                    chips=1)                         # no default hardware
    zero = rl.Roofline(0.0, 0.0, 0.0, 1, 1.0, 1.0, 1.0)
    assert zero.useful_flops_ratio == 0.0 and zero.mfu_bound == 0.0


def test_delta_extrapolate_clamps_as_the_reference():
    cases = [(10.0, 20.0, 1, 2, 40), (20.0, 10.0, 1, 2, 40),
             (5.0, 5.0, 2, 2, 9), (1.0, 1.5, 2, 4, 64), (3.0, -1.0, 1, 3, 8),
             (0.0, 0.0, 1, 2, 3), (7.0, 9.0, 6, 12, 81)]
    for c in cases:
        assert rl.delta_extrapolate(*c) == ref_rl.delta_extrapolate(*c), c


def test_format_table_matches_the_reference():
    rows = [{"arch": "smollm-360m", "cell": "train_4k", "t": 0.125},
            {"arch": "dbrx-132b", "cell": "decode_32k", "t": 12.5,
             "extra": "x"},
            {"arch": "x", "t": None}]
    for keys in (["arch", "cell", "t"], ["t"], ["arch", "missing"]):
        assert rl.format_table(rows, keys) == ref_rl.format_table(rows, keys)


def test_production_mesh_has_the_references_shapes():
    # the reference's make_production_mesh needs 256 / 512 devices; its
    # shapes and names are fixed in its source (launch/mesh.py:13-14)
    m = make_production_mesh(device="cpu")
    assert m.devices.shape == (16, 16) and m.axis_names == ("data", "model")
    assert m.shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True, device="cpu")
    assert m.devices.shape == (2, 16, 16)
    assert m.axis_names == ("pod", "data", "model")
    assert {d.type for d in m.devices.flat} == {"cpu"}
    # the reference's import path has the host-mesh constructors too
    h = launch_mesh.make_host_mesh(8, device="cpu")
    assert h.shape == {"data": 4, "model": 2}
    assert launch_mesh.shrink_mesh(h).shape == {"data": 3, "model": 2}


def test_production_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.resilience.errors import KernelUnavailableError

    with pytest.raises(KernelUnavailableError):
        make_production_mesh()
