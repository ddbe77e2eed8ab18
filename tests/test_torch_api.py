"""Port vs reference: the single-device entry point ``stkde``."""
import numpy as np
import pytest
import torch

from repro.core import get_instance as ref_get_instance
from repro.core.api import stkde as ref_stkde
from repro.core.api import validate_inputs as ref_validate_inputs
from repro.resilience import errors as ref_errors

from repro_torch import convert
from repro_torch.core import get_instance, stkde
from repro_torch.core.api import validate_inputs
from repro_torch.resilience import ensure_finite
from repro_torch.resilience import errors

TOL = dict(rtol=1e-5, atol=1e-8)


@pytest.fixture(scope="module")
def dengue():
    ref_inst = ref_get_instance("Dengue_Lr-Hb").scaled(200_000, 2_000)
    inst = get_instance("Dengue_Lr-Hb").scaled(200_000, 2_000)
    pts = inst.points()
    np.testing.assert_array_equal(pts, ref_inst.points())
    return ref_inst.domain(), inst.domain(), pts


@pytest.mark.parametrize("tiled", [False, True])
def test_stkde_matches_reference(dengue, tiled):
    ref_dom, dom, pts = dengue
    want = np.asarray(ref_stkde(pts, ref_dom, use_tiled_kernel=tiled))
    got = stkde(pts, dom, use_tiled_kernel=tiled, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == dom.grid_shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_stkde_branches_agree_and_mass_is_conserved(dengue):
    _, dom, pts = dengue
    a = stkde(pts, dom, device="cpu")
    b = stkde(pts, dom, use_tiled_kernel=True, device="cpu")
    np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    # Hs=25 on a 52x52 grid: about half of every disk falls off the edge
    mass = float(a.sum()) * dom.sres ** 2 * dom.tres
    assert 0.3 < mass <= 1.0 + 1e-3


def _bad_inputs(dom):
    good = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]], dtype=np.float32)
    nan = good.copy()
    nan[1, 0] = np.nan
    late = good.copy()
    late[0, 2] = dom.ot + dom.gt + dom.ht + 5.0
    return [
        (np.zeros((4, 2), np.float32), dom),
        (np.zeros((0, 3), np.float32), dom),
        (nan, dom),
        (good, dom.with_bandwidth(0.0, 1.0)),
        (good, dom.with_resolution(1.0, -1.0)),
        (late, dom),
    ]


@pytest.mark.parametrize("i", range(6))
def test_validate_inputs_rejects_like_the_reference(dengue, i):
    ref_dom, dom, _ = dengue
    pts, bad_dom = _bad_inputs(dom)[i]
    _, bad_ref_dom = _bad_inputs(ref_dom)[i]
    with pytest.raises(ref_errors.ReproValidationError) as want:
        ref_validate_inputs(pts, bad_ref_dom)
    with pytest.raises(errors.ReproValidationError) as got:
        validate_inputs(pts, bad_dom)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    with pytest.raises(errors.ReproValidationError):
        stkde(pts, bad_dom, device="cpu")


def test_validate_inputs_returns_float32(dengue):
    _, dom, pts = dengue
    out = validate_inputs(pts.astype(np.float64).tolist(), dom)
    assert out.dtype == np.float32 and out.shape == pts.shape


def test_ensure_finite_raises_on_nan_grid():
    grid = torch.ones((4, 5, 6))
    assert ensure_finite(grid, "t") is grid
    grid[1, 2, 3] = float("nan")
    grid[0, 0, 0] = float("inf")
    with pytest.raises(errors.NonFiniteOutputError,
                       match=r"t: 2/120 non-finite cells in output grid"):
        ensure_finite(grid, "t")


def test_stkde_without_a_card_raises(dengue):
    _, dom, pts = dengue
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    for tiled in (False, True):
        with pytest.raises(errors.KernelUnavailableError, match="CUDA"):
            stkde(pts, dom, use_tiled_kernel=tiled)


def test_domain_from_reference_reads_attributes_only(dengue):
    ref_dom, dom, _ = dengue

    class Bag:
        pass

    bag = Bag()
    for k in ("gx", "gy", "gt", "sres", "tres", "hs", "ht", "ox", "oy", "ot"):
        setattr(bag, k, getattr(ref_dom, k))
    assert convert.domain_from_reference(bag) == dom
