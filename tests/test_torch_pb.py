"""Port vs reference: the point-based scatter path (all four variants)."""
import numpy as np
import pytest
import torch

from repro.core import Domain as RefDomain
from repro.core import clustered_events
from repro.core import kernels_math as ref_km
from repro.core.pb import pb as ref_pb

from repro_torch import convert
from repro_torch.core import kernels_math as km
from repro_torch.core.pb import (VARIANTS, _add_in_order, _block_size,
                                  _pb_impl, pb, pb_sym)

from test_torch_foundations import NONUNIT, TILE_CASES

TOL = dict(rtol=1e-5, atol=1e-8)


def _case(i):
    grid, hs, ht, _ = TILE_CASES[i]
    ref = RefDomain(gx=float(grid[0]), gy=float(grid[1]), gt=float(grid[2]),
                    sres=1.0, tres=1.0, hs=hs, ht=ht)
    return ref, convert.domain_from_reference(ref), clustered_events(
        300, ref, seed=7 + i)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("i", range(len(TILE_CASES)))
def test_pb_variants_match_reference(i, variant):
    ref, dom, pts = _case(i)
    want = np.asarray(ref_pb(pts, ref, variant=variant))
    got = pb(pts, dom, variant=variant, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == dom.grid_shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pb_several_blocks_and_padding():
    """A small budget forces many blocks and a padded last block."""
    ref, dom, pts = _case(0)
    want = np.asarray(ref_pb(pts, ref, budget_elems=1 << 12))
    got = pb(pts, dom, budget_elems=1 << 12, device="cpu")
    assert _block_size(dom, 1 << 12) < len(pts)
    assert len(pts) % _block_size(dom, 1 << 12) != 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pb_nonunit_resolution_and_origin():
    ref = RefDomain(**NONUNIT)
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(4)
    pts = (np.array([-7.0, 3.0, 100.0])
           + rng.random((300, 3)) * np.array([20.0, 15.0, 30.0])
           ).astype(np.float32)
    want = np.asarray(ref_pb(pts, ref))
    np.testing.assert_allclose(pb_sym(pts, dom, device="cpu").numpy(), want,
                               **TOL)


def test_pb_paper_verbatim_kernels():
    ref, dom, pts = _case(1)
    want = np.asarray(ref_pb(pts, ref, ks=ref_km.ks_paper_verbatim,
                             kt=ref_km.kt_paper_verbatim))
    got = pb(pts, dom, ks=km.ks_paper_verbatim, kt=km.kt_paper_verbatim,
             device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pb_n_total_override():
    ref, dom, pts = _case(2)
    want = np.asarray(ref_pb(pts, ref, n_total=5 * len(pts)))
    got = pb(pts, dom, n_total=5 * len(pts), device="cpu").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got * 5, pb(pts, dom, device="cpu").numpy(), rtol=1e-6, atol=1e-9)


def test_pb_point_outside_domain():
    """A point outside the box still radiates the in-domain part of its
    cylinder; one far outside contributes nothing."""
    ref, dom, _ = _case(0)
    pts = np.array([[-1.5, 4.0, 3.0], [10.0, 26.5, 8.0], [500.0, 5.0, 5.0],
                    [12.0, 12.0, 8.0]], dtype=np.float32)
    want = np.asarray(ref_pb(pts, ref))
    got = pb(pts, dom, device="cpu").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got[0, 4, 3] > 0 and got[10, 24, 8] > 0


def test_pb_rejects_unknown_variant_and_huge_grid():
    ref, dom, pts = _case(0)
    with pytest.raises(ValueError, match="variant"):
        pb(pts, dom, variant="nope", device="cpu")
    big = convert.domain_from_reference(
        RefDomain(gx=1024, gy=1024, gt=1024, sres=1, tres=1, hs=1, ht=1))
    with pytest.raises(ValueError, match="2\\^30"):
        pb(pts, big, device="cpu")


def test_add_in_order_is_index_add_with_one_add_per_voxel():
    """The chunked path's fixed-order adds give what ``index_add_`` gives:
    bit for bit on integer-valued terms (every order sums them exactly),
    within rounding on real ones, the drop slot included."""
    rng = np.random.default_rng(3)
    lin = torch.from_numpy(rng.integers(0, 50, 20_000))
    for vals in (torch.from_numpy(rng.integers(-9, 10, 20_000)).float(),
                 torch.from_numpy(rng.random(20_000, np.float32))):
        got = torch.zeros(51)
        _add_in_order(got, lin, vals)
        want = torch.zeros(51).index_add_(0, lin, vals)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-8)
        if vals.eq(vals.round()).all():
            assert torch.equal(got, want)


def test_deterministic_scatter_changes_nothing_on_the_cpu():
    ref, dom, pts = _case(0)
    t = torch.from_numpy(pts)
    args = (dom, "sym", km.DEFAULT_KS, km.DEFAULT_KT, 1 << 12)
    assert torch.equal(_pb_impl(t, *args, deterministic=True),
                       _pb_impl(t, *args))
