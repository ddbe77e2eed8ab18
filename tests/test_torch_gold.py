"""Port vs reference: the gold standards VB and VB-DEC, the four PB variants
held against VB, and PB's evaluation-only phase (counterparts of
``tests/test_stkde_core.py::TestEquivalence``), at the reference's bars."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import Domain as RefDomain
from repro.core import clustered_events
from repro.core import kernels_math as ref_km
from repro.core.pb import pb as ref_pb
from repro.core.pb import pb_eval_only as ref_pb_eval_only
from repro.core.vb import vb as ref_vb
from repro.core.vb import vb_dec as ref_vb_dec

from repro_torch import convert
from repro_torch.core import kernels_math as km
from repro_torch.core.pb import VARIANTS, pb, pb_eval_only
from repro_torch.core.vb import vb, vb_dec
from repro_torch.resilience.errors import KernelUnavailableError

from test_torch_foundations import NONUNIT

TOL = dict(rtol=1e-5, atol=1e-8)
PROPERTY_TOL = dict(rtol=1e-4, atol=1e-7)
VERBATIM = dict(ks=km.ks_paper_verbatim, kt=km.kt_paper_verbatim)
REF_VERBATIM = dict(ks=ref_km.ks_paper_verbatim, kt=ref_km.kt_paper_verbatim)


def _small(hs=3.0, ht=2.0):
    ref = RefDomain(gx=24.0, gy=18.0, gt=14.0, sres=1.0, tres=1.0, hs=hs,
                    ht=ht)
    return ref, convert.domain_from_reference(ref)


def test_vb_matches_reference():
    ref, dom = _small()
    pts = clustered_events(300, ref, seed=0)
    want = np.asarray(ref_vb(jnp.asarray(pts), ref))
    got = vb(pts, dom, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == dom.grid_shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vb_panels_match_reference():
    """A small budget cuts every slice into many point panels."""
    ref, dom = _small()
    pts = clustered_events(300, ref, seed=3)
    want = np.asarray(ref_vb(jnp.asarray(pts), ref))
    got = vb(pts, dom, budget_elems=24 * 18 * 7, device="cpu")  # 7 points
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vb_nonunit_resolution_and_origin():
    ref = RefDomain(**NONUNIT)
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(4)
    pts = (np.array([-7.0, 3.0, 100.0])
           + rng.random((200, 3)) * np.array([20.0, 15.0, 30.0])
           ).astype(np.float32)
    want = np.asarray(ref_vb(jnp.asarray(pts), ref))
    np.testing.assert_allclose(vb(pts, dom, device="cpu").numpy(), want,
                               **TOL)


@pytest.mark.parametrize("budget", [1 << 26, 8 * 8 * 8 * 64])
def test_vb_dec_matches_reference(budget):
    """Default budget: every tile at once; small: batches of a few tiles."""
    ref, dom = _small()
    pts = clustered_events(300, ref, seed=1)
    want = np.asarray(ref_vb_dec(pts, ref))
    got = vb_dec(pts, dom, budget_elems=budget, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == dom.grid_shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vb_dec_matches_vb():
    ref, dom = _small()
    pts = clustered_events(300, ref, seed=1)
    np.testing.assert_allclose(vb_dec(pts, dom, device="cpu").numpy(),
                               vb(pts, dom, device="cpu").numpy(), **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pb_variants_match_vb(variant):
    ref, dom = _small()
    pts = clustered_events(300, ref, seed=0)
    gold = vb(pts, dom, device="cpu").numpy()
    got = pb(pts, dom, variant=variant, device="cpu").numpy()
    np.testing.assert_allclose(got, gold, **TOL)


@settings(max_examples=12, deadline=None)
@given(
    hs=st.floats(0.6, 4.5),
    ht=st.floats(0.6, 3.5),
    sres=st.floats(0.5, 1.5),
    tres=st.floats(0.5, 1.5),
    n=st.integers(5, 120),
    seed=st.integers(0, 10_000),
)
def test_property_pb_equals_reference_vb(hs, ht, sres, tres, n, seed):
    ref = RefDomain(gx=16.0, gy=12.0, gt=10.0, sres=sres, tres=tres, hs=hs,
                    ht=ht)
    dom = convert.domain_from_reference(ref)
    pts = clustered_events(n, ref, seed=seed)
    gold = np.asarray(ref_vb(jnp.asarray(pts), ref))
    got = pb(pts, dom, device="cpu").numpy()
    np.testing.assert_allclose(got, gold, **PROPERTY_TOL)


def test_paper_verbatim_kernels_also_equivalent():
    ref, dom = _small()
    pts = clustered_events(100, ref, seed=2)
    want = np.asarray(ref_vb(jnp.asarray(pts), ref, **REF_VERBATIM))
    gold = vb(pts, dom, device="cpu", **VERBATIM).numpy()
    np.testing.assert_allclose(gold, want, **TOL)
    got = pb(pts, dom, variant="sym", device="cpu", **VERBATIM).numpy()
    np.testing.assert_allclose(got, gold, **TOL)


def test_vb_dec_paper_verbatim_matches_reference():
    ref, dom = _small()
    pts = clustered_events(100, ref, seed=2)
    want = np.asarray(ref_vb_dec(pts, ref, **REF_VERBATIM))
    got = vb_dec(pts, dom, device="cpu", **VERBATIM).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pb_eval_only_matches_reference(variant):
    ref, dom = _small()
    pts = clustered_events(300, ref, seed=5)
    want = float(ref_pb_eval_only(pts, ref, variant=variant,
                                  budget_elems=1 << 14))
    got = pb_eval_only(pts, dom, variant=variant, budget_elems=1 << 14,
                       device="cpu")
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **TOL)
    # the checksum is the grid's mass plus what falls outside the grid
    grid = np.asarray(ref_pb(pts, ref, variant=variant), np.float64)
    assert float(got) >= grid.sum() * (1 - 1e-5)


def test_gold_standards_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    _, dom = _small()
    pts = np.full((4, 3), 5.0, np.float32)
    for fn in (vb, vb_dec, pb_eval_only):
        with pytest.raises(KernelUnavailableError, match="CUDA"):
            fn(pts, dom)
