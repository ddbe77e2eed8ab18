"""Port vs reference: the point-based scatter path (all four variants), and
the route to the CUDA scatter kernel with its wrapper's refusals."""
import math
import pathlib
import re
import sys

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
                                  _pb_impl, pb, pb_sym, scatter_route)
from repro_torch.kernels import stkde_scatter
from repro_torch.obs import metrics, trace
from repro_torch.resilience.errors import KernelUnavailableError

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


# ------------------------------------------------ the CUDA scatter's route
def _ks_other(u, v):
    return km.ks_epanechnikov(u, v)


def _kt_other(w):
    return km.kt_epanechnikov(w)


KERNEL_PAIRS = {
    "epanechnikov": (km.ks_epanechnikov, km.kt_epanechnikov),
    "paper_verbatim": (km.ks_paper_verbatim, km.kt_paper_verbatim),
    "ks_without_id": (_ks_other, km.kt_epanechnikov),
    "kt_without_id": (km.ks_epanechnikov, _kt_other),
}


@pytest.mark.parametrize("kernels", sorted(KERNEL_PAIRS))
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_scatter_route(device_type, variant, deterministic, kernels):
    """The kernel takes CUDA points, PB-SYM, atomic adds and kernel
    functions with an id; everything else keeps the loop."""
    ks, kt = KERNEL_PAIRS[kernels]
    want = ("kernel" if device_type == "cuda" and variant == "sym"
            and not deterministic and not kernels.endswith("without_id")
            else "loop")
    assert scatter_route(device_type, variant, deterministic, ks, kt) == want


def _refused(case):
    """Points and a domain the wrapper must refuse, and what it says."""
    ref, dom, pts = _case(0)
    t = torch.from_numpy(pts)
    big = convert.domain_from_reference(
        RefDomain(gx=2048, gy=1024, gt=1024, sres=1, tres=1, hs=1, ht=1))
    return {
        "cpu": (t, dom, KernelUnavailableError, "CUDA"),
        "float64": (t.double(), dom, ValueError, "float32"),
        "non_contiguous": (t.t().contiguous().t(), dom, ValueError,
                           "contiguous"),
        "wrong_shape": (t[:, :2].contiguous(), dom, ValueError, "\\(n, 3\\)"),
        "flat": (t.reshape(-1), dom, ValueError, "\\(n, 3\\)"),
        "grid_of_2_31_voxels": (t, big, ValueError, "2\\^31"),
    }[case]


@pytest.mark.parametrize("case", ["cpu", "float64", "non_contiguous",
                                  "wrong_shape", "flat",
                                  "grid_of_2_31_voxels"])
def test_scatter_wrapper_refuses(case):
    pts, dom, err, match = _refused(case)
    with pytest.raises(err, match=match):
        stkde_scatter.stkde_scatter_cuda(pts, dom, len(pts))


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield trace.get_tracer()
    trace.enable(False)
    trace.reset()


def test_kernel_route_records_its_path_and_one_launch(monkeypatch, traced):
    """With the launch stubbed, a call routed to the kernel launches once,
    with the global normalisation and the kernel ids, and says so on its
    ``stkde.scatter`` span."""
    ref, dom, pts = _case(1)
    t = torch.from_numpy(pts)
    calls = []
    # ``repro_torch.core.pb`` is the function; its module is in sys.modules
    monkeypatch.setattr(sys.modules["repro_torch.core.pb"], "scatter_route",
                        lambda *a: "kernel")
    monkeypatch.setattr(stkde_scatter, "_launch",
                        lambda *a: calls.append(a))
    launches = metrics.counter(stkde_scatter.LAUNCHES)
    before = launches.value
    grid = _pb_impl(t, dom, "sym", km.ks_paper_verbatim, km.kt_epanechnikov,
                    1 << 12, n_total=7 * len(pts))
    assert launches.value - before == 1 and len(calls) == 1
    points, out, ddom, norm, ks_id, kt_id = calls[0]
    assert points.data_ptr() == t.data_ptr() and out is grid
    assert ddom == dom and (ks_id, kt_id) == (1, 0)
    assert norm == km.normalization(7 * len(pts), dom.hs, dom.ht)
    assert tuple(grid.shape) == dom.grid_shape and not grid.any()
    (sp,) = traced.spans("stkde.scatter")
    assert sp.attrs["path"] == "kernel" and sp.attrs["launches"] == 1


def test_loop_route_records_its_path(traced):
    ref, dom, pts = _case(0)
    launches = metrics.counter(stkde_scatter.LAUNCHES)
    before = launches.value
    pb(pts, dom, budget_elems=1 << 12, device="cpu")
    (sp,) = traced.spans("stkde.scatter")
    assert sp.attrs["path"] == "loop" and sp.attrs["launches"] == 0
    assert sp.attrs["blocks"] == -(-len(pts) // _block_size(dom, 1 << 12))
    assert launches.value == before


def test_kernel_route_without_points_gives_the_zeroed_grid(monkeypatch,
                                                          traced):
    """An empty call routed to the kernel returns the zeroed grid and
    launches nothing."""
    ref, dom, pts = _case(0)
    monkeypatch.setattr(sys.modules["repro_torch.core.pb"], "scatter_route",
                        lambda *a: "kernel")

    def launch(*a):
        raise AssertionError("an empty call launched the kernel")

    monkeypatch.setattr(stkde_scatter, "_launch", launch)
    launches = metrics.counter(stkde_scatter.LAUNCHES)
    before = launches.value
    grid = _pb_impl(torch.zeros((0, 3)), dom, "sym", km.ks_epanechnikov,
                    km.kt_epanechnikov, 1 << 12, n_total=len(pts))
    assert tuple(grid.shape) == dom.grid_shape and not grid.any()
    assert grid.dtype == torch.float32 and launches.value == before
    (sp,) = traced.spans("stkde.scatter")
    assert sp.attrs["path"] == "kernel" and sp.attrs["launches"] == 0


@pytest.mark.parametrize("n", [0, 1, 2, 300, 588_189, 1_000_003,
                               2_000_006, 2**31 - 2])
def test_point_order_visits_each_point_once(n):
    order = stkde_scatter.point_order(n)
    assert 0 <= order < max(n, 1)
    assert n == 0 or math.gcd(order, n) == 1
    i = np.arange(min(n, 2_000_006), dtype=np.int64)
    walk = i * order % max(n, 1)
    assert len(np.unique(walk)) == len(i)
    if n <= 2_000_006:
        assert np.array_equal(np.sort(walk), i)


def test_kernel_ids_match_the_scatter_source():
    cu = (pathlib.Path(stkde_scatter.__file__).resolve().parent / "csrc"
          / "stkde_scatter.cu").read_text()
    defines = dict(re.findall(r"^#define (K[ST]_[A-Z_]+) (\d+)$", cu, re.M))
    assert defines == {fn.__name__.upper(): str(i)
                       for fn, i in km.KERNEL_IDS.items()}
