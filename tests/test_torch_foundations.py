"""Port vs reference: geometry, kernel functions, datasets, errors."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import Domain as RefDomain
from repro.core import datasets as ref_datasets
from repro.core import kernels_math as ref_km
from repro.resilience import errors as ref_errors

from repro_torch import convert
from repro_torch.core import Domain, from_points
from repro_torch.core import datasets, kernels_math as km
from repro_torch.resilience import errors

# (grid, hs, ht, tile) of tests/test_stkde_pallas.py, plus its non-unit domain
TILE_CASES = [
    ((33, 25, 17), 3.0, 2.0, (8, 8, 8)),
    ((32, 32, 16), 4.0, 1.0, (16, 16, 8)),
    ((64, 48, 12), 6.0, 3.0, (32, 16, 4)),
    ((17, 19, 23), 2.0, 2.0, (8, 8, 16)),
    ((40, 40, 8), 5.0, 1.0, (40, 40, 8)),
]
NONUNIT = dict(gx=20.0, gy=15.0, gt=30.0, sres=0.6, tres=2.2, hs=2.0, ht=4.0,
               ox=-7.0, oy=3.0, ot=100.0)


def _ref_domains():
    doms = [
        RefDomain(gx=float(g[0]), gy=float(g[1]), gt=float(g[2]),
                  sres=1.0, tres=1.0, hs=hs, ht=ht)
        for g, hs, ht, _ in TILE_CASES
    ]
    return doms + [RefDomain(**NONUNIT)]


PROPS = ("Gx", "Gy", "Gt", "grid_shape", "Hs", "Ht", "grid_voxels",
         "grid_mbytes", "cylinder_voxels")


@pytest.mark.parametrize("i", range(6))
def test_domain_properties_equal(i):
    ref = _ref_domains()[i]
    dom = convert.domain_from_reference(ref)
    for p in PROPS:
        assert getattr(dom, p) == getattr(ref, p), p
    assert dom.describe() == ref.describe()
    assert dom.with_bandwidth(1.5, 2.5).Hs == ref.with_bandwidth(1.5, 2.5).Hs
    assert (dom.with_resolution(0.5, 0.25).grid_shape
            == ref.with_resolution(0.5, 0.25).grid_shape)
    for name in ("voxel_centers_x", "voxel_centers_y", "voxel_centers_t"):
        got = getattr(dom, name)(device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(ref, name)()))


@pytest.mark.parametrize("i", range(6))
def test_point_voxels_identical(i):
    ref = _ref_domains()[i]
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(i)
    lo = np.array([ref.ox - ref.hs, ref.oy - ref.hs, ref.ot - ref.ht])
    span = np.array([ref.gx + 2 * ref.hs, ref.gy + 2 * ref.hs,
                     ref.gt + 2 * ref.ht])
    pts = (lo + rng.random((500, 3)) * span).astype(np.float32)
    for name in ("point_voxels", "point_voxels_unclipped"):
        got = getattr(dom, name)(torch.from_numpy(pts))
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(ref, name)(jnp.asarray(pts))))


def test_from_points_equal():
    from repro.core import from_points as ref_from_points

    pts = ref_datasets.clustered_events(
        200, RefDomain(gx=50, gy=40, gt=30, sres=1, tres=1, hs=2, ht=2), seed=5)
    ref = ref_from_points(pts, 0.5, 2.0, 3.0, 4.0)
    dom = from_points(pts, 0.5, 2.0, 3.0, 4.0)
    assert convert.domain_from_reference(ref) == dom


def _uvw_grid():
    """Offsets that include the support edge exactly and both sides of it."""
    base = np.linspace(-1.25, 1.25, 41, dtype=np.float32)  # has -1, 0, 1
    edge = np.array([1.0, -1.0, np.nextafter(np.float32(1), np.float32(0)),
                     np.nextafter(np.float32(1), np.float32(2)),
                     0.6, 0.8, -0.6, -0.8], dtype=np.float32)
    return np.concatenate([base, edge])


@pytest.mark.parametrize("name", ["ks_epanechnikov", "ks_paper_verbatim"])
def test_spatial_kernels_match(name):
    g = _uvw_grid()
    u, v = np.meshgrid(g, g, indexing="ij")   # (0.6, 0.8): r2 == 1 up to fp32
    want = np.asarray(getattr(ref_km, name)(jnp.asarray(u), jnp.asarray(v)))
    got = getattr(km, name)(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, want == 0)   # same support
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["kt_epanechnikov", "kt_paper_verbatim"])
def test_temporal_kernels_match(name):
    w = _uvw_grid()
    want = np.asarray(getattr(ref_km, name)(jnp.asarray(w)))
    got = getattr(km, name)(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_normalization_and_defaults():
    assert km.normalization(1234, 2.5, 0.7) == ref_km.normalization(
        1234, 2.5, 0.7)
    assert km.DEFAULT_KS is km.ks_epanechnikov
    assert km.DEFAULT_KT is km.kt_epanechnikov


def test_kernel_ids():
    assert km.spatial_kernel_id(km.ks_epanechnikov) == 0
    assert km.spatial_kernel_id(km.ks_paper_verbatim) == 1
    assert km.temporal_kernel_id(km.kt_epanechnikov) == 0
    assert km.temporal_kernel_id(km.kt_paper_verbatim) == 1
    with pytest.raises(errors.KernelUnavailableError):
        km.spatial_kernel_id(lambda u, v: u + v)
    with pytest.raises(errors.KernelUnavailableError):
        km.temporal_kernel_id(km.ks_epanechnikov)   # wrong role


@pytest.mark.parametrize(
    "name", ["Dengue_Lr-Hb", "PollenUS_Lr-Lb", "Flu_Mr-Hb"])
def test_instance_points_bit_identical(name):
    ref = ref_datasets.get_instance(name)
    inst = datasets.get_instance(name)
    assert (inst.n, inst.Gx, inst.Gy, inst.Gt, inst.Hs, inst.Ht) == (
        ref.n, ref.Gx, ref.Gy, ref.Gt, ref.Hs, ref.Ht)
    np.testing.assert_array_equal(inst.points(3000), ref.points(3000))
    assert convert.domain_from_reference(ref.domain()) == inst.domain()
    s, rs = inst.scaled(200_000, 2_000), ref.scaled(200_000, 2_000)
    assert (s.n, s.Gx, s.Gy, s.Gt) == (rs.n, rs.Gx, rs.Gy, rs.Gt)


def test_instance_table_equal():
    assert list(datasets.INSTANCES) == list(ref_datasets.INSTANCES)


def test_errors_keep_their_bases():
    for name in dir(ref_errors):
        ref_cls = getattr(ref_errors, name)
        if not (isinstance(ref_cls, type) and issubclass(ref_cls, Exception)):
            continue
        cls = getattr(errors, name)
        assert [c.__name__ for c in cls.__mro__] == [
            c.__name__ for c in ref_cls.__mro__], name
    assert issubclass(errors.ReproValidationError, ValueError)
    assert issubclass(errors.KernelUnavailableError, errors.ReproError)
    assert not errors.is_transient(errors.KernelUnavailableError("x"))
    assert errors.is_transient(errors.InjectedOOMError("site"))
    assert not errors.is_transient(errors.ReproValidationError("x"))
    assert str(errors.InjectedOOMError("s")) == str(
        ref_errors.InjectedOOMError("s"))
