"""Port vs reference: the tile path on the CPU.

The port's plain version is held against the reference's jnp oracle and
against the Pallas kernel in interpret mode, on the same bucket arrays; then
the port's counterparts of every test of tests/test_stkde_pallas.py run, each
also held against the reference's result.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import Domain as RefDomain
from repro.core import bucketing as ref_bucketing
from repro.core import clustered_events
from repro.core import kernels_math as ref_km
from repro.kernels import stkde_tiled as ref_stkde_tiled
from repro.kernels.ref import stkde_tiles_ref as ref_stkde_tiles_ref
from repro.kernels.stkde_tile import stkde_tiles_pallas

from repro_torch import convert
from repro_torch.core import kernels_math as km
from repro_torch.core.pb import pb
from repro_torch.kernels import stkde_tiled, stkde_tiles_cuda, stkde_tiles_ref
from repro_torch.kernels import stkde_tile
from repro_torch.obs import metrics
from repro_torch.resilience.errors import KernelUnavailableError

from test_torch_foundations import NONUNIT, TILE_CASES

TOL = dict(rtol=1e-5, atol=1e-8)


def _doms(grid, hs, ht):
    ref = RefDomain(gx=float(grid[0]), gy=float(grid[1]), gt=float(grid[2]),
                    sres=1.0, tres=1.0, hs=hs, ht=ht)
    return ref, convert.domain_from_reference(ref)


# ------------------------------------------- same bucket arrays, both sides
@pytest.mark.parametrize("grid,hs,ht,tile", TILE_CASES)
def test_plain_version_vs_reference_oracle_and_pallas(grid, hs, ht, tile):
    ref, dom = _doms(grid, hs, ht)
    pts = clustered_events(400, ref, seed=hash(grid) % 1000)
    b = ref_bucketing.bucket_points_overlap(pts, ref, tile)
    jargs = (jnp.asarray(b.points), jnp.asarray(b.valid.astype(np.float32)))
    oracle = np.asarray(ref_stkde_tiles_ref(*jargs, ref, tile, len(pts)))
    chunk = 8                       # cap is a multiple of 8
    pallas = np.asarray(stkde_tiles_pallas(
        *jargs, ref, tile, b.cap, len(pts), chunk, mode="interpret"))

    t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap,
                                 device="cpu")
    np.testing.assert_array_equal(t.pts_tiles.numpy(), b.points)
    got = stkde_tiles_ref(t.pts_tiles, t.valid_tiles, dom, tile, len(pts))
    assert got.dtype == torch.float32 and got.shape == oracle.shape
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # stopping at each tile's true load, and a small panel, give the same sum
    early = stkde_tiles_ref(t.pts_tiles, t.valid_tiles, dom, tile, len(pts),
                            counts=t.counts, panel=16)
    np.testing.assert_allclose(early.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-9)
    # the wrapper on CPU tensors is the plain version
    auto = stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, tile, t.cap,
                            len(pts), chunk, counts=t.counts)
    np.testing.assert_array_equal(
        auto.numpy(),
        stkde_tiles_ref(t.pts_tiles, t.valid_tiles, dom, tile, len(pts),
                        counts=t.counts).numpy())


# ------------------------------ counterparts of tests/test_stkde_pallas.py
@pytest.mark.parametrize("grid,hs,ht,tile", TILE_CASES)
def test_kernel_vs_scatter_sweep(grid, hs, ht, tile):
    ref, dom = _doms(grid, hs, ht)
    pts = clustered_events(400, ref, seed=hash(grid) % 1000)
    want = pb(pts, dom, device="cpu").numpy()
    got = stkde_tiled(pts, dom, tile=tile, device="cpu").numpy()
    assert got.shape == dom.grid_shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref_stkde_tiled(pts, ref, tile=tile)), **TOL)


@pytest.mark.parametrize("chunk", [8, 64, 256])
def test_kernel_chunk_sizes(chunk):
    ref, dom = _doms((32, 32, 16), 3.0, 2.0)
    pts = clustered_events(600, ref, seed=11)
    want = stkde_tiled(pts, dom, use_ref=True, device="cpu").numpy()
    got = stkde_tiled(pts, dom, chunk=chunk, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        got, np.asarray(ref_stkde_tiled(pts, ref, chunk=chunk)), **TOL)


def test_kernel_nonunit_resolution_and_origin():
    ref = RefDomain(**NONUNIT)
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(4)
    pts = np.stack(
        [
            -7.0 + rng.random(300) * 20.0,
            3.0 + rng.random(300) * 15.0,
            100.0 + rng.random(300) * 30.0,
        ],
        axis=1,
    ).astype(np.float32)
    want = pb(pts, dom, device="cpu").numpy()
    got = stkde_tiled(pts, dom, device="cpu").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(ref_stkde_tiled(pts, ref)),
                               **TOL)


def test_kernel_paper_verbatim_kernel_funcs():
    ref, dom = _doms((24, 24, 12), 3.0, 2.0)
    pts = clustered_events(200, ref, seed=13)
    kw = dict(ks=km.ks_paper_verbatim, kt=km.kt_paper_verbatim)
    want = pb(pts, dom, variant="sym", device="cpu", **kw).numpy()
    got = stkde_tiled(pts, dom, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ref_got = ref_stkde_tiled(pts, ref, ks=ref_km.ks_paper_verbatim,
                              kt=ref_km.kt_paper_verbatim)
    np.testing.assert_allclose(got, np.asarray(ref_got), **TOL)


@settings(max_examples=10, deadline=None)
@given(
    n=st.integers(1, 300),
    hs=st.floats(1.0, 5.0),
    ht=st.floats(1.0, 3.0),
    seed=st.integers(0, 99),
)
def test_property_kernel_equals_scatter(n, hs, ht, seed):
    ref, dom = _doms((26, 22, 18), hs, ht)
    pts = clustered_events(n, ref, seed=seed)
    want = pb(pts, dom, device="cpu").numpy()
    got = stkde_tiled(pts, dom, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        got, np.asarray(ref_stkde_tiled(pts, ref, use_ref=True)),
        rtol=1e-4, atol=1e-7)


def test_empty_tiles_are_zero():
    """Points concentrated in one corner leave far tiles exactly zero."""
    ref, dom = _doms((64, 64, 16), 2.0, 1.0)
    pts = np.full((50, 3), 3.0, dtype=np.float32)
    grid = stkde_tiled(pts, dom, device="cpu").numpy()
    assert grid[10:, 10:, :].sum() == 0.0
    assert grid[:8, :8, :8].sum() > 0
    np.testing.assert_allclose(grid, np.asarray(ref_stkde_tiled(pts, ref)),
                               **TOL)


def test_dtype_is_f32_accumulation():
    ref, dom = _doms((16, 16, 8), 2.0, 1.0)
    pts = clustered_events(100, ref, seed=17)
    out = stkde_tiled(pts, dom, device="cpu")
    assert out.dtype == torch.float32
    assert np.asarray(ref_stkde_tiled(pts, ref)).dtype == np.float32


# ------------------------------------------------ what decides which runs
def _small_inputs():
    ref, dom = _doms((16, 16, 8), 2.0, 1.0)
    pts = clustered_events(60, ref, seed=3)
    tile = (8, 8, 8)
    b = ref_bucketing.bucket_points_overlap(pts, ref, tile)
    t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap,
                                 device="cpu")
    return dom, t, len(pts)


def test_compiled_mode_on_cpu_tensors_raises():
    dom, t, n = _small_inputs()
    # launches are counted by the registry counter stkde_tile.launches
    launches = metrics.counter(stkde_tile.LAUNCHES)
    before = launches.value
    with pytest.raises(KernelUnavailableError, match="compiled"):
        stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, t.tile, t.cap, n,
                         mode="compiled")
    assert launches.value == before   # nothing was launched
    with pytest.raises(ValueError, match="mode"):
        stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, t.tile, t.cap, n,
                         mode="interpret")
    assert stkde_tile.MODES == ("auto", "reference", "compiled")


def test_reference_mode_is_the_plain_version():
    dom, t, n = _small_inputs()
    a = stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, t.tile, t.cap, n,
                         mode="reference")
    b = stkde_tiles_ref(t.pts_tiles, t.valid_tiles, dom, t.tile, n)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unknown_ks_runs_on_cpu_and_is_refused_by_the_id_lookup():
    dom, t, n = _small_inputs()

    def ks_cone(u, v):
        r = torch.sqrt(u * u + v * v)
        return torch.where(r < 1.0, 1.0 - r, 0.0)

    out = stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, t.tile, t.cap, n,
                           ks=ks_cone)
    assert torch.isfinite(out).all() and out.sum() > 0
    with pytest.raises(KernelUnavailableError, match="ks_cone"):
        km.spatial_kernel_id(ks_cone)


def test_buckets_to_torch_checks_shapes():
    dom, t, n = _small_inputs()
    pts = t.pts_tiles.numpy()
    with pytest.raises(ValueError, match="points must be"):
        convert.buckets_to_torch(pts, t.valid_tiles.numpy(),
                                 t.counts.numpy(), t.tile, t.cap + 8,
                                 device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        convert.buckets_to_torch(pts, t.valid_tiles.numpy()[..., :-1],
                                 t.counts.numpy(), t.tile, t.cap,
                                 device="cpu")
    with pytest.raises(KernelUnavailableError):
        if torch.cuda.is_available():
            raise KernelUnavailableError("a card is present")
        convert.buckets_to_torch(pts, t.valid_tiles.numpy(),
                                 t.counts.numpy(), t.tile, t.cap)
