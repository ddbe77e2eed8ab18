"""Port vs reference: bucket arrays are bit-identical, from the host's numpy
bucketing and from the torch bucketing on a tensor's device."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import Domain as RefDomain
from repro.core import bucketing as ref_bucketing
from repro.core import clustered_events

from repro_torch import convert
from repro_torch.core import bucketing
from repro_torch.kernels import ops

from test_torch_foundations import TILE_CASES


def _case(grid, hs, ht):
    ref = RefDomain(gx=float(grid[0]), gy=float(grid[1]), gt=float(grid[2]),
                    sres=1.0, tres=1.0, hs=hs, ht=ht)
    pts = clustered_events(400, ref, seed=sum(grid))
    return ref, convert.domain_from_reference(ref), pts


@pytest.mark.parametrize("mode", ["home", "overlap"])
@pytest.mark.parametrize("grid,hs,ht,tile", TILE_CASES)
def test_buckets_bit_identical(grid, hs, ht, tile, mode):
    ref, dom, pts = _case(grid, hs, ht)
    want = getattr(ref_bucketing, f"bucket_points_{mode}")(pts, ref, tile)
    got = getattr(bucketing, f"bucket_points_{mode}")(pts, dom, tile)
    assert got.cap == want.cap and got.tile == want.tile
    assert got.mode == want.mode and got.ntiles == want.ntiles
    assert got.replication_factor == want.replication_factor
    assert got.points.dtype == want.points.dtype
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.counts, want.counts)
    # the layout the kernel's early stop relies on: valid points first
    flat = got.valid.reshape(-1, got.cap)
    first = np.arange(got.cap)[None, :] < got.counts.reshape(-1, 1)
    np.testing.assert_array_equal(flat, first)


@pytest.mark.parametrize("grid,hs,ht,tile", TILE_CASES)
def test_helpers_equal(grid, hs, ht, tile):
    ref, dom, pts = _case(grid, hs, ht)
    assert bucketing.default_tile(dom) == ref_bucketing.default_tile(ref)
    assert bucketing.num_tiles(dom, tile) == ref_bucketing.num_tiles(ref, tile)
    np.testing.assert_array_equal(
        bucketing._point_voxels_np(pts, dom),
        ref_bucketing._point_voxels_np(pts, ref))
    from repro.kernels import default_tile as ref_default_tile

    assert ops.default_tile(dom) == ref_default_tile(ref)
    assert bucketing.round_up(13, 8) == ref_bucketing.round_up(13, 8) == 16


def test_cap_too_small_raises():
    ref, dom, pts = _case((32, 32, 16), 4.0, 1.0)
    with pytest.raises(ValueError, match="bucket capacity"):
        bucketing.bucket_points_overlap(pts, dom, (16, 16, 8), cap=8)


@pytest.mark.parametrize("chunk", [8, 64, 256])
def test_prepare_tiles_padding_matches_reference_arithmetic(chunk):
    """The tile path packs where repro.kernels.ops.stkde_tiled pads: its runs
    are the reference's buckets' valid slots, with no slot between them, and
    the panel it hands on is ``chunk`` or the longest run rounded up to 8."""
    ref, dom, pts = _case((33, 25, 17), 3.0, 2.0)
    tile = (8, 8, 8)
    raw = ref_bucketing.bucket_points_overlap(pts, ref, tile)
    b, got_chunk = ops.prepare_tiles(pts, dom, tile, chunk=chunk)
    assert isinstance(b, bucketing.PackedBuckets)
    assert (b.cap, got_chunk) == (
        int(raw.counts.max()),
        min(chunk, ref_bucketing.round_up(int(raw.counts.max()), 8)))
    assert b.points.shape == (int(raw.counts.sum()), 3)
    np.testing.assert_array_equal(b.points, raw.points[raw.valid])
    np.testing.assert_array_equal(b.counts, raw.counts)
    np.testing.assert_array_equal(np.diff(b.offsets), raw.counts.reshape(-1))
    assert b.offsets[0] == 0 and b.offsets[-1] == b.copies


@pytest.mark.parametrize("on_device", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("mode", ["home", "overlap"])
def test_copies_are_the_sum_of_the_loads_known_on_the_host(mode, on_device):
    """``Buckets.copies`` (and with it ``replication_factor``) is a host
    number that the bucketing already holds, the sum of the loads."""
    ref, dom, pts = _case((40, 24, 20), 3.0, 2.0)
    b = getattr(bucketing, f"bucket_points_{mode}")(
        torch.from_numpy(pts) if on_device else pts, dom, (8, 8, 8))
    assert isinstance(b.copies, int) and b.n_source == len(pts)
    assert b.copies == int(b.counts.sum())
    assert b.replication_factor == b.copies / len(pts)
    assert (b.copies == len(pts)) == (mode == "home")


# ------------------------------------------ torch bucketing on the device
def _assert_same(got, want):
    """A torch ``Buckets`` holds exactly the reference's numpy arrays."""
    assert isinstance(got.points, torch.Tensor)
    assert got.points.dtype == torch.float32
    assert got.valid.dtype == torch.bool and got.counts.dtype == torch.int64
    assert got.cap == want.cap and got.tile == tuple(want.tile)
    assert got.mode == want.mode and got.ntiles == tuple(want.ntiles)
    assert got.replication_factor == want.replication_factor
    np.testing.assert_array_equal(got.points.numpy(), want.points)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)


@pytest.mark.parametrize("mode", ["home", "overlap"])
@pytest.mark.parametrize("grid,hs,ht,tile", TILE_CASES)
def test_torch_buckets_bit_identical(grid, hs, ht, tile, mode):
    ref, dom, pts = _case(grid, hs, ht)
    want = getattr(ref_bucketing, f"bucket_points_{mode}")(pts, ref, tile)
    got = getattr(bucketing, f"bucket_points_{mode}")(
        torch.from_numpy(pts), dom, tile)
    _assert_same(got, want)


@settings(max_examples=15, deadline=None)
@given(
    gx=st.floats(4.0, 40.0), gy=st.floats(4.0, 40.0), gt=st.floats(2.0, 20.0),
    sres=st.floats(0.3, 2.0), tres=st.floats(0.3, 2.0),
    hs=st.floats(0.2, 6.0), ht=st.floats(0.2, 4.0),
    ox=st.floats(-50.0, 50.0), ot=st.floats(-10.0, 10.0),
    bx=st.integers(1, 4), bt=st.integers(1, 3),
    n=st.integers(1, 300), seed=st.integers(0, 10_000),
)
def test_property_torch_buckets_equal_reference(gx, gy, gt, sres, tres, hs,
                                                ht, ox, ot, bx, bt, n,
                                                seed):
    """Random domains, non-unit resolutions and origins, tiles of 8..32
    voxels, and points spread past the domain on every side (their voxels
    are clipped) and on the domain's edges and voxel faces."""
    ref = RefDomain(gx=gx, gy=gy, gt=gt, sres=sres, tres=tres, hs=hs,
                    ht=ht, ox=ox, oy=-ox / 2, ot=ot)
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(seed)
    lo = np.array([ref.ox, ref.oy, ref.ot])
    size = np.array([gx, gy, gt])
    pts = lo + rng.uniform(-0.2, 1.2, (n, 3)) * size
    edges = np.stack([lo, lo + size,
                      lo + np.floor(rng.uniform(0, 1, 3) * size / [
                          sres, sres, tres]) * [sres, sres, tres]])
    pts = np.concatenate([pts, edges]).astype(np.float32)
    tile = (8 * bx, 8 * bx, 4 * bt)
    for mode in ("home", "overlap"):
        want = getattr(ref_bucketing, f"bucket_points_{mode}")(pts, ref, tile)
        got = getattr(bucketing, f"bucket_points_{mode}")(
            torch.from_numpy(pts), dom, tile)
        _assert_same(got, want)
    np.testing.assert_array_equal(
        bucketing._point_voxels_torch(torch.from_numpy(pts), dom).numpy(),
        ref_bucketing._point_voxels_np(pts, ref))


def test_torch_buckets_with_empty_tiles_and_a_given_cap():
    """All points in one corner: most tiles are empty (count 0, no valid
    slot); a cap larger than the load is kept as given."""
    ref = RefDomain(gx=64.0, gy=64.0, gt=16.0, sres=1.0, tres=1.0, hs=2.0,
                    ht=1.0)
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(4)
    pts = rng.uniform(0.0, 6.0, (250, 3)).astype(np.float32)
    for mode in ("home", "overlap"):
        for cap in (None, 400):
            want = getattr(ref_bucketing, f"bucket_points_{mode}")(
                pts, ref, (8, 8, 4), cap=cap)
            got = getattr(bucketing, f"bucket_points_{mode}")(
                torch.from_numpy(pts), dom, (8, 8, 4), cap=cap)
            _assert_same(got, want)
            assert int((got.counts == 0).sum()) > got.counts.numel() // 2
            if cap is not None:
                assert got.cap == cap


@pytest.mark.parametrize("mode", ["home", "overlap"])
def test_torch_cap_too_small_raises(mode):
    ref, dom, pts = _case((32, 32, 16), 4.0, 1.0)
    with pytest.raises(ValueError, match="bucket capacity"):
        getattr(bucketing, f"bucket_points_{mode}")(
            torch.from_numpy(pts), dom, (16, 16, 8), cap=8)


@pytest.mark.parametrize("chunk", [8, 64, 256])
def test_prepare_tiles_on_a_tensor_equals_the_host(chunk):
    """The tile path's device preparation (bucket + pack on the tensor's
    device) gives the host preparation's arrays and chunk."""
    ref, dom, pts = _case((33, 25, 17), 3.0, 2.0)
    want, want_chunk = ops.prepare_tiles(pts, dom, (8, 8, 8), chunk=chunk)
    got, got_chunk = ops.prepare_tiles(torch.from_numpy(pts), dom, (8, 8, 8),
                                       chunk=chunk)
    assert (got.cap, got_chunk) == (want.cap, want_chunk)
    np.testing.assert_array_equal(got.points.numpy(), want.points)
    np.testing.assert_array_equal(got.offsets.numpy(), want.offsets)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)
    np.testing.assert_array_equal(got.loads, want.loads)
