"""Port vs reference: bucket arrays are bit-identical."""
import numpy as np
import pytest

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
    """cap is padded to a multiple of chunk and chunk halves until it divides,
    as repro.kernels.ops.stkde_tiled does before it calls its kernel."""
    ref, dom, pts = _case((33, 25, 17), 3.0, 2.0)
    tile = (8, 8, 8)
    raw = ref_bucketing.bucket_points_overlap(pts, ref, tile)
    cap_eff = ref_bucketing.round_up(
        raw.cap, min(chunk, ref_bucketing.round_up(raw.cap, 8)))
    chunk_eff = min(chunk, cap_eff)
    while cap_eff % chunk_eff:
        chunk_eff //= 2
    b, got_chunk = ops.prepare_tiles(pts, dom, tile, chunk=chunk)
    assert (b.cap, got_chunk) == (cap_eff, chunk_eff)
    assert b.points.shape[3] == cap_eff and b.valid.shape[3] == cap_eff
    np.testing.assert_array_equal(b.points[..., :raw.cap, :], raw.points)
    np.testing.assert_array_equal(b.valid[..., :raw.cap], raw.valid)
    assert not b.valid[..., raw.cap:].any()
    assert not b.points[..., raw.cap:, :].any()
