"""The tile branch's packed overlap buckets, on the CPU.

Packed buckets hold each tile's copies in one run, found by its offset: a run
must be the reference's padded bucket's valid slots, in order, bit for bit
(from numpy on the host and from a tensor on its device); the plain tile path
on them must match the benchmark's independent float64 reference at a shape
like PollenUS_VHr-Lb's (a bandwidth many tiles wide, clustered and skewed
loads); and nothing on the path may be shaped like ``ntiles x cap``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.core import Domain as RefDomain
from repro.core import bucketing as ref_bucketing
from repro.core import clustered_events

from repro_torch import convert
from repro_torch.core import Domain, bucketing, stkde
from repro_torch.kernels import ops, stkde_tiled

from test_torch_foundations import TILE_CASES

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))

from stkde_bench import check  # noqa: E402
from stkde_bench.reference.pbsym import Box  # noqa: E402


def _assert_runs_are_valid_slots(got, want):
    """Packed buckets ``got`` against the reference's padded ``want``: tile
    by tile, each run is the bucket's valid slots, in order, bit for bit,
    and nothing lies between the runs."""
    points = np.asarray(got.points.cpu() if isinstance(got.points,
                                                      torch.Tensor)
                        else got.points)
    offsets = np.asarray(got.offsets.cpu() if isinstance(got.offsets,
                                                         torch.Tensor)
                         else got.offsets)
    assert points.dtype == np.float32 and offsets.dtype == np.int64
    assert got.ntiles == tuple(want.ntiles) and got.tile == tuple(want.tile)
    assert got.copies == int(want.counts.sum()) == len(points)
    assert got.replication_factor == want.replication_factor
    counts = want.counts.reshape(-1)
    np.testing.assert_array_equal(np.diff(offsets), counts)
    np.testing.assert_array_equal(got.loads, counts)
    assert offsets[0] == 0 and offsets[-1] == len(points)
    assert got.max_load == int(counts.max())
    pad_pts = want.points.reshape(-1, want.cap, 3)
    pad_valid = want.valid.reshape(-1, want.cap)
    for t in range(len(counts)):
        run = points[offsets[t]:offsets[t + 1]]
        assert pad_valid[t, :counts[t]].all()
        assert not pad_valid[t, counts[t]:].any()
        np.testing.assert_array_equal(run, pad_pts[t, :counts[t]])
    np.testing.assert_array_equal(points, want.points[want.valid])


@pytest.mark.parametrize("on_device", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("grid,hs,ht,tile", TILE_CASES)
def test_packed_runs_are_the_padded_buckets_valid_slots(grid, hs, ht, tile,
                                                        on_device):
    ref = RefDomain(gx=float(grid[0]), gy=float(grid[1]), gt=float(grid[2]),
                    sres=1.0, tres=1.0, hs=hs, ht=ht)
    dom = convert.domain_from_reference(ref)
    pts = clustered_events(400, ref, seed=sum(grid))
    want = ref_bucketing.bucket_points_overlap(pts, ref, tile)
    got = bucketing.bucket_points_packed(
        torch.from_numpy(pts) if on_device else pts, dom, tile)
    assert isinstance(got.points, torch.Tensor) == on_device
    _assert_runs_are_valid_slots(got, want)
    # the padded layout's names, for the staged copy written against it,
    # warn on every read
    with pytest.warns(DeprecationWarning, match="offsets"):
        assert got.valid is got.offsets
    with pytest.warns(DeprecationWarning, match="max_load"):
        assert got.cap == got.max_load


@settings(max_examples=15, deadline=None)
@given(
    gx=st.floats(4.0, 40.0), gy=st.floats(4.0, 40.0), gt=st.floats(2.0, 20.0),
    sres=st.floats(0.3, 2.0), tres=st.floats(0.3, 2.0),
    hs=st.floats(0.2, 6.0), ht=st.floats(0.2, 4.0),
    ox=st.floats(-50.0, 50.0), ot=st.floats(-10.0, 10.0),
    bx=st.integers(1, 4), bt=st.integers(1, 3),
    n=st.integers(1, 300), seed=st.integers(0, 10_000),
)
def test_property_packed_equals_padded_valid_slots(gx, gy, gt, sres, tres,
                                                   hs, ht, ox, ot, bx, bt, n,
                                                   seed):
    """Random domains, non-unit resolutions and origins, and points past the
    domain on every side and on its edges: both packings, numpy and torch,
    are the reference's valid slots."""
    ref = RefDomain(gx=gx, gy=gy, gt=gt, sres=sres, tres=tres, hs=hs,
                    ht=ht, ox=ox, oy=-ox / 2, ot=ot)
    dom = convert.domain_from_reference(ref)
    rng = np.random.default_rng(seed)
    lo = np.array([ref.ox, ref.oy, ref.ot])
    size = np.array([gx, gy, gt])
    pts = lo + rng.uniform(-0.2, 1.2, (n, 3)) * size
    pts = np.concatenate([pts, lo[None], (lo + size)[None]]).astype(
        np.float32)
    tile = (8 * bx, 8 * bx, 4 * bt)
    want = ref_bucketing.bucket_points_overlap(pts, ref, tile)
    for arg in (pts, torch.from_numpy(pts)):
        _assert_runs_are_valid_slots(
            bucketing.bucket_points_packed(arg, dom, tile), want)


def _skewed_events(dom: Domain, n: int, heavy: float, seed: int):
    """Clustered events with ``heavy`` of them in one box of 6x6x3 voxels."""
    from stkde_bench.gen.events import clustered_events as bench_events

    box = (dom.ox, dom.oy, dom.ot, dom.gx, dom.gy, dom.gt)
    pts = bench_events(n, box, layout_seed=2, draw_seed=[seed, 0])
    rng = np.random.default_rng(seed)
    k = int(n * heavy)
    corner = np.array([0.4 * dom.gx, 0.55 * dom.gy, 0.3 * dom.gt])
    pts[:k] = corner + rng.random((k, 3)) * [6.0, 6.0, 3.0]
    return pts.astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_tile_path_matches_the_benchmark_reference_vhr_like(seed):
    """Hs 40 over tiles of 8 (its cylinder reaches 5 tiles a side, as
    PollenUS_VHr-Lb's Hs 100 reaches 3-4 of 32), clustered events and one
    box holding half of them: the grid of the plain tile path on packed
    buckets against ``stkde_bench/reference/pbsym.py`` (float64)."""
    dom = Domain(gx=240.0, gy=200.0, gt=24.0, sres=1.0, tres=1.0, hs=40.0,
                 ht=2.0)
    tile = (8, 8, 8)
    pts = _skewed_events(dom, 500, 1 / 2, seed)
    b = bucketing.bucket_points_packed(pts, dom, tile)
    assert (dom.Hs + tile[0] - 1) // tile[0] >= 5
    assert b.max_load >= 4 * b.loads.mean()       # skewed loads
    grid = stkde_tiled(pts, dom, tile=tile, device="cpu")
    assert grid.shape == dom.grid_shape
    box = Box(dom.Gx, dom.Gy, dom.Gt, dom.sres, dom.tres, dom.hs, dom.ht)
    assert check.grid_err(check.of_grid(grid), pts, box, "cpu") < 1e-5


class _Largest(TorchDispatchMode):
    """The most elements of any tensor an op returns under the mode."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_no_tensor_on_the_tile_path_is_ntiles_by_cap():
    """A tile holding most points of a grid of 512 tiles: padded buckets
    would take over 100x the packed bytes. No tensor the tile branch of
    ``stkde`` makes comes near ``ntiles x cap`` elements (the padded
    bucketing of the same points, under the same watch, does)."""
    dom = Domain(gx=128.0, gy=128.0, gt=16.0, sres=1.0, tres=1.0, hs=1.5,
                 ht=1.0)
    tile = (8, 8, 8)
    rng = np.random.default_rng(3)
    heavy = np.array([61.0, 61.0, 2.0]) + rng.random((3000, 3)) * 3.0
    pts = np.concatenate([heavy, rng.random((200, 3)) * [128, 128, 16]])
    pts = pts.astype(np.float32)
    b, _ = ops.prepare_tiles(pts, dom, tile)
    slots = int(np.prod(b.ntiles)) * b.max_load
    assert 16 * slots >= 100 * b.nbytes

    watch = _Largest()
    with watch:
        grid = stkde(pts, dom, use_tiled_kernel=True, device="cpu")
        packed = ops.prepare_tiles(torch.from_numpy(pts), dom, tile)[0]
    assert watch.largest < slots // 4
    assert grid.shape == dom.grid_shape and packed.copies == b.copies
    padded = _Largest()
    with padded:
        bucketing.bucket_points_overlap(torch.from_numpy(pts), dom, tile)
    assert padded.largest >= slots
