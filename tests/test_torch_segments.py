"""The tile kernel's work plan and the kernels' build hash, on the CPU.

The plan (``repro_torch.kernels.stkde_tile.plan_segments``) is what the CUDA
kernel's grid is made of: every tile's walk cut into items of at most ``seg``
points. It is plain numpy, so it is held here to what the kernel relies on:
each tile's ``[0, count)`` covered once and in order, slots consecutive per
tile and in the order of its points, an empty tile written once.
"""
import shutil
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

# conftest.py's per-test teardown imports repro.resilience, which needs
# repro.core imported first
import repro.core  # noqa: F401

from repro_torch.core import bucketing, get_instance
from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.kernels.stkde_tile import (
    PANEL, SegmentPlan, choose_seg, plan_counts, plan_segments, walked_pairs)


def _check_plan(loads, seg: int, plan: SegmentPlan) -> None:
    loads = np.asarray(loads, dtype=np.int64).reshape(-1)
    items = plan.items.astype(np.int64)
    assert plan.seg == seg and items.dtype == np.int64
    assert plan.items.dtype == np.int32 and plan.reduce.dtype == np.int32
    # heaviest first
    assert (np.diff(items[:, 2]) <= 0).all()
    assert plan.max_segment <= seg
    assert (items[:, 2] >= 0).all()
    by_tile = {}
    for tile, first, length, slot in items.tolist():
        by_tile.setdefault(tile, []).append((first, length, slot))
    assert sorted(by_tile) == list(range(len(loads)))
    slots_seen = []
    reduce = {int(r[0]): (int(r[1]), int(r[2])) for r in plan.reduce}
    for tile, segs in by_tile.items():
        segs.sort()
        c = int(loads[tile])
        assert len(segs) == max(1, -(-c // seg))
        # [0, c) exactly once, in order, cut at multiples of seg
        pos = 0
        for i, (first, length, slot) in enumerate(segs):
            assert first == pos == i * seg
            pos += length
            # the first item writes the grid, later ones their slots
            if i == 0:
                assert slot == -1
            else:
                assert slot == reduce[tile][0] + i - 1
                slots_seen.append(slot)
        assert pos == c
        if len(segs) > 1:
            assert reduce[tile][1] == len(segs) - 1
        else:
            assert tile not in reduce
    assert sorted(slots_seen) == list(range(plan.slots))
    assert plan.segments == len(items)


@settings(max_examples=25, deadline=None)
@given(ntiles=st.integers(1, 60), top=st.integers(0, 5000),
       seg=st.integers(1, 700), seed=st.integers(0, 999))
def test_plan_covers_each_tile_once_in_order(ntiles, top, seg, seed):
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, top + 1, size=ntiles)
    loads[rng.random(ntiles) < 0.3] = 0           # empty tiles
    _check_plan(loads, seg, plan_segments(loads, seg))


@pytest.mark.parametrize("loads,seg,n_items,slots", [
    ([0], 64, 1, 0),                # an empty tile is one empty item
    ([0, 0, 0], 8, 3, 0),
    ([64], 64, 1, 0),               # exactly seg: not split
    ([65], 64, 2, 1),
    ([1000, 3, 0], 128, 8 + 1 + 1, 7),
])
def test_plan_small_cases(loads, seg, n_items, slots):
    plan = plan_segments(loads, seg)
    _check_plan(loads, seg, plan)
    assert plan.segments == n_items and plan.slots == slots


def _walk_by_hand(plan: SegmentPlan, tile) -> int:
    """The (point, voxel) pairs of ``csrc/stkde_tile.cu``'s split pass, one
    by one: each item's panels of PANEL points from ``q0``, in each its
    ``nk = min(KSTEPS, (len - q0 + 7) >> 3)`` k-steps of 8 points, each
    point against every column and every t of the tile."""
    bx, by, bt = tile
    pairs = 0
    for _, _, length, _ in plan.items.tolist():
        for q0 in range(0, length, PANEL):
            nk = min(PANEL // 8, (length - q0 + 7) >> 3)
            for _ in range(nk * 8):
                for _ in range(bx * by):
                    pairs += bt
    return pairs


@pytest.mark.parametrize("loads,seg,tile", [
    ([0], 64, (8, 8, 8)),
    ([1, 7, 8, 9], 64, (8, 8, 8)),
    ([65, 64, 63, 130], 64, (8, 16, 8)),
    ([200, 0, 3], 128, (16, 8, 16)),
    ([1000, 999, 1], 192, (8, 8, 16)),
])
def test_walked_pairs_match_a_walk_by_hand(loads, seg, tile):
    plan = plan_segments(loads, seg)
    assert walked_pairs(plan, tile) == _walk_by_hand(plan, tile)
    got = plan_counts(plan, sum(loads), tile)
    assert got == {"tiles": len(loads), "items": plan.segments,
                   "split_tiles": len(plan.reduce), "seg": seg,
                   "copies": sum(loads), "slots": sum(loads),
                   "walked_pairs": _walk_by_hand(plan, tile)}


def test_plan_without_counts_covers_cap():
    """A plan over cap for every tile (a padded layout's whole buckets) is
    cut at the same multiples of seg as the plan over the loads, so its
    first items hold the same real points as the plan over the loads."""
    cap, seg = 640, 128
    counts = np.array([0, 5, 128, 300, 640])
    whole = plan_segments(np.full(len(counts), cap), seg)
    _check_plan(np.full(len(counts), cap), seg, whole)
    assert whole.segments == len(counts) * cap // seg
    early = plan_segments(counts, seg)
    starts = lambda p: {(int(t), int(f)) for t, f, _, _ in p.items}
    assert starts(early) <= starts(whole)


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="seg"):
        plan_segments([3], 0)
    with pytest.raises(ValueError, match="negative"):
        plan_segments([3, -1], 8)
    with pytest.raises(ValueError, match="positive"):
        choose_seg(100, 0, 2)


@pytest.mark.parametrize("total,sms,bps,want", [
    (0, 132, 2, PANEL),
    (1, 132, 2, PANEL),
    (2_020_000, 132, 2, 1920),      # ceil(2.02M / 1056) = 1913 -> 1920
    (72_000, 132, 2, PANEL * 2),    # ceil(72k / 1056) = 69 -> 128
])
def test_choose_seg(total, sms, bps, want):
    seg = choose_seg(total, sms, bps)
    assert seg == want and seg % PANEL == 0
    # about WAVES waves of work items, never fewer than one panel a block
    assert seg * 4 * sms * bps >= total


def test_plan_at_pollen_us_hr_lb_counts(monkeypatch):
    """The full-size buckets' loads: the 90,063-point tile is split into
    items no longer than seg, and every tile is still covered. The loads are
    the overlap bucketing's own, taken before it builds the capacity-padded
    layout (1.5 GB that the plan does not need)."""
    def loads_only(ids, pts_rep, nt, *rest):
        counts = np.bincount(ids, minlength=int(np.prod(nt)))
        # what the bucketing span reads, beside the loads
        return types.SimpleNamespace(counts=counts, cap=int(counts.max()),
                                     replication_factor=0.0, copies=len(ids))

    monkeypatch.setattr(bucketing, "_densify", loads_only)
    inst = get_instance("PollenUS_Hr-Lb")
    dom = inst.domain()
    counts = bucketing.bucket_points_overlap(inst.points(), dom,
                                             ops.default_tile(dom)).counts
    assert counts.max() == 90_063 and counts.size == 1_260
    seg = choose_seg(int(counts.sum()), 132, 2)
    assert seg == 1920
    plan = plan_segments(counts, seg)
    _check_plan(counts, seg, plan)
    assert plan.max_segment == seg < int(counts.max())
    assert plan.segments == int(np.maximum(1, -(-counts // seg)).sum())
    # the heaviest tile gives the most slots, all consecutive
    heavy = int(np.argmax(counts))
    row = plan.reduce[plan.reduce[:, 0] == heavy][0]
    assert row[2] == -(-90_063 // seg) - 1


# ----------------------------------------------------------- build hash
def test_library_name_changes_with_a_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = build.library_path("stkde_tile", csrc)
    assert before == build.library_path("stkde_tile", csrc)   # stable
    header = csrc / "extra.cuh"
    header.write_text("#define SOMETHING 1\n")
    with_header = build.library_path("stkde_tile", csrc)
    assert with_header != before
    header.write_text("#define SOMETHING 2\n")
    changed = build.library_path("stkde_tile", csrc)
    assert changed not in (before, with_header)
    assert changed.parent == build.build_dir()
    assert changed.name.startswith("stkde_tile-") and changed.suffix == ".so"


def test_library_name_changes_with_the_source(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = build.library_path("stkde_tile", csrc)
    src = csrc / "stkde_tile.cu"
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert build.library_path("stkde_tile", csrc) != before
    assert build.library_path("stkde_tile") == build.library_path(
        "stkde_tile", build.CSRC)
