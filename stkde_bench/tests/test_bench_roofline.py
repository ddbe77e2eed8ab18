"""The input-only count of ``roofline.py`` against a brute-force count, and
the least time it gives."""
import numpy as np
import pytest

from stkde_bench import harness, roofline
from stkde_bench.reference.pbsym import Box

H100 = "NVIDIA H100 80GB HBM3"


def brute_pairs(pts, box):
    p = pts.astype(np.float64)
    xc = box.ox + (np.arange(box.Gx) + 0.5) * box.sres
    yc = box.oy + (np.arange(box.Gy) + 0.5) * box.sres
    tc = box.ot + (np.arange(box.Gt) + 0.5) * box.tres
    u = (xc[None, :] - p[:, 0:1]) / box.hs
    v = (yc[None, :] - p[:, 1:2]) / box.hs
    w = (tc[None, :] - p[:, 2:3]) / box.ht
    disk = (u[:, :, None] ** 2 + v[:, None, :] ** 2 < 1).sum(axis=(1, 2))
    return int((disk * (np.abs(w) < 1).sum(axis=1)).sum())


@pytest.mark.parametrize("seed", range(6))
def test_support_pairs_equal_a_brute_force_count(seed):
    rng = np.random.default_rng(seed)
    box = Box(Gx=int(rng.integers(4, 24)), Gy=int(rng.integers(4, 24)),
              Gt=int(rng.integers(3, 16)), sres=float(rng.choice([1.0, 0.7])),
              tres=float(rng.choice([1.0, 2.5])), hs=float(rng.uniform(0.6, 6)),
              ht=float(rng.uniform(0.6, 7)), ox=-3.0, oy=2.0, ot=10.0)
    lo = np.array([box.ox, box.oy, box.ot]) - 3
    size = np.array([box.Gx * box.sres, box.Gy * box.sres,
                     box.Gt * box.tres]) + 6
    pts = (lo + rng.random((400, 3)) * size).astype(np.float32)
    assert roofline.support_pairs(pts, box, block=97) == brute_pairs(pts, box)


def test_a_point_at_a_voxel_centre():
    # hs = ht = 1.5 voxels: the disk holds the centre, its 4 neighbours (at
    # 1) and the 4 diagonals (at sqrt(2)); the bar 3 voxels; at the grid's
    # corner a quarter of the disk and two thirds of the bar
    box = Box(Gx=10, Gy=10, Gt=10, sres=1.0, tres=1.0, hs=1.5, ht=1.5)
    pts = np.array([[4.5, 4.5, 4.5]], dtype=np.float32)
    assert roofline.support_pairs(pts, box) == 9 * 3
    edge = np.array([[0.5, 0.5, 0.5]], dtype=np.float32)
    assert roofline.support_pairs(edge, box) == 4 * 2


def test_least_time_is_the_larger_bound_and_names_it():
    box = Box(Gx=8, Gy=8, Gt=8, sres=1.0, tres=1.0, hs=2.0, ht=2.0)
    pts = np.full((5, 3), 4.2, dtype=np.float32)
    lt = roofline.least_time(pts, box, H100)
    assert lt["operations"] == 2 * lt["support_pairs"]
    assert lt["bytes"] == 12 * 5 + 4 * 512
    assert lt["seconds"] == max(lt["operations_s"], lt["bytes_s"])
    assert lt["bound_by"] == "bytes"
    assert roofline.least_time(pts, box, "a card not in the table") is None


def test_same_count_for_the_tile_and_the_scatter_branch(tiny):
    """One query's count depends on its points and domain only: the same
    configuration and seed under a tile mix and a scatter mix with the same
    bandwidths give the same number."""
    from stkde_bench.gen.events import point_sets

    counts = []
    for name in ("pollenus_hr.tile_mb", "pollenus_hr.scatter_lb"):
        cell = tiny(name, hs=4, ht=2)
        assert cell.traffic["staged"] in ("tile", "scatter")
        _, box = harness.domains(cell)[0]
        pts = point_sets(cell.config, 12345, 1)[0]
        counts.append(roofline.least_time(pts, box, H100))
    assert counts[0] == counts[1]
    assert counts[0]["support_pairs"] > 0
