"""The plain reference against a hand case and a direct sum, and its
control: the TF32 reference fails the limit the program's plain path
passes."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from stkde_bench import check, harness
from stkde_bench.gen.events import point_sets
from stkde_bench.reference.pbsym import (Box, block_density, round_tf32,
                                         selections)

BENCH = Path(__file__).resolve().parents[1]


def whole(points, box, precision="float64", block=32):
    grid = torch.zeros((box.Gx, box.Gy, box.Gt), dtype=torch.float64)
    for xs, ys, sel in selections(points, box, "cpu", block):
        grid[xs, ys, :] = block_density(
            sel, box, (xs.start, xs.stop), (ys.start, ys.stop), len(points),
            precision).double()
    return grid


def test_one_point_by_hand():
    """One point at a voxel centre, hs = 2, ht = 2: the centre holds
    ks(0, 0) kt(0) / (n hs^2 ht) = (2/pi)(3/4)/8; the voxel one step away in
    x and one in t holds (2/pi)(1 - 1/4)^2 (3/4)(1 - 1/4) / 8."""
    box = Box(Gx=9, Gy=9, Gt=9, sres=1.0, tres=1.0, hs=2.0, ht=2.0)
    g = whole(np.array([[4.5, 4.5, 4.5]], dtype=np.float32), box, block=4)
    assert g[4, 4, 4] == pytest.approx((2 / math.pi) * 0.75 / 8, rel=1e-15)
    assert g[5, 4, 5] == pytest.approx(
        (2 / math.pi) * 0.75 ** 2 * 0.75 * 0.75 / 8, rel=1e-15)
    assert g[6, 4, 4] == 0.0 and g[4, 4, 6] == 0.0   # the support's edge
    assert int((g > 0).sum()) == 9 * 3               # 3x3 disk, 3-voxel bar


def test_blocks_equal_a_direct_sum_over_points():
    rng = np.random.default_rng(5)
    box = Box(Gx=23, Gy=17, Gt=9, sres=0.8, tres=1.5, hs=2.1, ht=2.7,
              ox=-1.0, oy=3.0, ot=7.0)
    pts = (np.array([box.ox, box.oy, box.ot]) - 1 + rng.random((60, 3))
           * np.array([20.4, 15.6, 16.5])).astype(np.float32)
    p = pts.astype(np.float64)
    xc = box.ox + (np.arange(box.Gx) + 0.5) * box.sres
    yc = box.oy + (np.arange(box.Gy) + 0.5) * box.sres
    tc = box.ot + (np.arange(box.Gt) + 0.5) * box.tres
    want = np.zeros((box.Gx, box.Gy, box.Gt))
    for x, y, t in p:
        u, v, w = (xc - x) / box.hs, (yc - y) / box.hs, (tc - t) / box.ht
        r2 = u[:, None] ** 2 + v[None, :] ** 2
        ks = np.where(r2 < 1, 2 / math.pi * (1 - r2) ** 2, 0.0)
        kt = np.where(np.abs(w) < 1, 0.75 * (1 - w * w), 0.0)
        want += ks[:, :, None] * kt[None, None, :]
    want /= len(p) * box.hs ** 2 * box.ht
    np.testing.assert_allclose(whole(pts, box, block=8).numpy(), want,
                               rtol=1e-12, atol=1e-18)


def test_round_tf32_keeps_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      3.14159265], dtype=torch.float32)
    got = round_tf32(x)
    assert got[:4].tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]
    assert abs(float(got[4]) / 3.14159265 - 1) < 2**-11
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


@pytest.mark.parametrize("workload", ["pollenus_hr.tile_mb",
                                      "flu_hr.tile_lb",
                                      "pollenus_hr.scatter_lb"])
def test_control_fails_the_limit_the_program_passes(tiny, workload):
    """At a size a test run holds: the program's plain path (the CPU's
    tile version or scatter) reads far under the cell's limit, the control
    (the reference in TF32) over it."""
    cell = tiny(workload, n=3000)
    limit = json.loads((BENCH / "limits" / f"{workload}.json").read_text()
                       )["grid_err"]
    dom, box = harness.domains(cell)[0]
    run = harness.caller(cell.traffic, harness.devices(1, "cpu"))
    pts = point_sets(cell.config, 99, 1)[0]
    program = check.grid_err(check.of_grid(run(pts, dom)), pts, box, "cpu")
    control = check.grid_err(check.control(box, len(pts)), pts, box, "cpu")
    assert program < limit < control
