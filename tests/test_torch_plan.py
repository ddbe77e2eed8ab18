"""Port vs reference: the strategy planner (``core/plan.py``).

``TestPlanner`` ports the reference's two planner cases (``tests/
test_scheduling.py``) with the port's default record, ``H100``. The rest
holds the port's arithmetic to the reference's: ``estimate`` and ``choose``
under the same ``Hardware`` field values, and ``calibrate_host`` on the
reference's committed rows. Every record is numbers only, so no device is
needed.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro.core import Domain as RefDomain
from repro.core import plan as ref_plan

from repro_torch import convert
from repro_torch.core import plan
from repro_torch.core.geometry import Domain

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_RECONCILE = ROOT / "results" / "bench" / "reconcile.json"
RECORDS = ("HOST", "HOST_SEED", "H100_SEED", "H100")
# terms of one strategy's entry that are compared as floats
TERMS = ("init_s", "compute_s", "comm_s", "mem_per_dev_gb", "feasible",
         "total_s")

# (domain fields, n): a Flu-like huge sparse grid, PollenUS at a tenth of
# its points, non-unit resolutions and origins, and one where PD-XYT's
# temporal cut is thinner than Ht
SWEEP_DOMS = [
    (dict(gx=581., gy=1536., gt=5951., sres=1., tres=1., hs=5., ht=7.),
     31_478),
    (dict(gx=651., gy=301., gt=84., sres=1., tres=1., hs=10., ht=3.),
     58_819),
    (dict(gx=20., gy=15., gt=30., sres=0.6, tres=2.2, hs=2., ht=4., ox=-7.,
          oy=3., ot=100.), 300),
    (dict(gx=48., gy=40., gt=6., sres=1., tres=1., hs=3., ht=2.), 1500),
]
SWEEP_MESHES = [(2, 2), (4, 2), (1, 8), (16, 16), (2, 2, 2), (2, 16, 16),
                (4, 1, 2)]


def _ref_hw(hw: plan.Hardware) -> ref_plan.Hardware:
    return ref_plan.Hardware(**dataclasses.asdict(hw))


def _loads(kind: str, size: int):
    rng = np.random.default_rng(size)
    if kind == "none":
        return None
    if kind == "uniform":
        return np.full(size, 7.0)
    return rng.pareto(1.5, size=size) * 100.0     # skewed


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


class TestPlanner:
    def test_planner_prefers_pd_for_sparse_large_grid(self):
        """Flu-like: huge grid, few points -> init-bound -> not DR."""
        dom = Domain(gx=581, gy=1536, gt=5951, sres=1, tres=1, hs=5, ht=7)
        pick, table = plan.choose(dom, 31_478, (16, 16))
        assert pick != "dr"
        assert table["dr"]["init_s"] > table["pd"]["init_s"]

    def test_planner_tables_have_all_strategies(self):
        dom = Domain(gx=131, gy=61, gt=84, sres=1, tres=1, hs=2, ht=3)
        _, table = plan.choose(dom, 588_189, (2, 16, 16))
        assert set(table) == {"dr", "dd", "pd", "pd_xt", "pd_xyt",
                              "dd_lpt", "hybrid"}
        for v in table.values():
            assert v["total_s"] > 0


@pytest.mark.parametrize("record", RECORDS)
def test_estimate_and_choose_match_reference(record):
    """Every term of every strategy agrees with the reference's to rel
    1e-12, and the pick is the same, over domains, 2-D and 3-D mesh shapes
    and loads (none, uniform, skewed)."""
    hw = getattr(plan, record)
    ref_hw = _ref_hw(hw)
    for fields, n in SWEEP_DOMS:
        dom, ref_dom = Domain(**fields), RefDomain(**fields)
        for shape in SWEEP_MESHES:
            for kind in ("none", "uniform", "skewed"):
                loads = _loads(kind, 12)
                for use_mxu in (True, False):
                    got = plan.estimate(dom, n, shape, loads, hw, use_mxu)
                    want = ref_plan.estimate(ref_dom, n, shape, loads,
                                             ref_hw, use_mxu)
                    assert set(got) == set(want)
                    for s in want:
                        for t in TERMS:
                            assert _close(got[s][t], want[s][t]), \
                                (record, fields, shape, kind, s, t)
                pick, table = plan.choose(dom, n, shape, loads, hw)
                ref_pick, ref_table = ref_plan.choose(ref_dom, n, shape,
                                                      loads, ref_hw)
                assert pick == ref_pick, (record, fields, shape, kind)
                assert table.keys() == ref_table.keys()


def test_calibrate_host_matches_reference_on_committed_rows():
    """The reference's committed rows re-fitted by both packages, from
    ``HOST`` and from ``HOST_SEED``: equal field by field."""
    for base in ("HOST", "HOST_SEED"):
        got = plan.calibrate_host(str(REF_RECONCILE),
                                  base=getattr(plan, base))
        want = ref_plan.calibrate_host(str(REF_RECONCILE),
                                       base=getattr(ref_plan, base))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), base
    # the probe registries name the same strategies
    assert plan.probed_strategies() == ref_plan.probed_strategies()


def test_host_records_are_the_references():
    for name in ("HOST", "HOST_SEED"):
        assert dataclasses.asdict(getattr(plan, name)) == \
            dataclasses.asdict(getattr(ref_plan, name))
    assert plan.TILE_PATH == ref_plan.TILE_PATH


def test_default_hw_picks_by_device_type():
    assert plan.default_hw("cpu") is plan.HOST
    assert plan.default_hw(torch.device("cpu")) is plan.HOST
    assert plan.default_hw("cuda:0") is plan.H100
    assert plan.default_hw(torch.device("cuda")) is plan.H100
    with pytest.raises(ValueError, match="meta"):
        plan.default_hw("meta")


def test_point_work_flops_match_reference():
    for fields, n in SWEEP_DOMS:
        dom = convert.domain_from_reference(RefDomain(**fields))
        assert plan._point_work_flops(dom, float(n)) == \
            ref_plan._point_work_flops(RefDomain(**fields), float(n))
