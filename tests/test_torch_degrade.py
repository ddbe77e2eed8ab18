"""Port vs reference: graceful degradation of STKDE queries
(``resilience/degrade.py``).

The six ``TestDegrade`` cases of ``tests/test_resilience.py`` run on the
port with the CPU as the device; the rest holds the port's coarsened
domains, point subsets, error bounds and degraded grid to the reference's.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro.core import Domain as RefDomain
from repro.core.api import stkde as ref_stkde
from repro.resilience import degrade as ref_degrade
from repro.resilience import errors as ref_errors

from repro_torch import convert
from repro_torch.core import clustered_events
from repro_torch.core.api import stkde
from repro_torch.obs import metrics, trace
from repro_torch.resilience import (
    DegradePolicy,
    degrade,
    errors,
    faults,
    run_with_degrade,
)

REF_DOM = RefDomain(gx=24.0, gy=24.0, gt=8.0, sres=1.0, tres=1.0, hs=3.0,
                    ht=2.0)
DOM = convert.domain_from_reference(REF_DOM)
CROSS_TOL = dict(rtol=1e-5, atol=1e-8)   # port vs reference


@pytest.fixture(autouse=True)
def _clean_port_state():
    """The port's fault injector, metrics registry and tracer are process
    globals of their own: start each test clean and leave nothing behind.
    The tracer records for the test (it is off by default): the tests read
    the ladder's spans."""
    trace.enable()
    yield
    trace.enable(False)
    faults.reset()
    metrics.reset()
    trace.reset()


def _stkde(p, d):
    return stkde(p, d, device="cpu")


def _oom_first(compute, error):
    """``compute`` that raises ``error`` on its first call."""
    calls = [0]

    def f(p, d):
        calls[0] += 1
        if calls[0] == 1:
            raise error("stkde")
        return compute(p, d)

    return f


class TestDegrade:
    def test_full_fidelity_untouched(self):
        pts = clustered_events(200, DOM, seed=0)
        res = run_with_degrade(_stkde, pts, DOM)
        assert not res.degraded and res.level == 0
        assert res.error_bound == 0.0
        assert res.grid.shape == DOM.grid_shape

    def test_degrades_on_resource_failure(self):
        pts = clustered_events(200, DOM, seed=0)
        res = run_with_degrade(_oom_first(_stkde, errors.InjectedOOMError),
                               pts, DOM,
                               DegradePolicy(coarsen=2.0, subsample=0.5))
        assert res.degraded and res.level == 1
        assert res.error_bound > 0
        assert res.dom.sres == 2.0 * DOM.sres
        assert len(res.reason) > 0
        assert res.grid.shape == res.dom.grid_shape
        assert metrics.export()["counters"]["resilience.degraded"] == 1

    def test_runs_out_of_levels(self):
        pts = clustered_events(50, DOM, seed=0)

        def never(p, d):
            raise errors.InjectedOOMError("stkde")

        with pytest.raises(errors.InjectedOOMError):
            run_with_degrade(never, pts, DOM, DegradePolicy(max_levels=1))
        assert metrics.export()["counters"]["resilience.gave_up"] == 1

    def test_nonfinite_output_triggers_degrade(self):
        pts = clustered_events(100, DOM, seed=0)
        calls = [0]

        def compute(p, d):
            calls[0] += 1
            g = _stkde(p, d).numpy()
            if calls[0] == 1:
                g = g.copy()
                g[0, 0, 0] = np.nan
            return g

        res = run_with_degrade(compute, pts, DOM)
        assert res.degraded and "NonFiniteOutputError" in res.reason

    def test_error_bound_monotonic(self):
        pol = DegradePolicy(coarsen=2.0, subsample=0.5, max_levels=3)
        bounds = [degrade.error_bound(DOM, 1000, lv, pol)
                  for lv in range(4)]
        assert bounds[0] == 0.0
        assert all(a < b for a, b in zip(bounds, bounds[1:]))

    def test_subsample_deterministic(self):
        pts = clustered_events(100, DOM, seed=0)
        a = degrade.subsample_points(pts, 0.3, seed=5)
        b = degrade.subsample_points(pts, 0.3, seed=5)
        assert np.array_equal(a, b) and len(a) == 30


# -------------------------------------------------------- vs reference
def test_subsample_points_match_reference():
    pts = clustered_events(333, DOM, seed=3)
    for frac in (0.0, 0.1, 0.5, 0.77, 1.0):
        for seed in (0, 1, 9):
            assert np.array_equal(
                degrade.subsample_points(pts, frac, seed=seed),
                ref_degrade.subsample_points(pts, frac, seed=seed)), \
                (frac, seed)


def test_coarsen_domain_and_error_bound_match_reference():
    nonunit = dict(gx=20., gy=15., gt=30., sres=0.6, tres=2.2, hs=2.,
                   ht=4., ox=-7., oy=3., ot=100.)
    policies = [(DegradePolicy(*a), ref_degrade.DegradePolicy(*a)) for a in (
        (), (2.0, 0.5, 3, 0), (1.0, 0.25, 2, 4), (3.0, 1.0, 2, 0))]
    for ref_dom in (REF_DOM, RefDomain(**nonunit)):
        dom = convert.domain_from_reference(ref_dom)
        for factor in (1.0, 2.0, 4.0, 1.5):
            got = degrade.coarsen_domain(dom, factor)
            want = ref_degrade.coarsen_domain(ref_dom, factor)
            assert got == convert.domain_from_reference(want)
            assert got.grid_shape == want.grid_shape
        for pol, ref_pol in policies:
            for n in (1, 1000):
                for level in range(4):
                    assert degrade.error_bound(dom, n, level, pol) == \
                        ref_degrade.error_bound(ref_dom, n, level, ref_pol)


def test_level_one_grid_matches_reference():
    """An OOM at level 0 in both packages: the same level, domain, reason
    and error bound, and the level-1 grid within the cross-package bar."""
    pts = clustered_events(300, DOM, seed=4)
    got = run_with_degrade(_oom_first(_stkde, errors.InjectedOOMError),
                           pts, DOM)
    want = ref_degrade.run_with_degrade(
        _oom_first(ref_stkde, ref_errors.InjectedOOMError), pts, REF_DOM)
    assert (got.level, got.degraded, got.reason, got.error_bound) == \
        (want.level, want.degraded, want.reason, want.error_bound)
    assert got.dom == convert.domain_from_reference(want.dom)
    assert isinstance(got.grid, torch.Tensor)
    np.testing.assert_allclose(got.grid.numpy(), np.asarray(want.grid),
                               **CROSS_TOL)


def test_ensure_finite_takes_tensors_and_arrays():
    good = np.ones((2, 3), dtype=np.float32)
    assert degrade.ensure_finite(good) is good
    t = torch.ones(2, 3)
    assert degrade.ensure_finite(t) is t
    for bad in (np.array([1.0, np.inf]), torch.tensor([np.nan, 1.0]),
                [[1.0, float("nan")]]):
        with pytest.raises(errors.NonFiniteOutputError, match="1/2"):
            degrade.ensure_finite(bad, "t")
    assert metrics.export()["counters"]["resilience.nonfinite"] == 3


def test_non_transient_failure_propagates_at_once():
    pts = clustered_events(50, DOM, seed=0)
    calls = [0]

    def broken(p, d):
        calls[0] += 1
        raise KeyError("bug")

    with pytest.raises(KeyError):
        run_with_degrade(broken, pts, DOM)
    assert calls[0] == 1
    spans = trace.get_tracer().spans("resilience.degrade.stkde")
    assert [s.attrs["level"] for s in spans] == [0]
