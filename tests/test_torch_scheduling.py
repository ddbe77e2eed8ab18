"""Port vs reference: the scheduling substrate — stencil coloring, critical
path and list scheduling (``core/coloring.py``) and LPT placement
(``distributed/partition.py``). Counterparts of the ``TestColoring`` and
``TestLPT`` cases of ``tests/test_scheduling.py``; each also holds the
port's answer equal to the reference's on the same inputs. ``TestPlanner``
waits for the planner's port."""
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import coloring as ref_coloring
from repro.distributed import partition as ref_partition

from repro_torch.core import coloring
from repro_torch.distributed import partition


def _valid_coloring(shape, colors):
    colors = np.asarray(colors).reshape(-1)
    for v, nbrs in coloring._neighbors(shape):
        for u in nbrs:
            if colors[u] == colors[v]:
                return False
    return True


class TestColoring:
    def test_naive_is_valid_8_colors(self):
        shape = (4, 4, 4)
        c = coloring.naive_coloring(shape)
        assert c.max() <= 7
        assert _valid_coloring(shape, c)
        np.testing.assert_array_equal(c, ref_coloring.naive_coloring(shape))

    @settings(max_examples=10, deadline=None)
    @given(
        nx=st.integers(1, 5), ny=st.integers(1, 5), nz=st.integers(1, 4),
        seed=st.integers(0, 99),
    )
    def test_load_aware_is_valid(self, nx, ny, nz, seed):
        shape = (nx, ny, nz)
        rng = np.random.default_rng(seed)
        loads = rng.pareto(1.5, nx * ny * nz) * 100
        c = coloring.load_aware_coloring(shape, loads)
        assert _valid_coloring(shape, c)
        np.testing.assert_array_equal(
            c, ref_coloring.load_aware_coloring(shape, loads))

    def test_load_aware_shortens_critical_path_on_skewed_loads(self):
        """The paper's Fig.12 claim: SCHED coloring <= naive coloring T_inf."""
        shape = (6, 6, 6)
        rng = np.random.default_rng(0)
        loads = rng.pareto(1.0, 6 * 6 * 6) * 100 + 1
        naive = coloring.naive_coloring(shape)
        smart = coloring.load_aware_coloring(shape, loads)
        t_naive = coloring.critical_path(shape, naive, loads)
        t_smart = coloring.critical_path(shape, smart, loads)
        assert t_smart <= t_naive * 1.001
        assert t_smart == ref_coloring.critical_path(shape, smart, loads)

    def test_critical_path_bounds(self):
        shape = (3, 3, 3)
        loads = np.ones(27)
        c = coloring.naive_coloring(shape)
        tinf = coloring.critical_path(shape, c, loads)
        assert loads.max() <= tinf <= loads.sum()

    def test_simulated_schedule_respects_graham(self):
        shape = (5, 5, 3)
        rng = np.random.default_rng(1)
        loads = rng.pareto(1.2, 75) * 50 + 1
        c = coloring.load_aware_coloring(shape, loads)
        T1 = loads.sum()
        Tinf = coloring.critical_path(shape, c, loads)
        for P in (2, 4, 8, 16):
            tp = coloring.simulate_schedule(shape, c, loads, P)
            assert tp <= coloring.graham_bound(T1, Tinf, P) + 1e-6
            assert tp >= max(T1 / P, Tinf) - 1e-6
            assert tp == ref_coloring.simulate_schedule(shape, c, loads, P)

    def test_replicate_critical_reduces_tinf(self):
        shape = (4, 4, 2)
        loads = np.ones(32)
        loads[0] = 500.0  # one dominating subdomain
        c = coloring.load_aware_coloring(shape, loads)
        t0 = coloring.critical_path(shape, c, loads)
        eff, rep = coloring.replicate_critical(shape, c, loads, P=8)
        t1 = coloring.critical_path(shape, c, eff)
        assert t1 < t0
        assert rep[0] > 1  # the heavy subdomain got replicated
        ref_eff, ref_rep = ref_coloring.replicate_critical(shape, c, loads,
                                                           P=8)
        np.testing.assert_array_equal(eff, ref_eff)
        np.testing.assert_array_equal(rep, ref_rep)


class TestLPT:
    def test_lpt_beats_block_on_skew(self):
        rng = np.random.default_rng(2)
        loads = np.sort(rng.pareto(1.0, 256) * 100)[::-1].copy()
        stats = partition.imbalance_stats(loads, 16)
        assert stats["lpt_makespan"] <= stats["block_makespan"]
        # LPT bound: makespan <= ideal + largest tile (a single dominating
        # tile can't be fixed by placement — that's what PD-REP is for)
        assert stats["lpt_makespan"] <= stats["ideal"] + loads.max() + 1e-9
        assert stats == ref_partition.imbalance_stats(loads, 16)

    @settings(max_examples=20, deadline=None)
    @given(
        n=st.integers(1, 200), P=st.integers(1, 32), seed=st.integers(0, 99)
    )
    def test_lpt_is_complete_and_bounded(self, n, P, seed):
        rng = np.random.default_rng(seed)
        loads = rng.random(n) * 10
        a = partition.lpt_assign(loads, P)
        # every tile assigned exactly once
        assert sorted(t for ts in a.tiles_of_device for t in ts) == list(
            range(n)
        )
        # Graham's 4/3 bound for LPT
        opt_lb = max(loads.max(initial=0.0), loads.sum() / P)
        assert a.makespan <= 4 / 3 * opt_lb + 1e-9
        # the same placement, slot for slot, as the reference's (DD-LPT's
        # tile soup depends on it)
        assert a.tiles_of_device == ref_partition.lpt_assign(
            loads, P).tiles_of_device

    def test_round_robin_split_conserves_counts(self):
        counts = np.array([[5, 0], [17, 3]])
        out = partition.split_counts_round_robin(counts, 4)
        assert out.shape == (4, 2, 2)
        np.testing.assert_array_equal(out.sum(axis=0), counts)
        assert out.max() - out.min(axis=0).min() <= 5  # near-even
        np.testing.assert_array_equal(
            out, ref_partition.split_counts_round_robin(counts, 4))

    def test_block_assign_matches_reference(self):
        a = partition.block_assign((4, 3, 2), 5)
        b = ref_partition.block_assign((4, 3, 2), 5)
        np.testing.assert_array_equal(a.device_of_tile, b.device_of_tile)
        assert [list(t) for t in a.tiles_of_device] == [
            list(t) for t in b.tiles_of_device]
