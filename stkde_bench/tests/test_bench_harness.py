"""A whole run of the harness at a tiny CPU size, past its look for a chip:
the result line, and ``correct`` coming out false when the timed path is
broken underneath it."""
import pytest
import torch

from stkde_bench import devtrace, harness

E2E = {"pollenus_hr.tile_mb": {"queries_per_s", "query_p95_ms", "setup_s"},
       "pollenus_hr.scatter_lb": {"queries_per_s", "setup_s"}}
TILE_STAGED = {"entry_ms", "h2d_ms", "bucketing_ms", "bucket_gib",
               "tile_call_ms", "finish_ms"}
STAGED = {"pollenus_hr.tile_mb": TILE_STAGED,
          "flu_hr.tile_lb": TILE_STAGED | {"query_tail_p95_ms"},
          "pollenus_hr.scatter_lb": {"entry_ms", "scatter_ms", "finish_ms"}}


@pytest.mark.parametrize("workload", sorted(E2E))
def test_a_run_measures_and_checks(tiny, workload):
    r = harness.run_cell(tiny(workload), 2**31 + 17, 1.0, False, "cpu")
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 2
    # peak memory is a device reading: a CPU run has none
    assert set(r["metrics"]) == E2E[workload]
    assert all(v["value"] > 0 for v in r["metrics"].values())
    c = r["checks"]["grid_err"]
    assert c["value"] < c["limit"]
    assert r["notes"]["checked_query"] == r["attempted"] - 1


@pytest.mark.parametrize("workload", sorted(STAGED))
def test_a_traced_run_reads_the_layers(tiny, workload):
    r = harness.run_cell(tiny(workload), 3, 1.0, True, "cpu")
    # the window's queries, 3 profiled, and 2 real ones beside the 2 staged
    assert r["correct"] is True and r["attempted"] >= 5 + 2
    assert r["notes"]["checked_query"] == 2    # the last profiled one
    assert set(r["metrics"]) == STAGED[workload]
    gap = r["staged_check"]["grid_gap"]
    assert gap["value"] <= gap["limit"]
    assert r["staged_check"]["time_share"]["value"] > 0
    assert "breakdown" not in r    # no device events in a CPU trace


def test_the_same_seed_makes_the_same_inputs(tiny):
    from stkde_bench.gen.events import point_sets

    cell = tiny("pollenus_hr.tile_mb")
    a, b = point_sets(cell.config, 7, 4), point_sets(cell.config, 7, 4)
    c = point_sets(cell.config, 8, 4)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not any((x == y).all() for x, y in zip(a, c))
    assert not (a[0] == a[1]).all()


def _stale(real):
    """Each answer is the one of the query before it."""
    held = []

    def stkde(points, dom, **kw):
        held.append(real(points, dom, **kw))
        return held.pop(0) if len(held) > 1 else held[0]
    return stkde


def _half(real):
    """Half of the points left out, the density normalised over the rest."""
    return lambda points, dom, **kw: real(points[: len(points) // 2], dom,
                                          **kw)


def _altered(real):
    """One voxel, the densest, altered by 1% where the grid is made."""
    def stkde(points, dom, **kw):
        grid = real(points, dom, **kw)
        at = divmod(int(torch.argmax(grid)), grid.shape[1] * grid.shape[2])
        grid[(at[0], *divmod(at[1], grid.shape[2]))] *= 1.01
        return grid
    return stkde


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale", "half", "altered"])
@pytest.mark.parametrize("workload", sorted(E2E))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, workload,
                                            fault):
    from repro_torch.core import api

    monkeypatch.setattr(api, "stkde", fault(api.stkde))
    r = harness.run_cell(tiny(workload), 11, 0.3, False, "cpu")
    assert r["correct"] is False
    assert r["checks"]["grid_err"]["value"] > r["checks"]["grid_err"]["limit"]


def test_a_failed_query_is_counted_and_not_correct(tiny, monkeypatch):
    from repro_torch.core import api

    def stkde(points, dom, **kw):
        raise RuntimeError("out of memory")
    monkeypatch.setattr(api, "stkde", stkde)
    cell = tiny("pollenus_hr.tile_mb", warmup_queries=0)
    r = harness.run_cell(cell, 1, 0.05, False, "cpu")
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1


def test_no_grid_lives_into_the_next_query(tiny, monkeypatch):
    """The window holds no answer while the next query runs: the peak
    memory it reads is the program's alone."""
    import weakref

    from repro_torch.core import api

    real, alive, held = api.stkde, [], []

    def stkde(points, dom, **kw):
        held.append(sum(r() is not None for r in alive))
        grid = real(points, dom, **kw)
        alive.append(weakref.ref(grid))
        return grid
    monkeypatch.setattr(api, "stkde", stkde)
    r = harness.run_cell(tiny("pollenus_hr.tile_mb"), 4, 0.3, False, "cpu")
    assert r["correct"] is True and r["attempted"] >= 2
    assert held and max(held) == 0


def test_a_traffic_names_its_entry_arguments_and_bandwidths(tiny,
                                                            monkeypatch):
    """A mix is data: the entry and its keyword arguments come from the
    traffic file, and queries cycle through its bandwidths."""
    from repro_torch.core import api

    real, seen = api.stkde, []

    def stkde(points, dom, **kw):
        seen.append((dom.Hs, dom.Ht, kw.get("validate")))
        return real(points, dom, **kw)
    monkeypatch.setattr(api, "stkde", stkde)
    cell = tiny("pollenus_hr.scatter_lb", warmup_queries=0,
                kwargs={"validate": False}, bandwidths=[[3, 2], [4, 1]])
    r = harness.run_cell(cell, 21, 0.3, False, "cpu")
    assert r["correct"] is True and r["attempted"] >= 2
    assert seen[:4] == [(3, 2, False), (4, 1, False)] * 2
    with pytest.raises(SystemExit):
        harness.caller({"entry": "repro.core.api.stkde"},
                       harness.devices(1, "cpu"))


def test_a_traffic_may_run_on_a_mesh_of_the_cells_devices(tiny,
                                                         monkeypatch):
    """A mix that names a mesh gets one of the cell's devices (here four
    host devices) in place of ``device=``, and its answer is checked."""
    from repro_torch.core import api

    real, meshes = api.stkde, []

    def stkde(points, dom, **kw):
        meshes.append((kw["mesh"].shape, "device" in kw))
        return real(points, dom, **kw)
    monkeypatch.setattr(api, "stkde", stkde)
    cell = tiny("pollenus_hr.scatter_lb", warmup_queries=1,
                mesh={"shape": [2, 2], "axes": ["data", "model"]})
    cell.chips = 4
    r = harness.run_cell(cell, 8, 0.2, False, "cpu")
    assert r["correct"] is True
    assert meshes[0] == ({"data": 2, "model": 2}, False)


def test_a_staged_copy_that_drifted_drops_its_metrics(tiny, monkeypatch):
    """A staged breakdown whose grid is not the real query's is caught:
    its metrics are left out and the result line says by how much."""
    import importlib

    pb_mod = importlib.import_module("repro_torch.core.pb")
    real = pb_mod.pb
    monkeypatch.setattr(pb_mod, "pb", lambda p, dom, **kw: real(
        p[: len(p) // 2], dom, **kw))
    r = harness.run_cell(tiny("pollenus_hr.scatter_lb"), 5, 0.3, True, "cpu")
    gap = r["staged_check"]["grid_gap"]
    assert gap["value"] > gap["limit"]
    assert not {"entry_ms", "scatter_ms", "finish_ms"} & set(r["metrics"])
    # the timed path itself is sound
    assert r["correct"] is True


def test_fingerprints_see_one_voxel_and_not_the_copy():
    g = torch.rand(17, 5, 9, dtype=torch.float32)
    a = harness.fingerprint(g, slab=4)
    assert a.shape == (2, 17, 5)
    assert harness._gap(a, harness.fingerprint(g.clone(), slab=8)) == 0
    h = g.clone()
    h[16, 4, 8] += 0.01
    assert harness._gap(harness.fingerprint(h), a) > 1e-3


def test_devtrace_summary_of_a_hand_made_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.QUERY,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": devtrace.QUERY,
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "stkde_bench.warmup",
         "ts": -50, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": -45, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 150,
         "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 75,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 80, "dur": 10},
    ]
    s = devtrace.summarize({"traceEvents": ev})
    assert s["queries"] == 2 and s["window_s"] == pytest.approx(200e-6)
    # busy: [10, 70] and [150, 200] -> 110 us of 200
    assert s["busy_s"] == pytest.approx(110e-6)
    assert s["device_s_by_name"] == pytest.approx(
        {"k1": 40e-6, "k2": 40e-6, "copy": 50e-6})
    idle = dict(s["idle_gaps"])
    assert idle["aten::nonzero"] == pytest.approx(80e-6)   # (70, 150)
    # (0, 10): no host event runs there; the next one starts at 75
    assert idle["host between start and aten::nonzero"] == pytest.approx(
        10e-6)
    assert devtrace.summarize({"traceEvents": ev[3:]}) is None


def test_devtrace_busy_is_averaged_over_the_devices():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.QUERY,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 60,
         "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 40, "dur": 20,
         "args": {"device": 1}},
    ]
    s = devtrace.summarize({"traceEvents": ev}, devices=2)
    assert s["busy_s"] == pytest.approx(40e-6)      # (60 + 20) / 2
    assert devtrace.summarize({"traceEvents": ev})["busy_s"] == (
        pytest.approx(40e-6))                       # two devices seen
    assert devtrace.summarize({"traceEvents": ev}, devices=4)[
        "busy_s"] == pytest.approx(20e-6)
