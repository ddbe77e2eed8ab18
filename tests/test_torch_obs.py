"""The port's observability layer (counterparts of ``tests/test_obs.py``:
spans, Chrome export, counters/gauges, histograms, registry reset, the
timer, the planner reconciliation; and the port's own: a tracer off by
default, its profiler ranges, query ids, device events and sync counts)
and the spans/counters of the layers that report into it."""
import json

import numpy as np
import pytest
import torch

from repro.core import Domain as RefDomain
from repro.core import bucketing as ref_bucketing
from repro.core import clustered_events
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace

from repro_torch import convert
from repro_torch.core import bucketing
from repro_torch.obs import metrics, timeit, timing, trace
from repro_torch.resilience import ensure_finite, faults
from repro_torch.resilience.errors import NonFiniteOutputError


@pytest.fixture(autouse=True)
def _reset_port_obs():
    """Fresh port tracer + metrics registry + fault injector per test (the
    reference's are reset by ``conftest.py``; the port's are its own). The
    port's tracer records for the test, as its tests of the spans read them
    (it is off by default)."""
    trace.enable()
    yield
    trace.enable(False)
    trace.reset()
    metrics.reset()
    faults.reset()


# ------------------------------------------------------------------ trace
def _on(tr):
    tr.enabled = True
    return tr


def test_span_nesting_and_attrs():
    tr = _on(trace.Tracer())
    with tr.span("outer", a=1):
        with tr.span("inner") as inner:
            inner.set(found=3)
    spans = {s.name: s for s in tr.spans()}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id is None
    assert spans["outer"].attrs == {"a": 1}
    assert spans["inner"].attrs == {"found": 3}
    assert spans["inner"].duration_ns <= spans["outer"].duration_ns
    assert spans["inner"].start_ns >= spans["outer"].start_ns


def test_global_span_helper_records():
    with trace.span("unit.test", k="v") as sp:
        pass
    assert sp.duration_s >= 0
    assert trace.get_tracer().spans("unit.test")
    assert not ref_trace.get_tracer().spans("unit.test")  # its own tracer


def test_chrome_trace_schema(tmp_path):
    tr = _on(trace.Tracer())
    with tr.span("phase", n=7, arr=np.arange(2), t=torch.zeros(1)):
        pass
    doc2 = json.loads(json.dumps(tr.to_chrome_trace()))
    assert doc2["displayTimeUnit"] == "ms"
    (ev,) = doc2["traceEvents"]
    assert ev["ph"] == "X"
    assert ev["name"] == "phase"
    for key in ("ts", "dur", "pid", "tid", "args"):
        assert key in ev
    assert ev["dur"] >= 0
    assert ev["args"]["n"] == 7
    p = tmp_path / "trace.json"
    tr.save(str(p))
    assert json.loads(p.read_text())["traceEvents"]


def test_chrome_trace_matches_reference_schema():
    """Both packages write the same event for the same span."""
    ours, theirs = _on(trace.Tracer()), ref_trace.Tracer()
    for tr in (ours, theirs):
        with tr.span("phase", n=7, s="x"):
            pass
    (a,), (b,) = (tr.to_chrome_trace()["traceEvents"] for tr in (ours, theirs))
    assert set(a) == set(b)
    assert {k: a[k] for k in ("name", "ph", "pid", "args")} == {
        k: b[k] for k in ("name", "ph", "pid", "args")}


def _no_cuda_calls(monkeypatch):
    """Make every CUDA event and sync-debug call fail the test."""
    def called(*a, **k):
        raise AssertionError("the tracer touched CUDA while off")

    for name in ("Event", "set_sync_debug_mode", "get_sync_debug_mode",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, called)


def test_profiler_mirror_off_by_default_and_records_ranges_when_on():
    """A tracer is off until enabled or a profiler records; a span that
    records is always a ``record_function`` range of the profiler."""
    tr = trace.Tracer()
    assert tr.enabled is False
    with tr.span("mirror.probe") as sp:
        torch.ones(4).sum()
    assert sp is trace.OFF and not tr.spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("mirror.probe") as sp:
            torch.ones(4).sum()
    assert sp.recording
    names = {e.key for e in prof.key_averages()}
    assert "mirror.probe" in names
    assert [s.name for s in tr.spans()] == ["mirror.probe"]
    with tr.span("mirror.after"):
        pass
    assert [s.name for s in tr.spans()] == ["mirror.probe"]


def test_tracer_off_records_nothing_allocates_nothing_touches_no_cuda(
        monkeypatch):
    """Off, ``span`` hands back one shared span that records nothing and
    ignores attributes, whatever device or query it is given."""
    _no_cuda_calls(monkeypatch)
    tr = trace.Tracer()
    a = tr.span("x", device="cuda", query=True, n=1)
    b = tr.span("y", device=torch.device("cuda", 0))
    assert a is b is trace.OFF
    with a as sp:
        sp.set(k=1)
        tr.count_sync()
    assert not sp.recording and dict(sp.attrs) == {}
    assert tr.spans() == [] and tr._next_id == 0


def test_stkde_with_the_tracer_off_records_no_span_and_no_cuda_call(
        monkeypatch):
    """Both single-device branches of ``stkde`` with the port's tracer off
    and no profiler: no span, no CUDA event, no sync-debug call."""
    from repro_torch.core import stkde

    monkeypatch.setattr(trace.get_tracer(), "enabled", False)
    trace.reset()
    _no_cuda_calls(monkeypatch)
    dom, pts = _small_query()
    for tiled in (True, False):
        stkde(pts, dom, use_tiled_kernel=tiled, device="cpu")
    assert trace.get_tracer().spans() == []


def test_tracer_records_while_a_cpu_profiler_session_records():
    tr = trace.Tracer()
    with tr.span("before"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tr.span("during"):
            pass
    with tr.span("after"):
        pass
    assert [s.name for s in tr.spans()] == ["during"]
    trace.enable(False)
    try:
        with trace.span("global.off"):
            pass
        assert not trace.get_tracer().spans("global.off")
    finally:
        trace.enable()


def _small_query():
    ref = RefDomain(gx=24.0, gy=18.0, gt=14.0, sres=1.0, tres=1.0, hs=3.0,
                    ht=2.0)
    return (convert.domain_from_reference(ref),
            clustered_events(300, ref, seed=5))


QUERY_SPANS = {
    "tile": {"stkde.query", "stkde.validate", "stkde.h2d",
             "bucketing.overlap", "bucketing.pad", "stkde.tile.inputs",
             "stkde.finish"},
    "pb": {"stkde.query", "stkde.validate", "stkde.h2d", "stkde.scatter",
           "stkde.finish"},
}


@pytest.mark.parametrize("path", sorted(QUERY_SPANS))
def test_query_spans_are_profiler_annotations_nested_around_their_ops(
        path, tmp_path):
    """Every span of a query on the CPU is a ``user_annotation`` of the
    profiler's exported trace, inside its parent's annotation as the tracer
    nests it, with the ops it ran inside it."""
    from repro_torch.core import stkde

    trace.enable(False)
    trace.reset()
    dom, pts = _small_query()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            stkde(pts, dom, use_tiled_kernel=path == "tile", device="cpu")
    finally:
        trace.enable()
    spans = {s.name: s for s in trace.get_tracer().spans()}
    assert set(spans) == QUERY_SPANS[path]
    assert spans["stkde.query"].attrs["path"] == path
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert set(spans) <= set(ann)

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    by_id = {s.span_id: s for s in spans.values()}
    for name, sp in spans.items():
        if sp.parent_id is not None:
            assert inside(ann[name], ann[by_id[sp.parent_id].name]), name
        if name != "stkde.validate":          # numpy: no op of torch
            assert any(inside(op, ann[name]) for op in ops), name


def test_spans_of_one_query_share_its_id():
    from repro_torch.core import stkde

    trace.reset()
    dom, pts = _small_query()
    with trace.span("outside"):
        pass
    for tiled in (True, False):
        stkde(pts, dom, use_tiled_kernel=tiled, device="cpu")
    spans = trace.get_tracer().spans()
    roots = [s for s in spans if s.name == "stkde.query"]
    assert len(roots) == 2
    assert {s.query for s in roots} == {s.span_id for s in roots}
    for s in spans:
        if s.name == "outside":
            assert s.query is None and "syncs" not in s.attrs
        else:
            assert s.query in {r.span_id for r in roots}
            assert s.attrs["syncs"] == 0       # no card: nothing waits
    assert len({s.query for s in spans if s.query is not None}) == 2
    assert all("query" in e["args"] for e in trace.get_tracer(
        ).to_chrome_trace()["traceEvents"] if e["name"] != "outside")


def test_sync_warnings_count_against_the_innermost_span():
    """Inside a query span each sync warning is counted against the
    innermost open span and not shown; other warnings are shown as ever,
    and after the query a sync warning is an ordinary warning again."""
    import warnings

    tr = _on(trace.Tracer())
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with tr.span("q", query=True):
            warnings.warn(trace.SYNC_WARNING)
            with tr.span("a"):
                with tr.span("b"):
                    for _ in range(3):
                        warnings.warn(trace.SYNC_WARNING)
                warnings.warn(trace.SYNC_WARNING + " (counted)")
                warnings.warn("something else")
                tr.count_sync(2)
        warnings.warn(trace.SYNC_WARNING)
    assert [str(w.message) for w in shown] == [
        "something else", trace.SYNC_WARNING]
    got = {s.name: s.attrs for s in tr.spans()}
    assert got["b"]["syncs"] == 3 and got["a"]["syncs"] == 3
    assert got["q"]["syncs"] == 1 and got["q"]["syncs_total"] == 7


def test_count_sync_counts_against_the_open_span_only():
    """Outside a query a span carries ``syncs`` only where some were
    counted by hand; with no span open a count goes nowhere."""
    tr = _on(trace.Tracer())
    tr.count_sync()
    with tr.span("waits"):
        tr.count_sync()
    with tr.span("plain"):
        pass
    got = {s.name: s.attrs for s in tr.spans()}
    assert got == {"waits": {"syncs": 1}, "plain": {}}


def test_span_cap_drops_the_oldest_first():
    tr = _on(trace.Tracer(max_spans=3))
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.spans()] == ["s2", "s3", "s4"]
    assert tr.dropped == 2
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_device_events_are_recorded_on_the_stream_and_read_late(
        monkeypatch):
    """With ``device=`` a card, a span records one event at its open and one
    at its close on the device's current stream, and reads their time only
    when the spans are read; a query span turns the sync debug mode to
    "warn" and back."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None

        def record(self, stream):
            log.append(("record", stream))
            self.at = len(log)

        def synchronize(self):
            log.append(("synchronize",))

        def elapsed_time(self, end):
            return 0.5 * (end.at - self.at)

    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: "stream")
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    tr = _on(trace.Tracer())
    with tr.span("q", device="cuda", query=True):
        assert modes == ["default", "warn"]
        with tr.span("inner", device=torch.device("cuda")):
            pass
    assert modes == ["default", "warn", "default"]
    assert [x[0] for x in log] == ["record"] * 4
    assert all(x[1] == "stream" for x in log)
    got = {s.name: s.device_ms for s in tr.spans()}
    assert got == {"inner": 0.5, "q": 1.5}
    assert [x[0] for x in log[4:]] == ["synchronize"] * 2
    tr.spans()                                  # resolved once
    assert len(log) == 6


# ---------------------------------------------------------------- metrics
def test_counter_and_gauge():
    metrics.counter("t.c").inc()
    metrics.counter("t.c").inc(2)
    metrics.gauge("t.g").set(1.5)
    d = metrics.export()
    assert d["counters"]["t.c"] == 3
    assert d["gauges"]["t.g"] == 1.5
    assert "t.c" not in ref_metrics.export()["counters"]  # its own registry


def test_histogram_percentiles():
    h = metrics.Histogram()
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100
    assert s["min"] == 1.0 and s["max"] == 100.0
    assert abs(s["p50"] - 50) / 50 < 0.10
    assert abs(s["p95"] - 95) / 95 < 0.10
    assert abs(s["p99"] - 99) / 99 < 0.10
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]


def test_histogram_nonpositive_and_empty():
    h = metrics.Histogram()
    assert np.isnan(h.percentile(0.5))
    h.observe(0.0)
    h.observe(-1.0)
    assert h.count == 2
    assert h.percentile(0.5) == -1.0  # underflow bucket reports min


def test_registry_dict_is_the_references():
    """A registry exported by the port merges into the reference's."""
    r = metrics.Registry()
    r.counter("n").inc(2)
    r.histogram("x_s").observe(0.5)
    theirs = ref_metrics.Registry()
    theirs.merge(json.loads(json.dumps(r.to_dict())))
    assert theirs.to_dict() == r.to_dict()


@pytest.mark.parametrize("order", ["a", "b"])
def test_registry_reset_between_tests(order):
    # with the autouse fixture, neither case may see the other's state
    assert "leak.probe" not in metrics.get_registry().names()
    metrics.counter("leak.probe").inc()


# ----------------------------------------------------------------- timing
def test_timeit_records_span_and_histogram():
    res = timeit(lambda: sum(range(100)), reps=3, warmup=1, name="t.work")
    assert len(res.times) == 3
    assert res.best <= res.mean
    assert len(trace.get_tracer().spans("bench.t.work")) == 3
    assert metrics.export()["histograms"]["t.work_s"]["count"] == 3


def test_block_never_touches_cuda_for_host_values(monkeypatch):
    """CPU tensors (in tuples, lists, dicts) and plain values are not
    waited for: nothing of CUDA is called."""
    def no_cuda(*a, **k):
        raise AssertionError("torch.cuda.synchronize was called")

    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    x = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": "s"}
    assert timing.block_until_ready(x) is x
    assert timing.block_until_ready(7) == 7
    res = timeit(lambda: torch.ones(8).sum(), reps=2, warmup=0)
    assert len(res.times) == 2


# ------------------------------------------ spans and counters of the layers
def test_bucketing_spans_recorded_with_the_references_attributes():
    ref = RefDomain(gx=24.0, gy=18.0, gt=14.0, sres=1.0, tres=1.0, hs=3.0,
                    ht=2.0)
    dom = convert.domain_from_reference(ref)
    pts = clustered_events(200, ref, seed=7)
    for fn, ref_fn in ((bucketing.bucket_points_home,
                        ref_bucketing.bucket_points_home),
                       (bucketing.bucket_points_overlap,
                        ref_bucketing.bucket_points_overlap)):
        fn(pts, dom, (8, 8, 4))
        ref_fn(pts, ref, (8, 8, 4))
    for name in ("bucketing.home", "bucketing.overlap"):
        (ours,) = trace.get_tracer().spans(name)
        (theirs,) = ref_trace.get_tracer().spans(name)
        # the port's overlap span adds the copies, a host number
        copies = ours.attrs.pop("copies", None)
        assert ours.attrs == theirs.attrs
        assert ours.attrs["n"] == 200 and ours.attrs["cap"] >= 1
    assert "replication" in trace.get_tracer().spans(
        "bucketing.overlap")[0].attrs
    assert copies == int(ref_bucketing.bucket_points_overlap(
        pts, ref, (8, 8, 4)).counts.sum())


def test_nonfinite_output_counted():
    ok = torch.ones(3)
    assert ensure_finite(ok) is ok
    assert "resilience.nonfinite" not in metrics.get_registry().names()
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    with pytest.raises(NonFiniteOutputError, match="2/3"):
        ensure_finite(bad, "probe")
    with pytest.raises(NonFiniteOutputError):
        ensure_finite(bad, "probe")
    assert metrics.counter("resilience.nonfinite").value == 2


# -------------------------------------------------------------- reconcile
def test_reconcile_smoke_8dev_all_registry_strategies():
    """reconcile.run on a 2x2x2 mesh of CPU shards probes every PROBED
    strategy and emits all four terms per strategy — no silently missing
    rows — and predicts what the reference's ``plan.estimate`` predicts
    for the same plan shape, loads and record (``HOST`` on the CPU)."""
    from repro.core import plan as ref_plan
    from repro.obs import reconcile as ref_reconcile

    from repro_torch.distributed import make_host_mesh
    from repro_torch.obs import reconcile

    ref = RefDomain(gx=48.0, gy=48.0, gt=16.0, sres=1.0, tres=1.0, hs=3.0,
                    ht=2.0)
    dom = convert.domain_from_reference(ref)
    pts = clustered_events(1500, ref, seed=0)
    mesh = make_host_mesh(8, multi_pod=True, device="cpu")
    res = reconcile.run(pts, dom, mesh, reps=1)
    assert res["hw"] == "host" and res["mesh"] == "2x2x2"
    assert (res["n"], res["grid"]) == (1500, "48x48x16")
    assert "nvidia_smi" not in res     # the mesh is not on a card
    strategies = {r["strategy"] for r in res["rows"]}
    assert strategies == set(reconcile.PROBED) == set(ref_reconcile.PROBED)
    for strat in strategies:
        terms = {r["term"] for r in res["rows"] if r["strategy"] == strat}
        assert terms == set(reconcile.TERMS) == set(ref_reconcile.TERMS)
    for r in res["rows"]:
        assert r["measured_s"] >= 0
        assert r["rel_err"] is not None
    assert "strategy" in res["report"]
    loads = ref_bucketing.bucket_points_home(
        pts, ref, (24, 24, 16)).counts.reshape(-1).astype(np.float64)
    for strat in strategies:
        spec = ref_reconcile.PROBED[strat]
        shape = spec.plan_shape(mesh, spec.default_axes(mesh))
        assert shape == reconcile.PROBED[strat].plan_shape(
            mesh, reconcile.PROBED[strat].default_axes(mesh))
        want = ref_plan.estimate(ref, 1500, shape, loads=loads,
                                 hw=ref_plan.HOST)[strat]
        got = {r["term"]: r["predicted_s"] for r in res["rows"]
               if r["strategy"] == strat}
        assert got == {t: want[t] for t in reconcile.TERMS}, strat
    assert len(trace.get_tracer().spans("reconcile.measure")) == 1


def test_measure_strategy_error_lists_registry_keys():
    from repro_torch.obs import reconcile

    with pytest.raises(ValueError) as ei:
        reconcile.measure_strategy(
            np.zeros((1, 3), np.float32), None, None, "nope")
    for name in reconcile.PROBED:
        assert name in str(ei.value)


def test_reconcile_rows_and_report_text_match_reference():
    """``reconcile`` and ``report_text`` on fixed inputs (a missing
    prediction, a missing measured term, zero predictions) and on the
    committed H100 rows give the reference's output exactly; records are
    named as the reference names its own."""
    import pathlib

    from repro.obs import reconcile as ref_reconcile

    from repro_torch.core import plan
    from repro_torch.obs import reconcile

    predicted = {"dr": {"init_s": 0.5, "compute_s": 2.0, "comm_s": 0.0,
                        "total_s": 2.5},
                 "pd": {"init_s": 1e-6, "compute_s": 3.25}}
    measured = {"dr": {"init_s": 0.25, "compute_s": 3.0, "comm_s": 0.125,
                       "total_s": 3.375},
                "pd": {"init_s": 2e-6, "compute_s": 1.0, "total_s": 1.5},
                "hybrid": {"total_s": 0.75}}
    rows = reconcile.reconcile(predicted, measured)
    assert rows == ref_reconcile.reconcile(predicted, measured)
    assert reconcile.report_text(rows) == ref_reconcile.report_text(rows)
    path = (pathlib.Path(__file__).resolve().parent.parent / "results"
            / "torch" / "reconcile_h100.json")
    for rep in json.load(open(path)):
        assert reconcile.report_text(rep["rows"]) == rep["report"] == \
            ref_reconcile.report_text(rep["rows"])
    names = {name: reconcile._hw_name(getattr(plan, rec)) for name, rec in (
        ("host", "HOST"), ("host_seed", "HOST_SEED"), ("h100", "H100"),
        ("h100_seed", "H100_SEED"))}
    assert all(k == v for k, v in names.items()), names
    assert reconcile._hw_name(plan.Hardware(1.0, 1.0, 1.0, 1.0)) == "custom"


def test_median_reports_take_each_rows_median(tmp_path):
    """``reconcile.median_reports`` (and ``main`` over ``chip_smoke.py``
    logs): each row's measured seconds the median over the runs, its
    relative error and the report text again; runs whose rows differ
    raise. The committed H100 record is a median of at least 3 runs."""
    import contextlib
    import io
    import pathlib

    from repro_torch.obs import reconcile

    predicted = {"dr": {"init_s": 0.5, "compute_s": 2.0},
                 "dd": {"compute_s": 1.0}}

    def one_run(scale):
        rows = reconcile.reconcile(predicted, {
            "dr": {"init_s": 0.25 * scale, "compute_s": 3.0 * scale},
            "dd": {"compute_s": 1.5 * scale, "total_s": 2.0 * scale}})
        return [{"mesh": "2x2", "rows": rows,
                 "report": reconcile.report_text(rows)}]

    runs = [one_run(s) for s in (1.0, 4.0, 2.0)]
    got = reconcile.median_reports(runs)
    want = one_run(2.0)[0]
    assert got == [{**want, "median_of": 3}]
    log = tmp_path / "run.log"
    log.write_text("".join(
        '{"phase": "other"}\n' + json.dumps(
            {"phase": "planner_reconcile", "reports": r}) + "\n"
        for r in runs))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reconcile.main([str(log)])
    assert json.loads(out.getvalue()) == got
    other = one_run(1.0)
    other[0]["rows"] = other[0]["rows"][1:]
    with pytest.raises(ValueError, match="same rows"):
        reconcile.median_reports(runs + [other])
    path = (pathlib.Path(__file__).resolve().parent.parent / "results"
            / "torch" / "reconcile_h100.json")
    assert all(rep["median_of"] >= 3 for rep in json.load(open(path)))
