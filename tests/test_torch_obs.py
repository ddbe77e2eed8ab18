"""The port's observability layer (counterparts of ``tests/test_obs.py``:
spans, Chrome export, counters/gauges, histograms, registry merge and reset,
the timer) and the spans/counters of the layers that report into it."""
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
    reference's are reset by ``conftest.py``; the port's are its own)."""
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


# ------------------------------------------------------------------ trace
def test_span_nesting_and_attrs():
    tr = trace.Tracer()
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
    tr = trace.Tracer()
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
    ours, theirs = trace.Tracer(), ref_trace.Tracer()
    for tr in (ours, theirs):
        with tr.span("phase", n=7, s="x"):
            pass
    (a,), (b,) = (tr.to_chrome_trace()["traceEvents"] for tr in (ours, theirs))
    assert set(a) == set(b)
    assert {k: a[k] for k in ("name", "ph", "pid", "args")} == {
        k: b[k] for k in ("name", "ph", "pid", "args")}


def test_ingest_foreign_events():
    tr = trace.Tracer()
    tr.ingest([{"name": "child", "ph": "X", "ts": 1.0, "dur": 2.0,
                "pid": 0, "tid": 0, "args": {}}], pid=42)
    evs = tr.to_chrome_trace()["traceEvents"]
    assert evs[0]["pid"] == 42


def test_profiler_mirror_off_by_default_and_records_ranges_when_on():
    assert trace.get_tracer().mirror_profiler is False
    tr = trace.Tracer(mirror_profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("mirror.probe"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "mirror.probe" in names
    assert tr.spans("mirror.probe")
    trace.set_mirror_profiler(True)
    assert trace.get_tracer().mirror_profiler is True
    trace.set_mirror_profiler(False)


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


def test_registry_merge_cross_process_shape():
    r = metrics.Registry()
    h = r.histogram("x_s")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    r.counter("n").inc(5)
    r2 = metrics.Registry()
    r2.merge(json.loads(json.dumps(r.to_dict())))
    d = r2.to_dict()
    assert d["counters"]["n"] == 5
    assert d["histograms"]["x_s"]["count"] == 3
    assert d["histograms"]["x_s"]["min"] == pytest.approx(0.1)


def test_registry_dict_is_the_references():
    """A registry exported by one package merges into the other's."""
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
    assert timing._block(x) is x
    assert timing._block(7) == 7
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
        assert ours.attrs == theirs.attrs
        assert ours.attrs["n"] == 200 and ours.attrs["cap"] >= 1
    assert "replication" in trace.get_tracer().spans(
        "bucketing.overlap")[0].attrs


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
