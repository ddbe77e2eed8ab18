"""``spans.py`` and the readers of the program's spans, on spans recorded
by hand into a fresh tracer of the port, as a profiled query leaves them."""
import types

import pytest

from stkde_bench import harness, spans

# the spans under each stkde.query span: name, card ms, host ms, host syncs
# counted against it, attributes
TILE = [("stkde.validate", 3.0, 3.0, 0, {}),
        ("stkde.h2d", 1.0, 0.2, 0, {"bytes": 36}),
        ("bucketing.overlap", 7.0, 6.0, 12, {"copies": 45}),
        ("bucketing.pad", 1.0, 0.1, 0, {}),
        ("stkde.tile.inputs", 0.5, 0.4, 1, {}),
        ("stkde.tile.plan", 2.0, 2.0, 0, {"copies": 45, "slots": 1000,
                                           "walked_pairs": 4000}),
        ("stkde.tile.launch", 7.0, 0.1, 0, {}),
        ("stkde.finish", 0.5, 0.6, 1, {})]
TILE_2 = [("bucketing.overlap", 9.0, 6.0, 12, {"copies": 90}),
          ("stkde.tile.inputs", 0.5, 0.4, 1, {}),
          ("stkde.tile.plan", 4.0, 4.0, 0, {"copies": 90, "slots": 1000,
                                             "walked_pairs": 6000}),
          ("stkde.finish", 0.3, 0.3, 1, {})]
SCATTER = [("stkde.validate", 3.0, 3.0, 0, {}),
           ("stkde.h2d", 1.0, 1.0, 1, {}),
           ("stkde.scatter", 500.0, 300.0, 868, {"blocks": 434}),
           ("stkde.finish", 0.4, 0.5, 1, {})]
QUERIES = [TILE, TILE_2, SCATTER]
# what each reader makes of QUERIES, with rec.least's support pairs 1000
# and 2000 (a mean of 1500 against a mean of 5000 walked)
READS = {"host_syncs": 14, "plan_ms": 3.0, "bucketing_span_ms": 8.5,
         "scatter_span_ms": 500.0, "finish_span_ms": 0.4,
         "bucket_fill_pct": 6.75, "tile_walk_useful_pct": 30.0}
LEAST = [{"seconds": 6e-5, "support_pairs": 1000},
         {"seconds": 8e-5, "support_pairs": 2000}]


def by_hand(tr, queries):
    """Record each query of ``queries`` into the tracer ``tr``: a
    ``stkde.query`` span over the listed spans, with their card and host
    times and their syncs."""
    was, tr.enabled = tr.enabled, True
    try:
        for listed in queries:
            with tr.span("stkde.query", query=True, path="by hand"):
                for name, dev_ms, host_ms, syncs, attrs in listed:
                    with tr.span(name, **attrs) as sp:
                        tr.count_sync(syncs)
                    sp.device_ms, sp.duration_ns = dev_ms, int(host_ms * 1e6)
    finally:
        tr.enabled = was


def _fresh(monkeypatch, queries, outside=()):
    """A fresh tracer holding ``queries`` (and spans outside any query),
    read by ``spans.py`` in place of the port's global one."""
    from repro_torch.obs import trace

    tr = trace.Tracer()
    tr.enabled = True
    for name in outside:
        with tr.span(name):
            pass
    by_hand(tr, queries)
    monkeypatch.setattr(spans, "program_spans", tr.spans)
    return tr


def _record():
    return harness.Record(trace={"queries": 2}, least=list(LEAST))


def test_queries_are_grouped_by_their_query_id(monkeypatch):
    _fresh(monkeypatch, QUERIES, outside=["chunk.compute"])
    got = spans.queries(spans.program_spans())
    assert [set(q) for q in got] == [
        {"stkde.query"} | {s[0] for s in listed} for listed in QUERIES]
    assert [q["stkde.query"][0].attrs["syncs_total"] for q in got] == [
        14, 14, 870]


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_reads_hand_made_spans(monkeypatch, name):
    _fresh(monkeypatch, QUERIES)
    assert harness.reader(name)(_record()) == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_needs_a_device_trace(monkeypatch, name):
    _fresh(monkeypatch, QUERIES)
    assert harness.reader(name)(harness.Record(least=list(LEAST))) is None


MISSING = {"plan_ms": "stkde.tile.plan", "bucket_fill_pct": "stkde.tile.plan",
           "tile_walk_useful_pct": "stkde.tile.plan",
           "bucketing_span_ms": "bucketing.overlap",
           "scatter_span_ms": "stkde.scatter", "finish_span_ms": "stkde.finish"}


@pytest.mark.parametrize("name", sorted(MISSING))
def test_a_query_missing_the_span_adds_no_value(monkeypatch, name):
    """Without its span in the first query, a reader reads the others; with
    it nowhere, nothing."""
    gone = MISSING[name]
    first = [s for s in TILE if s[0] != gone]
    _fresh(monkeypatch, [first, TILE_2, SCATTER])
    want = {"plan_ms": 4.0, "bucket_fill_pct": 9.0,
            "tile_walk_useful_pct": 25.0, "bucketing_span_ms": 9.0,
            "scatter_span_ms": 500.0, "finish_span_ms": 0.35}[name]
    if name == "scatter_span_ms":      # its one query loses the span
        _fresh(monkeypatch, [TILE, [s for s in SCATTER if s[0] != gone]])
        want = None
    got = harness.reader(name)(_record())
    assert got == (None if want is None else pytest.approx(want))
    _fresh(monkeypatch, [[s for s in q if s[0] != gone] for q in QUERIES])
    assert harness.reader(name)(_record()) is None


def test_a_span_without_its_device_time_adds_no_value(monkeypatch):
    untimed = [(n, None if n == "stkde.finish" else d, h, s, a)
               for n, d, h, s, a in TILE]
    _fresh(monkeypatch, [untimed, TILE_2])
    assert harness.reader("finish_span_ms")(_record()) == pytest.approx(0.3)


def test_spans_without_query_ids_read_nothing(monkeypatch):
    """A program older than the query spans (its spans carry no ``query``,
    ``syncs`` or ``device_ms``) gives no value and raises nothing."""
    old = [types.SimpleNamespace(name="bucketing.overlap", attrs={"cap": 8},
                                 duration_ns=1000)]
    monkeypatch.setattr(spans, "program_spans", lambda: old)
    for name in READS:
        assert harness.reader(name)(_record()) is None
