"""What ``tests/test_bench_readers.py`` needs of the readers of the
program's spans (``spans.py``): its test of every manifest name on a record
made by hand looks up one expected reading a name.

For that file alone, the span readers read a fresh tracer of the port
holding ``tests/test_bench_spans.QUERIES`` in place of the port's global
one, the hand-made record's profiled queries carry their support pairs, as
a traced run's do (``roofline.py``), and each span reader's expected reading
is the one ``tests/test_bench_spans.READS`` gives for those spans."""
import pytest


@pytest.fixture(autouse=True)
def _span_readings(request, monkeypatch):
    if request.path.name != "test_bench_readers.py":
        return
    from repro_torch.obs import trace

    from stkde_bench import spans
    from stkde_bench.tests import test_bench_spans as by_hand

    mod = request.module
    for name, value in by_hand.READS.items():
        monkeypatch.setitem(mod.EXPECTED, name, value)
    tr = trace.Tracer()
    by_hand.by_hand(tr, by_hand.QUERIES)
    monkeypatch.setattr(spans, "program_spans", tr.spans)
    made = mod._record

    def record():
        rec = made()
        rec.least = [dict(q, support_pairs=h["support_pairs"])
                     for q, h in zip(rec.least, by_hand.LEAST)]
        return rec
    monkeypatch.setattr(mod, "_record", record)
