"""The readers of the packed buckets' spans, ``packed_bucketing_ms`` and
``packed_bucket_gib``, on spans recorded by hand as a profiled tile query
leaves them, and on the spans of a program that does not pack."""
import pytest

from stkde_bench import harness
from stkde_bench.tests import test_bench_readers
from stkde_bench.tests.test_bench_spans import SCATTER, _fresh, _record

# test_bench_readers.py reads every manifest name on its record made by hand,
# whose spans (test_bench_spans.QUERIES) are those of a program that pads its
# buckets: there the two packed readers read nothing.
for _name in ("packed_bucketing_ms", "packed_bucket_gib"):
    test_bench_readers.EXPECTED.setdefault(_name, None)

GIB = 2**30
# name, card ms, host ms, host syncs, attributes (as test_bench_spans.TILE)
PACKED = [("stkde.validate", 3.0, 3.0, 0, {}),
          ("bucketing.overlap", 9.0, 8.0, 9, {"copies": 40}),
          ("bucketing.pack", 7.0, 7.5, 3,
           {"copies": 40, "slots": 40, "bytes": GIB // 2, "max_load": 30}),
          ("stkde.tile.inputs", 0.2, 0.3, 0, {}),
          ("stkde.tile.plan", 20.0, 20.0, 0, {"copies": 40, "slots": 40,
                                              "walked_pairs": 4000}),
          ("stkde.finish", 15.0, 60.0, 1, {})]
PACKED_2 = [("bucketing.overlap", 5.0, 4.0, 9, {"copies": 20}),
            ("bucketing.pack", 2.0, 2.5, 3,
             {"copies": 20, "slots": 20, "bytes": GIB // 4, "max_load": 9})]
PADDED = [("bucketing.overlap", 7.0, 6.0, 12, {"copies": 45}),
          ("bucketing.pad", 1.0, 0.1, 0, {}),
          ("stkde.tile.plan", 2.0, 2.0, 0, {"copies": 45, "slots": 1000})]


@pytest.mark.parametrize("name,want", [
    ("packed_bucketing_ms", (16.0 + 7.0) / 2),
    ("packed_bucket_gib", (0.5 + 0.25) / 2),
])
def test_readers_read_the_packed_spans(monkeypatch, name, want):
    """The median over the tile queries; the scatter query adds nothing."""
    _fresh(monkeypatch, [PACKED, PACKED_2, SCATTER])
    assert harness.reader(name)(_record()) == pytest.approx(want)
    _fresh(monkeypatch, [PACKED])
    assert harness.reader(name)(_record()) == pytest.approx(
        {"packed_bucketing_ms": 16.0, "packed_bucket_gib": 0.5}[name])


@pytest.mark.parametrize("name", ["packed_bucketing_ms",
                                  "packed_bucket_gib"])
def test_a_program_that_pads_reads_nothing(monkeypatch, name):
    """The spans of a tile query that pads its buckets (no
    ``bucketing.pack``) give nothing and raise nothing."""
    _fresh(monkeypatch, [PADDED, SCATTER])
    assert harness.reader(name)(_record()) is None


@pytest.mark.parametrize("name", ["packed_bucketing_ms",
                                  "packed_bucket_gib"])
def test_the_readers_need_a_device_trace(monkeypatch, name):
    _fresh(monkeypatch, [PACKED])
    assert harness.reader(name)(harness.Record()) is None


def test_an_untimed_pack_span_adds_no_time(monkeypatch):
    untimed = [(n, None if n == "bucketing.pack" else d, h, s, a)
               for n, d, h, s, a in PACKED]
    _fresh(monkeypatch, [untimed, PACKED_2])
    assert harness.reader("packed_bucketing_ms")(_record()) == \
        pytest.approx(7.0)
    assert harness.reader("packed_bucket_gib")(_record()) == \
        pytest.approx((0.5 + 0.25) / 2)
