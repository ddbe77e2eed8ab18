"""Each reader in ``metrics/`` on a record made by hand, and on an empty one
(a reader that finds nothing to read returns nothing)."""
import json
from pathlib import Path

import pytest

from stkde_bench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]


def _record():
    rec = harness.Record(setup_s=7.5, window_s=2.0,
                         latencies_s=[0.01 * (i + 1) for i in range(100)],
                         peak_bytes=3 * 2**30)
    rec.stages = {"entry": [0.001, 0.003, 0.002], "h2d": [0.0005],
                  "bucketing": [0.01, 0.012], "tile_call": [0.002],
                  "scatter": [0.5], "finish": [0.0001]}
    rec.counters = {"bucket_bytes": [2**30, 2**31, 2**31]}
    rec.trace = {"queries": 4, "window_s": 0.1, "busy_s": 0.08,
                 "device_s_by_name": {"stkde_tile_kernel(float*)": 0.02,
                                      "stkde_reduce_kernel(int*)": 0.004,
                                      "elementwise": 0.05}}
    rec.least = [{"seconds": 6e-5}, {"seconds": 8e-5}]
    return rec


EXPECTED = {
    "queries_per_s": 50.0,
    "query_p95_ms": 950.5,
    "query_tail_p95_ms": 950.5,
    "peak_mem_gib": 3.0,
    "setup_s": 7.5,
    "entry_ms": 2.0,
    "h2d_ms": 0.5,
    "bucketing_ms": 11.0,
    "tile_call_ms": 2.0,
    "scatter_ms": 500.0,
    "finish_ms": 0.1,
    "bucket_gib": 2.0,
    "tile_kernel_ms": 6.0,
    "tile_kernel_roofline_pct": 100 * 7e-5 / 0.006,
    "device_roofline_pct": 100 * 7e-5 * 4 / 0.08,
    "device_idle_pct": 20.0,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_a_record(name):
    assert harness.reader(name)(_record()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_of_an_empty_record_returns_nothing(name):
    assert harness.reader(name)(harness.Record()) is None


def test_kernel_readers_need_the_kernel_in_the_trace():
    rec = _record()
    rec.trace["device_s_by_name"] = {"elementwise": 0.05}
    assert harness.reader("tile_kernel_ms")(rec) is None
    assert harness.reader("tile_kernel_roofline_pct")(rec) is None
    rec.least = []
    assert harness.reader("device_roofline_pct")(rec) is None
