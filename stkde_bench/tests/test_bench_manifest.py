"""``BENCHMARK.json`` against the benchmark's contract: names, units, the
files each entry points to, and the metrics each cell reports."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "stkde_bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["stkde_bench"]
    assert MANIFEST["command"][1:] == ["stkde_bench/run.py"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_have_only_their_keys_and_good_names(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert set(e) <= KEYS[kind] and set(e) >= KEYS[kind] - {"workloads"}
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_units_sources_and_reader(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = {e["name"]: e for e in MANIFEST["end_to_end"]}[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for cell in CELLS:
        e2e = [m for m in MANIFEST["end_to_end"]
               if cell in m.get("workloads", [cell])]
        layer = [m for m in MANIFEST["per_layer"] if cell in m["workloads"]]
        assert len(e2e) >= 2 and layer


def test_layers_are_named_alike_and_ratio_metrics_are_percent():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len({m["layer"] for m in MANIFEST["per_layer"]}) >= 6


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist_and_hold_what_they_say(w):
    from stkde_bench import harness

    assert w["chips"] == 1
    cell = harness.load_cell(w["name"])
    assert cell.traffic["name"] == w["traffic"]
    assert cell.config["name"] == w["config"]
    assert cell.traffic["entry"].split(".")[0] == harness.PROGRAM
    assert (BENCH / "staged" / f"{cell.traffic['staged']}.py").is_file()
    assert 1 <= len(cell.traffic["bandwidths"]) <= cell.traffic[
        "warmup_queries"]
    assert 0 < float(cell.limits["grid_err"]) < 1
    assert sum(1 for x in CELLS.values()
               if (x["config"], x["traffic"]) == (w["config"], w["traffic"])
               ) == 1


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs_are_table2_rows_uncut(c):
    from stkde_bench.gen.table2 import ROWS

    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("stkde_bench/configs/")
    assert c["reduced"] == cfg["reduced"] == []
    for row in cfg["rows"]:
        r = ROWS[row]
        assert (r.n, r.Gx, r.Gy, r.Gt, r.layout_seed) == (
            cfg["n"], cfg["Gx"], cfg["Gy"], cfg["Gt"], cfg["layout_seed"])
    assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
