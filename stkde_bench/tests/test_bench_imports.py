"""Nothing the benchmark runs loads JAX or the JAX package ``repro``,
compared by the top-level name of each module; and a run without a card,
or without the port beside it, prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from stkde_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "stkde_bench"
SOURCES = sorted(BENCH.rglob("*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert harness.forbidden_modules(names) == [], (path, names)


def test_names_are_compared_whole_before_the_first_dot():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "flaxen",
         "stkde_bench.run"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.api", "jax.numpy", "jaxlib", "flax.linen"]
    ) == ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_repro():
    """A tiny run on the CPU in a fresh process, then its ``sys.modules``."""
    code = """
import json, sys
from stkde_bench import harness, run, check, roofline, devtrace
cell = harness.load_cell("pollenus_hr.tile_mb")
cell.config.update(n=1500, Gx=24, Gy=20, Gt=12)
cell.traffic.update(bandwidths=[[3, 2]], trace_queries=2, staged_queries=1)
r = harness.run_cell(cell, 5, 0.05, True, "cpu")
for m in (harness.load_cell(w).metrics for w in
          ("pollenus_hr.scatter_lb", "flu_hr.tile_lb")):
    for e in m["end_to_end"] + m["per_layer"]:
        harness.reader(e["name"])
print(json.dumps({"correct": r["correct"],
                  "repro_torch": "repro_torch" in sys.modules,
                  "bad": harness.forbidden_modules()}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "repro_torch": True, "bad": []}


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "stkde_bench/run.py", "--workload",
         "pollenus_hr.tile_mb", "--seed", "1", "--seconds", "1"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(ROOT, _env())
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "stkde_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = _run(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """On a card: a short run of the first cell prints a correct result."""
    out = subprocess.run(
        [sys.executable, "stkde_bench/run.py", "--workload",
         "pollenus_hr.tile_mb", "--seed", "2", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
