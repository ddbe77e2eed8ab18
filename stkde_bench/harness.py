"""One run of one cell: set-up, a measured window of real queries, the check.

A cell is a configuration (``configs/<name>.json``: a Table 2 dataset at one
resolution) under a traffic mix (``traffic/<name>.json``: the program's
entry and its keyword arguments, the bandwidths one analyst explores with,
the number of point sets, and the staged breakdown of ``staged/<name>.py``).
The run

1. makes ``point_sets`` point sets of the configuration's ``n`` from the
   seed (``gen/``) and warms up the program on them; query ``q`` uses point
   set ``q % point_sets`` and bandwidth ``q % len(bandwidths)``;
2. sends queries in a closed loop for ``seconds``: each one is a host
   float32 array handed to the traffic's ``entry``, timed until the card is
   synchronised after it returns; no grid lives into the next query but the
   window's last one; with ``trace=1`` the same window is followed by
   ``staged_queries`` queries stage by stage (``staged/<name>.py``), each
   beside a real query of the same inputs that it is checked against, and
   then ``trace_queries`` real queries profiled with ``torch.profiler``;
3. once the window has closed and its peak memory has been read, holds the
   grid of the last query (the last profiled one with ``trace=1``) against
   the plain reference (``check.py``);
4. reads each metric the manifest lists for the cell with its reader,
   ``metrics/<name>.py``.

Nothing here names a cell: what belongs to a configuration, a traffic mix
or a metric sits in its own file and is found by name.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, devtrace, roofline
from .gen.events import point_sets
from .gen.table2 import ROWS
from .reference.pbsym import Box

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "repro_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
TILE_KERNELS = ("stkde_tile_kernel", "stkde_reduce_kernel")
# the staged query against a real one of the same inputs: the largest gap
# of their column sums and maxima, as a share of the largest column value;
# and the staged stages' summed time over the real query's (medians)
STAGED_GAP = 1e-5
STAGED_SHARE = (0.8, 1.25)


# ------------------------------------------------------------------ inputs
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: Dict[str, list]     # "end_to_end" / "per_layer" -> entries


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and the metrics it reports."""
    manifest = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    w = cells[name]
    config = _json(HERE / "configs" / f"{w['config']}.json")
    for row in config["rows"]:
        r = ROWS[row]
        if (r.n, r.Gx, r.Gy, r.Gt) != (config["n"], config["Gx"],
                                       config["Gy"], config["Gt"]):
            raise SystemExit(f"configuration {w['config']!r} does not hold "
                             f"Table 2 row {row}")
    reported = {}
    for kind in ("end_to_end", "per_layer"):
        reported[kind] = [m for m in manifest[kind]
                          if name in m.get("workloads", [name])]
    return Cell(name, int(w["chips"]), config,
                _json(HERE / "traffic" / f"{w['traffic']}.json"),
                _json(HERE / "limits" / f"{name}.json"), reported)


def _module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded by name."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"stkde_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def domain(config: dict, bandwidth):
    """The program's ``Domain`` and the reference's ``Box`` of a query at
    ``bandwidth`` = ``[Hs, Ht]`` in grid cells."""
    from repro_torch.core.geometry import Domain

    hs_cells, ht_cells = bandwidth
    sres, tres = float(config["sres"]), float(config["tres"])
    box = Box(config["Gx"], config["Gy"], config["Gt"], sres, tres,
              hs_cells * sres, ht_cells * tres)
    dom = Domain(gx=box.Gx * sres, gy=box.Gy * sres, gt=box.Gt * tres,
                 sres=sres, tres=tres, hs=box.hs, ht=box.ht)
    if dom.grid_shape != (box.Gx, box.Gy, box.Gt) or (
            dom.Hs, dom.Ht) != (hs_cells, ht_cells):
        raise SystemExit("the program's domain is not the configuration's")
    return dom, box


def domains(cell: Cell) -> list:
    """``(dom, box)`` of each bandwidth of the cell's traffic, in order."""
    return [domain(cell.config, bw) for bw in cell.traffic["bandwidths"]]


def devices(chips: int, device="cuda") -> List[torch.device]:
    """The cell's devices: the first ``chips`` cards, or the CPU."""
    if torch.device(device).type != "cuda":
        return [torch.device(device)] * chips
    return [torch.device("cuda", i) for i in range(chips)]


# ----------------------------------------------------------------- queries
def sync(*devs: torch.device) -> None:
    """Wait for each card of ``devs`` (the CPU needs no wait)."""
    for dev in dict.fromkeys(devs):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def caller(traffic: dict, devs: List[torch.device]) -> Callable:
    """One query as the traffic mix calls the program: ``entry(points,
    dom, **kwargs)``, with ``mesh=`` a ``Mesh`` of the cell's devices where
    the traffic gives one (``{"shape": [...], "axes": [...]}``) and
    ``device=`` its first device otherwise. The answer as a tensor (a
    chunked run's host array too)."""
    module, _, attr = traffic["entry"].rpartition(".")
    if module.split(".")[0] != PROGRAM:
        raise SystemExit(f"entry {traffic['entry']!r} is not in {PROGRAM}")
    entry = getattr(importlib.import_module(module), attr)
    kw = dict(traffic.get("kwargs", {}))
    if traffic.get("mesh"):
        from repro_torch.distributed import Mesh

        m = traffic["mesh"]
        grid = np.empty(len(devs), dtype=object)
        grid[:] = devs
        kw["mesh"] = Mesh(grid.reshape(m["shape"]), m["axes"])
    else:
        kw["device"] = devs[0]

    def run(points, dom):
        out = entry(points, dom, **kw)
        return out if isinstance(out, torch.Tensor) else torch.as_tensor(
            np.asarray(out))
    return run


def fingerprint(grid: torch.Tensor, slab: int = 8) -> torch.Tensor:
    """Float64 sums and largest magnitudes of every ``(x, y)`` column of
    ``grid``, a few x-slabs at a time so that no copy of it is made."""
    parts = []
    for x in range(0, grid.shape[0], slab):
        g = grid[x: x + slab].to(torch.float64)
        parts.append(torch.stack([g.sum(-1), g.abs().amax(-1)]).cpu())
    return torch.cat(parts, dim=1)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest gap of two fingerprints over the largest value of ``b``."""
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


# ------------------------------------------------------------------ record
@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers take their numbers from it."""

    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: Optional[int] = None
    stages: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, list] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None          # devtrace.summarize of the queries
    least: List[dict] = dataclasses.field(default_factory=list)

    def stage_ms(self, name: str) -> Optional[float]:
        s = self.stages.get(name)
        return 1e3 * statistics.median(s) if s else None

    def device_s(self, names) -> Optional[float]:
        """Device seconds per profiled query in kernels whose name holds
        one of ``names``."""
        if self.trace is None:
            return None
        s = sum(v for k, v in self.trace["device_s_by_name"].items()
                if any(n in k for n in names))
        return s / self.trace["queries"] if s > 0 else None

    def least_s(self) -> Optional[float]:
        """Least time of a profiled query, on average."""
        if not self.least or self.trace is None:
            return None
        return statistics.fmean(x["seconds"] for x in self.least)


def reader(name: str) -> Callable[[Record], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    return _module("metrics", name).read


# ---------------------------------------------------------------- the run
def _run_query(run, pts, dom, devs, failures: List[str], q):
    try:
        grid = run(pts, dom)
        sync(*devs)
        return grid
    # a failed query is counted against the attempted ones; the run goes on
    except Exception as e:  # noqa: BLE001
        failures.append(f"query {q}: {type(e).__name__}: {e}")
        return None


def _window(run, inputs, devs, seconds: float, rec: Record,
            failures: List[str]):
    """The closed loop; the number of queries and the last one's answer."""
    q = 0
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        grid = _run_query(run, *inputs(q), devs, failures, q)
        e = time.perf_counter()
        rec.latencies_s.append(e - s)
        if e - t0 >= seconds:
            rec.window_s = e - t0
            return q + 1, grid
        grid = None  # no grid lives into the next query
        q += 1


def _staged(stage, run, inputs, devs, count: int, rec: Record,
            failures: List[str]) -> dict:
    """``count`` staged queries, each followed by a real one of the same
    inputs: the largest gap of their grids' fingerprints and the staged
    time over the real one. Staged metrics are left out where the staged
    query fails or computes another grid."""
    gaps, staged_s, real_s = [], [], []
    try:
        for q in range(count):
            stages: Dict[str, List[float]] = {}
            grid = stage(*inputs(q), devs[0], stages, rec.counters)
            fp = fingerprint(grid)
            grid = None
            staged_s.append(sum(v[0] for v in stages.values()))
            for name, v in stages.items():
                rec.stages.setdefault(name, []).extend(v)
            s = time.perf_counter()
            grid = _run_query(run, *inputs(q), devs, failures, f"staged {q}")
            real_s.append(time.perf_counter() - s)
            if grid is not None:
                gaps.append(_gap(fp, fingerprint(grid)))
            grid = None
    # the staged file copies the program's stages; if they moved, its
    # metrics are left out, and the result line says why
    except Exception as e:  # noqa: BLE001
        out = {"error": f"{type(e).__name__}: {e}"}
    else:
        share = statistics.median(staged_s) / statistics.median(real_s)
        out = {"grid_gap": {"value": max(gaps, default=float("inf")),
                            "limit": STAGED_GAP},
               "time_share": {"value": share, "range": list(STAGED_SHARE)}}
        if out["grid_gap"]["value"] <= STAGED_GAP:
            return out
    rec.stages.clear()
    rec.counters.clear()
    return out


def _profiled(run, inputs, devs, count: int, rec: Record,
              failures: List[str]):
    """``count`` real queries under ``torch.profiler``; the last answer."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if devs[0].type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    grid = None
    with profile(activities=acts) as prof:
        with record_function("stkde_bench.warmup"):
            _run_query(run, *inputs(0), devs, [], "warm-up")
        for q in range(count):
            grid = None  # no grid lives into the next query
            with record_function(devtrace.QUERY):
                grid = _run_query(run, *inputs(q), devs, failures, q)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        rec.trace = devtrace.summarize(_json(path), len(devs))
    return grid


def _card(devs: List[torch.device]) -> dict:
    if devs[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]),
           "count": len(devs)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={devs[0].index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = float(smi.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None) -> dict:
    """One run of ``cell``; the result line as a dict (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    if "host_threads" in cell.config:   # a setting the deployment states
        torch.set_num_threads(int(cell.config["host_threads"]))
    devs = devices(cell.chips, device)
    cuda = devs[0].type == "cuda"
    traffic = cell.traffic
    doms = domains(cell)
    run = caller(traffic, devs)
    sets = point_sets(cell.config, seed, traffic["point_sets"])

    def inputs(q):
        """The points and domain of query ``q``."""
        return sets[q % len(sets)], doms[q % len(doms)][0]

    for q in range(traffic["warmup_queries"]):   # at least one a bandwidth
        run(*inputs(q))
        sync(*devs)
    rec = Record()
    failures: List[str] = []
    card = _card(devs)
    if cuda:
        for dev in devs:
            torch.cuda.reset_peak_memory_stats(dev)
    rec.setup_s = time.perf_counter() - t_start
    staged = None
    attempted, grid = _window(run, inputs, devs, seconds, rec, failures)
    last = attempted - 1
    if trace:
        grid = None  # the last profiled answer is the one checked
        last = traffic["trace_queries"]
        attempted += last
        if traffic.get("staged") and traffic["staged_queries"]:
            staged = _staged(_module("staged", traffic["staged"]).run, run,
                             inputs, devs, traffic["staged_queries"], rec,
                             failures)
            attempted += traffic["staged_queries"]
        grid = _profiled(run, inputs, devs, last, rec, failures)
        last -= 1
    if cuda:
        rec.peak_bytes = max(int(torch.cuda.max_memory_allocated(dev))
                             for dev in devs)
        card["memory_peak_bytes"] = rec.peak_bytes
    if trace and rec.trace is not None:
        card["busy_s"] = rec.trace["busy_s"]
        card["window_s"] = rec.trace["window_s"]
        least = {}
        for q in range(rec.trace["queries"]):
            key = (q % len(sets), q % len(doms))
            if key not in least:
                least[key] = roofline.least_time(
                    sets[key[0]], doms[key[1]][1], card["kind"], devs[0])
            if least[key] is not None:
                rec.least.append(least[key])

    t_check = time.perf_counter()
    worst = float("inf")
    if grid is not None:
        pts, box = sets[last % len(sets)], doms[last % len(doms)][1]
        worst = check.grid_err(check.of_grid(grid), pts, box, devs[0])
    grid = None
    if cuda:
        torch.cuda.empty_cache()
    limit = float(cell.limits["grid_err"])
    correct = not failures and worst <= limit
    check_s = time.perf_counter() - t_check

    metrics = {}
    for m in cell.metrics["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted,
              "failed": len(failures), "metrics": metrics, "device": card}
    if trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    if trace and rec.least:
        result["least_time"] = {k: rec.least[0][k] for k in
                                ("seconds", "bound_by", "support_pairs",
                                 "operations", "bytes")}
    lat = rec.latencies_s
    result["notes"] = {"failures": failures[:5], "check_s": check_s,
                       "checked_query": last,
                       "latency_ms_quartiles": [
                           1e3 * x for x in statistics.quantiles(lat, n=4)]
                       if len(lat) > 1 else None}
    if staged is not None:
        result["staged_check"] = staged
    result["checks"] = {"grid_err": {"value": worst, "limit": limit}}
    return result


def forbidden_modules(names=None) -> List[str]:
    """The top-level names (the part before the first dot, whole) among
    ``names`` (default: ``sys.modules``) that a run may not load."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
