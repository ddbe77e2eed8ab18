"""Planner predicted-vs-measured reconciliation.

``core/plan.py`` prices every execution strategy with a three-term model
(init = memset, compute = point work x imbalance, comm = collectives) —
this module closes the loop: it *measures* the same three terms on a live
mesh and joins them against the prediction, per strategy and per term, with
relative errors. It is how ``plan.H100`` is fitted (``run`` on the card,
then ``plan.calibrate_host`` of its rows; the committed rows are the
median of several runs, ``median_reports``).

Measurement protocol (differential timing — the host clock sees a strategy
as a whole):

  init_s     ``torch.full`` of the strategy's per-device grid buffer
  nocomm     the strategy built with collectives stripped
             (``build_*(..., collectives=False)``; DD has none to strip)
  full       the production strategy

  measured.init    = t(init)
  measured.compute = max(t(nocomm) - t(init), 0)
  measured.comm    = max(t(full) - t(nocomm), 0)
  measured.total   = t(full)

All timings flow through ``obs.timing.timeit`` (warmup, and waiting for the
card before the clock is read) and therefore appear as spans in the trace.
Host bucketing (``prepare_*``) is outside all four terms, as in the
reference.

Probe registry
--------------

Every probed strategy is one ``StrategyProbe`` entry in ``PROBED`` — a
declarative spec binding the strategy's prepare/build pair from
``distributed/stkde_dist.py`` to the probe protocol above. The registry is
the single source of truth for what can be reconciled: ``run``'s default
strategy list, ``measure_strategy``'s error message, and
``plan.calibrate_host``'s row filter are all derived from its keys.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import timing, trace

TERMS = ("init_s", "compute_s", "comm_s", "total_s")


def _sd():
    """Lazy import: keep ``repro_torch.obs`` free of the strategies."""
    from ..distributed import stkde_dist

    return stkde_dist


def _axes_all(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _axes_workers(mesh) -> Tuple[str, ...]:
    """The worker (grid-sharding) axes: the *last two* mesh axes.

    On a 3-axis mesh the leading axis stays replicated (2-D strategies)
    or serves as the replication axis (hybrid)."""
    return tuple(mesh.axis_names)[-2:]


def _axes_xyz(mesh) -> Tuple[str, ...]:
    names = tuple(mesh.axis_names)
    if len(names) != 3:
        raise ValueError(
            f"pd_xyt probe needs a 3-axis (x, y, t) mesh, got {names}")
    return names


def _rep_axis(mesh, axes) -> str:
    """First mesh axis not claimed by the worker grid (hybrid's rep)."""
    rest = [a for a in mesh.axis_names if a not in axes]
    if not rest:
        raise ValueError(
            f"hybrid probe needs a rep axis outside the worker axes {axes};"
            f" mesh has only {tuple(mesh.axis_names)}")
    return rest[0]


def _worker_dims(dom, mesh, axes) -> Tuple[int, int]:
    A, B = (mesh.shape[a] for a in axes)
    return _sd()._device_grid_dims(dom, A, B)


@dataclasses.dataclass(frozen=True)
class StrategyProbe:
    """Declarative phase-probe spec for one strategy.

    prepare(pts, dom, mesh, axes, cap) -> (args, ctx)
        Host-side bucketing/layout and the copy to the mesh. ``args`` is
        the positional argument tuple for the built callables; ``ctx``
        carries point-dependent parameters the builders need (DD-LPT's
        tile/k/cap/ntiles) — empty for most strategies.
    build(dom, mesh, axes, n, ctx) -> fn
        The production (collectives-on) strategy.
    build_nocomm(dom, mesh, axes, n, ctx) -> fn, or None
        Same compute with collectives stripped. ``None`` declares the
        strategy communication-free (DD): the full build is reused and
        measured comm is exactly 0.
    local_shape(dom, mesh, axes, ctx) -> tuple
        Per-device grid buffer shape — the memset probe for ``init_s``.
    default_axes(mesh) -> axes
        The mesh axes the strategy spans when the caller passes none.
    plan_shape(mesh, axes) -> mesh_shape
        The shape handed to ``plan.estimate`` so the prediction prices
        the same decomposition the probe measures ((A, B), (R, A, B), or
        pd_xyt's (X, Y, T)).
    """

    prepare: Callable
    build: Callable
    build_nocomm: Optional[Callable]
    local_shape: Callable
    default_axes: Callable
    plan_shape: Callable


def _probe_dr() -> StrategyProbe:
    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            ((_sd().prepare_dr(pts, dom, mesh, axes),), {}),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_dr(dom, mesh, axes, n),
        build_nocomm=lambda dom, mesh, axes, n, ctx:
            _sd().build_dr(dom, mesh, axes, n, collectives=False),
        local_shape=lambda dom, mesh, axes, ctx: dom.grid_shape,
        default_axes=_axes_all,
        plan_shape=lambda mesh, axes:
            (1, int(np.prod([mesh.shape[a] for a in axes]))),
    )


def _probe_dd() -> StrategyProbe:
    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            (_sd().prepare_dd(pts, dom, mesh, axes, cap=cap), {}),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_dd(dom, mesh, axes, n),
        build_nocomm=None,                  # DD is communication-free
        local_shape=lambda dom, mesh, axes, ctx:
            _worker_dims(dom, mesh, axes) + (dom.Gt,),
        default_axes=_axes_workers,
        plan_shape=lambda mesh, axes: tuple(mesh.shape[a] for a in axes),
    )


def _probe_pd() -> StrategyProbe:
    def shape(dom, mesh, axes, ctx):
        gx, gy = _worker_dims(dom, mesh, axes)
        return (gx + 2 * dom.Hs, gy + 2 * dom.Hs, dom.Gt)

    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            (_sd().prepare_pd(pts, dom, mesh, axes, cap=cap), {}),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd(dom, mesh, axes, n),
        build_nocomm=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd(dom, mesh, axes, n, collectives=False),
        local_shape=shape,
        default_axes=_axes_workers,
        plan_shape=lambda mesh, axes: tuple(mesh.shape[a] for a in axes),
    )


def _probe_pd_xt() -> StrategyProbe:
    def shape(dom, mesh, axes, ctx):
        A, B = (mesh.shape[a] for a in axes)
        gx = math.ceil(dom.Gx / A)
        gt = math.ceil(dom.Gt / B)
        return (gx + 2 * dom.Hs, dom.Gy, gt + 2 * dom.Ht)

    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            (_sd().prepare_pd_xt(pts, dom, mesh, axes, cap=cap), {}),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd_xt(dom, mesh, axes, n),
        build_nocomm=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd_xt(dom, mesh, axes, n, collectives=False),
        local_shape=shape,
        default_axes=_axes_workers,
        plan_shape=lambda mesh, axes: tuple(mesh.shape[a] for a in axes),
    )


def _probe_pd_xyt() -> StrategyProbe:
    def shape(dom, mesh, axes, ctx):
        A, B, C = (mesh.shape[a] for a in axes)
        return (
            math.ceil(dom.Gx / A) + 2 * dom.Hs,
            math.ceil(dom.Gy / B) + 2 * dom.Hs,
            math.ceil(dom.Gt / C) + 2 * dom.Ht,
        )

    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            (_sd().prepare_pd_xyt(pts, dom, mesh, axes, cap=cap), {}),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd_xyt(dom, mesh, axes, n),
        build_nocomm=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd_xyt(dom, mesh, axes, n, collectives=False),
        local_shape=shape,
        default_axes=_axes_xyz,
        plan_shape=lambda mesh, axes: tuple(mesh.shape[a] for a in axes),
    )


def _probe_dd_lpt() -> StrategyProbe:
    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            _sd().prepare_dd_lpt(pts, dom, mesh, axes, cap=cap),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_dd_lpt(dom, mesh, axes, n, ctx["tile"], ctx["k"],
                               ctx["cap"], ctx["ntiles"]),
        build_nocomm=lambda dom, mesh, axes, n, ctx:
            _sd().build_dd_lpt(dom, mesh, axes, n, ctx["tile"], ctx["k"],
                               ctx["cap"], ctx["ntiles"],
                               collectives=False),
        local_shape=lambda dom, mesh, axes, ctx: tuple(
            nt * b for nt, b in zip(ctx["ntiles"], ctx["tile"])),
        default_axes=_axes_workers,
        plan_shape=lambda mesh, axes: tuple(mesh.shape[a] for a in axes),
    )


def _probe_hybrid() -> StrategyProbe:
    def shape(dom, mesh, axes, ctx):
        gx, gy = _worker_dims(dom, mesh, axes)
        return (gx + 2 * dom.Hs, gy + 2 * dom.Hs, dom.Gt)

    return StrategyProbe(
        prepare=lambda pts, dom, mesh, axes, cap:
            (_sd().prepare_hybrid(pts, dom, mesh, axes,
                                  rep_axis=_rep_axis(mesh, axes), cap=cap),
             {}),
        build=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd(dom, mesh, axes, n,
                           rep_axis=_rep_axis(mesh, axes)),
        build_nocomm=lambda dom, mesh, axes, n, ctx:
            _sd().build_pd(dom, mesh, axes, n,
                           rep_axis=_rep_axis(mesh, axes),
                           collectives=False),
        local_shape=shape,
        default_axes=_axes_workers,
        plan_shape=lambda mesh, axes:
            (mesh.shape[_rep_axis(mesh, axes)],)
            + tuple(mesh.shape[a] for a in axes),
    )


# strategy name -> phase-probe spec; the full set the planner can be
# reconciled against. Iteration order is report order.
PROBED: Dict[str, StrategyProbe] = {
    "dr": _probe_dr(),
    "dd": _probe_dd(),
    "pd": _probe_pd(),
    "pd_xt": _probe_pd_xt(),
    "pd_xyt": _probe_pd_xyt(),
    "dd_lpt": _probe_dd_lpt(),
    "hybrid": _probe_hybrid(),
}


def measure_strategy(
    points: np.ndarray,
    dom,
    mesh,
    strategy: str,
    axes: Optional[Tuple[str, ...]] = None,
    reps: int = 3,
    cap: Optional[int] = None,
) -> Dict[str, float]:
    """Measured init/compute/comm/total seconds for one strategy.

    ``axes=None`` uses the strategy's ``default_axes`` on the given mesh
    (worker-2D strategies span the last two axes; dr spans all; pd_xyt
    needs exactly three).
    """
    spec = PROBED.get(strategy)
    if spec is None:
        raise ValueError(f"phase probes implemented for {tuple(PROBED)}, "
                         f"got {strategy!r}")
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    if axes is None:
        axes = spec.default_axes(mesh)

    with trace.span(f"reconcile.{strategy}.prepare", n=n):
        args, ctx = spec.prepare(pts, dom, mesh, axes, cap)
        local_shape = spec.local_shape(dom, mesh, axes, ctx)
        full = spec.build(dom, mesh, axes, n, ctx)
        nocomm = (full if spec.build_nocomm is None
                  else spec.build_nocomm(dom, mesh, axes, n, ctx))

    device = mesh.first_device
    t_init = timing.timeit(
        lambda: torch.full(local_shape, 0.0, dtype=torch.float32,
                           device=device), reps=reps,
        name=f"reconcile.{strategy}.init", strategy=strategy).best
    t_nocomm = timing.timeit(
        lambda: nocomm(*args), reps=reps,
        name=f"reconcile.{strategy}.nocomm", strategy=strategy).best
    if nocomm is full:
        t_full = t_nocomm
    else:
        t_full = timing.timeit(
            lambda: full(*args), reps=reps,
            name=f"reconcile.{strategy}.full", strategy=strategy).best
    return {
        "init_s": t_init,
        "compute_s": max(t_nocomm - t_init, 0.0),
        "comm_s": max(t_full - t_nocomm, 0.0),
        "total_s": t_full,
    }


def reconcile(
    predicted: Dict[str, Dict[str, float]],
    measured: Dict[str, Dict[str, float]],
) -> List[Dict]:
    """Join per-strategy predicted and measured cost tables term-by-term.

    Relative error convention: (measured - predicted) / max(predicted, eps)
    — positive means the planner was optimistic for that term.
    """
    rows = []
    for strat in measured:
        pred = predicted.get(strat, {})
        for term in TERMS:
            p = pred.get(term)
            m = measured[strat].get(term)
            if m is None:
                continue
            rel = None
            if p is not None:
                rel = (m - p) / max(abs(p), 1e-12)
            rows.append({
                "strategy": strat,
                "term": term,
                "predicted_s": p,
                "measured_s": m,
                "rel_err": rel,
            })
    return rows


def report_text(rows: List[Dict]) -> str:
    """Fixed-width reconciliation report."""
    lines = [
        f"{'strategy':<10} {'term':<10} {'predicted_s':>12} "
        f"{'measured_s':>12} {'rel_err':>9}",
        "-" * 57,
    ]
    for r in rows:
        p = "-" if r["predicted_s"] is None else f"{r['predicted_s']:.6f}"
        e = "-" if r["rel_err"] is None else f"{r['rel_err']:+.2f}"
        lines.append(
            f"{r['strategy']:<10} {r['term']:<10} {p:>12} "
            f"{r['measured_s']:>12.6f} {e:>9}"
        )
    return "\n".join(lines)


def _hw_name(hw) -> str:
    from ..core import plan

    for name, rec in (("host", plan.HOST), ("host_seed", plan.HOST_SEED),
                      ("h100_seed", plan.H100_SEED)):
        if hw is rec:
            return name
    return "h100" if hw is plan.H100 else "custom"


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def run(
    points: np.ndarray,
    dom,
    mesh,
    strategies: Optional[Sequence[str]] = None,
    axes: Optional[Tuple[str, ...]] = None,
    reps: int = 3,
    hw=None,
) -> Dict:
    """Full reconciliation: plan, measure, join. Returns rows + report.

    ``strategies`` defaults to every registry key; ``axes=None`` lets each
    strategy pick its ``default_axes`` on the mesh (the recommended mode
    on a 3-axis mesh, where dr/pd_xyt/hybrid span different axis sets).
    Predictions are computed per strategy with its ``plan_shape`` so the
    planner prices the same decomposition the probe measures. ``hw=None``
    is ``plan.default_hw`` of the mesh's first device. On a card the
    report names it and its power limit (``nvidia_smi``).
    """
    from ..core import bucketing, plan

    pts = np.asarray(points, dtype=np.float32)
    if strategies is None:
        strategies = tuple(PROBED)
    hw = hw or plan.default_hw(mesh.first_device)

    # block imbalance measured on the worker home-bucket grid; shared by
    # every strategy's prediction (plan.estimate re-partitions per shape)
    wa, wb = _axes_workers(mesh)
    A, B = mesh.shape[wa], mesh.shape[wb]
    gx_loc, gy_loc = _sd()._device_grid_dims(dom, A, B)
    loads = bucketing.bucket_points_home(
        pts, dom, (gx_loc, gy_loc, dom.Gt)
    ).counts.reshape(-1).astype(np.float64)

    mesh_str = "x".join(str(int(mesh.shape[a])) for a in mesh.axis_names)
    predicted: Dict[str, Dict[str, float]] = {}
    measured: Dict[str, Dict[str, float]] = {}
    with trace.span("reconcile.measure", mesh=mesh_str):
        for strat in strategies:
            spec = PROBED.get(strat)
            if spec is None:
                raise ValueError(
                    f"phase probes implemented for {tuple(PROBED)}, "
                    f"got {strat!r}")
            s_axes = axes if axes is not None else spec.default_axes(mesh)
            table = plan.estimate(
                dom, len(pts), spec.plan_shape(mesh, s_axes),
                loads=loads, hw=hw)
            predicted[strat] = table[strat]
            measured[strat] = measure_strategy(
                pts, dom, mesh, strat, axes=s_axes, reps=reps
            )
    rows = reconcile(predicted, measured)
    out = {
        "mesh": mesh_str,
        "n": int(len(pts)),
        "grid": f"{dom.Gx}x{dom.Gy}x{dom.Gt}",
        "hw": _hw_name(hw),
        "rows": rows,
        "report": report_text(rows),
    }
    if mesh.first_device.type == "cuda":
        out["nvidia_smi"] = nvidia_smi()
    return out


def median_reports(runs: Sequence[List[Dict]]) -> List[Dict]:
    """Several runs of the same probes as one list of reports: ``runs``
    each a list of ``run``'s reports in the same order; each row's
    measured seconds become the median over the runs, with its relative
    error and the report text again, and ``median_of`` the number of
    runs. Raises if the runs' reports do not hold the same rows and
    predictions."""
    out = []
    for reps in zip(*runs):
        first = reps[0]

        def key(rep):
            return rep["mesh"], [(r["strategy"], r["term"], r["predicted_s"])
                                 for r in rep["rows"]]

        if any(key(rep) != key(first) for rep in reps[1:]):
            raise ValueError("the runs' reports do not hold the same rows")
        rows = []
        for i, r in enumerate(first["rows"]):
            m = float(np.median([rep["rows"][i]["measured_s"]
                                 for rep in reps]))
            p = r["predicted_s"]
            rows.append({**r, "measured_s": m, "rel_err": None if p is None
                         else (m - p) / max(abs(p), 1e-12)})
        out.append({**first, "rows": rows, "report": report_text(rows),
                    "median_of": len(reps)})
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The median (``median_reports``) of the ``planner_reconcile`` reports
    in ``chip_smoke.py`` output logs, as JSON on standard output: how
    ``results/torch/reconcile_h100.json`` is made, with ``PYTHONPATH=src
    python -c 'from repro_torch.obs import reconcile; reconcile.main()'
    LOG [LOG ...]``."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("logs", nargs="+")
    args = ap.parse_args(argv)
    runs = []
    for path in args.logs:
        with open(path) as f:
            for line in f:
                if '"planner_reconcile"' in line:
                    runs.append(json.loads(line)["reports"])
    if not runs:
        raise SystemExit("no planner_reconcile line in the logs")
    json.dump(median_reports(runs), sys.stdout, indent=1)
    sys.stdout.write("\n")
