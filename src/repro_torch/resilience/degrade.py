"""Graceful degradation for STKDE queries.

When a query cannot run at full fidelity (OOM, repeated strategy failure,
deadline pressure) we still owe the caller *an* answer: interactive
visualization tolerates a coarser or noisier density far better than a
500. Two degradation axes, applied per level:

  * **coarsen** — recompute on a grid with ``coarsen×`` larger voxels
    (memory and work drop ~coarsen³); error bounded by kernel variation
    across one voxel, ~``coarsen·sres/hs`` relative.
  * **subsample** — recompute on a coreset-style random fraction of the
    points (Zheng et al., 1709.04453); Monte-Carlo relative error
    ~``1/sqrt(n·frac)``.

Every degraded answer is tagged ``degraded=True`` with the level, reason,
and the combined error-bound estimate, and counted in
``resilience.degraded``. The levels, subsets and bounds are the reference
package's (``repro/resilience/degrade.py``): the same seed picks the same
points in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .errors import NonFiniteOutputError, ReproError, is_transient

if TYPE_CHECKING:  # core imports this module: no import of core at run time
    from ..core.geometry import Domain


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """How to walk down fidelity levels on resource failure."""

    coarsen: float = 2.0        # voxel-size multiplier per level (1 = off)
    subsample: float = 0.5      # point fraction kept per level (1 = off)
    max_levels: int = 2
    seed: int = 0


@dataclasses.dataclass
class DegradedResult:
    """An STKDE answer that may have been computed below full fidelity."""

    grid: Any                   # what ``compute`` returned (tensor or array)
    dom: Domain                 # the domain actually computed (may be coarse)
    degraded: bool = False
    level: int = 0
    reason: str = ""
    error_bound: float = 0.0    # relative-error estimate, 0 = exact


def coarsen_domain(dom: Domain, factor: float) -> Domain:
    """Same physical box, ``factor×`` larger voxels."""
    return dom.with_resolution(dom.sres * factor, dom.tres * factor)


def subsample_points(
    points: np.ndarray, frac: float, seed: int = 0
) -> np.ndarray:
    """Deterministic random coreset: keep ``ceil(n*frac)`` points."""
    pts = np.asarray(points)
    n = len(pts)
    keep = max(1, int(math.ceil(n * frac)))
    if keep >= n:
        return pts
    idx = np.random.default_rng(seed).choice(n, size=keep, replace=False)
    return pts[np.sort(idx)]


def error_bound(dom: Domain, n: int, level: int,
                policy: DegradePolicy) -> float:
    """Relative-error estimate for running ``level`` steps down.

    Coarsening contributes kernel variation across the larger voxel
    (~``Δres/hs``); subsampling contributes MC noise (~``1/sqrt(kept)``).
    Both are heuristics for UI display, not guarantees.
    """
    if level <= 0:
        return 0.0
    e_c = 0.0
    if policy.coarsen > 1.0:
        extra = dom.sres * (policy.coarsen**level - 1.0)
        e_c = extra / max(dom.hs, 1e-9)
    e_s = 0.0
    if policy.subsample < 1.0:
        kept = max(1.0, n * policy.subsample**level)
        e_s = 1.0 / math.sqrt(kept)
    return float(math.hypot(e_c, e_s))


def ensure_finite(grid, tag: str = "stkde"):
    """Raise NonFiniteOutputError when the density has NaN/Inf cells
    (counted in ``resilience.nonfinite``); returns ``grid`` unchanged.

    ``grid`` is a tensor or anything numpy takes. A tensor is tested where
    it lives: only one boolean crosses to the host (which waits for the
    device to finish the grid).
    """
    if isinstance(grid, torch.Tensor):
        with obs_trace.span("stkde.finish", device=grid.device):
            finite = torch.isfinite(grid)
            ok, size = bool(finite.all()), grid.numel()
            bad = 0 if ok else int(size - int(finite.sum()))
    else:
        arr = np.asarray(grid)
        finite = np.isfinite(arr)
        ok, size = bool(finite.all()), arr.size
        bad = 0 if ok else int(size - finite.sum())
    if not ok:
        obs_metrics.counter("resilience.nonfinite").inc()
        raise NonFiniteOutputError(
            f"{tag}: {bad}/{size} non-finite cells in output grid"
        )
    return grid


def run_with_degrade(
    compute: Callable[[np.ndarray, Domain], Any],
    points: np.ndarray,
    dom: Domain,
    policy: DegradePolicy = DegradePolicy(),
    tag: str = "stkde",
) -> DegradedResult:
    """Run ``compute(points, dom)``, walking down fidelity on failure.

    Level 0 is full fidelity; each subsequent level coarsens the grid and
    subsamples the points per ``policy``. Output (a tensor or an array) is
    finite-validated at every level. Non-transient failures propagate
    immediately; running out of levels re-raises the last failure.
    """
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    last: Optional[BaseException] = None
    reasons: Sequence[str] = []
    for level in range(policy.max_levels + 1):
        d = dom if level == 0 else coarsen_domain(
            dom, policy.coarsen**level)
        p = pts if level == 0 or policy.subsample >= 1.0 else (
            subsample_points(pts, policy.subsample**level,
                             seed=policy.seed + level)
        )
        try:
            with obs_trace.span(f"resilience.degrade.{tag}", level=level,
                                n=len(p)):
                grid = ensure_finite(compute(p, d), tag)
            if level > 0:
                obs_metrics.counter("resilience.degraded").inc()
            return DegradedResult(
                grid=grid,
                dom=d,
                degraded=level > 0,
                level=level,
                reason=";".join(reasons),
                error_bound=error_bound(dom, n, level, policy),
            )
        except BaseException as e:  # noqa: BLE001 — classified below
            if not (is_transient(e) or isinstance(e, (ReproError,
                                                      ValueError))):
                raise
            last = e
            reasons = list(reasons) + [f"L{level}:{type(e).__name__}"]
    obs_metrics.counter("resilience.gave_up").inc()
    raise last if last is not None else RuntimeError("unreachable")
