"""Observability of the port: tracing, metrics, the shared timer.

  trace      nestable spans of the stages, off until ``trace.enable()`` or
             a ``torch.profiler`` session: host and card time, host syncs,
             ``torch.profiler`` ranges, Chrome-trace/Perfetto JSON
  metrics    process-global counters / gauges / log-scale histograms
  timing     the one benchmark timer (warmup + waiting for the card)
  reconcile  the planner's predicted terms joined with measured ones, per
             strategy (``run``); the rows ``plan.calibrate_host`` fits

``trace`` (torch and the standard library) and ``metrics`` (the standard
library) import nothing of the port, so any layer of it can import them
without cycles; ``reconcile`` imports the planner and the strategies only
when it runs.
"""
from . import metrics, reconcile, timing, trace
from .metrics import counter, gauge, histogram
from .timing import timeit
from .trace import span

__all__ = [
    "trace",
    "metrics",
    "timing",
    "reconcile",
    "span",
    "timeit",
    "counter",
    "gauge",
    "histogram",
]
