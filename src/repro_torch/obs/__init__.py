"""Observability of the port: tracing, metrics, the shared timer.

  trace      nestable spans -> Chrome-trace/Perfetto JSON (optionally
             mirrored into ``torch.profiler.record_function`` ranges)
  metrics    process-global counters / gauges / log-scale histograms
  timing     the one benchmark timer (warmup + waiting for the card)

``trace`` and ``metrics`` are stdlib-only, so any layer of the port can
import them without cycles. The planner reconciliation of the reference
(``reconcile``) is not ported yet.
"""
from . import metrics, timing, trace
from .metrics import counter, gauge, histogram
from .timing import timeit
from .trace import span

__all__ = [
    "trace",
    "metrics",
    "timing",
    "span",
    "timeit",
    "counter",
    "gauge",
    "histogram",
]
