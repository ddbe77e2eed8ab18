"""Process-global metrics: counters, gauges, log-scale histograms.

The numeric companion to ``obs.trace``: spans answer "when / how long was
this one call", metrics aggregate across calls — request counts, tokens/s,
step-time percentiles. Histograms use logarithmic buckets so one instrument
covers microseconds to minutes with bounded memory and ~4% relative
resolution on the reported p50/p95/p99.

Dependency-free (stdlib only). JSON export shape::

    {"counters": {name: value},
     "gauges":   {name: value},
     "histograms": {name: {count, sum, min, max, mean, p50, p95, p99}}}
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Dict, List, Optional

# log-scale bucket layout: bucket i covers [BASE**i, BASE**(i+1))
_BASE = 1.08
_LOG_BASE = math.log(_BASE)
# value range 1e-9 .. 1e9 (seconds-scale friendly); clamped outside
_MIN_EXP = math.floor(math.log(1e-9) / _LOG_BASE)
_MAX_EXP = math.ceil(math.log(1e9) / _LOG_BASE)
_N_BUCKETS = _MAX_EXP - _MIN_EXP + 1


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    def __init__(self):
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Log-bucketed histogram of positive values (p50/p95/p99 summaries).

    Non-positive observations land in a dedicated underflow bucket and are
    reported through min/count but not the percentiles.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @staticmethod
    def _bucket_of(v: float) -> int:
        if v <= 0:
            return _MIN_EXP - 1                       # underflow bucket
        i = math.floor(math.log(v) / _LOG_BASE)
        return max(_MIN_EXP, min(_MAX_EXP, i))

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            b = self._bucket_of(v)
            self._buckets[b] = self._buckets.get(b, 0) + 1

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) from the bucket counts."""
        with self._lock:
            if self.count == 0:
                return float("nan")
            target = q * self.count
            seen = 0.0
            for b in sorted(self._buckets):
                seen += self._buckets[b]
                if seen >= target:
                    if b < _MIN_EXP:                  # underflow bucket
                        return self.min if self.min is not None else 0.0
                    # geometric midpoint of the bucket, clamped to observed
                    mid = math.exp((b + 0.5) * _LOG_BASE)
                    lo = self.min if self.min is not None else mid
                    hi = self.max if self.max is not None else mid
                    return min(max(mid, lo), hi)
            return self.max if self.max is not None else float("nan")

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.min is not None else float("nan"),
            "max": self.max if self.max is not None else float("nan"),
            "mean": self.sum / self.count if self.count else float("nan"),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def _merge_summary(self, s: Dict[str, float]) -> None:
        """Coarse merge of an exported summary (cross-process ingest):
        count/sum/min/max merge exactly; the midpoint stands in for the
        child's percentile mass."""
        with self._lock:
            n = int(s.get("count", 0))
            if n == 0:
                return
            self.count += n
            self.sum += s.get("sum", 0.0)
            for k, pick in (("min", min), ("max", max)):
                v = s.get(k)
                if v is not None and not math.isnan(v):
                    cur = getattr(self, k)
                    setattr(self, k, v if cur is None else pick(cur, v))
            mid = s.get("p50", s.get("mean", 0.0))
            b = self._bucket_of(mid if mid and not math.isnan(mid) else 0.0)
            self._buckets[b] = self._buckets.get(b, 0) + n


class Registry:
    """Name -> instrument map; instruments are created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table, name, factory):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                inst = table[name] = factory()
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    # ----------------------------------------------------------- exports
    def to_dict(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {
                    k: h.summary() for k, h in self._histograms.items()
                },
            }

    def save_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=float)

    def merge(self, exported: Dict[str, Dict]) -> None:
        """Fold another registry's ``to_dict()`` output into this one."""
        for k, v in exported.get("counters", {}).items():
            self.counter(k).inc(v)
        for k, v in exported.get("gauges", {}).items():
            self.gauge(k).set(v)
        for k, s in exported.get("histograms", {}).items():
            self.histogram(k)._merge_summary(s)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def names(self) -> List[str]:
        with self._lock:
            return sorted(
                set(self._counters) | set(self._gauges)
                | set(self._histograms)
            )


_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)


def export() -> Dict[str, Dict]:
    return _REGISTRY.to_dict()


def save_json(path: str) -> None:
    _REGISTRY.save_json(path)


def reset() -> None:
    _REGISTRY.reset()
