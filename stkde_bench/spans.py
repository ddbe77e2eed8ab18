"""The program's own spans of a traced run's profiled queries, by query.

The port's tracer (``repro_torch.obs.trace``) records while a
``torch.profiler`` session records, so after a traced run it holds the
spans of the profiled block alone, the warm-up query among them. Each
span of one ``stkde()`` call carries the ``query`` id of its
``stkde.query`` span; ``per_query`` groups them by it, asks a reader's
function for one value a query, and gives the median. A query that lacks
what the function reads adds no value; a run without a device trace (a CPU
run), or a program without these spans, gives nothing.
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

QUERY = "stkde.query"

Spans = Dict[str, list]       # span name -> the query's spans of that name


def program_spans() -> list:
    """Every span the port's tracer holds (device times resolved)."""
    from repro_torch.obs import trace

    return trace.get_tracer().spans()


def queries(spans) -> List[Spans]:
    """The spans of each query, in the order the queries began."""
    by_query: Dict[int, Spans] = {}
    for sp in spans:
        q = getattr(sp, "query", None)
        if q is not None:
            by_query.setdefault(q, {}).setdefault(sp.name, []).append(sp)
    return [by_query[q] for q in sorted(by_query) if QUERY in by_query[q]]


def values(rec, value: Callable[[Spans], Optional[float]]) -> List[float]:
    """``value`` of each query that has what it reads; none without a
    device trace."""
    if rec.trace is None:
        return []
    out = (value(q) for q in queries(program_spans()))
    return [v for v in out if v is not None]


def per_query(rec, value: Callable[[Spans], Optional[float]]
              ) -> Optional[float]:
    """The median over queries of ``value``."""
    vals = values(rec, value)
    return statistics.median(vals) if vals else None


def device_ms(*names: str, optional=()) -> Callable[[Spans], Optional[float]]:
    """The card time of the spans ``names`` (each present, each timed) and
    of those of ``optional`` that the query has, summed."""
    def value(q: Spans) -> Optional[float]:
        if not all(n in q for n in names):
            return None
        ms = [getattr(sp, "device_ms", None) for n in (*names, *optional)
              for sp in q.get(n, [])]
        return None if None in ms else sum(ms)
    return value


def host_ms(name: str) -> Callable[[Spans], Optional[float]]:
    """The host time of the spans ``name``, summed."""
    def value(q: Spans) -> Optional[float]:
        if name not in q:
            return None
        return sum(sp.duration_ns for sp in q[name]) / 1e6
    return value


def attr(name: str, key: str) -> Callable[[Spans], Optional[float]]:
    """The attribute ``key`` of the spans ``name``, summed."""
    def value(q: Spans) -> Optional[float]:
        got = [sp.attrs.get(key) for sp in q.get(name, [])]
        return sum(got) if got and None not in got else None
    return value
