"""Nestable wall-clock tracing with Chrome-trace export.

Every phase worth watching (bucketing, chunked execution, journal writes,
retries) opens a ``span``. Spans nest per thread, carry free-form
attributes, and export to the Chrome trace-event JSON format (load in
``chrome://tracing`` or Perfetto). Optionally each span also mirrors into
``torch.profiler.record_function`` so host spans line up with the device
kernels when a ``torch.profiler`` trace is being captured.

Naming convention: dotted lowercase ``component.subject[.phase]`` — e.g.
``bucketing.overlap``, ``chunk.compute``, ``journal.write``.

Dependency-free: stdlib only; torch is touched lazily and only when
mirroring is enabled.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

_NS_PER_US = 1_000


@dataclasses.dataclass
class Span:
    """One closed (or still-open) traced region."""

    name: str
    start_ns: int                     # relative to the tracer epoch
    duration_ns: Optional[int] = None
    tid: int = 0
    span_id: int = 0
    parent_id: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return 0.0 if self.duration_ns is None else self.duration_ns / 1e9

    def set(self, **attrs) -> "Span":
        """Attach attributes after the span opened (e.g. computed counts)."""
        self.attrs.update(attrs)
        return self

    def to_event(self, pid: int) -> Dict[str, Any]:
        """Chrome trace-event ("X" complete event, microsecond clock)."""
        return {
            "name": self.name,
            "ph": "X",
            "ts": self.start_ns / _NS_PER_US,
            "dur": (self.duration_ns or 0) / _NS_PER_US,
            "pid": pid,
            "tid": self.tid,
            "args": {k: _jsonable(v) for k, v in self.attrs.items()},
        }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class Tracer:
    """Thread-safe span recorder.

    One process-global instance (``get_tracer()``) backs the module-level
    ``span`` helper; independent instances can be created for tests.
    """

    def __init__(self, mirror_profiler: bool = False):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._spans: List[Span] = []
        self._foreign: List[Dict[str, Any]] = []   # ingested child events
        self._next_id = 0
        self.enabled = True
        self.mirror_profiler = mirror_profiler
        self.epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------- spans
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        if not self.enabled:
            yield Span(name=name, start_ns=0)
            return
        with self._lock:
            self._next_id += 1
            sid = self._next_id
        stack = self._stack()
        sp = Span(
            name=name,
            start_ns=time.perf_counter_ns() - self.epoch_ns,
            tid=threading.get_ident(),
            span_id=sid,
            parent_id=stack[-1].span_id if stack else None,
            attrs=dict(attrs),
        )
        stack.append(sp)
        mirror = (self._profiler_annotation(name) if self.mirror_profiler
                  else contextlib.nullcontext())
        try:
            with mirror:
                yield sp
        finally:
            stack.pop()
            sp.duration_ns = (
                time.perf_counter_ns() - self.epoch_ns - sp.start_ns
            )
            with self._lock:
                self._spans.append(sp)

    @staticmethod
    def _profiler_annotation(name: str):
        """A ``torch.profiler.record_function`` range named like the span:
        it shows in a profiler trace beside the kernels it launched."""
        import torch

        return torch.profiler.record_function(name)

    # ----------------------------------------------------------- exports
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Closed spans, optionally filtered by exact name."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def to_chrome_trace(self) -> Dict[str, Any]:
        pid = os.getpid()
        with self._lock:
            events = [s.to_event(pid) for s in self._spans]
            events += [dict(e) for e in self._foreign]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)

    def export_events(self) -> List[Dict[str, Any]]:
        """Chrome events for cross-process merge (see ``ingest``)."""
        return self.to_chrome_trace()["traceEvents"]

    def ingest(self, events: List[Dict[str, Any]],
               pid: Optional[int] = None) -> None:
        """Merge Chrome events produced by another process (e.g. a worker
        rank) into this tracer's timeline."""
        with self._lock:
            for e in events:
                e = dict(e)
                if pid is not None:
                    e["pid"] = pid
                self._foreign.append(e)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._foreign.clear()
            self._next_id = 0
        self.epoch_ns = time.perf_counter_ns()


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, **attrs):
    """Open a span on the process-global tracer (context manager)."""
    return _TRACER.span(name, **attrs)


def set_mirror_profiler(on: bool) -> None:
    """Mirror spans into ``torch.profiler.record_function`` ranges (they
    then appear in a ``torch.profiler`` trace beside the device kernels)."""
    _TRACER.mirror_profiler = on


def save_chrome_trace(path: str) -> None:
    _TRACER.save(path)


def reset() -> None:
    _TRACER.clear()
