"""Nestable spans of the port's stages, on the host clock and the card's.

Off by default. A span records only after ``enable()`` (an operator asking
for a trace) or while a ``torch.profiler`` session records; otherwise
``span()`` costs one check and hands back one shared span that records
nothing (``recording`` False): no allocation, no lock, no id. Attributes
that cost work to compute are set only where ``sp.recording`` holds.

A recording span holds its name, its host start and duration
(``perf_counter_ns``), its parent, the ``query`` id of the query span it
lies in, and free-form attributes. It always opens a
``torch.profiler.record_function`` range of its name, so that a profiler
trace shows it, on the profiler's clock, around the kernels it launched.
Given ``device=`` a CUDA device, it records a CUDA event on that device's
current stream at its open and another at its close; they are resolved to
``device_ms`` only when the spans are read, so nothing synchronises where
the span is. ``device_ms`` is the stream's time from reaching the open to
reaching the close: siblings partition the stream's timeline, and a host
stage entered with the stream drained reads the card idle time it causes.

A query span (``query=True``) starts a ``query`` id that every span inside
it shares, and counts host syncs: on a CUDA device it turns
``torch.cuda.set_sync_debug_mode("warn")`` on until it closes. Each
synchronising-op warning is counted, not shown, against the innermost open
span of its thread, as that span's ``syncs`` attribute; ``count_sync()``
counts a wait the mode does not see, such as an explicit
``torch.cuda.synchronize``, in or out of a query. Every span of a query
carries ``syncs``, and the query span ``syncs_total``, the query's sum.

Spans stay in memory until ``reset()``, at most ``max_spans`` of them: the
oldest are dropped first and ``dropped`` counts them. They export to the
Chrome trace-event JSON format (``chrome://tracing``, Perfetto).

Naming convention: dotted lowercase ``component.subject[.phase]`` — e.g.
``bucketing.overlap``, ``chunk.compute``, ``stkde.tile.plan``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
import types
import warnings
from typing import Any, Dict, List, Optional

import torch

_NS_PER_US = 1_000
MAX_SPANS = 50_000
# the text of torch's warning in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded (or still open) region."""

    name: str
    start_ns: int = 0                 # relative to the tracer epoch
    duration_ns: Optional[int] = None
    tid: int = 0
    span_id: int = 0
    parent_id: Optional[int] = None
    query: Optional[int] = None       # span_id of the query span it lies in
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    # (start, end) CUDA events until the span is read
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    recording = True

    @property
    def duration_s(self) -> float:
        return 0.0 if self.duration_ns is None else self.duration_ns / 1e9

    def set(self, **attrs) -> "Span":
        """Attach attributes after the span opened (e.g. computed counts)."""
        self.attrs.update(attrs)
        return self

    def _resolve(self) -> None:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None

    def to_event(self, pid: int) -> Dict[str, Any]:
        """Chrome trace-event ("X" complete event, microsecond clock)."""
        args = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.query is not None:
            args["query"] = self.query
        if self.device_ms is not None:
            args["device_ms"] = self.device_ms
        return {
            "name": self.name,
            "ph": "X",
            "ts": self.start_ns / _NS_PER_US,
            "dur": (self.duration_ns or 0) / _NS_PER_US,
            "pid": pid,
            "tid": self.tid,
            "args": args,
        }


class _Off:
    """What ``span()`` hands back while the tracer records nothing: one
    shared object, read-only, that ignores what it is given."""

    recording = False
    attrs = types.MappingProxyType({})

    def set(self, **attrs) -> "_Off":
        return self

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class _Open:
    """A span while it is open: its profiler range, its first CUDA event,
    the query span it counts its syncs into, and those syncs."""

    def __init__(self, tracer: "Tracer", sp: Span, device, query: bool):
        self.tracer, self.span = tracer, sp
        self.device, self.opens_query = device, query
        self.syncs = self.total = 0

    def __enter__(self) -> Span:
        tr, sp = self.tracer, self.span
        # the clocks start first and stop last: a span's own cost lies
        # inside it, so that siblings partition their parent's time
        sp.start_ns = time.perf_counter_ns() - tr.epoch_ns
        self.stream = self.start = None
        if (self.device is not None
                and torch.device(self.device).type == "cuda"):
            self.stream = torch.cuda.current_stream(self.device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        stack = tr._stack()
        parent = stack[-1] if stack else None
        with tr._lock:
            tr._next_id += 1
            sp.span_id = tr._next_id
        sp.tid = threading.get_ident()
        sp.parent_id = parent.span.span_id if parent else None
        self.root = self if self.opens_query else (
            parent.root if parent else None)
        sp.query = self.root.span.span_id if self.root else None
        self.range = torch.profiler.record_function(sp.name)
        self.range.__enter__()
        if self.opens_query:
            self.watch = _SyncWatch(tr, self.start is not None)
            self.watch.__enter__()
        stack.append(self)
        return sp

    def __exit__(self, *exc) -> None:
        tr, sp = self.tracer, self.span
        tr._stack().pop()
        if self.root is not None or self.syncs:
            sp.attrs["syncs"] = self.syncs
        if self.root is not None:
            self.root.total += self.syncs
        if self.opens_query:
            sp.attrs["syncs_total"] = self.total
            self.watch.__exit__()
        self.range.__exit__(None, None, None)
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            sp._events = (self.start, end)
        sp.duration_ns = time.perf_counter_ns() - tr.epoch_ns - sp.start_ns
        tr._keep(sp)


class Tracer:
    """Thread-safe span recorder.

    One process-global instance (``get_tracer()``) backs the module-level
    helpers; independent instances can be created for tests.
    """

    def __init__(self, max_spans: int = MAX_SPANS):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self._next_id = 0
        self.dropped = 0
        self.enabled = False
        self.epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------- spans
    def _stack(self) -> List[_Open]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, device=None, query: bool = False, **attrs):
        """A span named ``name`` (a context manager that gives the
        ``Span``); ``device`` gives it a ``device_ms`` where it is a CUDA
        device, ``query=True`` makes it a query span."""
        if not (self.enabled or torch.autograd._profiler_enabled()):
            return OFF
        return _Open(self, Span(name=name, attrs=attrs), device, query)

    def _keep(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)

    def count_sync(self, n: int = 1) -> None:
        """Count ``n`` host waits against this thread's innermost open span
        (nothing while no span is open)."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1].syncs += n

    # ----------------------------------------------------------- exports
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Recorded spans, optionally filtered by exact name. Device times
        are resolved here: reading a span waits for the card to reach its
        close."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        for s in out:
            s._resolve()
        return out

    def to_chrome_trace(self) -> Dict[str, Any]:
        pid = os.getpid()
        events = [s.to_event(pid) for s in self.spans()]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._next_id = 0
            self.dropped = 0
        self.epoch_ns = time.perf_counter_ns()


class _SyncWatch:
    """For the length of a query span: torch's sync debug mode at "warn" (on
    a CUDA device), and its warnings counted against the innermost open
    span instead of shown. Other warnings pass on as before."""

    def __init__(self, tracer: Tracer, cuda: bool):
        self.tracer, self.cuda = tracer, cuda

    def __enter__(self) -> None:
        self.caught = warnings.catch_warnings()
        self.caught.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.show = warnings.showwarning
        warnings.showwarning = self._on_warning
        if self.cuda:
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def __exit__(self) -> None:
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.caught.__exit__(None, None, None)

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None) -> None:
        if str(message).startswith(SYNC_WARNING):
            self.tracer.count_sync()
        else:
            self.show(message, category, filename, lineno, file, line)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, device=None, query: bool = False, **attrs):
    """Open a span on the process-global tracer (context manager)."""
    return _TRACER.span(name, device=device, query=query, **attrs)


def enable(on: bool = True) -> None:
    """Record spans on the process-global tracer (``enable(False)``: only
    while a ``torch.profiler`` session records, the default)."""
    _TRACER.enabled = on


def count_sync(n: int = 1) -> None:
    """Count a host wait that torch's sync debug mode does not see."""
    _TRACER.count_sync(n)


def save_chrome_trace(path: str) -> None:
    _TRACER.save(path)


def reset() -> None:
    _TRACER.clear()
