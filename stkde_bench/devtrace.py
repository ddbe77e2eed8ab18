"""What a ``torch.profiler`` trace of real queries says about the device.

The harness profiles a few real ``stkde()`` queries, each inside a
``record_function(QUERY)`` annotation, and exports the trace as Chrome JSON.
``summarize`` reads that JSON: the window runs from the first annotated
query's start to the last one's end; device work is every kernel, copy and
memset in it (clipped to the window), and ``busy_s`` is the length of their
union. Idle gaps are labelled with the innermost host event that was running
at their midpoint, or where none was, with the host events on either side.
Without a device event in the window (a CPU run) there is
no device summary.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

QUERY = "stkde_bench.query"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "python_function"}
NAME_CHARS = 160          # names in the breakdown are cut to this length
LABELLED_GAPS = 200       # the longest gaps labelled one by one


def _union(intervals: List[tuple]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top(d: Dict[str, float], k: int = 10) -> List[list]:
    return [[name[:NAME_CHARS], seconds] for name, seconds in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def _label(host: list, hs: np.ndarray, he: np.ndarray, mid: float) -> str:
    """The innermost host event running at ``mid``; where none runs (host
    Python or numpy, which the profiler does not record), the host events
    just before and just after."""
    if not host:
        return "host, no profiled op"
    inside = np.flatnonzero((hs <= mid) & (he >= mid))
    if len(inside):
        return host[int(inside[np.argmin((he - hs)[inside])])]["name"]
    before = np.flatnonzero(he < mid)
    after = np.flatnonzero(hs > mid)
    prev = host[int(before[np.argmax(he[before])])]["name"] if len(
        before) else "start"
    nxt = host[int(after[np.argmin(hs[after])])]["name"] if len(
        after) else "end"
    return f"host between {prev} and {nxt}"


def summarize(trace: dict, devices: int = 1) -> Optional[dict]:
    """Device time by name, busy and idle seconds, idle by host activity,
    over the annotated queries of a Chrome trace (``traceEvents``). Busy
    time is each device's union, averaged over the ``devices`` of the run;
    idle gaps are those of the union over all of them."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    queries = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == QUERY]
    if not queries:
        return None
    w0 = min(float(e["ts"]) for e in queries)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in queries)
    by_name: Dict[str, float] = defaultdict(float)
    busy = []
    per_device: Dict[object, list] = defaultdict(list)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t > s:
            by_name[e["name"]] += (t - s) / 1e6
            busy.append((s, t))
            per_device[e.get("args", {}).get("device", 0)].append((s, t))
    if not busy:
        return None
    merged = _union(busy)
    busy_us = sum(e - s for iv in per_device.values()
                  for s, e in _union(iv)) / max(devices, len(per_device))
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    idle: Dict[str, float] = defaultdict(float)
    for s, t in gaps[:LABELLED_GAPS]:
        idle[_label(host, hs, he, 0.5 * (s + t))] += (t - s) / 1e6
    rest = gaps[LABELLED_GAPS:]
    if rest:
        idle[f"{len(rest)} shorter gaps"] += sum(t - s for s, t in rest) / 1e6
    return {
        "queries": len(queries),
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_s_by_name": dict(by_name),
        "device_ops": _top(by_name),
        "idle_gaps": _top(idle),
    }
