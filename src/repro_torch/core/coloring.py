"""Stencil-graph coloring and critical-path machinery (paper §5.2).

On a shared-memory machine the paper turns subdomain dependencies (27-point
stencil) into a colored task DAG and schedules it with OpenMP tasks. A mesh
of shards has no dynamic task scheduler, so in this framework the
*placement* (``distributed/partition.py`` LPT) absorbs the load-balancing
role. This module keeps the paper's analysis machinery:

  * ``naive_coloring``     — the 8-color (2x2x2 parity) scheme of PB-SYM-PD
  * ``load_aware_coloring``— greedy, heaviest-subdomain-first (PB-SYM-PD-SCHED)
  * ``critical_path``      — T_inf of the implied DAG; with T_1 it gives
                             Graham's bound  T_P <= (T_1 - T_inf)/P + T_inf
  * ``simulate_schedule``  — list-scheduling simulation of the colored DAG on
                             P workers (reproduces the paper's Fig. 11-13
                             speedup story without OpenMP)
  * ``replicate_critical`` — PB-SYM-PD-REP's transformation: split tasks on
                             the critical path until T_inf <= T_1 / (2P)

All functions are host-side numpy (planning/analysis, not accelerator work),
the same as the reference package's ``core/coloring.py``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np


Shape3 = Tuple[int, int, int]


def _neighbors(shape: Shape3):
    """Yield (flat_id, [flat neighbor ids]) for the 27-point stencil."""
    nx, ny, nz = shape
    strides = (ny * nz, nz, 1)

    def flat(i, j, k):
        return i * strides[0] + j * strides[1] + k

    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                nbrs = []
                for di in (-1, 0, 1):
                    for dj in (-1, 0, 1):
                        for dk in (-1, 0, 1):
                            if di == dj == dk == 0:
                                continue
                            a, b, c = i + di, j + dj, k + dk
                            if 0 <= a < nx and 0 <= b < ny and 0 <= c < nz:
                                nbrs.append(flat(a, b, c))
                yield flat(i, j, k), nbrs


def naive_coloring(shape: Shape3) -> np.ndarray:
    """8-color parity scheme: color = (i&1)<<2 | (j&1)<<1 | (k&1)."""
    nx, ny, nz = shape
    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    return ((i & 1) << 2 | (j & 1) << 1 | (k & 1)).reshape(-1)


def load_aware_coloring(shape: Shape3, loads: np.ndarray) -> np.ndarray:
    """Greedy coloring, vertices in non-increasing load order (PD-SCHED)."""
    loads = np.asarray(loads).reshape(-1)
    n = loads.size
    adj: Dict[int, List[int]] = dict(_neighbors(shape))
    order = np.argsort(-loads, kind="stable")
    colors = np.full(n, -1, dtype=np.int64)
    for v in order:
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _dag_edges(shape: Shape3, colors: np.ndarray):
    """Stencil edges oriented low color -> high color."""
    for v, nbrs in _neighbors(shape):
        for u in nbrs:
            if colors[u] < colors[v] or (colors[u] == colors[v] and u < v):
                yield u, v


def critical_path(shape: Shape3, colors: np.ndarray,
                  loads: np.ndarray) -> float:
    """T_inf: longest weighted chain of the color-oriented DAG."""
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    n = loads.size
    # topological order: by (color, id) — valid since edges go low->high
    order = np.lexsort((np.arange(n), colors))
    cp = loads.copy()
    preds: Dict[int, List[int]] = {v: [] for v in range(n)}
    for u, v in _dag_edges(shape, colors):
        preds[v].append(u)
    for v in order:
        if preds[v]:
            cp[v] = loads[v] + max(cp[u] for u in preds[v])
    return float(cp.max()) if n else 0.0


def simulate_schedule(shape: Shape3, colors: np.ndarray, loads: np.ndarray,
                      P: int) -> float:
    """Greedy list-scheduling makespan of the colored DAG on P workers."""
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    n = loads.size
    indeg = np.zeros(n, dtype=np.int64)
    succs: Dict[int, List[int]] = {v: [] for v in range(n)}
    for u, v in _dag_edges(shape, colors):
        succs[u].append(v)
        indeg[v] += 1
    # ready queue ordered by color then heaviest-first (the paper's policy)
    ready = [(colors[v], -loads[v], v) for v in range(n) if indeg[v] == 0]
    heapq.heapify(ready)
    workers = [0.0] * P  # next-free times
    finish = np.zeros(n, dtype=np.float64)
    release = {v: 0.0 for v in range(n) if indeg[v] == 0}
    done = 0
    while ready:
        _, _, v = heapq.heappop(ready)
        w = min(range(P), key=lambda i: workers[i])
        start = max(workers[w], release[v])
        finish[v] = start + loads[v]
        workers[w] = finish[v]
        done += 1
        for s in succs[v]:
            indeg[s] -= 1
            release[s] = max(release.get(s, 0.0), finish[v])
            if indeg[s] == 0:
                heapq.heappush(ready, (colors[s], -loads[s], s))
    assert done == n, "cycle in colored DAG"
    return float(finish.max()) if n else 0.0


def replicate_critical(shape: Shape3, colors: np.ndarray, loads: np.ndarray,
                       P: int, max_rounds: int = 64):
    """PB-SYM-PD-REP: split critical-path tasks until T_inf <= T_1 / (2P).

    Returns (effective_loads, replication) where ``replication[v]`` is the
    number of ways task v was split (its points are processed by that many
    workers; the merge cost is accounted as one extra unit of its shard).
    """
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    T1 = loads.sum()
    rep = np.ones(loads.size, dtype=np.int64)
    eff = loads.copy()
    for _ in range(max_rounds):
        tinf = critical_path(shape, colors, eff)
        if tinf <= T1 / (2 * P) or tinf <= 0:
            break
        # find tasks on (near) the critical chain: greedy — heaviest first
        v = int(np.argmax(eff))
        rep[v] += 1
        eff[v] = loads[v] / rep[v] * (1.0 + 0.1)  # shard + merge overhead
    return eff, rep


def graham_bound(T1: float, Tinf: float, P: int) -> float:
    return (T1 - Tinf) / P + Tinf
