"""Load-aware placement — the SPMD incarnation of PB-SYM-PD-SCHED.

The paper shortens the critical path by coloring heavy subdomains first so
the OpenMP scheduler starts them early. An SPMD mesh has no dynamic
scheduler: the equivalent freedom is *which device owns which work*. LPT
(Longest Processing Time first) greedy assignment of tile loads to devices
minimizes makespan the same way the paper's heaviest-first coloring does —
Graham's bound applies to both.

Host-side numpy, the same as the reference package's
``distributed/partition.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Assignment:
    device_of_tile: np.ndarray   # (ntiles,) int
    tiles_of_device: list        # P lists of tile ids
    makespan: float
    total: float

    @property
    def imbalance(self) -> float:
        """makespan / perfect-balance ratio (1.0 = perfect)."""
        P = len(self.tiles_of_device)
        ideal = self.total / P if P else 0.0
        return self.makespan / ideal if ideal > 0 else 1.0


def lpt_assign(loads: np.ndarray, P: int) -> Assignment:
    """Greedy LPT: heaviest tile to least-loaded device."""
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    order = np.argsort(-loads, kind="stable")
    heap = [(0.0, p) for p in range(P)]
    heapq.heapify(heap)
    device_of = np.zeros(loads.size, dtype=np.int64)
    tiles_of = [[] for _ in range(P)]
    for t in order:
        w, p = heapq.heappop(heap)
        device_of[t] = p
        tiles_of[p].append(int(t))
        heapq.heappush(heap, (w + loads[t], p))
    per_dev = np.zeros(P)
    np.add.at(per_dev, device_of, loads)
    return Assignment(
        device_of_tile=device_of,
        tiles_of_device=tiles_of,
        makespan=float(per_dev.max()) if P else 0.0,
        total=float(loads.sum()),
    )


def block_assign(ntiles: Tuple[int, int, int], P: int) -> Assignment:
    """Naive contiguous-block assignment (the unscheduled baseline)."""
    n = int(np.prod(ntiles))
    device_of = (np.arange(n) * P) // n
    tiles_of = [list(np.where(device_of == p)[0]) for p in range(P)]
    return Assignment(device_of, tiles_of, float("nan"), float("nan"))


def imbalance_stats(loads: np.ndarray, P: int) -> dict:
    """Compare naive block split vs LPT for reporting/benchmarks."""
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    total = loads.sum()
    ideal = total / P
    # block split
    n = loads.size
    dev = (np.arange(n) * P) // n
    per_block = np.zeros(P)
    np.add.at(per_block, dev, loads)
    a = lpt_assign(loads, P)
    return {
        "ideal": ideal,
        "block_makespan": float(per_block.max()),
        "lpt_makespan": a.makespan,
        "block_imbalance": float(per_block.max() / ideal) if ideal else 1.0,
        "lpt_imbalance": a.imbalance,
    }


def split_counts_round_robin(counts: np.ndarray, R: int) -> np.ndarray:
    """Split per-bucket point counts as evenly as possible over R replicas.

    Returns (R, *counts.shape): replica r gets ceil/floor shares such that
    the sum over r equals the original counts (used by the hybrid/REP
    strategy to deal a bucket's points across the replica mesh axis).
    """
    counts = np.asarray(counts)
    base = counts // R
    rem = counts % R
    out = np.broadcast_to(base, (R,) + counts.shape).copy()
    r_idx = np.arange(R).reshape((R,) + (1,) * counts.ndim)
    out += (r_idx < rem).astype(counts.dtype)
    return out
