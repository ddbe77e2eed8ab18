"""Synthetic datasets matching the paper's four real-world datasets.

The paper's data (Dengue surveillance, PollenUS tweets, avian Flu records,
eBird sightings) is not redistributable; we generate clustered spatiotemporal
point processes with the same instance parameters (n, grid, bandwidths —
paper Table 2). Cluster structure matters: the paper's load-imbalance story
(PD-SCHED/REP) only exists because real events cluster; our generator mixes
dense Gaussian clusters with a uniform background and a seasonal temporal
cycle to reproduce that skew.

Table-2 cells that are garbled in the source text are reconstructed from the
paper's own consistency relations (resolution doubling doubles H; runtimes
scale with Hs^2*Ht) and flagged ``approx=True``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from .geometry import Domain


@dataclasses.dataclass(frozen=True)
class STKDEInstance:
    name: str
    n: int
    Gx: int
    Gy: int
    Gt: int
    Hs: int
    Ht: int
    clusters: int = 24
    cluster_frac: float = 0.8
    seed: int = 0
    approx: bool = False  # True where Table 2 was OCR-garbled

    # ------------------------------------------------------------------ api
    def domain(self) -> Domain:
        """Unit-resolution domain: voxel == domain unit, hs == Hs exactly."""
        return Domain(
            gx=float(self.Gx), gy=float(self.Gy), gt=float(self.Gt),
            sres=1.0, tres=1.0, hs=float(self.Hs), ht=float(self.Ht),
        )

    def points(self, n: Optional[int] = None) -> np.ndarray:
        n = self.n if n is None else min(n, self.n)
        return clustered_events(
            n, self.domain(), seed=self.seed, n_clusters=self.clusters,
            cluster_frac=self.cluster_frac,
        )

    def scaled(self, max_voxels: int = 2_000_000,
               max_points: int = 50_000) -> "STKDEInstance":
        """Shrink grid/points for CPU benchmarking, keeping the work profile.

        Bandwidths (in voxels) are preserved so the per-point cylinder cost —
        the quantity the paper's algorithms differ on — is unchanged; grid
        dims shrink isotropically, clamped to hold at least one cylinder.
        """
        vox = self.Gx * self.Gy * self.Gt
        f = min(1.0, (max_voxels / vox) ** (1.0 / 3.0))
        gx = max(2 * self.Hs + 2, int(self.Gx * f))
        gy = max(2 * self.Hs + 2, int(self.Gy * f))
        gt = max(2 * self.Ht + 2, int(self.Gt * f))
        return dataclasses.replace(
            self, n=min(self.n, max_points), Gx=gx, Gy=gy, Gt=gt,
            name=self.name + "_scaled",
        )

    @property
    def grid_mbytes(self) -> float:
        return self.Gx * self.Gy * self.Gt * 4 / 2**20


def clustered_events(
    n: int,
    dom: Domain,
    seed: int = 0,
    n_clusters: int = 24,
    cluster_frac: float = 0.8,
) -> np.ndarray:
    """Clustered space-time point process inside the domain box."""
    rng = np.random.default_rng(seed)
    n_c = int(n * cluster_frac)
    n_bg = n - n_c
    lo = np.array([dom.ox, dom.oy, dom.ot])
    span = np.array([dom.gx, dom.gy, dom.gt])

    centers = lo + rng.random((n_clusters, 3)) * span
    # Zipf-ish cluster sizes: a few clusters dominate (drives load imbalance)
    w = 1.0 / np.arange(1, n_clusters + 1)
    w /= w.sum()
    sizes = rng.multinomial(n_c, w)
    sigma_s = max(dom.gx, dom.gy) / 40.0
    sigma_t = dom.gt / 30.0

    parts = []
    for c, s in zip(centers, sizes):
        if s == 0:
            continue
        p = np.empty((s, 3))
        p[:, 0] = rng.normal(c[0], sigma_s, s)
        p[:, 1] = rng.normal(c[1], sigma_s, s)
        # seasonal: cluster time + weekly-ish harmonics
        p[:, 2] = c[2] + sigma_t * np.sin(rng.normal(0, 1.2, s)) + rng.normal(
            0, sigma_t / 3, s
        )
        parts.append(p)
    if n_bg:
        parts.append(lo + rng.random((n_bg, 3)) * span)
    pts = np.concatenate(parts, axis=0)[:n]
    eps = 1e-3
    hi = lo + span * (1 - eps)
    return np.clip(pts, lo, hi).astype(np.float32)


# --------------------------------------------------------------------------
# Paper Table 2 — 21 instances. approx=True marks reconstructed cells.
# --------------------------------------------------------------------------
_T = STKDEInstance
INSTANCES: Dict[str, STKDEInstance] = {
    i.name: i
    for i in [
        _T("Dengue_Lr-Lb", 11056, 148, 194, 728, 3, 1, seed=1),
        _T("Dengue_Lr-Hb", 11056, 148, 194, 728, 25, 1, seed=1),
        _T("Dengue_Hr-Lb", 11056, 294, 386, 728, 6, 1, seed=1, approx=True),
        _T("Dengue_Hr-Hb", 11056, 294, 386, 728, 50, 1, seed=1, approx=True),
        _T("Dengue_Hr-VHb", 11056, 294, 386, 728, 50, 14, seed=1),
        _T("PollenUS_Lr-Lb", 588189, 131, 61, 84, 2, 3, seed=2),
        _T("PollenUS_Hr-Lb", 588189, 651, 301, 84, 10, 3, seed=2),
        _T("PollenUS_Hr-Mb", 588189, 651, 301, 84, 25, 7, seed=2),
        _T("PollenUS_Hr-Hb", 588189, 651, 301, 84, 50, 14, seed=2, approx=True),
        _T("PollenUS_VHr-Lb", 588189, 6501, 3001, 84, 100, 3, seed=2),
        _T("PollenUS_VHr-VLb", 588189, 6501, 3001, 84, 50, 3, seed=2, approx=True),
        _T("Flu_Lr-Lb", 31478, 117, 308, 851, 1, 1, seed=3),
        _T("Flu_Lr-Hb", 31478, 117, 308, 851, 3, 3, seed=3, approx=True),
        _T("Flu_Mr-Lb", 31478, 233, 615, 1985, 2, 3, seed=3),
        _T("Flu_Mr-Hb", 31478, 233, 615, 1985, 4, 7, seed=3),
        _T("Flu_Hr-Lb", 31478, 581, 1536, 5951, 5, 7, seed=3),
        _T("Flu_Hr-Hb", 31478, 581, 1536, 5951, 10, 21, seed=3),
        _T("eBird_Lr-Lb", 291990435, 357, 721, 2435, 2, 3, seed=4),
        _T("eBird_Lr-Hb", 291990435, 357, 721, 2435, 6, 5, seed=4),
        _T("eBird_Hr-Lb", 291990435, 1781, 3601, 2435, 10, 3, seed=4),
        _T("eBird_Hr-Hb", 291990435, 1781, 3601, 2435, 30, 5, seed=4),
    ]
}


def get_instance(name: str) -> STKDEInstance:
    return INSTANCES[name]


def bench_suite(max_voxels: int = 1_500_000, max_points: int = 20_000):
    """Scaled-down versions of every instance, CPU-runnable."""
    return {k: v.scaled(max_voxels, max_points) for k, v in INSTANCES.items()}
