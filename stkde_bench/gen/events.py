"""Clustered space-time events: a frozen copy of the port's generator.

Copied from ``repro_torch/core/datasets.py::clustered_events`` so that a
later change to the program cannot move the benchmark's inputs. One change:
the cluster layout (centres and Zipf sizes) and the draw of the points come
from two seeds. ``layout_seed`` is the configuration's, so every run of a
cell places the same clusters with the same sizes; ``draw_seed`` comes from
the run's ``--seed``, so runs differ in their points and not in how much
work those points make. With ``draw_seed=None`` one generator does both, as
the original does.
"""
from __future__ import annotations

import numpy as np


def clustered_events(
    n: int,
    box,
    layout_seed: int,
    draw_seed=None,
    n_clusters: int = 24,
    cluster_frac: float = 0.8,
) -> np.ndarray:
    """``n`` float32 events ``(x, y, t)`` inside ``box`` = ``(ox, oy, ot,
    gx, gy, gt)``: ``cluster_frac`` of them in Gaussian clusters of Zipf
    sizes with a seasonal time term, the rest uniform."""
    layout = np.random.default_rng(layout_seed)
    draw = layout if draw_seed is None else np.random.default_rng(draw_seed)
    n_c = int(n * cluster_frac)
    n_bg = n - n_c
    ox, oy, ot, gx, gy, gt = (float(v) for v in box)
    lo = np.array([ox, oy, ot])
    span = np.array([gx, gy, gt])

    centers = lo + layout.random((n_clusters, 3)) * span
    # Zipf-ish cluster sizes: a few clusters dominate
    w = 1.0 / np.arange(1, n_clusters + 1)
    w /= w.sum()
    sizes = layout.multinomial(n_c, w)
    sigma_s = max(gx, gy) / 40.0
    sigma_t = gt / 30.0

    parts = []
    for c, s in zip(centers, sizes):
        if s == 0:
            continue
        p = np.empty((s, 3))
        p[:, 0] = draw.normal(c[0], sigma_s, s)
        p[:, 1] = draw.normal(c[1], sigma_s, s)
        # seasonal: cluster time + weekly-ish harmonics
        p[:, 2] = c[2] + sigma_t * np.sin(draw.normal(0, 1.2, s)) + draw.normal(
            0, sigma_t / 3, s
        )
        parts.append(p)
    if n_bg:
        parts.append(lo + draw.random((n_bg, 3)) * span)
    pts = np.concatenate(parts, axis=0)[:n]
    eps = 1e-3
    hi = lo + span * (1 - eps)
    return np.clip(pts, lo, hi).astype(np.float32)


def point_sets(config: dict, seed: int, count: int) -> list:
    """The ``count`` point sets of one run: set ``k`` is drawn from
    ``(seed, k)`` over the configuration's cluster layout."""
    box = (0.0, 0.0, 0.0, config["Gx"] * config["sres"],
           config["Gy"] * config["sres"], config["Gt"] * config["tres"])
    return [
        clustered_events(
            config["n"], box, layout_seed=config["layout_seed"],
            draw_seed=[int(seed) % 2**64, k],
            n_clusters=config["clusters"],
            cluster_frac=config["cluster_frac"])
        for k in range(count)
    ]
