"""Parametric strategy planner — the paper's §6.5 future work, implemented.

"What we need to do is to develop a parametric model for the problem that
 will take into account memory availability, cost of memory initialization,
 expected cost of computing the kernel density. Using that model finding the
 best execution strategy becomes a combinatorial problem."

Given an instance (grid, bandwidths, point loads) and a device mesh, this
module prices every strategy with a three-term model (the same decomposition
the roofline analysis uses):

    time = init(memset)  +  point-work(FLOPs, x imbalance)  +  collectives

and returns the argmin. The arithmetic is the reference package's
(``repro/core/plan.py``), numpy only. Hardware records:

  H100       NVIDIA H100, fitted by ``calibrate_host`` from the port's own
             reconcile rows (``results/torch/reconcile_h100.json``); the
             default of ``estimate``/``choose``
  H100_SEED  the card's published peaks, the unfitted starting point
  HOST       the reference's fit for 8 fake XLA devices on one CPU socket;
             used for CPU meshes (so CPU runs choose as the reference does)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import pathlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .geometry import Domain
from ..distributed import partition


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Rates of one device of a mesh, the reference's fields and names.

    On the H100 the two compute paths are: ``vpu_derate`` the scatter path
    (the PB-SYM strategies: CUDA cores and atomic adds) and ``mxu_derate``
    the tile-GEMM path (DD-LPT's fp32 ``einsum``); each is a share of
    ``peak_flops``. ``ici_bw`` prices the collectives' bytes, ``hbm_bw``
    the memset of a shard's grid, ``hbm_bytes`` the feasibility test.
    """

    peak_flops: float             # FLOP/s of one device
    hbm_bw: float                 # bytes/s
    ici_bw: float                 # bytes/s a collective moves
    hbm_bytes: float              # per device
    vpu_derate: float = 1.0       # scatter path: share of peak_flops
    mxu_derate: float = 1.0       # tile-GEMM path: share of peak_flops


# The published peaks of one NVIDIA H100 SXM (80 GB HBM3): fp32 outside the
# tensor cores (DD-LPT's einsum runs in fp32: TF32 is off), HBM3, memory.
# Every shard of the port's meshes measured so far sits on one card, so a
# collective is a copy within HBM: it reads and writes each byte, half the
# memory rate.
H100_SEED = Hardware(
    peak_flops=67e12,
    hbm_bw=3.35e12,
    ici_bw=3.35e12 / 2,
    hbm_bytes=80e9,
    vpu_derate=1.0,
    mxu_derate=1.0,
)

# The reference's constants for 8 fake XLA devices on one CPU socket (the
# per-"device" rates are fractions of the socket); HOST folds in its
# reconcile rows (results/bench/reconcile.json, mesh 2x2x2, n=8000).
# They describe no card: the port uses them for CPU meshes only, where they
# make the port choose as the reference chooses.
HOST_SEED = Hardware(
    peak_flops=5e10,     # per fake device, fp32 vector path
    hbm_bw=4e9,          # DRAM bandwidth share per fake device
    ici_bw=4e9,          # "collective" = memcpy through shared memory
    hbm_bytes=4e9,
    vpu_derate=1.0,      # scatter path on CPU is the same ALUs
    mxu_derate=1.0,
)
HOST = dataclasses.replace(HOST_SEED, peak_flops=3.0e6, mxu_derate=15.5)

# The port's reconcile reports measured on the card, as chip_smoke.py
# printed them; H100 is fitted from them.
H100_ROWS = (pathlib.Path(__file__).resolve().parents[3]
             / "results" / "torch" / "reconcile_h100.json")
# the report H100 is fitted from: all seven strategies are probed there
H100_FIT_MESH = "2x2x2"


@functools.lru_cache(maxsize=None)
def _fit_h100() -> Hardware:
    """``calibrate_host`` of the committed (2, 2, 2) rows, from
    ``H100_SEED``.

    The rows were measured with every shard on one card, in turn: the
    fitted rates are one shard's share of the card when 8 shards share it
    (as ``HOST``'s are one fake device's share of a socket). A mesh of
    distinct cards has not been measured.
    """
    with open(H100_ROWS) as f:
        reports = json.load(f)
    fit = [r for r in reports if r["mesh"] == H100_FIT_MESH]
    if len(fit) != 1:
        raise ValueError(f"{H100_ROWS} holds {len(fit)} reports of mesh "
                         f"{H100_FIT_MESH}; the H100 record needs one")
    return calibrate_host(fit[0]["rows"], base=H100_SEED)


def __getattr__(name: str):
    # H100 is read from the committed rows at first use, not at import
    if name == "H100":
        return _fit_h100()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def probed_strategies() -> Tuple[str, ...]:
    """Strategy names with a phase-probe spec (``obs.reconcile.PROBED``).

    Single source of truth for which rows calibration may trust — derived
    from the probe registry so the two can never drift.
    """
    from ..obs import reconcile

    return tuple(reconcile.PROBED)


# strategies whose compute runs on the tile-GEMM (einsum) path; every
# other strategy is on the scatter path — see estimate()
TILE_PATH = ("dd_lpt",)


def calibrate_host(rows, base: Hardware = HOST_SEED,
                   strategies: Optional[Sequence[str]] = None) -> Hardware:
    """Re-fit the compute rates from reconcile rows.

    ``rows`` is the ``rows`` list of a ``obs.reconcile`` report (or a path
    to one): entries with ``term == "compute_s"`` and positive
    predicted/measured values contribute ``measured / predicted`` ratios.
    ``base.peak_flops`` (the Hardware that *produced* those predictions)
    is divided by the geometric mean of the scatter-path strategies'
    ratios; ``base.mxu_derate`` is re-fitted from the ``TILE_PATH``
    strategies' ratios so the tile-GEMM rate tracks its own measurement.
    Terms other than compute are left untouched: the collectives measure
    within the host clock's noise, so a bandwidth fit would be
    unidentifiable from these rows.

    ``strategies`` limits which rows contribute; it defaults to the probe
    registry keys (``obs.reconcile.PROBED``) so rows from unknown or
    retired strategies in an old report can't skew the fit.
    """
    if isinstance(rows, (str, os.PathLike)):
        with open(rows) as f:
            rows = json.load(f)
    if isinstance(rows, dict):
        rows = rows.get("rows", [])
    if rows and isinstance(rows[0], dict) and "rows" in rows[0]:
        # a reconcile.json file: list of per-run reports, each with rows
        rows = [r for rep in rows for r in rep.get("rows", [])]
    allowed = set(probed_strategies() if strategies is None else strategies)

    def geomean_ratio(names):
        ratios = [
            r["measured_s"] / r["predicted_s"]
            for r in rows
            if r.get("term") == "compute_s"
            and r.get("strategy") in names
            and r.get("predicted_s", 0) > 0 and r.get("measured_s", 0) > 0
        ]
        if not ratios:
            return None
        return math.exp(sum(math.log(x) for x in ratios) / len(ratios))

    g_scatter = geomean_ratio(allowed - set(TILE_PATH))
    g_tile = geomean_ratio(allowed & set(TILE_PATH))
    out = base
    if g_scatter is not None:
        out = dataclasses.replace(out, peak_flops=base.peak_flops / g_scatter)
    if g_tile is not None:
        # tile rate = peak_flops * mxu_derate must shrink by g_tile; the
        # peak_flops change above is compensated inside the derate
        scale = g_scatter if g_scatter is not None else 1.0
        out = dataclasses.replace(
            out, mxu_derate=base.mxu_derate * scale / g_tile)
    return out


def default_hw(device) -> Hardware:
    """The Hardware record for a mesh on ``device``: ``H100`` on a CUDA
    device, ``HOST`` on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return _fit_h100()
    if kind == "cpu":
        return HOST
    raise ValueError(f"no Hardware record for device type {kind!r}")


def _point_work_flops(dom: Domain, n_eff: float) -> float:
    """PB-SYM flops: disk eval + bar eval + cylinder outer-product FMA."""
    disk = (2 * dom.Hs + 1) ** 2
    bar = 2 * dom.Ht + 1
    return n_eff * (disk * 10.0 + bar * 5.0 + disk * bar * 2.0)


def estimate(
    dom: Domain,
    n: int,
    mesh_shape: Tuple[int, ...],
    loads: Optional[np.ndarray] = None,
    hw: Optional[Hardware] = None,
    use_mxu: bool = True,
) -> Dict[str, Dict[str, float]]:
    """Per-strategy cost breakdown in seconds. mesh_shape=(A, B) or
    (R, A, B). ``hw=None`` means ``H100``."""
    hw = _fit_h100() if hw is None else hw
    if len(mesh_shape) == 3:
        R, A, B = mesh_shape
    else:
        R, (A, B) = 1, mesh_shape
    P = R * A * B
    Gb = dom.grid_voxels * 4.0                      # grid bytes
    gx_loc = math.ceil(dom.Gx / A)
    gy_loc = math.ceil(dom.Gy / B)
    sub_b = gx_loc * gy_loc * dom.Gt * 4.0
    halo_b = 2 * (gx_loc + gy_loc + 2 * dom.Hs) * dom.Hs * dom.Gt * 4.0
    # Two compute paths with very different efficiency: the scatter-based
    # PB-SYM strategies (dr/dd/pd/pd_xt/pd_xyt/hybrid) run at the scatter
    # rate, while dd_lpt's separable tile contraction is a GEMM workload.
    rate_scatter = hw.peak_flops * hw.vpu_derate
    rate_tile = hw.peak_flops * (
        hw.mxu_derate if use_mxu else hw.vpu_derate
    )

    # overlap replication factor (cut cylinders) for DD-style strategies
    tiles_per_dim_x = max(1.0, gx_loc / (2 * dom.Hs + 1))
    rep_dd = (1 + 1 / tiles_per_dim_x) * (
        1 + 1 / max(1.0, gy_loc / (2 * dom.Hs + 1))
    )

    # imbalance: measured from per-bucket loads when available
    if loads is not None:
        stats_ab = partition.imbalance_stats(loads, A * B)
        imb_block = stats_ab["block_imbalance"]
        imb_lpt = stats_ab["lpt_imbalance"]
    else:
        imb_block, imb_lpt = 2.5, 1.05              # pessimistic defaults

    w = _point_work_flops(dom, float(n))
    out: Dict[str, Dict[str, float]] = {}

    def entry(init_b, flops, imb, comm_b, mem_b, rate=rate_scatter):
        compute_s = flops * imb / (P * rate)
        return {
            "init_s": init_b / hw.hbm_bw,
            "compute_s": compute_s,
            "comm_s": comm_b / hw.ici_bw,
            "mem_per_dev_gb": mem_b / 1e9,
            "feasible": float(mem_b < hw.hbm_bytes),
            "total_s": init_b / hw.hbm_bw + compute_s + comm_b / hw.ici_bw,
        }

    # DR: full grid per device; ring all-reduce ~ 2*Gb*(P-1)/P per device
    out["dr"] = entry(Gb, w, 1.0, 2 * Gb * (P - 1) / P, 2 * Gb)
    # DD: subgrid per device; replicated points; no comm
    out["dd"] = entry(sub_b, w * rep_dd, imb_block, 0.0, sub_b)
    # PD: halo-extended subgrid; halo exchange; work-efficient
    pd_feasible = gx_loc >= dom.Hs and gy_loc >= dom.Hs
    out["pd"] = entry(
        (gx_loc + 2 * dom.Hs) * (gy_loc + 2 * dom.Hs) * dom.Gt * 4.0,
        w,
        imb_block,
        halo_b,
        sub_b * 2,
    )
    out["pd"]["feasible"] *= float(pd_feasible)
    # PD-XT: split (X, T) — temporal halos are Ht-wide (cheap for
    # long-duration instances); Y unsharded.
    gt_loc = math.ceil(dom.Gt / B)
    halo_xt = 2 * (dom.Hs * dom.Gy * (gt_loc + 2 * dom.Ht)
                   + dom.Ht * gx_loc * dom.Gy) * 4.0
    out["pd_xt"] = entry(
        (gx_loc + 2 * dom.Hs) * dom.Gy * (gt_loc + 2 * dom.Ht) * 4.0,
        w,
        imb_block,
        halo_xt,
        gx_loc * dom.Gy * gt_loc * 4.0 * 2,
    )
    out["pd_xt"]["feasible"] *= float(
        gx_loc >= dom.Hs and gt_loc >= dom.Ht)
    # PD-XYT: full 3-D split — a 3-tuple mesh_shape is read as the
    # (X, Y, T) device grid for this entry (the leading axis splits X
    # instead of replicating). On a 2-D mesh there is no T axis to
    # split, so the strategy is priced like pd but marked infeasible.
    if len(mesh_shape) == 3:
        X, Y, T = mesh_shape
        gx3 = math.ceil(dom.Gx / X)
        gy3 = math.ceil(dom.Gy / Y)
        gt3 = math.ceil(dom.Gt / T)
        halo_xyt = 2 * (
            dom.Hs * gy3 * gt3 + dom.Hs * gx3 * gt3 + dom.Ht * gx3 * gy3
        ) * 4.0
        out["pd_xyt"] = entry(
            (gx3 + 2 * dom.Hs) * (gy3 + 2 * dom.Hs)
            * (gt3 + 2 * dom.Ht) * 4.0,
            w,
            imb_block,
            halo_xyt,
            gx3 * gy3 * gt3 * 4.0 * 2,
        )
        out["pd_xyt"]["feasible"] *= float(
            gx3 >= dom.Hs and gy3 >= dom.Hs and gt3 >= dom.Ht)
    else:
        out["pd_xyt"] = dict(out["pd"])
        out["pd_xyt"]["feasible"] = 0.0
    # DD-LPT: full grid per device (tile soup assembly via psum); the
    # only strategy on the tile-GEMM compute path
    out["dd_lpt"] = entry(
        Gb, w * rep_dd, imb_lpt, 2 * Gb * (P - 1) / P, 2 * Gb,
        rate=rate_tile,
    )
    # hybrid (R-way REP over PD): psum of subgrids over R + halo
    out["hybrid"] = entry(
        (gx_loc + 2 * dom.Hs) * (gy_loc + 2 * dom.Hs) * dom.Gt * 4.0,
        w,
        max(1.0, imb_block / R),
        halo_b + 2 * sub_b * (R - 1) / R,
        sub_b * 2,
    )
    out["hybrid"]["feasible"] *= float(pd_feasible)
    return out


def choose(
    dom: Domain,
    n: int,
    mesh_shape: Tuple[int, ...],
    loads: Optional[np.ndarray] = None,
    hw: Optional[Hardware] = None,
) -> Tuple[str, Dict[str, Dict[str, float]]]:
    """Best feasible strategy and the full cost table (``hw=None`` means
    ``H100``)."""
    table = estimate(dom, n, mesh_shape, loads, hw)
    feas = {k: v for k, v in table.items() if v["feasible"] > 0}
    pick = min(feas or table, key=lambda k: (feas or table)[k]["total_s"])
    return pick, table
