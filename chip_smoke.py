#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

needs one NVIDIA Hopper card, ``nvcc`` and nothing else: it builds the CUDA
kernel from the sources in this checkout, holds it against its plain PyTorch
version on the card (small shapes, cases that split one heavy tile over many
work items, and the full-size ``PollenUS_Hr-Lb`` buckets), checks that the
kernel agrees with itself bit for bit (two launches; the tiles' loads given
on the host, on the card, and taken from the packed buckets' offsets) and,
at ``PollenUS_Hr-Mb``, with the grid it gave on capacity-padded buckets,
times it beside its bound, then drives the port's main path —
``repro_torch.core.api.stkde``, both branches — on two rows of the paper's
Table 2 at full size (``Dengue_Lr-Hb``, ``PollenUS_Hr-Lb``) and checks what
comes out. Then ``gold`` holds the tile kernel, the scatter and ``vb_dec``
against ``vb`` (the paper's Algorithm 1) on the card at full-size
``Dengue_Lr-Hb``, and ``chunked`` drives the crash-safe ``stkde_chunked``
at full-size ``PollenUS_Hr-Lb`` (two runs, a partial run resumed, a child
process SIGKILLed mid-run and resumed: all bit for bit), times the
scatter's fixed-order adds against its atomic ones, and streams the first
chunks of ``eBird_Lr-Lb``. Last, ``distributed`` runs the seven multi-device
strategies on meshes of shards that all sit on this card ((2, 2) and
(2, 2, 2)) at full-size ``PollenUS_Hr-Lb`` and ``Dengue_Lr-Hb``: each grid
against the single-device query, its time split into prepare, shard compute
and collectives, the halo bands of the ``collectives=False`` probes,
chunked runs on a mesh (two runs and a resume, bit for bit) and the
``dist.halo`` fallback to ``dr``. ``planner`` measures the planner's three
terms per strategy on those meshes (``obs.reconcile.run``), re-fits the H100
record from them, lets ``strategy="auto"`` pick at both instances and
loses devices in a chunked run on a mesh, which must shrink, re-plan and
finish; ``degrade`` walks the degrade ladder with the tile kernel as the
query and serves a partial answer from a journal. ``lm_serve`` runs the ten
``reduced`` language models on the card against the CPU, then the full
``smollm-360m`` through the bucketed ``ServingEngine`` (8 greedy requests,
fp32 against a teacher-forced ``forward``, bf16 with its tokens per
second) and through the slot-swap continuous engine (the same prompts,
``max_new`` alternating 8 and 32: its tokens against the bucketed path's,
its swaps and slot occupancy), and the ``reduced`` MLA and rwkv6 configs
continuous against bucketed. ``lm_train`` takes one train step of each
``reduced`` config on the card against the CPU, trains ``smollm-360m`` at
its widths (4 of its 32 blocks) for 20 steps through ``repro_torch.launch.train.main``
(async checkpoints every 10), then kills the run after step 10 and resumes
it: the step-10 checkpoint restored bit for bit, the resumed step-20 loss
against the uninterrupted one's. ``lm_sharded`` runs what exists only across
devices on meshes whose shards all sit on this card: the placement rules of
the ten configs at full size on the production meshes, the MoE all-to-all
at ``deepseek-v2-lite-16b``'s published widths against ``moe_apply``
(output, aux, gradients) and reduced ``dbrx-132b`` under a hint mesh, int8
gradient compression of a full ``smollm-360m`` gradient on 4 shards, full
``smollm-360m`` trained on a (2, 2) mesh against the one-device step
(tensor-parallel over "model", its 15 heads split through a head),
``mistral-nemo-12b`` at its published widths (2 layers) trained the same
way (whole heads split),
``deepseek-v2-lite-16b`` at its published widths (2 layers) trained on a
(2, 2) mesh, two batch shards with the global expert capacity, against the
one-device step (routing equal exactly), and the roofline bound on the card's measured peaks against the measured
steps. ``lm_remat`` holds the reference's per-layer remat on the card: the
ten ``reduced`` configs with and without it, full ``smollm-360m`` at
1 x 1024 both ways and 5 steps at 4 x 4096 (the reference's ``train_4k``
rows) with it, each step's peak memory beside ``launch.dryrun``'s count of
the same step (fake tensors, accounted on the host in two worker processes
started before ``lm_serve``, or in this process with
``--dry-run-in-process``), remat's cost timed at 1 x 1024 and 8 x 256, and
the dry run's sharded prefill and decode on meshes of the card against the
one-device path. The tile branch buckets its points on the
card, packed; its buckets are held bit for bit against the host's numpy
bucketing at both full-size rows.

Every phase prints one JSON line. Any failure exits non-zero; without a CUDA
device the script exits non-zero before it prints a result. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import resource
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM: fp32 outside the tensor cores, TF32 on the
# tensor cores (dense), and HBM.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations of one ks evaluation times norm (a select is one), as a
# kernel that contracts on the CUDA cores alone does them: the fp32 form of
# the bound.
C_KS = {"ks_epanechnikov": 8, "ks_paper_verbatim": 11}
# CUDA-core operations per (point, column) pair of csrc/stkde_tile.cu: the
# support-masked shape of ks (ks_shape; its constant and norm are in Kt, and
# Epanechnikov's u*u, v*v are staged per panel), and the hi/lo split of the
# A value (add, and, subtract). The tensor cores then do 3 MMAs x 2 flops x
# N per pair, N = bt padded to the 8-wide n-tiles of mma.m16n8k8.
C_KS_SHAPE = {"ks_epanechnikov": 4, "ks_paper_verbatim": 9}
C_SPLIT = 3
N_MMA = 3

SMALL_TOL = dict(rtol=1e-5, atol=1e-8)  # as the reference holds its kernel
# Full size: a voxel's sum has up to tens of thousands of fp32 terms, taken
# point by point in the kernel and panel by panel (a matrix product each) in
# the plain version; the error of such a sum grows with the number of terms.
# Measured on an H100: 7.7e-6 at worst, so five times the small-shape rtol.
FULL_TOL = dict(rtol=5e-5, atol_rel_to_max=1e-6)
# Tile branch against scatter branch: the same long sums, the scatter's in an
# order that atomics change from run to run. Measured: 7.3e-7 at worst, so
# the reference's own bar holds, with an atol scaled to the grid's maximum.
BRANCH_TOL = dict(rtol=1e-5, atol_rel_to_max=1e-6)
# sha256 of the tile branch's float32 grid at full-size PollenUS_Hr-Mb as the
# kernel gave it when it read capacity-padded buckets (NVIDIA H100 80GB HBM3):
# the packed buckets hold the same terms in the same order.
PADDED_KERNEL_SHA256 = (
    "1f30f725c26c1a990804337839bde9dc26a027c731b8c51ee93a13862c48f8f0")

TILE_CASES = [
    # (grid, hs, ht, tile)
    ((33, 25, 17), 3.0, 2.0, (8, 8, 8)),
    ((32, 32, 16), 4.0, 1.0, (16, 16, 8)),
    ((64, 48, 12), 6.0, 3.0, (32, 16, 4)),
    ((17, 19, 23), 2.0, 2.0, (8, 8, 16)),   # ragged: tiles overhang the grid
    ((40, 40, 8), 5.0, 1.0, (40, 40, 8)),   # single tile
]


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s``: seconds since the script was imported."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T0}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float) -> dict:
    """max abs / max rel error and whether |got-want| <= atol + rtol*|want|
    holds everywhere (the rule of numpy's assert_allclose)."""
    err = (got - want).abs()
    allowed = atol + rtol * want.abs()
    ok = bool((err <= allowed).all()) and bool(torch.isfinite(got).all())
    big = want.abs() > max(atol, 1e-30)
    rel = float((err[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    # the margin: 1.0 would sit on the bar
    worst = float((err / allowed.clamp_min(1e-38)).max())
    return {"max_abs_err": float(err.max()), "max_rel_err": rel,
            "worst_err_over_allowed": worst, "ok": ok}


def cuda_ms(fn, warmup: int, runs: int):
    """Median time of ``fn`` on the card, by CUDA events; and its result."""
    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    from repro_torch.obs.reconcile import nvidia_smi

    smi = nvidia_smi()
    dev = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit("device", **dev, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return {**dev, "nvidia_smi": smi}


def phase_build() -> dict:
    """Build every kernel (one ``nvcc`` per source, all at once), load it,
    and report what ``ptxas`` said and the split pass's occupancy at the
    main path's tile (32, 32, 16)."""
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import build, stkde_tile

    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    seconds = time.perf_counter() - t0
    report = {n: [ln.strip() for ln in build.build_report(n).splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling" in ln]
              for n in libs}
    lib = build.load("stkde_tile")
    occupancy = {
        "tile": [32, 32, 16], "threads_per_block": 256,
        "smem_bytes_per_block": lib.stkde_tile_smem_bytes(32, 32),
        "blocks_per_sm": {ks.__name__: stkde_tile.blocks_per_sm((32, 32, 16),
                                                                ks)
                          for ks in (km.ks_epanechnikov,
                                     km.ks_paper_verbatim)},
    }
    emit("build", seconds=seconds, libraries=sorted(libs), ptxas=report,
         occupancy=occupancy)
    return {"ptxas": report, "occupancy": occupancy}


def heavy_tile_points(dom, n: int, share: float, seed: int) -> np.ndarray:
    """``n`` points, ``share`` of them packed into one small box (one tile
    then holds most of them), the rest spread over the domain."""
    rng = np.random.default_rng(seed)
    lo = np.array([dom.ox, dom.oy, dom.ot])
    size = np.array([dom.gx, dom.gy, dom.gt])
    k = int(n * share)
    box = lo + size * (0.36 + 0.08 * rng.random((k, 3)))
    rest = lo + size * rng.random((n - k, 3))
    return np.concatenate([box, rest]).astype(np.float32)


def small_cases():
    """(label, dom, points, tile, chunk, ks, kt, seg) of the reference's own
    kernel tests: five tile shapes, three chunk sizes, non-unit resolution
    and origin, both pairs of kernel functions, empty tiles; then cases that
    force splits (a small ``seg`` and a tile holding most of the points).
    ``seg`` None is the wrapper's default."""
    from repro_torch.core import Domain, clustered_events
    from repro_torch.core import kernels_math as km

    epan = (km.ks_epanechnikov, km.kt_epanechnikov)
    verb = (km.ks_paper_verbatim, km.kt_paper_verbatim)
    cases = []
    for grid, hs, ht, tile in TILE_CASES:
        dom = Domain(gx=float(grid[0]), gy=float(grid[1]), gt=float(grid[2]),
                     sres=1.0, tres=1.0, hs=hs, ht=ht)
        pts = clustered_events(400, dom, seed=sum(grid))
        for pair in (epan, verb):
            cases.append((f"tile{tile}/{pair[0].__name__}", dom, pts, tile,
                          256, *pair, None))
    dom = Domain(gx=32, gy=32, gt=16, sres=1.0, tres=1.0, hs=3.0, ht=2.0)
    pts = clustered_events(600, dom, seed=11)
    for chunk in (8, 64, 256):
        cases.append((f"chunk{chunk}", dom, pts, None, chunk, *epan, None))
    dom = Domain(gx=20.0, gy=15.0, gt=30.0, sres=0.6, tres=2.2, hs=2.0,
                 ht=4.0, ox=-7.0, oy=3.0, ot=100.0)
    rng = np.random.default_rng(4)
    pts = (np.array([-7.0, 3.0, 100.0])
           + rng.random((300, 3)) * np.array([20.0, 15.0, 30.0])
           ).astype(np.float32)
    for pair in (epan, verb):
        cases.append((f"nonunit/{pair[0].__name__}", dom, pts, None, 256,
                      *pair, None))
    dom = Domain(gx=64, gy=64, gt=16, sres=1.0, tres=1.0, hs=2.0, ht=1.0)
    cases.append(("empty_tiles", dom, np.full((50, 3), 3.0, dtype=np.float32),
                  None, 256, *epan, None))
    # splits: one tile holds ~90% of the points and is cut into many items
    for grid, hs, ht, tile, seg in (
            ((48, 48, 16), 3.0, 2.0, (16, 16, 8), 64),
            ((64, 64, 32), 4.0, 2.0, (32, 32, 16), 128),
            ((80, 80, 16), 5.0, 1.5, (40, 40, 8), 192)):  # two column passes
        dom = Domain(gx=float(grid[0]), gy=float(grid[1]),
                     gt=float(grid[2]), sres=1.0, tres=1.0, hs=hs, ht=ht)
        pts = heavy_tile_points(dom, 3000, 0.9, seed=sum(grid))
        for pair in (epan, verb):
            cases.append((f"split{tile}/seg{seg}/{pair[0].__name__}", dom,
                          pts, tile, 256, *pair, seg))
    return cases


def bound_ms(points_walked: int, tile, ntiles: int, ks_name: str) -> dict:
    """Least time the card could take for the tile kernel's work, against
    the buckets read once and the padded grid written once over the memory
    rate, in two forms. The kernel's form: the shape of ks and the hi/lo
    split of every (point, column) pair on the CUDA cores in fp32, and the
    three TF32 products on the tensor cores;
    the two units work at once, so the operations take the longer of the
    two. ``fp32``: the whole contraction on the CUDA cores in fp32, the
    form to compare with a kernel that does not use the tensor cores."""
    bx, by, bt = tile
    pairs = points_walked * bx * by
    nbytes = 16 * points_walked + 4 * ntiles * bx * by * bt + 4 * ntiles
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    n_pad = -(-bt // 8) * 8
    c_ks = C_KS[ks_name]
    t_cc = pairs * (C_KS_SHAPE[ks_name] + C_SPLIT) / PEAK_FP32_FLOPS * 1e3
    t_tc = pairs * N_MMA * 2 * n_pad / PEAK_TF32_FLOPS * 1e3
    t_fp32 = pairs * (c_ks + 2 * bt) / PEAK_FP32_FLOPS * 1e3
    t_ops = max(t_cc, t_tc)
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs, "bytes": nbytes,
            "cuda_core_ms": t_cc, "tensor_core_ms": t_tc, "bytes_ms": t_bytes,
            "fp32_form": {"bound_ms": max(t_fp32, t_bytes),
                          "operations": pairs * (c_ks + 2 * bt)}}


def plan_fields(plan, tile) -> dict:
    """What the kernel's work plan looks like (printed beside its times)."""
    bx, by, bt = tile
    return {"seg": plan.seg, "segments": plan.segments,
            "max_segment": plan.max_segment,
            "split_tiles": int(plan.reduce.shape[0]),
            "scratch_slots": plan.slots,
            "scratch_bytes": plan.slots * bx * by * bt * 4}


def staged_tile_path(pts: np.ndarray, dom, timed_runs: int) -> dict:
    """The tile branch of ``stkde`` stage by stage, each stage timed: the
    points' copy to the card, overlap bucketing and packing on the card
    (the tiles' loads back to the host for the kernel's work plan), the
    kernel's inputs, kernel (given the host's loads, as ``stkde_tiled``
    does), slice + finite check. The kernel is timed twice: the wrapper as
    the main path calls it (host planning, the plan's copy, the launches),
    and the device work alone (split pass + reduction on a plan made
    beforehand). The card's packed buckets are held bit for bit against the
    host's numpy bucketing of the same points (timed too, as the stage it
    replaced)."""
    from repro_torch import convert
    from repro_torch._device import points_to_device
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops, stkde_tile, stkde_tiles_cuda
    from repro_torch.resilience import ensure_finite

    tile = ops.default_tile(dom)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    ops.prepare_tiles(points_to_device(pts, dev), dom, tile)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = points_to_device(pts, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b, chunk = ops.prepare_tiles(on_card, dom, tile)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    t = convert.buckets_to_torch(b.points, b.offsets, b.counts, tile,
                                 b.max_load)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    wrapper_ms, padded = cuda_ms(
        lambda: stkde_tiles_cuda(t.points, t.offsets, dom, tile, t.cap,
                                 len(pts), chunk, mode="compiled",
                                 counts=b.loads),
        warmup=1, runs=timed_runs)
    t4 = time.perf_counter()
    grid = ensure_finite(padded[: dom.Gx, : dom.Gy, : dom.Gt], "smoke.tiled")
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    prep = stkde_tile._prepare(t.points, t.offsets, b.loads, dom, tile,
                               t.cap, len(pts), km.DEFAULT_KS,
                               km.DEFAULT_KT, None)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t5
    kernel_ms, device_only = cuda_ms(
        lambda: stkde_tile._run(prep, t.points, t.offsets),
        warmup=1, runs=timed_runs)
    if not torch.equal(device_only, padded):
        fail("the prepared launch differs from the wrapper's")
    counts = b.loads

    h0 = time.perf_counter()
    nb, nchunk = ops.prepare_tiles(pts, dom, tile)
    host_bucketing_s = time.perf_counter() - h0
    same = {"points": bool(torch.equal(b.points,
                                       torch.from_numpy(nb.points).cuda())),
            "offsets": bool(torch.equal(b.offsets,
                                        torch.from_numpy(nb.offsets).cuda())),
            "counts": bool(np.array_equal(b.counts.cpu().numpy(), nb.counts)
                           and np.array_equal(counts, nb.loads)),
            "cap_and_chunk": (b.max_load, chunk) == (nb.max_load, nchunk)}
    del nb
    ks_name = km.DEFAULT_KS.__name__
    plan = prep.plan
    walked = int((-(-plan.items[:, 2].astype(np.int64) // 8) * 8).sum())
    return {
        "inputs": t, "chunk": chunk, "tile": tile, "grid": grid,
        "padded": padded, "counts_host": counts, "plan": plan,
        "buckets_bit_identical_to_numpy": {**same,
                                           "ok": all(same.values())},
        "bounds": {
            "useful": bound_ms(int(counts.sum()), tile, counts.size,
                               ks_name),
            "as_launched": bound_ms(walked, tile, counts.size, ks_name),
        },
        "times": {"points_h2d_s": t1 - t0,
                  "device_bucketing_and_loads_d2h_s": t2 - t1,
                  "kernel_inputs_s": t3 - t2,
                  "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
                  "plan_and_copy_s": plan_s, "slice_check_s": t5 - t4,
                  "numpy_host_bucketing_s": host_bucketing_s},
        "shape": {"ntiles": list(b.ntiles), "max_load": b.max_load,
                  "chunk": chunk,
                  "copies_per_point": b.replication_factor,
                  "bucket_bytes": b.nbytes,
                  "padded_bucket_bytes": 16 * counts.size * b.max_load,
                  **plan_fields(plan, tile)},
    }


def ks_support_share(t, dom, tile, block: int = 65536) -> dict:
    """Share of the walked (point, column) pairs whose ks is not zero, i.e.
    whose column lies inside the point's spatial disk; counted on the card
    from the packed buckets' points (the rest of the walk multiplies
    zeros)."""
    bx, by, _ = tile
    pts = t.points
    dev = pts.device
    nt = tuple(t.counts.shape)
    tile_of = torch.repeat_interleave(
        torch.arange(t.counts.numel(), device=dev),
        t.offsets.diff(), output_size=len(pts))
    hs = torch.tensor(dom.hs, dtype=torch.float32, device=dev)
    ix = torch.arange(bx, dtype=torch.float32, device=dev)
    iy = torch.arange(by, dtype=torch.float32, device=dev)
    inside = 0
    for i in range(0, len(pts), block):
        tid = tile_of[i:i + block, None]
        ti = (tid // (nt[1] * nt[2])).float()
        tj = (tid // nt[2] % nt[1]).float()
        u = (dom.ox + ((ti * bx + ix) + 0.5) * dom.sres
             - pts[i:i + block, 0:1]) / hs
        v = (dom.oy + ((tj * by + iy) + 0.5) * dom.sres
             - pts[i:i + block, 1:2]) / hs
        inside += int(((u * u)[:, :, None] + (v * v)[:, None, :] < 1.0).sum())
    pairs = len(pts) * bx * by
    return {"pairs": pairs, "pairs_ks_nonzero": inside,
            "share": inside / max(pairs, 1)}


def packed_against_padded_kernel() -> dict:
    """The tile branch's grid at full-size ``PollenUS_Hr-Mb`` against the
    grid the kernel gave when it read capacity-padded buckets (the same
    points, plan and card model): its sha256 against that grid's."""
    import hashlib

    from repro_torch.core import get_instance, stkde

    inst = get_instance("PollenUS_Hr-Mb")
    grid = stkde(inst.points(), inst.domain(), use_tiled_kernel=True)
    torch.cuda.synchronize()
    digest = hashlib.sha256(grid.cpu().numpy().tobytes()).hexdigest()
    return {"instance": inst.name, "sha256": digest,
            "padded_sha256": PADDED_KERNEL_SHA256,
            "bits_equal": digest == PADDED_KERNEL_SHA256}


def compare_by_slab(got: torch.Tensor, want: torch.Tensor, rtol: float,
                    atol: float, slab: int = 256) -> dict:
    """``compare`` over slabs of the first axis, for grids whose error
    tensors would not fit beside them on the card."""
    parts = [compare(got[i:i + slab], want[i:i + slab], rtol, atol)
             for i in range(0, got.shape[0], slab)]
    return {"max_abs_err": max(p["max_abs_err"] for p in parts),
            "max_rel_err": max(p["max_rel_err"] for p in parts),
            "worst_err_over_allowed": max(p["worst_err_over_allowed"]
                                          for p in parts),
            "ok": all(p["ok"] for p in parts)}


def packed_kernel_at_vhr() -> dict:
    """Full-size ``PollenUS_VHr-Lb``, the row the packed layout exists for
    (115,056 tiles, ~40 M packed copies, int64 offsets, a densest run of
    ~34k points): the card's packed buckets against numpy's, bit for bit,
    and the kernel against its plain version on the same packed tensors, at
    ``FULL_TOL``."""
    from repro_torch.core import get_instance
    from repro_torch.kernels import stkde_tiles_ref

    inst = get_instance("PollenUS_VHr-Lb")
    dom, pts = inst.domain(), inst.points()
    st = staged_tile_path(pts, dom, timed_runs=1)
    t, got = st["inputs"], st["padded"]
    del st["grid"]
    want, plain_s = host_timed(
        lambda: stkde_tiles_ref(t.points, t.offsets, dom, st["tile"],
                                len(pts)))
    atol = FULL_TOL["atol_rel_to_max"] * float(want.abs().max())
    vs_plain = compare_by_slab(got, want, FULL_TOL["rtol"], atol)
    vs_plain["atol"] = atol
    del got, want, st["padded"]
    torch.cuda.empty_cache()
    return {"instance": inst.name, "n": len(pts),
            "grid": list(dom.grid_shape), "vs_plain": vs_plain,
            "buckets_bit_identical_to_numpy":
                st["buckets_bit_identical_to_numpy"],
            "plain_s": plain_s, "kernel_ms": st["times"]["kernel_ms"],
            "stage_times": st["times"], **st["shape"]}


def phase_kernels() -> dict:
    from repro_torch import convert
    from repro_torch.core import get_instance
    from repro_torch.kernels import build, ops, stkde_tile
    from repro_torch.kernels import stkde_tiles_cuda, stkde_tiles_ref

    results = []
    worst_small = 0.0
    for label, dom, pts, tile, chunk, ks, kt, seg in small_cases():
        tile = ops.default_tile(dom) if tile is None else tile
        b, chunk_eff = ops.prepare_tiles(pts, dom, tile, chunk=chunk)
        t = convert.buckets_to_torch(b.points, b.offsets, b.counts, tile,
                                     b.max_load)
        args = (t.points, t.offsets, dom, tile)
        if seg is None:
            seg = stkde_tile.default_seg(b.loads, tile, t.points.device, ks)
        plan = stkde_tile.plan_segments(b.loads, seg)

        def run(counts):
            return stkde_tiles_cuda(*args, t.cap, len(pts), chunk_eff, ks, kt,
                                    mode="compiled", counts=counts, seg=seg)

        want = stkde_tiles_ref(*args, len(pts), ks, kt)
        early = run(b.loads)
        again = run(b.loads)
        dev_counts = run(t.counts)
        from_offsets = run(None)
        torch.cuda.synchronize()
        r = compare(early, want, **SMALL_TOL)
        r["label"] = label
        r.update(plan_fields(plan, tile))
        r["max_load"] = b.max_load
        r["two_launches_bit_identical"] = bool(torch.equal(early, again))
        r["device_counts_bit_identical"] = bool(torch.equal(early,
                                                            dev_counts))
        r["loads_from_offsets_bit_identical"] = bool(
            torch.equal(early, from_offsets))
        if label == "empty_tiles":
            r["far_tiles_sum"] = float(early[10:64, 10:64, :].sum())
            r["ok"] = r["ok"] and r["far_tiles_sum"] == 0.0 and float(
                early[:8, :8, :8].sum()) > 0
        if label.startswith("split"):     # the case must really split
            r["ok"] = r["ok"] and r["split_tiles"] > 0
        r["ok"] = (r["ok"] and r["two_launches_bit_identical"]
                   and r["device_counts_bit_identical"]
                   and r["loads_from_offsets_bit_identical"])
        results.append(r)
        worst_small = max(worst_small, r["max_abs_err"])
        if not r["ok"]:
            emit("kernels", failed=r)
            fail(f"stkde_tile disagrees with its plain version at {label}")

    # ---- full size: PollenUS_Hr-Lb buckets at tile (32, 32, 16)
    inst = get_instance("PollenUS_Hr-Lb")
    dom, pts = inst.domain(), inst.points()
    before = tile_launches()
    st = staged_tile_path(pts, dom, timed_runs=5)
    t, tile, chunk, plan = st["inputs"], st["tile"], st["chunk"], st["plan"]
    args = (t.points, t.offsets, dom, tile)
    n = len(pts)

    again = stkde_tiles_cuda(*args, t.cap, n, chunk, mode="compiled",
                             counts=st["counts_host"])
    # the loads taken from the offsets under the main path's seg
    offsets_ms, from_offsets = cuda_ms(
        lambda: stkde_tiles_cuda(*args, t.cap, n, chunk, mode="compiled",
                                 seg=plan.seg),
        warmup=0, runs=1)
    launches_here = tile_launches() - before

    # the reduction pass alone, on the main path's plan (scratch of zeros)
    lib = build.load("stkde_tile")
    reduce = torch.from_numpy(plan.reduce).cuda()
    scratch = torch.zeros(plan.slots * int(np.prod(tile)), device="cuda")
    sink = st["padded"].clone()
    reduce_ms, _ = cuda_ms(
        lambda: stkde_tile._reduce(lib, reduce, scratch, sink,
                                   tuple(t.counts.shape), tile),
        warmup=1, runs=5)
    del scratch, sink

    plain_ms, want = cuda_ms(
        lambda: stkde_tiles_ref(*args, n), warmup=1, runs=3)
    support = ks_support_share(t, dom, tile)

    scale = float(want.abs().max())
    atol = FULL_TOL["atol_rel_to_max"] * scale
    full = compare(st["padded"], want, FULL_TOL["rtol"], atol)
    two_launches = bool(torch.equal(st["padded"], again))
    bit_identical = bool(torch.equal(st["padded"], from_offsets))
    counts = st["counts_host"]
    b_useful = st["bounds"]["useful"]
    kernel_ms = st["times"]["kernel_ms"]
    against_padded = packed_against_padded_kernel()
    vhr = packed_kernel_at_vhr()
    full_size = {
        "instance": inst.name, "n": n, "grid": list(dom.grid_shape),
        **st["shape"],
        "mean_load": float(counts.mean()),
        "tolerance": {"rtol": FULL_TOL["rtol"], "atol": atol,
                      "why": "fp32 sums of up to max_load terms in another "
                             "order"},
        "vs_plain": full,
        "two_launches_bit_identical": two_launches,
        "loads_from_offsets_bit_identical": bit_identical,
        "loads_from_offsets_ms": offsets_ms,
        "launches": launches_here,
        "kernel_ms": kernel_ms, "reduction_ms": reduce_ms,
        "wrapper_ms": st["times"]["wrapper_ms"],
        "plain_ms": plain_ms,
        "share_of_bound": b_useful["bound_ms"] / kernel_ms,
        "share_of_fp32_bound": b_useful["fp32_form"]["bound_ms"] / kernel_ms,
        "bound_useful": b_useful,
        "bound_as_launched": st["bounds"]["as_launched"],
        "ks_support": support,
        "stage_times": st["times"],
        "against_padded_kernel": against_padded,
        "packed_at_vhr": vhr,
    }
    emit("kernels", kernels=[{
        "name": "stkde_tile", "small_cases": results,
        "small_tolerance": SMALL_TOL, "full_size": full_size}])
    full_size["buckets_bit_identical_to_numpy"] = \
        st["buckets_bit_identical_to_numpy"]
    if not (full["ok"] and bit_identical and two_launches
            and plan.max_segment <= plan.seg
            and against_padded["bits_equal"] and vhr["vs_plain"]["ok"]
            and vhr["buckets_bit_identical_to_numpy"]["ok"]):
        fail("stkde_tile disagrees with its plain version, with itself, or "
             "with the padded kernel's grid, or the card's packed buckets "
             "with numpy's, at full size")
    return {
        "max_abs_err": max(full["max_abs_err"], worst_small),
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": b_useful["bound_ms"], "bound_by": b_useful["bound_by"],
        "pollen_grid": st["grid"], "pollen_times": st["times"],
        "pollen_shape": st["shape"], "pollen_bounds": st["bounds"],
        "pollen_buckets": st["buckets_bit_identical_to_numpy"],
    }


def phase_main_path(kern: dict) -> dict:
    """``stkde`` through the public entry point with the default device, both
    branches, on two Table-2 rows at full n. Returns the tile kernel's
    launches, the scatter kernel's, and each instance's tile-branch grid."""
    from repro_torch.core import get_instance, stkde

    instances = [get_instance(n) for n in ("Dengue_Lr-Hb", "PollenUS_Hr-Lb")]
    data = [(i, i.domain(), i.points()) for i in instances]
    torch.cuda.synchronize()

    def timed_query(pts, dom, tiled: bool):
        t0 = time.perf_counter()
        grid = stkde(pts, dom, use_tiled_kernel=tiled)
        torch.cuda.synchronize()
        return grid, time.perf_counter() - t0

    # Each query twice: the first pays one-time costs of the process (CUDA
    # module loading, the allocator's first blocks), the second is steady.
    launches0, scatter0 = tile_launches(), scatter_launches()
    runs = []
    for inst, dom, pts in data:
        _, tile_first_s = timed_query(pts, dom, True)
        tiled, tile_s = timed_query(pts, dom, True)
        _, scatter_first_s = timed_query(pts, dom, False)
        scatter, scatter_s = timed_query(pts, dom, False)
        runs.append((inst, dom, pts, tiled, scatter, tile_s, scatter_s,
                     tile_first_s, scatter_first_s))
    launches = tile_launches() - launches0
    scatter_n = scatter_launches() - scatter0

    rows = []
    ok = launches == 2 * len(data) and scatter_n == 2 * len(data)
    for (inst, dom, pts, tiled, scatter, tile_s, scatter_s, tile_first_s,
         scatter_first_s) in runs:
        if inst.name == "PollenUS_Hr-Lb":   # staged in the kernels phase
            st = {"grid": kern["pollen_grid"], "times": kern["pollen_times"],
                  "shape": kern["pollen_shape"],
                  "bounds": kern["pollen_bounds"],
                  "buckets_bit_identical_to_numpy": kern["pollen_buckets"]}
        else:
            st = staged_tile_path(pts, dom, timed_runs=5)
        staged_grid, stage_times = st["grid"], st["times"]
        scale = float(scatter.abs().max())
        atol = BRANCH_TOL["atol_rel_to_max"] * scale
        agree = compare(tiled, scatter, BRANCH_TOL["rtol"], atol)
        row = {
            "instance": inst.name, "n": len(pts),
            "grid": list(dom.grid_shape),
            "device": str(tiled.device), "dtype": str(tiled.dtype),
            "shape_ok": tuple(tiled.shape) == dom.grid_shape
            and tuple(scatter.shape) == dom.grid_shape,
            "finite": bool(torch.isfinite(tiled).all())
            and bool(torch.isfinite(scatter).all()),
            "branches": agree,
            "tolerance": {"rtol": BRANCH_TOL["rtol"], "atol": atol,
                          "why": "long fp32 sums; the scatter adds with "
                                 "atomics, in an order that changes"},
            "same_as_staged_run": bool(torch.equal(tiled, staged_grid)),
            "mass_tiled": float(tiled.sum(dtype=torch.float64))
            * dom.sres ** 2 * dom.tres,
            "mass_scatter": float(scatter.sum(dtype=torch.float64))
            * dom.sres ** 2 * dom.tres,
            "tile_branch_total_s": tile_s,
            "scatter_branch_total_s": scatter_s,
            "tile_branch_first_call_s": tile_first_s,
            "scatter_branch_first_call_s": scatter_first_s,
            "tile_branch_stages": stage_times,
            "tile_branch_shape": st["shape"],
            "card_buckets_bit_identical_to_numpy":
                st["buckets_bit_identical_to_numpy"],
            "kernel_bound_useful_ms": st["bounds"]["useful"]["bound_ms"],
        }
        row["ok"] = (row["shape_ok"] and row["finite"] and agree["ok"]
                     and row["same_as_staged_run"] and tiled.is_cuda
                     and scatter.is_cuda and tiled.dtype == torch.float32
                     and 0.0 < row["mass_tiled"] <= 1.001
                     and st["buckets_bit_identical_to_numpy"]["ok"])
        ok = ok and row["ok"]
        rows.append(row)
    emit("main_path", launches=launches, scatter_launches=scatter_n,
         instances=rows)
    if not ok:
        fail("main path: a check failed (see the main_path line)")
    return {"launches": launches, "scatter_launches": scatter_n,
            "tiled": {r[0].name: r[3] for r in runs}}


def host_timed(fn):
    """``fn()`` and its seconds on the host clock, the card waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def gold_cases():
    """(label, dom, points) of the reference's gold-standard tests: its small
    domain, and the non-unit resolution and origin domain."""
    from repro_torch.core import Domain, clustered_events

    small = Domain(gx=24.0, gy=18.0, gt=14.0, sres=1.0, tres=1.0, hs=3.0,
                   ht=2.0)
    nonunit = Domain(gx=20.0, gy=15.0, gt=30.0, sres=0.6, tres=2.2, hs=2.0,
                     ht=4.0, ox=-7.0, oy=3.0, ot=100.0)
    rng = np.random.default_rng(4)
    pts = (np.array([-7.0, 3.0, 100.0])
           + rng.random((200, 3)) * np.array([20.0, 15.0, 30.0])
           ).astype(np.float32)
    return [("small", small, clustered_events(100, small, seed=2)),
            ("nonunit", nonunit, pts)]


def phase_gold(main: dict) -> int:
    """``vb`` (the paper's Algorithm 1) on the card at full-size
    ``Dengue_Lr-Hb``, and the three other ways to the same grid held
    against it: the tile branch of ``stkde`` (the hand-written kernel), its
    scatter branch and ``vb_dec``. Then ``vb`` against the scatter with the
    paper-verbatim kernel functions at small domains, where a quotient that
    is not a true division flips their support test. Returns the kernel's
    launches in this phase."""
    from repro_torch.core import get_instance, pb, stkde, vb, vb_dec
    from repro_torch.core import kernels_math as km

    inst = get_instance("Dengue_Lr-Hb")
    dom, pts = inst.domain(), inst.points()
    launches0 = tile_launches()
    tiled, tiled_s = host_timed(lambda: stkde(pts, dom, use_tiled_kernel=True))
    launches = tile_launches() - launches0
    scatter, scatter_s = host_timed(lambda: stkde(pts, dom))
    gold, vb_s = host_timed(lambda: vb(pts, dom))
    dec, vb_dec_s = host_timed(lambda: vb_dec(pts, dom))
    scale = float(gold.abs().max())
    atol = BRANCH_TOL["atol_rel_to_max"] * scale
    vs = {name: compare(g, gold, BRANCH_TOL["rtol"], atol)
          for name, g in (("tile_kernel", tiled), ("scatter", scatter),
                          ("vb_dec", dec))}
    same_tiled = bool(torch.equal(tiled, main["tiled"][inst.name]))
    row = {
        "instance": inst.name, "n": len(pts), "grid": list(dom.grid_shape),
        "kernel_evaluations": dom.grid_voxels * len(pts),
        "vb_s": vb_s, "vb_dec_s": vb_dec_s, "tile_branch_s": tiled_s,
        "scatter_branch_s": scatter_s,
        "tolerance": {"rtol": BRANCH_TOL["rtol"], "atol": atol,
                      "why": "fp32 sums of up to n terms per voxel in three "
                             "orders (vb's tree sums over point panels, the "
                             "kernel's point walk, the scatter's adds); the "
                             "bar that holds the two branches of stkde"},
        "vs_vb": vs,
        "worst_err_as_share_of_tolerance": max(
            v["worst_err_over_allowed"] for v in vs.values()),
        "tile_grid_same_as_main_path": same_tiled,
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "launches": launches,
    }
    verbatim = []
    kw = dict(ks=km.ks_paper_verbatim, kt=km.kt_paper_verbatim)
    for label, d, p in gold_cases():
        g = vb(p, d, **kw)
        r = compare(pb(p, d, variant="sym", **kw), g, **SMALL_TOL)
        r["vb_same_as_host"] = compare(
            g.cpu(), vb(p, d, device="cpu", **kw), **SMALL_TOL)
        r["label"] = label
        r["ok"] = r["ok"] and r["vb_same_as_host"]["ok"]
        verbatim.append(r)
    ok = (all(v["ok"] for v in vs.values()) and same_tiled and launches == 1
          and all(r["ok"] for r in verbatim)
          and tuple(gold.shape) == dom.grid_shape and gold.is_cuda
          and bool(torch.isfinite(gold).all())
          and not row["matmul_allow_tf32"])
    emit("gold", **row, paper_verbatim={"tolerance": SMALL_TOL,
                                        "cases": verbatim})
    if not ok:
        fail("gold: a grid disagrees with vb (see the gold line)")
    return launches


def scatter_launches() -> int:
    """Launches of the scatter kernel in this process so far: the port's
    registry counter ``stkde_scatter.launches``."""
    from repro_torch.kernels import stkde_scatter
    from repro_torch.obs import metrics

    return int(metrics.counter(stkde_scatter.LAUNCHES).value)


def phase_scatter() -> dict:
    """The PB-SYM scatter kernel (``csrc/stkde_scatter.cu``) at full-size
    ``PollenUS_Hr-Lb``: against the loop it replaced (``_scatter_loop``, run
    on the card) by the benchmark's ``grid_err`` measure, beside the limit
    of ``stkde_bench/limits/pollenus_hr.scatter_lb.json``, and so at
    full-size ``Dengue_Lr-Hb``, the main path's other shape; one launch and no
    host sync inside ``stkde.scatter`` in a query; the kernel's time beside
    the least time of ``stkde_bench/roofline.py`` and the loop's; ``dr`` on
    four shards of this card through the kernel against the single-device
    grid; and a hash of the chunked path's fixed-order grid, which the
    kernel leaves alone (the parent's bits)."""
    import hashlib
    import importlib

    from repro_torch.core import get_instance, stkde
    from repro_torch.core import kernels_math as km
    from repro_torch.distributed import make_host_mesh
    from repro_torch.obs import trace
    from stkde_bench import check, roofline
    from stkde_bench.reference.pbsym import Box

    pbm = importlib.import_module("repro_torch.core.pb")
    limit = json.loads((ROOT / "stkde_bench" / "limits"
                        / "pollenus_hr.scatter_lb.json").read_text())

    def on_card(name):
        inst = get_instance(name)
        dom, pts = inst.domain(), inst.points()
        return (inst, dom, pts, torch.from_numpy(pts).cuda(),
                Box(*dom.grid_shape, dom.sres, dom.tres, dom.hs, dom.ht))

    def kernel_of(dev_pts, dom):
        return lambda: pbm._pb_impl(dev_pts, dom, "sym", km.DEFAULT_KS,
                                    km.DEFAULT_KT, 1 << 22)

    def loop_of(dev_pts, dom):
        return lambda: pbm._scatter_loop(
            dev_pts, dom, "sym", km.DEFAULT_KS, km.DEFAULT_KT, 1 << 22,
            len(dev_pts), False, trace.OFF)

    def rel_err_in(box, n):
        def rel_err(got, want) -> float:
            """max |got - want| / max(|want|, tau): ``check.grid_err``'s
            measure, against a grid in place of the float64 reference."""
            tau = check.tau(box, n)
            return float(((got.double() - want.double()).abs()
                          / want.double().abs().clamp_min(tau)).max())
        return rel_err

    d_inst, d_dom, d_pts, d_dev, d_box = on_card("Dengue_Lr-Hb")
    d_before = scatter_launches()
    d_grid = kernel_of(d_dev, d_dom)()
    d_launches = scatter_launches() - d_before
    dengue = {"instance": d_inst.name, "n": len(d_pts),
              "grid": list(d_dom.grid_shape), "Hs": d_dom.Hs,
              "Ht": d_dom.Ht, "launches": d_launches,
              "kernel_vs_loop_rel_err": rel_err_in(d_box, len(d_pts))(
                  d_grid, loop_of(d_dev, d_dom)())}
    del d_grid, d_dev

    inst, dom, pts, dev_pts, box = on_card("PollenUS_Hr-Lb")
    n = len(pts)
    kernel, loop = kernel_of(dev_pts, dom), loop_of(dev_pts, dom)
    rel_err = rel_err_in(box, n)

    launches0 = scatter_launches()
    kernel_ms, grid = cuda_ms(kernel, warmup=2, runs=10)
    launches = scatter_launches() - launches0
    loop_ms, want = cuda_ms(loop, warmup=1, runs=2)
    again = kernel()
    least = roofline.least_time(pts, box, torch.cuda.get_device_name(0),
                                dev_pts.device)
    vs_loop = rel_err(grid, want)
    del want

    with traced():
        before = scatter_launches()
        query = stkde(pts, dom)
        query_launches = scatter_launches() - before
    (sp,) = trace.get_tracer().spans("stkde.scatter")
    (q,) = trace.get_tracer().spans("stkde.query")
    query_vs_kernel = rel_err(query, grid)
    del query

    before = scatter_launches()
    mesh = make_host_mesh(4, device="cuda")
    dr = stkde(pts, dom, mesh=mesh, strategy="dr")
    dr_launches = scatter_launches() - before
    dr_vs_single = rel_err(dr, grid)
    del dr

    fixed = fixed_order_scatter(dev_pts, dom)
    fixed_sha = hashlib.sha256(fixed.cpu().numpy().tobytes()).hexdigest()
    fixed_again = bool(torch.equal(fixed, fixed_order_scatter(dev_pts, dom)))
    del fixed

    row = {
        "instance": inst.name, "n": n, "grid": list(dom.grid_shape),
        "Hs": dom.Hs, "Ht": dom.Ht,
        "kernel_ms": kernel_ms, "loop_ms": loop_ms,
        "least_ms": None if least is None else 1e3 * least["seconds"],
        "least_time": least,
        "support_pairs_per_s": (None if least is None else
                                least["support_pairs"] / (kernel_ms / 1e3)),
        "launches_in_timing": launches, "timed_calls": 12,
        "kernel_vs_loop_rel_err": vs_loop,
        "two_launches_bit_identical": bool(torch.equal(grid, again)),
        "two_launches_rel_err": rel_err(again, grid),
        "limit": limit["grid_err"],
        "query": {"launches": query_launches, "path": sp.attrs.get("path"),
                  "span_launches": sp.attrs.get("launches"),
                  "scatter_syncs": sp.attrs.get("syncs"),
                  "query_syncs": q.attrs.get("syncs_total"),
                  "scatter_device_ms": sp.device_ms,
                  "vs_kernel_rel_err": query_vs_kernel},
        "dr_4_shards": {"launches": dr_launches,
                        "vs_single_rel_err": dr_vs_single},
        "fixed_order": {"sha256": fixed_sha, "bit_identical": fixed_again},
        "dengue": dengue,
    }
    ok = (launches == 12 and vs_loop <= limit["grid_err"]
          and d_launches == 1
          and dengue["kernel_vs_loop_rel_err"] <= limit["grid_err"]
          and row["two_launches_rel_err"] <= limit["grid_err"]
          and query_launches == 1 and sp.attrs.get("path") == "kernel"
          and sp.attrs.get("launches") == 1 and sp.attrs.get("syncs") == 0
          and query_vs_kernel <= limit["grid_err"]
          and dr_launches == 4 and dr_vs_single <= limit["grid_err"]
          and fixed_again and tuple(grid.shape) == dom.grid_shape
          and bool(torch.isfinite(grid).all()))
    emit("scatter", **row)
    if not ok:
        fail("scatter: a check failed (see the scatter line)")
    return row


def scatter_adding_with(pts: torch.Tensor, dom, add) -> torch.Tensor:
    """The PB-SYM scatter of ``core/pb.py``, built from its own pieces, with
    each block added by ``add(grid, lin, vals)``: the yardsticks for the
    fixed-order adds of the chunked path."""
    from repro_torch.core import kernels_math as km
    from repro_torch.core.pb import (_block_size, _cylinder_values,
                                     _padded_blocks)

    pts_b, vox_b = _padded_blocks(pts, dom, _block_size(dom, 1 << 22))
    grid = torch.zeros((dom.grid_voxels + 1,), dtype=torch.float32,
                       device=pts.device)
    for p, v in zip(pts_b, vox_b):
        lin, vals = _cylinder_values(p, v, dom, "sym", km.DEFAULT_KS,
                                     km.DEFAULT_KT, len(pts))
        add(grid, lin.reshape(-1), vals.reshape(-1))
    return grid[:-1].reshape(dom.grid_shape)


SCATTER_ADDS = {
    # PR 12's scatter: atomics, in an order that changes from run to run
    "atomic": lambda p, d: scatter_adding_with(
        p, d, lambda g, i, v: g.index_add_(0, i, v)),
    # PyTorch's sorted accumulation: fixed order, one thread a voxel's run
    "index_put": lambda p, d: scatter_adding_with(
        p, d, lambda g, i, v: g.index_put_((i,), v, accumulate=True)),
}


def fixed_order_scatter(pts: torch.Tensor, dom) -> torch.Tensor:
    """The PB-SYM scatter as the chunked path runs it (fixed-order adds)."""
    from repro_torch.core import kernels_math as km
    from repro_torch.core.pb import _pb_impl

    return _pb_impl(pts, dom, "sym", km.DEFAULT_KS, km.DEFAULT_KT, 1 << 22,
                    None, deterministic=True)


def tile_launches() -> int:
    """Launches of the tile kernel in this process so far: the port's
    registry counter ``stkde_tile.launches``."""
    from repro_torch.kernels import stkde_tile
    from repro_torch.obs import metrics

    return int(metrics.counter(stkde_tile.LAUNCHES).value)


@contextlib.contextmanager
def traced():
    """The port's tracer emptied and recording for the block, and off again
    after it (it records nothing by default); the spans stay to be read."""
    from repro_torch.obs import trace

    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.enable(False)


def chunk_split() -> list:
    """Per chunk, from the spans of the last chunked run: device compute,
    device-to-host copy, host float64 add, journal write (seconds). The
    caller ran it under ``traced()``."""
    from repro_torch.obs import trace

    rows = {}
    for name, key in (("chunk.device", "device_compute_s"),
                      ("chunk.d2h", "d2h_s"),
                      ("chunk.accumulate", "host_add_s"),
                      ("chunk.journal", "journal_write_s")):
        for sp in trace.get_tracer().spans(name):
            r = rows.setdefault(sp.attrs["chunk"], {"chunk": sp.attrs["chunk"]})
            r[key] = r.get(key, 0.0) + sp.duration_s
    return [rows[c] for c in sorted(rows)]


KILL_CODE = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core import get_instance
from repro_torch.core.api import stkde_chunked
from repro_torch.resilience import faults

inst = get_instance("PollenUS_Hr-Lb")
# delay-only fault widens the kill window without touching the math
faults.configure("stkde.chunk:delay:1.0:1.5", seed=0)
stkde_chunked(inst.points(), inst.domain(), chunk_size={chunk},
              journal={jdir!r})
print("DONE", flush=True)
"""


def sigkill_run(jdir: str, chunk: int) -> dict:
    """Run the journaled query in a child process on the card, SIGKILL it
    once the second chunk's snapshot has landed, and leave its journal."""
    import os
    import signal

    snap1 = os.path.join(jdir, "grid_00000001.npy")
    env = {k: v for k, v in os.environ.items() if k != "REPRO_FAULTS"}
    proc = subprocess.Popen(
        [sys.executable, "-c",
         KILL_CODE.format(src=str(ROOT / "src"), chunk=chunk, jdir=jdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if os.path.exists(snap1) or proc.poll() is not None:
                break
            time.sleep(0.02)
        alive = proc.poll() is None
        if alive:
            proc.send_signal(signal.SIGKILL)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    out, err = proc.communicate()
    return {"killed_while_running": alive, "rc": rc,
            "printed_done": "DONE" in out, "stderr_tail": err[-400:]}


def phase_chunked() -> dict:
    """``stkde_chunked`` on the card: at full-size ``PollenUS_Hr-Lb`` in 5
    chunks with a journal, bit-identical across two runs, partial + resume
    and SIGKILL + resume, and within tolerance of the monolithic grid; the
    scatter's fixed-order adds against the atomic ones; then the first
    chunks of ``eBird_Lr-Lb`` as a time-sliced stream."""
    import os
    import resource
    import tempfile

    from repro_torch.core import get_instance, stkde, stkde_chunked
    from repro_torch.data import stkde_stream

    inst = get_instance("PollenUS_Hr-Lb")
    dom, pts = inst.domain(), inst.points()
    chunk = 131072
    dev_pts = torch.from_numpy(pts).cuda()

    # fixed-order adds against atomics and index_put_, whole scatter, in
    # turns on one card
    fns = {**SCATTER_ADDS, "fixed_order": fixed_order_scatter}
    times = {name: [] for name in fns}
    grids = {name: [] for name in fns}
    for name in ("atomic", "fixed_order", "index_put", "index_put",
                 "fixed_order", "atomic"):
        g, sec = host_timed(lambda: fns[name](dev_pts, dom))
        times[name].append(sec)
        grids[name].append(g)
    tol = (BRANCH_TOL["rtol"], BRANCH_TOL["atol_rel_to_max"]
           * float(grids["atomic"][0].abs().max()))
    scatter = {
        **{f"{name}_s": t for name, t in times.items()},
        "cost_share": (statistics.mean(times["fixed_order"])
                       / statistics.mean(times["atomic"]) - 1.0),
        "index_put_cost_share": (statistics.mean(times["index_put"])
                                 / statistics.mean(times["atomic"]) - 1.0),
        **{f"{name}_bit_identical": bool(torch.equal(*g))
           for name, g in grids.items()},
        "fixed_vs_atomic": compare(grids["fixed_order"][0],
                                   grids["atomic"][0], *tol),
        "index_put_vs_atomic": compare(grids["index_put"][0],
                                       grids["atomic"][0], *tol),
    }
    del grids, dev_pts

    with tempfile.TemporaryDirectory(prefix="chip_smoke_journal_") as tmp:
        j1, j2, j3 = (os.path.join(tmp, d) for d in ("j1", "j2", "j3"))
        with traced():
            first, first_s = host_timed(
                lambda: stkde_chunked(pts, dom, chunk_size=chunk, journal=j1))
        split = chunk_split()
        snap_bytes = sorted(os.path.getsize(os.path.join(j1, f))
                            for f in os.listdir(j1) if f.startswith("grid_"))
        second, second_s = host_timed(
            lambda: stkde_chunked(pts, dom, chunk_size=chunk))
        part = stkde_chunked(pts, dom, chunk_size=chunk, journal=j2,
                             max_chunks=2)
        resumed = stkde_chunked(pts, dom, chunk_size=chunk, journal=j2,
                                resume=True)
        kill = sigkill_run(j3, chunk)
        after_kill = stkde_chunked(pts, dom, chunk_size=chunk, journal=j3,
                                   resume=True)
    mono, mono_s = host_timed(lambda: stkde(pts, dom))
    want = first.grid
    atol = BRANCH_TOL["atol_rel_to_max"] * float(np.abs(want).max())
    vs_mono = compare(torch.from_numpy(want), mono.cpu().double(),
                      BRANCH_TOL["rtol"], atol)
    pollen = {
        "instance": inst.name, "n": len(pts), "grid": list(dom.grid_shape),
        "chunk_size": chunk, "chunks": first.report["chunks_total"],
        "accumulator_bytes": int(want.nbytes),
        "snapshot_bytes": snap_bytes,
        "uninterrupted_s": [first_s, second_s],
        "monolithic_s": mono_s,
        "per_chunk": split,
        "two_runs_bit_identical": bool(np.array_equal(want, second.grid)),
        "partial": {k: part.report[k] for k in ("coverage", "truncated",
                                                 "chunks_computed")},
        "partial_resume_bit_identical": bool(
            np.array_equal(want, resumed.grid)),
        "resume_report": {k: resumed.report[k] for k in (
            "chunks_salvaged", "chunks_computed", "coverage")},
        "sigkill": {**kill, **{k: after_kill.report[k] for k in (
            "resumed", "chunks_salvaged", "chunks_computed")}},
        "sigkill_resume_bit_identical": bool(
            np.array_equal(want, after_kill.grid)),
        "vs_monolithic": vs_mono,
        "tolerance_vs_monolithic": {
            "rtol": BRANCH_TOL["rtol"], "atol": atol,
            "why": "float64 sum of five fp32 chunk grids against one fp32 "
                   "sum of every point"},
    }
    ok = (pollen["two_runs_bit_identical"]
          and pollen["partial_resume_bit_identical"]
          and pollen["sigkill_resume_bit_identical"]
          and kill["killed_while_running"] and kill["rc"] == -9
          and not kill["printed_done"]
          and after_kill.report["resumed"]
          and after_kill.report["chunks_salvaged"] >= 1
          and after_kill.report["chunks_computed"] >= 1
          and resumed.report["chunks_salvaged"] == 2
          and part.report["truncated"] and pollen["chunks"] == 5
          and vs_mono["ok"] and want.dtype == np.float64
          and scatter["fixed_order_bit_identical"]
          and scatter["fixed_vs_atomic"]["ok"]
          and scatter["index_put_vs_atomic"]["ok"])
    del first, second, part, resumed, after_kill, mono

    # eBird_Lr-Lb: the first three 1M-point chunks of the stream, no journal
    big = get_instance("eBird_Lr-Lb")
    bdom = big.domain()
    torch.cuda.reset_peak_memory_stats()
    with traced():
        res, stream_s = host_timed(lambda: stkde_chunked(
            stkde_stream(big, chunk=1_000_000), bdom, max_chunks=3))
    rep = res.report
    mass = float(res.grid.sum()) * bdom.sres ** 2 * bdom.tres
    ebird = {
        "instance": big.name, "n_total": rep["n_total"],
        "grid": list(bdom.grid_shape), "grid_voxels": bdom.grid_voxels,
        "chunk_grid_bytes_fp32": 4 * bdom.grid_voxels,
        "accumulator_bytes": int(res.grid.nbytes),
        "coverage": rep["coverage"], "chunks_computed": rep["chunks_computed"],
        "truncated": rep["truncated"], "seconds": stream_s,
        "per_chunk": chunk_split(),
        "mass": mass, "finite": bool(np.isfinite(res.grid).all()),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "peak_host_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
    }
    ok = (ok and rep["chunks_computed"] == 3 and rep["truncated"]
          and rep["coverage"] == 3_000_000 / big.n and ebird["finite"]
          and 0.0 < mass <= rep["coverage"] * 1.001
          and res.grid.shape == bdom.grid_shape)
    emit("chunked", scatter_accumulation=scatter, pollen=pollen,
         ebird_stream=ebird)
    if not ok:
        fail("chunked: a check failed (see the chunked line)")
    return {"scatter": scatter}


AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
# strategy -> the mesh it runs on here: (2, 2) or (2, 2, 2), all on one card
DIST_MESH = {"dr": 2, "dd": 2, "pd": 2, "pd_xt": 2, "dd_lpt": 2,
             "hybrid": 3, "pd_xyt": 3}


def mesh_fields(mesh) -> dict:
    return {"shape": list(mesh.devices.shape), "axes": list(mesh.axis_names),
            "devices": sorted({str(d) for d in mesh.devices.flat})}


def strategy_builds(strategy: str, pts: np.ndarray, dom, mesh):
    """``prepare_*`` of a strategy (host bucketing and the copy to the card)
    and a function ``build(collectives, deterministic)`` that runs its
    ``build_*`` on the prepared tensors. DD has no collectives, so no
    probe: ``build(False, ...)`` is None there."""
    from repro_torch.distributed import stkde_dist as sd

    n = len(pts)
    if strategy == "dr":
        args = (sd.prepare_dr(pts, dom, mesh, AXES2),)
        make = lambda c, d: sd.build_dr(dom, mesh, AXES2, n,  # noqa: E731
                                        collectives=c, deterministic=d)
    elif strategy == "dd":
        args = sd.prepare_dd(pts, dom, mesh, AXES2)
        make = lambda c, d: (sd.build_dd(  # noqa: E731
            dom, mesh, AXES2, n, deterministic=d) if c else None)
    elif strategy in ("pd", "pd_xt", "pd_xyt"):
        prep, build = {"pd": (sd.prepare_pd, sd.build_pd),
                       "pd_xt": (sd.prepare_pd_xt, sd.build_pd_xt),
                       "pd_xyt": (sd.prepare_pd_xyt, sd.build_pd_xyt)}[
                           strategy]
        axes = AXES3 if strategy == "pd_xyt" else AXES2
        args = prep(pts, dom, mesh, axes)
        make = lambda c, d: build(dom, mesh, axes, n,  # noqa: E731
                                  collectives=c, deterministic=d)
    elif strategy == "hybrid":
        args = sd.prepare_hybrid(pts, dom, mesh, AXES2, rep_axis="pod")
        make = lambda c, d: sd.build_pd(  # noqa: E731
            dom, mesh, AXES2, n, rep_axis="pod", collectives=c,
            deterministic=d)
    else:
        args, ctx = sd.prepare_dd_lpt(pts, dom, mesh, AXES2)
        make = lambda c, d: sd.build_dd_lpt(  # noqa: E731
            dom, mesh, AXES2, n, ctx["tile"], ctx["k"], ctx["cap"],
            ctx["ntiles"], collectives=c, deterministic=d)
    return args, make


def halo_split(strategy: str, dom, full: torch.Tensor,
               probe: torch.Tensor) -> dict:
    """The ``collectives=False`` probe against the full build: bit for bit
    equal away from the halo bands (hybrid: the rep partials added in the
    psum's order), and different inside them."""
    Hs, Ht = dom.Hs, dom.Ht
    if strategy == "hybrid":
        asm = probe[0].clone()
        for part in probe[1:]:
            asm += part
        probe = asm
    interior = {
        "pd": np.s_[:, :, Hs:-Hs, Hs:-Hs, :],
        "pd_xt": np.s_[:, :, Hs:-Hs, :, Ht:-Ht],
        "pd_xyt": np.s_[:, :, :, Hs:-Hs, Hs:-Hs, Ht:-Ht],
        "hybrid": np.s_[:, :, Hs:-Hs, Hs:-Hs, :],
    }[strategy]
    same = bool(torch.equal(full[interior], probe[interior]))
    differs = bool((full != probe).any())
    return {"interior_bit_identical": same, "bands_differ": differs,
            "cells_differing": int((full != probe).sum()),
            "ok": same and differs and full.shape == probe.shape}


def distributed_instance(inst, single: torch.Tensor) -> list:
    """Each strategy at one full-size instance: the query through ``stkde``
    twice (the second timed), its grid against the single-device query,
    then the time split by running ``prepare_*`` and the full and probe
    builds apart, and the halo-band check with fixed-order adds (atomics
    would change the last bits between the two builds)."""
    from repro_torch.core import stkde
    from repro_torch.distributed import make_host_mesh

    dom, pts = inst.domain(), inst.points()
    meshes = {2: make_host_mesh(4, device="cuda:0"),
              3: make_host_mesh(8, multi_pod=True, device="cuda:0")}
    atol = BRANCH_TOL["atol_rel_to_max"] * float(single.abs().max())
    rows = []
    for strategy, which in DIST_MESH.items():
        mesh = meshes[which]
        kw = dict(mesh=mesh, strategy=strategy,
                  rep_axis="pod" if which == 3 else None)
        _, first_s = host_timed(lambda: stkde(pts, dom, **kw))
        torch.cuda.reset_peak_memory_stats()
        grid, query_s = host_timed(lambda: stkde(pts, dom, **kw))
        peak = torch.cuda.max_memory_allocated()
        vs_single = compare(grid, single, BRANCH_TOL["rtol"], atol)
        del grid
        args, prep_s = host_timed(
            lambda: strategy_builds(strategy, pts, dom, mesh))
        args, make = args
        # full and probe builds in turns (full, probe, probe, full); dd has
        # no communication, so no probe: its builds are all full
        fns = {True: make(True, False), False: make(False, False)}
        times = {True: [], False: []}
        for collectives in (True, False, False, True):
            fn = fns[collectives] or fns[True]
            _, sec = host_timed(lambda: fn(*args))
            times[collectives if fns[collectives] else True].append(sec)
        full_s = statistics.mean(times[True])
        probe_s = statistics.mean(times[False]) if times[False] else full_s
        row = {"instance": inst.name, "strategy": strategy,
               "mesh": mesh_fields(mesh), "query_s": query_s,
               "first_call_s": first_s, "prepare_s": prep_s,
               "full_build_s": full_s, "shard_compute_s": probe_s,
               "collectives_s": full_s - probe_s,
               "full_build_runs_s": times[True],
               "probe_build_runs_s": times[False],
               "peak_device_bytes": peak, "vs_single_device": vs_single}
        ok = vs_single["ok"]
        if strategy in ("pd", "pd_xt", "pd_xyt", "hybrid"):
            full, probe = make(True, True)(*args), make(False, True)(*args)
            row["halo_bands"] = halo_split(strategy, dom, full, probe)
            ok = ok and row["halo_bands"]["ok"]
            del full, probe
        del args
        row["ok"] = ok
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def chunked_on_mesh(inst, single: torch.Tensor, chunk: int) -> list:
    """``stkde_chunked`` on a (2, 2) mesh with pd and dr: two runs, and a
    ``max_chunks=2`` run resumed, all bit for bit; within the bar of the
    single-device query."""
    import os
    import tempfile

    from repro_torch.core import stkde_chunked
    from repro_torch.distributed import make_host_mesh

    dom, pts = inst.domain(), inst.points()
    mesh = make_host_mesh(4, device="cuda:0")
    want = single.cpu().double()
    atol = BRANCH_TOL["atol_rel_to_max"] * float(want.abs().max())
    rows = []
    for strategy in ("pd", "dr"):
        kw = dict(mesh=mesh, strategy=strategy, chunk_size=chunk)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            jdir = os.path.join(tmp, "j")
            first, first_s = host_timed(lambda: stkde_chunked(pts, dom, **kw))
            second, second_s = host_timed(
                lambda: stkde_chunked(pts, dom, **kw))
            part = stkde_chunked(pts, dom, journal=jdir, max_chunks=2, **kw)
            resumed = stkde_chunked(pts, dom, journal=jdir, resume=True,
                                    **kw)
        row = {
            "instance": inst.name, "strategy": strategy,
            "mesh": mesh_fields(mesh), "chunk_size": chunk,
            "chunks": first.report["chunks_total"],
            "seconds": [first_s, second_s],
            "two_runs_bit_identical": bool(np.array_equal(first.grid,
                                                          second.grid)),
            "partial_truncated": part.report["truncated"],
            "resume_salvaged": resumed.report["chunks_salvaged"],
            "partial_resume_bit_identical": bool(
                np.array_equal(first.grid, resumed.grid)),
            "final_mesh": resumed.report["final_mesh"],
            "vs_single_device": compare(torch.from_numpy(first.grid), want,
                                        BRANCH_TOL["rtol"], atol),
        }
        row["ok"] = (row["two_runs_bit_identical"] and row["chunks"] == 5
                     and row["partial_truncated"]
                     and row["resume_salvaged"] == 2
                     and row["partial_resume_bit_identical"]
                     and row["final_mesh"] == [2, 2]
                     and row["vs_single_device"]["ok"])
        rows.append(row)
    return rows


def halo_faults(inst, single: torch.Tensor) -> dict:
    """``dist.halo`` faults (NaN poison, OOM at the build) reroute pd to dr
    on the same mesh; the counters read as the reference's."""
    from repro_torch.core import stkde
    from repro_torch.distributed import make_host_mesh
    from repro_torch.obs import metrics
    from repro_torch.resilience import faults

    dom, pts = inst.domain(), inst.points()
    mesh = make_host_mesh(4, device="cuda:0")
    atol = BRANCH_TOL["atol_rel_to_max"] * float(single.abs().max())
    metrics.reset()
    kinds = {}
    try:
        for kind in ("nan", "oom"):
            faults.configure(f"dist.halo:{kind}:1.0", seed=0)
            got = stkde(pts, dom, mesh=mesh, strategy="pd")
            kinds[kind] = compare(got, single, BRANCH_TOL["rtol"], atol)
    finally:
        faults.configure("", 0)
    c = metrics.export()["counters"]
    counters = {k: c.get(k, 0) for k in ("resilience.fallbacks",
                                         "resilience.fallbacks.stkde.pd")}
    ok = (all(v["ok"] for v in kinds.values())
          and counters == {"resilience.fallbacks": 2,
                           "resilience.fallbacks.stkde.pd": 2})
    return {"instance": inst.name, "mesh": mesh_fields(mesh),
            "vs_single_device": kinds, "counters": counters, "ok": ok}


def phase_distributed(dev: dict) -> int:
    """The seven strategies of ``repro_torch.distributed`` on meshes of
    shards that all sit on this card, at full-size ``PollenUS_Hr-Lb`` and
    ``Dengue_Lr-Hb``; chunked runs on a mesh; the ``dist.halo`` fallback.
    Returns the tile kernel's launches in this phase (the strategies run
    the PB-SYM scatter and, for DD-LPT, an einsum: none)."""
    from repro_torch.core import get_instance, stkde

    if torch.backends.cuda.matmul.allow_tf32:
        fail("distributed: TF32 matmuls are on; DD-LPT's einsum needs fp32")
    launches0 = tile_launches()
    rows, singles = [], {}
    for name in ("PollenUS_Hr-Lb", "Dengue_Lr-Hb"):
        inst = get_instance(name)
        pts, dom = inst.points(), inst.domain()
        stkde(pts, dom)
        single, single_s = host_timed(lambda: stkde(pts, dom))
        singles[name] = {"n": len(pts), "grid": list(dom.grid_shape),
                         "single_device_query_s": single_s}
        rows += distributed_instance(inst, single)
        if name == "PollenUS_Hr-Lb":
            chunked = chunked_on_mesh(inst, single, chunk=131072)
        else:
            fallback = halo_faults(inst, single)
        del single
    launches = tile_launches() - launches0
    emit("distributed", nvidia_smi=dev["nvidia_smi"], instances=singles,
         strategies=rows, chunked_on_mesh=chunked, halo_fallback=fallback,
         tolerance={"rtol": BRANCH_TOL["rtol"],
                    "atol_rel_to_max": BRANCH_TOL["atol_rel_to_max"],
                    "why": "fp32 sums in another order: shards' partial "
                           "grids, halo folds, the scatter's atomics"},
         tile_kernel_launches=launches)
    if not (all(r["ok"] for r in rows) and all(r["ok"] for r in chunked)
            and fallback["ok"]):
        fail("distributed: a check failed (see the distributed line)")
    return launches


# ------------------------------------------------------------ planner
# each reconcile row is the median of this many host-timed runs; measured by
# this phase on an NVIDIA H100 80GB HBM3 at 700 W, 5 cost 35.7 s more than
# 2, and 3 cost 15.0 s more (PERF.md §6)
RECONCILE_REPS = 3
CHUNK = 131072   # points per chunk of the chunked runs at PollenUS_Hr-Lb
# strategies a (2, 2) mesh can probe: pd_xyt and hybrid need a third axis
TWO_D = ("dr", "dd", "pd", "pd_xt", "dd_lpt")


def repredict(report: dict, mesh, dom, pts: np.ndarray, hw) -> dict:
    """Each strategy of a reconcile report priced again under ``hw``, with
    the same plan shape and loads that ``reconcile.run`` used."""
    from repro_torch.core import bucketing, plan
    from repro_torch.distributed import stkde_dist as sd
    from repro_torch.obs import reconcile

    wa, wb = mesh.axis_names[-2:]
    gx, gy = sd._device_grid_dims(dom, mesh.shape[wa], mesh.shape[wb])
    loads = bucketing.bucket_points_home(pts, dom, (gx, gy, dom.Gt)) \
        .counts.reshape(-1).astype(np.float64)
    out = {}
    for s in dict.fromkeys(r["strategy"] for r in report["rows"]):
        spec = reconcile.PROBED[s]
        shape = spec.plan_shape(mesh, spec.default_axes(mesh))
        out[s] = plan.estimate(dom, len(pts), shape, loads=loads, hw=hw)[s]
    return out


def planner_reconcile(inst) -> list:
    """``reconcile.run`` on the card under ``H100_SEED``: every strategy on a
    (2, 2, 2) mesh, the five 2-D ones on a (2, 2) mesh."""
    from repro_torch.core import plan
    from repro_torch.distributed import make_host_mesh
    from repro_torch.obs import reconcile

    dom, pts = inst.domain(), inst.points()
    reports = []
    for mesh, strategies in (
            (make_host_mesh(8, multi_pod=True, device="cuda:0"), None),
            (make_host_mesh(4, device="cuda:0"), TWO_D)):
        rep = reconcile.run(pts, dom, mesh, strategies=strategies,
                            reps=RECONCILE_REPS, hw=plan.H100_SEED)
        reports.append({"instance": inst.name, **rep})
        torch.cuda.empty_cache()
    return reports


def auto_query(inst, mesh, single: torch.Tensor) -> dict:
    """``stkde(points, dom, mesh=mesh)`` with the default ``auto``: the
    planner's pick and ranking, the query's seconds, and every candidate
    strategy's query seconds in the same run; the grid against the
    single-device query. The pick must be among the three fastest measured
    queries. DD-LPT's ``prepare`` (bucketing on the card, the host's LPT,
    one gather) is timed apart: the planner does not price it."""
    from repro_torch.core import plan, stkde
    from repro_torch.core.api import _auto_strategy, _home_loads, _plan_shape
    from repro_torch.distributed import stkde_dist as sd

    dom, pts = inst.domain(), inst.points()
    loads = _home_loads(pts, dom, mesh, AXES2)
    pick = _auto_strategy(dom, len(pts), mesh, AXES2, None, loads, plan.H100)
    _, table = plan.choose(dom, len(pts), _plan_shape(mesh, AXES2, None),
                           loads, hw=plan.H100)
    ranking = sorted((k for k, v in table.items() if v["feasible"] > 0),
                     key=lambda k: table[k]["total_s"])
    grid, auto_s = host_timed(lambda: stkde(pts, dom, mesh=mesh))
    atol = BRANCH_TOL["atol_rel_to_max"] * float(single.abs().max())
    vs_single = compare(grid, single, BRANCH_TOL["rtol"], atol)
    del grid
    measured = {}
    for s in TWO_D:
        _, measured[s] = host_timed(lambda: stkde(pts, dom, mesh=mesh,
                                                  strategy=s))
        torch.cuda.empty_cache()
    fastest = sorted(measured, key=measured.get)
    _, lpt_prepare_s = host_timed(
        lambda: sd.prepare_dd_lpt(pts, dom, mesh, AXES2))
    torch.cuda.empty_cache()
    in_three = pick in fastest[:3]
    return {"instance": inst.name, "n": len(pts), "mesh": mesh_fields(mesh),
            "pick": pick, "auto_query_s": auto_s,
            "predicted_ranking": ranking,
            "predicted_total_s": {k: table[k]["total_s"] for k in ranking},
            "measured_query_s": measured, "measured_ranking": fastest,
            "pick_in_measured_three_fastest": in_three,
            "dd_lpt_prepare_s": lpt_prepare_s,
            "vs_single_device": vs_single,
            "ok": vs_single["ok"] and in_three}


def recovering_chunked(inst, mesh, single: torch.Tensor) -> dict:
    """``stkde_chunked`` on ``mesh`` with dr while ``dist.device`` loses a
    device in 40% of the chunk calls (seed 3): the run shrinks the mesh,
    re-plans and finishes."""
    from repro_torch.core import stkde_chunked
    from repro_torch.obs import metrics
    from repro_torch.resilience import faults

    dom, pts = inst.domain(), inst.points()
    metrics.reset()
    faults.configure("dist.device:oom:0.4", seed=3)
    try:
        res, sec = host_timed(lambda: stkde_chunked(
            pts, dom, mesh=mesh, strategy="dr", chunk_size=CHUNK))
    finally:
        faults.configure("", 0)
    rec = res.report["recovery"]
    sizes = [int(np.prod(e["from_mesh"])) for e in rec]
    want = single.cpu().double()
    atol = BRANCH_TOL["atol_rel_to_max"] * float(want.abs().max())
    vs_single = compare(torch.from_numpy(res.grid), want, BRANCH_TOL["rtol"],
                        atol)
    c = metrics.export()["counters"]
    row = {"instance": inst.name, "mesh": mesh_fields(mesh),
           "chunk_size": CHUNK, "faults": "dist.device:oom:0.4 seed 3",
           "seconds": sec, "recovery": rec,
           "final_mesh": res.report["final_mesh"],
           "final_strategy": res.report["final_strategy"],
           "coverage": res.report["coverage"],
           "counters": {k: c.get(k, 0) for k in ("chunk.device_lost",
                                                 "chunk.replans")},
           "vs_single_device": vs_single}
    row["ok"] = (bool(rec) and all(e["event"] == "device_lost" for e in rec)
                 and rec[0]["from_mesh"] == [2, 2]
                 and sizes == sorted(sizes, reverse=True)
                 and len(set(sizes)) == len(sizes)
                 and res.report["coverage"] == 1.0
                 and row["counters"] == {"chunk.device_lost": len(rec),
                                         "chunk.replans": len(rec)}
                 and vs_single["ok"])
    return row


def phase_planner(dev: dict) -> int:
    """The planner on the card: reconcile rows under ``H100_SEED`` at
    full-size ``PollenUS_Hr-Lb`` on (2, 2, 2) and (2, 2); the re-fit against
    the committed ``H100``; ``stkde`` with ``auto`` at ``PollenUS_Hr-Lb``
    and ``Dengue_Lr-Hb``; a chunked run that loses devices. Returns the
    tile kernel's launches in this phase (none: the strategies scatter)."""
    from repro_torch.core import get_instance, plan, stkde
    from repro_torch.distributed import make_host_mesh

    t0 = time.perf_counter()
    launches0 = tile_launches()
    pollen = get_instance("PollenUS_Hr-Lb")
    reports = planner_reconcile(pollen)
    emit("planner_reconcile", reports=reports)
    fit = plan.calibrate_host(reports[0]["rows"], base=plan.H100_SEED)
    committed = plan.H100
    ratio = {k: getattr(fit, k) / getattr(committed, k)
             for k in ("peak_flops", "mxu_derate")}
    fit_ok = all(0.5 < r < 2.0 for r in ratio.values())

    dom, pts = pollen.domain(), pollen.points()
    m3 = make_host_mesh(8, multi_pod=True, device="cuda:0")
    m2 = make_host_mesh(4, device="cuda:0")
    under_h100 = []
    for rep, mesh in zip(reports, (m3, m2)):
        pred = repredict(rep, mesh, dom, pts, committed)
        measured = {(r["strategy"], r["term"]): r["measured_s"]
                    for r in rep["rows"]}
        under_h100.append({"mesh": rep["mesh"], "rows": [
            {"strategy": s, "term": t, "predicted_s": pred[s][t],
             "measured_s": measured[(s, t)],
             "rel_err": (measured[(s, t)] - pred[s][t])
             / max(abs(pred[s][t]), 1e-12)}
            for s in pred for t in ("init_s", "compute_s", "comm_s",
                                    "total_s")]})

    autos, chunked = [], None
    for name in ("PollenUS_Hr-Lb", "Dengue_Lr-Hb"):
        inst = get_instance(name)
        single = stkde(inst.points(), inst.domain())
        autos.append(auto_query(inst, m2, single))
        if name == "PollenUS_Hr-Lb":
            chunked = recovering_chunked(inst, m2, single)
        del single
        torch.cuda.empty_cache()
    launches = tile_launches() - launches0
    seconds = time.perf_counter() - t0
    emit("planner", nvidia_smi=dev["nvidia_smi"],
         h100=dataclasses.asdict(committed),
         refit_2x2x2=dataclasses.asdict(fit), refit_over_h100=ratio,
         refit_within_2x=fit_ok, predicted_with_h100=under_h100,
         auto=autos, chunked_device_loss=chunked,
         tile_kernel_launches=launches, seconds=seconds)
    if not (fit_ok and all(a["ok"] for a in autos) and chunked["ok"]):
        fail("planner: a check failed (see the planner line)")
    return launches


# ------------------------------------------------------------ degrade
def phase_degrade(dev: dict) -> int:
    """The degrade ladder with the tile kernel as the query: full-size
    ``Dengue_Lr-Hb`` clean (level 0) and after an injected OOM at level 0
    (level 1: voxels twice as large, half the points), each level's grid
    against the scatter of the same domain and points; then a partial
    answer from the journal of a chunked run cut after 2 chunks. Returns
    the tile kernel's launches in this phase."""
    import os
    import tempfile

    from repro_torch.core import get_instance, stkde, stkde_chunked
    from repro_torch.obs import metrics
    from repro_torch.resilience import (DegradePolicy, run_with_degrade,
                                        subsample_points)
    from repro_torch.resilience.errors import InjectedOOMError
    from repro_torch.serve import stkde_partial_answer

    inst = get_instance("Dengue_Lr-Hb")
    dom, pts = inst.domain(), inst.points()
    policy = DegradePolicy()
    calls = [0]

    def tiled(p, d):
        return stkde(p, d, use_tiled_kernel=True)

    def oom_at_level_0(p, d):
        calls[0] += 1
        if calls[0] == 1:
            raise InjectedOOMError("stkde")
        return tiled(p, d)

    metrics.reset()
    launches0 = tile_launches()
    clean, clean_s = host_timed(
        lambda: run_with_degrade(tiled, pts, dom, policy))
    degraded, degraded_s = host_timed(
        lambda: run_with_degrade(oom_at_level_0, pts, dom, policy))
    launches = tile_launches() - launches0
    counters = metrics.export()["counters"]
    levels = []
    for res, p, sec in (
            (clean, pts, clean_s),
            (degraded, subsample_points(pts, policy.subsample,
                                        seed=policy.seed + 1), degraded_s)):
        want = stkde(p, res.dom)
        atol = BRANCH_TOL["atol_rel_to_max"] * float(want.abs().max())
        levels.append({
            "level": res.level, "degraded": res.degraded,
            "reason": res.reason, "error_bound": res.error_bound,
            "n": len(p), "grid": list(res.dom.grid_shape),
            "sres": res.dom.sres, "tres": res.dom.tres, "seconds": sec,
            "shape_ok": tuple(res.grid.shape) == res.dom.grid_shape,
            "vs_scatter": compare(res.grid, want, BRANCH_TOL["rtol"], atol)})
    ladder_ok = (
        levels[0]["level"] == 0 and not levels[0]["degraded"]
        and levels[1]["level"] == 1 and levels[1]["degraded"]
        and levels[1]["reason"] == "L0:InjectedOOMError"
        and degraded.dom.sres == 2.0 * dom.sres
        and all(lv["shape_ok"] and lv["vs_scatter"]["ok"] for lv in levels)
        and counters.get("resilience.degraded", 0) == 1
        and launches == 2)
    del clean, degraded

    pollen = get_instance("PollenUS_Hr-Lb")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_partial_") as tmp:
        jdir = os.path.join(tmp, "j")
        part, part_s = host_timed(lambda: stkde_chunked(
            pollen.points(), pollen.domain(), chunk_size=CHUNK,
            journal=jdir, max_chunks=2))
        t0 = time.perf_counter()
        ans = stkde_partial_answer(jdir, rescale=False)
        answer_s = time.perf_counter() - t0
        scaled = stkde_partial_answer(jdir)
    partial = {
        "instance": pollen.name, "chunk_size": CHUNK,
        "chunks": ans.chunks, "coverage": ans.coverage,
        "run_coverage": part.report["coverage"],
        "chunked_run_s": part_s, "answer_s": answer_s,
        "bit_identical_to_accumulator": bool(np.array_equal(ans.grid,
                                                            part.grid)),
        "rescaled_equals_accumulator_over_coverage": bool(
            np.array_equal(scaled.grid, part.grid / ans.coverage)),
    }
    partial_ok = (partial["bit_identical_to_accumulator"]
                  and partial["rescaled_equals_accumulator_over_coverage"]
                  and ans.chunks == 2 and scaled.rescaled
                  and not ans.rescaled
                  and ans.coverage == part.report["coverage"]
                  == 2 * CHUNK / pollen.n)
    emit("degrade", nvidia_smi=dev["nvidia_smi"], instance=inst.name,
         levels=levels, counters={k: counters.get(k, 0) for k in (
             "resilience.degraded", "resilience.gave_up")},
         tolerance={"rtol": BRANCH_TOL["rtol"],
                    "atol_rel_to_max": BRANCH_TOL["atol_rel_to_max"],
                    "why": "tile kernel against the scatter: the bar that "
                           "holds the two branches of stkde"},
         tile_kernel_launches=launches, partial_answer=partial)
    if not (ladder_ok and partial_ok):
        fail("degrade: a check failed (see the degrade line)")
    return launches


# ------------------------------------------------------------ lm_serve
# fp32 on the card vs fp32 on the CPU, atol a share of the logits' largest
# magnitude: rwkv6 keeps its decay in fp32 by design, and 1-ulp differences
# of fp32 exp between the two devices reach its logits much amplified (the
# reduced rows' float64 fields show the gap that is left in float64)
LM_TOL = dict(rtol=1e-4, atol_rel_to_max=1e-5)
# bf16 decode_step vs bf16 forward, as a share of the forward logits' max:
# bf16 keeps 8 bits of mantissa, and the two paths round in other places
# over 32 layers
BF16_DECODE_BAR = 0.05
LM_PROMPTS = (64, 64, 64, 64, 128, 128, 128, 128)
LM_MAX_NEW = 32
LM_CONTINUOUS_MAX_NEW = (8, 32) * 4


def lm_inputs(cfg, B: int, S: int, seed: int):
    """Token ids and stub frontend embeddings from numpy, as tensors."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    kw = {}
    if cfg.frontend == "vision":
        kw["vision_embeds"] = torch.from_numpy((rng.normal(size=(
            B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.enc_dec:
        kw["audio_frames"] = torch.from_numpy((rng.normal(size=(
            B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32))
    return toks, kw


def reduced_on_card() -> list:
    """Each of the ten ``reduced`` configs, fp32, with the same seeded
    weights on the card and on the CPU: forward logits, prefill logits and
    two decode steps' logits on the card against the CPU's; beside them,
    the forward's distance between the devices in float64 and of each
    device's fp32 from the CPU's float64."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.models.transformer import tree_map

    rows = []
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        cpu_params = init_params(cfg, device="cpu", seed=0)
        card_params = tree_map(lambda a: a.cuda(), cpu_params)
        toks, kw = lm_inputs(cfg, 2, 16, seed=1)
        out = {}
        for where, params in (("cpu", cpu_params), ("cuda", card_params)):
            t = toks.to(where)
            k = {a: v.to(where) for a, v in kw.items()}
            with torch.inference_mode():
                logits, _ = forward(cfg, params, t, **k)
                pl, state = prefill(cfg, params, t[:, :12], max_seq=32, **k)
                steps = []
                for i in (12, 13):
                    lg, state = decode_step(cfg, params, t[:, i:i + 1],
                                            state)
                    steps.append(lg)
            out[where] = [logits, pl] + steps
        cmp = [compare(g.cpu(), w, LM_TOL["rtol"],
                       LM_TOL["atol_rel_to_max"] * float(w.abs().max()))
               for g, w in zip(out["cuda"], out["cpu"])]
        # the forward again in float64 (the ops the model keeps in fp32 by
        # design stay fp32): how far the two devices' arithmetic alone
        # moves the logits, and how far fp32 is from float64 on the CPU
        f64 = {}
        cfg64 = cfg.replace(compute_dtype="float64")
        for where, params in (("cpu", cpu_params), ("cuda", card_params)):
            p64 = tree_map(lambda a: a.double(), params)
            k = {a: v.to(where, torch.float64) for a, v in kw.items()}
            with torch.inference_mode():
                f64[where] = forward(cfg64, p64, toks.to(where), **k)[0] \
                    .cpu()
        rows.append({"arch": cfg.name,
                     "forward": cmp[0], "prefill": cmp[1],
                     "decode": cmp[2:],
                     "forward_float64_card_vs_cpu_max_abs": float(
                         (f64["cuda"] - f64["cpu"]).abs().max()),
                     "forward_fp32_card_vs_cpu_float64_max_abs": float(
                         (out["cuda"][0].cpu().double() - f64["cpu"])
                         .abs().max()),
                     "forward_fp32_cpu_vs_cpu_float64_max_abs": float(
                         (out["cpu"][0].double() - f64["cpu"]).abs().max()),
                     "finite": all(bool(torch.isfinite(g).all())
                                   for g in out["cuda"]),
                     "ok": all(c["ok"] for c in cmp)})
    return rows


def teacher_forced_check(cfg, params, prompts, results) -> dict:
    """Each request's tokens against the argmax of one ``forward`` over its
    prompt and its generated tokens (all but the last)."""
    from repro_torch.models import forward

    agree, total, worst = 0, 0, []
    for uid, prompt in enumerate(prompts):
        gen = results[uid].tokens
        seq = torch.from_numpy(np.concatenate([prompt, gen[:-1]])
                               .astype(np.int64))[None].cuda()
        with torch.inference_mode():
            logits, _ = forward(cfg, params, seq)
        want = logits[0, len(prompt) - 1:].argmax(-1).cpu().numpy()
        agree += int((want == gen).sum())
        total += len(gen)
        if not np.array_equal(want, gen):
            worst.append(uid)
    return {"tokens": total, "agree": agree, "requests_differing": worst,
            "ok": agree == total}


def decode_vs_forward(cfg, params, prompt: np.ndarray, steps: int) -> dict:
    """Prefill the prompt's first tokens, decode the rest teacher-forced:
    the largest logits difference against ``forward`` over the whole
    prompt, and as a share of the forward logits' largest magnitude."""
    from repro_torch.models import decode_step, forward, prefill

    toks = torch.from_numpy(prompt.astype(np.int64))[None].cuda()
    S0 = len(prompt) - steps
    with torch.inference_mode():
        logits, _ = forward(cfg, params, toks)
        _, state = prefill(cfg, params, toks[:, :S0], max_seq=len(prompt))
        err = 0.0
        for t in range(S0, len(prompt)):
            lg, state = decode_step(cfg, params, toks[:, t:t + 1], state)
            err = max(err, float((lg[0, 0] - logits[0, t]).abs().max()))
    scale = float(logits[0, S0:].abs().max())
    return {"steps": steps, "max_abs_err": err, "logits_max_abs": scale,
            "share": err / scale}


def serve_smollm(cfg, params, prompts) -> dict:
    """The bucketed engine on the card: 8 greedy requests in two buckets of
    4, ``max_new`` tokens each; its stats and the port's serve gauges."""
    from repro_torch.obs import metrics
    from repro_torch.serve import EngineConfig, ServingEngine

    metrics.reset()
    eng = ServingEngine(cfg, params, EngineConfig(
        continuous_batching=False, max_batch=4, max_seq=256))
    for uid, p in enumerate(prompts):
        eng.submit(uid, p, max_new=LM_MAX_NEW)
    t0 = time.perf_counter()
    results = eng.run_detailed()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g = metrics.export()["gauges"]
    st = eng.last_stats
    return {"results": results, "fields": {
        "compute_dtype": cfg.compute_dtype, "wall_s": wall,
        "n_tokens": st["n_tokens"], "decode_steps": st["decode_steps"],
        "decode_s": st["decode_s"],
        "serve.tokens_per_s": g.get("serve.tokens_per_s"),
        "serve.decode_tokens_per_s": g.get("serve.decode_tokens_per_s"),
        "all_ok": all(r.ok and not r.degraded for r in results.values()),
        "all_full_length": all(len(r.tokens) == LM_MAX_NEW
                               for r in results.values())}}


def serve_continuous(cfg, params, prompts, max_new) -> dict:
    """``prompts`` through the engine on the card twice, bucketed and
    slot-swap continuous (``max_batch`` 4, ``max_seq`` 256), request ``uid``
    asking for ``max_new[uid]`` tokens: each path's tokens, stats and serve
    gauges, and whether the greedy tokens agree for every uid."""
    from repro_torch.obs import metrics
    from repro_torch.serve import EngineConfig, ServingEngine

    out = {}
    for path in ("bucketed", "continuous"):
        metrics.reset()
        eng = ServingEngine(cfg, params, EngineConfig(
            continuous_batching=path == "continuous", max_batch=4,
            max_seq=256))
        for uid, p in enumerate(prompts):
            eng.submit(uid, p, max_new=max_new[uid])
        t0 = time.perf_counter()
        results = eng.run_detailed()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = metrics.export()["gauges"]
        st = eng.last_stats
        out[path] = {
            "tokens": {u: r.tokens.tolist() for u, r in results.items()},
            "fields": {
                "mode": st["mode"], "wall_s": wall,
                "n_tokens": st["n_tokens"],
                "decode_steps": st["decode_steps"], "swaps": st["swaps"],
                "serve.tokens_per_s": g.get("serve.tokens_per_s"),
                "serve.decode_tokens_per_s": g.get(
                    "serve.decode_tokens_per_s"),
                # the gauge holds the last loop's value (0 once the queue
                # has drained); the mean over decode steps is beside it
                "serve.slot_occupancy": g.get("serve.slot_occupancy"),
                "mean_slot_occupancy": (st["active_slot_steps"]
                                        / max(st["slot_steps"], 1)),
                "serve.slot_idle_frac": g.get("serve.slot_idle_frac"),
                "all_ok": all(r.ok and not r.degraded
                              for r in results.values())}}
    b, c = out["bucketed"]["tokens"], out["continuous"]["tokens"]
    return {"bucketed": out["bucketed"]["fields"],
            "continuous": out["continuous"]["fields"],
            "uids_differing": sorted(u for u in b if b[u] != c.get(u)),
            "tokens_equal": b == c}


def reduced_continuous_on_card() -> list:
    """The ``reduced`` MLA (deepseek-v2-lite) and rwkv6 configs served
    continuous and bucketed on the card, 8 mixed-length requests. The MoE
    of the MLA config runs with a capacity that drops no token: the capacity
    depends on how many tokens share a call, so a prompt prefilled alone
    and in a bucket may otherwise drop different ones (ROADMAP §C.4)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import init_params

    rows = []
    for name in ("deepseek-v2-lite-16b", "rwkv6-3b"):
        cfg = reduced(ARCHS[name])
        if cfg.mlp == "moe":
            cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
        params = init_params(cfg, device="cuda", seed=0)
        rng = np.random.default_rng(0)
        lens = [8, 12, 8, 16, 12, 9, 8, 16]
        prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
        res = serve_continuous(cfg, params, prompts,
                               [3 + (u % 3) * 3 for u in range(8)])
        rows.append({"arch": cfg.name,
                     "capacity_factor": cfg.capacity_factor,
                     "swaps": res["continuous"]["swaps"],
                     "tokens_equal": res["tokens_equal"],
                     "uids_differing": res["uids_differing"],
                     "ok": (res["tokens_equal"]
                            and res["continuous"]["all_ok"])})
    return rows


def phase_lm_serve(dev: dict) -> None:
    """The language-model stack on the card (no kernel of its own: the
    reference's attention is jnp, ported as plain ops). The ten ``reduced``
    configs against the CPU; then ``smollm-360m`` at full width and depth
    (seeded weights, 1.45 GB fp32) through the bucketed ``ServingEngine``:
    8 greedy requests (4 of 64 tokens, 4 of 128), 32 new tokens each, once
    in fp32 (every token the argmax of a teacher-forced ``forward``) and
    once in the config's bf16 (``decode_step`` against ``forward``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import leaves

    t0 = time.perf_counter()
    reduced_rows = reduced_on_card()
    t_reduced = time.perf_counter() - t0

    full = get_arch("smollm-360m")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(full, device="cuda", seed=0)
    param_bytes = sum(a.nbytes for a in leaves(params))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, full.vocab, n) for n in LM_PROMPTS]
    runs = {}
    for dtype in ("float32", full.compute_dtype):
        cfg = full.replace(compute_dtype=dtype)
        served = serve_smollm(cfg, params, prompts)
        fields = served["fields"]
        if dtype == "float32":
            fields["teacher_forced"] = teacher_forced_check(
                cfg, params, prompts, served["results"])
        fields["decode_vs_forward"] = decode_vs_forward(
            cfg, params, prompts[-1], steps=16)
        runs[dtype] = fields
    peak = torch.cuda.max_memory_allocated()
    # slot-swap continuous batching: the same prompts, max_new alternating
    # 8 and 32 so that slots free up mid-decode, against the bucketed path
    t_cont = time.perf_counter()
    cont = serve_continuous(full.replace(compute_dtype="float32"), params,
                            prompts, LM_CONTINUOUS_MAX_NEW)
    del params
    torch.cuda.empty_cache()
    cont["reduced"] = reduced_continuous_on_card()
    cont["seconds"] = time.perf_counter() - t_cont
    seconds = time.perf_counter() - t0
    fp32, bf16 = runs["float32"], runs[full.compute_dtype]
    ok = (all(r["ok"] and r["finite"] for r in reduced_rows)
          and all(r["all_ok"] and r["all_full_length"] for r in runs.values())
          and fp32["teacher_forced"]["ok"]
          and fp32["decode_vs_forward"]["max_abs_err"] < 5e-3
          and bf16["decode_vs_forward"]["share"] < BF16_DECODE_BAR
          and cont["tokens_equal"] and cont["continuous"]["swaps"] > 0
          and cont["continuous"]["all_ok"] and cont["bucketed"]["all_ok"]
          and all(r["ok"] for r in cont["reduced"]))
    emit("lm_serve", nvidia_smi=dev["nvidia_smi"], reduced=reduced_rows,
         reduced_tolerance={**LM_TOL, "why": "fp32 on the card against "
                            "fp32 on the CPU, same weights; atol a share of "
                            "the logits' largest magnitude (rwkv6's fp32 "
                            "decay amplifies 1-ulp differences)"},
         reduced_s=t_reduced,
         smollm={"arch": full.name, "n_layers": full.n_layers,
                 "d_model": full.d_model, "n_heads": full.n_heads,
                 "n_kv_heads": full.n_kv_heads, "d_ff": full.d_ff,
                 "vocab": full.vocab, "param_bytes": param_bytes,
                 "prompts": list(LM_PROMPTS), "max_new": LM_MAX_NEW,
                 "max_batch": 4, "max_seq": 256,
                 "peak_device_bytes": peak, "runs": runs,
                 "bars": {"fp32_decode_vs_forward_abs": 5e-3,
                          "bf16_decode_vs_forward_share":
                              BF16_DECODE_BAR}},
         continuous={**cont, "max_new": list(LM_CONTINUOUS_MAX_NEW)},
         seconds=seconds)
    if not ok:
        fail("lm_serve: a check failed (see the lm_serve line)")


# ------------------------------------------------------------ lm_train
# one train step, card against CPU, same weights and batch: fp32 with TF32
# off on both (PyTorch's default), so only the order of additions differs
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
# updated parameters, as a share of the step's learning rate: Adam's first
# step moves an element by lr * g / (|g| + eps), so a rounding difference
# that flips the sign of a gradient element a few ulps from zero moves it by
# up to 2 lr; the bar admits a quarter of that
TRAIN_PARAM_ATOL_LR = 0.5
# the resumed run's step-20 loss against the uninterrupted run's: both start
# step 11 from the same bits, but the card adds the embedding's gradient with
# atomics, so the runs may part in the last bits (compared, not assumed)
RESUME_LOSS_RTOL = 1e-3
TRAIN_ARGS = ["--arch", "smollm-360m", "--steps", "20", "--batch", "8",
              "--seq", "256", "--ckpt-every", "10"]
# (b)'s depth: smollm-360m's 32 blocks cut to 4 (its widths kept; 86.5 M
# parameters, a 1.04 GB checkpoint) for the script's time cap (8 until the
# sharded steps gathered a layer at a time, which lengthened lm_sharded)
TRAIN_LAYERS = 4


def train_batch(cfg, seed: int, batch: int = 2, seq: int = 16) -> dict:
    """A ``SyntheticLM`` batch (and stub frontend inputs) as CPU tensors."""
    from repro_torch.data import DataConfig, SyntheticLM

    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch)).batch_at(seed)
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    _, kw = lm_inputs(cfg, batch, seq, seed)
    return {**out, **kw}


def reduced_train_on_card() -> list:
    """One ``make_train_step`` step of each of the ten ``reduced`` configs on
    the card and on the CPU, from the same seeded weights and batch."""
    import math

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import init_params
    from repro_torch.models.transformer import leaves, tree_map
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt

    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    lr = float(opt.lr_at(ocfg, 1))
    rows = []
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        step = make_train_step(cfg, ocfg)
        cpu_params = init_params(cfg, device="cpu", seed=0)
        b = train_batch(cfg, seed=0)
        out = {}
        for where in ("cpu", "cuda"):
            params = tree_map(lambda a: a.to(where), cpu_params)
            p, _, m = step(params, opt.init(params),
                           {k: v.to(where) for k, v in b.items()})
            out[where] = (p, {k: float(v) for k, v in m.items()})
        (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
        dp = max(float((a.cpu() - c).abs().max())
                 for a, c in zip(leaves(pg), leaves(pc)))
        loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
        gn_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
        rows.append({"arch": cfg.name, "loss_cpu": mc["loss"],
                     "loss_card": mg["loss"], "loss_rel_err": loss_rel,
                     "grad_norm_rel_err": gn_rel,
                     "params_max_abs_over_lr": dp / lr,
                     "ok": (loss_rel <= TRAIN_LOSS_RTOL
                            and gn_rel <= TRAIN_GNORM_RTOL
                            and dp <= TRAIN_PARAM_ATOL_LR * lr
                            and math.isfinite(mg["loss"]))})
    return rows


CKPT_SPANS = ("ckpt.save", "ckpt.snapshot", "ckpt.serialize", "ckpt.write",
              "ckpt.verify", "ckpt.restore", "ckpt.decode", "ckpt.place")


def train_spans() -> dict:
    """The ``train.step`` spans (step, loss, seconds) and the checkpoint
    spans the port's tracer holds (seconds, on the writer thread or not),
    then clears the tracer. The caller has turned the tracer on."""
    from repro_torch.obs import trace

    tr = trace.get_tracer()
    main = threading.main_thread().ident
    steps = [(int(sp.attrs["step"]), sp.attrs.get("loss"), sp.duration_s)
             for sp in tr.spans("train.step")]
    ckpt = {name: [{"s": sp.duration_s, "async": sp.tid != main,
                    **{k: v for k, v in sp.attrs.items() if k == "step"}}
                   for sp in tr.spans(name)] for name in CKPT_SPANS}
    trace.reset()
    return {"steps": steps, "ckpt": ckpt}


def restored_bits_equal(tree, ckpt_dir: str, step: int) -> dict:
    """A restored ``tree`` against the arrays checkpoint ``step``'s
    ``.npz`` holds, bit for bit, leaf by leaf; and whether every leaf is on
    the card."""
    from repro_torch.train import checkpoint

    flat = checkpoint._flatten(tree)
    path = str(pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz")
    saved = checkpoint._npz_arrays(path, checkpoint._read(path),
                                   check_members=False)
    equal, on_card = 0, 0
    for k, t in flat.items():
        on_card += int(t.is_cuda)
        want = torch.from_numpy(saved[k.replace("/", "__")]).to(t.device)
        equal += int(t.dtype == want.dtype and torch.equal(t, want))
    return {"leaves": len(flat), "bit_equal": equal, "on_card": on_card,
            "ok": equal == on_card == len(flat)}


def phase_lm_train(dev: dict) -> float:
    """Training on the card (no kernel of its own: plain ops and
    ``torch.autograd``). (a) One step of each ``reduced`` config, card
    against CPU. (b) ``smollm-360m`` at full width, its depth cut to
    ``TRAIN_LAYERS``, through ``repro_torch.launch.train.main``: 20 steps of 8 x 256 tokens of
    ``SyntheticLM``, async checkpoints every 10 steps into a temporary
    directory (removed after). (c) The step-20 checkpoint removed, as if
    the run had died after step 10: a fresh ``TrainRunner`` from
    ``launch.train.make_runner`` (what ``main`` runs) resumes from step 10,
    its restored state is held bit for bit against the checkpoint's
    arrays, and it runs to 20; its step-20 loss against (b)'s."""
    import gc
    import math
    import os
    import shutil
    import tempfile

    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    cfg = ARCHS["smollm-360m"].replace(n_layers=TRAIN_LAYERS)
    reduced_rows = reduced_train_on_card()
    t_reduced = time.perf_counter() - t0

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        argv = TRAIN_ARGS + ["--ckpt-dir", ckpt_dir]
        trace.reset()
        trace.enable()   # train_spans reads the steps' and checkpoints' spans
        gc.collect()
        held_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        summary = launch_train.main(argv, cfg)
        t_full = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        run = train_spans()
        losses = [loss for _, loss, _ in run["steps"]]
        step_s = [d for _, _, d in run["steps"]]
        med = statistics.median(step_s[1:])
        saved = sorted(os.listdir(ckpt_dir))
        step10 = next(sv["s"] for sv in run["ckpt"]["ckpt.save"]
                      if sv["step"] == 10)
        ckpt_bytes = (pathlib.Path(ckpt_dir) / "step_00000010"
                      / "arrays.npz").stat().st_size

        # (c) kill after step 10 and resume
        t2 = time.perf_counter()
        shutil.rmtree(os.path.join(ckpt_dir, "step_00000020"))
        runner, batches = launch_train.make_runner(argv, cfg)
        restored = {"step": runner.step, **restored_bits_equal(
            (runner.params, runner.opt_state), ckpt_dir, 10)}
        resumed = runner.run(batches)
        t_resume = time.perf_counter() - t2
        rerun = train_spans()
    finally:
        trace.enable(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, last = losses[0], losses[-1]
    resume_diff = abs(resumed["last_loss"] - last)
    full = {"args": TRAIN_ARGS,
            "reduced": {"n_layers": [ARCHS["smollm-360m"].n_layers,
                                     cfg.n_layers],
                        "why": "depth only, for the script's time cap"},
            "steps": len(losses), "losses": losses,
            "first_loss": first, "last_loss": last,
            "ln_vocab": math.log(49152),
            "ms_per_step_median_steps_2_20": med * 1e3,
            # steps 11-20 share the host with the step-10 checkpoint's
            # writer thread; steps 2-10 have it to themselves
            "ms_per_step_median_steps_2_10": statistics.median(
                step_s[1:10]) * 1e3,
            "step_ms": [d * 1e3 for d in step_s],
            "tokens_per_s": 8 * 256 / med,
            "peak_device_bytes": peak,
            "device_bytes_held_before": held_before,
            "ckpt_async_write_s_step_10": step10,
            "ckpt_spans": run["ckpt"], "ckpt_bytes": ckpt_bytes,
            "checkpoints_on_disk": saved, "summary": summary,
            "seconds": t_full}
    resume = {"restored_step_10": restored,
              "resumed_steps": [s for s, _, _ in rerun["steps"]],
              "resumed_last_loss": resumed["last_loss"],
              "uninterrupted_last_loss": last,
              "abs_diff": resume_diff,
              "bit_identical": resumed["last_loss"] == last,
              "rtol": RESUME_LOSS_RTOL,
              "ckpt_spans": rerun["ckpt"], "seconds": t_resume}
    ok = (all(r["ok"] for r in reduced_rows)
          and len(losses) == 20 and all(math.isfinite(v) for v in losses)
          and abs(first - math.log(49152)) <= 0.5 and last < first
          and summary["final_step"] == 20
          and saved == ["step_00000010", "step_00000020"]
          and restored["ok"] and restored["step"] == 10
          and resume["resumed_steps"] == list(range(10, 20))
          and resumed["final_step"] == 20
          and resume_diff <= RESUME_LOSS_RTOL * abs(last))
    worst = {k: max(r[k] for r in reduced_rows)
             for k in ("loss_rel_err", "grad_norm_rel_err",
                       "params_max_abs_over_lr")}
    emit("lm_train", nvidia_smi=dev["nvidia_smi"], reduced=reduced_rows,
         reduced_worst=worst,
         reduced_tolerance={"loss_rtol": TRAIN_LOSS_RTOL,
                            "grad_norm_rtol": TRAIN_GNORM_RTOL,
                            "params_atol_over_lr": TRAIN_PARAM_ATOL_LR},
         reduced_s=t_reduced, smollm=full, resume=resume,
         seconds=time.perf_counter() - t0)
    if not ok:
        fail("lm_train: a check failed (see the lm_train line)")
    return med * 1e3


# ------------------------------------------------------------ lm_sharded
# a2a against moe_apply on the card, same weights and input: fp32, TF32 off
A2A_TOL = dict(rtol=1e-5, atol_rel_to_max=1e-6)
# deepseek-v2-lite-16b's MoE layer at its published widths, one (4, 512)
# batch over a (1, 8) ("data", "model") mesh: 8 local experts per rank
A2A_ARCH = "deepseek-v2-lite-16b"
A2A_X = (4, 512)
A2A_MESH = (1, 8)
# sharded training: the step-1 loss and grad norm, the parameters after one
# step (as a share of its lr), the three losses
SHARDED_LOSS_RTOL = 1e-5
SHARDED_GNORM_RTOL = 1e-4
SHARDED_PARAM_ATOL_LR = 0.5
SHARDED_LOSSES_RTOL = 1e-3
SHARDED_STEPS = 3
SHARDED_TIMED = 3     # more steps of each path, timed only
GC_SHARDS = 4
# MoE training on (2, 2) (the same bars as SHARDED_*): deepseek-v2-lite-16b
# at its published widths, its depth cut to the first (dense) layer and one
# MoE layer, one (4, 512) batch
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_LAYERS = 2
MOE_BATCH = (4, 512)
MOE_MESH = (2, 2)
# (g) tensor parallelism with whole heads: mistral-nemo-12b at its
# published widths, depth cut to 2 layers (1.887 B parameters: each path's
# fp32 state 22.6 GB; the paths run one after the other), fp32 compute
TP_ARCH = "mistral-nemo-12b"
TP_LAYERS = 2
TP_BATCH = (4, 256)
TP_MESH = (2, 2)
# the sharded steps' peaks on "NVIDIA H100 80GB HBM3, 700.00 W" when each
# position gathered every layer's pieces before its forward and held their
# gradients to the end of the step, printed beside the layer-by-layer
# step's: (d)'s step_peak_extra_bytes_sharded, (f)'s and (g)'s
# peak_device_bytes_sharded
GATHER_ALL_PEAKS = {"train": 6_062_826_496, "moe_train": 54_522_934_272,
                    "tp_train": 64_764_169_216}


def alloc_retries() -> int:
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def alloc_figures(r0: int) -> dict:
    """The caching allocator since ``r0 = alloc_retries()``: its retries
    (a failed ``cudaMalloc`` that frees the cache, synchronises and tries
    again) and the most it has reserved since the last peak reset."""
    return {"alloc_retries": alloc_retries() - r0,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}


def grad_peak_extra(vag, p, b) -> int:
    """The bytes one call of a sharded value-and-grad adds to what is
    allocated (the phase that gathers and cuts the layers; the update's
    new state comes after it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = vag(p, b)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - held


def card_mesh(shape, names) -> "object":
    """A mesh whose every position is the one card."""
    from repro_torch.distributed import Mesh

    return Mesh(np.full(shape, "cuda", dtype=object), names)


def specs_at_full_size() -> dict:
    """(a) ``param_specs`` over ``param_specs_abstract`` (meta tensors) of
    the ten configs on both production meshes: every sharded axis divides
    its dimension; counts of leaves, sharded leaves and axes used."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import make_production_mesh, specs

    t0 = time.perf_counter()
    rows, bad = {}, []
    trees = {n: specs.param_specs_abstract(ARCHS[n]) for n in sorted(ARCHS)}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
        tag = "x".join(str(v) for v in mesh.shape.values())
        for name, tree in trees.items():
            flat = {}

            def walk(t, s, path=""):
                if isinstance(t, dict):
                    for k in t:
                        walk(t[k], s[k], f"{path}{k}/")
                else:
                    flat[path[:-1]] = (t, s)

            walk(tree, sh.param_specs(tree, mesh, fsdp=True))
            n_split, pieces = 0, 0
            for path, (arr, spec) in flat.items():
                for i, ax in enumerate(spec):
                    size = int(np.prod([mesh.shape[a]
                                        for a in sh.P.axes_of(ax)]))
                    if arr.shape[i] % size:
                        bad.append((tag, name, path))
                n = int(np.prod([mesh.shape[a] for a in spec.mesh_axes()]))
                n_split += n > 1
                pieces += n
            rows.setdefault(name, {})[tag] = {
                "leaves": len(flat), "sharded_leaves": n_split,
                "pieces": pieces,
                "params": int(sum(a.numel() for a, _ in flat.values()))}
    return {"rows": rows, "not_dividing": bad, "ok": not bad,
            "seconds": time.perf_counter() - t0}


def moe_drops(cfg, p, x, mesh=None) -> int:
    """(token, slot) pairs the layer drops: ``moe_apply``'s per-expert
    capacity, or, with ``mesh``, ``moe_apply_a2a``'s per-rank one."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    T, D = x.shape[0] * x.shape[1], x.shape[2]
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)
    with torch.no_grad():
        if mesh is None:
            _, _, idx = moe._route(xt, p["router"], K)
            keep, _ = moe._slots(idx.reshape(-1), E,
                                 moe._capacity(T, cfg, E))
            return int((~keep).sum())
        M = mesh.shape[sh.TP]
        T2 = T // M       # one batch shard on the (1, M) mesh
        drops = 0
        for m in range(M):
            _, _, idx = moe._route(xt[m * T2:(m + 1) * T2], p["router"], K)
            keep, _ = moe._slots(idx.reshape(-1) // (E // M), M,
                                 moe._capacity(T2, cfg, M))
            drops += int((~keep).sum())
        return drops


def a2a_full_width() -> dict:
    """(b) deepseek-v2-lite-16b's MoE layer at its published widths (64
    experts, top-6, 2 shared, d_model 2048, d_ff_expert 1408), fp32, on
    x (4, 512, 2048) over a (1, 8) mesh on the card: at capacity factor 8
    (= M: no a2a slot can overflow; moe_apply's drops counted too) output,
    aux and the gradients of router, wg, wu, wo against ``moe_apply``; at
    the config's 1.25 both paths' drops and times. Then reduced dbrx
    through ``forward`` under ``hint_mesh`` (4, 2) against the same call
    without a mesh, at a capacity where neither path drops."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import forward, init_params, moe

    t0 = time.perf_counter()
    full = ARCHS[A2A_ARCH].replace(compute_dtype="float32")
    mesh = card_mesh(A2A_MESH, ("data", "model"))
    M = A2A_MESH[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    p = moe.moe_init(gen, full)
    x = torch.randn(A2A_X + (full.d_model,), generator=gen,
                    device="cuda") * 0.5
    expert_bytes = sum(p[k].nbytes for k in ("wg", "wu", "wo"))
    keys = ("router", "wg", "wu", "wo")

    def run(cfg, a2a: bool):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()
                  if k != "shared"}
        leaves["shared"] = p["shared"]
        fn = ((lambda: moe.moe_apply_a2a(cfg, leaves, x, mesh)) if a2a
              else (lambda: moe.moe_apply(cfg, leaves, x)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        y, aux = fn()
        loss = (y.float() ** 2).mean() + aux
        torch.cuda.synchronize()
        fwd = time.perf_counter() - t
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        torch.cuda.synchronize()
        both = time.perf_counter() - t
        return (y.detach(), aux.detach(), dict(zip(keys, grads)),
                {"forward_s": fwd, "forward_backward_s": both})

    nodrop = full.replace(capacity_factor=float(M))
    drops = {"moe_apply": moe_drops(nodrop, p, x),
             "a2a": moe_drops(nodrop, p, x, mesh)}
    for a2a in (True, False):      # warm-up (allocator, cuBLAS plans)
        run(nodrop, a2a)
    torch.cuda.reset_peak_memory_stats()
    ya, auxa, ga, ta = run(nodrop, True)
    peak_a2a = torch.cuda.max_memory_allocated()
    yp, auxp, gp, tp = run(nodrop, False)
    tol = A2A_TOL
    checks = {"y": compare(ya, yp, tol["rtol"],
                           tol["atol_rel_to_max"] * float(yp.abs().max())),
              "aux": compare(auxa.reshape(1), auxp.reshape(1), tol["rtol"],
                             tol["atol_rel_to_max"] * float(auxp.abs()))}
    for k in keys:
        checks["grad_" + k] = compare(
            ga[k], gp[k], tol["rtol"],
            tol["atol_rel_to_max"] * float(gp[k].abs().max()))
    E_loc = full.n_experts // M
    T2 = A2A_X[0] * A2A_X[1] // M
    C2 = moe._capacity(T2, nodrop, M)
    rows = M * C2
    # the a2a's expert matmuls: every rank, every local expert, every row
    a2a_flop = M * E_loc * rows * full.d_model * full.d_ff_expert * 6
    del ga, gp, ya, yp
    # the config's own capacity: drops and forward times, not compared
    own = {}
    with torch.no_grad():
        for name, fn in (("a2a", lambda: moe.moe_apply_a2a(full, p, x, mesh)),
                         ("moe_apply", lambda: moe.moe_apply(full, p, x))):
            ms, _ = cuda_ms(fn, warmup=1, runs=3)
            own[name] = {"forward_ms": ms,
                         "dropped": moe_drops(full, p, x, mesh if name == "a2a"
                                              else None)}
    del p, x
    torch.cuda.empty_cache()

    # reduced dbrx through forward, hint mesh (4, 2) against none
    dcfg = reduced(ARCHS["dbrx-132b"])
    wide = dcfg.replace(capacity_factor=dcfg.n_experts / dcfg.top_k)
    params = init_params(wide, device="cuda", seed=0)
    toks, _ = lm_inputs(wide, 8, 32, seed=5)
    toks = toks.cuda()
    calls = []
    real = moe.moe_apply_a2a

    def counted(*a):
        calls.append(1)
        return real(*a)

    moe.moe_apply_a2a = counted
    try:
        with torch.no_grad():
            plain, aux_p = forward(wide, params, toks)
            with sh.hint_mesh(card_mesh((4, 2), ("data", "model"))):
                exch, aux_e = forward(wide, params, toks)
    finally:
        moe.moe_apply_a2a = real
    dbrx = {"a2a_calls": len(calls), "n_layers": wide.n_layers,
            "logits": compare(exch, plain, LM_TOL["rtol"],
                              LM_TOL["atol_rel_to_max"]
                              * float(plain.abs().max())),
            "aux_abs_diff": float((aux_e - aux_p).abs())}
    ok = (all(c["ok"] for c in checks.values())
          and drops == {"moe_apply": 0, "a2a": 0}
          and dbrx["a2a_calls"] == wide.n_layers and dbrx["logits"]["ok"])
    return {"arch": A2A_ARCH, "n_experts": full.n_experts,
            "top_k": full.top_k, "n_shared_experts": full.n_shared_experts,
            "d_model": full.d_model, "d_ff_expert": full.d_ff_expert,
            "x": list(A2A_X) + [full.d_model], "mesh": list(A2A_MESH),
            "expert_weight_bytes": expert_bytes,
            "no_drop": {"capacity_factor": float(M), "dropped": drops,
                        "a2a_slots_per_rank": C2,
                        "a2a_rows_per_rank": rows,
                        "a2a_expert_tflop_forward": a2a_flop / 1e12,
                        "a2a": ta, "moe_apply": tp,
                        "a2a_peak_device_bytes": peak_a2a,
                        "checks": checks, "tolerance": A2A_TOL},
            "own_capacity": {"capacity_factor": full.capacity_factor,
                             **own},
            "dbrx_reduced_hint_mesh": dbrx, "ok": ok,
            "seconds": time.perf_counter() - t0}


def grad_compress_full() -> dict:
    """(c) One step's gradients of full ``smollm-360m`` (fp32, 361.8 M) on
    4 shards of a ``("pod",)`` axis (the gradients of 4 micro-batches of
    2 x 256, all on the card): ``psum_compressed`` against the fp32 sum,
    per leaf error <= 4 x scale / 2; ``quantize`` of the first leaf on the
    card bit-identical to the CPU's."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import collectives
    from repro_torch.models import init_params
    from repro_torch.train import grad_compress as gc
    from repro_torch.train import make_loss_fn, optimizer as opt
    from repro_torch.train.train_step import value_and_grad

    t0 = time.perf_counter()
    cfg = ARCHS["smollm-360m"].replace(compute_dtype="float32")
    params = init_params(cfg, device="cuda", seed=0)
    b = train_batch(cfg, seed=0, batch=8, seq=256)
    per = 8 // GC_SHARDS
    names = [k for k, _ in sorted_paths(params)]
    shards = []
    for k in range(GC_SHARDS):
        part = {n: v[k * per:(k + 1) * per].cuda() for n, v in b.items()}
        _, g = value_and_grad(make_loss_fn(cfg), params, part)
        shards.append(dict(sorted_paths(g)))
    del params
    grads = {n: collectives.shard_array([s[n] for s in shards])
             for n in names}
    del shards
    n_params = sum(grads[n][0].numel() for n in names)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, state = gc.psum_compressed(grads, gc.init(grads), 0)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t1
    worst, worst_leaf = 0.0, None
    for n in names:
        exact = collectives.psum(grads[n], 0).item()
        amax = max(float(g.abs().max()) for g in grads[n]) + 1e-12
        scale = torch.tensor(amax, dtype=torch.float32) / torch.tensor(
            127.0)
        bound = GC_SHARDS * float(scale) / 2
        r = float((out[n].item() - exact).abs().max()) / bound
        if r > worst:
            worst, worst_leaf = r, n
    first = grads[names[0]][0]
    q_card, s_card = gc.quantize(first)
    q_cpu, s_cpu = gc.quantize(first.cpu())
    same = (torch.equal(q_card.cpu(), q_cpu)
            and s_card.cpu().numpy().tobytes() == s_cpu.numpy().tobytes())
    del grads, out, state
    torch.cuda.empty_cache()
    # the int8 payload against fp32 on the wire: bytes a shard sends
    return {"arch": cfg.name, "shards": GC_SHARDS, "leaves": len(names),
            "params": n_params, "psum_compressed_s": t_comp,
            "payload_bytes_int8": n_params, "payload_bytes_fp32":
                4 * n_params,
            "worst_err_over_bound": worst, "worst_leaf": worst_leaf,
            "bound": "per leaf: shards x scale / 2 (scale = shared amax / "
                     "127)",
            "quantize_first_leaf": {"leaf": names[0],
                                    "numel": first.numel(),
                                    "card_equals_cpu_bits": same},
            "ok": worst <= 1.0 + 1e-3 and same,
            "seconds": time.perf_counter() - t0}


def sorted_paths(tree, prefix=""):
    """(path, leaf) of a parameter tree in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def sharded_training() -> dict:
    """(d) full ``smollm-360m`` fp32, batch 8 x 256 of ``SyntheticLM``:
    ``make_sharded_train_step`` on a (2, 2) ("data", "model") mesh on the
    card (tensor-parallel over "model"; 15 heads on 2 positions split
    through a head: ``tp_route``) against ``make_train_step`` from the
    same weights and batches,
    the two taking turns step by step: the first 3 steps are compared, ms
    per step is the median of steps 2-6 (both paths' batches cycle); the
    memory a step of each path adds to what both paths hold, and what the
    sharded value-and-grad alone adds (ZeRO-3: a layer gathered at a time),
    beside the step that gathered every layer first."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import attention, init_params
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.distributed import collectives
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_sharded_value_and_grad,
                                              shard_train_state)

    t0 = time.perf_counter()
    cfg = ARCHS["smollm-360m"].replace(compute_dtype="float32")
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=20)
    mesh = card_mesh((2, 2), ("data", "model"))
    params = init_params(cfg, device="cuda", seed=0)
    batches = [{k: v.cuda() for k, v in train_batch(
        cfg, seed=s, batch=8, seq=256).items()} for s in range(SHARDED_STEPS)]
    paths = {"one_device": [make_train_step(cfg, ocfg),
                            (params, opt.init(params))],
             "sharded": [make_sharded_train_step(cfg, ocfg, mesh),
                         shard_train_state(params, opt.init(params), mesh)]}
    n_pieces = sum(leaf.pieces.size
                   for _, leaf in sorted_paths(paths["sharded"][1][0]))
    n_params = sum(a.numel() for _, a in sorted_paths(params))
    del params
    metrics = {k: [] for k in paths}
    times = {k: [] for k in paths}
    peaks = {k: 0 for k in paths}
    peak_all = 0
    after1, calls = {}, {}
    attention.tp_splits.clear()
    for i in range(SHARDED_STEPS + SHARDED_TIMED):
        for tag, path in paths.items():
            step, (p, s) = path
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t = time.perf_counter()
            with collectives.counting() as count:
                p, s, m = step(p, s, batches[i % SHARDED_STEPS])
            torch.cuda.synchronize()
            times[tag].append(time.perf_counter() - t)
            calls[tag] = count.calls
            # what the step adds to what both paths hold
            peaks[tag] = max(peaks[tag],
                             torch.cuda.max_memory_allocated() - held)
            peak_all = max(peak_all, torch.cuda.max_memory_allocated())
            path[1] = (p, s)
            if i < SHARDED_STEPS:
                metrics[tag].append({k: float(v) for k, v in m.items()})
            if i == 0:
                after1[tag] = sh.gather_tree(p)
    grad_peak = grad_peak_extra(make_sharded_value_and_grad(cfg, mesh),
                                paths["sharded"][1][0], batches[0])
    del paths
    tp = tp_route(cfg, mesh, calls["sharded"])
    lr1 = float(opt.lr_at(ocfg, 1))
    dp = max(float((a - b).abs().max())
             for (_, a), (_, b) in zip(sorted_paths(after1["sharded"]),
                                       sorted_paths(after1["one_device"])))
    del after1
    torch.cuda.empty_cache()
    m1, m2 = metrics["one_device"], metrics["sharded"]
    loss_rel = abs(m2[0]["loss"] - m1[0]["loss"]) / abs(m1[0]["loss"])
    gn_rel = abs(m2[0]["grad_norm"] - m1[0]["grad_norm"]) / m1[0][
        "grad_norm"]
    losses_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(m2, m1))
    ok = (loss_rel <= SHARDED_LOSS_RTOL and gn_rel <= SHARDED_GNORM_RTOL
          and dp <= SHARDED_PARAM_ATOL_LR * lr1
          and losses_rel <= SHARDED_LOSSES_RTOL
          and all(np.isfinite(r["loss"]) for r in m2)
          and tp["tensor_parallel"]
          and set(tp["attention_splits"]) == {"through a head"})
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
    return {"arch": cfg.name, "compute_dtype": "float32", "batch": [8, 256],
            "mesh": mesh.shape, "pieces": n_pieces, **tp,
            "collective_calls_sharded_step": calls["sharded"],
            "losses_one_device": [r["loss"] for r in m1],
            "losses_sharded": [r["loss"] for r in m2],
            "grad_norm_one_device": m1[0]["grad_norm"],
            "grad_norm_sharded": m2[0]["grad_norm"],
            "step1_loss_rel_err": loss_rel, "step1_grad_norm_rel_err": gn_rel,
            "params_step1_max_abs_over_lr": dp / lr1,
            "losses_max_rel_err": losses_rel,
            "bars": {"loss_rtol": SHARDED_LOSS_RTOL,
                     "grad_norm_rtol": SHARDED_GNORM_RTOL,
                     "params_atol_over_lr": SHARDED_PARAM_ATOL_LR,
                     "losses_rtol": SHARDED_LOSSES_RTOL},
            "step_ms_one_device": [t * 1e3 for t in times["one_device"]],
            "step_ms_sharded": [t * 1e3 for t in times["sharded"]],
            "ms_per_step_one_device": med["one_device"],
            "ms_per_step_sharded": med["sharded"],
            "sharded_over_one_device": med["sharded"] / med["one_device"],
            "step_peak_extra_bytes_one_device": peaks["one_device"],
            "step_peak_extra_bytes_sharded": peaks["sharded"],
            "step_peak_extra_bytes_sharded_gathering_all_layers":
                GATHER_ALL_PEAKS["train"],
            "grad_peak_extra_bytes_sharded": grad_peak,
            "peak_device_bytes_both_paths": peak_all,
            # parameters and both moments, fp32
            "state_bytes_one_path": 3 * 4 * n_params,
            "ok": ok, "seconds": time.perf_counter() - t0}


def tp_route(cfg, mesh, calls) -> dict:
    """Whether the sharded steps just run were tensor-parallel, from what
    only that route runs: the attention splits that
    ``models.attention.attn_apply_tp`` counted (``tp_splits``: whole
    heads, the query heads of one KV head, or through a head; the
    whole-leaf step counts none); and the step's gradient cuts
    (``collective_calls``: every sharded step reduce-scatters its
    layers)."""
    from repro_torch.models import attention

    splits = dict(attention.tp_splits)
    return {"tensor_parallel": bool(splits)
            and calls.get("reduce-scatter", 0) > 0,
            "model_axis": mesh.shape["model"],
            "heads": [cfg.n_heads, cfg.n_kv_heads],
            "attention_splits": splits}


def tp_whole_heads_training() -> dict:
    """(g) ``mistral-nemo-12b`` at its published widths (d_model 5,120, 32
    heads / 8 KV of 128, ff 14,336, vocab 131,072), depth cut to
    ``TP_LAYERS``, fp32 compute, one ``TP_BATCH`` batch of ``SyntheticLM``:
    ``make_sharded_train_step`` on a (2, 2) ("data", "model") mesh on the
    card, tensor-parallel with whole heads at each position (16 query and 4
    KV heads), against ``make_train_step`` from the same weights. As (f):
    the one-device step first, its state freed before the sharded one's is
    made; each path one warm-up step, then one step from the same state
    timed by CUDA events; the step-1 loss, grad norm and parameters
    compared under (d)'s bars; the collective calls of the sharded step;
    the peak device memory of each path, what a sharded step adds to its
    state and what its value-and-grad alone adds."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import attention, init_params
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_sharded_value_and_grad,
                                              shard_train_state)

    t0 = time.perf_counter()
    full = ARCHS[TP_ARCH]
    cfg = full.replace(n_layers=TP_LAYERS, compute_dtype="float32")
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=20)
    mesh = card_mesh(TP_MESH, ("data", "model"))
    torch.cuda.empty_cache()
    params = init_params(cfg, device="cuda", seed=0)
    n_params = sum(a.numel() for _, a in sorted_paths(params))
    b = {k: v.cuda() for k, v in train_batch(
        cfg, seed=0, batch=TP_BATCH[0], seq=TP_BATCH[1]).items()}

    def timed(step, p, s):
        r0 = alloc_retries()
        step(p, s, b)                               # warm-up, dropped
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with collectives.counting() as count:
            start.record()
            out = step(p, s, b)
            end.record()
        torch.cuda.synchronize()
        alloc.append(alloc_figures(r0))
        return out[0], out[2], start.elapsed_time(end), count.calls

    alloc = []

    st = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p1, m1, ms1, _ = timed(make_train_step(cfg, ocfg), params, st)
    peak1 = torch.cuda.max_memory_allocated()
    del st
    ps, ss = shard_train_state(params, opt.init(params), mesh)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held2 = torch.cuda.memory_allocated()
    attention.tp_splits.clear()
    p2, m2, ms2, calls = timed(make_sharded_train_step(cfg, ocfg, mesh), ps,
                               ss)
    peak2 = torch.cuda.max_memory_allocated()
    tp = tp_route(cfg, mesh, calls)
    grad_peak = grad_peak_extra(make_sharded_value_and_grad(cfg, mesh), ps,
                                b)
    del ps, ss
    lr1 = float(opt.lr_at(ocfg, 1))
    dp = max(float((sh.gather(a) - w).abs().max())
             for (_, a), (_, w) in zip(sorted_paths(p2), sorted_paths(p1)))
    del p1, p2
    torch.cuda.empty_cache()
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(
        float(m1["loss"]))
    gn_rel = abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) / float(
        m1["grad_norm"])
    ok = (loss_rel <= SHARDED_LOSS_RTOL and gn_rel <= SHARDED_GNORM_RTOL
          and dp <= SHARDED_PARAM_ATOL_LR * lr1
          and tp["tensor_parallel"]
          and set(tp["attention_splits"]) == {"whole heads"}
          and all(np.isfinite(float(m[k])) for m in (m1, m2)
                  for k in ("loss", "grad_norm")))
    return {"arch": full.name, "compute_dtype": "float32",
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers],
                        "why": "depth only: both paths' fp32 state and a "
                               "step's transients on one 80 GB card; "
                               "widths as published"},
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "params": n_params, "state_bytes_one_path": 3 * 4 * n_params,
            "batch": list(TP_BATCH), "mesh": mesh.shape, **tp,
            "collective_calls_sharded_step": calls,
            "loss_one_device": float(m1["loss"]),
            "loss_sharded": float(m2["loss"]),
            "grad_norm_one_device": float(m1["grad_norm"]),
            "grad_norm_sharded": float(m2["grad_norm"]),
            "step1_loss_rel_err": loss_rel, "step1_grad_norm_rel_err": gn_rel,
            "params_step1_max_abs_over_lr": dp / lr1,
            "bars": {"loss_rtol": SHARDED_LOSS_RTOL,
                     "grad_norm_rtol": SHARDED_GNORM_RTOL,
                     "params_atol_over_lr": SHARDED_PARAM_ATOL_LR},
            "step_ms_one_device": ms1, "step_ms_sharded": ms2,
            "sharded_over_one_device": ms2 / ms1,
            "allocator": dict(zip(("one_device", "sharded"), alloc)),
            "peak_device_bytes_one_device": peak1,
            "peak_device_bytes_sharded": peak2,
            "peak_device_bytes_sharded_gathering_all_layers":
                GATHER_ALL_PEAKS["tp_train"],
            "step_peak_extra_bytes_sharded": peak2 - held2,
            "grad_peak_extra_bytes_sharded": grad_peak,
            "ok": ok, "seconds": time.perf_counter() - t0}


def routes_by_layer(routes: list, n_shards: int) -> dict:
    """``moe.recording_routes``'s list of ``n_shards`` forwards in turn,
    joined per MoE layer over the shards: ``{key: [(T, K) per layer]}``."""
    n = len(routes) // n_shards
    return {key: [torch.cat([routes[k * n + i][key] for k in range(n_shards)])
                  for i in range(n)] for key in ("expert", "keep", "slot")}


def moe_sharded_training() -> dict:
    """(f) ``deepseek-v2-lite-16b`` at its published widths (64 experts
    top-6, 2 shared, d_model 2048, vocab 102,400, MLA), depth cut to 2
    layers (the first dense layer and one MoE layer), fp32 compute, one
    (4, 512) batch of ``SyntheticLM``: ``make_sharded_train_step`` on a
    (2, 2) ("data", "model") mesh on the card (two batch shards, the
    reference's global expert capacity and load-balance loss;
    tensor-parallel: 32 experts and 8 MLA heads a position) against
    ``make_train_step`` from the same weights. The one-device step runs
    first and its state is freed before the sharded one's is made. Each
    path: one warm-up step, then one step timed by CUDA events from the
    same state; the step-1 loss, grad norm and parameters compared, the MoE
    layer's routing (expert ids, keep masks, slots) compared exactly, its
    drops counted; a control with each batch shard's capacity sized and
    counted from its own tokens; the peak device memory of each path, what
    a sharded step adds to its state and what its value-and-grad alone
    adds; what ran: the splits ``moe.tp_splits`` and ``mla.tp_splits``
    counted (only the tensor-parallel step makes them)."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import forward, init_params, mla, moe
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_sharded_value_and_grad,
                                              shard_train_state)

    t0 = time.perf_counter()
    full = ARCHS[MOE_ARCH]
    cfg = full.replace(n_layers=MOE_LAYERS, compute_dtype="float32")
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=20)
    mesh = card_mesh(MOE_MESH, ("data", "model"))
    n_bd = MOE_MESH[0]
    torch.cuda.empty_cache()
    params = init_params(cfg, device="cuda", seed=0)
    n_params = sum(a.numel() for _, a in sorted_paths(params))
    b = {k: v.cuda() for k, v in train_batch(
        cfg, seed=0, batch=MOE_BATCH[0], seq=MOE_BATCH[1]).items()}
    T = b["tokens"].numel()

    def timed(step, p, s):
        r0 = alloc_retries()
        step(p, s, b)                               # warm-up, dropped
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with moe.recording_routes() as routes, \
                collectives.counting() as count:
            start.record()
            out = step(p, s, b)
            end.record()
        torch.cuda.synchronize()
        alloc.append(alloc_figures(r0))
        return out[0], out[2], start.elapsed_time(end), routes, count.calls

    alloc = []

    st = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p1, m1, ms1, r1, _ = timed(make_train_step(cfg, ocfg), params, st)
    peak1 = torch.cuda.max_memory_allocated()
    del st
    # the control: each batch shard sizes and counts its own capacity
    rows = MOE_BATCH[0] // n_bd
    with torch.no_grad(), moe.recording_routes() as rc:
        for k in range(n_bd):
            forward(cfg, params, b["tokens"][k * rows:(k + 1) * rows])
    ps, ss = shard_train_state(params, opt.init(params), mesh)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held2 = torch.cuda.memory_allocated()
    moe.tp_splits.clear()
    mla.tp_splits.clear()
    p2, m2, ms2, r2, calls = timed(make_sharded_train_step(cfg, ocfg, mesh),
                                   ps, ss)
    peak2 = torch.cuda.max_memory_allocated()
    ran = moe_tp_route(calls)
    grad_peak = grad_peak_extra(make_sharded_value_and_grad(cfg, mesh), ps,
                                b)
    del ps, ss
    lr1 = float(opt.lr_at(ocfg, 1))
    dp = max(float((sh.gather(a) - w).abs().max())
             for (_, a), (_, w) in zip(sorted_paths(p2), sorted_paths(p1)))
    del p1, p2
    torch.cuda.empty_cache()
    one, many, ctl = (routes_by_layer(r1, 1), routes_by_layer(r2, n_bd),
                      routes_by_layer(rc, n_bd))
    same = {key: len(one[key]) == len(many[key]) > 0 and all(
        torch.equal(a, w) for a, w in zip(many[key], one[key]))
        for key in one}
    dropped = {name: [int((~k).sum()) for k in r["keep"]]
               for name, r in (("one_device", one), ("sharded", many),
                               ("per_shard_capacity", ctl))}
    control_differs = any(not torch.equal(a, w)
                          for a, w in zip(ctl["keep"], one["keep"]))
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(
        float(m1["loss"]))
    gn_rel = abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) / float(
        m1["grad_norm"])
    ok = (loss_rel <= SHARDED_LOSS_RTOL and gn_rel <= SHARDED_GNORM_RTOL
          and dp <= SHARDED_PARAM_ATOL_LR * lr1 and all(same.values())
          and dropped["sharded"] == dropped["one_device"]
          and ran["tensor_parallel"]
          and set(ran["moe_splits"]) == {"experts over the row"}
          and set(ran["mla_splits"]) == {"whole heads"}
          and all(np.isfinite(float(m[k])) for m in (m1, m2)
                  for k in ("loss", "aux", "grad_norm")))
    return {"arch": full.name, "compute_dtype": "float32",
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers],
                        "why": "depth only: the first (dense) layer and "
                               "one MoE layer; widths as published"},
            **ran, "collective_calls_sharded_step": calls,
            "n_experts": cfg.n_experts, "top_k": cfg.top_k,
            "n_shared_experts": cfg.n_shared_experts,
            "d_model": cfg.d_model, "d_ff_expert": cfg.d_ff_expert,
            "vocab": cfg.vocab, "params": n_params,
            "param_bytes": 4 * n_params, "batch": list(MOE_BATCH),
            "tokens": T, "mesh": mesh.shape,
            "capacity_factor": cfg.capacity_factor,
            "expert_capacity": moe._capacity(T, cfg, cfg.n_experts),
            "per_shard_capacity": moe._capacity(T // n_bd, cfg,
                                                cfg.n_experts),
            "loss_one_device": float(m1["loss"]),
            "loss_sharded": float(m2["loss"]),
            "aux_one_device": float(m1["aux"]),
            "aux_sharded": float(m2["aux"]),
            "grad_norm_one_device": float(m1["grad_norm"]),
            "grad_norm_sharded": float(m2["grad_norm"]),
            "step1_loss_rel_err": loss_rel, "step1_grad_norm_rel_err": gn_rel,
            "params_step1_max_abs_over_lr": dp / lr1,
            "routing_equal": same, "dropped_slots": dropped,
            "per_shard_capacity_keep_differs": control_differs,
            "bars": {"loss_rtol": SHARDED_LOSS_RTOL,
                     "grad_norm_rtol": SHARDED_GNORM_RTOL,
                     "params_atol_over_lr": SHARDED_PARAM_ATOL_LR,
                     "routing": "equal"},
            "step_ms_one_device": ms1, "step_ms_sharded": ms2,
            "sharded_over_one_device": ms2 / ms1,
            "allocator": dict(zip(("one_device", "sharded"), alloc)),
            "peak_device_bytes_one_device": peak1,
            "peak_device_bytes_sharded": peak2,
            "peak_device_bytes_sharded_gathering_all_layers":
                GATHER_ALL_PEAKS["moe_train"],
            "step_peak_extra_bytes_sharded": peak2 - held2,
            "grad_peak_extra_bytes_sharded": grad_peak,
            "ok": ok, "seconds": time.perf_counter() - t0}


def moe_tp_route(calls) -> dict:
    """Whether the sharded step just run was tensor-parallel, from what
    only that route runs: the splits that ``models.moe.moe_apply_tp`` /
    ``moe_apply_a2a_tp`` and ``models.mla.mla_apply_tp`` counted
    (``tp_splits``; the whole-leaf step counts none); and the step's
    gradient cuts (``collective_calls``: every sharded step
    reduce-scatters its layers)."""
    from repro_torch.models import mla, moe

    splits = dict(moe.tp_splits)
    return {"tensor_parallel": bool(splits)
            and calls.get("reduce-scatter", 0) > 0, "moe_splits": splits,
            "mla_splits": dict(mla.tp_splits)}


def strip_model(specs):
    """A spec tree with "model" taken out: the whole-leaf layout."""
    from repro_torch.distributed import sharding as sh

    if isinstance(specs, dict):
        return {k: strip_model(v) for k, v in specs.items()}
    return sh.P(*(None if e == sh.TP else e for e in specs))


def one_moe_step(step, p, s, b, hint=None) -> dict:
    """One step of ``step`` from ``(p, s)`` on ``b`` (under ``hint_mesh``
    when given): parameters after it gathered whole, metrics, routes per
    MoE layer joined over the batch shards, collective calls, ms by CUDA
    events, the bytes the step adds to what is allocated."""
    import contextlib

    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    ctx = sh.hint_mesh(hint) if hint is not None else \
        contextlib.nullcontext()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with ctx, moe.recording_routes() as routes, \
            collectives.counting() as count:
        start.record()
        new_p, _, m = step(p, s, b)
        end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    return {"params": {k: sh.gather(a) if isinstance(a, sh.Sharded) else a
                       for k, a in sorted_paths(new_p)},
            "metrics": {k: float(v) for k, v in m.items()},
            "routes": routes, "calls": count.calls,
            "ms": start.elapsed_time(end), "step_peak_extra_bytes": peak}


def moe_steps_agree(got: dict, want: dict, n_shards: tuple, lr1: float
                    ) -> dict:
    """Step-1 loss, grad norm and parameters of two steps under (d)'s bars,
    the routing equal exactly and the drops counted; ``n_shards`` the two
    steps' batch shards (how their routes are split)."""
    loss_rel = abs(got["metrics"]["loss"] - want["metrics"]["loss"]) / abs(
        want["metrics"]["loss"])
    gn_rel = abs(got["metrics"]["grad_norm"] - want["metrics"]["grad_norm"]
                 ) / want["metrics"]["grad_norm"]
    dp = max(float((got["params"][k] - w).abs().max())
             for k, w in want["params"].items())
    r_got, r_want = (routes_by_layer(x["routes"], n)
                     for x, n in zip((got, want), n_shards))
    same = all(len(r_got[k]) == len(r_want[k]) > 0 and all(
        torch.equal(a, w) for a, w in zip(r_got[k], r_want[k]))
        for k in r_want)
    dropped = [int((~k).sum()) for k in r_want["keep"]]
    ok = (loss_rel <= SHARDED_LOSS_RTOL and gn_rel <= SHARDED_GNORM_RTOL
          and dp <= SHARDED_PARAM_ATOL_LR * lr1 and same
          and all(np.isfinite(got["metrics"][k]) for k in
                  ("loss", "aux", "grad_norm")))
    return {"loss": [got["metrics"]["loss"], want["metrics"]["loss"]],
            "step1_loss_rel_err": loss_rel, "step1_grad_norm_rel_err": gn_rel,
            "params_step1_max_abs_over_lr": dp / lr1, "routing_equal": same,
            "dropped_slots": dropped, "ms": [got["ms"], want["ms"]],
            "ok": ok}


# (h): reduced dbrx under the hint mesh, the a2a inside each row, against
# the whole-leaf step under the same mesh; budget 5 s on the card
A2A_ROW_BATCH = (8, 64)
A2A_ROW_MESH = (2, 2)
# the whole-leaf MoE step on a mesh without "model"; budget 5 s
WHOLE_LEAF_MESH = (4,)


def a2a_row_training() -> dict:
    """(h) reduced ``dbrx-132b`` (fp32, 4 experts top-2, d_model 64) on a
    (2, 2) ("data", "model") mesh on the card under ``hint_mesh``: the
    tensor-parallel step, whose MoE layers run the all-to-all inside each
    row of positions on their own experts (``moe_apply_a2a_tp``), against
    the port's whole-leaf step under the same mesh (the leaves placed
    without "model": each batch shard gathers whole layers, whose a2a
    reads slices of the whole weights), at the config's capacity and at
    0.5: one step each from the same state, compared under (d)'s bars, the
    routing equal exactly, the drops counted, what ran checked."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import init_params, moe
    from repro_torch.train import OptimizerConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              shard_train_state)

    t0 = time.perf_counter()
    mesh = card_mesh(A2A_ROW_MESH, ("data", "model"))
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=20)
    lr1 = float(opt.lr_at(ocfg, 1))
    out, ok = {}, True
    for cap in (None, 0.5):
        cfg = reduced(ARCHS["dbrx-132b"])
        if cap is not None:
            cfg = cfg.replace(capacity_factor=cap)
        params = init_params(cfg, device="cuda", seed=0)
        b = {k: v.cuda() for k, v in train_batch(
            cfg, seed=0, batch=A2A_ROW_BATCH[0],
            seq=A2A_ROW_BATCH[1]).items()}
        specs = sh.param_specs(params, mesh)
        step = make_sharded_train_step(cfg, ocfg, mesh)
        runs = {}
        for tag, sp in (("whole_leaf", strip_model(specs)), ("tp", specs)):
            moe.tp_splits.clear()
            ps, ss = shard_train_state(params, opt.init(params), mesh, sp)
            one_moe_step(step, ps, ss, b, hint=mesh)   # warm-up, dropped
            runs[tag] = one_moe_step(step, ps, ss, b, hint=mesh)
            runs[tag].update(moe_tp_route(runs[tag]["calls"]))
        n = A2A_ROW_MESH[0]
        agree = moe_steps_agree(runs["tp"], runs["whole_leaf"], (n, n), lr1)
        good = (agree["ok"] and runs["tp"]["tensor_parallel"]
                and set(runs["tp"]["moe_splits"]) == {"a2a in the row"}
                and not runs["whole_leaf"]["tensor_parallel"]
                and (cap is None or sum(agree["dropped_slots"]) > 0))
        out[str(cfg.capacity_factor)] = {
            **agree, "ok": good,
            "tp": {k: runs["tp"][k] for k in (
                "tensor_parallel", "moe_splits", "calls",
                "step_peak_extra_bytes")},
            "whole_leaf": {k: runs["whole_leaf"][k] for k in (
                "tensor_parallel", "calls", "step_peak_extra_bytes")}}
        ok = ok and good
    return {"arch": "dbrx-132b (reduced)", "batch": list(A2A_ROW_BATCH),
            "mesh": mesh.shape, "capacities": out,
            "bars": {"loss_rtol": SHARDED_LOSS_RTOL,
                     "grad_norm_rtol": SHARDED_GNORM_RTOL,
                     "params_atol_over_lr": SHARDED_PARAM_ATOL_LR,
                     "routing": "equal"},
            "ok": ok, "seconds": time.perf_counter() - t0}


def whole_leaf_moe_training() -> dict:
    """The whole-leaf MoE step kept on the card: reduced
    ``deepseek-v2-lite-16b`` (fp32) on a (4,) ("data",) mesh, no "model"
    axis, so every batch shard gathers whole layers, against
    ``make_train_step`` from the same weights: one step each, (d)'s bars,
    routing equal exactly, drops counted; no tensor-parallel split counted
    (``tp_splits`` of attention, MLA and MoE), its layers' gradients
    reduce-scattered; the bytes each step adds."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import attention, init_params, mla, moe
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              shard_train_state)

    t0 = time.perf_counter()
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"]).replace(capacity_factor=0.5)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=20)
    mesh = card_mesh(WHOLE_LEAF_MESH, ("data",))
    params = init_params(cfg, device="cuda", seed=0)
    b = {k: v.cuda() for k, v in train_batch(
        cfg, seed=0, batch=A2A_ROW_BATCH[0], seq=A2A_ROW_BATCH[1]).items()}
    runs = {}
    for splits in (attention.tp_splits, mla.tp_splits, moe.tp_splits):
        splits.clear()
    for tag, step, (p, s) in (
            ("one_device", make_train_step(cfg, ocfg),
             (params, opt.init(params))),
            ("sharded", make_sharded_train_step(cfg, ocfg, mesh),
             shard_train_state(params, opt.init(params), mesh))):
        one_moe_step(step, p, s, b)                     # warm-up, dropped
        runs[tag] = one_moe_step(step, p, s, b)
    agree = moe_steps_agree(runs["sharded"], runs["one_device"],
                            (WHOLE_LEAF_MESH[0], 1),
                            float(opt.lr_at(ocfg, 1)))
    calls = runs["sharded"]["calls"]
    splits = {"attention": dict(attention.tp_splits),
              "mla": dict(mla.tp_splits), "moe": dict(moe.tp_splits)}
    ok = (agree["ok"] and not any(splits.values())
          and calls.get("reduce-scatter", 0) > 0
          and sum(agree["dropped_slots"]) > 0)
    return {"arch": cfg.name, "capacity_factor": cfg.capacity_factor,
            "batch": list(A2A_ROW_BATCH), "mesh": mesh.shape, **agree,
            "tp_splits": splits, "collective_calls_sharded_step": calls,
            "step_peak_extra_bytes": {
                k: runs[k]["step_peak_extra_bytes"] for k in runs},
            "ok": ok, "seconds": time.perf_counter() - t0}


def measured_peaks() -> dict:
    """(e) The card's own rates: an 8192^3 fp32 matmul with TF32 off, the
    same in bf16, and a 2 GiB device-to-device copy (read + write)."""
    n = 8192
    a = torch.randn(n, n, device="cuda")
    b = torch.randn(n, n, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms32, _ = cuda_ms(lambda: a @ b, warmup=2, runs=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    a16, b16 = a.bfloat16(), b.bfloat16()
    ms16, _ = cuda_ms(lambda: a16 @ b16, warmup=2, runs=10)
    del a, b, a16, b16
    src = torch.empty(1 << 29, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    msc, _ = cuda_ms(lambda: dst.copy_(src), warmup=2, runs=10)
    moved = 2 * src.nbytes
    del src, dst
    torch.cuda.empty_cache()
    flop = 2 * n ** 3
    return {"fp32_flops": flop / (ms32 / 1e3), "bf16_flops":
            flop / (ms16 / 1e3), "copy_bytes_per_s": moved / (msc / 1e3),
            "fp32_matmul_ms": ms32, "bf16_matmul_ms": ms16, "copy_ms": msc,
            "matmul_n": n, "copy_bytes": moved}


def roofline_check(peaks: dict, lm_train_ms: float, fp32_step_ms: float
                   ) -> dict:
    """(e) ``Roofline`` of ``algo_flops`` / ``algo_hbm_bytes`` on the card's
    measured peaks, for the step ``lm_train`` runs (smollm-360m cut to
    ``TRAIN_LAYERS`` blocks, train, seq 256, batch 8; bf16 compute over
    fp32 masters, so the bf16 rate) and for (d)'s one-device fp32 step
    (full smollm-360m, the fp32 rate); each bound must be at most
    the step measured in this process. One card: no link traffic, and the
    copy rate stands for the link (shards on one card exchange through
    its memory)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import roofline as rl

    full = ARCHS["smollm-360m"]
    args = ("train", 256, 8)
    out = {}
    for tag, cfg, peak, measured in (
            ("lm_train_bf16", full.replace(n_layers=TRAIN_LAYERS),
             peaks["bf16_flops"], lm_train_ms),
            ("sharded_phase_fp32_one_device", full, peaks["fp32_flops"],
             fp32_step_ms)):
        r = rl.Roofline(flops=rl.algo_flops(cfg, *args),
                        hbm_bytes=rl.algo_hbm_bytes(cfg, *args),
                        coll_bytes_per_dev=0.0, chips=1, peak_flops=peak,
                        hbm_bw=peaks["copy_bytes_per_s"],
                        link_bw=peaks["copy_bytes_per_s"],
                        model_flops=rl.model_flops_estimate(cfg, *args))
        d = r.to_dict()
        out[tag] = {**d, "measured_step_ms": measured,
                    "bound_over_measured": d["step_time_s"] * 1e3 / measured,
                    "ok": d["step_time_s"] * 1e3 <= measured}
    return out


def phase_lm_sharded(dev: dict, lm_train_ms: float) -> None:
    """What exists only across devices, every shard on this card: (a) the
    placement rules at full size on the production meshes, (b) the MoE
    all-to-all at deepseek-v2-lite's widths, (c) int8 gradient compression
    of a full smollm-360m gradient, (d) sharded training of full smollm-360m
    on (2, 2) (tensor-parallel, through a head), (g) of mistral-nemo-12b at
    its widths, 2 layers, on (2, 2) (tensor-parallel, whole heads), (f) MoE
    training of deepseek-v2-lite-16b (2 layers) on (2, 2)
    with the global expert capacity (tensor-parallel: experts and MLA
    heads over "model"), (h) reduced dbrx's a2a inside each row under the
    hint mesh against the whole-leaf step, the whole-leaf MoE step on a
    mesh without "model", (e) the roofline on the card's measured peaks.
    One JSON line each."""
    t0 = time.perf_counter()
    a = specs_at_full_size()
    emit("lm_sharded.specs", **a)
    b = a2a_full_width()
    emit("lm_sharded.a2a", nvidia_smi=dev["nvidia_smi"], **b)
    c = grad_compress_full()
    emit("lm_sharded.grad_compress", nvidia_smi=dev["nvidia_smi"], **c)
    d = sharded_training()
    emit("lm_sharded.train", nvidia_smi=dev["nvidia_smi"], **d)
    g = tp_whole_heads_training()
    emit("lm_sharded.tp_train", nvidia_smi=dev["nvidia_smi"], **g)
    f = moe_sharded_training()
    emit("lm_sharded.moe_train", nvidia_smi=dev["nvidia_smi"], **f)
    h = a2a_row_training()
    emit("lm_sharded.a2a_row_train", nvidia_smi=dev["nvidia_smi"], **h)
    w = whole_leaf_moe_training()
    emit("lm_sharded.moe_whole_leaf_train", nvidia_smi=dev["nvidia_smi"],
         **w)
    t_e = time.perf_counter()
    peaks = measured_peaks()
    e = roofline_check(peaks, lm_train_ms, d["ms_per_step_one_device"])
    emit("lm_sharded.roofline", nvidia_smi=dev["nvidia_smi"], peaks=peaks,
         rooflines=e, seconds=time.perf_counter() - t_e,
         phase_seconds=time.perf_counter() - t0)
    failed = [name for name, ok in (
        ("specs", a["ok"]), ("a2a", b["ok"]), ("grad_compress", c["ok"]),
        ("train", d["ok"]), ("tp_train", g["ok"]), ("moe_train", f["ok"]),
        ("a2a_row_train", h["ok"]), ("moe_whole_leaf_train", w["ok"]),
        ("roofline", all(r["ok"] for r in e.values())))
        if not ok]
    if failed:
        fail(f"lm_sharded: {', '.join(failed)} failed (see their lines)")


# ------------------------------------------------------------ lm_remat
REMAT_ARCH = "smollm-360m"
# (b) and (c) run (and the dry run counts) smollm-360m at its widths on 8
# of its 32 blocks: the cut that pays for the mamba2 / rwkv6 serving checks
# (e), the planner's third reconcile repeat and the layer-by-layer sharded
# steps in the script's time cap
REMAT_LAYERS = 8
REMAT_SHORT = (1, 1024)      # (b): both steps fit the card
# (c): the reference's train_4k row length; B the largest of 4, 2, 1 whose
# dry-run peak is under the card's capacity (the dry run's 24.9 GB at 4 x
# 4096 with remat, written into PERF.md before the first run on the card)
REMAT_LONG = (4, 4096)
# (c)'s steps (step 1 left out of the median): few, for the script's time cap
REMAT_STEPS = 5
# remat's cost, timed in the phase: at (b)'s batch and at lm_train's
REMAT_COST_TRAIN = (8, 256)
REMAT_COST_ROUNDS = 3
# measured max_memory_allocated over the dry run's counted peak
REMAT_PEAK_RATIO = (0.8, 1.25)
REMAT_GRAD_ATOL_REL = 1e-5   # the embedding's backward adds with atomics
SERVE_PROMPTS = (4, 256)
SERVE_DECODE_STEPS = 16
MOE_PREFILL = (8, 32)
# (d)'s checks added with the rows' serving: mistral-nemo-12b at its widths
# cut to 2 layers, 4 prompts of 512 into 2,048 lines; the MoE prefill
# followed by 8 decode steps on (2, 2); budget 15 s together
NEMO_LAYERS = 2
NEMO_SERVE = (4, 512)
NEMO_CACHE = 2048
MOE_DECODE_STEPS = 8
# (e)'s checks, the mamba2 and rwkv6 configs on rows (budget 15 s
# together): the reduced ones, 8 x 32 prompts + 8 steps on (2, 2) and
# (4, 2) and one prompt with the cache over (data, model) on (2, 2);
# rwkv6-3b at its widths on 2 layers over (1, 16), its 40 heads straddling
# the 16 positions; zamba2-7b at its widths on 6 layers (one shared site)
# over (2, 2)
RECURRENT_STEPS = 8
RWKV_LAYERS = 2
RWKV_MESH = (1, 16)
ZAMBA_LAYERS = 6
WIDE_PREFILL = (2, 64)


# the one-device train steps the dry run accounts for ``lm_remat``: (b) at
# 1 x 1024 with and without remat, (c) at B x 4096 with remat and the same
# step without it (not run on the card)
REMAT_CELLS = [("short_remat", REMAT_SHORT, True),
               ("short_plain", REMAT_SHORT, False),
               ("long_remat", REMAT_LONG, True),
               ("long_plain", REMAT_LONG, False)]


def dryrun_figure(cell) -> dict:
    """``launch.dryrun.account`` of the one-device train step of
    ``smollm-360m`` on ``REMAT_LAYERS`` blocks on a batch of ``cell``'s
    shape: fake tensors on the
    host, no card touched (in a worker process, so that the card's phases
    do not share this one's interpreter with it, or in this process with
    ``--dry-run-in-process``)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun, specs
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt

    tag, (B, S), remat = cell
    cfg = ARCHS[REMAT_ARCH].replace(remat=remat, n_layers=REMAT_LAYERS)
    params = specs.param_specs_abstract(cfg)
    state = opt.OptState(mu=params, nu=params, step=torch.empty(
        (), dtype=torch.int32, device="meta"))
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    acc = dryrun.account(make_train_step(cfg, OptimizerConfig()), params,
                         state, batch)
    return {"cell": tag, "batch": [B, S], "remat": remat,
            "accounted_on": "host, fake tensors",
            "hbm_per_chip": dryrun.HBM_PER_CHIP,
            **{k: v for k, v in acc["memory"].items()
               if k != "per_position"},
            "flops": acc["cost"]["flops"], "seconds": acc["seconds"]}


def start_dryrun_figures():
    """The ``lm_remat`` accountings in two spawned worker processes (about
    a minute of host time in all, most of it the two 4 x 4096 cells),
    started before ``lm_serve`` so that they run beside the language-model
    phases and not beside the timed STKDE ones; the phase collects them.
    Returns the pool and the futures."""
    import concurrent.futures as cf
    import multiprocessing

    pool = cf.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(dryrun_figure, c) for c in REMAT_CELLS]


def remat_reduced_on_card() -> list:
    """(a) The ten ``reduced`` configs with ``remat=True`` against
    ``remat=False`` on the card, from the same weights and batch: the loss
    bit for bit, every gradient within ``REMAT_GRAD_ATOL_REL x max|g|``."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import init_params
    from repro_torch.models.transformer import leaves
    from repro_torch.train import make_loss_fn
    from repro_torch.train.train_step import value_and_grad

    rows = []
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name]).replace(remat=True)
        params = init_params(cfg, device="cuda", seed=0)
        b = {k: v.cuda() for k, v in train_batch(cfg, seed=0).items()}
        out = {}
        for remat in (True, False):
            (total, _), g = value_and_grad(
                make_loss_fn(cfg.replace(remat=remat)), params, b)
            out[remat] = (total, list(leaves(g)))
        worst = max(float((a - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                    for a, w in zip(out[True][1], out[False][1]))
        same = bool(torch.equal(out[True][0], out[False][0]))
        rows.append({"arch": cfg.name, "loss": float(out[True][0]),
                     "loss_bit_equal": same,
                     "grad_max_abs_over_max": worst,
                     "ok": same and worst <= REMAT_GRAD_ATOL_REL})
    return rows


def peak_of(fn, held: int):
    """``fn()``'s result and the card's peak allocation while it ran, less
    ``held`` (what was allocated before its inputs were made)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - held


def remat_cost(cfg, ocfg, params, state, b, rounds: int) -> dict:
    """Remat's cost in one run: the train step with remat and without on
    ``b``, alternated ``rounds`` times after one untimed step each, timed by
    CUDA events; the medians and their ratio."""
    from repro_torch.train import make_train_step

    steps = {r: make_train_step(cfg.replace(remat=r), ocfg)
             for r in (True, False)}
    times = {True: [], False: []}
    for i in range(rounds + 1):
        for remat in (True, False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = steps[remat](params, state, b)
            end.record()
            torch.cuda.synchronize()
            del out
            if i:
                times[remat].append(start.elapsed_time(end))
    med = {r: statistics.median(t) for r, t in times.items()}
    return {"batch": list(b["tokens"].shape), "remat_step_ms": times[True],
            "plain_step_ms": times[False], "remat_ms": med[True],
            "plain_ms": med[False], "remat_over_plain": med[True] / med[False]}


def remat_full_width(figures: dict) -> dict:
    """(b) ``smollm-360m`` at its widths on ``REMAT_LAYERS`` blocks at 1 x
    1024: one step with remat and one
    without, their losses and gradients compared, each step's peak beside
    the dry run's count; remat's cost timed there and at ``lm_train``'s
    8 x 256 batch (``remat_cost``); (c) at B x 4096 with remat: 5 steps, ms per step,
    tokens/s, the peak beside the count, step 1's loss against the loss
    function under ``torch.no_grad()`` on the same batch (bit for bit), and
    the count of the same step without remat (not run)."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.models.transformer import leaves
    from repro_torch.train import (OptimizerConfig, make_loss_fn,
                                   make_train_step)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import value_and_grad

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = ARCHS[REMAT_ARCH].replace(n_layers=REMAT_LAYERS)
    assert cfg.remat and cfg.scan_layers
    ocfg = OptimizerConfig()
    params = init_params(cfg, device="cuda", seed=0)
    state = opt.init(params)

    def batch(shape, seed):
        return {k: v.cuda() for k, v in train_batch(
            cfg, seed=seed, batch=shape[0], seq=shape[1]).items()}

    def ratio(measured, tag):
        counted = figures[tag]["peak_bytes"]
        return {"measured_peak_bytes": measured, "dry_run_peak_bytes":
                counted, "measured_over_dry_run": measured / counted,
                "ok": REMAT_PEAK_RATIO[0] <= measured / counted
                <= REMAT_PEAK_RATIO[1]}

    # (b): both steps' peaks first, with nothing else held, then the
    # gradients compared
    b = batch(REMAT_SHORT, 0)
    short = {}
    for remat, tag in ((True, "short_remat"), (False, "short_plain")):
        step = make_train_step(cfg.replace(remat=remat), ocfg)
        out, peak = peak_of(lambda: step(params, state, b), held)
        del out
        short[tag] = ratio(peak, tag)
    grads = {}
    for remat in (True, False):
        (total, _), g = value_and_grad(
            make_loss_fn(cfg.replace(remat=remat)), params, b)
        grads[remat] = (total, list(leaves(g)))
        del g
    worst = max(float((a - w).abs().max()) / max(float(w.abs().max()),
                                                 1e-30)
                for a, w in zip(grads[True][1], grads[False][1]))
    same = bool(torch.equal(grads[True][0], grads[False][0]))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    short.update(loss_bit_equal=same, grad_max_abs_over_max=worst,
                 ok=same and worst <= REMAT_GRAD_ATOL_REL and all(
                     r["ok"] for r in short.values()
                     if isinstance(r, dict)))
    cost = [remat_cost(cfg, ocfg, params, state, bt, REMAT_COST_ROUNDS)
            for bt in (b, batch(REMAT_COST_TRAIN, 2))]
    del b
    gc.collect()
    torch.cuda.empty_cache()

    # (c)
    long_fig = figures["long_remat"]
    fits = long_fig["peak_bytes"] < long_fig["hbm_per_chip"]
    bls = [batch(REMAT_LONG, 1 + i) for i in range(REMAT_STEPS)]
    step = make_train_step(cfg, ocfg)
    with torch.no_grad():
        want = make_loss_fn(cfg)(params, bls[0])[0]
    # the steps' inputs are their only references: a step's old state is
    # freed once the next holds the new one
    p, s = params, state
    del params, state
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for bl in bls:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, s, m = step(p, s, bl)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(m["loss"])
    peak_long = torch.cuda.max_memory_allocated() - held
    first_equal = bool(torch.equal(losses[0], want))
    losses = [float(x) for x in losses]
    del p, s, m, bls
    gc.collect()
    torch.cuda.empty_cache()
    ms = statistics.median(times[1:])
    tokens = REMAT_LONG[0] * REMAT_LONG[1]
    long_ = {"batch": list(REMAT_LONG), "steps": REMAT_STEPS,
             "step_ms": times, "ms_per_step": ms,
             "tokens_per_s": tokens / (ms / 1e3), "losses": losses,
             "step1_loss_equals_no_grad_loss": first_equal,
             "dry_run_peak_fits_card": fits,
             **ratio(peak_long, "long_remat"),
             "dry_run_without_remat": figures["long_plain"]}
    long_["ok"] = (long_["ok"] and first_equal and fits
                   and all(np.isfinite(losses)))
    return {"arch": cfg.name, "compute_dtype": cfg.compute_dtype,
            "reduced": {"n_layers": [ARCHS[REMAT_ARCH].n_layers,
                                     REMAT_LAYERS]},
            "held_before_bytes": held, "short": short,
            "remat_cost": cost, "long": long_,
            "ok": short["ok"] and long_["ok"],
            "seconds": time.perf_counter() - t0}


def serve_paths_ran() -> dict:
    """Which path the sharded prefill and decode took since the counts
    were cleared (``launch.dryrun.serve_paths``: "row" or "whole leaves")
    and how often each layer's row decode ran the flash-decoding combine
    (``attention.tp_splits``, ``mla.tp_splits``)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import attention, mla

    return {"serve_paths": dict(dryrun.serve_paths),
            "attention_flash_decoding": attention.tp_splits[
                "flash-decoding"],
            "mla_flash_decoding": mla.tp_splits["flash-decoding"]}


def clear_serve_paths() -> None:
    from repro_torch.launch import dryrun
    from repro_torch.models import attention, mla

    dryrun.serve_paths.clear()
    attention.tp_splits.clear()
    mla.tp_splits.clear()


def greedy_against_one_device(cfg, params, p_sh, mesh, toks, max_seq: int,
                              steps: int, hint=None, p_whole=None) -> dict:
    """The sharded prefill of ``toks`` into ``max_seq`` lines and ``steps``
    greedy decode steps (``launch.dryrun``), against the one-device
    ``prefill`` / ``decode_step`` fed the one-device path's tokens: each
    call's last logits within ``LM_TOL``, the tokens equal, and under
    ``hint`` (the hint mesh, both paths) the MoE routes of every call
    equal. With ``p_whole`` (the parameters placed without "model", so
    that the layout picks the whole-leaf path, which leaves its input
    state as it is), the first decode step also runs on whole leaves, and
    each path's peak device bytes above what was held before it, and its
    ms, are taken."""
    import contextlib

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step, moe, prefill

    s_specs = dryrun._decode_state_specs(cfg, toks.shape[0], max_seq,
                                         getattr(torch, cfg.compute_dtype),
                                         mesh)
    pre = dryrun.sharded_prefill(cfg, mesh, max_seq, s_specs)
    dec = dryrun.sharded_decode(cfg, mesh, s_specs)
    def ctx():
        return sh.hint_mesh(hint) if hint is not None else \
            contextlib.nullcontext()

    n_shards = mesh.shape["data"]
    errs, tok_equal, routes_equal, out = [], True, True, {}
    compared = 0

    def routed(fn, *args):
        with ctx(), moe.recording_routes() as r:
            res = fn(*args)
        return res, r

    def measured(fn, *args):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with ctx():
            res = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - held, \
            start.elapsed_time(end)

    with torch.no_grad():
        (got, st_sh), r_sh = routed(pre, p_sh, {"tokens": toks})
        (want, st), r_one = routed(prefill, cfg, params, toks, max_seq)
        for i in range(steps + 1):
            c = compare(got[:, -1], want[:, -1], LM_TOL["rtol"],
                        LM_TOL["atol_rel_to_max"] * float(
                            want.abs().max()))
            errs.append(c["worst_err_over_allowed"])
            t_sh, t_one = got.argmax(-1), want.argmax(-1)
            tok_equal = tok_equal and bool(torch.equal(t_sh, t_one))
            n = len(r_one)
            compared += n
            routes_equal = routes_equal and len(r_sh) == n * n_shards and all(
                torch.equal(torch.cat([r_sh[b * n + j][k]
                                       for b in range(n_shards)]),
                            r_one[j][k])
                for j in range(n) for k in ("expert", "keep", "slot"))
            if i == steps:
                break
            if p_whole is not None and i == 0:
                res, out["peak_bytes_whole_leaves"], \
                    out["ms_whole_leaves"] = measured(dec, p_whole, st_sh,
                                                      t_one)
                del res
                (got, st_sh), out["peak_bytes_rows"], out["ms_rows"] = \
                    measured(dec, p_sh, st_sh, t_one)
                r_sh = []
                (want, st), _, out["ms_one_device"] = measured(
                    decode_step, cfg, params, t_one, st)
                r_one = []
                continue
            (got, st_sh), r_sh = routed(dec, p_sh, st_sh, t_one)
            (want, st), r_one = routed(decode_step, cfg, params, t_one, st)
    del st_sh, st
    return {"worst_err_over_allowed": max(errs), "tokens_equal": tok_equal,
            "routes_equal": routes_equal, "moe_calls_compared": compared,
            **out}


def recurrent_serving_on_card() -> dict:
    """(e) The mamba2 and rwkv6 configs served on rows (``launch.dryrun``'s
    ``sharded_prefill`` / ``sharded_decode``; ``models/ssm.py::
    ssm_apply_tp`` / ``ssm_decode_tp``, ``models/rwkv.py``'s ``*_tp``,
    zamba2's shared sites through ``attention.attn_decode_tp``) against
    the one-device path, fp32: each call's logits within ``LM_TOL``,
    greedy tokens equal, every call on the rows. Reduced zamba2 and rwkv6:
    8 prompts of 32 and ``RECURRENT_STEPS`` steps on (2, 2) and (4, 2),
    and one prompt on (2, 2), whose shared sites' cache
    ``decode_state_specs`` splits over ``(data, model)`` (``long_500k``'s
    layout). ``rwkv6-3b`` at its widths on ``RWKV_LAYERS`` layers over
    ``RWKV_MESH`` (40 heads of 64 on 16 positions: 2.5 heads a position,
    as on the production mesh) and ``zamba2-7b`` at its widths on
    ``ZAMBA_LAYERS`` layers (one shared site) over (2, 2): 2 prompts of
    64 and ``RECURRENT_STEPS`` steps."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    rows = []

    def check(cfg, params, shape, toks, what):
        mesh = card_mesh(shape, ("data", "model"))
        p_sh = sh.shard_tree(params, sh.param_specs(
            params, mesh, fsdp=dryrun._serve_fsdp(cfg, mesh)), mesh)
        clear_serve_paths()
        t = time.perf_counter()
        run = greedy_against_one_device(
            cfg, params, p_sh, mesh, toks,
            toks.shape[1] + RECURRENT_STEPS, RECURRENT_STEPS)
        del p_sh
        paths = serve_paths_ran()
        shards = mesh.shape["data"] if toks.shape[0] > 1 else 1
        rows.append({
            "arch": cfg.name, "what": what, "layers": cfg.n_layers,
            "mesh": mesh.shape, "prompts": list(toks.shape),
            "decode_steps": RECURRENT_STEPS, **run, **paths,
            "seconds": time.perf_counter() - t,
            "ok": run["tokens_equal"] and run["worst_err_over_allowed"]
            <= 1.0 and paths["serve_paths"] == {"row": 1 + RECURRENT_STEPS}
            and paths["attention_flash_decoding"]
            == RECURRENT_STEPS * cfg.attn_sites * shards})

    for name in ("zamba2-7b", "rwkv6-3b"):
        cfg = reduced(ARCHS[name])
        params = init_params(cfg, device="cuda", seed=0)
        toks = lm_inputs(cfg, *MOE_PREFILL, seed=6)[0].cuda()
        check(cfg, params, (2, 2), toks, "reduced")
        check(cfg, params, (4, 2), toks, "reduced")
        check(cfg, params, (2, 2), toks[:1], "reduced, one prompt" + (
            ": the shared sites' cache over (data, model)"
            if cfg.attn_sites else ""))
        del params
    for name, layers_, shape in (("rwkv6-3b", RWKV_LAYERS, RWKV_MESH),
                                 ("zamba2-7b", ZAMBA_LAYERS, (2, 2))):
        cfg = ARCHS[name].replace(n_layers=layers_, compute_dtype="float32")
        params = init_params(cfg, device="cuda", seed=0)
        check(cfg, params, shape,
              lm_inputs(cfg, *WIDE_PREFILL, seed=7)[0].cuda(),
              f"published widths, {layers_} layers")
        del params
        torch.cuda.empty_cache()
    return {"rows": rows, "ok": all(r["ok"] for r in rows),
            "seconds": time.perf_counter() - t0}


def sharded_serving_on_card() -> dict:
    """(d) The dry run's sharded prefill and decode (``launch.dryrun``'s
    ``sharded_prefill`` / ``sharded_decode``) on meshes of the one card
    against the one-device path; every covered config here takes the rows
    of "model" positions with the cache split by sequence (the
    flash-decoding layout), and each line records the path that ran.
    Full ``smollm-360m`` (fp32 compute) on a (2, 2) mesh, 4 prompts of
    256 tokens, then 16 greedy decode steps (logits within ``LM_TOL``,
    tokens equal). ``mistral-nemo-12b`` at its published widths cut to
    ``NEMO_LAYERS`` (fp32; whole heads on (2, 2)): 4 prompts of 512 into
    2,048 lines (pieces past the cursor fully masked), 16 greedy steps,
    tokens equal, the row step's peak beside the whole-leaf step's (the
    weights placed without "model").
    Reduced ``deepseek-v2-lite-16b`` (the MLA latent cache) and
    ``dbrx-132b`` (the a2a in the rows) under the hint mesh: prefill on
    (2, 2) and (4, 2), and on (2, 2) ``MOE_DECODE_STEPS`` decode steps,
    against the one-device path under the same hint mesh, routing equal
    at every call. Then (e), ``recurrent_serving_on_card``."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params

    t0 = time.perf_counter()

    def placed(cfg, params, mesh):
        return sh.shard_tree(params, sh.param_specs(
            params, mesh, fsdp=dryrun._serve_fsdp(cfg, mesh)), mesh)

    cfg = ARCHS[REMAT_ARCH].replace(compute_dtype="float32")
    B, S = SERVE_PROMPTS
    mesh = card_mesh((2, 2), ("data", "model"))
    params = init_params(cfg, device="cuda", seed=0)
    clear_serve_paths()
    run = greedy_against_one_device(
        cfg, params, placed(cfg, params, mesh), mesh,
        lm_inputs(cfg, B, S, seed=3)[0].cuda(), S + SERVE_DECODE_STEPS,
        SERVE_DECODE_STEPS)
    paths = serve_paths_ran()
    del params
    torch.cuda.empty_cache()
    rows = paths["serve_paths"] == {"row": 1 + SERVE_DECODE_STEPS}
    smollm = {"arch": cfg.name, "compute_dtype": "float32",
              "mesh": mesh.shape, "prompts": [B, S],
              "decode_steps": SERVE_DECODE_STEPS, **run, **paths,
              "seconds": time.perf_counter() - t0,
              "ok": run["tokens_equal"] and run["worst_err_over_allowed"]
              <= 1.0 and rows}

    t1 = time.perf_counter()
    cfg = ARCHS["mistral-nemo-12b"].replace(n_layers=NEMO_LAYERS,
                                            compute_dtype="float32")
    B, S = NEMO_SERVE
    params = init_params(cfg, device="cuda", seed=0)
    p_whole = sh.shard_tree(params, strip_model(sh.param_specs(
        params, mesh, fsdp=dryrun._serve_fsdp(cfg, mesh))), mesh)
    clear_serve_paths()
    run = greedy_against_one_device(
        cfg, params, placed(cfg, params, mesh), mesh,
        lm_inputs(cfg, B, S, seed=5)[0].cuda(), NEMO_CACHE,
        SERVE_DECODE_STEPS, p_whole=p_whole)
    del p_whole
    paths = serve_paths_ran()
    del params
    torch.cuda.empty_cache()
    rows = (paths["serve_paths"] == {"row": 1 + SERVE_DECODE_STEPS,
                                     "whole leaves": 1}
            and paths["attention_flash_decoding"]
            == SERVE_DECODE_STEPS * NEMO_LAYERS * mesh.shape["data"])
    nemo = {"arch": cfg.name, "layers": NEMO_LAYERS,
            "compute_dtype": "float32", "mesh": mesh.shape,
            "prompts": [B, S], "cache_lines": NEMO_CACHE,
            "decode_steps": SERVE_DECODE_STEPS, **run, **paths,
            "seconds": time.perf_counter() - t1,
            "ok": run["tokens_equal"] and run["worst_err_over_allowed"]
            <= 1.0 and rows
            and run["peak_bytes_rows"] < run["peak_bytes_whole_leaves"]}

    t2 = time.perf_counter()
    moe_rows = []
    for name in ("deepseek-v2-lite-16b", "dbrx-132b"):
        mcfg = reduced(ARCHS[name])
        mp = init_params(mcfg, device="cuda", seed=0)
        mt = lm_inputs(mcfg, *MOE_PREFILL, seed=4)[0].cuda()
        for shape, steps in (((2, 2), MOE_DECODE_STEPS), ((4, 2), 0)):
            m = card_mesh(shape, ("data", "model"))
            clear_serve_paths()
            run = greedy_against_one_device(
                mcfg, mp, placed(mcfg, mp, m), m, mt,
                MOE_PREFILL[1] + MOE_DECODE_STEPS, steps, hint=m)
            paths = serve_paths_ran()
            moe_rows.append({
                "arch": name, "mesh": m.shape, "decode_steps": steps,
                **run, **paths,
                "ok": run["routes_equal"] and run["moe_calls_compared"] > 0
                and run["tokens_equal"]
                and run["worst_err_over_allowed"] <= 1.0
                and paths["serve_paths"] == {"row": 1 + steps}})
        del mp
    moe_seconds = time.perf_counter() - t2
    recurrent = recurrent_serving_on_card()
    return {"smollm": smollm, "nemo": nemo, "moe": moe_rows,
            "moe_seconds": moe_seconds, "recurrent": recurrent,
            "new_checks_seconds": recurrent["seconds"],
            "ok": smollm["ok"] and nemo["ok"]
            and all(r["ok"] for r in moe_rows) and recurrent["ok"],
            "seconds": time.perf_counter() - t0}


def phase_lm_remat(dev: dict, pending=None) -> None:
    """The reference's per-layer remat on the card, and the dry run beside
    it: (a) the ten reduced configs with and without remat, (b) and (c)
    full smollm-360m at 1 x 1024 and at the reference's 4,096-token rows,
    each peak beside the dry run's count of the same step (accounted on
    the host: in worker processes, ``pending`` being
    ``start_dryrun_figures()``'s, or with ``pending=None`` here, after
    (a)), remat's cost timed in this run, (d) the dry run's sharded prefill
    and decode on meshes of the card, with (e) the mamba2 and rwkv6
    configs' rows. One JSON line each."""
    t0 = time.perf_counter()
    a = remat_reduced_on_card()
    emit("lm_remat.reduced", rows=a, ok=all(r["ok"] for r in a))
    t_wait = time.perf_counter()
    if pending is None:
        figures = {c[0]: dryrun_figure(c) for c in REMAT_CELLS}
    else:
        pool, futures = pending
        try:
            figures = {f["cell"]: f for f in (x.result() for x in futures)}
        finally:
            pool.shutdown()
    emit("lm_remat.dry_run", figures=list(figures.values()),
         in_process=pending is None, waited_s=time.perf_counter() - t_wait,
         counted_by="launch.dryrun.account: fake-tensor accounting for "
         "NVIDIA H100 80GB HBM3 on the host")
    bc = remat_full_width(figures)
    emit("lm_remat.full_width", nvidia_smi=dev["nvidia_smi"], **bc)
    d = sharded_serving_on_card()
    emit("lm_remat.sharded_serving", nvidia_smi=dev["nvidia_smi"], **d,
         phase_seconds=time.perf_counter() - t0)
    failed = [name for name, ok in (
        ("reduced", all(r["ok"] for r in a)), ("full_width", bc["ok"]),
        ("sharded_serving", d["ok"])) if not ok]
    if failed:
        fail(f"lm_remat: {', '.join(failed)} failed (see their lines)")


def main() -> None:
    """``--dry-run-in-process``: ``lm_remat``'s accountings run in this
    process inside that phase, not in worker processes beside the
    language-model phases (to compare those phases' times without them)."""
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    import repro_torch.kernels  # noqa: F401  (fails here without the port)

    in_process = "--dry-run-in-process" in sys.argv[1:]
    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    main = phase_main_path(kern)
    launches = main["launches"] + phase_gold(main)
    scatter = {**phase_scatter(), "main_path_launches":
               main["scatter_launches"]}
    phase_chunked()
    launches += phase_distributed(dev)
    launches += phase_planner(dev)
    launches += phase_degrade(dev)
    pending = None if in_process else start_dryrun_figures()
    phase_lm_serve(dev)
    lm_train_ms = phase_lm_train(dev)
    phase_lm_sharded(dev, lm_train_ms)
    phase_lm_remat(dev, pending)
    emit("total", seconds=time.perf_counter() - t_start,
         peak_host_rss_bytes=resource.getrusage(
             resource.RUSAGE_SELF).ru_maxrss * 1024)
    print(json.dumps({"kernels": [{
        "name": "stkde_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stkde_tile.cu",
        "replaces": "src/repro/kernels/stkde_tile.py:63",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None,
    }, {
        "name": "stkde_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stkde_scatter.cu",
        "replaces": None, "launches": scatter["main_path_launches"],
        "max_rel_err": scatter["kernel_vs_loop_rel_err"],
        "ms": scatter["kernel_ms"], "plain_ms": scatter["loop_ms"],
        "bound_ms": scatter["least_ms"],
        "bound_by": (scatter["least_time"] or {}).get("bound_by"),
        "library_ms": None,
    }]}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
