#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

needs one NVIDIA Hopper card, ``nvcc`` and nothing else: it builds the CUDA
kernel from the sources in this checkout, holds it against its plain PyTorch
version on the card (small shapes, cases that split one heavy tile over many
work items, and the full-size ``PollenUS_Hr-Lb`` buckets), checks that the
kernel agrees with itself bit for bit (two launches; stopping at each
tile's count against walking the whole buckets under the same ``seg``),
times it beside its bound, then drives the port's main path —
``repro_torch.core.api.stkde``, both branches — on two rows of the paper's
Table 2 at full size (``Dengue_Lr-Hb``, ``PollenUS_Hr-Lb``) and checks what
comes out.

Every phase prints one JSON line. Any failure exits non-zero; without a CUDA
device the script exits non-zero before it prints a result. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
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

TILE_CASES = [
    # (grid, hs, ht, tile)
    ((33, 25, 17), 3.0, 2.0, (8, 8, 8)),
    ((32, 32, 16), 4.0, 1.0, (16, 16, 8)),
    ((64, 48, 12), 6.0, 3.0, (32, 16, 4)),
    ((17, 19, 23), 2.0, 2.0, (8, 8, 16)),   # ragged: tiles overhang the grid
    ((40, 40, 8), 5.0, 1.0, (40, 40, 8)),   # single tile
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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
    """The tile branch of ``stkde`` stage by stage, each stage timed: host
    bucketing, copy to the card, kernel (given the host's counts, as
    ``stkde_tiled`` does), slice + finite check. The kernel is timed twice:
    the wrapper as the main path calls it (host planning, the plan's copy,
    the launches), and the device work alone (split pass + reduction on a
    plan made beforehand)."""
    from repro_torch import convert
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops, stkde_tile, stkde_tiles_cuda
    from repro_torch.resilience import ensure_finite

    tile = ops.default_tile(dom)
    t0 = time.perf_counter()
    b, chunk = ops.prepare_tiles(pts, dom, tile)
    t1 = time.perf_counter()
    t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host_counts = torch.from_numpy(b.counts.astype(np.int32))
    wrapper_ms, padded = cuda_ms(
        lambda: stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, tile, t.cap,
                                 len(pts), chunk, mode="compiled",
                                 counts=host_counts),
        warmup=1, runs=timed_runs)
    t3 = time.perf_counter()
    grid = ensure_finite(padded[: dom.Gx, : dom.Gy, : dom.Gt], "smoke.tiled")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    prep = stkde_tile._prepare(t.pts_tiles, t.valid_tiles, host_counts, dom,
                               tile, t.cap, len(pts), chunk, km.DEFAULT_KS,
                               km.DEFAULT_KT, None)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t4
    kernel_ms, device_only = cuda_ms(
        lambda: stkde_tile._run(prep, t.pts_tiles, t.valid_tiles),
        warmup=1, runs=timed_runs)
    if not torch.equal(device_only, padded):
        fail("the prepared launch differs from the wrapper's")
    counts = b.counts.astype(np.int64)
    ks_name = km.DEFAULT_KS.__name__
    plan = prep.plan
    walked = int((-(-plan.items[:, 2].astype(np.int64) // 8) * 8).sum())
    return {
        "inputs": t, "chunk": chunk, "tile": tile, "grid": grid,
        "padded": padded, "counts_host": counts, "host_counts": host_counts,
        "plan": plan,
        "bounds": {
            "useful": bound_ms(int(counts.sum()), tile, counts.size,
                               ks_name),
            "as_launched": bound_ms(walked, tile, counts.size, ks_name),
            "padded": bound_ms(counts.size * b.cap, tile, counts.size,
                               ks_name),
        },
        "times": {"host_bucketing_s": t1 - t0, "h2d_s": t2 - t1,
                  "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
                  "plan_and_copy_s": plan_s, "slice_check_s": t4 - t3},
        "shape": {"ntiles": list(b.ntiles), "cap": b.cap, "chunk": chunk,
                  "copies_per_point": b.replication_factor,
                  "bucket_bytes": int(t.pts_tiles.nbytes
                                      + t.valid_tiles.nbytes),
                  **plan_fields(plan, tile)},
    }


def ks_support_share(t, dom, tile, block: int = 65536) -> dict:
    """Share of the walked (point, column) pairs whose ks is not zero, i.e.
    whose column lies inside the point's spatial disk; counted on the card
    from the buckets' real points (the rest of the walk multiplies zeros)."""
    bx, by, _ = tile
    valid = t.valid_tiles > 0
    where = valid.nonzero()                 # (copies, 4): ti, tj, tk, slot
    pts = t.pts_tiles[valid]                # (copies, 3), same order
    dev = pts.device
    hs = torch.tensor(dom.hs, dtype=torch.float32, device=dev)
    ix = torch.arange(bx, dtype=torch.float32, device=dev)
    iy = torch.arange(by, dtype=torch.float32, device=dev)
    inside = 0
    for i in range(0, len(pts), block):
        ti = where[i:i + block, 0:1].float()
        tj = where[i:i + block, 1:2].float()
        u = (dom.ox + ((ti * bx + ix) + 0.5) * dom.sres
             - pts[i:i + block, 0:1]) / hs
        v = (dom.oy + ((tj * by + iy) + 0.5) * dom.sres
             - pts[i:i + block, 1:2]) / hs
        inside += int(((u * u)[:, :, None] + (v * v)[:, None, :] < 1.0).sum())
    pairs = len(pts) * bx * by
    return {"pairs": pairs, "pairs_ks_nonzero": inside,
            "share": inside / max(pairs, 1)}


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
        t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap)
        args = (t.pts_tiles, t.valid_tiles, dom, tile)
        host_counts = torch.from_numpy(b.counts.astype(np.int32))
        if seg is None:
            seg = stkde_tile.default_seg(b.counts, tile, t.pts_tiles.device,
                                         ks)
        plan = stkde_tile.plan_segments(b.counts, seg)

        def run(counts):
            return stkde_tiles_cuda(*args, t.cap, len(pts), chunk_eff, ks, kt,
                                    mode="compiled", counts=counts, seg=seg)

        want = stkde_tiles_ref(*args, len(pts), ks, kt)
        early = run(host_counts)
        again = run(host_counts)
        dev_counts = run(t.counts)
        whole = run(None)
        torch.cuda.synchronize()
        r = compare(early, want, **SMALL_TOL)
        r["label"] = label
        r.update(plan_fields(plan, tile))
        r["max_load"] = int(b.counts.max())
        r["two_launches_bit_identical"] = bool(torch.equal(early, again))
        r["device_counts_bit_identical"] = bool(torch.equal(early,
                                                            dev_counts))
        r["stop_at_count_is_bit_identical"] = bool(torch.equal(early, whole))
        if label == "empty_tiles":
            r["far_tiles_sum"] = float(early[10:64, 10:64, :].sum())
            r["ok"] = r["ok"] and r["far_tiles_sum"] == 0.0 and float(
                early[:8, :8, :8].sum()) > 0
        if label.startswith("split"):     # the case must really split
            r["ok"] = r["ok"] and r["split_tiles"] > 0
        r["ok"] = (r["ok"] and r["two_launches_bit_identical"]
                   and r["device_counts_bit_identical"]
                   and r["stop_at_count_is_bit_identical"])
        results.append(r)
        worst_small = max(worst_small, r["max_abs_err"])
        if not r["ok"]:
            emit("kernels", failed=r)
            fail(f"stkde_tile disagrees with its plain version at {label}")

    # ---- full size: PollenUS_Hr-Lb buckets at tile (32, 32, 16)
    inst = get_instance("PollenUS_Hr-Lb")
    dom, pts = inst.domain(), inst.points()
    before = stkde_tile.launch_count()
    st = staged_tile_path(pts, dom, timed_runs=5)
    t, tile, chunk, plan = st["inputs"], st["tile"], st["chunk"], st["plan"]
    args = (t.pts_tiles, t.valid_tiles, dom, tile)
    n = len(pts)

    again = stkde_tiles_cuda(*args, t.cap, n, chunk, mode="compiled",
                             counts=st["host_counts"])
    # the whole buckets under the main path's seg: bit-identical to it
    whole_seg_ms, whole_seg = cuda_ms(
        lambda: stkde_tiles_cuda(*args, t.cap, n, chunk, mode="compiled",
                                 seg=plan.seg),
        warmup=0, runs=1)
    whole_plan = stkde_tile.plan_segments(
        np.full(st["counts_host"].size, t.cap), plan.seg)
    # the whole buckets under their own default seg (one item a tile)
    padded_ms, whole = cuda_ms(
        lambda: stkde_tiles_cuda(*args, t.cap, n, chunk, mode="compiled"),
        warmup=1, runs=3)
    launches_here = stkde_tile.launch_count() - before

    # the reduction pass alone, on the main path's plan (scratch of zeros)
    lib = build.load("stkde_tile")
    reduce = torch.from_numpy(plan.reduce).cuda()
    scratch = torch.zeros(plan.slots * int(np.prod(tile)), device="cuda")
    sink = st["padded"].clone()
    reduce_ms, _ = cuda_ms(
        lambda: stkde_tile._reduce(lib, reduce, scratch, sink,
                                   tuple(t.pts_tiles.shape[:3]), tile),
        warmup=1, runs=5)
    del scratch, sink

    plain_ms, want = cuda_ms(
        lambda: stkde_tiles_ref(*args, n, counts=t.counts), warmup=1, runs=3)
    plain_padded_ms, want_padded = cuda_ms(
        lambda: stkde_tiles_ref(*args, n), warmup=0, runs=1)
    support = ks_support_share(t, dom, tile)

    scale = float(want.abs().max())
    atol = FULL_TOL["atol_rel_to_max"] * scale
    full = compare(st["padded"], want, FULL_TOL["rtol"], atol)
    full_padded = compare(whole, want_padded, FULL_TOL["rtol"], atol)
    two_launches = bool(torch.equal(st["padded"], again))
    bit_identical = bool(torch.equal(st["padded"], whole_seg))
    counts = st["counts_host"]
    b_useful = st["bounds"]["useful"]
    kernel_ms = st["times"]["kernel_ms"]
    full_size = {
        "instance": inst.name, "n": n, "grid": list(dom.grid_shape),
        **st["shape"],
        "max_load": int(counts.max()), "mean_load": float(counts.mean()),
        "tolerance": {"rtol": FULL_TOL["rtol"], "atol": atol,
                      "why": "fp32 sums of up to cap terms in another order"},
        "vs_plain": full, "padded_vs_plain_padded": full_padded,
        "two_launches_bit_identical": two_launches,
        "stop_at_count_is_bit_identical": bit_identical,
        "whole_under_same_seg": {"ms": whole_seg_ms,
                                 **plan_fields(whole_plan, tile)},
        "launches": launches_here,
        "kernel_ms": kernel_ms, "reduction_ms": reduce_ms,
        "wrapper_ms": st["times"]["wrapper_ms"],
        "kernel_padded_ms": padded_ms,
        "plain_ms": plain_ms, "plain_padded_ms": plain_padded_ms,
        "share_of_bound": b_useful["bound_ms"] / kernel_ms,
        "share_of_fp32_bound": b_useful["fp32_form"]["bound_ms"] / kernel_ms,
        "bound_useful": b_useful,
        "bound_as_launched": st["bounds"]["as_launched"],
        "bound_padded": st["bounds"]["padded"],
        "ks_support": support,
        "stage_times": st["times"],
    }
    emit("kernels", kernels=[{
        "name": "stkde_tile", "small_cases": results,
        "small_tolerance": SMALL_TOL, "full_size": full_size}])
    if not (full["ok"] and full_padded["ok"] and bit_identical
            and two_launches and plan.max_segment <= plan.seg):
        fail("stkde_tile disagrees with its plain version, or with itself, "
             "at full size")
    return {
        "max_abs_err": max(full["max_abs_err"], full_padded["max_abs_err"],
                           worst_small),
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": b_useful["bound_ms"], "bound_by": b_useful["bound_by"],
        "pollen_grid": st["grid"], "pollen_times": st["times"],
        "pollen_shape": st["shape"], "pollen_bounds": st["bounds"],
    }


def phase_main_path(kern: dict) -> int:
    """``stkde`` through the public entry point with the default device, both
    branches, on two Table-2 rows at full n. Returns the kernel's launches."""
    from repro_torch.core import get_instance, stkde
    from repro_torch.kernels import stkde_tile

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
    stkde_tile.reset_launch_count()
    runs = []
    for inst, dom, pts in data:
        _, tile_first_s = timed_query(pts, dom, True)
        tiled, tile_s = timed_query(pts, dom, True)
        _, scatter_first_s = timed_query(pts, dom, False)
        scatter, scatter_s = timed_query(pts, dom, False)
        runs.append((inst, dom, pts, tiled, scatter, tile_s, scatter_s,
                     tile_first_s, scatter_first_s))
    launches = stkde_tile.launch_count()

    rows = []
    ok = launches == 2 * len(data)
    for (inst, dom, pts, tiled, scatter, tile_s, scatter_s, tile_first_s,
         scatter_first_s) in runs:
        if inst.name == "PollenUS_Hr-Lb":   # staged in the kernels phase
            st = {"grid": kern["pollen_grid"], "times": kern["pollen_times"],
                  "shape": kern["pollen_shape"],
                  "bounds": kern["pollen_bounds"]}
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
            "kernel_bound_useful_ms": st["bounds"]["useful"]["bound_ms"],
        }
        row["ok"] = (row["shape_ok"] and row["finite"] and agree["ok"]
                     and row["same_as_staged_run"] and tiled.is_cuda
                     and scatter.is_cuda and tiled.dtype == torch.float32
                     and 0.0 < row["mass_tiled"] <= 1.001)
        ok = ok and row["ok"]
        rows.append(row)
    emit("main_path", launches=launches, instances=rows)
    if not ok:
        fail("main path: a check failed (see the main_path line)")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    import repro_torch.kernels  # noqa: F401  (fails here without the port)

    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    launches = phase_main_path(kern)
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "stkde_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stkde_tile.cu",
        "replaces": "src/repro/kernels/stkde_tile.py:63",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
