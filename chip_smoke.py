#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

needs one NVIDIA Hopper card, ``nvcc`` and nothing else: it builds the CUDA
kernel from the sources in this checkout, holds it against its plain PyTorch
version on the card (small shapes and the full-size ``PollenUS_Hr-Lb``
buckets), then drives the port's main path — ``repro_torch.core.api.stkde``,
both branches — on two rows of the paper's Table 2 at full size
(``Dengue_Lr-Hb``, ``PollenUS_Hr-Lb``) and checks what comes out.

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

# Published peaks of one H100 SXM: fp32 outside the tensor cores, and HBM.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations of one ks evaluation times norm, counted from
# csrc/stkde_tile.cu (ks_eval + the multiplication by norm; a select is one).
C_KS = {"ks_epanechnikov": 8, "ks_paper_verbatim": 11}

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
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    big = want.abs() > max(atol, 1e-30)
    rel = float((err[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    return {"max_abs_err": float(err.max()), "max_rel_err": rel, "ok": ok}


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


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    seconds = time.perf_counter() - t0
    report = {n: [ln for ln in build.build_report(n).splitlines()
                  if "registers" in ln or "spill" in ln]
              for n in libs}
    emit("build", seconds=seconds, libraries=sorted(libs), ptxas=report)


def small_cases():
    """(label, dom, points, tile, chunk, ks, kt) of the reference's own
    kernel tests: five tile shapes, three chunk sizes, non-unit resolution
    and origin, both pairs of kernel functions, empty tiles."""
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
                          256, *pair))
    dom = Domain(gx=32, gy=32, gt=16, sres=1.0, tres=1.0, hs=3.0, ht=2.0)
    pts = clustered_events(600, dom, seed=11)
    for chunk in (8, 64, 256):
        cases.append((f"chunk{chunk}", dom, pts, None, chunk, *epan))
    dom = Domain(gx=20.0, gy=15.0, gt=30.0, sres=0.6, tres=2.2, hs=2.0,
                 ht=4.0, ox=-7.0, oy=3.0, ot=100.0)
    rng = np.random.default_rng(4)
    pts = (np.array([-7.0, 3.0, 100.0])
           + rng.random((300, 3)) * np.array([20.0, 15.0, 30.0])
           ).astype(np.float32)
    for pair in (epan, verb):
        cases.append((f"nonunit/{pair[0].__name__}", dom, pts, None, 256,
                      *pair))
    dom = Domain(gx=64, gy=64, gt=16, sres=1.0, tres=1.0, hs=2.0, ht=1.0)
    cases.append(("empty_tiles", dom, np.full((50, 3), 3.0, dtype=np.float32),
                  None, 256, *epan))
    return cases


def bound_ms(points_walked: int, tile, ntiles: int, c_ks: int) -> dict:
    """Least time the card could take: fp32 operations over the peak rate
    outside the tensor cores, against buckets read once and the padded grid
    written once over the memory rate."""
    bx, by, bt = tile
    ops = points_walked * bx * by * (c_ks + 2 * bt)
    nbytes = 16 * points_walked + 4 * ntiles * bx * by * bt + 4 * ntiles
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations": ops, "bytes": nbytes}


def staged_tile_path(pts: np.ndarray, dom, timed_runs: int) -> dict:
    """The tile branch of ``stkde`` stage by stage, each stage timed: host
    bucketing, copy to the card, kernel, slice + finite check."""
    from repro_torch import convert
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops, stkde_tiles_cuda
    from repro_torch.resilience import ensure_finite

    tile = ops.default_tile(dom)
    t0 = time.perf_counter()
    b, chunk = ops.prepare_tiles(pts, dom, tile)
    t1 = time.perf_counter()
    t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    kernel_ms, padded = cuda_ms(
        lambda: stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, tile, t.cap,
                                 len(pts), chunk, mode="compiled",
                                 counts=t.counts),
        warmup=1, runs=timed_runs)
    t3 = time.perf_counter()
    grid = ensure_finite(padded[: dom.Gx, : dom.Gy, : dom.Gt], "smoke.tiled")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts = b.counts.astype(np.int64)
    c_ks = C_KS[km.DEFAULT_KS.__name__]
    walked = int((-(-counts // chunk) * chunk).sum())
    return {
        "inputs": t, "chunk": chunk, "tile": tile, "grid": grid,
        "padded": padded, "counts_host": counts,
        "bounds": {
            "useful": bound_ms(int(counts.sum()), tile, counts.size, c_ks),
            "as_launched": bound_ms(walked, tile, counts.size, c_ks),
            "padded": bound_ms(counts.size * b.cap, tile, counts.size, c_ks),
        },
        "times": {"host_bucketing_s": t1 - t0, "h2d_s": t2 - t1,
                  "kernel_ms": kernel_ms, "slice_check_s": t4 - t3},
        "shape": {"ntiles": list(b.ntiles), "cap": b.cap, "chunk": chunk,
                  "copies_per_point": b.replication_factor,
                  "bucket_bytes": int(t.pts_tiles.nbytes
                                      + t.valid_tiles.nbytes)},
    }


def phase_kernels() -> dict:
    from repro_torch import convert
    from repro_torch.core import get_instance
    from repro_torch.kernels import ops, stkde_tiles_cuda, stkde_tiles_ref
    from repro_torch.kernels import stkde_tile

    results = []
    worst_small = 0.0
    for label, dom, pts, tile, chunk, ks, kt in small_cases():
        tile = ops.default_tile(dom) if tile is None else tile
        b, chunk_eff = ops.prepare_tiles(pts, dom, tile, chunk=chunk)
        t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap)
        args = (t.pts_tiles, t.valid_tiles, dom, tile)
        want = stkde_tiles_ref(*args, len(pts), ks, kt)
        early = stkde_tiles_cuda(*args, t.cap, len(pts), chunk_eff, ks, kt,
                                 mode="compiled", counts=t.counts)
        whole = stkde_tiles_cuda(*args, t.cap, len(pts), chunk_eff, ks, kt,
                                 mode="compiled")
        torch.cuda.synchronize()
        r = compare(early, want, **SMALL_TOL)
        r["label"] = label
        r["stop_at_count_is_bit_identical"] = bool(torch.equal(early, whole))
        if label == "empty_tiles":
            r["far_tiles_sum"] = float(early[10:64, 10:64, :].sum())
            r["ok"] = r["ok"] and r["far_tiles_sum"] == 0.0 and float(
                early[:8, :8, :8].sum()) > 0
        r["ok"] = r["ok"] and r["stop_at_count_is_bit_identical"]
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
    t, tile, chunk = st["inputs"], st["tile"], st["chunk"]
    args = (t.pts_tiles, t.valid_tiles, dom, tile)
    n = len(pts)

    padded_ms, whole = cuda_ms(
        lambda: stkde_tiles_cuda(*args, t.cap, n, chunk, mode="compiled"),
        warmup=1, runs=3)
    plain_ms, want = cuda_ms(
        lambda: stkde_tiles_ref(*args, n, counts=t.counts), warmup=1, runs=3)
    plain_padded_ms, want_padded = cuda_ms(
        lambda: stkde_tiles_ref(*args, n), warmup=0, runs=1)
    launches_here = stkde_tile.launch_count() - before

    scale = float(want.abs().max())
    atol = FULL_TOL["atol_rel_to_max"] * scale
    full = compare(st["padded"], want, FULL_TOL["rtol"], atol)
    full_padded = compare(whole, want_padded, FULL_TOL["rtol"], atol)
    bit_identical = bool(torch.equal(st["padded"], whole))
    counts = st["counts_host"]
    b_useful = st["bounds"]["useful"]
    full_size = {
        "instance": inst.name, "n": n, "grid": list(dom.grid_shape),
        **st["shape"],
        "max_load": int(counts.max()), "mean_load": float(counts.mean()),
        "tolerance": {"rtol": FULL_TOL["rtol"], "atol": atol,
                      "why": "fp32 sums of up to cap terms in another order"},
        "vs_plain": full, "padded_vs_plain_padded": full_padded,
        "stop_at_count_is_bit_identical": bit_identical,
        "launches": launches_here,
        "kernel_ms": st["times"]["kernel_ms"], "kernel_padded_ms": padded_ms,
        "plain_ms": plain_ms, "plain_padded_ms": plain_padded_ms,
        "bound_useful": b_useful,
        "bound_as_launched": st["bounds"]["as_launched"],
        "bound_padded": st["bounds"]["padded"],
        "stage_times": st["times"],
    }
    emit("kernels", kernels=[{
        "name": "stkde_tile", "small_cases": results,
        "small_tolerance": SMALL_TOL, "full_size": full_size}])
    if not (full["ok"] and full_padded["ok"] and bit_identical):
        fail("stkde_tile disagrees with its plain version at full size")
    return {
        "max_abs_err": max(full["max_abs_err"], full_padded["max_abs_err"],
                           worst_small),
        "ms": st["times"]["kernel_ms"], "plain_ms": plain_ms,
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
