"""PB-SYM tile accumulation on Hopper: the wrapper of ``csrc/stkde_tile.cu``.

The paper's PB-SYM observation — each point's contribution factors into a
spatial disk ``Ks[X, Y]`` and a temporal bar ``Kt[T]`` — makes a grid tile's
density a contraction over its candidate points,

    density[bx, by, bt]  =  sum_p Ks_p[bx, by] * Kt_p[bt]

which the CUDA kernel computes on the tensor cores (3xTF32), with the points
arriving in packed overlap buckets (``core/bucketing.py::PackedBuckets``:
every tile's copies in one run, found by its offset). Tiles hold very
different numbers of points, so the kernel's grid is not the tiles but a
plan of work items (``plan_segments``): each item is at most ``seg``
consecutive points of one tile, a heavy tile is split over many blocks, and
a second small pass adds the partial tiles in a fixed order. See the note at
the top of the ``.cu`` for what bounds it and what the design does about
that.

Where the tensors live decides what runs: CUDA tensors launch the kernel (or
raise ``KernelUnavailableError``), CPU tensors run the plain version
``ref.stkde_tiles_ref``. Nothing falls back from the one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import bucketing
from ..core.geometry import Domain
from ..core import kernels_math as km
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..resilience.errors import KernelUnavailableError
from . import build
from .ref import stkde_tiles_ref

# execution modes of the tile kernel's entry points
MODES = ("auto", "reference", "compiled")

# dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448
# points the kernel stages per panel (PANEL in the .cu); seg is a multiple
PANEL = 64
# work items per block slot of the card that the default seg aims for
WAVES = 4
# the registry counter of the kernel's launches (split pass and reduction
# of one plan count once)
LAUNCHES = "stkde_tile.launches"


class SegmentPlan(NamedTuple):
    """The split pass's work items and the reduction's table.

    ``items`` (n_items, 4) int32: tile, first point, length, scratch slot
    (-1 for a tile's first item, which writes straight into the grid),
    heaviest first. ``reduce`` (n_split, 3) int32: tile, first slot, number
    of slots, for every tile split over more than one item; a tile's slots
    are consecutive and in the order of its points.
    """

    seg: int
    items: np.ndarray
    reduce: np.ndarray

    @property
    def segments(self) -> int:
        return len(self.items)

    @property
    def max_segment(self) -> int:
        return int(self.items[:, 2].max()) if len(self.items) else 0

    @property
    def slots(self) -> int:
        return int(self.reduce[:, 2].sum()) if len(self.reduce) else 0


def walked_pairs(plan: SegmentPlan, tile: Tuple[int, int, int]) -> int:
    """(point, voxel) pairs the split pass multiplies for ``plan``, as
    ``csrc/stkde_tile.cu`` walks them: an item of ``length`` points walks
    its panels in k-steps of 8 points, the last panel only up to the k-step
    that holds its last point (``nk``), so ``8 * ceil(length / 8)`` points,
    each against the ``bx * by * bt`` voxels of its tile."""
    lengths = plan.items[:, 2].astype(np.int64)
    return int(((lengths + 7) // 8 * 8).sum()) * int(np.prod(tile))


def plan_counts(plan: SegmentPlan, slots: int,
                tile: Tuple[int, int, int]) -> dict:
    """What the ``stkde.tile.plan`` span reports of a plan: its tiles (each
    has an item), work items, split tiles and ``seg``; the point copies in
    the buckets (``copies``, the items' lengths, which sum to the loads) and
    the slots of the packed buckets they sit in (``slots``); and the pairs
    the kernel walks."""
    tiles = int(plan.items[:, 0].max()) + 1 if plan.segments else 0
    return {"tiles": tiles, "items": plan.segments,
            "split_tiles": len(plan.reduce), "seg": plan.seg,
            "copies": int(plan.items[:, 2].astype(np.int64).sum()),
            "slots": int(slots), "walked_pairs": walked_pairs(plan, tile)}


def choose_seg(total_walk: int, sms: int, blocks_per_sm: int,
               panel: int = PANEL) -> int:
    """Longest work item: the total walk over about ``WAVES`` waves of the
    card's block slots, rounded up to a multiple of ``panel``."""
    if min(sms, blocks_per_sm, panel) < 1:
        raise ValueError(
            f"sms, blocks_per_sm and panel must be positive; got {sms}, "
            f"{blocks_per_sm}, {panel}")
    items = WAVES * sms * blocks_per_sm
    seg = -(-max(int(total_walk), 1) // items)
    return -(-seg // panel) * panel


def plan_segments(loads, seg: int) -> SegmentPlan:
    """Cut each tile's walk ``[0, loads[tile])`` into items of at most
    ``seg`` points, at multiples of ``seg``. A tile of ``c`` points gets
    ``ceil(c / seg)`` items, an empty tile one empty item (so that it is
    still written, as exact 0.0)."""
    if seg < 1:
        raise ValueError(f"seg must be positive; got {seg}")
    loads = np.asarray(loads, dtype=np.int64).reshape(-1)
    if loads.size and loads.min() < 0:
        raise ValueError("tile loads must not be negative")
    tiles = np.arange(len(loads))
    nseg = np.maximum((loads + (seg - 1)) // seg, 1)
    start = np.cumsum(nseg) - nseg           # first item of each tile
    slot0 = start - tiles                    # first scratch slot of each tile
    tile = np.repeat(tiles, nseg)
    k = np.arange(len(tile)) - start[tile]   # index of the item in its tile
    items = np.empty((len(tile), 4), dtype=np.int64)
    items[:, 0] = tile
    items[:, 1] = k * seg
    items[:, 2] = np.minimum(loads[tile] - items[:, 1], seg)
    items[:, 3] = np.where(k > 0, slot0[tile] + k - 1, -1)
    items = items[np.argsort(-items[:, 2], kind="stable")]
    split = np.flatnonzero(nseg > 1)
    reduce = np.stack([split, slot0[split], nseg[split] - 1], axis=1)
    if items.size and items.max() >= 2**31:
        raise ValueError("the plan does not fit 32-bit ints")
    return SegmentPlan(int(seg), items.astype(np.int32),
                       reduce.astype(np.int32))


def _library() -> ctypes.CDLL:
    lib = build.load("stkde_tile")
    fn = lib.stkde_tile_launch
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * 3 + [i32] + [ptr] * 2 + [i32] * 6 + [f32] * 8
                       + [i32] * 2 + [ptr])
        fn.restype = i32
        lib.stkde_tile_reduce_launch.argtypes = (
            [ptr, i32, ptr, ptr] + [i32] * 5 + [ptr])
        lib.stkde_tile_reduce_launch.restype = i32
        lib.stkde_tile_smem_bytes.argtypes = [i32] * 2
        lib.stkde_tile_smem_bytes.restype = ctypes.c_longlong
        lib.stkde_tile_blocks_per_sm.argtypes = [i32] * 3
        lib.stkde_tile_blocks_per_sm.restype = i32
        lib.stkde_tile_panel.restype = i32
        if lib.stkde_tile_panel() != PANEL:
            raise KernelUnavailableError(
                f"csrc/stkde_tile.cu stages {lib.stkde_tile_panel()} points "
                f"a panel; the wrapper plans for {PANEL}")
    return lib


def blocks_per_sm(tile: Tuple[int, int, int], ks=km.DEFAULT_KS,
                  device=None) -> int:
    """Blocks of the split pass that one SM of ``device`` (``None``: the
    current CUDA device) holds for ``tile``."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _blocks_per_sm(index, tile[0], tile[1], km.spatial_kernel_id(ks))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, bx: int, by: int, ks_id: int) -> int:
    with torch.cuda.device(device):
        n = _library().stkde_tile_blocks_per_sm(bx, by, ks_id)
    if n < 1:
        raise KernelUnavailableError(
            f"no block of the tile kernel fits an SM for tile ({bx}, {by})")
    return n


def default_seg(loads, tile: Tuple[int, int, int], device,
                ks=km.DEFAULT_KS) -> int:
    """The ``seg`` the wrapper picks for these tile loads on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return choose_seg(int(np.asarray(loads).sum()), sms,
                      blocks_per_sm(tile, ks, device))


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)}; got "
            f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _reduce(lib: ctypes.CDLL, reduce: torch.Tensor, scratch: torch.Tensor,
            out: torch.Tensor, ntiles: Tuple[int, int, int],
            tile: Tuple[int, int, int]) -> None:
    """Add the split tiles' partials in ``scratch`` into ``out``, in slot
    order, on the current stream (the reduction pass alone)."""
    err = lib.stkde_tile_reduce_launch(
        reduce.data_ptr(), reduce.shape[0], scratch.data_ptr(),
        out.data_ptr(), ntiles[1], ntiles[2], *tile,
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise KernelUnavailableError(
            f"stkde_tile reduction launch failed with CUDA error {err} "
            f"(tile={tile} split tiles={reduce.shape[0]})")


class Prepared(NamedTuple):
    """What one launch needs besides the buckets: the plan on the host and,
    on the device, its items (n_items, 4) and reduction table (n_split, 3)."""

    lib: ctypes.CDLL
    plan: SegmentPlan
    items: torch.Tensor
    reduce: torch.Tensor
    tile: Tuple[int, int, int]
    ntiles: Tuple[int, int, int]
    ks_id: int
    kt_id: int
    norm: float
    dom: Domain


def _tile_loads(offsets: torch.Tensor, counts, ntiles: int) -> np.ndarray:
    """The tiles' loads on the host: the differences of the offsets (one
    copy back). ``counts`` (host or device, any shape of ``ntiles`` values),
    where given, must hold the same loads tile by tile: a load that is not
    its run's length would send the kernel into another tile's points, or
    past the last run."""
    runs = offsets.cpu().numpy()
    if runs.size and runs[0] != 0:
        raise ValueError(f"the first run starts at {runs[0]}, not at 0")
    loads = np.diff(runs)
    if counts is None:
        return loads
    given = torch.as_tensor(counts).cpu().numpy().astype(np.int64).reshape(-1)
    if given.size != ntiles:
        raise ValueError(f"counts hold {given.size} loads for {ntiles} tiles")
    wrong = np.flatnonzero(given != loads)
    if wrong.size:
        raise ValueError(
            f"counts differ from the offsets' runs at {wrong.size} tiles "
            f"(tile {wrong[0]}: {given[wrong[0]]} counted, a run of "
            f"{loads[wrong[0]]})")
    return loads


def _prepare(points, offsets, counts, dom, tile, cap, n_total, ks, kt,
             seg) -> Prepared:
    """Check the arguments, plan the work items on the host and start one
    non-blocking copy of the plan to the tensors' device."""
    ks_id = km.spatial_kernel_id(ks)
    kt_id = km.temporal_kernel_id(kt)
    bx, by, bt = tile
    nt = bucketing.num_tiles(dom, tile)
    ntiles = int(np.prod(nt))
    dev = points.device
    _check(points, "points", (points.shape[0], 3), torch.float32)
    _check(offsets, "offsets", (ntiles + 1,), torch.int64)
    if offsets.device != dev:
        raise ValueError("points and offsets must be on one device")
    if min(bx, by, bt) < 1:
        raise ValueError(f"tile must be positive; got tile={tile}")
    if ntiles >= 2**31 or bx * by * bt >= 2**31:
        raise ValueError(f"too many tiles ({ntiles}) or tile {tile} too "
                         "large")

    lib = _library()
    smem = lib.stkde_tile_smem_bytes(bx, by)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"a panel of {PANEL} points for tile {tile} needs {smem} bytes "
            f"of shared memory; a block has {MAX_SMEM_BYTES}: lower the tile")

    # the plan is made on the host, from the offsets copied back
    loads = _tile_loads(offsets, counts, ntiles)
    if loads.size and (loads.min() < 0 or loads.max() > cap
                       or loads.sum() != points.shape[0]):
        raise ValueError(
            f"the loads (largest {loads.max()}, {loads.sum()} in all) are "
            f"not runs of the {points.shape[0]} points under cap {cap}")
    if seg is None:
        seg = default_seg(loads, tile, dev, ks)
    plan = plan_segments(loads, seg)
    table = torch.from_numpy(
        np.concatenate([plan.items.reshape(-1), plan.reduce.reshape(-1)]))
    table = table.pin_memory().to(dev, non_blocking=True)
    n_items = plan.items.size
    return Prepared(lib, plan, table[:n_items].view(-1, 4),
                    table[n_items:].view(-1, 3), tuple(tile), nt, ks_id,
                    kt_id, km.normalization(n_total, dom.hs, dom.ht), dom)


def _run(prep: Prepared, points, offsets) -> torch.Tensor:
    """Launch the split pass and the reduction of a prepared plan on the
    current stream of the tensors' device; return the padded grid (not
    synchronised)."""
    bx, by, bt = prep.tile
    ntx, nty, ntt = prep.ntiles
    dev, dom, plan = points.device, prep.dom, prep.plan
    out = torch.empty((ntx * bx, nty * by, ntt * bt), dtype=torch.float32,
                      device=dev)
    scratch = torch.empty(plan.slots * bx * by * bt, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = prep.lib.stkde_tile_launch(
            points.data_ptr(), offsets.data_ptr(),
            prep.items.data_ptr(), plan.segments, out.data_ptr(),
            scratch.data_ptr(), ntx, nty, ntt, bx, by, bt,
            dom.ox, dom.oy, dom.ot, dom.sres, dom.tres, dom.hs, dom.ht,
            prep.norm, prep.ks_id, prep.kt_id,
            torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise KernelUnavailableError(
                f"stkde_tile kernel launch failed with CUDA error {err} "
                f"(tile={prep.tile} seg={plan.seg})")
        if plan.reduce.shape[0]:
            _reduce(prep.lib, prep.reduce, scratch, out, prep.ntiles,
                    prep.tile)
    return out


def _launch(points, offsets, counts, dom, tile, cap, n_total, ks, kt,
            seg) -> torch.Tensor:
    dev = points.device
    with obs_trace.span("stkde.tile.plan", device=dev) as sp:
        prep = _prepare(points, offsets, counts, dom, tile, cap, n_total,
                        ks, kt, seg)
        if sp.recording:
            sp.set(**plan_counts(prep.plan, points.shape[0], prep.tile))
    with obs_trace.span("stkde.tile.launch", device=dev):
        out = _run(prep, points, offsets)
    obs_metrics.counter(LAUNCHES).inc()
    return out


def stkde_tiles_cuda(
    points: torch.Tensor,   # (copies, 3) f32, packed overlap buckets
    offsets: torch.Tensor,  # (ntiles + 1,) int64
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: int,
    n_total: int,
    chunk: int = 256,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    mode: str = "auto",
    counts: Optional[torch.Tensor] = None,  # (ntx, nty, ntt) tile loads
    seg: Optional[int] = None,
) -> torch.Tensor:
    """Padded density grid (ntx*bx, nty*by, ntt*bt) from packed buckets
    (``convert.TileInputs``): tile ``t``'s points are
    ``points[offsets[t]:offsets[t + 1]]``, the tiles those of
    ``bucketing.num_tiles(dom, tile)`` in row-major order.

    ``mode`` selects what runs: ``"compiled"`` launches the CUDA kernel and
    raises ``KernelUnavailableError`` for CPU tensors; ``"reference"`` runs
    the plain PyTorch version wherever the tensors live; ``"auto"`` (default)
    launches the kernel for CUDA tensors and runs the plain version for CPU
    tensors. ``ks``/``kt`` must be callables of ``kernels_math`` when the
    kernel runs; the plain version takes any callable.

    The kernel's plan takes the loads from the offsets (one copy back).
    ``cap`` bounds them (``PackedBuckets.max_load``); a load past it is
    refused. ``counts`` (``PackedBuckets.loads`` or ``counts``, on the host
    or the device), where given, are checked against the offsets' runs tile
    by tile. ``seg`` is the longest work item of the kernel (``None``:
    ``default_seg``). ``chunk`` is the plain version's panel; the kernel
    stages its own ``PANEL``-point panels.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    on_cuda = points.is_cuda
    if mode == "compiled" and not on_cuda:
        raise KernelUnavailableError(
            "mode='compiled' needs CUDA tensors; the tile kernel has no CPU "
            "form (mode='reference' runs the plain version)")
    if mode == "reference" or not on_cuda:
        return stkde_tiles_ref(points, offsets, dom, tile, n_total, ks, kt,
                               panel=chunk)
    return _launch(points, offsets, counts, dom, tile, cap, n_total, ks, kt,
                   seg)
