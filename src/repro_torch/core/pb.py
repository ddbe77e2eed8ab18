"""Point-based STKDE algorithms: PB, PB-DISK, PB-BAR, PB-SYM.

Algorithm 2/3 of the paper: stream over points, each point scatter-adds its
bandwidth cylinder into the grid. The four variants differ in how much of the
kernel evaluation is hoisted out of the cylinder loop:

  PB       evaluates ks*kt per cylinder voxel              (no hoisting)
  PB-DISK  hoists the spatial invariant Ks[X,Y]            (Algorithm 3, half)
  PB-BAR   hoists the temporal invariant Kt[T]
  PB-SYM   hoists both; cylinder work is a pure outer product Ks ⊗ Kt

All variants produce identical grids; they exist separately so a Table-3
benchmark can reproduce the paper's flop-reduction story. The redundant work
in PB / PB-DISK / PB-BAR is expressed through *materialized* broadcasts, which
eager PyTorch really performs.

``_pb_impl`` has two scatters that share no code (``scatter_route`` picks):

  kernel  ``kernels/csrc/stkde_scatter.cu``, one launch of a hand-written
          CUDA kernel that adds each point's non-zero, in-grid pairs with
          atomics: CUDA points, PB-SYM, ``deterministic=False`` and kernel
          functions with a CUDA id (the single query and the mesh shards).
  loop    plain PyTorch on whatever device it is given: blocks of points,
          each materialising its ``(B, Dx*Dy*Dt)`` indices and values for
          ``index_add_``. Everything else: CPU tensors (every CPU test), the
          PB / PB-DISK / PB-BAR variants, the chunked path's fixed order,
          callables without an id.

On CUDA both add with atomics, so the order of each voxel's sum, and with
it the last bits of the result, change from run to run; ``_pb_impl``'s
``deterministic`` switch (taken by the chunked path) sends the loop's blocks
through ``_add_in_order``, a fixed order. The loop on the card is the
kernel's yardstick (``chip_smoke.py``); the tile kernel
(``repro_torch.kernels``) is cross-tested against both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .geometry import Domain
from . import kernels_math as km

VARIANTS = ("pb", "disk", "bar", "sym")


def _cylinder_values(
    pts: torch.Tensor,  # (B, 3)
    vox: torch.Tensor,  # (B, 3) int32 home voxels
    dom: Domain,
    variant: str,
    ks: km.SpatialKernel,
    kt: km.TemporalKernel,
    n_total: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel values + linear indices for a block of points.

    Returns (lin_idx, vals), both (B, Dx*Dy*Dt). Out-of-grid voxels get
    lin_idx == grid_size (the drop slot of the scatter buffer).
    """
    Hs, Ht = dom.Hs, dom.Ht
    Dx = Dy = 2 * Hs + 1
    Dt = 2 * Ht + 1
    B = pts.shape[0]
    Gx, Gy, Gt = dom.grid_shape
    gsz = Gx * Gy * Gt
    dev = pts.device

    vox = vox.to(torch.int64)
    dx = torch.arange(-Hs, Hs + 1, device=dev)
    dt = torch.arange(-Ht, Ht + 1, device=dev)
    X = vox[:, 0:1] + dx[None, :]                    # (B, Dx)
    Y = vox[:, 1:2] + dx[None, :]                    # (B, Dy)
    T = vox[:, 2:3] + dt[None, :]                    # (B, Dt)

    # voxel-center coordinates of the cylinder bbox; the bandwidths are
    # device tensors so that the division is a true one on CUDA too
    hs = torch.tensor(dom.hs, dtype=torch.float32, device=dev)
    ht = torch.tensor(dom.ht, dtype=torch.float32, device=dev)
    xc = dom.ox + (X.to(torch.float32) + 0.5) * dom.sres
    yc = dom.oy + (Y.to(torch.float32) + 0.5) * dom.sres
    tc = dom.ot + (T.to(torch.float32) + 0.5) * dom.tres
    u = (xc - pts[:, 0:1]) / hs                      # (B, Dx)
    v = (yc - pts[:, 1:2]) / hs                      # (B, Dy)
    w = (tc - pts[:, 2:3]) / ht                      # (B, Dt)

    norm = km.normalization(n_total, dom.hs, dom.ht)
    shape3 = (B, Dx, Dy, Dt)

    def _pin(x: torch.Tensor) -> torch.Tensor:
        """Materialize a broadcast for real, so each variant performs the
        flops the scalar algorithm it models would perform."""
        return x.expand(shape3).contiguous()

    if variant == "sym":
        Ks = ks(u[:, :, None], v[:, None, :]) * norm         # (B, Dx, Dy)
        Kt = kt(w)                                           # (B, Dt)
        vals = Ks[:, :, :, None] * Kt[:, None, None, :]
    elif variant == "disk":
        Ks = ks(u[:, :, None], v[:, None, :]) * norm
        W = _pin(w[:, None, None, :])
        vals = Ks[:, :, :, None] * kt(W)
    elif variant == "bar":
        Kt = kt(w) * norm
        U = _pin(u[:, :, None, None])
        V = _pin(v[:, None, :, None])
        vals = ks(U, V) * Kt[:, None, None, :]
    elif variant == "pb":
        U = _pin(u[:, :, None, None])
        V = _pin(v[:, None, :, None])
        W = _pin(w[:, None, None, :])
        vals = ks(U, V) * kt(W) * norm
    else:
        raise ValueError(f"unknown variant {variant!r}")

    # linear indices with out-of-bounds -> gsz (dropped)
    okx = (X >= 0) & (X < Gx)
    oky = (Y >= 0) & (Y < Gy)
    okt = (T >= 0) & (T < Gt)
    px = torch.where(okx, X * (Gy * Gt), gsz)
    py = torch.where(oky, Y * Gt, gsz)
    ptt = torch.where(okt, T, gsz)
    lin = (
        px[:, :, None, None] + py[:, None, :, None] + ptt[:, None, None, :]
    )
    lin = torch.clamp(lin, max=gsz)                  # keep within drop range
    return lin.reshape(B, -1), vals.reshape(B, -1)


def _block_size(dom: Domain, budget_elems: int) -> int:
    per_point = dom.cylinder_voxels
    return max(1, min(4096, budget_elems // max(1, per_point)))


def _padded_blocks(points: torch.Tensor, dom: Domain, B: int):
    """Points padded to whole blocks of ``B`` and their unclipped home
    voxels, both ``(nblocks, B, 3)``."""
    n = points.shape[0]
    nblocks = -(-n // B)
    pad = nblocks * B - n
    pts = torch.nn.functional.pad(points.to(torch.float32), (0, 0, 0, pad))
    # padded points are parked outside every grid cylinder via a huge coord
    if pad:
        pts[n:, 0] = float(np.float32(dom.ox - 1e8))
    # Unclipped home voxels: points outside this (possibly local) domain
    # still contribute the in-domain part of their cylinder; fully
    # out-of-reach voxels land in the drop slot.
    vox = dom.point_voxels_unclipped(pts)
    return pts.reshape(nblocks, B, 3), vox.reshape(nblocks, B, 3)


def _add_in_order(grid: torch.Tensor, lin: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``grid[lin] += vals`` with each voxel's terms summed in one fixed
    order, whatever the device: the indices are stable-sorted (as 32-bit
    keys; every grid the scatter takes is below 2^30 voxels), each run of
    equal indices is summed by ``segment_reduce``, and every voxel then gets
    exactly one add, so atomics cannot reorder anything."""
    keys, order = torch.sort(lin.to(torch.int32), stable=True)
    voxels, counts = torch.unique_consecutive(keys, return_counts=True)
    sums = torch.segment_reduce(vals[order], "sum", lengths=counts,
                                unsafe=True)
    grid.index_add_(0, voxels.to(torch.int64), sums)


def scatter_route(device_type: str, variant: str, deterministic: bool,
                  ks, kt) -> str:
    """The scatter ``_pb_impl`` runs: ``"kernel"`` for points on a CUDA
    device, the PB-SYM variant, atomic adds and kernel functions the CUDA
    kernels have an id for; ``"loop"`` otherwise."""
    if (device_type == "cuda" and variant == "sym" and not deterministic
            and km.known_to_kernels(ks, kt)):
        return "kernel"
    return "loop"


def _pb_impl(
    points: torch.Tensor,
    dom: Domain,
    variant: str,
    ks,
    kt,
    budget_elems: int,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """The scatter, by the route ``scatter_route`` picks. ``deterministic=
    True`` (taken by the chunked path) makes a CUDA grid come out with the
    same bits on every run: each block of the loop is added by
    ``_add_in_order`` in place of ``index_add_``, whose atomics add in an
    order that changes from run to run. On the CPU ``index_add_`` adds in
    order, so nothing changes there."""
    n = points.shape[0]
    n_norm = n if n_total is None else n_total
    if dom.grid_voxels >= 2**30:
        raise ValueError(
            "scatter-path PB needs grid < 2^30 voxels; use the tiled kernel "
            "or the distributed strategies for larger grids"
        )
    route = scatter_route(points.device.type, variant, deterministic, ks, kt)
    with obs_trace.span("stkde.scatter", device=points.device) as sp:
        if route == "kernel":
            return _scatter_kernel(points, dom, ks, kt, n_norm, sp)
        return _scatter_loop(points, dom, variant, ks, kt, budget_elems,
                             n_norm, deterministic, sp)


def _scatter_kernel(points, dom, ks, kt, n_norm, sp) -> torch.Tensor:
    """One launch of ``csrc/stkde_scatter.cu``; the span gets the route and
    the launches counted while it ran."""
    from ..kernels import stkde_scatter

    launches = obs_metrics.counter(stkde_scatter.LAUNCHES)
    before = launches.value
    grid = stkde_scatter.stkde_scatter_cuda(
        points.to(torch.float32).contiguous(), dom, n_norm, ks, kt)
    if sp.recording:
        sp.set(path="kernel", launches=int(launches.value - before))
    return grid


def _scatter_loop(points, dom, variant, ks, kt, budget_elems, n_norm,
                  deterministic, sp) -> torch.Tensor:
    """The blocked loop: ``index_add_`` (or ``_add_in_order``) of each
    block's materialised indices and values into a grid with a drop slot."""
    gsz = dom.grid_voxels
    pts_b, vox_b = _padded_blocks(points, dom,
                                  _block_size(dom, budget_elems))
    if sp.recording:
        sp.set(path="loop", blocks=len(pts_b), launches=0)
    grid = torch.zeros((gsz + 1,), dtype=torch.float32,
                       device=points.device)     # +1 slot absorbs drops
    in_order = deterministic and grid.is_cuda
    for p, v in zip(pts_b, vox_b):
        lin, vals = _cylinder_values(p, v, dom, variant, ks, kt, n_norm)
        if in_order:
            _add_in_order(grid, lin.reshape(-1), vals.reshape(-1))
        else:
            grid.index_add_(0, lin.reshape(-1), vals.reshape(-1))
    return grid[:gsz].reshape(dom.grid_shape)


def _as_points(points, device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    with obs_trace.span("stkde.h2d", device=dev) as sp:
        pts = torch.as_tensor(np.asarray(points, dtype=np.float32)
                              if not isinstance(points, torch.Tensor)
                              else points)
        if sp.recording:
            sp.set(bytes=pts.nbytes)
        return pts.to(dev)


def pb_eval_only(points, dom: Domain, variant: str = "sym",
                 ks: km.SpatialKernel = km.DEFAULT_KS,
                 kt: km.TemporalKernel = km.DEFAULT_KT,
                 budget_elems: int = 1 << 22,
                 device: DeviceLike = None) -> torch.Tensor:
    """Kernel-evaluation phase only (no scatter): the fp32 sum of every
    cylinder value, block by block, as a 0-dim tensor on ``device``. Times
    the compute phase the paper's Table 3 differentiates; the scatter is
    variant-independent."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    pts = _as_points(points, device)
    pts_b, vox_b = _padded_blocks(pts, dom, _block_size(dom, budget_elems))
    acc = torch.zeros((), dtype=torch.float32, device=pts.device)
    for p, v in zip(pts_b, vox_b):
        _, vals = _cylinder_values(p, v, dom, variant, ks, kt, len(pts))
        acc = acc + vals.sum()
    return acc


def pb(points, dom: Domain, variant: str = "sym",
       ks: km.SpatialKernel = km.DEFAULT_KS,
       kt: km.TemporalKernel = km.DEFAULT_KT,
       budget_elems: int = 1 << 22,
       n_total: Optional[int] = None,
       device: DeviceLike = None) -> torch.Tensor:
    """Point-based STKDE. ``variant`` in {"pb", "disk", "bar", "sym"}.

    ``n_total`` overrides the normalization count (distributed callers pass
    the global point count while supplying only their local shard).
    ``device=None`` means ``"cuda"``; the grid is returned on that device.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    return _pb_impl(_as_points(points, device), dom, variant, ks, kt,
                    budget_elems, n_total)


def pb_sym(points, dom: Domain, **kw) -> torch.Tensor:
    return pb(points, dom, variant="sym", **kw)
