"""Multi-device STKDE strategies — the paper's §4/§5 on a mesh of shards.

Strategy map (the reference package's ``distributed/stkde_dist.py``, same
names, layouts and fault sites):

  stkde_dr      PB-SYM-DR   points sharded over all devices, per-device full
                            grid, all-reduce. Pleasingly parallel; comm = grid.
  stkde_dd      PB-SYM-DD   grid block-sharded over a 2-D device grid; points
                            overlap-bucketed (cut-cylinder work overhead);
                            ZERO communication.
  stkde_pd      PB-SYM-PD   work-efficient owner-computes: points home-
                            bucketed, each device computes a halo-extended
                            local grid, halos folded into neighbors with
                            ppermute (races -> halo exchange).
  stkde_pd_xt   PD over an (X, T) device grid (Ht-wide temporal halos).
  stkde_pd_xyt  PD over an (X, Y, T) device grid (three fold phases).
  stkde_dd_lpt  PB-SYM-PD-SCHED   fine tiles, LPT load-aware placement
                            (scheduling -> placement), tile-soup assembly.
  stkde_hybrid  PB-SYM-PD-REP     mesh factored (rep × workers): each
                            bucket's points dealt over the rep axis, PD per
                            slice, psum over rep only. r=1 ⇒ PD, r=P ⇒ DR.

One controller runs every shard in row-major mesh order on the shard's
device (``mesh.Mesh``); halo bands and partial grids move between shards
through ``collectives``, which add in a fixed order. Per-shard compute is
the PB-SYM scatter ``core.pb._pb_impl`` normalised by the global ``n``. Its
adds are atomic on CUDA unless a caller asks for ``deterministic=True``
(the chunked path does, so that a resumed run keeps its bits).

Every ``build_*`` returns a function of the ``prepare_*`` tensors with the
reference's output layout; ``collectives=False`` skips the all-reduce /
halo folds and returns the device-stacked (or rep-stacked) partial grids —
the probe that splits a query's time into shard compute and collectives.
A shard walks only the prefix of its capacity-padded bucket that holds
valid points (``_used``): the padding is parked far outside the grid and
would add nothing.
Shifts and voxel centres are computed in float32 in the reference's order,
so that a point lands in the same voxel as there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import points_to_device
from ..core import bucketing, kernels_math as km
from ..core.geometry import Domain
from ..core.pb import _pb_impl
from ..obs import trace as obs_trace
from ..resilience import faults as _faults
from ..resilience.errors import DeviceLostError, FaultInjectedError
from . import partition
from .collectives import ppermute, psum
from .mesh import Mesh

PARK = -1e8  # parked coordinate for invalid/padded points
_PB_BUDGET = 1 << 22   # the scatter's block budget, as ``core.pb.pb``'s
_F32 = np.float32


def _pad_tile_grid(points, valid, A, B):
    """Pad bucket arrays to the full (A, B) device grid.

    ceil(G/A)*A can overshoot G, leaving fewer tiles than devices — the
    missing (edge) tiles are empty by construction."""
    na, nb = points.shape[:2]
    if na == A and nb == B:
        return points, valid
    pp = np.zeros((A, B) + points.shape[2:], points.dtype)
    vv = np.zeros((A, B) + valid.shape[2:], valid.dtype)
    pp[:na, :nb] = points
    vv[:na, :nb] = valid
    pp[vv == 0] = PARK
    return pp, vv


def _mesh_sizes(mesh: Mesh, axes) -> Tuple[int, ...]:
    return tuple(mesh.shape[a] for a in axes)


def _park_invalid(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Move invalid bucket slots far outside every domain."""
    return torch.where(valid[..., None] > 0, pts, PARK)


def _used(bval: torch.Tensor) -> np.ndarray:
    """Per bucket, the length of the prefix of its slots that holds every
    valid point, on the host (one read of the card). The rest of a bucket
    is parked padding: its cylinders fall wholly outside the grid and add
    nothing, so a shard's scatter walks the prefix only."""
    slot = torch.arange(1, bval.shape[-1] + 1, dtype=torch.float32,
                        device=bval.device)
    return torch.where(bval > 0, slot, 0.0).amax(dim=-1).to(
        torch.int64).cpu().numpy()


def _to_mesh(arr, mesh: Mesh) -> torch.Tensor:
    """A prepared array on the mesh's first device: a host array is copied
    there once, a tensor already there is not copied. Each shard's slice
    moves on to its own device when the build runs."""
    if isinstance(arr, torch.Tensor):
        return arr.to(mesh.first_device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.first_device)


def _shift(device: torch.device, *components) -> torch.Tensor:
    """A shard's point shift as a float32 tensor; ``components`` are numpy
    float32 scalars computed in the reference's order."""
    return torch.from_numpy(np.array(components, dtype=_F32)).to(device)


def _scatter(p: torch.Tensor, dom: Domain, n: int, ks, kt,
             deterministic: bool) -> torch.Tensor:
    return _pb_impl(p, dom, "sym", ks, kt, _PB_BUDGET, n,
                    deterministic=deterministic)


def _each(shards: np.ndarray, fn: Callable) -> np.ndarray:
    """``fn`` applied to every shard's tensor."""
    out = np.empty(shards.shape, dtype=object)
    for idx in np.ndindex(shards.shape):
        out[idx] = fn(shards[idx])
    return out


def _add_into(dst: np.ndarray, fn: Callable, src: np.ndarray) -> None:
    """``fn(dst shard) += src shard`` in place, shard by shard."""
    for idx in np.ndindex(dst.shape):
        fn(dst[idx]).add_(src[idx])


def _stack(shards: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """Gather the shards onto the mesh's first device as one tensor of shape
    ``shards.shape + shard shape`` (the reference's device-stacked layout)."""
    dev = mesh.first_device
    flat = [t.to(dev) for t in shards.reshape(-1)]
    return torch.stack(flat).reshape(shards.shape + tuple(flat[0].shape))


# ------------------------------------------------------------------ DR
def prepare_dr(points: np.ndarray, dom: Domain, mesh: Mesh,
               axes) -> torch.Tensor:
    """Pad points to a multiple of the device count (PARK fills)."""
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    Ptot = int(np.prod(_mesh_sizes(mesh, axes)))
    npad = bucketing.round_up(max(n, Ptot), Ptot)
    full = np.full((npad, 3), PARK, dtype=np.float32)
    full[:n] = pts
    return _to_mesh(full, mesh)


def stkde_dr(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, ...] = ("data", "model"),
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """Domain replication: shard points, replicate grid, all-reduce.

    ``n_total`` overrides the normalization count — chunked execution
    passes the *global* point count while feeding a chunk at a time.
    """
    n = int(n_total) if n_total is not None else len(points)
    with obs_trace.span("stkde.dr", n=n, mesh=str(mesh.shape)):
        with obs_trace.span("stkde.dr.prepare"):
            full = prepare_dr(points, dom, mesh, axes)
            fn = build_dr(dom, mesh, axes, n, ks, kt,
                          deterministic=deterministic)
        with obs_trace.span("stkde.dr.execute"):
            return fn(full)


def build_dr(dom: Domain, mesh: Mesh, axes, n: int,
             ks=km.DEFAULT_KS, kt=km.DEFAULT_KT, collectives: bool = True,
             deterministic: bool = False):
    """DR over pre-sharded points.

    ``collectives=False`` runs the same per-device point work but skips
    the all-reduce, returning the device-stacked partial grids.
    """
    devs = mesh.devices_of(axes).reshape(-1)

    def f(full: torch.Tensor) -> torch.Tensor:
        local = full.reshape(len(devs), -1, 3)
        grids = np.empty(len(devs), dtype=object)
        for s, dev in enumerate(devs):
            grids[s] = _scatter(local[s].to(dev), dom, n, ks, kt,
                                deterministic)
        if collectives:
            return psum(grids, 0)[()]
        return _stack(grids, mesh)

    return f


# ------------------------------------------------------------------ DD
def _device_grid_dims(dom: Domain, A: int, B: int) -> Tuple[int, int]:
    return (math.ceil(dom.Gx / A), math.ceil(dom.Gy / B))


def _local_domain(dom: Domain, gx_loc: int, gy_loc: int,
                  halo: int = 0) -> Domain:
    """A device-local domain at canonical origin (points are shifted)."""
    return dataclasses.replace(
        dom,
        gx=(gx_loc + 2 * halo) * dom.sres,
        gy=(gy_loc + 2 * halo) * dom.sres,
        gt=dom.Gt * dom.tres,
    )


def prepare_dd(
    points: np.ndarray, dom: Domain, mesh: Mesh, axes,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlap-bucket points onto the (A, B) device grid (DD layout)."""
    A, B = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    b = bucketing.bucket_points_overlap(
        pts, dom, (gx_loc, gy_loc, dom.Gt), cap=cap
    )
    na, nb = b.ntiles[0], b.ntiles[1]
    bpts, bval = _pad_tile_grid(
        b.points.reshape(na, nb, b.cap, 3),
        b.valid.reshape(na, nb, b.cap).astype(np.float32), A, B)
    return _to_mesh(bpts, mesh), _to_mesh(bval, mesh)


def stkde_dd(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, str] = ("data", "model"),
    cap: Optional[int] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """Domain decomposition: block-sharded grid, overlap-routed points."""
    A, B = _mesh_sizes(mesh, axes)
    n = int(n_total) if n_total is not None else len(points)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    with obs_trace.span("stkde.dd", n=n, mesh=str(mesh.shape)):
        with obs_trace.span("stkde.dd.bucket"):
            bpts, bval = prepare_dd(points, dom, mesh, axes, cap=cap)
        fn = build_dd(dom, mesh, axes, n, ks, kt,
                      deterministic=deterministic)
        with obs_trace.span("stkde.dd.execute"):
            out = fn(bpts, bval)
            out = out.reshape(A, B, gx_loc, gy_loc, dom.Gt)
            out = out.permute(0, 2, 1, 3, 4).reshape(
                A * gx_loc, B * gy_loc, dom.Gt)
            return out[: dom.Gx, : dom.Gy, :]


def build_dd(dom: Domain, mesh: Mesh, axes, n: int,
             ks=km.DEFAULT_KS, kt=km.DEFAULT_KT,
             deterministic: bool = False):
    """DD over overlap-bucketed points; communication-free, so it has no
    ``collectives=False`` probe: the build is its own."""
    A, B = _mesh_sizes(mesh, axes)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    ldom = _local_domain(dom, gx_loc, gy_loc)
    devs = mesh.devices_of(axes)

    def f(bpts: torch.Tensor, bval: torch.Tensor) -> torch.Tensor:
        used = _used(bval)
        out = np.empty((A, B), dtype=object)
        for i, j in np.ndindex(A, B):
            dev, u = devs[i, j], used[i, j]
            p = _park_invalid(bpts[i, j, :u].to(dev), bval[i, j, :u].to(dev))
            shift = _shift(dev, _F32(i) * _F32(gx_loc) * _F32(dom.sres),
                           _F32(j) * _F32(gy_loc) * _F32(dom.sres), 0.0)
            out[i, j] = _scatter(p - shift, ldom, n, ks, kt, deterministic)
        return _stack(out, mesh)  # (A, B, gx_loc, gy_loc, Gt)

    return f


# ------------------------------------------------------------------ PD
def prepare_pd(
    points: np.ndarray, dom: Domain, mesh: Mesh, axes,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Home-bucket points onto the (A, B) device grid (PD layout)."""
    A, B = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    b = bucketing.bucket_points_home(
        pts, dom, (gx_loc, gy_loc, dom.Gt), cap=cap
    )
    na, nb = b.ntiles[0], b.ntiles[1]
    bp, bv = _pad_tile_grid(
        b.points.reshape(na, nb, b.cap, 3),
        b.valid.reshape(na, nb, b.cap).astype(np.float32), A, B)
    return _to_mesh(bp, mesh), _to_mesh(bv, mesh)


def stkde_pd(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, str] = ("data", "model"),
    cap: Optional[int] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
    _rep_axis: Optional[str] = None,
    _pts_override=None,
) -> torch.Tensor:
    """Work-efficient owner-computes + halo exchange (PB-SYM-PD)."""
    A, B = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    n = int(n_total) if n_total is not None else len(pts)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    Hs = dom.Hs
    if gx_loc < Hs or gy_loc < Hs:
        raise ValueError(
            f"PD requires subdomains >= bandwidth: local ({gx_loc},{gy_loc})"
            f" vs Hs={Hs}; use DD/DR or a coarser device grid"
            " (paper §5.1 constraint)"
        )
    strat = "pd" if _rep_axis is None else "hybrid"
    with obs_trace.span(f"stkde.{strat}", n=n, mesh=str(mesh.shape)):
        if _pts_override is None:
            with obs_trace.span(f"stkde.{strat}.bucket"):
                bpts, bval = prepare_pd(pts, dom, mesh, axes, cap=cap)
        else:  # hybrid path: (R, A, B, cap, 3) sharded over rep too
            bpts, bval = _pts_override
        # fault site dist.halo: an injected OOM here models a failed
        # strategy build (halo buffers are the PD-only allocation); the
        # api-level fallback then reroutes the query to the dr baseline.
        _faults.fault_point("dist.halo")
        fn = build_pd(dom, mesh, axes, n, ks, kt, rep_axis=_rep_axis,
                      deterministic=deterministic)
        with obs_trace.span(f"stkde.{strat}.execute"):
            out = fn(bpts, bval)
            out = out.reshape(A, B, gx_loc, gy_loc, dom.Gt)
            out = out.permute(0, 2, 1, 3, 4).reshape(
                A * gx_loc, B * gy_loc, dom.Gt)
            # nan-kind injection poisons the folded halos; callers
            # validate via resilience.degrade.ensure_finite
            return _faults.poison(
                "dist.halo", out[: dom.Gx, : dom.Gy, :])


def build_pd(dom: Domain, mesh: Mesh, axes, n: int,
             ks=km.DEFAULT_KS, kt=km.DEFAULT_KT, rep_axis=None,
             collectives: bool = True, deterministic: bool = False):
    """PD (owner-computes + halo exchange) over home-bucketed points.

    Input layout: (A, B, cap, 3) — or (R, A, B, cap, 3) with rep_axis for
    the hybrid/REP strategy. Output (A, B, gx_loc, gy_loc, Gt).
    ``collectives=False`` skips the halo ppermute folds (and rep psum) and
    returns the unfolded interiors (numerically incomplete by design),
    rep-stacked ``(R, A, B, ...)`` with rep_axis.
    """
    ax, ay = axes
    A, B = _mesh_sizes(mesh, axes)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    Hs = dom.Hs
    ldom = _local_domain(dom, gx_loc, gy_loc, halo=Hs)
    names = (ax, ay) if rep_axis is None else (rep_axis, ax, ay)
    devs = mesh.devices_of(names)
    dx, dy = len(names) - 2, len(names) - 1   # shard-array axes of X, Y

    def f(bpts: torch.Tensor, bval: torch.Tensor) -> torch.Tensor:
        used = _used(bval)
        L = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            i, j = idx[-2:]
            dev, u = devs[idx], used[idx]
            p = _park_invalid(bpts[idx][:u].to(dev), bval[idx][:u].to(dev))
            shift = _shift(
                dev,
                (_F32(i) * _F32(gx_loc) - _F32(Hs)) * _F32(dom.sres),
                (_F32(j) * _F32(gy_loc) - _F32(Hs)) * _F32(dom.sres), 0.0)
            L[idx] = _scatter(p - shift, ldom, n, ks, kt, deterministic)
        if not collectives:
            return _stack(_each(L, lambda g: g[Hs:Hs + gx_loc,
                                               Hs:Hs + gy_loc, :]), mesh)
        # ---- fold halos: X phase (full-y slabs), then Y phase (interior-x)
        from_left = ppermute(_each(L, lambda g: g[-Hs:]), devs, dx, 1)
        from_right = ppermute(_each(L, lambda g: g[:Hs]), devs, dx, -1)
        _add_into(L, lambda g: g[Hs:2 * Hs], from_left)
        _add_into(L, lambda g: g[gx_loc:gx_loc + Hs], from_right)

        interior = _each(L, lambda g: g[Hs:Hs + gx_loc])
        from_bot = ppermute(_each(interior, lambda g: g[:, -Hs:, :]), devs,
                            dy, 1)
        from_top = ppermute(_each(interior, lambda g: g[:, :Hs, :]), devs,
                            dy, -1)
        _add_into(interior, lambda g: g[:, Hs:2 * Hs], from_bot)
        _add_into(interior, lambda g: g[:, gy_loc:gy_loc + Hs], from_top)
        out = _each(interior, lambda g: g[:, Hs:Hs + gy_loc, :])
        if rep_axis is not None:
            out = psum(out, 0)
        return _stack(out, mesh)

    return f


def prepare_pd_xt(
    points: np.ndarray, dom: Domain, mesh: Mesh, axes,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Home-bucket points onto the (A, B) = (x-tile, t-tile) device grid."""
    A, B = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    gx_loc = math.ceil(dom.Gx / A)
    gt_loc = math.ceil(dom.Gt / B)
    b = bucketing.bucket_points_home(
        pts, dom, (gx_loc, dom.Gy, gt_loc), cap=cap
    )
    na, nt = b.ntiles[0], b.ntiles[2]
    bp, bv = _pad_tile_grid(
        b.points.reshape(na, nt, b.cap, 3),
        b.valid.reshape(na, nt, b.cap).astype(np.float32), A, B)
    return _to_mesh(bp, mesh), _to_mesh(bv, mesh)


def build_pd_xt(dom: Domain, mesh: Mesh, axes, n: int,
                ks=km.DEFAULT_KS, kt=km.DEFAULT_KT, rep_axis=None,
                collectives: bool = True, deterministic: bool = False):
    """PD split over (X, T) instead of (X, Y).

    The halo a subdomain exchanges is its boundary thickened by the
    bandwidth: splitting the *temporal* axis pays Ht-wide halos instead of
    Hs-wide ones. Input layout: (A, B, cap, 3) buckets over (x-tile,
    t-tile); output (A, B, gx_loc, Gy, gt_loc). ``collectives=False`` skips
    the halo ppermute folds (and rep psum) and returns the unfolded
    interiors (numerically incomplete by design).
    """
    ax, at = axes
    A, B = _mesh_sizes(mesh, axes)
    gx_loc = math.ceil(dom.Gx / A)
    gt_loc = math.ceil(dom.Gt / B)
    Hs, Ht = dom.Hs, dom.Ht
    if gx_loc < Hs or gt_loc < Ht:
        raise ValueError("PD-XT requires subdomains >= bandwidth")
    ldom = dataclasses.replace(
        dom,
        gx=(gx_loc + 2 * Hs) * dom.sres,
        gy=dom.Gy * dom.sres,
        gt=(gt_loc + 2 * Ht) * dom.tres,
    )
    names = (ax, at) if rep_axis is None else (rep_axis, ax, at)
    devs = mesh.devices_of(names)
    dx, dt = len(names) - 2, len(names) - 1

    def f(bpts: torch.Tensor, bval: torch.Tensor) -> torch.Tensor:
        used = _used(bval)
        L = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            i, j = idx[-2:]
            dev, u = devs[idx], used[idx]
            p = _park_invalid(bpts[idx][:u].to(dev), bval[idx][:u].to(dev))
            shift = _shift(
                dev, (_F32(i) * _F32(gx_loc) - _F32(Hs)) * _F32(dom.sres),
                0.0, (_F32(j) * _F32(gt_loc) - _F32(Ht)) * _F32(dom.tres))
            L[idx] = _scatter(p - shift, ldom, n, ks, kt, deterministic)
        if not collectives:
            return _stack(_each(L, lambda g: g[Hs:Hs + gx_loc, :,
                                               Ht:Ht + gt_loc]), mesh)
        # fold halos: X phase (full-t slabs), then T phase (interior-x)
        _add_into(L, lambda g: g[Hs:2 * Hs],
                  ppermute(_each(L, lambda g: g[-Hs:]), devs, dx, 1))
        _add_into(L, lambda g: g[gx_loc:gx_loc + Hs],
                  ppermute(_each(L, lambda g: g[:Hs]), devs, dx, -1))
        interior = _each(L, lambda g: g[Hs:Hs + gx_loc])
        _add_into(interior, lambda g: g[:, :, Ht:2 * Ht],
                  ppermute(_each(interior, lambda g: g[:, :, -Ht:]), devs,
                           dt, 1))
        _add_into(interior, lambda g: g[:, :, gt_loc:gt_loc + Ht],
                  ppermute(_each(interior, lambda g: g[:, :, :Ht]), devs,
                           dt, -1))
        out = _each(interior, lambda g: g[:, :, Ht:Ht + gt_loc])
        if rep_axis is not None:
            out = psum(out, 0)
        return _stack(out, mesh)

    return f


def stkde_pd_xt(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, str] = ("data", "model"),
    cap: Optional[int] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """PD with an (X, T) device grid (small temporal halos)."""
    A, B = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    n = int(n_total) if n_total is not None else len(pts)
    gx_loc = math.ceil(dom.Gx / A)
    gt_loc = math.ceil(dom.Gt / B)
    bpts, bval = prepare_pd_xt(pts, dom, mesh, axes, cap=cap)
    fn = build_pd_xt(dom, mesh, axes, n, ks, kt, deterministic=deterministic)
    out = fn(bpts, bval)
    out = out.reshape(A, B, gx_loc, dom.Gy, gt_loc)
    out = out.permute(0, 2, 3, 1, 4).reshape(
        A * gx_loc, dom.Gy, B * gt_loc)
    return out[: dom.Gx, :, : dom.Gt]


def prepare_pd_xyt(
    points: np.ndarray, dom: Domain, mesh: Mesh, axes,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Home-bucket points onto the (A, B, C) = (x, y, t) device grid."""
    A, B, C = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    gx_loc = math.ceil(dom.Gx / A)
    gy_loc = math.ceil(dom.Gy / B)
    gt_loc = math.ceil(dom.Gt / C)
    b = bucketing.bucket_points_home(
        pts, dom, (gx_loc, gy_loc, gt_loc), cap=cap
    )
    na, nb, nt = b.ntiles
    pp = np.full((A, B, C, b.cap, 3), PARK, dtype=np.float32)
    vv = np.zeros((A, B, C, b.cap), dtype=np.float32)
    pp[:na, :nb, :nt] = b.points
    vv[:na, :nb, :nt] = b.valid.astype(np.float32)
    return _to_mesh(pp, mesh), _to_mesh(vv, mesh)


def build_pd_xyt(dom: Domain, mesh: Mesh, axes, n: int,
                 ks=km.DEFAULT_KS, kt=km.DEFAULT_KT,
                 collectives: bool = True, deterministic: bool = False):
    """Full 3-D PD decomposition (the paper's A×B×C) over three mesh axes,
    with halo folds in all three directions (Hs, Hs, Ht wide); output
    (A, B, C, gx_loc, gy_loc, gt_loc). ``collectives=False`` skips all
    three fold phases and returns the unfolded interiors.
    """
    A, B, C = _mesh_sizes(mesh, axes)
    gx_loc = math.ceil(dom.Gx / A)
    gy_loc = math.ceil(dom.Gy / B)
    gt_loc = math.ceil(dom.Gt / C)
    Hs, Ht = dom.Hs, dom.Ht
    if gx_loc < Hs or gy_loc < Hs or gt_loc < Ht:
        raise ValueError("PD-XYT requires subdomains >= bandwidth")
    ldom = dataclasses.replace(
        dom,
        gx=(gx_loc + 2 * Hs) * dom.sres,
        gy=(gy_loc + 2 * Hs) * dom.sres,
        gt=(gt_loc + 2 * Ht) * dom.tres,
    )
    devs = mesh.devices_of(axes)

    def f(bpts: torch.Tensor, bval: torch.Tensor) -> torch.Tensor:
        used = _used(bval)
        L = np.empty(devs.shape, dtype=object)
        for i, j, k in np.ndindex(devs.shape):
            dev, u = devs[i, j, k], used[i, j, k]
            p = _park_invalid(bpts[i, j, k, :u].to(dev),
                              bval[i, j, k, :u].to(dev))
            shift = _shift(
                dev,
                (_F32(i) * _F32(gx_loc) - _F32(Hs)) * _F32(dom.sres),
                (_F32(j) * _F32(gy_loc) - _F32(Hs)) * _F32(dom.sres),
                (_F32(k) * _F32(gt_loc) - _F32(Ht)) * _F32(dom.tres))
            L[i, j, k] = _scatter(p - shift, ldom, n, ks, kt, deterministic)
        if not collectives:
            return _stack(_each(L, lambda g: g[Hs:Hs + gx_loc,
                                               Hs:Hs + gy_loc,
                                               Ht:Ht + gt_loc]), mesh)
        # X phase (full-(y,t) slabs) -> Y phase (interior-x) -> T phase
        _add_into(L, lambda g: g[Hs:2 * Hs],
                  ppermute(_each(L, lambda g: g[-Hs:]), devs, 0, 1))
        _add_into(L, lambda g: g[gx_loc:gx_loc + Hs],
                  ppermute(_each(L, lambda g: g[:Hs]), devs, 0, -1))
        ix = _each(L, lambda g: g[Hs:Hs + gx_loc])
        _add_into(ix, lambda g: g[:, Hs:2 * Hs],
                  ppermute(_each(ix, lambda g: g[:, -Hs:]), devs, 1, 1))
        _add_into(ix, lambda g: g[:, gy_loc:gy_loc + Hs],
                  ppermute(_each(ix, lambda g: g[:, :Hs]), devs, 1, -1))
        iy = _each(ix, lambda g: g[:, Hs:Hs + gy_loc])
        _add_into(iy, lambda g: g[:, :, Ht:2 * Ht],
                  ppermute(_each(iy, lambda g: g[:, :, -Ht:]), devs, 2, 1))
        _add_into(iy, lambda g: g[:, :, gt_loc:gt_loc + Ht],
                  ppermute(_each(iy, lambda g: g[:, :, :Ht]), devs, 2, -1))
        return _stack(_each(iy, lambda g: g[:, :, Ht:Ht + gt_loc]), mesh)

    return f


def stkde_pd_xyt(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, str, str] = ("pod", "data", "model"),
    cap: Optional[int] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """Paper-style 3-D decomposition across a three-axis mesh."""
    A, B, C = _mesh_sizes(mesh, axes)
    pts = np.asarray(points, dtype=np.float32)
    n = int(n_total) if n_total is not None else len(pts)
    gx_loc = math.ceil(dom.Gx / A)
    gy_loc = math.ceil(dom.Gy / B)
    gt_loc = math.ceil(dom.Gt / C)
    bpts, bval = prepare_pd_xyt(pts, dom, mesh, axes, cap=cap)
    fn = build_pd_xyt(dom, mesh, axes, n, ks, kt,
                      deterministic=deterministic)
    out = fn(bpts, bval)
    out = out.reshape(A, B, C, gx_loc, gy_loc, gt_loc)
    out = out.permute(0, 3, 1, 4, 2, 5).reshape(
        A * gx_loc, B * gy_loc, C * gt_loc)
    return out[: dom.Gx, : dom.Gy, : dom.Gt]


# ------------------------------------------------------------------ hybrid
def prepare_hybrid(
    points: np.ndarray, dom: Domain, mesh: Mesh, axes,
    rep_axis: str = "pod", cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Home-bucket points, then deal each bucket round-robin over ``rep``.

    Returns (R, A, B, cap_r, 3) points and (R, A, B, cap_r) valid masks —
    the input layout ``build_pd(..., rep_axis=...)`` expects.
    """
    A, B = _mesh_sizes(mesh, axes)
    R = mesh.shape[rep_axis]
    pts = np.asarray(points, dtype=np.float32)
    gx_loc, gy_loc = _device_grid_dims(dom, A, B)
    b = bucketing.bucket_points_home(
        pts, dom, (gx_loc, gy_loc, dom.Gt), cap=cap
    )
    na, nb = b.ntiles[0], b.ntiles[1]
    src, val = _pad_tile_grid(
        b.points.reshape(na, nb, b.cap, 3),
        b.valid.reshape(na, nb, b.cap).astype(np.float32), A, B)
    # deal bucket contents over R replicas
    cap_r = bucketing.round_up(max(1, -(-b.cap // R)), 8)
    dpts = np.full((R, A, B, cap_r, 3), PARK, dtype=np.float32)
    dval = np.zeros((R, A, B, cap_r), dtype=np.float32)
    pos = np.arange(b.cap)
    r_of = pos % R
    p_of = pos // R
    dpts[r_of, :, :, p_of] = np.transpose(src, (2, 0, 1, 3))
    dval[r_of, :, :, p_of] = np.transpose(val, (2, 0, 1)).astype(np.float32)
    return _to_mesh(dpts, mesh), _to_mesh(dval, mesh)


def stkde_hybrid(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, str] = ("data", "model"),
    rep_axis: str = "pod",
    cap: Optional[int] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """PD over the worker grid × DR over the ``rep`` axis (PB-SYM-PD-REP).

    Every bucket's points are dealt round-robin over the rep axis — the
    moldable-task replication of the paper expressed as a mesh dimension.
    """
    pts = np.asarray(points, dtype=np.float32)
    return stkde_pd(
        pts, dom, mesh, axes, cap=cap, ks=ks, kt=kt, n_total=n_total,
        deterministic=deterministic, _rep_axis=rep_axis,
        _pts_override=prepare_hybrid(
            pts, dom, mesh, axes, rep_axis=rep_axis, cap=cap),
    )


# ------------------------------------------------------------------ DD-LPT
def prepare_dd_lpt(
    points: np.ndarray, dom: Domain, mesh: Mesh, axes,
    tile: Optional[Tuple[int, int, int]] = None,
    cap: Optional[int] = None,
):
    """Fine-tile bucket + LPT placement for DD-LPT.

    The points are copied to the mesh's first device once and bucketed
    there; the host sees only the tiles' loads (for LPT). Each device's
    slots are one gather from the buckets.

    Returns ``((dpts, dval, dpos), ctx)``: the first element holds the
    arguments of the function ``build_dd_lpt`` returns; ``ctx`` carries the
    parameters (``tile``, ``k``, ``cap``, ``ntiles``) that ``build_dd_lpt``
    needs. A device's ``k`` slots hold its tiles in LPT order (heaviest
    first); slots past its last tile are empty.
    """
    A, B = _mesh_sizes(mesh, axes)
    Ptot = A * B
    if tile is None:
        tile = bucketing.default_tile(dom)
    bx, by, bt = tile
    dev = mesh.first_device
    b = bucketing.bucket_points_overlap(
        points_to_device(points, dev), dom, tile, cap=cap)
    ntx, nty, ntt = b.ntiles
    loads = b.counts.reshape(-1).cpu().numpy().astype(np.float64)
    assign = partition.lpt_assign(loads, Ptot)
    k = max(len(t) for t in assign.tiles_of_device)

    # (P, k) slot -> tile table; an empty slot gathers tile 0 and is then
    # parked (points PARK, valid 0, origin 0)
    slot_tile = np.zeros((Ptot, k), dtype=np.int64)
    empty = np.ones((Ptot, k), dtype=bool)
    for p, tiles in enumerate(assign.tiles_of_device):
        slot_tile[p, :len(tiles)] = tiles
        empty[p, :len(tiles)] = False
    ti, tj, tk = np.unravel_index(slot_tile, (ntx, nty, ntt))
    dpos = np.stack([ti * bx, tj * by, tk * bt], axis=-1).astype(np.int32)
    dpos[empty] = 0

    capn = b.cap
    idx = torch.from_numpy(slot_tile).to(dev)
    gone = torch.from_numpy(empty).to(dev)
    dpts = b.points.reshape(-1, capn, 3)[idx]
    dpts[gone] = PARK
    dval = b.valid.reshape(-1, capn)[idx].to(torch.float32)
    dval[gone] = 0.0
    del b
    args = (_to_mesh(dpts, mesh), _to_mesh(dval, mesh), _to_mesh(dpos, mesh))
    ctx = {"tile": tile, "k": k, "cap": capn, "ntiles": (ntx, nty, ntt)}
    return args, ctx


def _tile_batches(used: np.ndarray, per_point: int, budget_elems: int):
    """``(first, stop, cut)`` batches of consecutive slots whose
    ``(slots, cut, bx, by)`` panel holds at most ``budget_elems`` values
    (at least one slot); ``cut`` is the batch's longest used prefix. Slots
    with nothing in them are skipped: they add exact zeros."""
    s, k = 0, len(used)
    while s < k:
        if used[s] == 0:
            s += 1
            continue
        e, cut = s + 1, int(used[s])
        while e < k and used[e] > 0 and \
                (e + 1 - s) * max(cut, int(used[e])) * per_point \
                <= budget_elems:
            cut = max(cut, int(used[e]))
            e += 1
        yield s, e, cut
        s = e


def build_dd_lpt(dom: Domain, mesh: Mesh, axes, n: int,
                 tile: Tuple[int, int, int], k: int, cap: int,
                 ntiles: Tuple[int, int, int],
                 ks=km.DEFAULT_KS, kt=km.DEFAULT_KT,
                 collectives: bool = True, deterministic: bool = False,
                 budget_elems: int = 1 << 26):
    """DD-LPT over the LPT-placed tile soup.

    Parameters (``tile``, ``k``, ``cap``, ``ntiles``) come from
    ``prepare_dd_lpt``'s ctx. Each device computes its tiles with the
    separable contraction ``einsum("pxy,pt->xyt")`` in batches of tiles
    whose ``Ks`` panel holds at most ``budget_elems`` values, each tile cut
    to its used prefix of the capacity (the padded rest would add exact
    zeros), and places each batch's tiles into its grid with one
    ``index_add_`` (a device's tiles are disjoint). ``collectives=False``
    skips the tile-soup assembly psum and returns the device-stacked
    partial grids. (The product is deterministic: ``deterministic`` is
    accepted for a uniform signature.)
    """
    del deterministic, cap, k
    bx, by, bt = tile
    ntx, nty, ntt = ntiles
    Gxp, Gyp, Gtp = ntx * bx, nty * by, ntt * bt
    norm = km.normalization(n, dom.hs, dom.ht)
    devs = mesh.devices_of(axes).reshape(-1)

    def centres(pos: np.ndarray, size: int, origin: float,
                res: float) -> np.ndarray:
        """Voxel centres of tiles at ``pos`` along one axis, float32, in the
        reference's order: origin + (pos + iota + 0.5) * res."""
        return _F32(origin) + (pos.astype(_F32)[:, None]
                               + np.arange(size, dtype=_F32)
                               + _F32(0.5)) * _F32(res)

    def f(dpts: torch.Tensor, dval: torch.Tensor,
          dpos: torch.Tensor) -> torch.Tensor:
        used = _used(dval)
        pos = dpos.cpu().numpy()
        grids = np.empty(len(devs), dtype=object)
        for s, dev in enumerate(devs):
            hs = torch.tensor(dom.hs, dtype=torch.float32, device=dev)
            ht = torch.tensor(dom.ht, dtype=torch.float32, device=dev)
            # offset of each voxel of a tile from the tile's origin in g
            offs = ((torch.arange(bx, device=dev)[:, None, None] * Gyp
                     + torch.arange(by, device=dev)[None, :, None]) * Gtp
                    + torch.arange(bt, device=dev)[None, None, :])
            g = torch.zeros((Gxp, Gyp, Gtp), dtype=torch.float32, device=dev)
            for a, e, cut in _tile_batches(used[s], bx * by, budget_elems):
                p = dpts[s, a:e, :cut].to(dev)                # (T, cut, 3)
                val = dval[s, a:e, :cut].to(dev)              # (T, cut)
                xc = torch.from_numpy(centres(pos[s, a:e, 0], bx, dom.ox,
                                              dom.sres)).to(dev)
                yc = torch.from_numpy(centres(pos[s, a:e, 1], by, dom.oy,
                                              dom.sres)).to(dev)
                tc = torch.from_numpy(centres(pos[s, a:e, 2], bt, dom.ot,
                                              dom.tres)).to(dev)
                u = (xc[:, None, :] - p[:, :, 0:1]) / hs      # (T, cut, bx)
                v = (yc[:, None, :] - p[:, :, 1:2]) / hs      # (T, cut, by)
                w = (tc[:, None, :] - p[:, :, 2:3]) / ht      # (T, cut, bt)
                Ks = ks(u[:, :, :, None], v[:, :, None, :]) * norm
                Kt = kt(w) * val[:, :, None]
                tiles = torch.einsum("spxy,spt->sxyt", Ks, Kt)
                # a device's tiles are disjoint: each voxel gets one value
                base = torch.from_numpy(
                    (pos[s, a:e, 0].astype(np.int64) * Gyp
                     + pos[s, a:e, 1]) * Gtp + pos[s, a:e, 2]).to(dev)
                g.view(-1).index_add_(
                    0, (base[:, None, None, None] + offs).reshape(-1),
                    tiles.reshape(-1))
            grids[s] = g
        if collectives:
            return psum(grids, 0)[()]
        return _stack(grids, mesh)

    return f


def stkde_dd_lpt(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    axes: Tuple[str, str] = ("data", "model"),
    tile: Optional[Tuple[int, int, int]] = None,
    cap: Optional[int] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """Fine-tile DD with LPT load-aware placement (PD-SCHED as placement).

    Each device receives the k tiles LPT assigned to it (capacity-padded
    "tile soup"), computes each tile's density with the separable contraction,
    scatters them into a device-local grid, and the grids are summed — tiles
    are disjoint, so the psum is pure assembly, not numerical reduction.
    """
    pts = np.asarray(points, dtype=np.float32)
    n = int(n_total) if n_total is not None else len(pts)
    args, ctx = prepare_dd_lpt(pts, dom, mesh, axes, tile=tile, cap=cap)
    fn = build_dd_lpt(
        dom, mesh, axes, n, ctx["tile"], ctx["k"], ctx["cap"],
        ctx["ntiles"], ks, kt, deterministic=deterministic,
    )
    out = fn(*args)
    return out[: dom.Gx, : dom.Gy, : dom.Gt]


STRATEGIES = {
    "dr": stkde_dr,
    "dd": stkde_dd,
    "pd": stkde_pd,
    "pd_xt": stkde_pd_xt,
    "pd_xyt": stkde_pd_xyt,
    "dd_lpt": stkde_dd_lpt,
    "hybrid": stkde_hybrid,
}


def strategy_kwargs(strategy: str, axes: Tuple[str, ...],
                    rep_axis: Optional[str]) -> dict:
    """The axis arguments a strategy takes from the public API's ``axes`` and
    ``rep_axis``: hybrid deals over the rep axis (``"pod"`` by default), and
    pd_xyt given two axes uses the rep axis as its X cut."""
    kw: dict = {"axes": tuple(axes)}
    if strategy == "hybrid":
        kw["rep_axis"] = rep_axis or "pod"
    elif strategy == "pd_xyt" and len(axes) == 2:
        # 3-D split needs a third mesh axis: the rep axis becomes the X cut
        kw["axes"] = (rep_axis or "pod",) + tuple(axes)
    return kw


# -------------------------------------------------------------- chunked
def execute_chunk(
    points: np.ndarray,
    dom: Domain,
    mesh: Mesh,
    strategy: str,
    axes: Tuple[str, ...] = ("data", "model"),
    rep_axis: Optional[str] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """One chunk of a chunked run on ``mesh`` (normalized by the *global*
    ``n_total``), every shard's scatter adding in a fixed order so that the
    chunk's grid has the same bits on every run. (The reference also takes
    a fixed bucket ``cap`` to keep its compiled shapes across chunks; the
    port compiles nothing and walks only used bucket slots, so it has
    none.)

    The ``dist.device`` fault site models a device dying mid-chunk: an
    injected oom/drop here surfaces as a non-transient ``DeviceLostError``,
    which the chunked executor does not retry on the same mesh.
    """
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    try:
        _faults.fault_point("dist.device")
    except FaultInjectedError as e:
        raise DeviceLostError("dist.device", mesh_shape=shape) from e
    fn = STRATEGIES[strategy]
    kw = dict(strategy_kwargs(strategy, axes, rep_axis), ks=ks, kt=kt,
              n_total=n_total, deterministic=True)
    return fn(points, dom, mesh, **kw)
