"""Top-level STKDE public API of the port.

    from repro_torch.core.api import stkde
    grid = stkde(points, dom)                          # PB-SYM scatter
    grid = stkde(points, dom, use_tiled_kernel=True)   # CUDA tile kernel
    grid = stkde(points, dom, device="cpu")            # plain versions, host
    mesh = make_host_mesh(8)                           # (4, 2) shards, cuda
    grid = stkde(points, dom, mesh=mesh, strategy="pd")
    res = stkde(points, dom, chunk_size=4096,          # crash-safe chunked run
                journal="runs/j1")                     # -> ChunkedResult
    res = stkde(points, dom, resume="runs/j1")         # salvage + continue
    grid = np.asarray(res)                             # or res.grid

Robustness contract: inputs are validated at this boundary (typed
``ReproValidationError`` instead of downstream shape errors), outputs are
NaN/Inf-checked, and a failed distributed strategy build/execution falls
back to the ``dr`` baseline on the same mesh (counted in
``resilience.fallbacks``) unless ``fallback=False``. ``device=None`` means
``"cuda"``; without a CUDA device that raises ``KernelUnavailableError`` —
nothing carries on on the CPU unasked. On a mesh (``repro_torch.
distributed.Mesh``) the mesh's devices decide where each shard runs.
``strategy="auto"`` on a mesh asks the parametric planner (``core.plan``)
for the cheapest strategy. Chunked execution (``stkde_chunked``) journals
per-chunk progress to disk so that a killed run resumes bit-identically
(its journal is the reference package's, so either package resumes the
other's), and survives a lost device by re-planning the remaining chunks
onto a shrunken mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from .._device import DeviceLike, resolve_device
from ..resilience import faults as _faults
from ..resilience.degrade import ensure_finite
from ..resilience.errors import (
    DeviceLostError,
    ReproError,
    ReproValidationError,
    RetriesExhaustedError,
)
from ..resilience.journal import ProgressJournal, fingerprint_of
from ..resilience.retry import RetryPolicy, with_retry
from .geometry import Domain
from . import bucketing
from . import kernels_math as km
from . import plan as _plan
from .pb import _as_points, _pb_impl
from .pb import pb as _pb


def validate_inputs(points, dom: Domain) -> np.ndarray:
    """API-boundary validation; returns points as float32 ``(n, 3)``.

    Rejects (typed ``ReproValidationError``): empty point sets, wrong
    shapes, NaN/Inf coordinates, non-positive bandwidths/resolutions,
    and time coordinates outside the domain's time window (± one
    temporal bandwidth — points just outside still radiate density in).
    """
    pts = np.asarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ReproValidationError(
            f"points must be (n, 3) [x, y, t]; got shape {pts.shape}"
        )
    if len(pts) == 0:
        raise ReproValidationError("empty point set")
    if not np.isfinite(pts).all():
        bad = int(len(pts) - np.isfinite(pts).all(axis=1).sum())
        raise ReproValidationError(
            f"{bad}/{len(pts)} points have NaN/Inf coordinates"
        )
    if not (dom.hs > 0 and dom.ht > 0):
        raise ReproValidationError(
            f"bandwidths must be positive: hs={dom.hs} ht={dom.ht}"
        )
    if not (dom.sres > 0 and dom.tres > 0):
        raise ReproValidationError(
            f"resolutions must be positive: sres={dom.sres} tres={dom.tres}"
        )
    t_lo, t_hi = dom.ot - dom.ht, dom.ot + dom.gt + dom.ht
    t = pts[:, 2]
    if t.min() < t_lo or t.max() > t_hi:
        n_out = int(((t < t_lo) | (t > t_hi)).sum())
        raise ReproValidationError(
            f"{n_out}/{len(pts)} points outside the domain time window "
            f"[{t_lo}, {t_hi}] (ot={dom.ot} gt={dom.gt} ht={dom.ht})"
        )
    return pts


def _check_strategy(strategy: str) -> str:
    """``strategy`` if it is ``"auto"`` or one of ``STRATEGIES``."""
    from ..distributed.stkde_dist import STRATEGIES

    if strategy != "auto" and strategy not in STRATEGIES:
        raise ReproValidationError(
            f"unknown strategy {strategy!r}; have 'auto' or "
            f"{sorted(STRATEGIES)}")
    return strategy


def _plan_shape(mesh, axes, rep_axis) -> Tuple[int, ...]:
    """The mesh shape the planner prices: (A, B), or (R, A, B) with a rep
    axis."""
    A, B = mesh.shape[axes[0]], mesh.shape[axes[1]]
    return (mesh.shape[rep_axis], A, B) if rep_axis is not None else (A, B)


def _home_loads(pts: np.ndarray, dom: Domain, mesh, axes) -> np.ndarray:
    """Points per device block of the (A, B) worker grid (home buckets)."""
    A, B = mesh.shape[axes[0]], mesh.shape[axes[1]]
    tile = (math.ceil(dom.Gx / A), math.ceil(dom.Gy / B), dom.Gt)
    return bucketing.bucket_points_home(pts, dom, tile).counts.reshape(-1)


def _auto_strategy(dom: Domain, n: int, mesh, axes, rep_axis, loads,
                   hw) -> str:
    """The planner's pick on ``mesh``; hybrid and pd_xyt need a rep axis,
    so without one they become pd."""
    strat, _ = _plan.choose(dom, n, _plan_shape(mesh, axes, rep_axis),
                            loads, hw=hw)
    if strat in ("hybrid", "pd_xyt") and rep_axis is None:
        strat = "pd"
    return strat


def stkde(
    points,
    dom: Domain,
    mesh=None,
    strategy: str = "auto",
    axes: Tuple[str, ...] = ("data", "model"),
    rep_axis: Optional[str] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    use_tiled_kernel: bool = False,
    validate: bool = True,
    fallback: bool = True,
    chunk_size: Optional[int] = None,
    journal: Optional[str] = None,
    resume: Optional[str] = None,
    device: DeviceLike = None,
) -> Union[torch.Tensor, "ChunkedResult"]:
    """Space-time kernel density grid for ``points`` over ``dom``: a
    ``float32`` tensor of shape ``dom.grid_shape`` on ``device`` (on a mesh:
    on the mesh's first device).

    mesh:     a ``repro_torch.distributed.Mesh``; ``None`` is one device.
    strategy: on a mesh, "auto" (the planner's cheapest under
              ``plan.H100``, from the points' home-bucket loads) or one of
              "dr" | "dd" | "pd" | "pd_xt" | "pd_xyt" | "dd_lpt" |
              "hybrid"; unused without a mesh.
    axes / rep_axis: the mesh axes the strategy splits over; hybrid deals
              each bucket over ``rep_axis`` (default ``"pod"``), and pd_xyt
              given two ``axes`` takes the rep axis as its X cut.
    use_tiled_kernel: overlap-bucket the points on the host and run the
              tile kernel (the CUDA kernel on a CUDA device, its plain
              version on the CPU) instead of the PB-SYM scatter.
    validate: typed input validation at this boundary (see
              ``validate_inputs``).
    fallback: on a mesh strategy's build/execution failure or non-finite
              output, run the query again with ``dr`` on the same mesh.
    chunk_size / journal / resume: any of these switches to crash-safe
              chunked execution (``stkde_chunked``): bounded-memory chunk
              ingestion, per-chunk progress journaling to the ``journal``
              directory, and ``resume=<journal dir>`` salvaging a killed
              run's completed chunks before continuing. The chunked path
              returns a ``ChunkedResult`` (array-like: ``np.asarray(res)``
              or ``res.grid`` is the float64 accumulator grid, on the host;
              ``.report`` carries coverage/recovery details).
    device:   ``None`` means ``"cuda"``; not used on a mesh.
    """
    if chunk_size is not None or journal is not None or resume is not None:
        return stkde_chunked(
            points, dom, mesh=mesh, strategy=strategy, axes=axes,
            rep_axis=rep_axis, ks=ks, kt=kt, chunk_size=chunk_size,
            journal=resume if resume is not None else journal,
            resume=resume is not None, validate=validate, device=device,
        )
    dev = resolve_device(device) if mesh is None else None
    with (obs.span("stkde.query", device=dev, query=True) if mesh is None
          else obs.trace.OFF) as sp:
        if sp.recording:
            sp.set(path="tile" if use_tiled_kernel else "pb",
                   n=len(points), grid="x".join(map(str, dom.grid_shape)))
        with obs.span("stkde.validate", device=dev):
            pts = (validate_inputs(points, dom) if validate
                   else np.asarray(points, dtype=np.float32))
        if mesh is None:
            if use_tiled_kernel:
                from ..kernels import stkde_tiled

                return ensure_finite(
                    stkde_tiled(pts, dom, ks=ks, kt=kt, device=dev),
                    "stkde.tiled")
            return ensure_finite(
                _pb(pts, dom, variant="sym", ks=ks, kt=kt, device=dev),
                "stkde.pb"
            )

    from ..distributed.stkde_dist import STRATEGIES, strategy_kwargs

    if _check_strategy(strategy) == "auto":
        strategy = _auto_strategy(dom, len(pts), mesh, axes, rep_axis,
                                  _home_loads(pts, dom, mesh, axes),
                                  _plan.H100)
    kw = dict(strategy_kwargs(strategy, axes, rep_axis), ks=ks, kt=kt)
    try:
        return ensure_finite(STRATEGIES[strategy](pts, dom, mesh, **kw),
                             f"stkde.{strategy}")
    except (ReproError, ValueError) as e:
        if not fallback or strategy == "dr":
            raise
        obs.counter("resilience.fallbacks").inc()
        obs.counter(f"resilience.fallbacks.stkde.{strategy}").inc()
        with obs.span("resilience.fallback", frm=strategy, to="dr",
                      error=type(e).__name__):
            out = STRATEGIES["dr"](pts, dom, mesh, axes=axes, ks=ks, kt=kt)
        return ensure_finite(out, "stkde.dr")


# ------------------------------------------------------------------ chunked
DEFAULT_CHUNK = 4096

# per-chunk transient faults (injected OOMs, IO hiccups) retry in place
_CHUNK_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.01,
                            max_delay_s=0.2)


@dataclasses.dataclass
class ChunkedResult:
    """Result of a chunked (crash-safe) STKDE run — returned by
    ``stkde_chunked`` and by ``stkde`` whenever ``chunk_size``/``journal``/
    ``resume`` engage the chunked path.

    ``grid`` is the float64 accumulator, a numpy array on the host — chunk
    contributions are summed there in float64 *in fixed chunk order*, and
    every chunk's fp32 grid comes out of the card with the same bits on
    every run; that is what makes an interrupted-and-resumed run
    bit-identical to an uninterrupted one. The object is array-like
    (``__array__`` forwards to ``grid``).
    """

    grid: np.ndarray
    report: Dict[str, Any]
    journal_path: Optional[str] = None

    def __array__(self, dtype=None, copy=None):
        return (np.asarray(self.grid) if dtype is None
                else np.asarray(self.grid, dtype=dtype))


def _chunk_fingerprint(dom: Domain, n_total: int, chunk_desc, strategy: str,
                       ks, kt) -> str:
    """The reference package's fingerprint of the same fields, so that a
    journal of either package is accepted by the other."""
    return fingerprint_of(
        dom=dataclasses.asdict(dom), n_total=int(n_total),
        chunk_size=chunk_desc, strategy=strategy,
        ks=getattr(ks, "__name__", str(ks)),
        kt=getattr(kt, "__name__", str(kt)), version=1,
    )


def _mesh_shape(mesh) -> Optional[List[int]]:
    return (None if mesh is None
            else [int(mesh.shape[a]) for a in mesh.axis_names])


def _replan_after_loss(dom: Domain, n_total: int, mesh, axes, rep_axis):
    """Pick (mesh, strategy) for the chunks remaining after a device loss.

    Shrinks the mesh by one device and re-runs the planner with the
    hardware record of the mesh's device (``plan.default_hw``); when no
    multi-device mesh survives, degrades to single-device local execution
    (strategy ``local``).
    """
    from ..distributed.mesh import shrink_mesh

    new_mesh = shrink_mesh(mesh, 1)
    if new_mesh is None:
        return None, "local"
    return new_mesh, _auto_strategy(dom, n_total, new_mesh, axes, rep_axis,
                                    None, _plan.default_hw(mesh.first_device))


def stkde_chunked(
    points,
    dom: Domain,
    mesh=None,
    strategy: str = "auto",
    axes: Tuple[str, ...] = ("data", "model"),
    rep_axis: Optional[str] = None,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    chunk_size: Optional[int] = None,
    journal: Optional[str] = None,
    resume: bool = False,
    validate: bool = True,
    keep_snapshots: int = 2,
    max_chunks: Optional[int] = None,
    n_total: Optional[int] = None,
    device: DeviceLike = None,
) -> ChunkedResult:
    """Crash-safe chunked STKDE: bounded memory and durable progress.

    ``points`` is an in-memory ``(n, 3)`` array (sliced into
    ``chunk_size`` pieces) or a chunk stream (``data.pipeline
    .stkde_stream``, or any iterable of chunk arrays plus ``n_total=``) —
    peak point-buffer memory is one chunk either way. Each chunk's PB-SYM
    grid is computed on ``device`` (``None`` means ``"cuda"``) with
    fixed-order adds, copied to the host once, and accumulated there in
    float64; with ``journal=`` every landed chunk appends a CRC-verified
    record + accumulator snapshot, and ``resume=True`` salvages completed
    chunks from that journal before computing the rest. ``max_chunks``
    bounds how many chunks this call computes (cooperative time-slicing:
    call again with ``resume=True`` to continue; the report's ``coverage``
    < 1 flags the partial state).

    ``strategy`` is recorded in the journal's fingerprint as the reference
    records it; without a mesh every chunk runs locally (strategy
    ``local``). On a ``mesh`` (``device`` is then not used) every chunk
    runs ``strategy`` through ``distributed.stkde_dist.execute_chunk``
    (fixed-order adds there too; ``"auto"`` asks ``plan.choose`` with
    ``plan.default_hw`` of the mesh's first device), and each journal
    record names the mesh's shape. A device failure (``DeviceLostError``
    from the ``dist.device`` site, or a chunk whose retries exhaust)
    re-plans the remaining chunks onto a shrunken mesh
    (``distributed.mesh.shrink_mesh`` + ``plan.choose``), ultimately
    running them ``local`` on the mesh's first device, and records a
    ``device_lost`` event in ``report["recovery"]`` and in the journal
    instead of raising.
    """
    from ..data.pipeline import as_chunks

    dev = resolve_device(device) if mesh is None else None
    is_array = isinstance(points, (np.ndarray, list, tuple))
    if is_array:
        points = (validate_inputs(points, dom) if validate
                  else np.asarray(points, dtype=np.float32))

    jnl = None
    if journal is not None:
        jnl = ProgressJournal(journal, keep=keep_snapshots)
        if resume and chunk_size is None and is_array and jnl.exists():
            # stkde(..., resume=path) convenience: recover the original
            # chunk size from the journal's meta record
            m = jnl.meta()
            if m is not None:
                cs = m.get("meta", {}).get("chunk_size")
                chunk_size = cs if isinstance(cs, int) else None
    if is_array and chunk_size is None:
        chunk_size = DEFAULT_CHUNK
    chunks, n_total = as_chunks(points, chunk_size, n_total)
    chunk_desc: Union[int, str] = chunk_size if is_array else "stream"

    requested = strategy
    if mesh is None:
        strat = "local"
    elif _check_strategy(strategy) == "auto":
        # streams can't be pre-bucketed: the planner's default loads
        loads = (_home_loads(points, dom, mesh, axes) if is_array
                 else None)
        strat = _auto_strategy(dom, n_total, mesh, axes, rep_axis, loads,
                               _plan.default_hw(mesh.first_device))
    else:
        strat = strategy
    fp = _chunk_fingerprint(dom, n_total, chunk_desc, requested, ks, kt)
    meta = {
        "n_total": int(n_total), "chunk_size": chunk_desc,
        "strategy": requested, "grid_shape": list(dom.grid_shape),
    }
    salvage = None
    if jnl is not None:
        if resume and jnl.exists():
            s = jnl.replay(expect_fingerprint=fp, truncate=True)
            if s.meta is None:
                # journal died before its meta record landed: fresh start
                jnl.create(fp, meta)
            else:
                salvage = s
        else:
            jnl.create(fp, meta)

    if salvage is not None and salvage.grid is not None:
        acc = np.array(salvage.grid, dtype=np.float64)
    else:
        acc = np.zeros(dom.grid_shape, dtype=np.float64)
    salvaged_id = salvage.chunk_id if salvage is not None else -1

    # after a device loss: the mesh left, its strategy; with no mesh left
    # the chunks run locally on the card (or CPU) the mesh was on
    mesh_now, strat_now = mesh, strat
    local_dev = dev if mesh is None else mesh.first_device
    recovery: List[Dict[str, Any]] = []
    if salvage is not None:
        recovery.extend(salvage.events)
    computed = 0
    done_stop = (salvage.ranges[salvaged_id][1]
                 if salvage is not None and salvaged_id >= 0 else 0)
    max_chunk_points = 0
    chunks_seen = 0
    truncated = False

    for cid, start, stop, cpts in chunks:
        chunks_seen = cid + 1
        if cid <= salvaged_id:
            got = (int(start), int(stop))
            want = tuple(salvage.ranges.get(cid, (None, None)))
            if got != want:
                raise ReproValidationError(
                    f"resume point-range mismatch at chunk {cid}: source "
                    f"yields {got} but the journal recorded {want} — the "
                    "point source differs from the original run"
                )
            continue  # salvaged from the journal: skip recomputation
        if max_chunks is not None and computed >= max_chunks:
            truncated = True
            break
        if not is_array and validate:
            cpts = validate_inputs(cpts, dom)
        max_chunk_points = max(max_chunk_points, len(cpts))

        def attempt(cpts=cpts, cid=cid):
            _faults.fault_point("stkde.chunk")
            with obs.span("chunk.device", chunk=cid):
                if mesh_now is None:
                    g = _pb_impl(_as_points(cpts, local_dev), dom, "sym", ks,
                                 kt, 1 << 22, n_total, deterministic=True)
                else:
                    from ..distributed.stkde_dist import execute_chunk

                    g = execute_chunk(cpts, dom, mesh_now, strat_now,
                                      axes=axes, rep_axis=rep_axis, ks=ks,
                                      kt=kt, n_total=n_total)
                # on the card; the one boolean it reads waits for the grid
                g = ensure_finite(g, f"stkde.chunk.{cid}")
            with obs.span("chunk.d2h", chunk=cid, bytes=g.numel() * 4):
                return g.cpu().numpy()

        with obs.span("chunk.compute", chunk=cid, n=len(cpts),
                      strategy=strat_now):
            while True:
                try:
                    g = with_retry(attempt, policy=_CHUNK_POLICY,
                                   site="stkde.chunk")
                    break
                except (DeviceLostError, RetriesExhaustedError) as e:
                    if mesh_now is None:
                        raise  # local execution has no mesh to shrink
                    old_shape = _mesh_shape(mesh_now)
                    mesh_now, strat_now = _replan_after_loss(
                        dom, n_total, mesh_now, axes, rep_axis)
                    event = {
                        "event": "device_lost", "chunk_id": int(cid),
                        "error": type(e).__name__,
                        "from_mesh": old_shape,
                        "to_mesh": _mesh_shape(mesh_now),
                        "strategy": strat_now,
                    }
                    recovery.append(event)
                    if jnl is not None:
                        jnl.append_event(event)
                    obs.counter("chunk.device_lost").inc()
                    obs.counter("chunk.replans").inc()
        with obs.span("chunk.accumulate", chunk=cid):
            acc += g      # float32 -> float64 is exact: the reference's adds
        computed += 1
        done_stop = int(stop)
        obs.counter("chunk.computed").inc()
        obs.histogram("chunk.points").observe(len(cpts))
        if jnl is not None:
            with obs.span("chunk.journal", chunk=cid):
                jnl.append_chunk(cid, start, stop, acc, strategy=strat_now,
                                 mesh=_mesh_shape(mesh_now))

    report = {
        "n_total": int(n_total),
        "chunks_total": int(chunks_seen),
        "chunks_salvaged": int(salvaged_id + 1),
        "chunks_computed": int(computed),
        "coverage": float(done_stop / n_total) if n_total else 0.0,
        "max_chunk_points": int(max_chunk_points),
        "strategy": requested,
        "final_strategy": strat_now,
        "final_mesh": _mesh_shape(mesh_now),
        "resumed": bool(salvage is not None),
        "truncated": bool(truncated),
        "recovery": recovery,
    }
    if salvage is not None:
        report["dropped_tail_records"] = int(salvage.dropped_tail)
        report["dropped_snapshots"] = int(salvage.dropped_snapshots)
    return ChunkedResult(grid=acc, report=report, journal_path=journal)
