"""Top-level STKDE public API of the port.

    from repro_torch.core.api import stkde
    grid = stkde(points, dom)                          # PB-SYM scatter
    grid = stkde(points, dom, use_tiled_kernel=True)   # CUDA tile kernel
    grid = stkde(points, dom, device="cpu")            # plain versions, host
    res = stkde(points, dom, chunk_size=4096,          # crash-safe chunked run
                journal="runs/j1")                     # -> ChunkedResult
    res = stkde(points, dom, resume="runs/j1")         # salvage + continue
    grid = np.asarray(res)                             # or res.grid

Robustness contract: inputs are validated at this boundary (typed
``ReproValidationError`` instead of downstream shape errors) and outputs are
NaN/Inf-checked. ``device=None`` means ``"cuda"``; without a CUDA device that
raises ``KernelUnavailableError`` — nothing carries on on the CPU unasked.
Chunked execution (``stkde_chunked``) journals per-chunk progress to disk
so that a killed run resumes bit-identically; its journal is the reference
package's, so either package resumes the other's. Meshes, strategies and
fallback are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import obs
from .._device import DeviceLike, resolve_device
from ..resilience import faults as _faults
from ..resilience.degrade import ensure_finite
from ..resilience.errors import ReproValidationError
from ..resilience.journal import ProgressJournal, fingerprint_of
from ..resilience.retry import RetryPolicy, with_retry
from .geometry import Domain
from . import kernels_math as km
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


def stkde(
    points,
    dom: Domain,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    use_tiled_kernel: bool = False,
    validate: bool = True,
    chunk_size: Optional[int] = None,
    journal: Optional[str] = None,
    resume: Optional[str] = None,
    device: DeviceLike = None,
) -> Union[torch.Tensor, "ChunkedResult"]:
    """Space-time kernel density grid for ``points`` over ``dom``: a
    ``float32`` tensor of shape ``dom.grid_shape`` on ``device``.

    use_tiled_kernel: overlap-bucket the points on the host and run the
              tile kernel (the CUDA kernel on a CUDA device, its plain
              version on the CPU) instead of the PB-SYM scatter.
    validate: typed input validation at this boundary (see
              ``validate_inputs``).
    chunk_size / journal / resume: any of these switches to crash-safe
              chunked execution (``stkde_chunked``): bounded-memory chunk
              ingestion, per-chunk progress journaling to the ``journal``
              directory, and ``resume=<journal dir>`` salvaging a killed
              run's completed chunks before continuing. The chunked path
              returns a ``ChunkedResult`` (array-like: ``np.asarray(res)``
              or ``res.grid`` is the float64 accumulator grid, on the host;
              ``.report`` carries coverage/recovery details).
    device:   ``None`` means ``"cuda"``.
    """
    if chunk_size is not None or journal is not None or resume is not None:
        return stkde_chunked(
            points, dom, ks=ks, kt=kt, chunk_size=chunk_size,
            journal=resume if resume is not None else journal,
            resume=resume is not None, validate=validate, device=device,
        )
    dev = resolve_device(device)
    if validate:
        pts = validate_inputs(points, dom)
    else:
        pts = np.asarray(points, dtype=np.float32)
    if use_tiled_kernel:
        from ..kernels import stkde_tiled

        return ensure_finite(
            stkde_tiled(pts, dom, ks=ks, kt=kt, device=dev), "stkde.tiled")
    return ensure_finite(
        _pb(pts, dom, variant="sym", ks=ks, kt=kt, device=dev), "stkde.pb"
    )


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


def stkde_chunked(
    points,
    dom: Domain,
    strategy: str = "auto",
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
    ``local``).
    """
    from ..data.pipeline import as_chunks

    dev = resolve_device(device)
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

    requested, strat = strategy, "local"
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
                g = _pb_impl(_as_points(cpts, dev), dom, "sym", ks, kt,
                             1 << 22, n_total, deterministic=True)
                # on the card; the one boolean it reads waits for the grid
                g = ensure_finite(g, f"stkde.chunk.{cid}")
            with obs.span("chunk.d2h", chunk=cid, bytes=g.numel() * 4):
                return g.cpu().numpy()

        with obs.span("chunk.compute", chunk=cid, n=len(cpts),
                      strategy=strat):
            g = with_retry(attempt, policy=_CHUNK_POLICY, site="stkde.chunk")
        with obs.span("chunk.accumulate", chunk=cid):
            acc += g      # float32 -> float64 is exact: the reference's adds
        computed += 1
        done_stop = int(stop)
        obs.counter("chunk.computed").inc()
        obs.histogram("chunk.points").observe(len(cpts))
        if jnl is not None:
            with obs.span("chunk.journal", chunk=cid):
                jnl.append_chunk(cid, start, stop, acc, strategy=strat,
                                 mesh=None)

    report = {
        "n_total": int(n_total),
        "chunks_total": int(chunks_seen),
        "chunks_salvaged": int(salvaged_id + 1),
        "chunks_computed": int(computed),
        "coverage": float(done_stop / n_total) if n_total else 0.0,
        "max_chunk_points": int(max_chunk_points),
        "strategy": requested,
        "final_strategy": strat,
        "final_mesh": None,
        "resumed": bool(salvage is not None),
        "truncated": bool(truncated),
        "recovery": recovery,
    }
    if salvage is not None:
        report["dropped_tail_records"] = int(salvage.dropped_tail)
        report["dropped_snapshots"] = int(salvage.dropped_snapshots)
    return ChunkedResult(grid=acc, report=report, journal_path=journal)
