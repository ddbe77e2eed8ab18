"""Durable progress journal for crash-safe resumable STKDE.

A chunked STKDE run (``core.api.stkde_chunked``) accumulates per-chunk
grid contributions into a float64 accumulator. After every chunk it
lands (a) a verified ``.npy`` snapshot of the accumulator and (b) an
append-only journal record naming the chunk, its point range, the plan
fingerprint, and the snapshot's CRC-32. A run killed at any instant —
including mid-write — can be resumed: ``replay()`` walks the journal,
drops the truncated/corrupt tail, and salvages the newest chunk whose
snapshot still verifies. Because the accumulator is restored bit-exactly
(``.npy`` round-trips float64 exactly) and chunks are deterministic,
an interrupted-then-resumed run produces a grid *bit-identical* to an
uninterrupted one.

The on-disk format is the reference package's, byte for byte (records,
``.npy`` snapshots, fingerprint): either package resumes the other's
journal.

On-disk layout (one directory per run)::

    <journal>/journal.bin          append-only records
    <journal>/grid_00000012.npy    float64 accumulator after chunk 12
                                   (keep-last-K)

Record wire format (little-endian)::

    b"STKJ" | payload_len:u32 | crc32(payload):u32 | payload(JSON)

Record kinds: ``meta`` (first record: fingerprint + run parameters),
``chunk`` (one per landed chunk), ``event`` (recovery annotations, e.g.
mesh shrink). Writes are verified: payload bytes pass the
``journal.write`` fault site, are fsynced, re-read, and CRC-checked; a
mismatch truncates the partial append and retries
(``JournalCorruptError`` is transient at write time).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

from . import faults as _faults
from .errors import JournalCorruptError, ReproValidationError
from .retry import RetryPolicy, with_retry

MAGIC = b"STKJ"
_HEADER = struct.Struct("<4sII")  # magic, payload_len, payload_crc32

# corruption/IO hiccups re-write
# quickly, persistent corruption is a real error
_WRITE_POLICY = RetryPolicy(max_attempts=5, base_delay_s=0.01,
                            max_delay_s=0.2)

_SNAPSHOT_FMT = "grid_{:08d}.npy"


def fingerprint_of(**fields: Any) -> str:
    """Stable plan fingerprint: sha256 of canonical-JSON key/value pairs.

    Callers pass everything that must match between the original run and
    a resume for the replayed chunks to be valid: domain fields, global
    point count, chunk size, requested strategy, kernel names. The mesh
    is deliberately *not* part of it — mesh shrink mid-run must not
    invalidate the journal.
    """
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass
class Salvage:
    """What ``replay()`` recovered from a journal."""

    meta: Optional[Dict[str, Any]]      # meta payload, None if unusable
    chunk_id: int                       # newest salvaged chunk (-1: none)
    grid: Optional[np.ndarray]          # float64 accumulator after chunk_id
    ranges: Dict[int, Tuple[int, int]]  # chunk_id -> (start, stop)
    events: List[Dict[str, Any]]        # recovery events in the valid prefix
    dropped_tail: int = 0               # corrupt/truncated records dropped
    dropped_snapshots: int = 0          # chunk records without a live snapshot


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _encode(payload: Dict[str, Any]) -> Tuple[bytes, bytes]:
    body = json.dumps(payload, sort_keys=True).encode()
    return _HEADER.pack(MAGIC, len(body), _crc(body)), body


class ProgressJournal:
    """Append-only, CRC-verified progress journal (one directory per run)."""

    def __init__(self, path: str, keep: int = 2):
        if keep < 1:
            raise ReproValidationError(f"journal keep must be >= 1: {keep}")
        self.dir = str(path)
        self.keep = int(keep)

    # ------------------------------------------------------------ paths
    @property
    def journal_file(self) -> str:
        return os.path.join(self.dir, "journal.bin")

    def snapshot_file(self, chunk_id: int) -> str:
        return os.path.join(self.dir, _SNAPSHOT_FMT.format(chunk_id))

    def exists(self) -> bool:
        return os.path.exists(self.journal_file)

    # ----------------------------------------------------------- create
    def create(self, fingerprint: str, meta: Optional[Dict[str, Any]] = None
               ) -> None:
        """Start a fresh journal (truncates any previous run's state)."""
        os.makedirs(self.dir, exist_ok=True)
        for f in os.listdir(self.dir):
            if f.startswith("grid_") or f.endswith(".tmp"):
                os.remove(os.path.join(self.dir, f))
        with open(self.journal_file, "wb"):
            pass
        self._append_record(
            {"kind": "meta", "fingerprint": fingerprint,
             "meta": dict(meta or {})}
        )

    def meta(self) -> Optional[Dict[str, Any]]:
        """The meta payload of an existing journal (None if unreadable)."""
        if not self.exists():
            return None
        recs, _, _ = self._read_records()
        if recs and recs[0][0].get("kind") == "meta":
            return recs[0][0]
        return None

    # ----------------------------------------------------------- append
    def append_chunk(self, chunk_id: int, start: int, stop: int,
                     grid: np.ndarray, **extra: Any) -> None:
        """Land one completed chunk: verified snapshot, then its record.

        Ordering is the crash-safety invariant: the snapshot is fully
        landed (written, re-read, CRC-verified, atomically renamed)
        *before* the record that names it is appended. A crash between
        the two leaves an orphan snapshot (harmless); a record can never
        name a snapshot that was not durably written.
        """
        acc = np.ascontiguousarray(grid, dtype=np.float64)
        crc = self._write_snapshot(chunk_id, acc)
        self._append_record({
            "kind": "chunk", "chunk_id": int(chunk_id),
            "start": int(start), "stop": int(stop),
            "grid_crc32": crc, "snapshot": _SNAPSHOT_FMT.format(chunk_id),
            **extra,
        })
        self._prune_snapshots(chunk_id)
        obs_metrics.counter("journal.chunks").inc()

    def append_event(self, event: Dict[str, Any]) -> None:
        """Append a recovery annotation (mesh shrink, strategy change)."""
        self._append_record({"kind": "event", **event})
        obs_metrics.counter("journal.events").inc()

    # ----------------------------------------------------------- replay
    def replay(self, expect_fingerprint: Optional[str] = None,
               truncate: bool = False) -> Salvage:
        """Parse the valid record prefix and salvage the newest restorable
        accumulator state.

        Corrupt or truncated tail records are *dropped*, never fatal; a
        fingerprint mismatch against ``expect_fingerprint`` raises a
        typed ``ReproValidationError`` (resuming a journal written by a
        different plan would silently produce a wrong grid). With
        ``truncate=True`` the journal file is cut back to the salvage
        point so subsequent appends continue from a consistent state.
        """
        with obs_trace.span("journal.replay", path=self.dir):
            recs, dropped_tail, _ = self._read_records()
            if dropped_tail:
                obs_metrics.counter("journal.dropped_tail").inc(dropped_tail)
            if not recs or recs[0][0].get("kind") != "meta":
                # nothing trustworthy (missing/corrupt meta): salvage nothing
                return Salvage(meta=None, chunk_id=-1, grid=None, ranges={},
                               events=[], dropped_tail=dropped_tail)
            meta = recs[0][0]
            if (expect_fingerprint is not None
                    and meta.get("fingerprint") != expect_fingerprint):
                raise ReproValidationError(
                    "journal fingerprint mismatch: journal was written by a "
                    "different plan (domain / n_total / chunk_size / "
                    f"strategy / kernels) — {self.journal_file} has "
                    f"{meta.get('fingerprint')!r}, caller expects "
                    f"{expect_fingerprint!r}. Refusing to resume."
                )
            chunks: List[Tuple[Dict[str, Any], int]] = []
            events: List[Dict[str, Any]] = []
            ranges: Dict[int, Tuple[int, int]] = {}
            next_id = 0
            end_meta = recs[0][1]
            for payload, end in recs[1:]:
                kind = payload.get("kind")
                if kind == "event":
                    events.append(payload)
                elif kind == "chunk":
                    if payload.get("chunk_id") != next_id:
                        break  # out-of-order/gapped tail: distrust the rest
                    chunks.append((payload, end))
                    ranges[next_id] = (payload["start"], payload["stop"])
                    next_id += 1

            dropped_snaps = 0
            for payload, end in reversed(chunks):
                grid = self._load_snapshot(payload)
                if grid is not None:
                    cid = payload["chunk_id"]
                    if truncate:
                        self._truncate(end)
                    obs_metrics.counter("journal.salvaged_chunks").inc(
                        cid + 1)
                    return Salvage(
                        meta=meta, chunk_id=cid, grid=grid,
                        ranges={i: ranges[i] for i in range(cid + 1)},
                        events=events, dropped_tail=dropped_tail,
                        dropped_snapshots=dropped_snaps)
                dropped_snaps += 1
            if truncate:
                self._truncate(end_meta)
            return Salvage(meta=meta, chunk_id=-1, grid=None, ranges={},
                           events=events, dropped_tail=dropped_tail,
                           dropped_snapshots=dropped_snaps)

    # --------------------------------------------------------- internals
    def _append_record(self, payload: Dict[str, Any]) -> None:
        header, body = _encode(payload)

        def write_once():
            _faults.fault_point("journal.write")
            # corruption models an in-flight bit flip: the header CRC is
            # computed from the clean payload, so a flipped byte fails
            # the read-back check below and the append is retried
            data = header + _faults.corrupt("journal.write", body)
            with open(self.journal_file, "ab") as f:
                off = f.tell()
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            with open(self.journal_file, "rb") as f:
                f.seek(off)
                got = f.read(len(data))
            if got != header + body:
                self._truncate(off)
                raise JournalCorruptError(
                    f"journal record failed write verification at "
                    f"offset {off} ({self.journal_file})"
                )

        with obs_trace.span("journal.write", kind=payload.get("kind", "?")):
            with_retry(write_once, policy=_WRITE_POLICY,
                       site="journal.write")
        obs_metrics.counter("journal.writes").inc()

    def _write_snapshot(self, chunk_id: int, acc: np.ndarray) -> int:
        """Write-verify the float64 accumulator snapshot; returns its CRC."""
        final = self.snapshot_file(chunk_id)
        tmp = final + ".tmp"
        crc = _crc(acc.tobytes())
        buf = io.BytesIO()
        np.save(buf, acc)
        body = buf.getvalue()

        def write_once():
            _faults.fault_point("journal.write")
            data = _faults.corrupt("journal.write", body)
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            try:
                back = np.load(tmp)
                ok = (back.dtype == acc.dtype and back.shape == acc.shape
                      and _crc(back.tobytes()) == crc)
            except Exception:
                ok = False
            if not ok:
                raise JournalCorruptError(
                    f"snapshot failed write verification: {tmp}"
                )
            os.replace(tmp, final)

        with obs_trace.span("journal.snapshot", chunk=chunk_id,
                            bytes=len(body)):
            with_retry(write_once, policy=_WRITE_POLICY,
                       site="journal.write")
        return crc

    def _load_snapshot(self, payload: Dict[str, Any]) -> Optional[np.ndarray]:
        path = os.path.join(self.dir, payload.get("snapshot", ""))
        if not os.path.exists(path):
            return None
        try:
            grid = np.load(path)
        except Exception:
            return None
        if (grid.dtype != np.float64
                or _crc(grid.tobytes()) != payload.get("grid_crc32")):
            return None
        return grid

    def _prune_snapshots(self, newest_id: int) -> None:
        """Keep-last-K snapshots: older accumulator states are
        recoverable by recomputation anyway."""
        cutoff = newest_id - self.keep + 1
        for f in os.listdir(self.dir):
            if not (f.startswith("grid_") and f.endswith(".npy")):
                continue
            try:
                cid = int(f[5:-4])
            except ValueError:
                continue
            if cid < cutoff:
                os.remove(os.path.join(self.dir, f))

    def _truncate(self, offset: int) -> None:
        with open(self.journal_file, "r+b") as f:
            f.truncate(offset)

    def _read_records(self) -> Tuple[List[Tuple[Dict[str, Any], int]],
                                     int, int]:
        """All structurally valid records from the head of the file.

        Returns ``(records, dropped_tail, valid_end)`` where records are
        ``(payload, end_offset)`` pairs. Parsing stops at the first bad
        magic / short read / CRC mismatch / JSON failure — everything
        after that point is the crash-truncated tail.
        """
        out: List[Tuple[Dict[str, Any], int]] = []
        if not self.exists():
            return out, 0, 0
        with open(self.journal_file, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            head = data[off:off + _HEADER.size]
            if len(head) < _HEADER.size:
                break
            magic, ln, crc = _HEADER.unpack(head)
            if magic != MAGIC:
                break
            body = data[off + _HEADER.size: off + _HEADER.size + ln]
            if len(body) < ln or _crc(body) != crc:
                break
            try:
                payload = json.loads(body.decode())
            except (ValueError, UnicodeDecodeError):
                break
            off += _HEADER.size + ln
            out.append((payload, off))
        dropped = 1 if off < len(data) else 0
        return out, dropped, off


def iter_records(path: str) -> Iterator[Dict[str, Any]]:
    """Debugging helper: iterate the valid record payloads of a journal."""
    recs, _, _ = ProgressJournal(path)._read_records()
    for payload, _ in recs:
        yield payload
