"""Deterministic data sources: the synthetic token stream of the language
models, and point sources for chunked, out-of-core STKDE.

``SyntheticLM`` produces token streams with learnable n-gram structure from
a counter-based seed: seekable by step (resuming at step N yields exactly
the batches a run that did not stop would have seen) and shardable by host
(host h of H draws rows [h::H] of the global batch). ``stkde_stream``
yields an instance's points chunk by chunk, and ``as_chunks`` turns an array
or such a stream into the bounded-memory chunk iterator that
``core.api.stkde_chunked`` consumes. Every read goes through the
``data.read`` fault site and is retried. All of it is numpy only and gives
the reference package's batches and chunks bit for bit, so a run or a
journal of one package names the data the other will produce.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..resilience import RetryPolicy, faults, with_retry
from ..resilience.errors import ReproValidationError

# transient read faults (dropped shards, storage hiccups) retry quickly;
# a batch or chunk that cannot be produced after that is a real error
_READ_POLICY = RetryPolicy(max_attempts=4, base_delay_s=0.005,
                           max_delay_s=0.1)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_host: int = 1
    host_id: int = 0
    # markov-chain structure strength (0 = uniform noise, 1 = deterministic)
    structure: float = 0.8


class SyntheticLM:
    """Order-1 Markov token stream with a fixed random transition table."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab, 4096)  # structured sub-vocab
        self.v = v
        self.next_tok = rng.integers(0, v, size=(v, 4))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step`` (retried through the ``data.read`` fault
        site — the stream is seekable, so a re-read is exact)."""
        return with_retry(lambda: self._batch_at(step),
                          policy=_READ_POLICY, site="data.read")

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        faults.fault_point("data.read")
        cfg = self.cfg
        rows = np.arange(cfg.host_id, cfg.global_batch, cfg.n_host)
        B = len(rows)
        # counter-based determinism: seed from (step, row)
        seqs = np.empty((B, cfg.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, int(r)])
            )
            toks = np.empty(cfg.seq_len + 1, np.int32)
            toks[0] = rng.integers(0, self.v)
            noise = rng.random(cfg.seq_len)
            branch = rng.integers(0, 4, cfg.seq_len)
            rand = rng.integers(0, self.v, cfg.seq_len)
            for t in range(cfg.seq_len):
                if noise[t] < cfg.structure:
                    toks[t + 1] = self.next_tok[toks[t], branch[t]]
                else:
                    toks[t + 1] = rand[t]
            seqs[i] = toks
        return {
            "tokens": seqs[:, :-1],
            "labels": seqs[:, 1:],
        }

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


def stkde_stream(instance, chunk: int = 100_000, seed: Optional[int] = None):
    """Chunked point stream for out-of-core STKDE (eBird-scale ingestion).

    Yields (chunk_i, n_total) so accumulation strategies can stream points
    through the grid without materializing all n at once.
    """
    n = instance.n
    done = 0
    i = 0
    while done < n:
        take = min(chunk, n - done)
        sub = dataclasses.replace(
            instance, n=take,
            seed=(instance.seed if seed is None else seed) + 7919 * i,
        )

        def read_chunk(sub=sub):
            faults.fault_point("data.read")
            return sub.points()

        yield with_retry(read_chunk, policy=_READ_POLICY,
                         site="data.read"), n
        done += take
        i += 1


def as_chunks(points, chunk_size: Optional[int] = None,
              n_total: Optional[int] = None
              ) -> Tuple[Iterator[Tuple[int, int, int, np.ndarray]], int]:
    """Normalize a point source into a bounded-memory chunk iterator.

    Accepts either an in-memory ``(n, 3)`` array (sliced into
    ``chunk_size`` pieces without copying the whole set again) or an
    iterable of chunks — plain arrays, or the ``(chunk, n_total)`` pairs
    ``stkde_stream`` yields. Returns ``(iterator, n_total)`` where the
    iterator yields ``(chunk_id, start, stop, pts)``; peak point-buffer
    memory is one chunk. The global count must be known up front (STKDE
    normalization divides by it): it is taken from the array length, the
    stream protocol, or the explicit ``n_total`` argument.
    """
    if isinstance(points, np.ndarray) or isinstance(points, (list, tuple)):
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ReproValidationError(
                f"points must be (n, 3) [x, y, t]; got shape {pts.shape}"
            )
        n = len(pts)
        if not chunk_size or chunk_size <= 0:
            raise ReproValidationError(
                f"chunk_size must be a positive int: {chunk_size!r}"
            )

        def from_array():
            for i, s in enumerate(range(0, n, chunk_size)):
                stop = min(s + chunk_size, n)
                yield i, s, stop, pts[s:stop]

        return from_array(), n

    it = iter(points)
    try:
        first = next(it)
    except StopIteration:
        raise ReproValidationError("empty point source") from None
    if isinstance(first, tuple):  # stkde_stream protocol: (chunk, n_total)
        n_total = int(first[1])
    if n_total is None:
        raise ReproValidationError(
            "streaming point sources need n_total (pass stkde_stream, or "
            "give n_total= explicitly) — STKDE normalization divides by "
            "the global point count before the stream is exhausted"
        )

    def from_stream(n=int(n_total)):
        start = 0
        for i, item in enumerate(itertools.chain([first], it)):
            chunk = np.asarray(item[0] if isinstance(item, tuple) else item,
                               dtype=np.float32)
            stop = start + len(chunk)
            if stop > n:
                raise ReproValidationError(
                    f"point stream produced {stop} > n_total={n} points"
                )
            yield i, start, stop, chunk
            start = stop

    return from_stream(), int(n_total)
