"""STKDE partial answers served from a progress journal.

The reference's ``serve/engine.py`` also holds the language-model
``ServingEngine`` (continuous batching, the bucketed oracle); that part
arrives with the port's LM stack. What is here is the lowest rung of the
STKDE degrade ladder: ``stkde_partial_answer`` over the port's
``ProgressJournal``, which reads a journal written by either package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import obs
from ..resilience.errors import ReproValidationError
from ..resilience.journal import ProgressJournal


@dataclasses.dataclass
class PartialGridAnswer:
    """A degraded STKDE answer served from a salvaged progress journal.

    The lowest degrade rung for density queries: when a chunked run died
    mid-way, the journal's newest verified accumulator snapshot already
    holds the exact density contribution of every completed chunk — serve
    that instead of failing, tagged with how much of the point set it
    covers.
    """

    grid: np.ndarray          # float64 accumulator (optionally rescaled)
    coverage: float           # fraction of points folded in, in (0, 1]
    chunks: int               # completed chunks behind the answer
    n_total: int              # global point count of the full run
    journal_path: str
    rescaled: bool


def stkde_partial_answer(journal_path: str,
                         rescale: bool = True) -> PartialGridAnswer:
    """Answer a density query from the salvaged state of ``journal_path``.

    ``rescale=True`` divides the partial accumulator by the coverage
    fraction — an unbiased estimate of the full-run grid when chunks are
    exchangeable (the synthetic streams draw i.i.d. chunks), analogous to
    the coreset estimate of Zheng et al. Raises a typed
    ``ReproValidationError`` when the journal holds nothing salvageable —
    callers then fall through to the coarsen/subsample degrade ladder.
    """
    salvage = ProgressJournal(journal_path).replay()
    if salvage.meta is None or salvage.grid is None:
        raise ReproValidationError(
            f"no salvageable chunks in journal {journal_path!r}: cannot "
            "serve a partial answer"
        )
    n_total = int(salvage.meta.get("meta", {}).get("n_total", 0))
    stop = salvage.ranges[salvage.chunk_id][1]
    coverage = stop / n_total if n_total else 0.0
    grid = np.array(salvage.grid, dtype=np.float64)
    if rescale and coverage > 0:
        grid /= coverage
    obs.counter("serve.partial_answers").inc()
    with obs.span("serve.partial_answer", coverage=round(coverage, 4),
                  chunks=salvage.chunk_id + 1):
        return PartialGridAnswer(
            grid=grid, coverage=coverage, chunks=salvage.chunk_id + 1,
            n_total=n_total, journal_path=str(journal_path),
            rescaled=bool(rescale),
        )
