"""Output checks for STKDE queries.

Only ``ensure_finite`` is here so far; coarsening, subsampling and
``run_with_degrade`` arrive with the degrade slice.
"""
from __future__ import annotations

import torch

from ..obs import metrics as obs_metrics
from .errors import NonFiniteOutputError


def ensure_finite(grid: torch.Tensor, tag: str = "stkde") -> torch.Tensor:
    """Raise NonFiniteOutputError when the density has NaN/Inf cells
    (counted in ``resilience.nonfinite``).

    The test runs where the grid lives; only one boolean crosses to the
    host (which waits for the device to finish the grid).
    """
    finite = torch.isfinite(grid)
    if not bool(finite.all()):
        bad = int(grid.numel() - int(finite.sum()))
        obs_metrics.counter("resilience.nonfinite").inc()
        raise NonFiniteOutputError(
            f"{tag}: {bad}/{grid.numel()} non-finite cells in output grid"
        )
    return grid
