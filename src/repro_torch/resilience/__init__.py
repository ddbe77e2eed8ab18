"""Resilience layer of the port: typed errors and the finite-output check.

  errors   typed failure taxonomy + the ``is_transient`` retryability oracle
  degrade  ``ensure_finite`` (the rest of graceful degradation is not ported yet)
"""
from . import degrade, errors
from .degrade import ensure_finite
from .errors import (
    AdmissionError,
    CheckpointCorruptError,
    DeadlineExceededError,
    DeviceLostError,
    FaultInjectedError,
    JournalCorruptError,
    KernelUnavailableError,
    NonFiniteOutputError,
    ReproError,
    ReproValidationError,
    RetriesExhaustedError,
    is_transient,
)

__all__ = [
    "degrade",
    "errors",
    "ensure_finite",
    "AdmissionError",
    "CheckpointCorruptError",
    "DeadlineExceededError",
    "DeviceLostError",
    "FaultInjectedError",
    "JournalCorruptError",
    "KernelUnavailableError",
    "NonFiniteOutputError",
    "ReproError",
    "ReproValidationError",
    "RetriesExhaustedError",
    "is_transient",
]
