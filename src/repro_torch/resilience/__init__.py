"""Resilience layer of the port: fault injection, retry, the progress
journal, typed errors and the finite-output check.

  errors   typed failure taxonomy + the ``is_transient`` retryability oracle
  faults   deterministic seedable fault injector (``REPRO_FAULTS`` env; the
           same sites, kinds and spec grammar as the reference package)
  retry    ``with_retry`` — exponential backoff + jitter + deadline
  journal  durable progress journal for crash-safe resumable STKDE
           (byte-compatible with the reference package's)
  degrade  graceful degradation: ``run_with_degrade`` walks coarser grids
           and point subsets on failure; ``ensure_finite``

``faults``/``retry``/``errors`` depend only on the stdlib and ``obs``
(itself stdlib-only); ``journal`` adds numpy and ``degrade`` torch.
"""
from . import degrade, errors, faults, journal, retry
from .degrade import (
    DegradedResult,
    DegradePolicy,
    coarsen_domain,
    ensure_finite,
    error_bound,
    run_with_degrade,
    subsample_points,
)
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
from .journal import ProgressJournal, Salvage, fingerprint_of
from .faults import FaultInjector, configure, fault_point, get_injector
from .retry import RetryPolicy, with_retry

__all__ = [
    "degrade",
    "errors",
    "faults",
    "journal",
    "retry",
    "ensure_finite",
    "DegradePolicy",
    "DegradedResult",
    "coarsen_domain",
    "subsample_points",
    "error_bound",
    "run_with_degrade",
    "ProgressJournal",
    "Salvage",
    "fingerprint_of",
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
    "FaultInjector",
    "configure",
    "fault_point",
    "get_injector",
    "RetryPolicy",
    "with_retry",
]
