"""Typed error taxonomy for the resilience layer.

Every failure the stack can recover from (or deliberately surface) has a
class here, so callers branch on type instead of string-matching messages.
``is_transient`` is the single retryability oracle used by ``retry`` —
injected faults, CUDA out-of-memory errors, and filesystem hiccups are
transient; validation errors never are.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base class for every typed error raised by this repo."""


class ReproValidationError(ReproError, ValueError):
    """Malformed input rejected at the API boundary (never retried)."""


class AdmissionError(ReproError):
    """Request rejected at submit time (queue full, over limits).

    ``reason`` is a stable machine-readable slug (e.g. ``queue_full``).
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(detail or reason)


class DeadlineExceededError(ReproError):
    """A per-request or per-call deadline elapsed."""


class KernelUnavailableError(ReproError):
    """A hand-written kernel cannot run where it was asked to: no CUDA
    device, the kernel failed to build or launch, or the ``ks``/``kt``
    callable has no id the kernel knows. Never retried, and never answered
    by running the plain version instead."""


class NonFiniteOutputError(ReproError):
    """A kernel/strategy produced NaN/Inf where finite density was due."""


class CheckpointCorruptError(ReproError):
    """Checkpoint bytes failed checksum / structural verification."""


class JournalCorruptError(CheckpointCorruptError):
    """A progress-journal record or grid snapshot failed verification.

    Transient at *write* time (the journal re-writes through ``with_retry``
    like checkpoints do); at *replay* time it is handled structurally —
    corrupt tail records are dropped, never retried.
    """


class DeviceLostError(ReproError):
    """A device in the active mesh died mid-computation (never retried
    on the same mesh — the chunked executor re-plans onto a shrunken
    mesh instead; see docs/resilience.md "Resumable execution")."""

    def __init__(self, site: str, mesh_shape=None):
        self.site = site
        self.mesh_shape = tuple(mesh_shape) if mesh_shape else None
        super().__init__(
            f"DEVICE_LOST: [{site}] device failed mid-run"
            + (f" on mesh {self.mesh_shape}" if self.mesh_shape else "")
        )


class RetriesExhaustedError(ReproError):
    """``with_retry`` gave up; ``__cause__`` holds the last failure."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        self.site = site
        self.attempts = attempts
        super().__init__(
            f"{site or 'call'}: gave up after {attempts} attempts: "
            f"{type(last).__name__}: {last}"
        )
        self.__cause__ = last


# ------------------------------------------------------------ injected
class FaultInjectedError(ReproError):
    """Base for faults raised by the deterministic injector."""

    def __init__(self, site: str, msg: str):
        self.site = site
        super().__init__(msg)


class InjectedOOMError(FaultInjectedError):
    """Carries the RESOURCE_EXHAUSTED text of a device out-of-memory."""

    def __init__(self, site: str):
        super().__init__(
            site,
            f"RESOURCE_EXHAUSTED: [injected@{site}] Out of memory while "
            "trying to allocate 9437184000 bytes.",
        )


class InjectedDropError(FaultInjectedError):
    """A work item was dropped / a read failed (transient)."""

    def __init__(self, site: str):
        super().__init__(site, f"UNAVAILABLE: [injected@{site}] work item "
                               "dropped")


_TRANSIENT = (
    InjectedOOMError,
    InjectedDropError,
    NonFiniteOutputError,
    CheckpointCorruptError,
    OSError,
)


def is_transient(exc: BaseException) -> bool:
    """Retryability oracle: injected faults, OOMs, I/O errors — not
    validation/admission errors, not arbitrary bugs."""
    if isinstance(exc, (ReproValidationError, AdmissionError,
                        DeadlineExceededError, DeviceLostError,
                        KernelUnavailableError)):
        return False
    if isinstance(exc, _TRANSIENT):
        return True
    # a real device OOM is torch.cuda.OutOfMemoryError; match by name so
    # this module stays stdlib-only
    return type(exc).__name__ == "OutOfMemoryError"
