"""Generic retry with exponential backoff + deterministic jitter.

``with_retry(fn, policy, site=...)`` is the one retry loop of the port:
it classifies failures through ``errors.is_transient``, backs off
exponentially with seeded jitter (deterministic under a fixed seed — the
property the chaos tests assert), honors a wall-clock deadline, and emits
``resilience.retries`` / ``resilience.gave_up`` counters plus
``resilience.backoff_s`` / ``resilience.recovery_s`` histograms so the
recovery overhead can be priced.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional, Tuple, Type, TypeVar

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

from .errors import DeadlineExceededError, RetriesExhaustedError, is_transient
from .faults import _unit_roll

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay_i = min(base * mult**i, max) ± jitter."""

    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of the delay randomized away
    deadline_s: Optional[float] = None   # wall-clock budget for all attempts
    retry_on: Tuple[Type[BaseException], ...] = ()  # extra retryable types
    seed: int = 0

    def delays(self, site: str = "") -> Iterator[float]:
        """The deterministic backoff schedule (attempt i -> sleep before
        attempt i+1). Jitter derives from (seed, site, attempt) only."""
        for i in range(self.max_attempts - 1):
            d = min(self.base_delay_s * self.multiplier**i,
                    self.max_delay_s)
            if self.jitter > 0:
                u = _unit_roll(self.seed, f"retry.{site}", i, "jitter")
                d *= 1.0 - self.jitter * u
            yield d


DEFAULT_POLICY = RetryPolicy()


def _retryable(exc: BaseException, policy: RetryPolicy) -> bool:
    return is_transient(exc) or isinstance(exc, policy.retry_on)


def with_retry(
    fn: Callable[[], T],
    policy: RetryPolicy = DEFAULT_POLICY,
    site: str = "",
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` until it succeeds, retrying transient failures.

    Raises ``RetriesExhaustedError`` (cause = last failure) after
    ``max_attempts``, ``DeadlineExceededError`` when the next backoff
    would overrun ``policy.deadline_s``, and re-raises non-transient
    failures immediately. ``sleep`` is injectable for tests.
    """
    t0 = time.perf_counter()
    delays = policy.delays(site)
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            out = fn()
            if attempt > 1:
                obs_metrics.histogram("resilience.recovery_s").observe(
                    time.perf_counter() - t0
                )
            return out
        except BaseException as e:  # noqa: BLE001 — classified below
            last = e
            if not _retryable(e, policy):
                raise
            delay = next(delays, None)
            if delay is None:  # attempts exhausted
                obs_metrics.counter("resilience.gave_up").inc()
                if site:
                    obs_metrics.counter(
                        f"resilience.gave_up.{site}").inc()
                raise RetriesExhaustedError(site, attempt, e)
            if policy.deadline_s is not None and (
                time.perf_counter() - t0 + delay > policy.deadline_s
            ):
                obs_metrics.counter("resilience.gave_up").inc()
                raise DeadlineExceededError(
                    f"{site or 'call'}: deadline {policy.deadline_s}s "
                    f"exhausted after {attempt} attempts"
                ) from e
            obs_metrics.counter("resilience.retries").inc()
            if site:
                obs_metrics.counter(f"resilience.retries.{site}").inc()
            obs_metrics.histogram("resilience.backoff_s").observe(delay)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            with obs_trace.span("resilience.backoff", site=site,
                                attempt=attempt):
                sleep(delay)
    raise RetriesExhaustedError(site, policy.max_attempts,
                                last or RuntimeError("unreachable"))
