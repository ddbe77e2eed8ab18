"""Deterministic, seedable fault injector (env/config-driven).

The injector is the chaos half of the resilience layer: production code
calls ``fault_point(site)`` / ``corrupt(site, data)`` / ``poison(site,
arr)`` at named sites, and a spec decides — deterministically — which of
those calls actually fail. With no spec every hook is a no-op costing one
dict lookup.

Spec grammar (env var ``REPRO_FAULTS`` or ``configure()``)::

    site:kind:rate[,site:kind:rate...]
    REPRO_FAULTS="serve.prefill:oom:0.1,ckpt.write:corrupt:0.25"
    REPRO_FAULTS="*:drop:0.05"          # wildcard: every known site

Sites:  serve.prefill  serve.decode  dist.halo  dist.device  ckpt.write
        journal.write  stkde.chunk   data.read
Kinds:  oom      raise InjectedOOMError (RESOURCE_EXHAUSTED-styled)
        drop     raise InjectedDropError
        delay    sleep ``param`` seconds (default 0.05)
        corrupt  bit-flip bytes passed through ``corrupt()``
        nan      NaN-poison arrays passed through ``poison()``

Determinism: each (site) keeps a call counter k; the decision for call k
derives from ``sha256(seed, site, k)`` — independent of wall clock,
thread timing, and of every other site. Same seed + same call sequence
⇒ identical faults, which is what makes chaos tests assertable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import metrics as obs_metrics

from .errors import InjectedDropError, InjectedOOMError, ReproValidationError

SITES = (
    "serve.prefill",
    "serve.decode",
    "dist.halo",
    "dist.device",
    "ckpt.write",
    "journal.write",
    "stkde.chunk",
    "data.read",
)
KINDS = ("oom", "drop", "delay", "corrupt", "nan")

ENV_SPEC = "REPRO_FAULTS"
ENV_SEED = "REPRO_FAULTS_SEED"


@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str
    kind: str
    rate: float
    param: float = 0.05  # delay seconds / corrupt flip density knob


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse ``site:kind:rate[:param]`` comma list; '*' fans out to SITES."""
    rules: List[FaultRule] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (3, 4):
            raise ReproValidationError(
                f"bad fault rule {part!r}: want site:kind:rate[:param]"
            )
        site, kind, rate = fields[0], fields[1], float(fields[2])
        param = float(fields[3]) if len(fields) == 4 else 0.05
        if kind not in KINDS:
            raise ReproValidationError(
                f"unknown fault kind {kind!r} (have {KINDS})"
            )
        if not 0.0 <= rate <= 1.0:
            raise ReproValidationError(f"fault rate {rate} outside [0, 1]")
        sites = SITES if site in ("*", "all") else (site,)
        for s in sites:
            rules.append(FaultRule(site=s, kind=kind, rate=rate,
                                   param=param))
    return rules


def _unit_roll(seed: int, site: str, k: int, salt: str) -> float:
    """Deterministic uniform [0,1) from (seed, site, call-index, salt)."""
    h = hashlib.sha256(
        f"{seed}|{site}|{k}|{salt}".encode()
    ).digest()
    (x,) = struct.unpack("<Q", h[:8])
    return x / 2**64


class FaultInjector:
    """Deterministic per-site fault decisions; thread-safe counters."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.seed = int(seed)
        self._rules: Dict[str, List[FaultRule]] = {}
        for r in rules:
            self._rules.setdefault(r.site, []).append(r)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "FaultInjector":
        env = os.environ if env is None else env
        return cls(parse_spec(env.get(ENV_SPEC, "")),
                   seed=int(env.get(ENV_SEED, "0")))

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def _next_k(self, site: str) -> int:
        with self._lock:
            k = self._counts.get(site, 0)
            self._counts[site] = k + 1
            return k

    def _trigger(self, site: str, kinds: Tuple[str, ...]
                 ) -> Optional[FaultRule]:
        rules = [r for r in self._rules.get(site, ()) if r.kind in kinds]
        if not rules:
            return None
        k = self._next_k(site)
        for i, r in enumerate(rules):
            if _unit_roll(self.seed, site, k, f"{r.kind}{i}") < r.rate:
                obs_metrics.counter("resilience.injected").inc()
                obs_metrics.counter(f"resilience.injected.{site}").inc()
                return r
        return None

    # ------------------------------------------------------------ hooks
    def maybe_fail(self, site: str) -> None:
        """Control-flow faults: raise (oom/drop) or stall (delay)."""
        r = self._trigger(site, ("oom", "drop", "delay"))
        if r is None:
            return
        if r.kind == "oom":
            raise InjectedOOMError(site)
        if r.kind == "drop":
            raise InjectedDropError(site)
        time.sleep(r.param)

    def corrupt(self, site: str, data: bytes) -> bytes:
        """Data faults: flip a few bytes of ``data`` when triggered."""
        r = self._trigger(site, ("corrupt",))
        if r is None or not data:
            return data
        out = bytearray(data)
        n_flips = max(1, int(len(out) * min(r.param, 0.01)))
        for i in range(n_flips):
            pos = int(_unit_roll(self.seed, site, i, "pos") * len(out))
            out[pos] ^= 0xFF
        return bytes(out)

    def poison(self, site: str, arr):
        """Output faults: NaN-poison an array when triggered."""
        r = self._trigger(site, ("nan",))
        if r is None:
            return arr
        import numpy as np
        import torch

        if isinstance(arr, torch.Tensor):  # poisoned where it lives
            return arr * float("nan")
        out = np.array(arr, copy=True)
        out.reshape(-1)[:: max(1, out.size // 8)] = np.nan
        return out

    def reset_counts(self) -> None:
        with self._lock:
            self._counts.clear()


# ------------------------------------------------------- global injector
_INJECTOR: Optional[FaultInjector] = None
_GLOBAL_LOCK = threading.Lock()


def get_injector() -> FaultInjector:
    global _INJECTOR
    with _GLOBAL_LOCK:
        if _INJECTOR is None:
            _INJECTOR = FaultInjector.from_env()
        return _INJECTOR


def configure(spec: str, seed: int = 0) -> FaultInjector:
    """Install a process-global injector from a spec string."""
    global _INJECTOR
    inj = FaultInjector(parse_spec(spec), seed=seed)
    with _GLOBAL_LOCK:
        _INJECTOR = inj
    return inj


def reset() -> None:
    """Drop the global injector; next use re-derives from the env."""
    global _INJECTOR
    with _GLOBAL_LOCK:
        _INJECTOR = None


# Module-level conveniences used at the named sites in production code.
def fault_point(site: str) -> None:
    get_injector().maybe_fail(site)


def corrupt(site: str, data: bytes) -> bytes:
    return get_injector().corrupt(site, data)


def poison(site: str, arr):
    return get_injector().poison(site, arr)
