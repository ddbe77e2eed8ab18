"""Serving: the language-model engine (slot-swap continuous batching, and
the bucketed path) and STKDE partial answers.

Language models (the reference's ``serve/engine.py``):

  * ``make_serve_step(cfg)`` / ``make_prefill(cfg, max_seq)`` — the
    (params, state, token) -> (logits, state) decode function and the
    prompt prefill the engine calls.
  * ``ServingEngine`` with ``EngineConfig.continuous_batching`` (the
    default) runs a fixed pool of ``max_batch`` decode slots with per-row
    cache positions (``DecodeState.step`` a (B,) tensor): a row that hits
    EOS, ``max_new`` or its deadline is swapped out at once and the next
    queued request is prefilled into the freed slot mid-decode
    (``models.model.prefill(..., state=, slot=)``), so no slot idles while
    work is queued. ``continuous_batching=False`` keeps the bucketed path:
    same-length buckets of at most ``max_batch`` requests, one prefill and
    a lockstep decode per bucket; finished rows idle until the bucket
    drains. An encoder-decoder config is always served bucketed (a slot
    swap has no per-row encoder output), as in the reference. Greedy
    decode gives the same tokens on both paths (per-row masks keep each
    row's arithmetic apart from its neighbours'), except where a MoE
    layer's expert capacity drops tokens: its capacity depends on how many
    tokens share the call, so a prompt prefilled alone and the same prompt
    prefilled in a bucket can drop different ones (the reference's
    engine does the same).

Scheduler loop (continuous path)::

    while queued or occupied:
        retire rows at EOS / max_new / deadline   -> RequestResult
        prefill queued requests into free slots   (serve.swap_s)
        one masked decode step over the pool      (serve.decode_token_s)

Resilience contract, as the reference's: ``submit`` validates prompts and
enforces bounded admission (``EngineConfig.max_queue``, typed
``AdmissionError`` + ``serve.rejected`` counter); ``run`` never raises for
a per-request failure. Continuous: a failing slot prefill is retried under
``EngineConfig.retry`` and then fails only that request; a failing decode
step is retried in place and, when retries run out, fails only the rows
occupied at that moment. Bucketed: a failing bucket is retried whole, then
each of its requests alone. A request that still fails ends in a typed
failed ``RequestResult``. Fault sites ``serve.prefill`` / ``serve.decode``
are the port's injector's.

Observability: ``serve.continuous`` / ``serve.bucket`` / ``serve.prefill``
spans, ``serve.queue_wait_s`` (once per request, at its first service
attempt), ``serve.prefill_s``, ``serve.swap_s``, ``serve.decode_token_s``,
``serve.slot_occupancy``, ``serve.slot_idle_frac``, ``serve.tokens_per_s``
(wall clock, swaps included) and ``serve.decode_tokens_per_s`` (decode-step
time only).

STKDE: ``stkde_partial_answer`` is the lowest rung of the degrade ladder,
over the port's ``ProgressJournal``, which reads a journal written by either
package.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from .._device import DeviceLike, resolve_device
from ..models import layers
from ..models import model as model_lib
from ..models.model import DecodeState
from ..models.transformer import tree_map
from ..resilience import faults
from ..resilience.errors import (
    AdmissionError,
    NonFiniteOutputError,
    ReproValidationError,
)
from ..resilience.journal import ProgressJournal
from ..resilience.retry import RetryPolicy, with_retry


def make_serve_step(cfg):
    """One-token decode step."""

    def serve_step(params, state: DecodeState, token):
        return model_lib.decode_step(cfg, params, token, state)

    return serve_step


def make_prefill(cfg, max_seq: int):
    def prefill_fn(params, tokens, **kw):
        return model_lib.prefill(cfg, params, tokens, max_seq=max_seq, **kw)

    return prefill_fn


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 32
    out: Optional[np.ndarray] = None
    t_submit: float = 0.0         # perf_counter at submit(); queue-wait base
    deadline: Optional[float] = None   # perf_counter absolute deadline
    qw_seen: bool = False         # queue wait observed (once per request)


@dataclasses.dataclass
class RequestResult:
    """Terminal status of one served request.

    Exactly one of three shapes (the engine's completion guarantee):
    ``ok`` (full generation), ``degraded`` (partial/retried generation,
    ``reason`` says why), or failed (``ok=False`` with a typed ``reason``
    — never an unhandled exception).
    """

    uid: int
    tokens: np.ndarray
    ok: bool = True
    degraded: bool = False
    reason: str = ""
    attempts: int = 1


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 512
    temperature: float = 0.0      # 0 = greedy
    eos_id: int = -1              # -1 = never stop on token
    seed: int = 0
    continuous_batching: bool = True   # slot-swap decode; False = bucketed
    # --- resilience ---
    max_queue: int = 256          # bounded admission; 0 = unbounded
    request_timeout_s: Optional[float] = None   # 0 = expire immediately
    retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(max_attempts=3,
                                            base_delay_s=0.002,
                                            max_delay_s=0.05)
    )


def _blank_stats(mode: str) -> Dict:
    return {
        "mode": mode,
        "wall_s": 0.0,
        "decode_s": 0.0,
        "n_tokens": 0,
        "decode_steps": 0,
        "slot_steps": 0,          # decode_steps * pool or bucket width
        "active_slot_steps": 0,   # slot-steps that produced a kept token
        "swaps": 0,
        "queue_wait_s": [],
    }


def sample_seed(seed: int, uid: int, count: int) -> int:
    """The seed of the generator that draws request ``uid``'s token number
    ``count`` (0 = the first generated token): a function of the three
    alone, so a retry or a solo rerun draws the same token."""
    words = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, uid & 0xFFFFFFFF, count & 0xFFFFFFFF]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class ServingEngine:
    """Serving of ``cfg`` with ``params`` on ``device`` (``None`` means
    ``"cuda"``; the parameters are moved there if they are not).

    Sampling at ``temperature > 0`` cannot reproduce the reference's
    ``jax.random`` streams. Each token is drawn on the host from the
    softmax of its row's fp32 logits over ``temperature``, by a
    ``torch.Generator`` seeded with ``sample_seed(seed, uid, count)``: the
    token depends on the request and its position only, so a retry, a
    request rerun alone, or the other scheduling path draws the same
    tokens, as the reference promises.
    """

    def __init__(self, cfg, params, ecfg: EngineConfig,
                 device: DeviceLike = None):
        if ecfg.request_timeout_s is not None and ecfg.request_timeout_s < 0:
            raise ReproValidationError(
                f"request_timeout_s must be >= 0 or None: "
                f"{ecfg.request_timeout_s}"
            )
        if ecfg.max_batch < 1:
            raise ReproValidationError(
                f"max_batch must be >= 1: {ecfg.max_batch}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.ecfg = ecfg
        self.queue: List[Request] = []
        self.done: Dict[int, np.ndarray] = {}
        self.results: Dict[int, RequestResult] = {}
        self.last_stats: Dict = _blank_stats("idle")
        self._prefill = make_prefill(cfg, ecfg.max_seq)
        self._step = make_serve_step(cfg)
        # continuous batching needs decoder-only states (a slot swap has no
        # per-row encoder output); whisper-style configs are served bucketed
        self._continuous = (ecfg.continuous_batching
                            and not getattr(cfg, "enc_dec", False))

    def _prefill_slot(self, params, tokens, state: DecodeState, slot: int):
        """Prefill a (1, S) prompt into row ``slot`` of the pool ``state``."""
        return model_lib.prefill(self.cfg, params, tokens,
                                 max_seq=self.ecfg.max_seq, state=state,
                                 slot=slot)

    # ------------------------------------------------------------- submit
    def _validate_prompt(self, prompt: np.ndarray) -> np.ndarray:
        p = np.asarray(prompt)
        if p.ndim != 1 or len(p) == 0:
            raise ReproValidationError(
                f"prompt must be a non-empty 1-D token array; got shape "
                f"{p.shape}"
            )
        if len(p) > self.ecfg.max_seq:
            raise ReproValidationError(
                f"prompt length {len(p)} exceeds max_seq "
                f"{self.ecfg.max_seq}"
            )
        if not np.issubdtype(p.dtype, np.integer):
            if not np.all(np.isfinite(p)) or np.any(p != np.floor(p)):
                raise ReproValidationError(
                    "prompt tokens must be integers (got non-finite or "
                    "fractional values)"
                )
        vocab = getattr(self.cfg, "vocab", None)
        if np.any(p < 0) or (vocab is not None and np.any(p >= vocab)):
            raise ReproValidationError(
                f"prompt tokens outside [0, {vocab})"
            )
        return p.astype(np.int32)

    def submit(self, uid: int, prompt: np.ndarray, max_new: int = 32):
        """Enqueue a request. Raises ``ReproValidationError`` on malformed
        input and ``AdmissionError`` when the queue is full."""
        if max_new <= 0:
            raise ReproValidationError(f"max_new must be positive: {max_new}")
        p = self._validate_prompt(prompt)
        if self.ecfg.max_queue > 0 and len(self.queue) >= self.ecfg.max_queue:
            obs.counter("serve.rejected").inc()
            raise AdmissionError(
                "queue_full",
                f"admission queue full ({len(self.queue)}/"
                f"{self.ecfg.max_queue}); retry after run()",
            )
        obs.counter("serve.requests").inc()
        now = time.perf_counter()
        # timeout 0 means "expire immediately", not "no timeout" — only
        # None disables the deadline
        dl = (now + self.ecfg.request_timeout_s
              if self.ecfg.request_timeout_s is not None else None)
        self.queue.append(
            Request(uid=uid, prompt=p, max_new=max_new, t_submit=now,
                    deadline=dl)
        )

    # ---------------------------------------------------------------- run
    def run(self) -> Dict[int, np.ndarray]:
        """Serve everything in the queue; returns uid -> generated tokens.

        Completion guarantee: every queued uid appears in the result (and
        in ``self.results`` with full status) — failed/expired requests
        map to an empty token array rather than raising.
        """
        reqs, self.queue = self.queue, []
        self.results = {}
        self.last_stats = _blank_stats(
            "continuous" if self._continuous else "bucketed")
        t0 = time.perf_counter()
        with torch.inference_mode():
            if self._continuous:
                self._run_continuous(reqs)
            else:
                buckets = defaultdict(list)
                for r in reqs:
                    buckets[len(r.prompt)].append(r)
                for _, bucket in sorted(buckets.items()):
                    for i in range(0, len(bucket), self.ecfg.max_batch):
                        self._serve_bucket(
                            bucket[i: i + self.ecfg.max_batch])
        st = self.last_stats
        st["wall_s"] = time.perf_counter() - t0
        if st["slot_steps"]:
            obs.gauge("serve.slot_idle_frac").set(
                1.0 - st["active_slot_steps"] / st["slot_steps"])
        if st["wall_s"] > 0:
            obs.gauge("serve.tokens_per_s").set(
                st["n_tokens"] / st["wall_s"])
        if st["decode_s"] > 0:
            obs.gauge("serve.decode_tokens_per_s").set(
                st["n_tokens"] / st["decode_s"])
        obs.counter("serve.tokens").inc(st["n_tokens"])
        out, self.done = self.done, {}
        return out

    def run_detailed(self) -> Dict[int, RequestResult]:
        """Like ``run`` but returns the full per-request status map."""
        self.run()
        return self.results

    # --------------------------------------------------------- shared bits
    def _observe_queue_wait(self, r: Request) -> None:
        """Queue wait is observed exactly once per request, at its first
        service attempt — retries and solo-degrade reruns must not
        re-observe it (they would inflate p95/p99 under fault injection)."""
        if r.qw_seen or r.t_submit <= 0:
            return
        r.qw_seen = True
        w = max(time.perf_counter() - r.t_submit, 0.0)
        obs.histogram("serve.queue_wait_s").observe(w)
        self.last_stats["queue_wait_s"].append(w)

    def _sample(self, logits: torch.Tensor, uids, counts) -> torch.Tensor:
        """(B, V) fp32 logits -> (B,) tokens on the logits' device: the
        argmax when greedy, else one seeded draw per row (see the class)."""
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float().cpu() / self.ecfg.temperature,
                              dim=-1)
        out = torch.empty(len(uids), dtype=torch.int64)
        for i, (uid, count) in enumerate(zip(uids, counts)):
            g = torch.Generator()
            g.manual_seed(sample_seed(self.ecfg.seed, int(uid), int(count)))
            out[i] = torch.multinomial(probs[i], 1, generator=g)[0]
        return out.to(logits.device)

    @staticmethod
    def _check_logits(logits: torch.Tensor) -> None:
        """Fault-site output validation: poisoned logits must not silently
        become argmax(NaN) tokens."""
        if not bool(torch.isfinite(logits).all()):
            raise NonFiniteOutputError("serve: non-finite logits")

    def _fail(self, r: Request, exc: BaseException, attempts: int,
              tokens: Optional[List[int]] = None) -> None:
        obs.counter("serve.failed").inc()
        toks = np.asarray(tokens or [], np.int32)
        self.results[r.uid] = RequestResult(
            uid=r.uid, tokens=toks, ok=False, degraded=True,
            attempts=attempts, reason=f"{type(exc).__name__}: {exc}",
        )
        self.done[r.uid] = toks

    # ------------------------------------------------- continuous batching
    def _run_continuous(self, reqs: List[Request]) -> None:
        """Slot-swap scheduler: fixed pool of ``max_batch`` decode slots,
        per-row cache positions, mid-decode prefill into freed slots."""
        B = self.ecfg.max_batch
        dev = self.device
        state = model_lib.init_decode_state(
            self.cfg, B, self.ecfg.max_seq,
            layers.dtype_of(self.cfg.compute_dtype), dev, per_row=True)
        pending = deque(reqs)
        slots: List[Optional[Request]] = [None] * B
        gen: List[List[int]] = [[] for _ in range(B)]
        attempts = [1] * B
        retried = [False] * B
        last_tok = np.zeros(B, np.int64)
        uids = np.zeros(B, np.int64)
        st = self.last_stats
        decode_h = obs.histogram("serve.decode_token_s")
        swap_h = obs.histogram("serve.swap_s")
        eos = self.ecfg.eos_id

        def occupied() -> List[int]:
            return [i for i in range(B) if slots[i] is not None]

        def retire(i: int, reason: str = "") -> None:
            r = slots[i]
            slots[i] = None
            toks = gen[i][: r.max_new]
            gen[i] = []
            degraded = bool(reason) or retried[i]
            self.results[r.uid] = RequestResult(
                uid=r.uid, tokens=np.asarray(toks, np.int32), ok=True,
                degraded=degraded, attempts=attempts[i],
                reason=reason or ("retried" if retried[i] else ""),
            )
            self.done[r.uid] = self.results[r.uid].tokens

        def retire_finished() -> None:
            now = time.perf_counter()
            for i in occupied():
                r = slots[i]
                if len(gen[i]) >= r.max_new:
                    retire(i)
                elif (r.deadline is not None and now > r.deadline
                        and (eos < 0 or eos not in gen[i])):
                    obs.counter("serve.deadline_truncated").inc()
                    retire(i, reason="deadline_truncated")

        with obs.span("serve.continuous", batch=B, n_requests=len(reqs)):
            while pending or occupied():
                retire_finished()
                # ---- swap in: prefill queued requests into free slots
                for i in range(B):
                    if slots[i] is not None or not pending:
                        continue
                    r = pending.popleft()
                    self._observe_queue_wait(r)
                    t_sw = time.perf_counter()
                    swapped = self._swap_in(r, i, state)
                    swap_h.observe(time.perf_counter() - t_sw)
                    st["swaps"] += 1
                    if swapped is None:      # typed failure already logged
                        continue
                    state, first, n_att = swapped
                    slots[i] = r
                    gen[i] = [first]
                    last_tok[i] = first
                    uids[i] = r.uid
                    attempts[i] = n_att
                    retried[i] = n_att > 1
                    st["n_tokens"] += 1
                retire_finished()            # max_new==1 / expired deadlines
                occ = occupied()
                obs.gauge("serve.slot_occupancy").set(len(occ) / B)
                if not occ:
                    if pending:
                        continue
                    break
                # ---- one masked decode step over the whole pool
                tok = torch.from_numpy(last_tok[:, None]).to(dev)
                counts = [len(g) for g in gen]
                cur_state = state

                def step_attempt() -> Tuple[DecodeState, np.ndarray]:
                    faults.fault_point("serve.decode")
                    # idle rows decode too; their tokens are thrown away,
                    # and a row past the cache's end writes nothing
                    logits, new_state = self._step(self.params, cur_state,
                                                   tok)
                    logits = faults.poison("serve.decode", logits)
                    # checked before sampling: a draw from NaN
                    # probabilities raises rather than yielding a token
                    self._check_logits(logits[occ, -1])
                    nxt = self._sample(logits[:, -1], uids, counts)
                    return new_state, nxt.cpu().numpy()   # device sync

                def bump(_a, _e, _d):
                    for i in occ:
                        attempts[i] += 1
                        retried[i] = True

                t_dec = time.perf_counter()
                try:
                    state, nxt = with_retry(
                        step_attempt, policy=self.ecfg.retry,
                        site="serve.decode", on_retry=bump,
                    )
                except Exception as e:  # noqa: BLE001 — per-slot degrade
                    obs.counter("serve.step_failed").inc()
                    for i in occ:
                        r, toks = slots[i], gen[i]
                        slots[i], gen[i] = None, []
                        self._fail(r, e, attempts[i], tokens=toks)
                    continue
                dt_step = time.perf_counter() - t_dec
                decode_h.observe(dt_step)
                st["decode_s"] += dt_step
                st["decode_steps"] += 1
                st["slot_steps"] += B
                st["active_slot_steps"] += len(occ)
                for i in occ:
                    t = int(nxt[i])
                    gen[i].append(t)
                    last_tok[i] = t
                    st["n_tokens"] += 1
                    if t == eos and len(gen[i]) > 1:
                        retire(i)

    def _swap_in(self, r: Request, slot: int, state: DecodeState):
        """Prefill one request into pool row ``slot`` (retried under the
        engine policy). Returns (state, first_token, attempts) or None
        after recording a typed failure — never raises."""
        n_att = [1]

        def bump(_a, _e, _d):
            n_att[0] += 1

        prompt = torch.from_numpy(r.prompt[None].astype(np.int64)).to(
            self.device)

        def attempt():
            t0 = time.perf_counter()
            with obs.span("serve.prefill", slot=slot, seq=len(r.prompt)):
                faults.fault_point("serve.prefill")
                logits, new_state = self._prefill_slot(
                    self.params, prompt, state, slot)
                logits = faults.poison("serve.prefill", logits)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                    obs.trace.count_sync()
            obs.histogram("serve.prefill_s").observe(time.perf_counter() - t0)
            self._check_logits(logits[:, -1])
            return logits, new_state

        try:
            logits, new_state = with_retry(
                attempt, policy=self.ecfg.retry, site="serve.prefill",
                on_retry=bump,
            )
        except Exception as e:  # noqa: BLE001 — per-slot degrade
            self._fail(r, e, n_att[0])
            return None
        first = int(self._sample(logits[:, -1], [r.uid], [0])[0])
        return new_state, first, n_att[0]

    # ---------------------------------------------------------- bucketed
    def _serve_bucket(self, reqs: List[Request]):
        """Retry-or-degrade wrapper: bucket retried whole, then failing
        requests re-run solo, and final stragglers are marked failed —
        this method never raises for per-request faults."""
        attempts = 1

        def bump(_a, _e, _d):
            nonlocal attempts
            attempts += 1

        for r in reqs:
            self._observe_queue_wait(r)
        try:
            gen = with_retry(
                lambda: self._run_bucket(reqs),
                policy=self.ecfg.retry,
                site="serve.bucket",
                on_retry=bump,
            )
            self._finish(reqs, gen, attempts=attempts,
                         degraded=attempts > 1,
                         reason="retried" if attempts > 1 else "")
            return
        except Exception as e:  # noqa: BLE001 — degrade path below
            obs.counter("serve.bucket_failed").inc()
            last = e
        if len(reqs) > 1:
            # degrade: the bucket keeps failing as a batch — serve each
            # request alone so one poisoned row cannot sink its neighbors
            for r in reqs:
                self._serve_bucket([r])
            for r in reqs:
                res = self.results[r.uid]
                if res.ok and not res.degraded:
                    res.degraded = True
                    res.reason = "bucket_degraded_to_solo"
            return
        self._fail(reqs[0], last, attempts)

    def _finish(self, reqs, gen, attempts=1, degraded=False, reason=""):
        for r_i, r in enumerate(reqs):
            toks = np.asarray(gen[r_i][: r.max_new], np.int32)
            timed_out = (r.deadline is not None
                         and len(toks) < r.max_new
                         and time.perf_counter() > r.deadline
                         and (self.ecfg.eos_id < 0
                              or self.ecfg.eos_id not in toks.tolist()))
            self.results[r.uid] = RequestResult(
                uid=r.uid, tokens=toks, ok=True,
                degraded=degraded or timed_out,
                attempts=attempts,
                reason="deadline_truncated" if timed_out else reason,
            )
            self.done[r.uid] = toks

    def _run_bucket(self, reqs: List[Request]) -> List[List[int]]:
        """One attempt at a bucket; pure w.r.t. engine state so retries
        can re-run it from scratch (results land via ``_finish``)."""
        B = len(reqs)
        uids = [r.uid for r in reqs]
        st = self.last_stats
        dev = self.device
        with obs.span("serve.bucket", batch=B, seq=len(reqs[0].prompt)):
            prompts = torch.from_numpy(
                np.stack([r.prompt for r in reqs]).astype(np.int64)).to(dev)
            t0 = time.perf_counter()
            with obs.span("serve.prefill"):
                faults.fault_point("serve.prefill")
                logits, state = self._prefill(self.params, prompts)
                logits = faults.poison("serve.prefill", logits)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    obs.trace.count_sync()
            obs.histogram("serve.prefill_s").observe(time.perf_counter() - t0)
            self._check_logits(logits[:, -1])
            max_new = max(r.max_new for r in reqs)
            tok = self._sample(logits[:, -1], uids, [0] * B)[:, None]
            active = np.ones(B, bool)
            gen: List[List[int]] = [[] for _ in range(B)]
            first = tok[:, 0].cpu().numpy()
            for r_i in range(B):
                gen[r_i].append(int(first[r_i]))
            st["n_tokens"] += B
            decode_h = obs.histogram("serve.decode_token_s")
            for _ in range(max_new - 1):
                t0 = time.perf_counter()
                faults.fault_point("serve.decode")
                logits, state = self._step(self.params, state, tok)
                logits = faults.poison("serve.decode", logits)
                self._check_logits(logits[:, -1])
                counts = [len(g) for g in gen]
                tok = self._sample(logits[:, -1], uids, counts)[:, None]
                host = tok[:, 0].cpu().numpy()   # device sync
                dt_step = time.perf_counter() - t0
                decode_h.observe(dt_step)
                st["decode_s"] += dt_step
                st["decode_steps"] += 1
                st["slot_steps"] += B
                now = time.perf_counter()
                for r_i in range(B):
                    if not active[r_i]:
                        continue
                    if len(gen[r_i]) >= reqs[r_i].max_new:
                        active[r_i] = False
                        continue
                    if (reqs[r_i].deadline is not None
                            and now > reqs[r_i].deadline):
                        # per-request timeout: stop generating for this
                        # row; _finish tags the partial result degraded
                        obs.counter("serve.deadline_truncated").inc()
                        active[r_i] = False
                        continue
                    t = int(host[r_i])
                    gen[r_i].append(t)
                    st["n_tokens"] += 1
                    st["active_slot_steps"] += 1
                    if t == self.ecfg.eos_id:
                        active[r_i] = False
                if not active.any():
                    break
        return gen


# ------------------------------------------------- STKDE partial answers
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


def cache_bytes(cfg, batch: int, seq: int) -> int:
    """KV-cache footprint for reports/planning (bf16), as the reference
    counts it."""
    if cfg.mixer == "attn" and cfg.mla:
        per_tok = cfg.kv_lora + cfg.qk_rope_dims
        return cfg.n_layers * batch * seq * per_tok * 2
    if cfg.mixer == "attn":
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
        return cfg.n_layers * batch * seq * per_tok * 2
    state = 0
    if cfg.mixer == "mamba2":
        state = cfg.n_layers * batch * (
            cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            + (cfg.ssm_conv - 1) * (cfg.d_inner_ssm + 2 * cfg.ssm_groups
                                    * cfg.ssm_state) * 2
        )
    if cfg.mixer == "rwkv6":
        H = cfg.d_model // 64
        state = cfg.n_layers * batch * (H * 64 * 64 * 4 + 2 * cfg.d_model * 2)
    if cfg.shared_attn_every > 0:
        state += (cfg.attn_sites * batch * seq
                  * 2 * cfg.n_kv_heads * cfg.head_dim * 2)
    return state
