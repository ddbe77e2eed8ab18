"""Fault-tolerant training runner.

Wraps the functional train step (one device, or ``make_sharded_train_step``
on a mesh, whose ``Sharded`` leaves the checkpoints gather and cut again)
with the reference runner's operational machinery:

  * auto-resume from the latest checkpoint (crash / preemption restart)
  * periodic async checkpoints (the step does not wait for the write)
  * preemption hook (SIGTERM -> stop after the step -> synchronous final
    checkpoint); the final checkpoint is not written again when the async
    one of the same step has just landed (the reference writes it twice)
  * straggler detection: per-step wall-time EWMA; a step slower than
    ``straggler_factor`` times the EWMA is logged with its step index and
    counted (``train.stragglers``)
  * non-finite loss: the update is skipped and the old parameters kept
    (``train.nonfinite_steps``)

Step timing flows through the port's ``obs`` (span ``train.step`` with the
step's loss, histogram ``train.step_s``, counter ``train.steps``); a step
ends when the card has finished it (``obs.timing.block_until_ready``, which
waits for CUDA tensors only).
"""
from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Any, Callable, Iterable

from .. import obs
from ..obs.timing import block_until_ready
from . import checkpoint as ckpt_lib


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    max_steps: int = 1000
    straggler_factor: float = 3.0
    log_every: int = 10
    resume: bool = True


class TrainRunner:
    def __init__(
        self,
        run_cfg: RunnerConfig,
        train_step: Callable,     # (params, opt_state, batch) -> (p, o, m)
        params: Any,
        opt_state: Any,
        log: Callable[[str], None] = print,
    ):
        self.cfg = run_cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.log = log
        self.step = 0
        self.straggler_events = []
        self.metrics_history = []
        self._ckpt = ckpt_lib.AsyncCheckpointer(run_cfg.ckpt_dir,
                                                keep=run_cfg.keep)
        self._preempted = False
        if run_cfg.resume:
            self._maybe_resume()

    # ------------------------------------------------------------- resume
    def _maybe_resume(self):
        last = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return
        (self.params, self.opt_state), self.step, _ = ckpt_lib.restore(
            self.cfg.ckpt_dir, (self.params, self.opt_state), step=last
        )
        self.step = last
        self.log(f"[runner] resumed from step {last}")

    # --------------------------------------------------------- preemption
    def install_preemption_hook(self):
        def handler(signum, frame):
            self._preempted = True
            self.log("[runner] SIGTERM: checkpointing before exit")

        signal.signal(signal.SIGTERM, handler)

    # ------------------------------------------------------------- train
    def run(self, batches: Iterable[Any]) -> dict:
        ewma = None
        async_step = None
        for batch in batches:
            if self.step >= self.cfg.max_steps or self._preempted:
                break
            t0 = time.perf_counter()
            with obs.span("train.step", step=self.step) as sp:
                params, opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch
                )
                loss = float(metrics["loss"])
                sp.set(loss=loss)
                if not math.isfinite(loss):
                    self.log(f"[runner] step {self.step}: non-finite loss "
                             f"{loss}; skipping update")
                    obs.counter("train.nonfinite_steps").inc()
                    self.step += 1
                    continue
                self.params, self.opt_state = params, opt_state
                block_until_ready((params, opt_state, metrics))
            dt = time.perf_counter() - t0
            obs.histogram("train.step_s").observe(dt)
            obs.counter("train.steps").inc()
            if ewma is None:
                ewma = dt
            elif dt > self.cfg.straggler_factor * ewma:
                self.straggler_events.append((self.step, dt, ewma))
                obs.counter("train.stragglers").inc()
                self.log(f"[runner] straggler step {self.step}: "
                         f"{dt * 1e3:.1f}ms vs ewma {ewma * 1e3:.1f}ms")
                # do not poison the EWMA with the outlier
            else:
                ewma = 0.9 * ewma + 0.1 * dt
            self.step += 1
            self.metrics_history.append(
                {k: float(v) for k, v in metrics.items()}
            )
            if self.step % self.cfg.log_every == 0:
                self.log(
                    f"[runner] step {self.step} loss {loss:.4f} "
                    f"({dt * 1e3:.0f}ms)"
                )
            if self.step % self.cfg.ckpt_every == 0:
                self._ckpt.save(self.step, (self.params, self.opt_state))
                async_step = self.step
        # final (synchronous) checkpoint — also the preemption path
        self._ckpt.wait()
        if async_step != self.step:
            ckpt_lib.save(self.cfg.ckpt_dir, self.step,
                          (self.params, self.opt_state))
        return {
            "final_step": self.step,
            "stragglers": len(self.straggler_events),
            "last_loss": (self.metrics_history[-1]["loss"]
                          if self.metrics_history else float("nan")),
        }
