"""Fault-tolerant step runner + straggler detection — the port of the
JAX package's ``repro.runtime.fault_tolerance``.

* ``StepRunner`` — drives training with periodic atomic checkpoints; on
  a step failure it restores the last committed checkpoint and replays
  the deterministic data stream (``data.pipeline`` contract), bounded
  by a retry budget.
* ``StragglerMonitor`` — per-host step-time EWMA; hosts slower than
  ``threshold`` x median are flagged.

The JAX package's ``elastic_remesh`` and ``replace_state`` re-place a
checkpoint onto a smaller device mesh; they come with the port's
distributed slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from ..ckpt import checkpoint as ckpt


class StepFailure(Exception):
    """Raised by a step function to signal a (simulated or real) fault."""


@dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2          # EWMA coefficient
    threshold: float = 1.5      # x median = straggler
    ewma: Optional[np.ndarray] = None

    def record(self, host_times: np.ndarray) -> list[int]:
        if self.ewma is None:
            self.ewma = host_times.astype(np.float64).copy()
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * host_times
        med = float(np.median(self.ewma))
        return [i for i, t in enumerate(self.ewma)
                if t > self.threshold * med]


@dataclass
class StepRunner:
    """Run (step_fn, state, data) with checkpoint/restart semantics.
    ``state`` is a tree of tensors (``ckpt.restore`` returns new ones on
    each leaf's device, so ``step_fn`` takes the state it is given)."""

    step_fn: Callable[[Any, dict], Any]     # state, batch -> state, metrics
    batch_at: Callable[[int], dict]         # deterministic data access
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    keep: int = 2
    async_save: bool = False
    on_step: Optional[Callable[[int, dict], None]] = None

    def resume_or_init(self, init_state) -> tuple[Any, int]:
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return init_state, 0
        state = ckpt.restore(self.ckpt_dir, last, init_state)
        return state, last

    def run(self, init_state, n_steps: int) -> tuple[Any, list[dict]]:
        state, start = self.resume_or_init(init_state)
        metrics_log: list[dict] = []
        step = start
        retries = 0
        pending: Optional[Any] = None
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                batch = self.batch_at(step)
                state, metrics = self.step_fn(state, batch)
                metrics = dict(metrics)
                metrics["step_time"] = time.perf_counter() - t0
                metrics["step"] = step
                metrics_log.append(metrics)
                if self.on_step:
                    self.on_step(step, metrics)
                step += 1
                retries = 0
                if step % self.ckpt_every == 0 or step == n_steps:
                    pending = ckpt.save(self.ckpt_dir, step, state,
                                        blocking=not self.async_save)
                    ckpt.prune_old(self.ckpt_dir, self.keep)
            except StepFailure:
                retries += 1
                if retries > self.max_retries:
                    raise
                last = ckpt.latest_step(self.ckpt_dir)
                if last is not None:
                    state = ckpt.restore(self.ckpt_dir, last, state)
                    step = last
                # else: replay from the current in-memory state
        if pending is not None:
            pending.join()
        return state, metrics_log
