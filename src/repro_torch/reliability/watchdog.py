"""Soft step watchdog for the serving loop.

Wraps each engine step, records the running maximum step latency, and
counts *breaches* of an optional wall-clock budget.  Soft by design: a
breach increments a counter (and fires an optional callback) rather
than killing the step — a launched CUDA graph or kernel cannot be
safely interrupted mid-flight, and the engine's tiered fallback
already handles the failure modes worth aborting for.  The chaos lane asserts
``breaches == 0`` under a generous budget, which catches hangs and
pathological recompile loops without flaking on CI jitter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterator, Optional

__all__ = ["StepWatchdog"]


@dataclasses.dataclass
class StepWatchdog:
    budget_s: Optional[float] = None
    on_breach: Optional[Callable[[str, float], None]] = None
    n_steps: int = 0
    breaches: int = 0
    max_step_s: float = 0.0
    last_step_s: float = 0.0
    last_label: str = ""

    @contextlib.contextmanager
    def watch(self, label: str = "") -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.n_steps += 1
            self.last_step_s = dt
            self.last_label = label
            if dt > self.max_step_s:
                self.max_step_s = dt
            if self.budget_s is not None and dt > self.budget_s:
                self.breaches += 1
                if self.on_breach is not None:
                    self.on_breach(label, dt)

    def reset(self) -> None:
        self.n_steps = 0
        self.breaches = 0
        self.max_step_s = 0.0
        self.last_step_s = 0.0
        self.last_label = ""
