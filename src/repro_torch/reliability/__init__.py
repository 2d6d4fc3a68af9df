"""Fault injection and graceful degradation for the served stack — the
counterpart of the JAX package's ``repro.reliability``.

* :mod:`repro_torch.reliability.faults` — seeded, deterministic fault
  injection threaded through the production seams (kernel dispatch,
  schedule/plan load, page allocation, the engine step loop, and the
  silent-corruption ``wrong_answer`` seam).
* :mod:`repro_torch.reliability.breaker` — per-fingerprint circuit
  breaker that quarantines failing schedules/plans via persistent
  denylist records (distinct from deletion; no retuning storms on
  relaunch), and the rule of which failures may be degraded from at
  all (``degradable``: an injected fault, or a launch the card
  refused without running it).
* :mod:`repro_torch.reliability.sentinels` — correctness sentinels:
  sampled shadow verification against the torch twin, golden probes
  before serving traffic, and activation health checks.
* :mod:`repro_torch.reliability.watchdog` — soft step-latency watchdog
  for the serving loop.

:mod:`repro_torch.reliability.chaos` (imported explicitly, not
re-exported here — it pulls in the serving engine) is the chaos
harness of ``tests/test_torch_reliability.py``.
"""
from .breaker import BREAKER, CircuitBreaker            # noqa: F401
from .faults import (FAULT_KINDS, FaultSpec, InjectedFault,  # noqa: F401
                     active, check, clear, fault_point, inject, injected)
from .sentinels import SentinelSpec, shadowing          # noqa: F401
from .watchdog import StepWatchdog                      # noqa: F401

__all__ = [
    "FAULT_KINDS", "FaultSpec", "InjectedFault",
    "inject", "injected", "clear", "active", "check", "fault_point",
    "CircuitBreaker", "BREAKER", "SentinelSpec", "shadowing",
    "StepWatchdog",
]
