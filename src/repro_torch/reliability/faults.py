"""Seeded, deterministic fault-injection registry.

Production seams (kernel dispatch in ``kernels/ops.py`` and the paged
attention branch of ``models/layers.py``, schedule/plan load in
``core/schedule_cache.py``, page allocation in ``serving/kv_pages.py``,
the engine step loop in ``serving/engine.py``)
call :func:`check` / :func:`fault_point` with a fault *kind*.  When a
test or the chaos bench has armed that kind via :func:`inject`, the
point fires — raising :class:`InjectedFault` — and the caller's
degradation path takes over.  With nothing armed, ``check`` is a single
dict lookup on an empty registry: the hooks cost nothing in production.

Determinism is the whole point: firing is a pure function of
``(seed, kind, call-ordinal)`` — never wall clock, never a global RNG —
so a chaos run replays bit-identically and a failing seed is a
reproducer, not an anecdote.  The firing function is the JAX package's
(``repro.reliability.faults``), unchanged, so one injection fires on the
same ordinals in both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Callable, Dict, Iterator, Optional

__all__ = [
    "FAULT_KINDS", "InjectedFault", "FaultSpec",
    "inject", "injected", "clear", "active", "armed", "check",
    "fault_point",
]

#: The fault taxonomy.  Each kind names one production seam; arming a
#: kind only affects call sites that declare it.
FAULT_KINDS = (
    # fused-kernel compile/dispatch: kernels/ops.py tails, the paged
    # decode kernel branch in models/layers.py, and engine tier 0
    "kernel_dispatch",
    # planner record load: core/schedule_cache.load_plan
    "plan_load",
    # tuned-schedule record load: core/schedule_cache.load
    "cache_corrupt",
    # KV page allocation: serving/kv_pages.PagePool.alloc
    "page_exhaustion",
    # the serving step dispatch itself (any execution tier)
    "engine_step",
    # silent corruption: a fused output is *perturbed* instead of
    # raising — only the sentinels layer (reliability/sentinels.py)
    # can observe it; crash-path degradation never sees this kind
    "wrong_answer",
)


class InjectedFault(RuntimeError):
    """Raised by :func:`fault_point` when an armed fault fires."""

    def __init__(self, kind: str, context: Optional[dict] = None):
        detail = f" {context}" if context else ""
        super().__init__(f"injected fault: {kind}{detail}")
        self.kind = kind
        self.context = dict(context or {})


@dataclasses.dataclass
class FaultSpec:
    """One armed fault.  Exactly one firing rule applies, checked in
    order: ``trigger`` (predicate over the call-site context), ``nth``
    (fire on the nth encounter, 0-based), ``rate`` (seeded hash of the
    encounter ordinal — deterministic, not a global RNG), else fire on
    every encounter.  ``limit`` caps total fires (``nth`` implies 1)."""

    kind: str
    rate: Optional[float] = None
    nth: Optional[int] = None
    trigger: Optional[Callable[[dict], bool]] = None
    seed: int = 0
    limit: Optional[int] = None
    n_seen: int = 0
    n_fired: int = 0

    def _decide(self, context: dict) -> bool:
        if self.limit is not None and self.n_fired >= self.limit:
            return False
        if self.trigger is not None:
            return bool(self.trigger(context))
        if self.nth is not None:
            return self.n_seen == self.nth
        if self.rate is None:
            return True
        blob = f"{self.seed}:{self.kind}:{self.n_seen}".encode()
        u = int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")
        return u / 2.0 ** 64 < self.rate


_REGISTRY: Dict[str, FaultSpec] = {}
_LOCK = threading.Lock()


def inject(kind: str, *, rate: Optional[float] = None,
           nth: Optional[int] = None,
           trigger: Optional[Callable[[dict], bool]] = None,
           seed: int = 0, limit: Optional[int] = None) -> FaultSpec:
    """Arm ``kind``.  Replaces any spec already armed for that kind."""
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"known: {FAULT_KINDS}")
    if rate is not None and not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    if nth is not None and limit is None:
        limit = 1
    spec = FaultSpec(kind=kind, rate=rate, nth=nth, trigger=trigger,
                     seed=seed, limit=limit)
    with _LOCK:
        _REGISTRY[kind] = spec
    return spec


def clear(kind: Optional[str] = None) -> None:
    """Disarm one kind, or everything when ``kind`` is None."""
    with _LOCK:
        if kind is None:
            _REGISTRY.clear()
        else:
            _REGISTRY.pop(kind, None)


def active() -> Dict[str, FaultSpec]:
    """Snapshot of the armed specs (for assertions on fire counts)."""
    with _LOCK:
        return dict(_REGISTRY)


def armed() -> bool:
    """True iff *any* fault kind is armed — the lock-free predicate
    per-dispatch seams use to skip context construction entirely on
    the production path."""
    return bool(_REGISTRY)


def check(kind: str, **context) -> bool:
    """True iff an armed fault of ``kind`` fires at this call.

    Every call on an armed kind advances its encounter counter, so
    ``nth=`` / ``rate=`` firing is a deterministic function of call
    order regardless of which seam observes the fault.
    """
    if not _REGISTRY:        # production fast path: nothing armed
        return False
    with _LOCK:
        spec = _REGISTRY.get(kind)
        if spec is None:
            return False
        fire = spec._decide(context)
        spec.n_seen += 1
        if fire:
            spec.n_fired += 1
        return fire


def fault_point(kind: str, **context) -> None:
    """Raise :class:`InjectedFault` iff an armed ``kind`` fires here."""
    if check(kind, **context):
        raise InjectedFault(kind, context)


@contextlib.contextmanager
def injected(kind: str, **kwargs) -> Iterator[FaultSpec]:
    """Arm ``kind`` for the duration of a ``with`` block."""
    spec = inject(kind, **kwargs)
    try:
        yield spec
    finally:
        clear(kind)
