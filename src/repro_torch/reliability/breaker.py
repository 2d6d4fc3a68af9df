"""Per-fingerprint circuit breaker over the schedule cache.

When a fused kernel or a planner-carved plan fails to dispatch, the
breaker *opens* for that fingerprint: subsequent lookups route straight
to the slower twin (the unfused torch ops) without retrying the broken
unit, and — when the schedule cache is enabled — a **denylist record**
is persisted next to the cached entry so a relaunched process skips
the fingerprint too.

Quarantine is deliberately distinct from deletion: deleting the cached
schedule would make every relaunch miss, re-tune, re-fail, and re-tune
again (a retuning storm).  The denylist record leaves the entry in
place and is consulted at *dispatch* level, so the cache itself stays
warm and the degraded path is chosen in O(1).

The default threshold is 1: schedules and plans are deterministic, so
a unit that failed to dispatch once will fail identically on replay —
there is no transient to wait out, unlike a network breaker.

Only two kinds of failure are degraded from (:func:`degradable`): an
injected fault, and a launch the card refused without running it.
Everything else — a kernel that does not build, a CUDA error that
poisons the context, a wrapper's own ``ValueError``, a bug, running out
of memory — raises through every guard: serving on the twin would hide
a broken toolchain, a broken card or a broken wrapper.
"""
from __future__ import annotations

import json
import threading

__all__ = ["CircuitBreaker", "BREAKER", "record_failure", "is_open",
           "failures", "reset", "degradable"]

DEFAULT_THRESHOLD = 1

#: ``cudaError_t`` codes of a launch the card refused before running
#: it, which leave the context usable: cudaErrorInvalidConfiguration
#: (a grid, block or shared memory size the card does not take) and
#: cudaErrorLaunchOutOfResources (too many registers or too much
#: shared memory for a tile).
USABLE_LAUNCH_ERRORS = (9, 701)


def degradable(exc: BaseException) -> bool:
    """Whether a guard may serve the twin after ``exc``: an injected
    fault, or a ``KernelLaunchError`` whose code is one of
    ``USABLE_LAUNCH_ERRORS``.  Anything else re-raises."""
    from ..kernels._build import KernelLaunchError
    from .faults import InjectedFault
    return isinstance(exc, InjectedFault) or (
        isinstance(exc, KernelLaunchError)
        and exc.code in USABLE_LAUNCH_ERRORS)


def _default_hw():
    # every record of the port is priced and keyed under the H100
    # descriptor (core/api.py); a denylist record filed under another
    # descriptor would never be looked up on the card
    from ..core.perf_model import H100
    return H100


class CircuitBreaker:
    """Counts failures per fingerprint; opens at ``threshold``.

    ``persist=True`` writes/reads denylist records through
    ``core.schedule_cache`` so open circuits survive relaunch.  Disk
    lookups are memoized per ``(cache_dir, fingerprint)`` — the serving
    hot loop may consult the breaker every step.  ``generation`` counts
    the failures recorded: a captured step compares it before each
    replay, since a graph captured before a record still runs the unit
    the record quarantined.
    """

    def __init__(self, threshold: int = DEFAULT_THRESHOLD,
                 persist: bool = True):
        self.threshold = threshold
        self.persist = persist
        self.generation = 0
        self._failures: dict = {}
        self._open: set = set()
        self._disk_memo: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _norm(key) -> str:
        items = list(key) if isinstance(key, (list, tuple)) else [key]
        return json.dumps(items, sort_keys=True, default=str)

    def record_failure(self, key, hw=None, reason: str = "") -> bool:
        """Note one failure of ``key``; returns True once open.

        Opening with ``persist`` writes the denylist record so the
        quarantine survives a relaunch.
        """
        from ..core import schedule_cache
        hw = hw or _default_hw()
        k = self._norm(key)
        with self._lock:
            n = self._failures.get(k, 0) + 1
            self._failures[k] = n
            self.generation += 1
            newly_open = n >= self.threshold and k not in self._open
            if n >= self.threshold:
                self._open.add(k)
        if newly_open and self.persist:
            schedule_cache.quarantine(key, hw, reason=reason)
            with self._lock:
                self._disk_memo[(str(schedule_cache.cache_dir()), k)] \
                    = True
        return n >= self.threshold

    def is_open(self, key, hw=None) -> bool:
        from ..core import schedule_cache
        k = self._norm(key)
        with self._lock:
            if k in self._open:
                return True
        if not self.persist:
            return False
        memo_key = (str(schedule_cache.cache_dir()), k)
        with self._lock:
            if memo_key in self._disk_memo:
                return self._disk_memo[memo_key]
        hw = hw or _default_hw()
        hit = schedule_cache.is_quarantined(key, hw) is not None
        with self._lock:
            self._disk_memo[memo_key] = hit
            if hit:
                self._open.add(k)
        return hit

    def failures(self, key) -> int:
        with self._lock:
            return self._failures.get(self._norm(key), 0)

    def reset(self) -> None:
        """Forget in-process state (denylist records stay on disk —
        use ``schedule_cache.clear_quarantine`` to lift those)."""
        with self._lock:
            self._failures.clear()
            self._open.clear()
            self._disk_memo.clear()
            self.generation += 1


#: Process-wide default instance used by the production seams.
BREAKER = CircuitBreaker()


def record_failure(key, hw=None, reason: str = "") -> bool:
    return BREAKER.record_failure(key, hw, reason=reason)


def is_open(key, hw=None) -> bool:
    return BREAKER.is_open(key, hw)


def failures(key) -> int:
    return BREAKER.failures(key)


def reset() -> None:
    BREAKER.reset()
