"""Correctness sentinels: online detection of silently wrong answers.

The crash-path reliability layer (``faults.py`` / ``breaker.py`` /
the tiered engine executor) only reacts when something *raises*.  A
kernel that computes the wrong numbers, or a schedule replayed on a
card it was not tuned for, serves wrong tokens with no exception — and
the breaker never trips.  This module turns "wrong answer" into a
detectable, quarantinable event using the one asset every fused unit
of the port has: an unfused torch twin computing the same function.

Three detectors, all feeding the per-fingerprint breaker:

* **sampled shadow verification** — :func:`shadow_kernel` re-runs the
  twin on ~1/N of guarded dispatches (a seeded sha256 draw over the
  dispatch ordinal, the design of ``faults.FaultSpec``) and compares
  within per-dtype tolerance; a mismatch records a breaker failure
  against the fingerprint, so the entry is quarantined on disk and the
  *current* call already returns the twin's output.
* **golden probes** — the serving engine runs one canned input through
  its configured tier and its twin before serving traffic, and
  ``core.api`` probes a warm cache entry whose stored host fingerprint
  differs from the current host before trusting it
  (``schedule_cache.host_fingerprint``).
* **activation health** — :func:`healthy` is a NaN/Inf/magnitude check
  the engine applies to step logits under ``Runtime(sentinels=True)``;
  an unhealthy slot is evicted with the honest outcome ``"health"``.

Sampling determinism mirrors ``faults.py``: whether dispatch ordinal
``i`` is shadow-verified is a pure function of ``(seed, i)``, the JAX
package's draw (``repro.reliability.sentinels``) unchanged.  Nothing
here is armed by default: :func:`active` returns ``None`` and every
hook is a cheap early-out until :func:`enable` (or :func:`shadowing`)
arms a :class:`SentinelSpec`.

A comparison needs one host sync, which a CUDA graph capture and its
eager warm-up forbid (``kernels.capture``); the kernel seams skip there,
as the JAX package's skip while tracing, and the engine-level sentinel
covers captured steps.

The matching fault class is ``faults.inject("wrong_answer", ...)``:
instead of raising, it *perturbs* a fused output at the guarded seams
(:func:`corrupt_if_armed`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Callable, Iterator, Optional

import torch

from . import faults as _faults

__all__ = [
    "SentinelSpec", "DEFAULT_RATE", "HEALTH_MAX_ABS", "TOLERANCES",
    "enable", "disable", "active", "shadowing",
    "corrupt_if_armed", "shadow_kernel", "outputs_close",
    "outputs_equal", "healthy",
]

#: Default shadow-verification sampling rate: ~1 in 64 dispatches.
DEFAULT_RATE = 1.0 / 64

#: Activation-health bound: any |logit| at or past this is an
#: explosion (qk-norm'd smoke configs peak around |logit| ~ 1e1).
HEALTH_MAX_ABS = 1e4

#: Per-dtype (rtol, atol) for kernel-vs-twin comparison.  f32 gets a
#: small tolerance because a fused kernel's accumulation order differs
#: from the twin's; a caller whose configured path runs the twin's own
#: ops compares bitwise instead (``outputs_equal``).
TOLERANCES = {
    "float64": (1e-12, 1e-12),
    "float32": (1e-5, 1e-6),
    "bfloat16": (2e-2, 2e-2),
    "float16": (2e-3, 2e-3),
}


#: Ordinals per precomputed draw block: :meth:`SentinelSpec.sample`
#: sits on every guarded dispatch, so its hot path must be an integer
#: increment plus a set lookup — the sha256 drawing work runs once per
#: ``_BLOCK`` ordinals (and for block 0 at construction, off the
#: serving path), producing bit-identical draws to hashing per call.
_BLOCK = 512


@dataclasses.dataclass
class SentinelSpec:
    """One armed sentinel configuration plus its observability counters.

    ``rate`` is the shadow-sampling probability; dispatch ordinal
    ``n_seen`` is verified iff ``sha256(f"{seed}:shadow:{n_seen}")``
    maps below ``rate``.  ``probe=False`` disarms the construction and
    warm-load golden probes while keeping shadow sampling."""

    rate: float = DEFAULT_RATE
    seed: int = 0
    probe: bool = True
    n_seen: int = 0           # dispatches observed at shadow seams
    n_checked: int = 0        # dispatches actually shadow-verified
    n_mismatched: int = 0     # shadow comparisons that diverged
    n_probed: int = 0         # golden probes run (engine + warm-load)
    n_probe_mismatched: int = 0
    _block: int = dataclasses.field(default=-1, repr=False,
                                    compare=False)
    _draws: frozenset = dataclasses.field(default=frozenset(),
                                          repr=False, compare=False)

    def __post_init__(self) -> None:
        if 0.0 < self.rate < 1.0:
            self._block, self._draws = 0, self._draws_for(0)

    def _draws_for(self, block: int) -> frozenset:
        lo = block * _BLOCK
        draws = set()
        for n in range(lo, lo + _BLOCK):
            blob = f"{self.seed}:shadow:{n}".encode()
            u = int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")
            if u / 2.0 ** 64 < self.rate:
                draws.add(n)
        return frozenset(draws)

    def note_check(self, ok: bool) -> None:
        """Count one shadow comparison and its outcome (engine seam —
        the kernel seam counts inside :func:`shadow_kernel`)."""
        with _LOCK:
            self.n_checked += 1
            if not ok:
                self.n_mismatched += 1

    def note_probe(self, ok: bool) -> None:
        """Count one golden probe and its outcome."""
        with _LOCK:
            self.n_probed += 1
            if not ok:
                self.n_probe_mismatched += 1

    def sample(self) -> bool:
        """Advance the dispatch ordinal; True iff this one is verified."""
        with _LOCK:
            n = self.n_seen
            self.n_seen += 1
            if self.rate >= 1.0:
                return True
            if self.rate <= 0.0:
                return False
            block = n // _BLOCK
            if block != self._block:
                self._block = block
                self._draws = self._draws_for(block)
            return n in self._draws


_SPEC: Optional[SentinelSpec] = None
_LOCK = threading.Lock()


def enable(rate: float = DEFAULT_RATE, *, seed: int = 0,
           probe: bool = True) -> SentinelSpec:
    """Arm the sentinels process-wide; replaces any armed spec."""
    global _SPEC
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    spec = SentinelSpec(rate=rate, seed=seed, probe=probe)
    with _LOCK:
        _SPEC = spec
    return spec


def disable() -> None:
    global _SPEC
    with _LOCK:
        _SPEC = None


def active() -> Optional[SentinelSpec]:
    return _SPEC


@contextlib.contextmanager
def shadowing(rate: float = DEFAULT_RATE, *, seed: int = 0,
              probe: bool = True) -> Iterator[SentinelSpec]:
    """Arm the sentinels for the duration of a ``with`` block."""
    spec = enable(rate, seed=seed, probe=probe)
    try:
        yield spec
    finally:
        disable()


# ---------------------------------------------------------------------
# silent-corruption fault seam
# ---------------------------------------------------------------------

def _corrupt(out: torch.Tensor) -> torch.Tensor:
    """Shape/dtype-preserving perturbation of a floating output.

    A one-slot roll along the last axis changes the argmax of a logits
    row and the values of an activation row — the corruption a
    crashing fault cannot model.  A device op, so armed inside a
    capture it is recorded into the graph, which is what a miscompiled
    kernel does.
    """
    return torch.roll(out, 1, dims=-1) if out.is_floating_point() else out


def corrupt_if_armed(out: torch.Tensor, *, op: str) -> torch.Tensor:
    """The ``wrong_answer`` fault seam: perturb ``out`` iff armed+fired.

    Free when the fault registry is empty (``faults.check`` fast path).
    """
    if _faults.check("wrong_answer", op=op):
        return _corrupt(out)
    return out


# ---------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------

def _sync_forbidden(out: torch.Tensor) -> bool:
    """True inside a CUDA graph capture or its warm-up (which runs under
    ``set_sync_debug_mode("error")``): a comparison's host sync would
    break the capture or raise there."""
    return out.is_cuda and (torch.cuda.is_current_stream_capturing()
                            or torch.cuda.get_sync_debug_mode() == 2)


def _equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bitwise equality, NaN equal to NaN; one host sync."""
    same = got == want
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    return bool(same.all())


def outputs_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Per-dtype comparison of two outputs (``TOLERANCES``), reduced on
    the device with one host sync; shape and dtype mismatches are
    decided from metadata."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return _equal(got, want)
    rtol, atol = TOLERANCES.get(str(got.dtype).replace("torch.", ""),
                                (1e-5, 1e-6))
    return bool(torch.isclose(got.double(), want.double(), rtol=rtol,
                              atol=atol, equal_nan=True).all())


def outputs_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bitwise equality, reduced on the device (one scalar sync).

    The engine's shadow comparison wherever its configured tier runs
    the twin's own ops: the contract there is bit-identity.
    """
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    return _equal(got, want)


def shadow_kernel(fingerprint: tuple, out: torch.Tensor,
                  ref_fn: Callable[[], torch.Tensor],
                  rows: Optional[Callable[[], torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Sampled shadow verification for a guarded fused dispatch.

    Called by the kernel tails (``kernels/ops.py::_guarded``) and the
    fused paged-attention branch (``models/layers.py``) with the fused
    output and a thunk for the twin.  Early-outs: sentinels not armed,
    a capture or its warm-up (no host sync allowed there), or the
    seeded sampler skipping this ordinal.  On mismatch the fingerprint
    takes a breaker failure (quarantined on disk like a crash would be)
    and the twin's output is returned — the caller serves the correct
    value on the very dispatch that detected the corruption.  ``rows``,
    a thunk of a boolean mask over the output's first axis, limits the
    comparison to the rows the caller reads: the paged decode kernel's
    row of an inactive slot is zeros where the twin's is the mean of v.
    """
    spec = _SPEC
    if spec is None or _sync_forbidden(out):
        return out
    if not spec.sample():
        return out
    with _LOCK:
        spec.n_checked += 1
    ref = ref_fn()
    read = rows() if rows is not None else slice(None)
    if outputs_close(out[read], ref[read]):
        return out
    with _LOCK:
        spec.n_mismatched += 1
    from . import breaker as _breaker
    _breaker.record_failure(
        fingerprint,
        reason="shadow mismatch: fused output diverged from the torch "
               "twin")
    return ref


# ---------------------------------------------------------------------
# activation health
# ---------------------------------------------------------------------

def healthy(logits: torch.Tensor,
            max_abs: float = HEALTH_MAX_ABS) -> torch.Tensor:
    """Per-row activation health: finite and below the explosion bound.

    ``logits`` is ``(..., vocab)``; returns a boolean tensor over the
    leading dims, on the logits' device (no host sync, so a captured
    step can compute it).
    """
    finite = torch.isfinite(logits).all(dim=-1)
    bounded = logits.abs().amax(dim=-1) < max_abs
    return finite & bounded
