"""Chaos harness: serve a ragged workload under one injected fault
class and show the tokens do not change.

Used by ``tests/test_torch_reliability.py``.  One :func:`run_chaos` call
runs three phases over the same model, params and workload:

1. **baseline** — fault-free engine run (also warms the schedule/plan
   disk cache, so the faulted phase has real records to corrupt);
2. **faulted** — a fresh engine constructed and run with the fault
   class armed (arming spans construction: plan pre-carve and regime
   pricing are production load paths too);
3. **relaunch** — faults cleared, a fresh engine replays from the
   (possibly repaired) cache — skipping anything the circuit breaker
   quarantined, without a retuning storm.

The invariant asserted downstream: every phase serves the same token
streams (f32 config, stitching off, no kernel — the degraded twin is
bit-identical by construction); faults only move *which program*
computes them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np

from ..configs import get_config
from ..models.lm import LM, Runtime
from ..serving.engine import ServingEngine
from . import breaker as _breaker
from . import faults as _faults
from . import sentinels as _sentinels

#: Engine geometry: small enough for a CPU test, ragged enough to
#: exercise growth and eviction.
DEFAULT_ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=32,
                         max_pages_per_seq=8, choose_regime=False)

#: Generation lengths of the ragged workload (finish order != submit
#: order, so slots churn).
RAGGED_GENS = (3, 9, 1, 6, 12, 2)


def ragged_workload(cfg, seed: int = 0,
                    gens=RAGGED_GENS) -> list:
    """[(prompt, max_new)] with ragged prompt and generation lengths —
    the JAX package's draws, so both packages serve the same prompts."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.vocab,
                         size=int(rng.randint(3, 14))).astype(np.int32),
             int(g)) for g in gens]


def tokens_by_rid(results) -> dict:
    return {r.rid: list(r.tokens) for r in results}


@dataclasses.dataclass
class ChaosOutcome:
    kind: str
    fired: int                  # how many times the armed fault fired
    baseline: dict              # rid -> tokens, fault-free
    faulted: dict               # rid -> tokens, fault armed
    relaunch: dict              # rid -> tokens, fresh engine after
    faulted_stats: dict
    relaunch_stats: dict
    faulted_engine: ServingEngine
    relaunch_engine: ServingEngine

    @property
    def tokens_identical(self) -> bool:
        return self.baseline == self.faulted == self.relaunch


def run_chaos(kind: str, inject_kw: Optional[dict] = None, *,
              planner: bool = False, choose_regime: bool = False,
              engine_kw: Optional[dict] = None,
              watchdog_s: Optional[float] = None,
              arch: str = "qwen3_8b", workload_seed: int = 0,
              outcomes_ok=("complete",),
              sentinel_rate: Optional[float] = None,
              sentinel_seed: int = 0, device="cuda",
              params: Optional[dict] = None) -> ChaosOutcome:
    """Serve the ragged workload of ``arch`` (SMOKE) under one armed
    fault class.

    planner: serve planner-carved blocks (``Runtime(planner=True,
    stitch=False)``) so plan-load and plan-fingerprint quarantine paths
    are live.  choose_regime: tune the paged attention at construction
    (the production default), putting a schedule load on the
    construction path — the seam the ``cache_corrupt`` class targets.

    sentinel_rate: arm the correctness sentinels
    (``sentinels.shadowing``) around ALL THREE phases at this shadow
    sampling rate — required for the ``wrong_answer`` class, whose
    corruption never raises.  The baseline runs with sentinels armed
    too, so a sentinel-induced behaviour difference would break the
    token-identity invariant.

    device: where the model runs (the card unless the caller asks for
    the CPU); params: the weights (default: ``init_params(0)``).

    Raises AssertionError when any phase fails to complete every
    request with an outcome in ``outcomes_ok``.
    """
    cfg = get_config(arch, smoke=True)
    rt = Runtime(planner=True, stitch=False) if planner else Runtime()
    model = LM(cfg, rt, device=device)
    params = model.init_params(0) if params is None else params
    reqs = ragged_workload(cfg, workload_seed)
    kw = dict(DEFAULT_ENGINE_KW, **(engine_kw or {}))
    kw["choose_regime"] = choose_regime
    if watchdog_s is not None:
        kw["watchdog_s"] = watchdog_s

    def _serve():
        # fresh-process semantics for every phase: in-process plan
        # memo, tuned-kernel cache and breaker state dropped — only
        # the DISK cache (entries + denylist records) carries over, so
        # construction re-loads records exactly like a relaunch would.
        # Sentinels (when requested) re-arm per phase with the same
        # seed, so each phase samples the same dispatch ordinals.
        from ..core import api
        from ..core import planner as planner_mod
        planner_mod.clear_memo()
        api.clear_cache()
        _breaker.reset()
        sentry = (_sentinels.shadowing(sentinel_rate,
                                       seed=sentinel_seed)
                  if sentinel_rate is not None
                  else contextlib.nullcontext())
        with sentry:
            eng = ServingEngine(model, params, **kw)
            res, stats = eng.run(list(reqs))
        bad = [r for r in res if r.outcome not in outcomes_ok]
        assert not bad, f"requests failed under {kind}: {bad}"
        assert len(res) == len(reqs)
        return eng, tokens_by_rid(res), stats

    _faults.clear()
    _, baseline, _ = _serve()

    with _faults.injected(kind, **(inject_kw or {"nth": 0})) as spec:
        f_eng, faulted, f_stats = _serve()
        fired = spec.n_fired

    r_eng, relaunch, r_stats = _serve()

    return ChaosOutcome(kind, fired, baseline, faulted, relaunch,
                        f_stats, r_stats, f_eng, r_eng)
