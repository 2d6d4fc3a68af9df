"""MCFuser public API: tune once, get a fused callable.

    from repro_torch.core import api
    tk = api.fuse_attention_paged(1, 160, 128, 128, page_size=16,
                                  heads=32, batch=4, dtype="bfloat16")
    o = tk(q, k_pages, v_pages, page_table, lengths)

Tuned schedules are cached at two levels so model code can call this
for every layer at zero cost after the first hit:

* per-process (``_CACHE``): (chain signature, hardware, mesh) ->
  TunedKernel — the paper's "tuning time" is paid once per shape;
* on disk (``core.schedule_cache``, ``REPRO_TORCH_CACHE_DIR``): the
  search *outcome* survives process restarts, so a serving relaunch
  rebuilds the kernel in milliseconds without running
  ``heuristic_search`` at all.

The disk key uses ``MeshSpec.canonical()`` rather than the raw mesh, so
two regimes that localize a chain identically share one entry.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Callable, Optional

from . import codegen, pruning, schedule_cache
from .chain import Chain, attention_chain
from .dag import build_schedule
from .perf_model import H100, GpuSpec, MeshSpec, TpuSpec, paged_gather_seconds
from .search import SearchReport, heuristic_search

_CACHE: dict[tuple, "TunedKernel"] = {}


@dataclass
class TunedKernel:
    fn: Callable
    report: SearchReport
    params: object
    tuning_seconds: float
    source: str = "search"   # "search" | "disk"

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _tune_or_load(kind: str, chain: Chain, hw: "TpuSpec | GpuSpec",
                  mesh: Optional[MeshSpec], unit: int, seed: int,
                  disk_key: tuple):
    """(report, params, seconds, source): disk-cache hit or full search.

    A hit rebuilds the winning Schedule through ``build_schedule`` and
    re-derives the kernel params, cross-checking them against the
    stored kwargs — a corrupt or semantically stale entry falls back to
    tuning instead of dispatching a bad kernel.  The rebuilt schedule
    is then re-validated against the pruning invariants
    (``pruning.validate_schedule``: Rules 2–4 and the on-chip bound) so
    a corrupted-but-parseable record never reaches a kernel; a failing
    record is quarantined to ``.corrupt`` and retuned.  Outcomes
    persist under the ``"analytic"`` trial kind (wall-clock trials on
    the card would be a separate ``"measured"`` population).
    """
    trial = "analytic"
    t0 = time.perf_counter()
    rec = schedule_cache.load(disk_key, hw, trial)
    if rec is not None:
        local = mesh.localize(chain) if mesh is not None else chain
        try:
            sched = build_schedule(local, rec["expr"], rec["tile_sizes"],
                                   hard_rule2=True)
            params = codegen.params_for(kind, sched)
            ok = sched.valid and params.as_kwargs() == rec["params"]
            if ok:
                ok, _why = pruning.validate_schedule(sched, hw, unit)
                if not ok:
                    schedule_cache.quarantine_entry(disk_key, hw, trial)
        except (AttributeError, KeyError, TypeError, ValueError):
            ok = False       # a stale or mangled entry means retune
        if ok:
            report = SearchReport(
                best=sched, best_time=rec["best_time"],
                n_measured=rec["n_measured"],
                n_iterations=rec["n_iterations"],
                n_candidates=rec["n_candidates"],
                prune_stats=rec["prune_stats"],
                history=rec["history"], mesh=mesh)
            return report, params, time.perf_counter() - t0, "disk"

    report = heuristic_search(chain, hw=hw, mesh=mesh, unit=unit,
                              seed=seed)
    params = codegen.params_for(kind, report.best)
    dt = time.perf_counter() - t0
    schedule_cache.store(
        disk_key, hw, expr=report.best.expr,
        tile_sizes=report.best.tile_sizes, best_time=report.best_time,
        n_measured=report.n_measured, n_iterations=report.n_iterations,
        n_candidates=report.n_candidates, prune_stats=report.prune_stats,
        history=report.history, params=params.as_kwargs(), trial=trial)
    return report, params, dt, "search"


def fuse_attention_paged(M: int, N: int, K: int, H: int, *,
                         page_size: int, heads: int = 1, batch: int = 1,
                         dtype: str = "float32", causal: bool = True,
                         window: int = 0, scale: Optional[float] = None,
                         hw: "TpuSpec | GpuSpec" = H100,
                         mesh: Optional[MeshSpec] = None,
                         unit: Optional[int] = None,
                         seed: int = 0) -> TunedKernel:
    """Tune the attention chain for the paged-KV serving regime and
    build ``kernels.attention.fused_attention_paged`` around the
    winning tiles.

    The tile search is the plain attention search — the paged-gather
    term is tile-independent — but both cache levels key the paged
    fingerprint ``("attn-paged", page_size)`` alongside
    ``MeshSpec.canonical()``, so a serving restart replays the regime
    decision from disk (``TunedKernel.source == "disk"``).
    ``report.best_time`` includes the paged-gather seconds
    (``perf_model.paged_gather_seconds`` on the localized chain).
    Serving attention is causal by construction (``causal`` exists for
    pricing symmetry and must stay True for the built kernel).
    """
    unit = hw.tile_unit if unit is None else unit
    key = ("attn-paged", page_size, M, N, K, H, heads, batch, dtype,
           causal, window, scale, hw.name, unit, mesh, seed)
    if key in _CACHE:
        return _CACHE[key]
    chain = attention_chain(M, N, K, H, heads=heads, batch=batch,
                            dtype=dtype, causal=causal, window=window)
    disk_key = ("attn-paged", page_size, M, N, K, H, heads, batch, dtype,
                causal, window, scale, hw.name, unit,
                mesh.canonical() if mesh is not None else None, seed)
    report, params, dt, source = _tune_or_load(
        "attn", chain, hw, mesh, unit, seed, disk_key)
    report = dataclasses.replace(
        report, best_time=report.best_time
        + paged_gather_seconds(chain, page_size, hw, mesh))

    from ..kernels.attention import fused_attention_paged as kernel

    fn = functools.partial(kernel, window=window, scale=scale,
                           **params.as_kwargs())
    tk = TunedKernel(fn, report, params, dt, source=source)
    _CACHE[key] = tk
    return tk


def clear_cache() -> None:
    """Drop the per-process cache (the disk entries stay)."""
    _CACHE.clear()
