"""MCFuser public API: tune once, get a fused callable.

    from repro_torch.core import api
    tk = api.fuse_gemm_chain(M=512, N=256, K=64, H=64)
    e = tk(a, b, d)                           # a: (B, M, K)
    tk = api.fuse_attention(M=512, N=512, K=64, H=64, heads=12)
    o = tk(q, k, v)                           # q: (B, Hq, M, K)
    tk = api.fuse_attention_paged(1, 160, 128, 128, page_size=16,
                                  heads=32, kv_heads=8, batch=4,
                                  dtype="bfloat16")
    o = tk(q, k_pages, v_pages, page_table, lengths)
    mlp = api.fuse_mlp_chain(4, 12288, 4096, dtype="bfloat16")
    e = mlp(a, w_up, w_down, wg=w_gate)       # a: (B, M, K)

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
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

from . import codegen, pruning, schedule_cache
from .chain import (PARTIAL_ATTENTION, Chain, attention_chain, gemm_chain,
                    mlp_chain)
from .dag import build_schedule
from .perf_model import H100, GpuSpec, MeshSpec, TpuSpec, paged_gather_seconds
from .search import SearchReport, heuristic_search, rank_regimes

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


def _host_probe_due(rec: dict) -> bool:
    """True when a warm entry must be numerically probed before it is
    trusted: sentinels armed with probing on, and the record's stored
    host fingerprint differs from (or predates) the current host."""
    from ..reliability import sentinels as _sentinels
    spec = _sentinels.active()
    if spec is None or not spec.probe:
        return False
    return rec.get("host") != schedule_cache.host_fingerprint()


def _run_probe(kind: str, kernel_thunk, ref_thunk) -> bool:
    """One golden probe: canned input through the rebuilt kernel vs its
    torch twin, per-dtype tolerance.  The ``wrong_answer`` fault seam
    (``op=f"probe-{kind}"``) perturbs the kernel side so a corrupted
    replay is caught *before* traffic.  A probe that raises counts as a
    mismatch — an entry that cannot even execute must not be trusted
    either — if it is a failure the breaker may degrade from
    (``breaker.degradable``); any other failure raises."""
    from ..reliability import breaker as _breaker
    from ..reliability import sentinels as _sentinels
    spec = _sentinels.active()
    try:
        got = _sentinels.corrupt_if_armed(kernel_thunk(),
                                          op=f"probe-{kind}")
        ok = bool(_sentinels.outputs_close(got, ref_thunk()))
    except Exception as e:  # noqa: BLE001 - unexecutable entry = mismatch
        if not _breaker.degradable(e):
            raise
        ok = False
    if spec is not None:
        spec.note_probe(ok)
    return ok


def _measured(measure_fn) -> tuple:
    """The in-process key's mark of a measured-trial kernel (none for
    the analytic one, whose key stays as it was)."""
    return () if measure_fn is None else ("measured",)


def _pad_to(dim: int, tile: int) -> int:
    return int(math.ceil(dim / max(int(tile), 1)) * max(int(tile), 1))


def _probe_arrays(shapes: list[tuple], dtype: str) -> list:
    """Deterministic canned probe operands (seeded, O(0.1) magnitude),
    on the card where there is one (the kernels' device), else on the
    CPU (their plain versions)."""
    import numpy as np
    import torch
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    rs = np.random.RandomState(0)
    return [torch.from_numpy(rs.standard_normal(s) * 0.1).to(
        dev, getattr(torch, dtype)) for s in shapes]


def _tune_or_load(kind: str, chain: Chain, hw: "TpuSpec | GpuSpec",
                  mesh: Optional[MeshSpec], unit: int, seed: int,
                  disk_key: tuple, measure_fn=None, probe_fn=None):
    """(report, params, seconds, source): disk-cache hit or full search.

    A hit rebuilds the winning Schedule through ``build_schedule`` and
    re-derives the kernel params, cross-checking them against the
    stored kwargs — a corrupt or semantically stale entry falls back to
    tuning instead of dispatching a bad kernel.  The rebuilt schedule
    is then re-validated against the pruning invariants
    (``pruning.validate_schedule``: Rules 2–4 and the on-chip bound) so
    a corrupted-but-parseable record never reaches a kernel; a failing
    record is quarantined to ``.corrupt`` and retuned.

    ``measure_fn(schedule) -> seconds`` runs Algorithm 1's measured
    trials: the analytical model ranks each population and
    ``heuristic_search`` hands the top candidates to ``measure_fn``
    (on the card, a wall clock of the candidate's kernel; the package
    ships none).  Its outcome persists under the ``"measured"`` trial
    kind, the default search's under ``"analytic"``: two disk
    populations, so neither ever satisfies the other's lookup (a
    measured record holds the card's times, an analytic one the
    model's).

    ``probe_fn(params) -> bool`` is the sentinels' warm-load golden
    probe: when the sentinels are armed and the record's stored host
    fingerprint differs from the current host (another torch, card or
    platform — the replay may behave differently than where it tuned),
    the entry must pass a numeric kernel-vs-twin probe before it is
    served.  Pass → the record is re-stamped with the current host
    (probes don't repeat every load); fail → the entry is quarantined
    and retuned.
    """
    trial = "measured" if measure_fn is not None else "analytic"
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
        if ok and probe_fn is not None and _host_probe_due(rec):
            if probe_fn(params):
                # probe passed on this host: re-stamp so subsequent
                # loads skip the probe until the host changes again
                schedule_cache.store(
                    disk_key, hw, expr=rec["expr"],
                    tile_sizes=rec["tile_sizes"],
                    best_time=rec["best_time"],
                    n_measured=rec["n_measured"],
                    n_iterations=rec["n_iterations"],
                    n_candidates=rec["n_candidates"],
                    prune_stats=rec["prune_stats"],
                    history=rec["history"], params=rec["params"],
                    trial=trial)
            else:
                schedule_cache.quarantine_entry(disk_key, hw, trial)
                ok = False
        if ok:
            report = SearchReport(
                best=sched, best_time=rec["best_time"],
                n_measured=rec["n_measured"],
                n_iterations=rec["n_iterations"],
                n_candidates=rec["n_candidates"],
                prune_stats=rec["prune_stats"],
                history=rec["history"], mesh=mesh)
            return report, params, time.perf_counter() - t0, "disk"

    report = heuristic_search(chain, measure_fn=measure_fn, hw=hw,
                              mesh=mesh, unit=unit, seed=seed)
    params = codegen.params_for(kind, report.best)
    dt = time.perf_counter() - t0
    schedule_cache.store(
        disk_key, hw, expr=report.best.expr,
        tile_sizes=report.best.tile_sizes, best_time=report.best_time,
        n_measured=report.n_measured, n_iterations=report.n_iterations,
        n_candidates=report.n_candidates, prune_stats=report.prune_stats,
        history=report.history, params=params.as_kwargs(), trial=trial)
    return report, params, dt, "search"


def fuse_gemm_chain(M: int, N: int, K: int, H: int, batch: int = 1,
                    dtype: str = "float32", hw: "TpuSpec | GpuSpec" = H100,
                    mesh: Optional[MeshSpec] = None,
                    unit: Optional[int] = None,
                    seed: int = 0, measure_fn=None) -> TunedKernel:
    """Tune the 2-GEMM chain E = (A B) D and build
    ``kernels.gemm_chain.fused_gemm_chain`` — the CUDA kernel — around
    the winning schedule (class and tiles).

    (M, N, K, H, batch) are the GLOBAL problem dims; with a ``mesh`` the
    search localizes them and the kernel is parametrized for one
    shard's block.  Under ``GpuSpec`` Rule 4 prices every candidate by
    the kernel's own shared-memory layout at the n split it launches
    (the MLP machine's ``perf_model.mlp_smem_bytes``, ungated) and
    admits only the tiles it takes (``perf_model.mlp_tiles_ok``).
    ``measure_fn`` runs measured trials (``_tune_or_load``), cached
    under the ``"measured"`` trial kind."""
    unit = hw.tile_unit if unit is None else unit
    key = ("gemm", M, N, K, H, batch, dtype, hw.name, unit, mesh, seed,
           *_measured(measure_fn))
    if key in _CACHE:
        return _CACHE[key]
    chain = gemm_chain(M, N, K, H, batch=batch, dtype=dtype)
    disk_key = ("gemm", M, N, K, H, batch, dtype, hw.name, unit,
                mesh.canonical() if mesh is not None else None, seed)

    def _probe(params) -> bool:
        # warm-load golden probe (sentinels): canned input, dims padded
        # to the entry's tiles, kernel vs the unfused torch twin
        from ..kernels import ref as _ref
        from ..kernels.gemm_chain import fused_gemm_chain as _k
        kw = params.as_kwargs()
        m, n = _pad_to(M, kw.get("bm", 1)), _pad_to(N, kw.get("bn", 1))
        k2, h = _pad_to(K, kw.get("bk", 1)), _pad_to(H, kw.get("bh", 1))
        a, b, d = _probe_arrays(
            [(batch, m, k2), (batch, k2, n), (batch, n, h)], dtype)
        return _run_probe("gemm", lambda: _k(a, b, d, **kw),
                          lambda: _ref.gemm_chain_ref(a, b, d))

    report, params, dt, source = _tune_or_load(
        "gemm", chain, hw, mesh, unit, seed, disk_key, measure_fn=measure_fn,
        probe_fn=_probe if mesh is None else None)

    from ..kernels.gemm_chain import fused_gemm_chain as kernel

    fn = functools.partial(kernel, **params.as_kwargs())
    tk = TunedKernel(fn, report, params, dt, source=source)
    _CACHE[key] = tk
    return tk


def fuse_attention(M: int, N: int, K: int, H: int, heads: int = 1,
                   batch: int = 1, dtype: str = "float32",
                   causal: bool = False, window: int = 0,
                   scale: Optional[float] = None,
                   hw: "TpuSpec | GpuSpec" = H100,
                   mesh: Optional[MeshSpec] = None,
                   unit: Optional[int] = None,
                   seed: int = 0, group: int = 0,
                   measure_fn=None) -> TunedKernel:
    """Tune the attention chain for (M, N, K, H) and build
    ``kernels.attention.fused_attention`` — the CUDA kernel, queries at
    the tail of the kv sequence — around the winning (bq, bkv).

    As with ``fuse_gemm_chain``, dims are global; heads and batch fold
    into the chain batch.  Under ``GpuSpec`` Rule 4 prices every
    candidate by the kernel's shared-memory layout
    (``perf_model.attention_smem_bytes``) and admits only the tiles the
    kernel takes (``perf_model.attention_tiles_ok``).  ``group > 0``
    tunes the chain the partial kernel runs instead (the ring regime's
    per-rank kernel, GQA groups of ``group`` q heads; Rule 4 by
    ``attention_partial_smem_bytes``) and builds
    ``fused_attention_partial``, called as ``tk(q, k, v, kv_pos,
    q_pos)``; only the H100 pricing reads the difference.
    ``measure_fn`` runs measured trials, as in ``fuse_gemm_chain``."""
    unit = hw.tile_unit if unit is None else unit
    key = ("attn", M, N, K, H, heads, batch, dtype, causal, window,
           scale, hw.name, unit, mesh, seed, group, *_measured(measure_fn))
    if key in _CACHE:
        return _CACHE[key]
    chain = attention_chain(
        M, N, K, H, heads=heads, batch=batch, dtype=dtype, causal=causal,
        window=window, **(dict(name=PARTIAL_ATTENTION, group=group)
                          if group else {}))
    disk_key = ("attn", M, N, K, H, heads, batch, dtype, causal, window,
                scale, hw.name, unit,
                mesh.canonical() if mesh is not None else None, seed,
                *((("partial", group),) if group else ()))

    def _probe(params) -> bool:
        from ..kernels import ref as _ref
        from ..kernels.attention import fused_attention as _k
        kw = params.as_kwargs()
        m, n = _pad_to(M, kw.get("bq", 1)), _pad_to(N, kw.get("bkv", 1))
        q, k, v = _probe_arrays(
            [(batch, heads, m, K), (batch, heads, n, K),
             (batch, heads, n, H)], dtype)
        return _run_probe(
            "attn",
            lambda: _k(q, k, v, causal=causal, window=window, scale=scale,
                       **kw),
            lambda: _ref.gqa_attention_ref(q, k, v, causal=causal,
                                           window=window, scale=scale))

    report, params, dt, source = _tune_or_load(
        "attn", chain, hw, mesh, unit, seed, disk_key, measure_fn=measure_fn,
        probe_fn=_probe if mesh is None and not group else None)

    from ..kernels.attention import fused_attention as kernel
    if group:
        from ..kernels.attention import fused_attention_partial as kernel

    fn = functools.partial(kernel, causal=causal, window=window,
                           scale=scale, **params.as_kwargs())
    tk = TunedKernel(fn, report, params, dt, source=source)
    _CACHE[key] = tk
    return tk


def fuse_attention_paged(M: int, N: int, K: int, H: int, *,
                         page_size: int, kv_heads: int, heads: int = 1,
                         batch: int = 1,
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
    pricing symmetry and must stay True for the built kernel).  Under
    ``GpuSpec`` Rule 4 prices every candidate by the partial kernel's
    layout (``perf_model.attention_partial_smem_bytes``), whose blocks
    hold the ``heads / kv_heads`` q-heads of a GQA group; ``kv_heads``
    has no default, so that no caller prices a GQA shape as group 1.
    """
    unit = hw.tile_unit if unit is None else unit
    key = ("attn-paged", page_size, M, N, K, H, heads, kv_heads, batch,
           dtype, causal, window, scale, hw.name, unit, mesh, seed)
    if key in _CACHE:
        return _CACHE[key]
    chain = attention_chain(M, N, K, H, heads=heads, batch=batch,
                            dtype=dtype, causal=causal, window=window,
                            name=PARTIAL_ATTENTION,
                            group=heads // kv_heads)
    disk_key = ("attn-paged", page_size, M, N, K, H, heads, kv_heads, batch,
                dtype, causal, window, scale, hw.name, unit,
                mesh.canonical() if mesh is not None else None, seed)
    # no numeric probe_fn: the paged entry is still schedule-validated
    # on every warm load, and the serving engine's construction-time
    # golden probe runs the full paged decode against its twin before
    # traffic (serving/engine.py)
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


def fuse_mlp_chain(M: int, FF: int, D: int, batch: int = 1,
                   dtype: str = "float32", gated: bool = True,
                   act: str = "silu", hw: "TpuSpec | GpuSpec" = H100,
                   mesh: Optional[MeshSpec] = None,
                   unit: Optional[int] = None,
                   seed: int = 0, measure_fn=None) -> TunedKernel:
    """Tune the (gated) MLP chain E = (act(A Wg) * (A Wu)) Wd and build
    ``kernels.gemm_chain.fused_mlp_chain`` — the CUDA kernel — around
    the winning schedule: the chain ``core.planner`` carves for the
    memory-bound MLP half of a transformer block.

    (M, FF, D) are tokens, d_ff and d_model.  Under ``GpuSpec`` Rule 4
    prices every candidate by the kernel's own shared-memory layout
    (``perf_model.mlp_smem_bytes``), so the tiles always fit a block.
    Entries persist under the distinct "mlp" key prefix, so they never
    collide with other chains of the same dims.  ``measure_fn`` runs
    measured trials, as in ``fuse_gemm_chain``."""
    unit = hw.tile_unit if unit is None else unit
    key = ("mlp", M, FF, D, batch, gated, act, dtype, hw.name, unit,
           mesh, seed, *_measured(measure_fn))
    if key in _CACHE:
        return _CACHE[key]
    chain = mlp_chain(M, FF, D, batch=batch, dtype=dtype, gated=gated,
                      act=act)
    disk_key = ("mlp", M, FF, D, batch, gated, act, dtype, hw.name, unit,
                mesh.canonical() if mesh is not None else None, seed)

    def _probe(params) -> bool:
        from ..kernels import ref as _ref
        from ..kernels.gemm_chain import fused_mlp_chain as _k
        kw = params.as_kwargs()
        m, n = _pad_to(M, kw.get("bm", 1)), _pad_to(FF, kw.get("bn", 1))
        k2, h = _pad_to(D, kw.get("bk", 1)), _pad_to(D, kw.get("bh", 1))
        shapes = [(batch, m, k2), (batch, k2, n), (batch, n, h)]
        if gated:
            shapes.append((batch, k2, n))
        arrs = _probe_arrays(shapes, dtype)
        a, wu, wd = arrs[:3]
        wg = arrs[3] if gated else None
        return _run_probe(
            "mlp", lambda: _k(a, wu, wd, wg=wg, act=act, **kw),
            lambda: _ref.mlp_chain_ref(a, wu, wd, wg=wg, act=act))

    report, params, dt, source = _tune_or_load(
        "mlp", chain, hw, mesh, unit, seed, disk_key, measure_fn=measure_fn,
        probe_fn=_probe if mesh is None else None)

    from ..kernels.gemm_chain import fused_mlp_chain as kernel

    fn = functools.partial(kernel, act=act, **params.as_kwargs())
    tk = TunedKernel(fn, report, params, dt, source=source)
    _CACHE[key] = tk
    return tk


@dataclass
class RegimeChoice:
    """Outcome of the attention regime search: the parallelism regime
    the model ranks fastest for one global shape, plus every regime's
    tuned kernel (all cached)."""

    regime: str
    kernel: TunedKernel
    times: dict[str, float]            # eq (2') best_time per regime
    kernels: dict[str, TunedKernel]


def _choose(kernels: dict[str, TunedKernel]) -> RegimeChoice:
    best = rank_regimes({n: tk.report for n, tk in kernels.items()})[0]
    return RegimeChoice(
        regime=best, kernel=kernels[best],
        times={n: tk.report.best_time for n, tk in kernels.items()},
        kernels=kernels)


def fuse_attention_regimes(M: int, N: int, K: int, H: int, *,
                           heads: int = 1, batch: int = 1,
                           dtype: str = "float32", causal: bool = False,
                           window: int = 0, scale: Optional[float] = None,
                           hw: "TpuSpec | GpuSpec" = H100,
                           regimes: dict[str, Optional[MeshSpec]],
                           unit: Optional[int] = None, seed: int = 0,
                           kv_heads: Optional[int] = None) -> RegimeChoice:
    """Regime search: tune the attention chain once per candidate
    ``MeshSpec`` (``None`` = replicated single-device execution) through
    ``fuse_attention`` and return the regime eq (2') ranks fastest.
    The reported times include each regime's collective term, so the
    ring regime wins only when its localized tile time plus the
    combine beats the spatial regime's.  With a mesh no numeric probe
    runs (analytic tuning only), as in the JAX package.  List the
    collective-free regime first: ties break to it.  ``kv_heads``: a
    regime whose MeshSpec splits the kv loop runs the partial kernel
    on each rank, so it is tuned as that kernel's chain at the group
    it runs (``dist.ring_dispatch.ring_group``)."""
    if not regimes:
        raise ValueError("regime search needs at least one candidate")

    from ..dist.ring_dispatch import ring_group

    def _group(spec) -> int:
        ring = spec is not None and any(l == "n" for l, _ in spec.placement)
        return ring_group(heads, kv_heads, M) if (ring and kv_heads) else 0

    return _choose({
        name: fuse_attention(M, N, K, H, heads=heads, batch=batch,
                             dtype=dtype, causal=causal, window=window,
                             scale=scale, hw=hw, mesh=spec, unit=unit,
                             seed=seed, group=_group(spec))
        for name, spec in regimes.items()})


def fuse_attention_paged_regimes(M: int, N: int, K: int, H: int, *,
                                 page_size: int, kv_heads: int,
                                 heads: int = 1, batch: int = 1,
                                 dtype: str = "float32",
                                 window: int = 0,
                                 scale: Optional[float] = None,
                                 hw: "TpuSpec | GpuSpec" = H100,
                                 regimes: dict[str, Optional[MeshSpec]],
                                 unit: Optional[int] = None,
                                 seed: int = 0) -> RegimeChoice:
    """The paged counterpart of ``fuse_attention_regimes``: every
    candidate tuned through ``fuse_attention_paged`` (its ``best_time``
    carries its own localized paged-gather term), ranked alike.  List
    "paged-spatial" first: ties break to it."""
    if not regimes:
        raise ValueError("regime search needs at least one candidate")
    return _choose({
        name: fuse_attention_paged(M, N, K, H, page_size=page_size,
                                   kv_heads=kv_heads, heads=heads,
                                   batch=batch, dtype=dtype, causal=True,
                                   window=window, scale=scale, hw=hw,
                                   mesh=spec, unit=unit, seed=seed)
        for name, spec in regimes.items()})


def clear_cache(disk: bool = False) -> None:
    """Drop the per-process cache; ``disk=True`` also deletes the
    persistent entries under ``REPRO_TORCH_CACHE_DIR``
    (``schedule_cache.clear``)."""
    _CACHE.clear()
    if disk:
        schedule_cache.clear()
