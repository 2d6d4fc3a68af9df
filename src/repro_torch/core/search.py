"""Heuristic exploration (paper §IV-B, Algorithm 1).

Evolutionary search in which the *analytical* model (perf_model) ranks
the population and only the top-n candidates are actually measured;
mutation draws parents weighted by estimated speed; the loop terminates
automatically once the best measured time stops improving by more than
epsilon (no hand-set trial count — the paper's second enhancement over
Ansor).

`measure_fn` is pluggable:
  * on the card: wall-clock the compiled fused kernel;
  * anywhere: the analytical model itself ("analytic", default).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .chain import Chain
from .dag import Schedule, build_schedule
from .perf_model import (GpuSpec, H100, MeshSpec, TpuSpec, collective_bytes,
                         estimate, rule4_ok, t_coll_pipelined)
from .pruning import (CandidateMatrix, PruneStats, generate_candidates,
                      generate_candidates_batch, rule3_padding_ok)
from .tiling import candidate_tile_sizes


MeasureFn = Callable[[Schedule], float]


@dataclass
class SearchReport:
    best: Schedule
    best_time: float
    n_measured: int
    n_iterations: int
    n_candidates: int
    prune_stats: dict
    history: list[tuple[int, float]] = field(default_factory=list)
    mesh: Optional[MeshSpec] = None   # regime the schedule was tuned for


def rank_regimes(reports: dict[str, "SearchReport"]) -> list[str]:
    """Regime names cheapest-first by eq (2') ``best_time``.

    ``best_time`` already folds the collective term in (see
    ``heuristic_search``: it is kept out of the intra-regime search
    dynamics and added once to the report), so ranking reports tuned
    under different ``MeshSpec`` regimes compares like with like —
    per-shard tile time plus whatever each regime pays on the wire.
    ``sorted`` is stable, so ties break to the caller's insertion
    order; callers list the collective-free regime first to make the
    tie-break conservative, then the serial combine before its
    pipelined variant (``ring`` before ``ring-pipelined``) so equal
    pricing keeps the single-collective dispatch.
    """
    return sorted(reports, key=lambda name: reports[name].best_time)


def _mutate(sched: Schedule, chain: Chain, rng: random.Random,
            unit: int, hw: "TpuSpec | GpuSpec") -> Optional[Schedule]:
    """Mutate one loop's tile size (Algorithm 1 line 17)."""
    loops = list(chain.loops)
    for _ in range(8):
        l = rng.choice(loops)
        cands = candidate_tile_sizes(chain.loops[l], unit=unit)
        if len(cands) <= 1:
            continue
        new = rng.choice(cands)
        if new == sched.tile_sizes[l]:
            continue
        if not rule3_padding_ok(chain.loops[l], new, unit):
            continue
        ts = dict(sched.tile_sizes)
        ts[l] = new
        cand = build_schedule(chain, sched.expr, ts, hard_rule2=True)
        if not cand.valid:
            continue
        if not rule4_ok(cand, hw):
            continue
        return cand
    return None


def heuristic_search(chain: Chain,
                     measure_fn: Optional[MeasureFn] = None,
                     hw: "TpuSpec | GpuSpec" = H100,
                     mesh: Optional[MeshSpec] = None,
                     population_size: int = 128,   # N
                     topk: int = 8,                # n (paper: 8)
                     epsilon: float = 0.01,        # convergence criterion
                     max_iterations: int = 32,     # safety net only
                     unit: Optional[int] = None,
                     seed: int = 0,
                     engine: str = "batch") -> SearchReport:
    """Algorithm 1.  Returns the best schedule + tuning telemetry.

    With a ``mesh``, the search runs over the *localized* chain — each
    shard's sub-problem — so the picked tile sizes are per parallelism
    regime and directly parametrize the per-shard kernel that
    ``kernels.ops`` dispatches through shard_map.  The collective term
    of eq (2') depends only on (chain, mesh), not the tile sizes, so it
    stays OUT of the intra-regime search dynamics (ranking, parent
    weights, the epsilon convergence band — a large constant would
    drown the signal in all three) and is added once to the reported
    best_time/history, keeping regime-vs-regime comparisons on eq (2').

    ``engine`` picks the implementation: ``"batch"`` (default) runs the
    identical algorithm over ``pruning.CandidateMatrix`` array tables —
    same rng stream, same candidate ordering, bit-identical estimates,
    so it returns the same best schedule — materializing ``Schedule``
    objects only for measured candidates and the winner.  ``"scalar"``
    is the per-Schedule reference implementation (docs/tuning.md).
    """
    if engine not in ("batch", "scalar"):
        raise ValueError(f"unknown search engine {engine!r}")
    unit = hw.tile_unit if unit is None else unit
    # The collective term stays OUT of the intra-regime dynamics (see
    # above); ``coll_of(tile_s)`` prices it at return time.  Serial is
    # tile-independent (a constant); the pipelined ring's overlap term
    # needs the winning tile time (hop_compute = tile_s / n), so it is
    # a function of the best time rather than a precomputed constant.
    coll_of = lambda tile_s: 0.0  # noqa: E731
    if mesh is not None:
        chain = mesh.localize(chain)
        if mesh.pipelined:
            local = chain
            coll_of = lambda tile_s: t_coll_pipelined(  # noqa: E731
                local, mesh, tile_s)
        else:
            coll_s = collective_bytes(chain, mesh) / mesh.ici_bw
            coll_of = lambda tile_s: coll_s  # noqa: E731
    if engine == "batch":
        return _search_batch(chain, measure_fn, hw, mesh, coll_of,
                             population_size, topk, epsilon,
                             max_iterations, unit, seed)
    rng = random.Random(seed)
    stats = PruneStats()
    candidates = generate_candidates(chain, hw=hw, unit=unit, stats=stats)
    if not candidates:
        raise ValueError(f"no viable schedule for chain {chain.name}")
    if measure_fn is None:
        measure_fn = lambda s: estimate(s, hw)  # noqa: E731

    population = (candidates if len(candidates) <= population_size
                  else rng.sample(candidates, population_size))

    best_t = math.inf
    best: Optional[Schedule] = None
    measured_cache: dict[tuple, float] = {}
    n_measured = 0
    history: list[tuple[int, float]] = []

    for it in range(max_iterations):
        est = [(estimate(s, hw), s) for s in population]
        est.sort(key=lambda p: p[0])
        top = [s for _, s in est[:topk]]

        top1_t, top1 = math.inf, None
        for s in top:
            k = s.key()
            if k not in measured_cache:
                measured_cache[k] = measure_fn(s)
                n_measured += 1
            if measured_cache[k] < top1_t:
                top1_t, top1 = measured_cache[k], s
        history.append((it, min(top1_t, best_t)))

        if best is not None and top1_t >= best_t * (1 - epsilon):
            if top1_t < best_t:
                best_t, best = top1_t, top1
            break  # converged (lines 10-12)
        if top1_t < best_t:
            best_t, best = top1_t, top1

        # next population: draw parents weighted by estimated speed
        weights = [1.0 / max(e, 1e-12) for e, _ in est]
        parents = rng.choices([s for _, s in est], weights=weights,
                              k=population_size)
        nxt: list[Schedule] = []
        seen: set[tuple] = set()
        for p in parents:
            child = _mutate(p, chain, rng, unit, hw) or p
            k = child.key()
            if k not in seen:
                seen.add(k)
                nxt.append(child)
        # keep elites so the best never regresses
        for s in top:
            if s.key() not in seen:
                nxt.append(s)
                seen.add(s.key())
        population = nxt

    assert best is not None
    return SearchReport(best=best, best_time=best_t + coll_of(best_t),
                        n_measured=n_measured,
                        n_iterations=it + 1, n_candidates=stats.n_kept,
                        prune_stats=stats.as_dict(),
                        history=[(i, t + coll_of(t))
                                 for i, t in history],
                        mesh=mesh)


# ---------------------------------------------------------------------------
# Batched engine: Algorithm 1 over array tables
# ---------------------------------------------------------------------------

def _mutate_batch(cand: tuple[int, int], cm: CandidateMatrix,
                  chain: Chain, rng: random.Random, unit: int,
                  hw: "TpuSpec | GpuSpec", loops: list[str],
                  tile_cands: dict[str, list[int]],
                  rule3_ok: dict[str, set[int]]
                  ) -> Optional[tuple[int, int]]:
    """``_mutate`` on matrix coordinates: identical rng draws and
    identical accept/reject checks (Rule 3, hard Rule 2, Rule 4), but
    both rules come from the pre-priced class tables (``keep``) instead
    of a fresh ``build_schedule``.  ``tile_cands``/``rule3_ok`` are
    memoized per search call (they depend only on the chain)."""
    ci, row = cand
    cls = cm.classes[ci]
    for _ in range(8):
        l = rng.choice(loops)
        cands = tile_cands[l]
        if len(cands) <= 1:
            continue
        new = rng.choice(cands)
        if new == cm.tile_at(row, l):
            continue
        if new not in rule3_ok[l]:
            continue
        row2 = cm.row_with(row, l, new)
        if not cls.keep[row2]:
            continue
        return (ci, row2)
    return None


def _search_batch(chain: Chain, measure_fn: Optional[MeasureFn],
                  hw: "TpuSpec | GpuSpec", mesh: Optional[MeshSpec],
                  coll_of: Callable[[float], float],
                  population_size: int, topk: int, epsilon: float,
                  max_iterations: int, unit: int,
                  seed: int) -> SearchReport:
    """Algorithm 1 with candidates as (class, tile-row) coordinates.

    Every rng call, ordering decision, and float comparison mirrors the
    scalar engine (stable sorts on bit-identical estimates, same
    mutation draw sequence), so both engines converge to the same
    ``Schedule.key()`` — the scalar path stays the testable reference
    while this one is the fast path.
    """
    rng = random.Random(seed)
    stats = PruneStats()
    cm = generate_candidates_batch(chain, hw=hw, unit=unit, stats=stats)
    candidates = cm.candidates
    if not candidates:
        raise ValueError(f"no viable schedule for chain {chain.name}")

    population = (candidates if len(candidates) <= population_size
                  else rng.sample(candidates, population_size))

    loops = list(chain.loops)
    tile_cands = {l: candidate_tile_sizes(chain.loops[l], unit=unit)
                  for l in loops}
    rule3_ok = {l: {t for t in tile_cands[l]
                    if rule3_padding_ok(chain.loops[l], t, unit)}
                for l in loops}

    best_t = math.inf
    best: Optional[tuple[int, int]] = None
    measured_cache: dict[tuple, float] = {}
    materialized: dict[tuple, Schedule] = {}
    n_measured = 0
    history: list[tuple[int, float]] = []

    for it in range(max_iterations):
        est = [(cm.est_of(c), c) for c in population]
        est.sort(key=lambda p: p[0])
        top = [c for _, c in est[:topk]]

        top1_t, top1 = math.inf, None
        for c in top:
            k = cm.key(c)
            if k not in measured_cache:
                if measure_fn is None:
                    # analytic measurement: bit-identical to
                    # estimate(materialize(c), hw), already priced
                    measured_cache[k] = cm.est_of(c)
                else:
                    sched = materialized.get(k)
                    if sched is None:
                        sched = cm.materialize(c)
                        materialized[k] = sched
                    measured_cache[k] = measure_fn(sched)
                n_measured += 1
            if measured_cache[k] < top1_t:
                top1_t, top1 = measured_cache[k], c
        history.append((it, min(top1_t, best_t)))

        if best is not None and top1_t >= best_t * (1 - epsilon):
            if top1_t < best_t:
                best_t, best = top1_t, top1
            break  # converged (lines 10-12)
        if top1_t < best_t:
            best_t, best = top1_t, top1

        # next population: draw parents weighted by estimated speed
        weights = [1.0 / max(e, 1e-12) for e, _ in est]
        parents = rng.choices([c for _, c in est], weights=weights,
                              k=population_size)
        nxt: list[tuple[int, int]] = []
        seen: set[tuple] = set()
        for p in parents:
            child = _mutate_batch(p, cm, chain, rng, unit, hw, loops,
                                  tile_cands, rule3_ok) or p
            k = cm.key(child)
            if k not in seen:
                seen.add(k)
                nxt.append(child)
        # keep elites so the best never regresses
        for c in top:
            if cm.key(c) not in seen:
                nxt.append(c)
                seen.add(cm.key(c))
        population = nxt

    assert best is not None
    best_sched = materialized.get(cm.key(best)) or cm.materialize(best)
    return SearchReport(best=best_sched, best_time=best_t + coll_of(best_t),
                        n_measured=n_measured,
                        n_iterations=it + 1, n_candidates=stats.n_kept,
                        prune_stats=stats.as_dict(),
                        history=[(i, t + coll_of(t))
                                 for i, t in history],
                        mesh=mesh)
