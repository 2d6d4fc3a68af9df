"""Search-space pruning (paper §III-C, Rules 1-4), for GPU or TPU specs.

Rule 1  Deduplication: candidates sharing a per-block sub-tiling
        expression (after grid binding) and tile sizes are equivalent.
Rule 2  Intermediate-tile blow-up: schedules that must cache multiple
        partial-result tiles in VMEM (reduction loop outside the
        consumer sweep) are pruned when the blow-up is categorical,
        otherwise charged to the Rule-4 estimate.
Rule 3  Padding: tile sizes that do not divide a power-of-two dim are
        discarded; otherwise padding ratio must stay < 0.05.  Dims below
        the MXU lane width are exempt (padding is mandatory there).
Rule 4  On-chip limit (perf_model.rule4_ok): under TpuSpec the
        paper's eq. (1) VMEM residency must be <= 1.2 x VMEM; under
        GpuSpec the shared memory one thread block holds must fit the
        per-block opt-in limit, and the CUDA kernel must take the tiles
        (perf_model.kernel_tiles_ok).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

from .batch_model import ExprClassTable, class_key
from .chain import Chain
from .dag import Schedule, build_schedule
from .perf_model import (GpuSpec, H100, TpuSpec, floor_residency_bytes,
                         rule4_ok)
from .tiling import Scope, candidate_tile_sizes, enumerate_tilings


@dataclass
class PruneStats:
    n_exprs: int = 0
    n_expr_classes: int = 0
    n_total: int = 0
    n_after_dedup: int = 0
    n_invalid: int = 0
    n_rule2: int = 0
    n_rule3: int = 0
    n_rule4: int = 0
    n_kept: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def rule3_padding_ok(dim: int, tile: int, unit: int = 128,
                     max_ratio: float = 0.05) -> bool:
    if dim <= unit:
        return True  # mandatory padding, exempt
    padded = math.ceil(dim / tile) * tile
    if padded == dim:
        return True
    if dim & (dim - 1) == 0:  # power of two: exact division required
        return False
    return (padded - dim) / dim < max_ratio


def validate_schedule(sched: Schedule, hw: "TpuSpec | GpuSpec" = H100,
                      unit: int | None = None) -> tuple[bool, str]:
    """Re-check the pruning invariants on a *rebuilt* schedule.

    The warm-cache path rebuilds schedules from persisted records
    (``core/schedule_cache.py``); a record can be corrupted into
    something that still parses and rebuilds — tile sizes edited to
    absurd values, a loop dropped — and such a schedule must never
    reach a kernel.  This re-runs the
    checks the search itself enforced, so a legitimately tuned outcome
    always passes: Rule 2 via ``Schedule.valid`` (the rebuild uses
    ``hard_rule2=True``), Rule 3 via :func:`rule3_padding_ok` per loop,
    Rule 4 via the same ``hw.rule4_budget`` ``heuristic_search``
    prunes with.  (Rule 1 is a dedup, not a validity property — an
    un-deduplicated schedule is wasteful, not wrong.)

    Returns ``(ok, reason)``; ``reason`` is "" when valid.
    """
    unit = hw.tile_unit if unit is None else unit
    if not sched.valid:
        return False, sched.invalid_reason or "invalid_schedule"
    loops = sched.chain.loops
    if set(sched.tile_sizes) != set(loops):
        return False, "tile_sizes_do_not_cover_loops"
    for name, ext in loops.items():
        t = int(sched.tile_sizes[name])
        if t < 1:
            return False, f"bad_tile:{name}={t}"
        if not rule3_padding_ok(ext, t, unit):
            return False, f"rule3_padding:{name}={t}"
    if not rule4_ok(sched, hw):
        return False, "rule4_on_chip"
    return True, ""


def stitched_vmem_ok(chain: Chain, extra_bytes: int,
                     hw: "TpuSpec | GpuSpec" = H100, unit: int = 16,
                     full_loops: tuple = ()) -> bool:
    """Rule-4 extension for FusionStitching (core/planner.py).

    A stitched prologue/epilogue makes extra operand tiles resident in
    EVERY schedule of the chain — the residual-stream tile of a fused
    residual add, the cos/sin table slice of a fused rope, a norm's
    scale vector.  The stitch is only admissible if the chain's
    *smallest* legal tile residency (every loop clamped to ``unit``)
    still leaves room for those ``extra_bytes`` inside the Rule-4
    budget; otherwise no schedule at all survives with the stitch
    attached and the glue must stay standalone.  Checking the floor
    rather than a tuned schedule keeps the gate schedule-independent,
    so the planner can decide stitches before any search has run.

    The floor is priced as Rule 4 prices a schedule
    (``perf_model.floor_residency_bytes``): double-buffered VMEM under
    ``TpuSpec``, the CUDA kernel's own shared-memory layout under
    ``GpuSpec``.

    ``full_loops`` names loops the stitch forces to full extent — a
    glue op that *reduces* over a chain loop (a norm prologue over the
    contraction axis, a softmax epilogue over the score row) is only
    tile-local if that loop is swept untiled, so its floor residency
    uses the full dimension there instead of ``unit``.
    """
    tile = {l: ext if l in full_loops else min(ext, unit)
            for l, ext in chain.loops.items()}
    return (floor_residency_bytes(chain, tile, hw) + extra_bytes
            <= hw.rule4_budget)


def iter_tile_assignments(chain: Chain, unit: int = 128,
                          rule3: bool = False) -> Iterator[dict[str, int]]:
    names = list(chain.loops)
    cand = [candidate_tile_sizes(chain.loops[n], unit=unit) for n in names]
    if rule3:
        cand = [[t for t in c if rule3_padding_ok(chain.loops[n], t, unit)]
                for n, c in zip(names, cand)]
    for combo in itertools.product(*cand):
        yield dict(zip(names, combo))


def generate_candidates(chain: Chain, hw: "TpuSpec | GpuSpec" = H100,
                        unit: int | None = None,
                        hard_rule2: bool = True,
                        stats: PruneStats | None = None,
                        exprs: Iterable[Scope] | None = None,
                        ) -> list[Schedule]:
    """Enumerate, place, and prune the full candidate set (Fig. 7 flow).

    Rule 3 is applied *per loop before the Cartesian product* — the raw
    space (paper: 1.09e8 for the 1024/512 GEMM chain) is never
    materialized, only counted.
    """
    unit = hw.tile_unit if unit is None else unit
    if exprs is None:
        exprs = enumerate_tilings(chain)
    exprs = list(exprs)
    if stats is None:
        stats = PruneStats()
    stats.n_exprs = len(exprs)

    n_raw_tiles = 1
    for n in chain.loops:
        n_raw_tiles *= len(candidate_tile_sizes(chain.loops[n], unit=unit))
    stats.n_total = len(exprs) * n_raw_tiles

    tiles_ok = list(iter_tile_assignments(chain, unit=unit, rule3=True))
    stats.n_rule3 = (n_raw_tiles - len(tiles_ok)) * len(exprs)

    kept: dict[tuple, Schedule] = {}
    classes: set[tuple] = set()
    for expr in exprs:
        # structure-level placement reused across tile sizes where possible
        for ts in tiles_ok:
            sched = build_schedule(chain, expr, ts, hard_rule2=hard_rule2)
            if not sched.valid:
                if sched.invalid_reason == "rule2_intermediate_blowup":
                    stats.n_rule2 += 1
                else:
                    stats.n_invalid += 1
                continue
            key = sched.key()
            classes.add(key[0])
            if key in kept:  # Rule 1
                continue
            kept[key] = sched
    stats.n_after_dedup = len(kept)
    stats.n_expr_classes = len(classes)

    final = []
    for sched in kept.values():
        if not rule4_ok(sched, hw):
            stats.n_rule4 += 1
            continue
        final.append(sched)
    stats.n_kept = len(final)
    return final


# ---------------------------------------------------------------------------
# Batched candidate generation (the tuning hot path, docs/tuning.md)
# ---------------------------------------------------------------------------

@dataclass
class PricedClass:
    """One Rule-1 expression class priced over the full tile matrix."""

    table: ExprClassTable
    multiplicity: int          # how many raw expressions share the class
    est: np.ndarray            # eq (2) estimate per tile row (no t_coll)
    vmem: np.ndarray           # Rule-4 residency per tile row
    valid: np.ndarray          # hard-Rule-2 mask per tile row
    keep: np.ndarray           # valid & Rule 4 (candidate membership)


@dataclass
class CandidateMatrix:
    """The whole pruned search space as arrays: every kept expression
    class priced against the shared Rule-3-filtered tile matrix.

    ``candidates`` lists (class_idx, row) pairs in exactly the order
    ``generate_candidates`` yields Schedule objects, so the batched
    search visits an identical space — but a ``Schedule`` is only
    materialized for candidates that get *measured* and for the final
    winner (``materialize``).
    """

    chain: Chain
    hw: "TpuSpec | GpuSpec"
    unit: int
    names: tuple[str, ...]
    cand_tiles: tuple[tuple[int, ...], ...]   # per-loop Rule-3-ok tiles
    tiles: np.ndarray                         # (A, L) cartesian product
    classes: list[PricedClass]
    candidates: list[tuple[int, int]]
    stats: PruneStats

    def __post_init__(self) -> None:
        s, rev = 1, []
        for c in reversed(self.cand_tiles):
            rev.append(s)
            s *= len(c)
        self._strides = tuple(reversed(rev))
        self._col = {n: i for i, n in enumerate(self.names)}
        self._tile_idx = tuple({t: i for i, t in enumerate(c)}
                               for c in self.cand_tiles)
        self._sorted_cols = tuple(sorted(range(len(self.names)),
                                         key=self.names.__getitem__))
        self._rows = self.tiles.tolist()   # python ints: fast row access

    # ---- row index arithmetic ----------------------------------------
    def row_with(self, row: int, loop: str, tile: int) -> int:
        """Row index after substituting one loop's tile (mutation)."""
        li = self._col[loop]
        stride = self._strides[li]
        old_idx = (row // stride) % len(self.cand_tiles[li])
        return row + (self._tile_idx[li][tile] - old_idx) * stride

    def tile_at(self, row: int, loop: str) -> int:
        return self._rows[row][self._col[loop]]

    def tile_sizes(self, row: int) -> dict[str, int]:
        r = self._rows[row]
        return {n: r[i] for i, n in enumerate(self.names)}

    def est_of(self, cand: tuple[int, int]) -> float:
        return float(self.classes[cand[0]].est[cand[1]])

    def key(self, cand: tuple[int, int]) -> tuple:
        """``Schedule.key()`` without building the Schedule."""
        ci, row = cand
        t = self.classes[ci].table
        r = self._rows[row]
        return (t.sub_expr, frozenset(t.grid),
                tuple((self.names[c], r[c]) for c in self._sorted_cols))

    def materialize(self, cand: tuple[int, int]) -> Schedule:
        ci, row = cand
        return build_schedule(self.chain, self.classes[ci].table.expr,
                              self.tile_sizes(row), hard_rule2=True)


# Priced candidate matrices are pure functions of (chain, hw, unit);
# serving re-tunes the same layer shapes over and over (per seed, per
# mesh regime with identical localization), so memoize a handful.
_MATRIX_CACHE: dict[tuple, CandidateMatrix] = {}
_MATRIX_CACHE_MAX = 64


def generate_candidates_batch(chain: Chain, hw: "TpuSpec | GpuSpec" = H100,
                              unit: int | None = None,
                              stats: PruneStats | None = None,
                              exprs: Iterable[Scope] | None = None,
                              ) -> CandidateMatrix:
    """Array-based ``generate_candidates``: identical candidate set,
    identical ``PruneStats``, no per-candidate ``build_schedule``.

    Rules become array ops: Rule 3 filters per-loop tile lists before
    the cartesian product, Rule 1 keeps the first expression per
    (sub-expression, grid) class (all tile rows of equal-class
    expressions collide pairwise), Rule 2 and Rule 4 are boolean masks
    from ``batch_model``.  Placement runs once per class (a handful of
    ``build_schedule`` calls on a reference assignment) instead of once
    per candidate.

    Results are memoized on ``Chain.signature()`` (default ``exprs``
    only): the matrix is immutable from the search's point of view, so
    repeated tuning of the same chain — different seeds, mesh regimes
    with identical localization, benchmark repetitions — skips straight
    to the evolutionary loop.
    """
    unit = hw.tile_unit if unit is None else unit
    memo_key = None
    if exprs is None:
        memo_key = (chain.signature(), hw, unit)
        hit = _MATRIX_CACHE.get(memo_key)
        if hit is not None:
            if stats is not None:
                stats.__dict__.update(hit.stats.as_dict())
            return hit
        exprs = enumerate_tilings(chain)
    exprs = list(exprs)
    if stats is None:
        stats = PruneStats()
    stats.n_exprs = len(exprs)

    names = tuple(chain.loops)
    n_raw_tiles = 1
    for n in names:
        n_raw_tiles *= len(candidate_tile_sizes(chain.loops[n], unit=unit))
    stats.n_total = len(exprs) * n_raw_tiles

    cand_tiles = tuple(
        tuple(t for t in candidate_tile_sizes(chain.loops[n], unit=unit)
              if rule3_padding_ok(chain.loops[n], t, unit))
        for n in names)
    tiles = np.asarray(list(itertools.product(*cand_tiles)),
                       dtype=np.int64).reshape(-1, len(names))
    stats.n_rule3 = (n_raw_tiles - tiles.shape[0]) * len(exprs)

    budget = hw.rule4_budget
    by_class: dict[tuple, int] = {}
    classes: list[PricedClass] = []
    candidates: list[tuple[int, int]] = []
    for expr in exprs:
        ck = class_key(chain, expr)
        if ck in by_class:
            # Rule 1: every tile row of this expression collides with
            # the first-seen expression of its class
            pc = classes[by_class[ck]]
            pc.multiplicity += 1
            stats.n_rule2 += int((~pc.valid).sum())
            continue
        table = ExprClassTable.build(chain, expr, unit=unit)
        priced = table.price(tiles, hw)
        est, vmem, valid = priced.est, priced.vmem, priced.valid
        keep = valid & priced.tiles_ok & (vmem <= budget)
        pc = PricedClass(table=table, multiplicity=1, est=est,
                         vmem=vmem, valid=valid, keep=keep)
        by_class[ck] = len(classes)
        classes.append(pc)
        stats.n_rule2 += int((~valid).sum())
        ci = len(classes) - 1
        for row in np.flatnonzero(valid):
            if keep[row]:
                candidates.append((ci, int(row)))
            else:
                stats.n_rule4 += 1
    stats.n_after_dedup = sum(int(pc.valid.sum()) for pc in classes)
    stats.n_expr_classes = sum(1 for pc in classes if pc.valid.any())
    stats.n_kept = len(candidates)
    cm = CandidateMatrix(chain=chain, hw=hw, unit=unit, names=names,
                         cand_tiles=cand_tiles, tiles=tiles,
                         classes=classes, candidates=candidates,
                         stats=stats)
    if memo_key is not None:
        if len(_MATRIX_CACHE) >= _MATRIX_CACHE_MAX:
            _MATRIX_CACHE.pop(next(iter(_MATRIX_CACHE)))
        _MATRIX_CACHE[memo_key] = cm
    return cm


def expression_classes(chain: Chain, hard_rule2: bool = False,
                       hw: "TpuSpec | GpuSpec" = H100) -> dict[str, Scope]:
    """Distinct per-block sub-tiling expressions (Rule-1 classes) of
    ``chain`` at a reference tile assignment — each dim tiled by the
    descriptor's unit (the MXU's 128 under ``TpuSpec``, as the JAX
    package's; a tensor core's 16 under ``GpuSpec``) or whole where
    smaller — for reporting and tests (paper Fig. 7)."""
    ref_tiles = {n: max(1, min(hw.tile_unit, d))
                 for n, d in chain.loops.items()}
    out: dict[str, Scope] = {}
    for expr in enumerate_tilings(chain):
        sched = build_schedule(chain, expr, ref_tiles, hard_rule2=hard_rule2)
        if sched.valid:
            out.setdefault(sched.sub_expr(), expr)
    return out
