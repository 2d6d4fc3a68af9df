"""Batched (array-based) analytical model — tuning's hot path.

``perf_model.estimate`` prices one ``Schedule`` by walking its placed
statement list; the tuner calls it thousands of times per search, and
profiling shows ``build_schedule`` + per-candidate ``estimate`` dominate
tuning wall-clock.  This module factors eqs (3)/(4)/(5') into
*per-expression-class* coefficient tables so an entire tile-assignment
matrix is priced as NumPy array math:

* Statement **placement is structural**: for a fixed tiling expression,
  which loops enclose a statement depends on the expression tree (and
  grid binding, and the Fig. 6b consumer cut) — not on the tile sizes.
  The only tile-dependent placement effect is hoisting past extent-1
  loops, and an extent-1 loop contributes a factor of exactly 1 to the
  trip count and a full-dim tile to the visit size, so it reduces to
  pure arithmetic on the extent matrix (see ``_mem_trips``).
* **Trips** (eq 3/4) become cumulative products over extent columns:
  ``extents = ceil(dim / tile)`` for the whole matrix at once.
* **Rule-2 blow-up** re-prices from the dim *sets* ``dag.build_schedule``
  records (``Schedule.cached_dim_sets``): mult = prod of extents over
  each set.
* **Rule-4** (``PricedBatch.vmem``) is the same visit/tile products
  against the load-buffer + f32-accumulator charges — or, for a chain
  a CUDA kernel runs, under ``GpuSpec``, that kernel's own
  shared-memory footprint (``perf_model.kernel_smem_bytes``), with the
  kernel's tile rule (``perf_model.kernel_tiles_ok``) beside it in
  ``PricedBatch.tiles_ok``.

Bit-compatibility contract: for any schedule, ``ExprClassTable.price``
on a 1-row tile matrix accumulates per-statement
contributions in the same order and with the same int->float conversion
points as the scalar reference (``perf_model.estimate`` /
``vmem_estimate``), so the two paths agree to the last ulp on
workload-sized chains (dims up to a few thousand; intermediate products
stay within int64 — pinned by ``tests/test_batch_model.py``).  The
scalar implementation stays the reference; this module must follow it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from .chain import Chain, DTYPE_BYTES
from .dag import bind_grid, build_schedule
from .perf_model import (GpuSpec, H100, TpuSpec, chain_tie_break,
                         kernel_smem_bytes, kernel_split_terms,
                         kernel_tiles_ok)
from .tiling import Scope, expr_repr


def reference_tiles(chain: Chain, unit: int = 128) -> dict[str, int]:
    """A tile assignment with extent > 1 wherever any candidate allows
    it (dims > unit), so the reference placement never bakes in
    *optional* dead-loop hoisting.  Dims <= unit have a single tile
    candidate (the full dim, extent always 1) and hoisting past them is
    constant across the whole matrix."""
    return {n: (unit if d > unit else d) for n, d in chain.loops.items()}


def class_key(chain: Chain, expr: Scope) -> tuple[str, frozenset]:
    """Rule-1 expression-class identity: per-block program + grid set.
    Matches the structural part of ``Schedule.key()`` (grid-axis order
    does not change the per-block program)."""
    grid, block = bind_grid(chain, expr)
    return (expr_repr(block), frozenset(grid))


@dataclass(frozen=True)
class _MemStmt:
    tensor: str
    path: tuple[str, ...]       # static (reference-hoisted) path
    dims: tuple[str, ...]
    dtype_bytes: int
    is_load: bool
    dedup_group: int            # index among loads of the same tensor


@dataclass(frozen=True)
class _CompStmt:
    tensor: str                 # produced tensor
    path: tuple[str, ...]
    related: tuple[str, ...]
    out_dims: tuple[str, ...]
    flops_per_point: int


@dataclass(frozen=True)
class ExprClassTable:
    """Structural coefficient table for one expression class."""

    chain: Chain
    expr: Scope                 # first-occurrence expression of the class
    sub_expr: str
    grid: tuple[str, ...]
    names: tuple[str, ...]      # loop column order of every tile matrix
    mem_stmts: tuple[_MemStmt, ...]      # in scalar accumulation order
    comp_stmts: tuple[_CompStmt, ...]
    stmt_order: tuple[tuple[str, int], ...]  # ("mem"|"comp", idx) in
    #   Schedule.stmts order — vmem_estimate accumulates in this order
    cached_dim_sets: tuple[tuple[str, tuple[tuple[str, ...], ...]], ...]
    # ^ (intermediate, dim sets) for the Rule-2 blow-up

    @classmethod
    def build(cls, chain: Chain, expr: Scope,
              unit: int = 128) -> "ExprClassTable":
        ref = build_schedule(chain, expr, reference_tiles(chain, unit),
                             hard_rule2=False)
        names = tuple(chain.loops)
        mems: list[_MemStmt] = []
        comps: list[_CompStmt] = []
        order: list[tuple[str, int]] = []
        loads_per_tensor: dict[str, int] = {}
        for s in ref.stmts:
            if s.kind == "compute":
                op = next(o for o in chain.ops if o.name == s.op)
                order.append(("comp", len(comps)))
                comps.append(_CompStmt(
                    tensor=s.tensor, path=s.path, related=s.related,
                    out_dims=chain.tensors[s.tensor].dims,
                    flops_per_point=op.flops_per_point))
            else:
                t = chain.tensors[s.tensor]
                grp = 0
                if s.kind == "load":
                    grp = loads_per_tensor.get(s.tensor, 0)
                    loads_per_tensor[s.tensor] = grp + 1
                order.append(("mem", len(mems)))
                mems.append(_MemStmt(
                    tensor=s.tensor, path=s.path, dims=t.dims,
                    dtype_bytes=t.dtype_bytes,
                    is_load=(s.kind == "load"), dedup_group=grp))
        return cls(chain=chain, expr=expr, sub_expr=ref.sub_expr(),
                   grid=ref.grid, names=names,
                   mem_stmts=tuple(mems), comp_stmts=tuple(comps),
                   stmt_order=tuple(order),
                   cached_dim_sets=tuple(sorted(
                       ref.cached_dim_sets.items())))

    # ------------------------------------------------------------------
    def _col(self, loop: str) -> int:
        return self.names.index(loop)

    def extents(self, tiles: np.ndarray) -> np.ndarray:
        dims = np.asarray([self.chain.loops[n] for n in self.names],
                          dtype=np.int64)
        return -(-dims // tiles)  # ceil div, elementwise (A, L)

    def _visit(self, tiles: np.ndarray, dims: Sequence[str],
               path: Sequence[str]) -> np.ndarray:
        """Elements touched per visit (eq 3/4): tile size for dims on
        the statement's path, full extent otherwise.  A dim popped from
        the path by extent-1 hoisting has tile == full dim, so static
        path membership gives the identical product."""
        pset = set(path)
        const = 1
        v = np.ones(tiles.shape[0], dtype=np.int64)
        for d in dims:
            if d in pset:
                v = v * tiles[:, self._col(d)]
            else:
                const *= self.chain.loops[d]
        return v * const

    def _mem_trips_and_key(self, ext: np.ndarray, stmt: _MemStmt
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Per-row trip count of a memory statement after per-assignment
        hoisting, plus an integer encoding of the hoisted path (for
        load dedup).

        Hoisting pops enclosing loops from the inside out while the
        innermost one does not index the tensor or has extent 1, so the
        surviving path is the prefix ending at the last position whose
        loop is in ``dims`` AND has extent > 1.
        """
        A = ext.shape[0]
        batch = self.chain.batch
        if not stmt.path:
            one = np.full(A, batch, dtype=np.int64)
            return one, np.zeros(A, dtype=np.int64)
        cols = [self._col(l) for l in stmt.path]
        epath = ext[:, cols]                       # (A, P)
        cum = np.cumprod(epath, axis=1)
        dset = set(stmt.dims)
        j = np.full(A, -1, dtype=np.int64)
        for i, l in enumerate(stmt.path):
            if l in dset:
                j = np.where(epath[:, i] > 1, i, j)
        prefix = cum[np.arange(A), np.maximum(j, 0)]
        trips = np.where(j >= 0, prefix, 1) * batch
        # hoisted-path encoding: sum of (loop_id+1) * base^pos over the
        # surviving prefix — equal encodings <=> equal path tuples
        base = len(self.names) + 1
        key = np.zeros(A, dtype=np.int64)
        for i, c in enumerate(cols):
            key += np.where(j >= i, (c + 1) * base ** i, 0)
        return trips, key

    # ---- the batched model -------------------------------------------
    # price() is the ONE batched implementation of eqs (1)/(3)/(4)/(5');
    # every public *_batch accessor is a view over it, so the
    # accumulation order the bit-compatibility contract depends on
    # exists in exactly one place (besides the scalar reference).

    def price(self, tiles: np.ndarray,
              hw: "TpuSpec | GpuSpec" = H100) -> "PricedBatch":
        """All model terms for every tile row in one pass: the extent
        matrix, load-dedup keys, and statement walks are shared across
        eq (3), eq (4), eq (5'), Rule 2 and the eq-(1) VMEM estimate.
        This is what ``pruning.generate_candidates_batch`` calls on the
        hot path."""
        A = tiles.shape[0]
        ext = self.extents(tiles)
        # ---- eq (3) + mem side of eq (1) ------------------------------
        # Load dedup: a load whose hoisted path collides with an earlier
        # load of the same tensor is the same DMA and must not be
        # double-charged (build_schedule dedups these at placement time).
        mem_total = np.zeros(A, dtype=np.float64)
        vmem_mem = np.zeros(A, dtype=np.int64)
        load_keys: dict[str, list[np.ndarray]] = {}
        for s in self.mem_stmts:
            trips, key = self._mem_trips_and_key(ext, s)
            tile_b = self._visit(tiles, s.dims, s.path) * s.dtype_bytes
            contrib = (tile_b * trips).astype(np.float64)
            res = hw.load_buffers * tile_b if s.is_load else tile_b
            if s.is_load:
                earlier = load_keys.setdefault(s.tensor, [])
                if earlier:
                    keep = np.ones(A, dtype=bool)
                    for k in earlier:
                        keep &= key != k
                    contrib = np.where(keep, contrib, 0.0)
                    res = np.where(keep, res, 0)
                earlier.append(key)
            mem_total += contrib
            vmem_mem += res
        # ---- eq (4) + Rule 2 + accumulator side of eq (1) -------------
        mult_by_tensor: dict[str, np.ndarray] = {}
        valid = np.ones(A, dtype=bool)
        for tensor, sets in self.cached_dim_sets:
            m = np.ones(A, dtype=np.int64)
            for dim_set in sets:
                cols = [self._col(d) for d in dim_set]
                m = np.maximum(m, np.prod(ext[:, cols], axis=1,
                                          dtype=np.int64))
            mult_by_tensor[tensor] = m
            valid &= m == 1
        comp_total = np.zeros(A, dtype=np.float64)
        vmem_comp = np.zeros(A, dtype=np.int64)
        for s in self.comp_stmts:
            cols = [self._col(l) for l in s.path]
            trips = np.prod(ext[:, cols], axis=1,
                            dtype=np.int64) * self.chain.batch
            flops = s.flops_per_point * self._visit(tiles, s.related,
                                                    s.path)
            util = np.ones(A, dtype=np.float64)
            pset = set(s.path)
            for d in s.related:
                if d in pset:
                    sz = tiles[:, self._col(d)]
                    util *= np.where(sz < hw.tile_unit,
                                     sz / hw.tile_unit, 1.0)
                else:
                    sz = self.chain.loops[d]
                    if sz < hw.tile_unit:
                        util *= sz / hw.tile_unit
            comp_total += (flops * trips) / np.maximum(util, 1e-9)
            elems = np.ones(A, dtype=np.int64)
            for d in s.out_dims:
                elems = elems * tiles[:, self._col(d)]
            mult = mult_by_tensor.get(s.tensor)
            if mult is not None:
                # scalar records the blow-up only when > 1
                elems = elems * np.maximum(mult, 1)
            vmem_comp += elems * DTYPE_BYTES["float32"]
        # NOTE: scalar vmem_estimate accumulates in Schedule.stmts order
        # (computes interleaved with loads/stores); integer addition is
        # exact so regrouping into mem + comp partial sums is identical.
        flat = "(" in self.sub_expr
        by_loop = {l: tiles[:, self._col(l)] for l in self.names}
        # eq (5') counts a split kernel's blocks, eq (3) its partials
        splits, extra = kernel_split_terms(self.chain, by_loop, flat, hw)
        g = np.maximum(1, np.prod(ext[:, [self._col(x)
                                          for x in self.grid]],
                                  axis=1, dtype=np.int64)
                       * self.chain.batch * splits)
        t_mem = (mem_total + extra) / hw.hbm_bw
        t_comp = comp_total / hw.peak_flops
        alpha = (g + hw.alpha_extra) / g
        vmem = vmem_mem + vmem_comp
        tiles_ok = np.ones(A, dtype=bool)
        if isinstance(hw, GpuSpec):
            smem = kernel_smem_bytes(self.chain, by_loop, flat, hw)
            if smem is not None:
                vmem = smem
            tiles_ok &= kernel_tiles_ok(self.chain, by_loop)
        tie = chain_tie_break(self.chain, by_loop, flat, hw)
        return PricedBatch(t_mem=t_mem, t_comp=t_comp, alpha=alpha,
                           est=(t_mem + t_comp) * alpha + tie,
                           vmem=vmem, valid=valid, tiles_ok=tiles_ok)


@dataclass(frozen=True)
class PricedBatch:
    """Per-tile-row model terms from ``ExprClassTable.price``."""

    t_mem: np.ndarray    # eq (3) seconds
    t_comp: np.ndarray   # eq (4) seconds
    alpha: np.ndarray    # eq (5')
    est: np.ndarray      # (t_mem + t_comp) * alpha  (no collective term)
    vmem: np.ndarray     # Rule-4 residency (perf_model.rule4_bytes)
    valid: np.ndarray    # hard-Rule-2 mask
    tiles_ok: np.ndarray  # the CUDA kernel takes the tiles (Rule 4)


# ---------------------------------------------------------------------------
# Tile matrices
# ---------------------------------------------------------------------------

def as_tile_matrix(chain: Chain,
                   assignments: "np.ndarray | Iterable[dict[str, int]]"
                   ) -> np.ndarray:
    """Tile matrix (n_assignments, n_loops) in ``list(chain.loops)``
    column order from either an array or an iterable of dicts."""
    if isinstance(assignments, np.ndarray):
        m = np.asarray(assignments, dtype=np.int64)
        return m.reshape(1, -1) if m.ndim == 1 else m
    names = list(chain.loops)
    return np.asarray([[a[n] for n in names] for a in assignments],
                      dtype=np.int64)
