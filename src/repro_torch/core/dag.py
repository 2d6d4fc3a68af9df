"""Statement placement, DAG analysis and memory-access hoisting (§III-B).

Given (tiling expression, tile sizes) this module produces a *Schedule*:
every Load / Compute / Store primitive placed at a loop scope, with the
paper's two optimizations applied:

1. **Hoisting**: a memory statement moves outward past every enclosing
   loop whose variable does not index its tensor (Fig. 4a: `S_E` hoisted
   out of the reduction loop).
2. **Dead-loop elimination**: a loop whose extent is 1 (tile == dim) is
   a dead DAG node; statements hoist past it as well (Fig. 4b: `L_A`
   hoisted out by a factor of h·n once k == 1).

Both collapse into one uniform rule: *pop enclosing loops from the
inside out while the innermost one either does not index the tensor or
has extent 1*.

TPU grid binding (Rule-1 canonicalization, docs/design.md §2): chain-spatial
loops sitting on pure-nest positions are hoisted to the Pallas grid.
Spatial loops inside *flat* (sequential-sibling) scopes stay put — that
is exactly the deep-vs-flat distinction (a flat `mn(k,h)` computes C
once per (m,n) and reuses it for every h, a deep `mhnk` recomputes C per
h grid block).

Consumer-inside-producer-reduction placements (sub-expression `kn`) are
handled as the paper's Fig. 6(b): the consumer hoists out of the
producer's reduction loop and sweeps its own loops *implicitly*, at the
cost of caching every intermediate tile — Rule 2 / Rule 4 then prune
the blow-up.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .chain import Chain, OpSpec
from .tiling import Loop, Scope, expr_repr


@dataclass(frozen=True)
class Stmt:
    kind: str                 # "load" | "compute" | "store"
    tensor: str               # tensor moved / produced
    op: Optional[str]         # owning compute op (None for shared loads)
    path: tuple[str, ...]     # enclosing loops, outermost -> innermost
    related: tuple[str, ...]  # loops that semantically index this stmt


@dataclass
class Schedule:
    chain: Chain
    expr: Scope                       # original tiling expression
    tile_sizes: dict[str, int]
    grid: tuple[str, ...]             # loops bound to the Pallas grid
    block_expr: Scope                 # per-block structure after binding
    stmts: list[Stmt] = field(default_factory=list)
    valid: bool = True
    invalid_reason: Optional[str] = None
    needs_rescale: bool = False       # online-softmax streaming consumer
    cached_intermediates: dict[str, int] = field(default_factory=dict)
    # ^ intermediate -> buffer multiplicity (Rule-2 blow-up factor)
    cached_dim_sets: dict[str, tuple[tuple[str, ...], ...]] = \
        field(default_factory=dict)
    # ^ intermediate -> dim sets whose tile *extents* multiply into the
    #   Rule-2 blow-up.  The multiplicity above is the max over these
    #   sets of prod(ceil(dim/tile)); recording the sets (structural,
    #   tile-independent) lets batch_model re-price the blow-up for a
    #   whole tile matrix without re-running placement.

    # ---- extents -----------------------------------------------------
    def extent(self, loop: str) -> int:
        return math.ceil(self.chain.loops[loop] / self.tile_sizes[loop])

    @property
    def extents(self) -> dict[str, int]:
        return {l: self.extent(l) for l in self.chain.loops}

    def trips(self, stmt: Stmt) -> int:
        t = self.chain.batch
        for l in stmt.path:
            t *= self.extent(l)
        return t

    def visit_elems(self, stmt: Stmt, dims: tuple[str, ...]) -> int:
        """Elements touched per visit: tiled if the loop encloses the
        statement, full otherwise (hoisted / implicit sweep)."""
        n = 1
        for d in dims:
            n *= self.tile_sizes[d] if d in stmt.path else self.chain.loops[d]
        return n

    def sub_expr(self) -> str:
        return expr_repr(self.block_expr)

    def key(self) -> tuple:
        """Rule-1 dedup key: per-block program + tile sizes.  Grid-axis
        order does not change the per-block program (mhnk == hmnk)."""
        return (
            self.sub_expr(),
            frozenset(self.grid),
            tuple(sorted(self.tile_sizes.items())),
        )

    def grid_size(self) -> int:
        n = self.chain.batch
        for g in self.grid:
            n *= self.extent(g)
        return n


# ---------------------------------------------------------------------------
# Rule-1 canonicalization: hoist pure-nest spatial loops to the grid
# ---------------------------------------------------------------------------

def bind_grid(chain: Chain, expr: Scope) -> tuple[tuple[str, ...], Scope]:
    spatial = set(chain.spatial_loops)

    grid: list[str] = []

    def strip(scope: Scope, in_flat: bool) -> Scope:
        out: list[Loop] = []
        flat_here = len(scope) > 1
        for l in scope:
            if l.name in spatial and not in_flat and not flat_here:
                grid.append(l.name)
                out.extend(strip(l.body, in_flat))
            else:
                out.append(Loop(l.name, strip(l.body, in_flat or flat_here)))
        return tuple(out)

    block = strip(expr, False)
    return tuple(grid), block


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _find_path(scope: Scope, related: set[str], prefix: tuple[str, ...]
               ) -> tuple[str, ...]:
    """Descend into every child whose subtree contains a related loop;
    returns the enclosing-loop path for a statement needing `related`."""
    for l in scope:
        sub = set(_subtree_names(l))
        if sub & related:
            return _find_path(l.body, related, prefix + (l.name,))
    return prefix


def _subtree_names(l: Loop) -> list[str]:
    out = [l.name]
    for c in l.body:
        out.extend(_subtree_names(c))
    return out


def _tree_index(scope: Scope) -> dict[str, tuple[str, ...]]:
    """loop name -> path of ancestors (outermost..itself)."""
    idx: dict[str, tuple[str, ...]] = {}

    def walk(s: Scope, pre: tuple[str, ...]) -> None:
        for l in s:
            idx[l.name] = pre + (l.name,)
            walk(l.body, pre + (l.name,))

    walk(scope, ())
    return idx


def build_schedule(chain: Chain, expr: Scope, tile_sizes: dict[str, int],
                   hard_rule2: bool = False) -> Schedule:
    """Place all statements and apply hoisting + dead-loop elimination.

    hard_rule2: if True, reject any schedule that caches multiple
    intermediate tiles (the paper's categorical Rule 2); if False the
    blow-up is charged to the VMEM estimate and Rule 4 decides.
    """
    grid, block = bind_grid(chain, expr)
    sched = Schedule(chain, expr, dict(tile_sizes), grid, block)
    producers = chain.producers()
    tree = _tree_index(block)

    compute_paths: dict[str, tuple[str, ...]] = {}
    for op in chain.ops:
        related = set(chain.op_related_loops(op)) - set(grid)
        path = grid + _find_path(block, related, ())
        # Redundant enclosers: loops on the path not related to this op.
        for r in path:
            if r in chain.op_related_loops(op):
                continue
            producing = [
                producers[t] for t in op.ins if t in producers
            ]
            for p in producing:
                if r in p.reduce_dims:
                    # Consumer sits inside its producer's reduction loop:
                    # hoist the consumer out (paper Fig. 6b semantics) and
                    # cache every produced tile indexed by loops inside r.
                    cut = path.index(r)
                    inner = set(path[cut:]) - {r}
                    new_path = path[:cut]
                    # implicit sweep over related loops no longer enclosing
                    path = new_path
                    mult = 1
                    dim_set: list[str] = []
                    for d in chain.tensors[p.out].dims:
                        if d in inner or (d in tree and r in tree[d][:-1]):
                            dim_set.append(d)
                            mult *= math.ceil(
                                chain.loops[d] / tile_sizes[d])
                    if dim_set:
                        sched.cached_dim_sets[p.out] = (
                            sched.cached_dim_sets.get(p.out, ())
                            + (tuple(dim_set),))
                    if mult > 1:
                        sched.cached_intermediates[p.out] = max(
                            sched.cached_intermediates.get(p.out, 1), mult)
                    if p.epilogue == "online_softmax":
                        sched.needs_rescale = False
                    break
        compute_paths[op.name] = path
        sched.stmts.append(Stmt("compute", op.out, op.name, path,
                                tuple(chain.op_related_loops(op))))
        # Streaming-softmax detection: the consumer of an online_softmax
        # producer accumulates across the producer's spatial loop.
        for t in op.ins:
            if t in producers and producers[t].epilogue == "online_softmax":
                shared_red = set(op.reduce_dims) & set(path)
                if shared_red and producers[t].out not in sched.cached_intermediates:
                    sched.needs_rescale = True

    def hoisted(path: tuple[str, ...], dims: tuple[str, ...]) -> tuple[str, ...]:
        p = list(path)
        while p and (p[-1] not in dims or sched.extent(p[-1]) == 1):
            p.pop()
        return tuple(p)

    # Loads: one per (input tensor, consuming op); dedup identical.
    seen: set[tuple] = set()
    for op in chain.ops:
        for t in op.ins:
            if t in producers:
                continue  # intermediate: VMEM-resident, no HBM load
            dims = chain.tensors[t].dims
            path = hoisted(compute_paths[op.name], dims)
            key = ("load", t, path)
            if key in seen:
                continue
            seen.add(key)
            sched.stmts.append(Stmt("load", t, op.name, path, dims))

    # Stores: chain outputs only.
    for name in chain.output_names:
        op = producers[name]
        dims = chain.tensors[name].dims
        path = hoisted(compute_paths[op.name], dims)
        sched.stmts.append(Stmt("store", name, op.name, path, dims))

    if hard_rule2 and any(m > 1 for m in sched.cached_intermediates.values()):
        sched.valid = False
        sched.invalid_reason = "rule2_intermediate_blowup"
    return sched
