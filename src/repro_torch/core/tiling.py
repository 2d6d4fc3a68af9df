"""Tiling-expression enumeration (paper §III-A).

A tiling expression is a loop tree over the chain's cross-tile loops:

* **Deep tiling** — every pair of loops is nested; one expression per
  permutation of the loop set (x! for x loops).
* **Flat tiling** — loops exclusive to different ops run *sequentially*
  in the same (innermost) scope; shared loops are nested outside.  For
  the 2-GEMM chain this yields exactly ``mn(k,h)`` and ``nm(k,h)``
  (paper's example: 24 + 2 = 26 expressions).

Trees are immutable tuples so they hash (used by Rule-1 dedup).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, Union

from .chain import Chain

# A scope is a tuple of items executed sequentially.
# An item is either a Loop (name, body-scope) or a statement placeholder
# (statements are attached later by dag.py).


@dataclass(frozen=True)
class Loop:
    name: str
    body: tuple["Loop", ...] = ()

    def __repr__(self) -> str:  # compact: mhn(k) style
        if not self.body:
            return self.name
        inner = ",".join(repr(b) for b in self.body)
        if len(self.body) == 1:
            return f"{self.name}{inner}"
        return f"{self.name}({inner})"


Scope = tuple[Loop, ...]


def expr_repr(scope: Scope) -> str:
    s = ",".join(repr(l) for l in scope)
    return s


def deep_tiling(order: Iterable[str]) -> Scope:
    """Nested loop chain in the given order."""
    scope: Scope = ()
    for name in reversed(list(order)):
        scope = (Loop(name, scope),)
    return scope


def flat_tiling(shared_order: Iterable[str], groups: Iterable[Iterable[str]]) -> Scope:
    """Shared loops nested outer, then one deep sub-chain per op group,
    the groups sequential in the innermost shared scope."""
    inner: Scope = tuple(
        deep_tiling(g)[0] for g in groups if list(g)
    )
    scope = inner
    for name in reversed(list(shared_order)):
        scope = (Loop(name, scope),)
    return scope


def all_loops(scope: Scope) -> list[str]:
    out: list[str] = []

    def walk(s: Scope) -> None:
        for l in s:
            out.append(l.name)
            walk(l.body)

    walk(scope)
    return out


def loop_depth(scope: Scope) -> int:
    if not scope:
        return 0
    return max(1 + loop_depth(l.body) for l in scope)


def is_deep(scope: Scope) -> bool:
    """True if every scope has at most one child (pure nest)."""
    if len(scope) > 1:
        return False
    return all(is_deep(l.body) for l in scope)


def enumerate_tilings(chain: Chain) -> list[Scope]:
    """All deep + flat tiling expressions for a chain (paper §III-A)."""
    names = list(chain.loops)
    exprs: list[Scope] = [deep_tiling(p) for p in itertools.permutations(names)]

    # Flat tilings: shared loops (related to >1 op) nested in any order;
    # per-op exclusive loops form sequential sibling groups innermost.
    groups = [chain.exclusive_loops(op) for op in chain.ops]
    groups = [g for g in groups if g]
    shared = [n for n in names if all(n not in g for g in groups)]
    if len(groups) >= 2:
        for shared_perm in itertools.permutations(shared):
            group_perms = [list(itertools.permutations(g)) for g in groups]
            for combo in itertools.product(*group_perms):
                exprs.append(flat_tiling(shared_perm, combo))
    # dedup (identical trees can arise for degenerate chains)
    seen: dict[Scope, None] = {}
    for e in exprs:
        seen.setdefault(e, None)
    return list(seen)


# ---------------------------------------------------------------------------
# Tile-size enumeration (TPU adaptation: MXU lane width 128, not 16)
# ---------------------------------------------------------------------------

def candidate_tile_sizes(dim: int, unit: int = 128, max_candidates: int = 64,
                         allow_full: bool = True) -> list[int]:
    """Viable tile sizes for one loop: multiples of `unit` (MXU-aligned)
    up to the dim size, plus the full dim itself (→ loop extent 1, which
    enables the paper's dead-loop hoisting, Fig. 4b).

    The paper uses multiples of 16 (tensor-core min tile); on TPU the
    MXU lane width is 128, and sub-128 tiles waste the systolic array.
    Dims smaller than `unit` get a single candidate: the full dim
    (padded inside the kernel — Rule 3 exempts mandatory padding).
    """
    if dim <= unit:
        return [dim]
    cands = [t for t in range(unit, dim, unit)][:max_candidates - 1]
    if allow_full and dim not in cands:
        cands.append(dim)
    return cands


def search_space_size(chain: Chain, unit: int = 128) -> int:
    n_expr = len(enumerate_tilings(chain))
    n_tiles = 1
    for name, dim in chain.loops.items():
        n_tiles *= len(candidate_tile_sizes(dim, unit=unit))
    return n_expr * n_tiles
