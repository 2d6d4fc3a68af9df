"""Paged KV cache: fixed-size pages + per-request page tables.

The device side is a shared *page pool* per attention site — tensors of
shape ``(n_pages, n_kv_heads, page_size, head_dim)`` — and requests
own disjoint sets of physical pages.  A request's logical slot for
absolute position ``p`` is page ``p // page_size``, offset
``p % page_size``; its page table maps that logical page to a physical
one.  Allocation is a host-side free list: admission takes pages for
the prompt, each decode step takes at most one more when the context
crosses a page boundary, and completion returns every page.

Physical page 0 is the **scratch page**: it is never handed out, and
every masked write (an inactive batch slot, a prompt-padding row) is
redirected to it, so scatters never need a dynamic "skip" path.  Reads
never mask by value — slots are rejected by *position* (table entry
-1, or slot position ≥ the request's length / beyond the causal row).
The decode kernel reads the pool in place, only the pages
``walked_pages`` names; the gather twin (``gather_pages``) reads every
slot of the table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch

SCRATCH_PAGE = 0


class PagePool:
    """Host-side free-list allocator over ``n_pages`` physical pages.

    Page ``SCRATCH_PAGE`` (0) is reserved; ``n_pages - 1`` pages are
    allocatable.  The free list is LIFO so churn immediately reuses
    just-freed pages.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        if page_size < 1:
            raise ValueError(f"bad page_size {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = list(range(n_pages - 1, 0, -1))  # LIFO: pop() -> 1
        self._live: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """``n`` pages, or None (and no state change) when the pool
        cannot cover the request — admission backs off instead of
        partially allocating.  An armed ``page_exhaustion`` fault
        (reliability/faults.py) denies the same way a genuinely empty
        pool does, so every caller's back-off path is exercised."""
        from ..reliability import faults as _faults
        if n < 0:
            raise ValueError(f"bad page count {n}")
        if n > len(self._free) or _faults.check(
                "page_exhaustion", n=n, n_free=len(self._free)):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        return pages

    def free(self, pages: Iterable[int]) -> None:
        for p in pages:
            if p not in self._live:
                raise ValueError(f"freeing page {p} not allocated")
            self._live.remove(p)
            self._free.append(p)


#: Placeholder left in ``RequestPages.pages`` for a logical page whose
#: physical page was reclaimed (sliding-window attention): logical
#: indexing must keep counting from position 0, but the table entry
#: becomes -1 — gathered as scratch and rejected by position, exactly
#: like a never-allocated page.
RECLAIMED = -1


@dataclasses.dataclass
class RequestPages:
    """One request's page allocation: physical pages in logical order.
    Entries may be ``RECLAIMED`` (-1) after sliding-window reclamation —
    logical order is preserved, the physical page is back in the
    pool."""

    pages: list[int] = dataclasses.field(default_factory=list)

    def ensure(self, length: int, pool: PagePool) -> bool:
        """Grow the allocation to cover ``length`` kv slots; False (and
        no change) if the pool cannot — the scheduler then preempts."""
        need = math.ceil(length / pool.page_size) - len(self.pages)
        if need <= 0:
            return True
        got = pool.alloc(need)
        if got is None:
            return False
        self.pages.extend(got)
        return True

    def reclaim_below(self, min_pos: int, pool: PagePool) -> int:
        """Free pages wholly below kv position ``min_pos``; returns the
        number reclaimed.

        Sliding-window attention (``window=w``) masks ``kv_pos <=
        row_pos - w``, so once every row that will ever attend is at
        position ``p``, slots below ``min_pos = p - w + 1`` are dead.
        Logical page ``L`` covers positions ``[L*ps, (L+1)*ps)`` and is
        wholly dead iff ``(L+1)*ps <= min_pos``, i.e. ``L < min_pos //
        ps``.  Freed entries become ``RECLAIMED`` placeholders: the
        page table shows -1 there, the gather pulls scratch, and the
        position mask rejects it — bit-identical to keeping the page
        (the window mask already excluded those slots)."""
        cutoff = min(min_pos // pool.page_size, len(self.pages))
        n = 0
        for i in range(cutoff):
            if self.pages[i] != RECLAIMED:
                pool.free([self.pages[i]])
                self.pages[i] = RECLAIMED
                n += 1
        return n

    def release(self, pool: PagePool) -> None:
        pool.free(p for p in self.pages if p != RECLAIMED)
        self.pages = []


def table_array(allocs: list[Optional[RequestPages]],
                max_pages: int) -> np.ndarray:
    """(B, max_pages) int32 page table; -1 pads unallocated logical
    pages and entire inactive slots (``None`` entries)."""
    out = np.full((len(allocs), max_pages), -1, np.int32)
    for b, a in enumerate(allocs):
        if a is None:
            continue
        if len(a.pages) > max_pages:
            raise ValueError(f"request holds {len(a.pages)} pages > "
                             f"table width {max_pages}")
        out[b, :len(a.pages)] = a.pages
    return out


def paged_kv_positions(page_table: torch.Tensor, page_size: int,
                       invalid: int = -1,
                       first_page: int = 0) -> torch.Tensor:
    """(B, max_pages*page_size) absolute position of every gathered
    slot; ``invalid`` marks slots of unallocated pages.  Slot ``j`` of
    a request's ``p``-th logical page holds position
    ``p * page_size + j`` — the contiguous order the gather produces.

    ``first_page`` offsets the logical page index for callers holding a
    *slice* of the table (a chunked kernel pass).  ``invalid`` is the
    caller's sentinel — -1 for bodies that mask ``pos >= 0``,
    ``INVALID_POS`` for bodies whose causal mask alone must reject the
    slot."""
    b, mp = page_table.shape
    dev = page_table.device
    pos = ((first_page + torch.arange(mp, dtype=torch.int32,
                                      device=dev))[:, None] * page_size
           + torch.arange(page_size, dtype=torch.int32, device=dev)[None, :])
    # a Python scalar, not a tensor made from one: that would be a host
    # to device copy, which a captured decode step may not hold
    pos = torch.where(page_table[:, :, None] >= 0, pos[None], invalid)
    return pos.reshape(b, mp * page_size)


def walked_pages(length: int, page_size: int, window: int = 0,
                 rows: int = 1) -> tuple[int, int]:
    """[lo, hi): the logical pages paged decode attention reads for a
    request of ``length`` keys whose ``rows`` query rows sit at the tail
    (positions ``length - rows .. length - 1``): up to the page of its
    last key, from the page of the first key the window lets the first
    row see (page 0 with no window).  A request of length 0 reads none.
    The kernel (``csrc/attention_partial.cu``), its plain version and
    the serving engine's page counter all walk this range."""
    if length <= 0:
        return 0, 0
    lo = max(0, length - rows - window + 1) // page_size if window > 0 else 0
    return lo, -(-length // page_size)


def slot_coords(page_table: torch.Tensor, positions: torch.Tensor,
                page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical_page, offset) for writing kv at absolute ``positions``
    ((B, S); -1 = masked).  Masked positions — and positions whose
    logical page is unallocated — map to ``SCRATCH_PAGE``."""
    safe = positions.clamp(min=0)
    logical = safe // page_size
    offset = safe % page_size
    phys = torch.gather(page_table, 1,
                        logical.clamp(0, page_table.shape[1] - 1).long())
    phys = torch.where((positions >= 0) & (phys >= 0), phys,
                       torch.full_like(phys, SCRATCH_PAGE))
    return phys, offset


def gather_pages(pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """(n_pages, H, ps, D) through (B, MP) indices -> (B, H, MP*ps, D);
    unallocated entries gather the scratch page and must be rejected by
    position."""
    g = pages[page_table.clamp(0, pages.shape[0] - 1).long()]
    b, mp, h, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, mp * ps, d)


def scatter_pages(pages: torch.Tensor, phys: torch.Tensor,
                  offset: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Write ``values`` (B, S, H, D) into ``pages`` at per-token
    (phys, offset) coordinates (each (B, S)), IN PLACE — the pool is
    the largest tensor a serving step touches, so it is not copied.
    Distinct live slots never collide (pages are exclusively owned);
    duplicate scratch writes land in arbitrary order, which is fine —
    scratch is never read validly.  Returns ``pages``."""
    pages[phys.long(), :, offset.long(), :] = values.to(pages.dtype)
    return pages
