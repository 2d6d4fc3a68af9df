"""Orca-style continuous-batching scheduler over the paged KV cache.

One ``step()`` is one scheduler iteration:

1. **admit** — pop FIFO requests into free batch slots while the page
   pool can cover their prompt plus the slot of their first decode
   token, and prefill each (batch 1, padded to a page multiple) straight
   into its freshly allocated pages;
2. **decode** — every running request advances one token in a single
   ragged batched ``decode_step_paged`` call (inactive slots ride along
   masked: position -1, kv to the scratch page, logits ignored);
3. **evict** — requests that hit their token budget (or ``eos_id``)
   free their pages back to the pool and leave the batch.

Under memory pressure the **newest** running request is preempted and
requeued for recompute (its prompt plus tokens-generated-so-far become
the new prompt); a retry budget bounds how often one request may be
preempted.  Requests may carry a deadline in scheduler steps, and
``drain()`` stops gracefully.  Every cut-short request is reported with
an honest ``outcome`` and its partial tokens.

The decode attention's (bq, bkv) tiles are a tuner decision: at
construction the engine tunes the paged attention chain for its decode
shape (``core.api.fuse_attention_paged``, persistent-cached) and threads
the winning tiles into the model's ``Runtime``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from . import kv_pages as KP

#: Per-request outcomes reported on ``FinishedRequest.outcome``.
OUTCOMES = ("complete", "deadline", "preempt_budget", "drained")


@dataclasses.dataclass
class FinishedRequest:
    """One completed request, in submission order from ``run()``."""

    rid: int
    prompt_len: int
    tokens: list[int]            # generated tokens (may be < requested
    submit_step: int             # budget when eos_id fired)
    finish_step: int
    n_preempted: int = 0
    outcome: str = "complete"    # one of OUTCOMES; anything but
    #                              "complete" means tokens is partial


@dataclasses.dataclass
class _Pending:
    rid: int
    prompt: np.ndarray           # original prompt ++ recomputed tokens
    base_prompt_len: int
    done: list[int]
    max_new: int
    submit_step: int
    n_preempted: int = 0
    deadline: Optional[int] = None   # absolute step number, inclusive


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: np.ndarray           # original prompt (++ recomputed tokens
    base_prompt_len: int         # after a preemption)
    generated: list[int]
    max_new: int
    alloc: KP.RequestPages
    submit_step: int
    admit_seq: int               # preemption order: newest goes first
    n_preempted: int = 0
    n_done_admit: int = 0        # generated tokens already inside
    #                              ``prompt`` (recompute re-prefilled them)
    deadline: Optional[int] = None

    @property
    def pos(self) -> int:
        """Absolute position the next decode step writes: kv holds the
        prompt plus every post-admission token except the newest.
        Tokens re-prefilled after a preemption live in ``prompt`` AND
        ``generated`` — count them once."""
        return (len(self.prompt) + len(self.generated)
                - self.n_done_admit - 1)


class ServingEngine:
    """Continuous-batching serving over a paged KV cache.

    model/params: a ``models.lm.LM`` and its weights (on the model's
    device).  max_batch: decode slot count (the ragged batch width).
    page_size / n_pages: the pool (page 0 is scratch, so ``n_pages - 1``
    are allocatable).  max_pages_per_seq: page-table width; a request
    may span at most ``max_pages_per_seq * page_size`` positions.
    """

    def __init__(self, model, params, *, max_batch: int = 4,
                 page_size: int = 16, n_pages: int = 64,
                 max_pages_per_seq: int = 8,
                 eos_id: Optional[int] = None,
                 choose_regime: bool = True, verbose: bool = False,
                 max_preemptions: int = 8, stall_limit: int = 8):
        self.params = params
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.n_ctx = max_pages_per_seq * page_size
        self.eos_id = eos_id
        self.verbose = verbose
        self.max_preemptions = max_preemptions
        self.stall_limit = stall_limit
        self.pool = KP.PagePool(n_pages, page_size)
        self.queue: list[_Pending] = []
        self.slots: list[Optional[_Slot]] = [None] * max_batch
        self.finished: list[FinishedRequest] = []
        self.step_no = 0
        self._next_rid = 0
        self._admit_seq = 0
        self._stall = 0              # consecutive barren steps
        self._draining = False
        self.stats = {"decode_steps": 0, "prefills": 0, "preemptions": 0,
                      "generated": 0, "slot_steps": 0, "active_steps": 0,
                      "ctx_tokens": 0, "admit_requeues": 0,
                      "deadline_evictions": 0, "preempt_failures": 0,
                      "drained": 0}
        self.regime_source, tiles = (self._choose_regime(model)
                                     if choose_regime else (None, None))
        if tiles != model.rt.paged_block:
            model = type(model)(
                model.cfg, dataclasses.replace(model.rt, paged_block=tiles),
                device=model.device)
        self.model = model
        self.device = model.device
        self.cache = model.init_paged_cache(n_pages, page_size)

    # ------------------------------------------------------------------
    def _choose_regime(self, model):
        """(schedule source, (bq, bkv)) of the paged attention tuned for
        this engine's decode shape (q=1 row over the full ``n_ctx``
        paged context) — served from the persistent schedule cache on
        warm starts."""
        from ..core import api
        cfg = model.cfg
        tk = api.fuse_attention_paged(
            1, self.n_ctx, cfg.dh, cfg.dh, page_size=self.page_size,
            heads=cfg.n_heads, batch=self.max_batch, dtype=cfg.dtype,
            causal=True)
        if self.verbose:
            print(f"paged regime[decode q=1 kv={self.n_ctx}]: "
                  f"paged-spatial bq={tk.params.bq} bkv={tk.params.bkv} "
                  f"({tk.report.best_time * 1e6:.1f}us modelled, "
                  f"schedule from {tk.source})")
        return tk.source, (tk.params.bq, tk.params.bkv)

    def _table(self, allocs) -> torch.Tensor:
        return torch.from_numpy(KP.table_array(allocs, self.max_pages)).to(
            self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int,
               deadline_steps: Optional[int] = None) -> int:
        """Queue one request; returns its id.  Validated against the
        engine's hard geometry so admission can never dead-lock — the
        pool must cover the WORST-CASE re-admission after a preemption
        (recompute prompt = prompt ++ up to ``max_new - 1`` generated
        tokens, plus the one-page admission headroom).

        deadline_steps: budget in scheduler steps; past it the request
        is evicted with ``outcome="deadline"`` and its partial tokens."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if max_new < 1:
            raise ValueError("max_new must be >= 1: greedy serving "
                             "always emits the prefill's first token")
        if deadline_steps is not None and deadline_steps < 1:
            raise ValueError(f"bad deadline_steps {deadline_steps}")
        total = len(prompt) + max_new
        if total > self.n_ctx:
            raise ValueError(
                f"prompt {len(prompt)} + gen {max_new} = {total} "
                f"exceeds n_ctx {self.n_ctx}")
        worst = math.ceil((total - 1) / self.page_size) + 1
        if worst > self.pool.n_pages - 1:
            raise ValueError(
                f"request needs up to {worst} pages after a recompute "
                f"but the pool holds {self.pool.n_pages - 1}")
        rid = self._next_rid
        self._next_rid += 1
        deadline = (self.step_no + deadline_steps
                    if deadline_steps is not None else None)
        self.queue.append(_Pending(rid, prompt, len(prompt), [], max_new,
                                   self.step_no, deadline=deadline))
        return rid

    # ------------------------------------------------------------------
    def _admit_one(self) -> bool:
        """FIFO head-of-line admission: the head is admitted iff a slot
        is free AND the pool covers its prompt pages plus the slot its
        first decode token writes — allocated up front, so a freshly
        admitted request can never be the same step's preemption
        victim."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not self.queue or not free:
            return False
        pend = self.queue[0]
        plen = len(pend.prompt)
        if self.pool.n_free < math.ceil((plen + 1) / self.page_size):
            return False
        self.queue.pop(0)
        alloc = KP.RequestPages()
        if not alloc.ensure(plen + 1, self.pool):
            self.queue.insert(0, pend)
            self.stats["admit_requeues"] += 1
            return False
        s_pad = math.ceil(plen / self.page_size) * self.page_size
        toks = np.zeros((1, s_pad), np.int64)
        toks[0, :plen] = pend.prompt
        logits, self.cache = self.model.prefill_paged(
            self.params, torch.from_numpy(toks).to(self.device), self.cache,
            self._table([alloc]), plen)
        self.stats["prefills"] += 1
        tok = int(torch.argmax(logits[0]))
        slot = _Slot(pend.rid, pend.prompt, pend.base_prompt_len,
                     pend.done + [tok], pend.max_new, alloc,
                     pend.submit_step, self._admit_seq,
                     pend.n_preempted, n_done_admit=len(pend.done),
                     deadline=pend.deadline)
        self._admit_seq += 1
        self.slots[free[0]] = slot
        self._maybe_finish(free[0])
        return True

    def _preempt(self, idx: int) -> None:
        """Requeue slot ``idx`` for recompute: its pages go back to the
        pool and its prompt ++ generated tokens become the new prompt
        (greedy decode is deterministic, so the continuation picks up
        where it left off).  A request preempted more than
        ``max_preemptions`` times finishes with
        ``outcome="preempt_budget"``; the first recompute requeues at
        the head, repeat victims back off to the tail."""
        slot = self.slots[idx]
        slot.alloc.release(self.pool)
        self.slots[idx] = None
        if slot.n_preempted + 1 > self.max_preemptions:
            self.finished.append(FinishedRequest(
                slot.rid, slot.base_prompt_len, list(slot.generated),
                slot.submit_step, self.step_no, slot.n_preempted + 1,
                outcome="preempt_budget"))
            self.stats["preempt_failures"] += 1
            self.stats["generated"] += len(slot.generated)
            return
        fresh = slot.generated[slot.n_done_admit:]
        pend = _Pending(
            slot.rid,
            np.concatenate([slot.prompt, np.asarray(fresh, np.int64)]),
            slot.base_prompt_len, list(slot.generated), slot.max_new,
            slot.submit_step, slot.n_preempted + 1,
            deadline=slot.deadline)
        if slot.n_preempted == 0:
            self.queue.insert(0, pend)
        else:
            self.queue.append(pend)
        self.stats["preemptions"] += 1

    def _maybe_finish(self, idx: int) -> None:
        slot = self.slots[idx]
        done_n = len(slot.generated)
        hit_eos = (self.eos_id is not None and done_n
                   and slot.generated[-1] == self.eos_id)
        if done_n >= slot.max_new or hit_eos:
            slot.alloc.release(self.pool)
            self.finished.append(FinishedRequest(
                slot.rid, slot.base_prompt_len, list(slot.generated),
                slot.submit_step, self.step_no, slot.n_preempted))
            self.slots[idx] = None
            self.stats["generated"] += done_n

    def _grow_or_preempt(self) -> list[int]:
        """Every active slot gets capacity for the position it is about
        to write, preempting newest-first under pressure."""
        while True:
            active = [i for i, s in enumerate(self.slots)
                      if s is not None]
            blocked = [i for i in active
                       if not self.slots[i].alloc.ensure(
                           self.slots[i].pos + 1, self.pool)]
            if not blocked:
                return active
            victim = max(active, key=lambda i: self.slots[i].admit_seq)
            self._preempt(victim)

    def _finish_request(self, rid, prompt_len, tokens, submit_step,
                        n_preempted, outcome: str) -> None:
        self.finished.append(FinishedRequest(
            rid, prompt_len, list(tokens), submit_step, self.step_no,
            n_preempted, outcome=outcome))
        self.stats["generated"] += len(tokens)

    def _evict_slot(self, idx: int, outcome: str) -> None:
        """Honest eviction: pages back to the pool, partial tokens
        reported under ``outcome``."""
        slot = self.slots[idx]
        slot.alloc.release(self.pool)
        self.slots[idx] = None
        self._finish_request(slot.rid, slot.base_prompt_len,
                             slot.generated, slot.submit_step,
                             slot.n_preempted, outcome)

    def _expire_deadlines(self) -> None:
        """Queued or running requests past their deadline finish NOW
        with ``outcome="deadline"`` and whatever they have."""
        kept = []
        for pend in self.queue:
            if pend.deadline is not None and self.step_no > pend.deadline:
                self._finish_request(pend.rid, pend.base_prompt_len,
                                     pend.done, pend.submit_step,
                                     pend.n_preempted, "deadline")
                self.stats["deadline_evictions"] += 1
            else:
                kept.append(pend)
        self.queue[:] = kept
        for i, slot in enumerate(self.slots):
            if (slot is not None and slot.deadline is not None
                    and self.step_no > slot.deadline):
                self._evict_slot(i, "deadline")
                self.stats["deadline_evictions"] += 1

    # ------------------------------------------------------------------
    def step(self) -> list[FinishedRequest]:
        """One scheduler iteration; returns requests finished in it."""
        n_done = len(self.finished)
        self.step_no += 1
        self._expire_deadlines()
        # running slots take their growth pages BEFORE admission sees
        # the free count, and admission reserves each fresh request's
        # first decode slot — so the second growth pass below can only
        # preempt on genuine cross-step pressure
        self._grow_or_preempt()
        admitted = False
        if not self._draining:
            while self._admit_one():
                admitted = True
        active = self._grow_or_preempt()
        if not active:
            if self.queue and not admitted and not self._draining:
                self._stall += 1
                if self._stall > self.stall_limit:
                    raise RuntimeError(
                        "scheduler stalled: pool cannot cover the "
                        "queue head even when idle — shrink prompts "
                        "or grow n_pages")
            return self.finished[n_done:]
        self._stall = 0

        tokens = np.zeros((self.max_batch,), np.int64)
        positions = np.full((self.max_batch,), -1, np.int32)
        for i in active:
            tokens[i] = self.slots[i].generated[-1]
            positions[i] = self.slots[i].pos
        logits, self.cache = self.model.decode_step_paged(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(positions).to(self.device),
            self._table([s.alloc if s is not None else None
                         for s in self.slots]))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += self.max_batch
        self.stats["active_steps"] += len(active)
        for i in active:
            slot = self.slots[i]
            self.stats["ctx_tokens"] += slot.pos + 1
            slot.generated.append(int(nxt[i]))
            self._maybe_finish(i)
        return self.finished[n_done:]

    def drain(self, deadline: Optional[float] = None,
              max_steps: Optional[int] = None) -> list[FinishedRequest]:
        """Graceful stop: admission closes, in-flight requests run to
        completion, and whatever cannot finish inside ``deadline``
        wall-seconds (or ``max_steps`` scheduler steps) is evicted with
        ``outcome="drained"`` and its partial tokens.  Queued requests
        that never reached a slot are failed immediately the same way.
        Returns the requests that finished during the drain."""
        n_done = len(self.finished)
        self._draining = True
        try:
            def _fail_queue():
                for pend in self.queue:
                    self._finish_request(
                        pend.rid, pend.base_prompt_len, pend.done,
                        pend.submit_step, pend.n_preempted, "drained")
                    self.stats["drained"] += 1
                self.queue.clear()

            _fail_queue()
            t0 = time.perf_counter()
            steps = 0
            while any(s is not None for s in self.slots):
                if deadline is not None \
                        and time.perf_counter() - t0 >= deadline:
                    break
                if max_steps is not None and steps >= max_steps:
                    break
                self.step()
                steps += 1
                _fail_queue()   # preemption refugees drain too
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    self._evict_slot(i, "drained")
                    self.stats["drained"] += 1
        finally:
            self._draining = False
        return self.finished[n_done:]

    def run(self, requests) -> tuple[list[FinishedRequest], dict]:
        """Drive ``step()`` until every submitted request finishes.

        requests: iterable of (prompt, max_new).  Returns results in
        submission order plus a stats dict (wall seconds, tokens/s, and
        the step counters)."""
        for prompt, max_new in requests:
            self.submit(prompt, max_new)
        t0 = time.perf_counter()
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        dt = time.perf_counter() - t0
        out = sorted(self.finished, key=lambda r: r.rid)
        stats = dict(self.stats)
        stats["wall_s"] = dt
        stats["tok_per_s"] = stats["generated"] / dt if dt > 0 else 0.0
        return out, stats
