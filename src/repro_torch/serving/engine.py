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

On the card the decode step is captured once per engine in a CUDA
graph (``kernels.capture.CapturedStep``) and replayed on every step —
the counterpart of the JAX package's ``jax.jit(decode_step_paged)``.
Its inputs live in static device buffers of the step's fixed shape
(tokens and positions of ``max_batch``, a page table ``max_pages``
wide) that each step overwrites; the KV pool is written in place, so
the graph's writes land in the engine's cache, and the argmax runs
inside the graph.  The capture's warm-up runs with every position at
-1, which writes only the scratch page.  ``eager_decode=True`` runs
the step op by op instead (the yardstick a captured run is held
against); on the CPU the step always runs eagerly.  Prefill stays
eager: its shape changes with each prompt.

The decode attention's (bq, bkv) tiles are a tuner decision: at
construction the engine tunes the paged attention chain for its decode
shape (``core.api.fuse_attention_paged``, persistent-cached) and threads
the winning tiles into the model's ``Runtime``.  Under a mesh
(``Runtime(mesh=...)``) the choice is also the regime's
(``kernels.ops.paged_attention_regime_choice``: paged-spatial,
paged-ring or paged-ring-pipelined), threaded into the ``Runtime`` as
its ``dist_decode_attn``/``dist_decode_pipelined``; the pools are then
whole on every rank for the ring regimes, heads-sharded otherwise.
Every rank runs the same scheduler on the same requests.  A gloo
collective cannot be captured in a CUDA graph, so under a mesh the
decode step runs eagerly, and ``stats["decode_graph"]`` says why
(``"eager-mesh"``; ``"captured"`` or ``"eager"`` otherwise).  Under
``Runtime(planner=True)`` it also plans the steady-state decode block
at construction (``core.planner``), so the first step never pays the
carve.

Degradation: the engine does not die on a bad fused unit.  Execution
runs through a **tiered fallback chain** — tier 0 is the configured
model (planner/kernel paths as built, captured on the card), tier 1 its
torch twin (planner and kernel_ops off, still captured on the card),
tier 2 the same twin op by op — demoting stickily on a dispatch failure
and, on the planned path, quarantining the decode plan through the
circuit breaker so relaunches skip it.  Only an injected fault or a
launch the card refused is degraded from
(``reliability.breaker.degradable``); anything else raises, a kernel
that does not build among them (every library the engine will launch
is built at construction on the card).  Every degradation counts
in ``stats`` (``tier_demotions``, ``shadow_mismatches``,
``golden_mismatches``) or in the breaker's ``failures(key)``.  With the
sentinels armed (``reliability.sentinels``) a golden probe runs before
traffic and sampled steps are shadowed by the twin; since the KV pool
is written in place, a shadow saves the pool rows the step wrote,
runs the twin, and restores them.  A soft **watchdog** times every
step, and ``drain()`` stops gracefully.

Tracing: ``engine.step`` and each phase of a step (``PHASES``) are
host-only ``torch.profiler`` events, and each phase adds its host
seconds to a counter in ``stats``, always on, beside ``queue_wait_s``
(the seconds each admitted request waited in the queue).  Host-only by
design: a ``record_function`` range gets a device-side image on the
card, which a trace would count as device work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..reliability import breaker as _breaker
from ..reliability import faults as _faults
from ..reliability import sentinels as _sentinels
from ..reliability.watchdog import StepWatchdog
from . import kv_pages as KP

from torch._C._profiler import _RecordFunctionFast

#: Execution tiers, best first.
TIERS = ("configured", "torch-twin", "eager-twin")

#: Where the configured tier runs kernels, a shadow accepts its logits
#: when each row's gap from the twin's, relative in the 2-norm, is within
#: the dtype's ``TOLERANCES`` rtol — for bf16 within the port's stated
#: decode-step limit of 5e-2 instead: an elementwise test fails on the
#: logits near zero, where a kernel's rounding is as large as the
#: logit, and a bf16 step is 0.018 from the plain step on the card
#: while a wrong answer is order 1.
SHADOW_REL_TOL = {"bfloat16": 5e-2}

#: The phases of a step: the profiler event's name, and the counter in
#: ``stats`` that adds its host seconds less those of the phases nested
#: in it.  ``engine.schedule`` is deadlines, window reclaim, growth and
#: admission decisions, a prefill nested in it; ``engine.prefill`` one
#: admitted prompt through its first token on the host; the decode step's inputs staged, its dispatch launched (a
#: graph replay on the card), the host waiting for its tokens; then
#: ``engine.book``, the per-slot bookkeeping.  A sampled sentinel
#: shadow is timed in ``shadow_wall_s``, inside the phase it checks.
PHASES = {"engine.schedule": "schedule_s", "engine.prefill": "prefill_s",
          "engine.decode.stage": "decode_stage_s",
          "engine.decode.launch": "decode_launch_s",
          "engine.decode.wait": "decode_wait_s", "engine.book": "book_s"}

#: Per-request outcomes reported on ``FinishedRequest.outcome``.
#: "health" = evicted by the activation health monitor
#: (``Runtime(sentinels=True)``): its step produced NaN/Inf/exploded
#: logits, and the partial tokens are reported honestly.
OUTCOMES = ("complete", "deadline", "preempt_budget", "drained",
            "health")


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
    # host seconds it entered the queue (submitted, or requeued)
    queued_s: float = dataclasses.field(default_factory=time.perf_counter)


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
    watchdog_s: the soft step budget (breaches are counted, never
    fatal).  eager_decode: on a CUDA device, run each decode step op by
    op instead of replaying the captured one; otherwise only a demotion
    to tier 2 (counted in ``stats["tier_demotions"]``) runs the eager
    step on the card.  choose_regime: tune the decode attention's
    regime and tiles (under a mesh, the regime search); False runs the
    regime the model's ``Runtime`` states (a ring regime under
    ``dist_decode_attn``, pipelined under ``dist_decode_pipelined``) at
    its ``paged_block`` tiles.
    """

    def __init__(self, model, params, *, max_batch: int = 4,
                 page_size: int = 16, n_pages: int = 64,
                 max_pages_per_seq: int = 8,
                 eos_id: Optional[int] = None,
                 choose_regime: bool = True, verbose: bool = False,
                 max_preemptions: int = 8,
                 watchdog_s: Optional[float] = None,
                 stall_limit: int = 8, eager_decode: bool = False):
        self.params = params
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.n_ctx = max_pages_per_seq * page_size
        self.eos_id = eos_id
        self.verbose = verbose
        self.max_preemptions = max_preemptions
        self.stall_limit = stall_limit
        self.watchdog = StepWatchdog(budget_s=watchdog_s)
        self.pool = KP.PagePool(n_pages, page_size)
        self.queue: list[_Pending] = []
        self.slots: list[Optional[_Slot]] = [None] * max_batch
        self.finished: list[FinishedRequest] = []
        self.step_no = 0
        self._next_rid = 0
        self._admit_seq = 0
        self._stall = 0              # consecutive barren steps
        self._draining = False
        self.exec_tier = 0           # index into TIERS; sticky demotion
        self.stats = {"decode_steps": 0, "prefills": 0, "preemptions": 0,
                      "generated": 0, "slot_steps": 0, "active_steps": 0,
                      "page_slot_steps": 0, "gathered_page_steps": 0,
                      "admit_requeues": 0, "tier_demotions": 0,
                      "deadline_evictions": 0, "preempt_failures": 0,
                      "drained": 0, "shadow_checks": 0,
                      "shadow_mismatches": 0, "golden_probes": 0,
                      "golden_mismatches": 0, "health_evictions": 0,
                      "reclaimed_pages": 0, "queue_wait_s": 0.0}
        self.stats.update((k, 0.0) for k in PHASES.values())
        # seconds of the phases closed since the innermost open phase
        # began (``_phase``)
        self._nested_s = 0.0
        # wall seconds of each decode step run() drove (inter-token
        # latency), of each engine-level shadow by phase (from the
        # configured dispatch's return to the verdict, so on the card
        # a decode shadow's includes waiting for the configured step's
        # device work), the largest gap a comparison with the twin
        # decided on (``_agree``; 0 where it compares bitwise), and the
        # golden probe's wall at construction
        self.decode_step_wall_s: list[float] = []
        self.shadow_wall_s = {"prefill": [], "decode": []}
        self.shadow_gap = 0.0
        self.golden_probe_s: Optional[float] = None
        rt = model.rt
        if choose_regime:
            self.regime, self.regime_source, self.regime_times, tiles = (
                self._choose_regime(model))
            ring = rt.mesh is not None and self.regime != "paged-spatial"
            pipe = ring and self.regime == "paged-ring-pipelined"
            if (tiles != rt.paged_block or rt.dist_decode_attn != ring
                    or rt.dist_decode_pipelined != pipe):
                # the tuner's decision is authoritative in both directions
                model = type(model)(
                    model.cfg, dataclasses.replace(
                        rt, paged_block=tiles, dist_decode_attn=ring,
                        dist_decode_pipelined=pipe), device=model.device)
        else:
            if rt.dist_decode_attn and rt.mesh is None:
                raise ValueError("a ring regime (dist_decode_attn) needs a "
                                 "mesh")
            self.regime = ("paged-spatial" if not rt.dist_decode_attn
                           else "paged-ring-pipelined"
                           if rt.dist_decode_pipelined else "paged-ring")
            self.regime_source, self.regime_times = None, {}
        self.model = model
        self.device = dev = model.device
        self._window = int(model.cfg.window or 0)
        self.cache = model.init_paged_cache(n_pages, page_size)
        self._twin = type(model)(
            model.cfg, dataclasses.replace(model.rt, planner=False,
                                           kernel_ops=False),
            device=dev)
        rt = model.rt
        from ..core import planner
        # the planner runs only the configs it can plan; the others
        # serve hand-wired blocks under Runtime(planner=True), as in the
        # JAX package
        self._planned = rt.planner and planner.plannable(model.cfg)
        # the configured tier is bitwise its twin where it computes the
        # twin's numbers: no kernel (nor a kernel's plain version on
        # the CPU), and no stitched glue widened to f32 in a narrower
        # type; elsewhere a shadow is held within SHADOW_REL_TOL
        self._bitwise = not rt.kernel_ops and not (
            self._planned and rt.stitch and model.cfg.dtype != "float32")
        self._rel_tol = SHADOW_REL_TOL.get(
            model.cfg.dtype,
            _sentinels.TOLERANCES.get(model.cfg.dtype, (1e-5, 1e-6))[0])
        # the decode step's inputs, overwritten by every step
        self._tokens = torch.zeros(max_batch, dtype=torch.long, device=dev)
        self._positions = torch.full((max_batch,), -1, dtype=torch.int32,
                                     device=dev)
        self._table = torch.full((max_batch, max_pages_per_seq), -1,
                                 dtype=torch.int32, device=dev)
        self._graphed = (dev.type == "cuda" and not eager_decode
                         and rt.mesh is None)
        self._decode_graph = ("captured" if self._graphed else
                              "eager-mesh" if rt.mesh is not None
                              and dev.type == "cuda" else "eager")
        self.captured = None         # the current tier's graph
        self._captured_gen = -1      # the breaker generation it saw
        self._shadow_graphs = None   # (save, restore, twin) graphs
        if dev.type == "cuda":
            self._build_libraries()
        self.decode_plan = None
        if self._planned:
            # every later decode_step_paged hits the plan memo (and a
            # relaunch replays the ("plan", ..., "decode", page_size,
            # n_ctx) disk record); prefill shapes vary per prompt and
            # are planned, then memoized, on first sight.  A
            # quarantined decode plan is skipped: the layer-level
            # dispatch serves the hand-wired block instead of
            # re-carving a denylisted fingerprint.
            if not _breaker.is_open(self._decode_plan_key()):
                self.decode_plan = planner.plan_model(
                    model.cfg, max_batch, 1, stitch=model.rt.stitch,
                    phase="decode", paged=page_size, kv_len=self.n_ctx)
        self._golden_probe()
        if self._graphed and self.exec_tier < len(TIERS) - 1:
            # captured with every position at -1: the warm-up writes
            # only the scratch page
            self._capture()

    @contextlib.contextmanager
    def _phase(self, name: str):
        """One phase of the step (``PHASES``): its host-only profiler
        event, and its host seconds less those of the phases nested in
        it added to its counter."""
        outer, self._nested_s = self._nested_s, 0.0
        t0 = time.perf_counter()
        try:
            with _RecordFunctionFast(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.stats[PHASES[name]] += dt - self._nested_s
            self._nested_s = outer + dt

    def _build_libraries(self) -> None:
        """Build every CUDA library the configured tier will launch, so
        that a missing toolkit or a failed compile raises here — a
        ``KernelBuildError`` no guard degrades from — before the golden
        probe, the capture or any traffic."""
        from ..kernels import _build
        rt = self.model.rt
        if rt.kernel_ops:
            _build.load("attention_partial")
            if self._planned:
                _build.load("mlp_chain")

    def _decode_plan_key(self) -> tuple:
        from ..core import planner
        return planner.plan_key(
            self.model.cfg, self.max_batch, 1, self.model.rt.stitch,
            phase="decode", paged=self.page_size, kv_len=self.n_ctx)

    def _outputs(self, logits: torch.Tensor) -> tuple:
        """(host part, logits) of a decode step: the host part holds the
        greedy tokens (max_batch,), then under ``Runtime(sentinels=
        True)`` each slot's health flag, so one ``.cpu()`` reads both."""
        host = torch.argmax(logits, dim=-1)
        if self.model.rt.sentinels:
            host = torch.cat([host, _sentinels.healthy(logits).long()])
        return host, logits

    def _step(self, model) -> tuple:
        """One decode step of ``model`` over the static inputs, op by
        op; returns ``_outputs``."""
        logits, _ = model.decode_step_paged(
            self.params, self.cache, self._tokens, self._positions,
            self._table)
        return self._outputs(logits)

    def _tier_model(self, tier: int):
        """The model executing at ``tier``: tiers 1–2 strip the planner
        and the kernels; what remains is the plain paged path,
        bit-identical to tier 0 on f32 configs with stitching off when
        tier 0 launches no kernel."""
        return self.model if tier == 0 else self._twin

    def _decode(self) -> tuple:
        """The current tier's decode step over the static inputs, op by
        op (``captured.replay()`` is the same step from its graph)."""
        return self._step(self._tier_model(self.exec_tier))

    def _capture(self) -> None:
        """Capture the current tier's decode step, dropping the graph of
        the tier before.  The breaker's generation is read after the
        capture: its warm-up may record a failure, and the capture then
        records what the breaker allows."""
        from ..kernels.capture import CapturedStep
        self.captured = None
        self.captured = CapturedStep(self._decode, self.device)
        self._captured_gen = _breaker.BREAKER.generation

    # ------------------------------------------------------------------
    # Tiered execution (configured -> torch twin -> eager twin)
    # ------------------------------------------------------------------
    def _run(self, phase: str, tier: int, args: tuple):
        """One dispatch at ``tier``: prefill returns its logits (1, V),
        decode ``_outputs``.  A captured tier replays its graph, captured
        anew when the breaker recorded a failure since its capture."""
        if phase == "prefill":
            tokens, table, length = args
            logits, _ = self._tier_model(tier).prefill_paged(
                self.params, tokens, self.cache, table, length)
            return logits
        if self._graphed and tier < len(TIERS) - 1:
            if (self.captured is None
                    or self._captured_gen != _breaker.BREAKER.generation):
                self._capture()
            return self.captured.replay()
        return self._step(self._tier_model(tier))

    def _note_tier_failure(self, phase: str, reason: str) -> None:
        """Quarantine what tier 0 was executing before demoting, so a
        relaunch starts on the degraded path instead of re-failing —
        the planned decode plan, the one fingerprint the engine owns.
        ``reason`` is recorded verbatim on the denylist record."""
        if self.exec_tier == 0 and self._planned:
            _breaker.record_failure(self._decode_plan_key(),
                                    reason=f"engine {phase}: {reason}")
        if self.verbose:
            print(f"serving tier demotion on {phase}: "
                  f"{TIERS[self.exec_tier]} -> "
                  f"{TIERS[self.exec_tier + 1]} ({reason})")

    def _demote(self) -> None:
        """One tier down, stickily.  The captured graph is dropped: the
        next decode at a captured tier captures that tier's step."""
        self.exec_tier += 1
        self.stats["tier_demotions"] += 1
        self.captured = None

    def _demote_tier0(self, phase: str, reason: str) -> None:
        """Sticky demotion off the configured tier on a *correctness*
        signal (shadow or golden-probe mismatch) — the crash handler's
        quarantine and rebuild, minus the exception."""
        if self.exec_tier != 0:
            return
        self._note_tier_failure(phase, reason)
        self._demote()

    def _logits(self, phase: str, out) -> torch.Tensor:
        return out if phase == "prefill" else out[1]

    def _serve(self, phase: str, logits: torch.Tensor):
        """The dispatch result carrying ``logits`` in place of the
        step's own (a corrupted or a twin's)."""
        return logits if phase == "prefill" else self._outputs(logits)

    def _rows(self, positions: torch.Tensor, table: torch.Tensor) -> tuple:
        """The pool rows a step at ``positions`` (B, S) writes, and their
        current values: (phys, off, [(k, v) of each layer]) — inactive
        slots and prompt padding on the scratch page."""
        phys, off = KP.slot_coords(table, positions, self.page_size)
        phys, off = phys.long(), off.long()
        return phys, off, [(c["k_pages"][phys, :, off],
                            c["v_pages"][phys, :, off]) for c in self.cache]

    def _restore(self, rows: tuple) -> None:
        phys, off, saved = rows
        for c, (k, v) in zip(self.cache, saved):
            c["k_pages"][phys, :, off] = k
            c["v_pages"][phys, :, off] = v

    def _shadow_decode(self) -> tuple:
        """The twin's decode logits on the static inputs, and the
        callable that puts back the pool rows the twin wrote.  On the
        card the save, the restore and the twin step are each captured
        once in a graph of their own (sharing the pool) and replayed;
        the restore is captured before the twin step, so its warm-up
        writes back the rows just saved, and the twin's warm-up writes
        the rows its replay writes again."""
        rows_of = lambda: self._rows(self._positions[:, None],  # noqa: E731
                                     self._table)
        if not self._graphed:
            rows = rows_of()
            return self._step(self._twin)[1], lambda: self._restore(rows)
        if self._shadow_graphs is None:
            from ..kernels.capture import CapturedStep
            save = CapturedStep(rows_of, self.device)
            save.replay()
            restore = CapturedStep(lambda: self._restore(save.out),
                                   self.device)
            twin = CapturedStep(lambda: self._step(self._twin),
                                self.device)
            self._shadow_graphs = (save, restore, twin)
        else:
            save, restore, twin = self._shadow_graphs
            save.replay()
        return twin.replay()[1], restore.replay

    def _agree(self, got: torch.Tensor, want: torch.Tensor) -> bool:
        """Configured logits against the twin's: bitwise where the
        configured tier runs the twin's own ops, else each row's gap
        from the twin's, relative in the 2-norm, within ``_rel_tol`` —
        per row, so that one request's bad logits are not diluted by
        the others'.  The largest gap is kept in ``shadow_gap``; one
        host sync either way."""
        if self._bitwise:
            return _sentinels.outputs_equal(got, want)
        w = want.float()
        gap = ((got.float() - w).norm(dim=-1)
               / w.norm(dim=-1).clamp(min=1e-30)).max().item()
        self.shadow_gap = max(self.shadow_gap, gap)
        return gap <= self._rel_tol

    def _sentinel_check(self, phase: str, args: tuple, out):
        """Sampled shadow verification of one tier-0 dispatch (``args``:
        a prefill's, or a decode's live slots).  On the sampler's draw
        the twin re-runs the SAME inputs; a mismatch
        quarantines the decode plan (planned path), demotes stickily
        to the twin, and serves the twin's output and pool rows.
        Otherwise the rows the twin wrote are restored to the
        configured tier's, so a shadow never changes a later step."""
        spec = _sentinels.active()
        if spec is None:
            return out
        if _faults.armed():
            logits = self._logits(phase, out)
            bad = _sentinels.corrupt_if_armed(logits, op=f"engine-{phase}")
            if bad is not logits:
                out = self._serve(phase, bad)
        if not spec.sample():
            return out
        self.stats["shadow_checks"] += 1
        t0 = time.perf_counter()
        got = self._logits(phase, out)
        if phase == "decode":
            # live slots only: an inactive slot's logits are never read,
            # and its dead row is zeros from the kernel but the mean of
            # v from the gather twin
            ref, restore = self._shadow_decode()
            live = list(args[0])
            ok = self._agree(got[live], ref[live])
        else:
            tokens, table, length = args
            ar = torch.arange(tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
            rows = self._rows(torch.where(ar < length, ar, -1)[None, :],
                              table)
            ref = self._run(phase, 2, args)
            ok = self._agree(got, ref)
            restore = lambda: self._restore(rows)  # noqa: E731
        spec.note_check(ok)
        if ok:
            restore()
        self.shadow_wall_s[phase].append(time.perf_counter() - t0)
        if ok:
            return out
        self.stats["shadow_mismatches"] += 1
        self._demote_tier0(
            phase, "shadow mismatch: configured output diverged from the "
                   "torch twin on identical inputs")
        return self._serve(phase, ref)

    def _golden_probe(self) -> None:
        """Golden probe at construction: before any traffic, one canned
        decode dispatch runs through the configured tier AND the twin,
        op by op, and must agree.  The dispatch is live (every slot at
        position 0 with only the scratch page in its table), so it
        reaches the decode kernel and writes nothing but the scratch
        page; an all-inactive one would compare the kernel's dead rows
        (zeros) with the twin's (the mean of v).  A mismatch, or a
        probe that raises, quarantines the decode plan and starts the
        engine on the twin tier."""
        spec = _sentinels.active()
        if spec is None or not spec.probe:
            return
        t0 = time.perf_counter()
        self.stats["golden_probes"] += 1
        self._tokens.zero_()
        self._positions.zero_()
        self._table[:, 0] = KP.SCRATCH_PAGE
        try:
            out = self._step(self.model)[1]
            out = _sentinels.corrupt_if_armed(out, op="engine-golden")
            ref = self._step(self._twin)[1]
            ok = self._agree(out, ref)
        except Exception as e:  # noqa: BLE001 - probe failure = mismatch
            if not _breaker.degradable(e):
                raise
            ok = False
            if self.verbose:
                print(f"golden probe raised: {type(e).__name__}: {e}")
        finally:
            self._positions.fill_(-1)
            self._table.fill_(-1)
        spec.note_probe(ok)
        if not ok:
            self.stats["golden_mismatches"] += 1
            self._demote_tier0(
                "decode", "golden probe: canned dispatch diverged from "
                          "the torch twin before serving")
        self.golden_probe_s = time.perf_counter() - t0

    def _exec(self, phase: str, *args):
        """Run one prefill/decode dispatch through the fallback chain.

        A failed dispatch is retried at the next tier on the SAME
        inputs (the pool rows a failed attempt wrote are rewritten by
        the retry), so degradation changes which program computes the
        step, never which step is computed.  A failure the breaker may
        not degrade from raises at every tier."""
        while True:
            try:
                if self.exec_tier == 0:
                    _faults.fault_point("kernel_dispatch",
                                        op=f"engine-{phase}")
                _faults.fault_point("engine_step", op=phase,
                                    tier=self.exec_tier)
                out = self._run(phase, self.exec_tier, args)
                if self.exec_tier == 0:
                    out = self._sentinel_check(phase, args, out)
                return out
            except Exception as e:  # noqa: BLE001 - demote and retry
                if (self.exec_tier >= len(TIERS) - 1
                        or not _breaker.degradable(e)):
                    raise
                self._note_tier_failure(phase, f"{type(e).__name__}: {e}")
                self._demote()

    # ------------------------------------------------------------------
    def _choose_regime(self, model):
        """(regime, schedule source, modelled times by regime, (bq,
        bkv)) of the paged attention tuned for this engine's decode
        shape (q=1 row over the full ``n_ctx`` paged context) — served
        from the persistent schedule cache on warm starts.  Without a
        mesh the one regime is paged-spatial; under one the regime
        search of ``kernels.ops.paged_attention_regime_choice``, whose
        winner every rank must share (``ops._agree``)."""
        from ..core import api
        from ..kernels import ops
        cfg, rt = model.cfg, model.rt
        if rt.mesh is None or not rt.rules.enabled:
            tk = api.fuse_attention_paged(
                1, self.n_ctx, cfg.dh, cfg.dh, page_size=self.page_size,
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                batch=self.max_batch, dtype=cfg.dtype, causal=True)
            regime, times = "paged-spatial", {
                "paged-spatial": tk.report.best_time}
        else:
            choice, _ = ops.paged_attention_regime_choice(
                rt.rules, rt.mesh, batch=self.max_batch,
                q_heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, q_len=1,
                kv_len=self.n_ctx, head_dim=cfg.dh,
                page_size=self.page_size, dtype=cfg.dtype)
            regime, tk, times = choice.regime, choice.kernel, choice.times
            ops._agree(("engine", regime, self.n_ctx, tk.params.bq,
                        tk.params.bkv))
        if self.verbose:
            print(f"paged regime[decode q=1 kv={self.n_ctx}]: {regime} "
                  f"bq={tk.params.bq} bkv={tk.params.bkv} ("
                  + " ".join(f"{k}={v * 1e6:.1f}us"
                             for k, v in times.items())
                  + f" modelled, schedule from {tk.source})")
        return regime, tk.source, dict(times), (tk.params.bq, tk.params.bkv)

    def _page_table(self, allocs) -> torch.Tensor:
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
        self.stats["queue_wait_s"] += time.perf_counter() - pend.queued_s
        with self._phase("engine.prefill"):
            s_pad = math.ceil(plen / self.page_size) * self.page_size
            toks = np.zeros((1, s_pad), np.int64)
            toks[0, :plen] = pend.prompt
            logits = self._exec("prefill", torch.from_numpy(toks).to(
                self.device), self._page_table([alloc]), plen)
            sick = self.model.rt.sentinels and not bool(
                _sentinels.healthy(logits[:1]).all())
            tok = None if sick else int(torch.argmax(logits[0]))
        self.stats["prefills"] += 1
        if sick:
            # activation health monitor: the prefill produced
            # NaN/Inf/exploded logits — evict honestly instead of
            # admitting a request whose every future token is garbage
            alloc.release(self.pool)
            self.stats["health_evictions"] += 1
            self._finish_request(pend.rid, pend.base_prompt_len,
                                 pend.done, pend.submit_step,
                                 pend.n_preempted, "health")
            return True
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

    def _reclaim_window(self) -> None:
        """Sliding-window page reclamation: once a request's next write
        position ``p`` puts every kv slot below ``p - window + 1``
        permanently outside the attention window, the pages wholly
        covered by those slots go back to the pool (kv_pages.py
        ``reclaim_below``).  Bit-identical to keeping them — the window
        mask already rejected those slots — but the freed pages fund
        admission and growth, so long windowed generations stop
        monopolising the pool."""
        if self._window <= 0:
            return
        for slot in self.slots:
            if slot is None:
                continue
            self.stats["reclaimed_pages"] += slot.alloc.reclaim_below(
                slot.pos + 1 - self._window, self.pool)

    # ------------------------------------------------------------------
    def step(self) -> list[FinishedRequest]:
        """One scheduler iteration; returns requests finished in it."""
        n_done = len(self.finished)
        self.step_no += 1
        with self.watchdog.watch(f"step{self.step_no}"), \
                _RecordFunctionFast("engine.step"):
            self._step_inner()
        return self.finished[n_done:]

    def _step_inner(self) -> None:
        with self._phase("engine.schedule"):
            active = self._schedule()
        if not active:
            return
        with self._phase("engine.decode.stage"):
            tokens = np.zeros((self.max_batch,), np.int64)
            positions = np.full((self.max_batch,), -1, np.int32)
            for i in active:
                tokens[i] = self.slots[i].generated[-1]
                positions[i] = self.slots[i].pos
            self._tokens.copy_(torch.from_numpy(tokens))
            self._positions.copy_(torch.from_numpy(positions))
            self._table.copy_(torch.from_numpy(KP.table_array(
                [s.alloc if s is not None else None for s in self.slots],
                self.max_pages)))
        with self._phase("engine.decode.launch"):
            host, _ = self._exec("decode", active)
        with self._phase("engine.decode.wait"):
            host = host.cpu().numpy()
        with self._phase("engine.book"):
            self._book(active, host)

    def _schedule(self) -> list[int]:
        """Deadlines, window reclaim, growth and admission (each
        admitted prompt prefilled); returns the slots the decode step
        runs, none when the step has nothing to decode."""
        self._expire_deadlines()
        self._reclaim_window()
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
        if active:
            self._stall = 0
        elif self.queue and not admitted and not self._draining:
            self._stall += 1
            if self._stall > self.stall_limit:
                raise RuntimeError(
                    "scheduler stalled: pool cannot cover the queue head "
                    "even when idle — shrink prompts or grow n_pages")
        return active

    def _book(self, active: list[int], host: np.ndarray) -> None:
        """The decode step's tokens (and health flags) into its slots."""
        nxt = host[:self.max_batch]
        health = host[self.max_batch:] if self.model.rt.sentinels else None
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += self.max_batch
        self.stats["active_steps"] += len(active)
        self.stats["gathered_page_steps"] += self._read_page_slots(active)
        for i in active:
            slot = self.slots[i]
            self.stats["page_slot_steps"] += sum(
                1 for p in slot.alloc.pages if p != KP.RECLAIMED)
            if health is not None and not health[i]:
                # activation health monitor: this slot's logits went
                # NaN/Inf/exploded — its kv is poisoned, evict with the
                # partial tokens instead of sampling from garbage
                self.stats["health_evictions"] += 1
                self._evict_slot(i, "health")
                continue
            slot.generated.append(int(nxt[i]))
            self._maybe_finish(i)

    def _walks_pages(self) -> bool:
        """Whether the decode step's attention is the paged kernel,
        which walks each request's live pages: the configured tier,
        ``kernel_ops`` on the card, no ring regime."""
        rt = self.model.rt
        return (self.exec_tier == 0 and rt.kernel_ops
                and self.device.type == "cuda" and not rt.dist_decode_attn)

    def _read_page_slots(self, active: list[int]) -> int:
        """The page-table slots the decode step's attention reads: on
        the kernel path each active slot's ``KP.walked_pages`` and none
        of an empty slot; the gather twin and the ring regimes read
        every slot of the table."""
        if not self._walks_pages():
            return self._table.numel()
        return sum(hi - lo for lo, hi in (
            KP.walked_pages(self.slots[i].pos + 1, self.page_size,
                            self._window) for i in active))

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

    def reset(self) -> None:
        """Zero the counters between ``run()`` calls.  With requests in
        flight it warns (``DeprecationWarning``) and drains them first
        (``drain(deadline=0)``): in-flight work is evicted honestly as
        ``outcome="drained"`` before the counters zero."""
        if self.queue or any(s is not None for s in self.slots):
            warnings.warn(
                "reset() with requests in flight is deprecated; "
                "draining them first — call drain() explicitly to "
                "control the deadline", DeprecationWarning,
                stacklevel=2)
            self.drain(deadline=0.0)
        assert self.pool.n_free == self.pool.n_pages - 1
        self.finished = []
        self.step_no = 0
        self._next_rid = 0
        self._stall = 0
        self.watchdog.reset()
        self.decode_step_wall_s = []
        for k in self.stats:
            self.stats[k] = 0

    def run(self, requests) -> tuple[list[FinishedRequest], dict]:
        """Drive ``step()`` until every submitted request finishes.

        requests: iterable of (prompt, max_new).  Returns results in
        submission order plus a stats dict (wall seconds, tokens/s, the
        step counters, the execution tier, the watchdog's readings and
        the wall of each decode step)."""
        for prompt, max_new in requests:
            self.submit(prompt, max_new)
        t0 = time.perf_counter()
        while self.queue or any(s is not None for s in self.slots):
            before = self.stats["decode_steps"]
            ts = time.perf_counter()
            self.step()
            if self.stats["decode_steps"] > before:
                # a step that ran the batched decode: its wall time is
                # the inter-token latency every active slot just paid
                self.decode_step_wall_s.append(time.perf_counter() - ts)
        dt = time.perf_counter() - t0
        out = sorted(self.finished, key=lambda r: r.rid)
        stats = dict(self.stats)
        stats["wall_s"] = dt
        stats["tok_per_s"] = stats["generated"] / dt if dt > 0 else 0.0
        stats["exec_tier"] = TIERS[self.exec_tier]
        stats["regime"] = self.regime
        stats["decode_graph"] = self._decode_graph
        stats["watchdog_breaches"] = self.watchdog.breaches
        stats["max_step_s"] = self.watchdog.max_step_s
        stats["decode_step_wall_s"] = list(self.decode_step_wall_s)
        return out, stats
