"""One run of one cell: set-up, the measured window, the traced stretch.

The window drives ``repro_torch.serving.engine.ServingEngine`` through
``submit()`` and ``step()`` and stamps each ``step()``'s start and
return on the host clock.  After each return it reads, for every
request in the engine, how many tokens it now holds; a request that
gained tokens in a step is served at that step's return.  Nothing of
the engine's own timing (``run()``'s walls) is used.

Set-up, timed by ``setup_s``: the weights, the engine (its tuned decode
tiles, its plan and its captured decode step), one prefill at every
padded prompt length the window can admit and a few replayed decode
steps (then the engine is reset), and, for a closed loop whose clients
start mid-generation, the admission of every client's first request.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import typing
from typing import Optional

import numpy as np
import torch

from . import traffic as TR

#: The host activities the trace reduction names idle gaps after.
SPANS = ("harness.step", "harness.wait", "harness.book")


@dataclasses.dataclass
class StepRec:
    t0: float                    # host seconds, step() called
    t1: float                    # host seconds, step() returned
    prefills: list               # context length of each prompt admitted
    decode_keys: list            # keys each decoded token's query read
    gained: int                  # tokens the step gave
    traced: bool = False


@dataclasses.dataclass
class Served:
    """One request as the window saw it."""
    req: TR.Request
    rid: int
    submit_s: float              # host seconds it was submitted
    due_s: Optional[float]       # host seconds it was due (open loop)
    events: list = dataclasses.field(default_factory=list)  # (t, gained)
    tokens: list = dataclasses.field(default_factory=list)
    outcome: Optional[str] = None


@dataclasses.dataclass
class Run:
    """What a run measured, handed to the metric readers."""
    cell: object
    model: dict
    seconds: float
    t_start: float               # window opened (host seconds)
    t_end: float                 # window closed
    steps: list                  # StepRec of steps returning in the window
    steps_all: list              # every step the window loop made (the
    #                              last returns after the close)
    served: list                 # Served, every request in the window
    stats: dict                  # the engine's counters over the window
    launches: dict               # kernel launches over the window
    fused_prefill: set           # padded lengths whose prefill ran the MLP
    #                              kernel (seen in the warm-up)
    trace: Optional[object] = None
    notes: dict = dataclasses.field(default_factory=dict)
    # open loop: every Request the mix made, submitted or not
    offered: list = dataclasses.field(default_factory=list)

    @property
    def traced_steps(self) -> list:
        return [s for s in self.steps_all if s.traced]


def model_config(m: dict):
    """The program's ``ModelConfig`` from a configuration file's
    ``model`` dict: a field declared as a dataclass, or an ``Optional``
    of one, is built from its dict, and a JSON list becomes a tuple."""
    from repro_torch.models.config import ModelConfig
    return _dataclass(ModelConfig, m)


def _dataclass(cls, d: dict):
    hints = typing.get_type_hints(cls)
    return cls(**{k: _field(hints.get(k), v) for k, v in d.items()})


def _field(hint, v):
    if isinstance(v, list):
        return tuple(_field(None, x) for x in v)
    if isinstance(v, dict):
        for cls in (hint, *typing.get_args(hint)):
            if dataclasses.is_dataclass(cls):
                return _dataclass(cls, v)
    return v


def build_engine(cell, params, device):
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.serving.engine import ServingEngine
    cfg = model_config(cell.config["model"])
    model = LM(cfg, Runtime(**cell.config["runtime"]), device=device)
    return ServingEngine(model, params, **cell.config["engine"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launches() -> dict:
    from repro_torch.kernels import capture
    return capture.snapshot()


def _memos() -> tuple:
    from repro_torch.core import api, planner
    return set(api._CACHE), set(planner._PLAN_MEMO)


def warm(engine, lengths: list, vocab: int, device) -> set:
    """One prefill at each padded length (greedy budget of one token, so
    each finishes at admission) and a few replayed decode steps, then
    the engine's counters reset.  Returns the lengths whose prefill
    launched the fused MLP kernel."""
    fused = set()
    rng = np.random.default_rng(0)
    for n in lengths:
        before = _launches()["fused_mlp_chain"]
        engine.submit(rng.integers(0, vocab, n), 1)
        engine.step()
        _sync(device)
        if _launches()["fused_mlp_chain"] > before:
            fused.add(n)
    for _ in range(engine.max_batch):
        engine.submit(rng.integers(0, vocab, lengths[0]), 4)
    while engine.queue or any(s is not None for s in engine.slots):
        engine.step()
    _sync(device)
    engine.reset()
    return fused


class _Tracker:
    """Per-request token counts after every step, and the step's record."""

    def __init__(self, engine):
        self.engine = engine
        self.by_rid: dict = {}

    def add(self, s: Served) -> None:
        self.by_rid[s.rid] = s

    def after_step(self, t0: float, t1: float, finished: list) -> StepRec:
        now = {}
        for slot in self.engine.slots:
            if slot is not None:
                now[slot.rid] = slot.generated
        for fr in finished:
            now[fr.rid] = fr.tokens
            self.by_rid[fr.rid].outcome = fr.outcome
        rec = StepRec(t0, t1, [], [], 0)
        for rid, toks in now.items():
            s = self.by_rid[rid]
            old = len(s.tokens)
            if len(toks) <= old:
                continue
            ctx = len(s.req.prompt)
            if old == 0:
                rec.prefills.append(ctx)
            for g in range(max(old, 1), len(toks)):
                # the g-th token (0-based) came from a decode whose query
                # sat at position ctx + g - 1
                rec.decode_keys.append(ctx + g)
            rec.gained += len(toks) - old
            s.tokens = list(toks)
            s.events.append((t1, len(toks) - old))
        return rec


def _open_loop_submit(engine, tracker, pending, t_start, now, served):
    while pending and t_start + pending[0].due_s <= now:
        r = pending.pop(0)
        rid = engine.submit(r.prompt, r.max_new)
        s = Served(r, rid, time.perf_counter(), t_start + r.due_s)
        tracker.add(s)
        served.append(s)


def run_window(cell, engine, reqs, seconds: float, trace: bool, device,
               tracker: _Tracker, served: list) -> tuple:
    """Drive the engine for ``seconds``; returns (t_start, t_end, steps
    returning inside the window, every step made, the traced stretch or
    None)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    mix = cell.traffic
    closed = mix["loop"] == "closed"
    queues = {}
    pending = []
    if closed:
        for r in reqs:
            queues.setdefault(r.client, []).append(r)
    else:
        pending = list(reqs)
    steps, steps_all = [], []
    prof = None
    stretch = min(3.0, 0.25 * seconds)
    t_prof = None
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if trace and prof is None and now >= t_end - stretch:
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            t_prof = time.perf_counter()
        if not closed:
            with record_function("harness.book"):
                _open_loop_submit(engine, tracker, pending, t_start, now,
                                  served)
        if not engine.queue and all(s is None for s in engine.slots):
            # nothing to serve until the next arrival (a closed loop's
            # callers are never all idle unless their requests ran out)
            with record_function("harness.wait"):
                nxt = min(t_start + pending[0].due_s if pending else t_end,
                          t_end if prof is not None or not trace
                          else t_end - stretch)
                while time.perf_counter() < nxt:
                    time.sleep(2e-4)
            continue
        t0 = time.perf_counter()
        with record_function("harness.step"):
            finished = engine.step()
        t1 = time.perf_counter()
        with record_function("harness.book"):
            rec = tracker.after_step(t0, t1, finished)
            rec.traced = prof is not None
            steps_all.append(rec)
            if t1 <= t_end:
                steps.append(rec)
            if closed:
                for fr in finished:
                    client = tracker.by_rid[fr.rid].req.client
                    if queues.get(client):
                        r = queues[client].pop(0)
                        rid = engine.submit(r.prompt, r.max_new)
                        s = Served(r, rid, t1, None)
                        tracker.add(s)
                        served.append(s)
    span = None
    if prof is not None:
        _sync(device)
        t_stop = time.perf_counter()
        prof.stop()
        span = (prof, t_stop - t_prof)
    return t_start, t_end, steps, steps_all, span


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> tuple:
    """One run; returns (Run, params) with the engine freed, the
    weights (the benchmark's) kept for the reference."""
    from . import weights
    m = cell.config["model"]
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_process)]
    if trace and device.type == "cuda":
        # the profiler's first start initialises the device tracing
        # (seconds); pay it here, not inside the traced stretch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            _sync(device)
        marks.append(("profiler", time.perf_counter()))
    params = weights.make(cell.arch, m, seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    engine = build_engine(cell, params, device)
    marks.append(("engine", time.perf_counter()))
    n_ctx = engine.n_ctx
    reqs = TR.generate(cell.traffic, m["vocab"], seed, seconds, n_ctx)
    closed = cell.traffic["loop"] == "closed"
    c = int(cell.traffic.get("clients", 0))
    window_reqs = reqs[c:] if closed else reqs
    fused = warm(engine, TR.padded_lengths(window_reqs, engine.page_size),
                 m["vocab"], device)
    marks.append(("warm-up", time.perf_counter()))
    tracker = _Tracker(engine)
    served = []
    if closed:
        firsts = reqs[:c]
        for r in firsts:
            rid = engine.submit(r.prompt, r.max_new)
            s = Served(r, rid, time.perf_counter(), None)
            tracker.add(s)
            served.append(s)
        t0 = time.perf_counter()
        tracker.after_step(t0, t0, engine.step())
        queued = reqs[c:]
    else:
        queued = reqs
    _sync(device)
    marks.append(("first requests", time.perf_counter()))
    stats0 = dict(engine.stats)
    launches0 = _launches()
    memo0 = _memos()
    setup_s = time.perf_counter() - t_process
    t_start, t_end, steps, steps_all, span = run_window(
        cell, engine, queued, seconds, trace, device, tracker, served)
    _sync(device)
    memo1 = _memos()
    from repro_torch.core import api, schedule_cache
    new_tuned = memo1[0] - memo0[0]
    notes = {
        "setup_s": setup_s,
        "setup_parts": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])},
        "searched_in_window": sum(1 for k in new_tuned
                                  if api._CACHE[k].source == "search"),
        "tuned_in_window": len(new_tuned),
        "planned_in_window": len(memo1[1] - memo0[1]),
        "exec_tier": engine.exec_tier,
        "deny_records": len(schedule_cache.list_quarantined()),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
        "in_flight_at_end": sum(s is not None for s in engine.slots),
        "queued_at_end": len(engine.queue),
        "page_size": engine.page_size,
    }
    stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()}
    launches1 = _launches()
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    if not closed:
        late = [s.submit_s - s.due_s for s in served]
        notes["late_max_s"] = max(late) if late else 0.0
        notes["late_p95_s"] = float(np.percentile(late, 95)) if late else 0.0
    run = Run(cell, m, seconds, t_start, t_end, steps, steps_all, served,
              stats, launches, fused, span, notes,
              [] if closed else list(reqs))
    del engine, tracker
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, params
