"""The port's reliability layer (``repro_torch.reliability``) against the
JAX package's (``repro.reliability``).

One counterpart of each test of ``tests/test_reliability.py``, on the
port at qwen3 SMOKE on the CPU with the reference's engine geometry
(``ENG_KW``) and a hermetic cache directory per test: the deterministic
fault registry, the circuit breaker's persistent quarantine (keyed
under ``H100``), the step watchdog, the engine's hardening and tiers,
the chaos suite, the schedule cache's hardening, the sentinels and the
warm-load probes.  Then parity with the JAX package where both are
deterministic: the same injection fires on the same ordinals, the
shadow sampler draws the same ordinals, and for each of the six fault
kinds ``run_chaos`` gives the reference's outcome (fired, the tokens of
every phase, the reliability counters) with the reference's weights
carried over (``models.convert``).  Last, no guard degrades from
anything but an injected fault or a launch the card refused: not from
a kernel that does not build, a sticky CUDA error, a wrapper's own
``ValueError``, a bug or running out of memory.
"""
import glob
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import api, planner, schedule_cache  # noqa: E402
from repro_torch.core.perf_model import H100  # noqa: E402
from repro_torch.kernels._build import (KernelBuildError,  # noqa: E402
                                        KernelLaunchError)
from repro_torch.models.lm import LM, Runtime  # noqa: E402
from repro_torch.reliability import (breaker, chaos, faults,  # noqa: E402
                                     sentinels)
from repro_torch.reliability.faults import InjectedFault  # noqa: E402
from repro_torch.reliability.watchdog import StepWatchdog  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

CFG = get_config("qwen3_8b", smoke=True)


def _reset_port():
    faults.clear()
    breaker.reset()
    sentinels.disable()
    planner.clear_memo()
    api.clear_cache()


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    """Every test gets an empty cache dir (the reference one beside it)
    and clean registry/breaker/sentinel state — chaos runs must never
    leak quarantine records into each other."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    _reset_port()
    yield tmp_path
    _reset_port()


@pytest.fixture(scope="module")
def _model():
    model = LM(CFG, device="cpu")
    return model, model.init_params(0)


ENG_KW = dict(max_batch=2, page_size=4, n_pages=16, max_pages_per_seq=4,
              choose_regime=False)


def _prompt(n):
    return np.arange(n, dtype=np.int64) % CFG.vocab


# ---------------------------------------------------------------------------
# fault registry
# ---------------------------------------------------------------------------

def test_registry_is_deterministic():
    def pattern(seed):
        faults.inject("engine_step", rate=0.3, seed=seed)
        out = [faults.check("engine_step") for _ in range(50)]
        faults.clear("engine_step")
        return out

    a, b = pattern(7), pattern(7)
    assert a == b                      # same seed -> same firing
    assert any(a) and not all(a)       # rate actually thins
    assert pattern(8) != a             # seed is live


def test_nth_fires_exactly_once():
    spec = faults.inject("page_exhaustion", nth=2)
    assert [faults.check("page_exhaustion") for _ in range(6)] \
        == [False, False, True, False, False, False]
    assert spec.n_fired == 1 and spec.n_seen == 6


def test_trigger_and_context():
    faults.inject("cache_corrupt",
                  trigger=lambda ctx: "bad" in ctx.get("path", ""))
    assert not faults.check("cache_corrupt", path="/ok.json")
    assert faults.check("cache_corrupt", path="/bad.json")
    with pytest.raises(InjectedFault) as ei:
        faults.fault_point("cache_corrupt", path="really bad")
    assert ei.value.kind == "cache_corrupt"


def test_unknown_kind_rejected():
    with pytest.raises(ValueError):
        faults.inject("disk_on_fire")
    assert not faults.check("engine_step")  # nothing armed: free


# ---------------------------------------------------------------------------
# circuit breaker + persistent quarantine
# ---------------------------------------------------------------------------

def test_breaker_opens_and_survives_relaunch():
    key = ("attn", 128, 128, 64, 64, 4, 1, "float32", True, 0)
    assert not breaker.is_open(key)
    assert breaker.record_failure(key, reason="lowering failed")
    assert breaker.is_open(key)
    # "relaunch": a fresh in-process breaker sees the disk denylist,
    # filed under the H100 descriptor every record of the port uses
    fresh = breaker.CircuitBreaker()
    assert fresh.is_open(key)
    rec = schedule_cache.is_quarantined(key, H100)
    assert rec is not None and "lowering failed" in rec["reason"]
    # operator override lifts it
    assert schedule_cache.clear_quarantine(key, H100)
    assert not breaker.CircuitBreaker().is_open(key)


def test_quarantine_is_not_deletion(tmp_path):
    """The denylist record leaves the cached entry readable — skipping
    happens at dispatch, so lifting the quarantine costs no retune."""
    tk = api.fuse_gemm_chain(512, 512, 128, 128, dtype="bfloat16")
    key = ("plan-ish", "whatever")
    schedule_cache.quarantine(key, H100, reason="x")
    assert schedule_cache.is_quarantined(key, H100) is not None
    api.clear_cache()
    warm = api.fuse_gemm_chain(512, 512, 128, 128, dtype="bfloat16")
    assert warm.source == "disk"     # entry untouched by the denylist
    assert tk.report.best.key() == warm.report.best.key()
    assert len(schedule_cache.list_quarantined()) == 1


def _mlp_inputs():
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((32, 16), (16, 32), (32, 16))]


MLP_FP = ("mlp", 32, 32, 16, "float32", False, "silu")


def test_guarded_kernel_tail_degrades_to_ref():
    """ops-level tier: an injected dispatch fault on the fused MLP tail
    returns the torch twin's exact output and opens the breaker; the
    next call routes straight to the twin without the fault armed."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlp_chain_ref
    x, wu, wd = _mlp_inputs()
    want = mlp_chain_ref(x, wu, wd)
    with faults.injected("kernel_dispatch", nth=0):
        got = ops.mlp_chain(x, wu, wd)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # IS the twin
    assert breaker.is_open(MLP_FP)
    again = ops.mlp_chain(x, wu, wd)
    torch.testing.assert_close(again, want, rtol=0, atol=0)


def test_watchdog_counts_breaches():
    wd = StepWatchdog(budget_s=0.0)
    with wd.watch("s1"):
        pass
    assert wd.breaches == 1 and wd.max_step_s > 0.0
    calm = StepWatchdog()          # no budget: observe only
    with calm.watch("s1"):
        pass
    assert calm.breaches == 0 and calm.n_steps == 1


# ---------------------------------------------------------------------------
# engine hardening
# ---------------------------------------------------------------------------

def test_admission_requeues_on_alloc_failure(_model):
    model, params = _model
    eng = ServingEngine(model, params, **ENG_KW)
    eng.submit(_prompt(5), 3)
    with faults.injected("page_exhaustion", nth=0):
        eng.step()                 # admission alloc denied -> requeue
    assert eng.stats["admit_requeues"] == 1
    assert len(eng.queue) == 1 and eng.pool.n_free == eng.pool.n_pages - 1
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()                 # fault disarmed: admits and finishes
    (res,) = eng.finished
    assert res.outcome == "complete" and len(res.tokens) == 3


def test_deadline_evicts_running_request(_model):
    model, params = _model
    eng = ServingEngine(model, params, **ENG_KW)
    eng.submit(_prompt(4), 10, deadline_steps=3)
    results, stats = eng.run([])
    (res,) = results
    assert res.outcome == "deadline"
    assert 0 < len(res.tokens) < 10    # honest partial tokens
    assert stats["deadline_evictions"] == 1
    assert eng.pool.n_free == eng.pool.n_pages - 1


def test_deadline_evicts_queued_request(_model):
    model, params = _model
    eng = ServingEngine(model, params, max_batch=1, page_size=4,
                        n_pages=16, max_pages_per_seq=4,
                        choose_regime=False)
    p = _prompt(4)
    eng.submit(p, 8)                        # hogs the only slot
    eng.submit(p, 8, deadline_steps=2)      # starves in the queue
    results, stats = eng.run([])
    by_rid = {r.rid: r for r in results}
    assert by_rid[0].outcome == "complete" and len(by_rid[0].tokens) == 8
    assert by_rid[1].outcome == "deadline" and by_rid[1].tokens == []
    assert stats["deadline_evictions"] == 1


def test_preemption_budget_fails_honestly(_model):
    model, params = _model
    eng = ServingEngine(model, params, max_preemptions=0, **ENG_KW)
    eng.submit(_prompt(4), 10)
    eng.step()
    idx = next(i for i, s in enumerate(eng.slots) if s is not None)
    eng._preempt(idx)              # budget 0: fails instead of requeue
    (res,) = eng.finished
    assert res.outcome == "preempt_budget" and res.n_preempted == 1
    assert len(res.tokens) >= 1    # partial output reported
    assert eng.stats["preempt_failures"] == 1
    assert not eng.queue and eng.pool.n_free == eng.pool.n_pages - 1


def test_drain_finishes_in_flight_and_fails_queued(_model):
    model, params = _model
    eng = ServingEngine(model, params, max_batch=1, page_size=4,
                        n_pages=16, max_pages_per_seq=4,
                        choose_regime=False)
    p = _prompt(4)
    eng.submit(p, 6)
    eng.submit(p, 6)
    eng.step()                     # rid 0 in flight, rid 1 queued
    drained = eng.drain()
    by_rid = {r.rid: r for r in drained}
    assert by_rid[0].outcome == "complete" and len(by_rid[0].tokens) == 6
    assert by_rid[1].outcome == "drained" and by_rid[1].tokens == []
    assert eng.stats["drained"] == 1
    assert eng.pool.n_free == eng.pool.n_pages - 1
    # drain is idempotent and the engine stays usable
    assert eng.drain() == []
    eng.submit(p, 2)
    results, _ = eng.run([])
    assert results[-1].outcome == "complete"


def test_drain_deadline_zero_evicts_in_flight(_model):
    model, params = _model
    eng = ServingEngine(model, params, **ENG_KW)
    eng.submit(_prompt(4), 10)
    eng.step()
    drained = eng.drain(deadline=0.0)
    (res,) = drained
    assert res.outcome == "drained" and 1 <= len(res.tokens) < 10
    assert eng.pool.n_free == eng.pool.n_pages - 1


def test_reset_in_flight_warns_and_drains(_model):
    model, params = _model
    eng = ServingEngine(model, params, **ENG_KW)
    eng.submit(_prompt(4), 10)
    eng.step()
    with pytest.warns(DeprecationWarning, match="drain"):
        eng.reset()
    assert eng.finished == [] and eng.step_no == 0
    assert all(v == 0 for v in eng.stats.values())
    assert eng.pool.n_free == eng.pool.n_pages - 1


def test_stall_is_bounded_not_instant(_model):
    """Persistent allocation failure raises only after stall_limit
    consecutive barren steps — transient faults recover, genuine
    geometry stalls still surface instead of livelocking."""
    model, params = _model
    eng = ServingEngine(model, params, stall_limit=3, **ENG_KW)
    eng.submit(_prompt(4), 2)
    with faults.injected("page_exhaustion"):     # always fires
        for _ in range(3):
            eng.step()             # barren but tolerated
        with pytest.raises(RuntimeError, match="stalled"):
            eng.step()
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()                 # disarmed: recovers the same engine
    assert eng.finished and eng.finished[0].outcome == "complete"


def test_tier_chain_reaches_eager_twin(_model):
    """Two stacked dispatch failures demote configured -> torch-twin ->
    eager-twin; tokens match the healthy run bit-for-bit."""
    model, params = _model
    reqs = [(_prompt(5), 4)]
    base, _ = ServingEngine(model, params, **ENG_KW).run(list(reqs))
    eng = ServingEngine(model, params, **ENG_KW)
    with faults.injected("kernel_dispatch", nth=0):
        with faults.injected("engine_step", nth=0):
            results, stats = eng.run(list(reqs))
    assert stats["exec_tier"] == "eager-twin"
    assert stats["tier_demotions"] == 2
    assert [r.tokens for r in results] == [r.tokens for r in base]


# ---------------------------------------------------------------------------
# chaos acceptance: one fault class at a time, tokens bit-identical
# ---------------------------------------------------------------------------

def _decode_plan_key():
    return planner.plan_key(CFG, 3, 1, False, phase="decode", paged=4,
                            kv_len=32)


def test_chaos_kernel_dispatch_quarantines_and_replays():
    out = chaos.run_chaos("kernel_dispatch", {"nth": 0}, planner=True,
                          device="cpu")
    assert out.fired == 1
    assert out.tokens_identical
    assert out.faulted_stats["tier_demotions"] == 1
    # the decode plan fingerprint is denylisted on disk ...
    assert schedule_cache.is_quarantined(_decode_plan_key(), H100) \
        is not None
    # ... and the relaunch never touched it: healthy tier, no demotion,
    # no decode plan in the fresh memo (prefill plans replay fine)
    assert out.relaunch_stats["exec_tier"] == "configured"
    assert out.relaunch_stats["tier_demotions"] == 0
    assert out.relaunch_engine.decode_plan is None
    assert all(k[8] != "decode" for k in planner._PLAN_MEMO)
    assert any(k[8] == "prefill" for k in planner._PLAN_MEMO)


def test_chaos_cache_corruption_quarantines_file(tmp_path):
    out = chaos.run_chaos("cache_corrupt", {"nth": 0},
                          choose_regime=True, device="cpu")
    assert out.fired == 1
    assert out.tokens_identical
    corrupt = glob.glob(str(tmp_path / "*.corrupt"))
    assert len(corrupt) == 1       # evidence preserved, not deleted
    # the retuned replacement landed at the original path and the
    # relaunch replayed it without another quarantine
    assert out.relaunch_stats["tier_demotions"] == 0
    assert out.relaunch_engine.regime_source == "disk"


def test_chaos_plan_load_quarantines_record(tmp_path):
    out = chaos.run_chaos("plan_load", {"nth": 0}, planner=True,
                          device="cpu")
    assert out.fired == 1
    assert out.tokens_identical
    assert len(glob.glob(str(tmp_path / "*.corrupt"))) == 1
    assert out.relaunch_stats["tier_demotions"] == 0


def test_chaos_page_exhaustion_backs_off():
    out = chaos.run_chaos("page_exhaustion", {"nth": 2}, device="cpu")
    assert out.fired == 1
    assert out.tokens_identical
    assert (out.faulted_stats["admit_requeues"]
            + out.faulted_stats["preemptions"]) >= 1


# ---------------------------------------------------------------------------
# schedule-cache hardening details the chaos suite leans on
# ---------------------------------------------------------------------------

def test_corrupt_plan_quarantined_to_corrupt_file(tmp_path):
    key = planner.plan_key(CFG, 2, 64, True)
    schedule_cache.store_plan(key, H100, {"version": 1})
    path = schedule_cache.plan_entry_path(key, H100)
    path.write_text('{"schema": 2, "trunc')
    assert schedule_cache.load_plan(key, H100) is None
    assert not path.exists()
    evidence = path.with_name(path.name + ".corrupt")
    assert evidence.exists()
    assert evidence.read_text().startswith('{"schema": 2, "trunc')


def test_mangled_plan_payload_quarantined_and_recarved(tmp_path):
    """A plan record that parses as JSON but whose payload is mangled
    is quarantined by plan_model (not silently re-carved forever) and
    a fresh record lands at the original path."""
    plan = planner.plan_model(CFG, 2, 16, stitch=False)
    key = planner.plan_key(CFG, 2, 16, False)
    path = schedule_cache.plan_entry_path(key, H100)
    rec = json.loads(path.read_text())
    rec["plan"] = {"version": planner.PLANNER_VERSION}  # fields gone
    path.write_text(json.dumps(rec))

    planner.clear_memo()
    replanned = planner.plan_model(CFG, 2, 16, stitch=False)
    assert replanned == plan               # deterministic re-carve
    evidence = path.with_name(path.name + ".corrupt")
    assert evidence.exists()               # mangled bytes preserved
    assert path.exists()                   # fresh record, same path
    planner.clear_memo()
    assert planner.plan_model(CFG, 2, 16, stitch=False) == plan


def test_stale_schema_is_not_quarantined(tmp_path):
    """A valid record from an older schema is a miss, not corruption —
    it must stay in place, not be renamed to *.corrupt."""
    key = planner.plan_key(CFG, 2, 64, True)
    schedule_cache.store_plan(key, H100, {"version": 1})
    path = schedule_cache.plan_entry_path(key, H100)
    rec = json.loads(path.read_text())
    rec["schema"] = schedule_cache.SCHEMA_VERSION - 1
    path.write_text(json.dumps(rec))
    assert schedule_cache.load_plan(key, H100) is None
    assert path.exists()
    assert not glob.glob(str(tmp_path / "*.corrupt"))


def test_concurrent_plan_writers_race_same_key(tmp_path):
    """N threads hammering store_plan on one key: the surviving record
    is one complete payload (atomic replace + advisory lock), never a
    torn mix, and no temp files leak."""
    key = planner.plan_key(CFG, 4, 128, True)
    n = 8
    barrier = threading.Barrier(n)

    def write(i):
        barrier.wait(timeout=30)
        for _ in range(10):
            schedule_cache.store_plan(key, H100,
                                      {"version": 1, "writer": i,
                                       "pad": "x" * (1000 + i)})

    threads = [threading.Thread(target=write, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    rec = schedule_cache.load_plan(key, H100)
    assert rec is not None and rec["version"] == 1
    w = rec["writer"]
    assert rec["pad"] == "x" * (1000 + w)    # payload internally whole
    assert not list(tmp_path.glob("*.tmp"))
    assert not glob.glob(str(tmp_path / "*.corrupt"))


# ---------------------------------------------------------------------------
# correctness sentinels: shadow verification, golden probes, health
# ---------------------------------------------------------------------------

def test_shadow_sampler_is_deterministic():
    def pattern(seed, rate=0.25, n=200):
        spec = sentinels.SentinelSpec(rate=rate, seed=seed)
        return [spec.sample() for _ in range(n)]

    a, b = pattern(3), pattern(3)
    assert a == b                      # same seed -> same ordinals
    assert any(a) and not all(a)       # rate actually thins
    assert pattern(4) != a             # seed is live
    assert 20 <= sum(a) <= 80          # ~rate * n, deterministic
    assert all(sentinels.SentinelSpec(rate=1.0).sample()
               for _ in range(10))
    assert not any(sentinels.SentinelSpec(rate=0.0).sample()
                   for _ in range(10))
    with pytest.raises(ValueError):
        sentinels.enable(rate=1.5)
    assert sentinels.active() is None  # failed enable arms nothing


def test_shadow_catches_wrong_answer_at_kernel_seam():
    """wrong_answer perturbs the fused MLP output without raising; the
    armed shadow sampler re-runs the torch twin, serves ITS values on
    the detecting call, and quarantines the fingerprint on disk."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlp_chain_ref
    x, wu, wd = _mlp_inputs()
    want = mlp_chain_ref(x, wu, wd)
    with sentinels.shadowing(1.0) as sp:
        with faults.injected("wrong_answer", rate=1.0) as spec:
            got = ops.mlp_chain(x, wu, wd)
        assert spec.n_fired >= 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # twin's output
    assert sp.n_checked == 1 and sp.n_mismatched == 1
    assert breaker.is_open(MLP_FP)
    assert schedule_cache.is_quarantined(MLP_FP, H100) is not None
    # without the sentinels armed the corruption would have sailed
    # through: the crash path sees no exception (lift the quarantine
    # first — an open breaker routes to the twin and would mask it)
    faults.clear()
    schedule_cache.clear_quarantine(MLP_FP, H100)
    breaker.reset()
    with faults.injected("wrong_answer", rate=1.0):
        silent = ops.mlp_chain(x, wu, wd)
    assert not torch.allclose(silent, want)


def test_kernel_shadow_compares_the_rows_read():
    """``rows`` limits a kernel-level shadow to the rows its caller
    reads: a row that differs outside them (the paged kernel's row of
    an inactive slot, zeros against the twin's mean of v) is no
    mismatch; unmasked, the same outputs are one."""
    out = torch.ones(3, 4, dtype=torch.bfloat16)
    ref = out.clone()
    ref[2] = 0.5
    fp = ("attn-paged", 3)
    with sentinels.shadowing(1.0) as spec:
        read = sentinels.shadow_kernel(
            fp, out, lambda: ref, lambda: torch.tensor([True, True, False]))
        assert read is out
        assert spec.n_mismatched == 0 and not breaker.is_open(fp)
        assert sentinels.shadow_kernel(fp, out, lambda: ref) is ref
        assert spec.n_mismatched == 1 and breaker.is_open(fp)


def test_sentinels_no_fault_bit_identical(_model):
    """Sentinels armed at rate 1.0 with no fault: every engine dispatch
    shadow-verified, zero mismatches, and the served tokens are
    bit-identical to a sentinel-free run — the pool rows a shadow's
    twin wrote are put back."""
    model, params = _model
    reqs = [(_prompt(5), 4), (_prompt(7), 6)]
    base, _ = ServingEngine(model, params, **ENG_KW).run(list(reqs))
    with sentinels.shadowing(1.0):
        eng = ServingEngine(model, params, **ENG_KW)
        res, stats = eng.run(list(reqs))
    assert [r.tokens for r in res] == [r.tokens for r in base]
    assert stats["golden_probes"] == 1
    assert stats["golden_mismatches"] == 0
    assert stats["shadow_checks"] == (stats["decode_steps"]
                                      + stats["prefills"])
    assert stats["shadow_mismatches"] == 0
    assert stats["exec_tier"] == "configured"
    assert eng._bitwise and eng.shadow_gap == 0.0   # as configured
    assert (len(eng.shadow_wall_s["prefill"]), len(eng.shadow_wall_s[
        "decode"])) == (stats["prefills"], stats["decode_steps"])


def _pool_equal(a, b) -> bool:
    """Two engines' KV pools equal bitwise past the scratch page."""
    return all(torch.equal(x[k][1:], y[k][1:]) for x, y in zip(a.cache,
                                                               b.cache)
               for k in ("k_pages", "v_pages"))


def test_shadow_restores_the_pool_rows(_model, monkeypatch):
    """Where the twin's rows differ from the configured tier's (the MLP
    kernel's plain version against the unfused MLP), shadows at rate
    1.0 still leave the disarmed run's pool bitwise: each shadow puts
    back the rows its twin wrote.  Without the restore they differ."""
    _, params = _model
    model = LM(CFG, Runtime(kernel_ops=True, planner=True), device="cpu")
    reqs = [(_prompt(5), 4), (_prompt(7), 6), (_prompt(3), 5)]
    base = ServingEngine(model, params, **ENG_KW)
    want, _ = base.run(list(reqs))
    with sentinels.shadowing(1.0):
        eng = ServingEngine(model, params, **ENG_KW)
        got, stats = eng.run(list(reqs))
    assert stats["shadow_mismatches"] == 0 and stats["shadow_checks"] > 0
    assert eng.shadow_gap > 0                  # the twin is not bitwise
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert _pool_equal(eng, base)
    monkeypatch.setattr(ServingEngine, "_restore", lambda self, rows: None)
    with sentinels.shadowing(1.0):
        unrestored = ServingEngine(model, params, **ENG_KW)
        unrestored.run(list(reqs))
    assert not _pool_equal(unrestored, base)


def test_shadow_judges_each_request_apart(_model, monkeypatch):
    """Where the engine compares within a relative gap (a configured
    tier that runs kernels), the gap is taken per request: a decode
    step whose logits are wrong for one live slot of three, by 1.6x
    the limit, is a mismatch, although the gap pooled over the three
    slots is within it.  The twin's logits are served on that step, so
    the tokens are a disarmed run's."""
    _, params = _model
    model = LM(CFG, Runtime(kernel_ops=True), device="cpu")
    kw = dict(ENG_KW, max_batch=3, n_pages=24)
    reqs = [(_prompt(5), 4), (_prompt(7), 4), (_prompt(3), 4)]
    base, _ = ServingEngine(model, params, **kw).run(list(reqs))
    eng = ServingEngine(model, params, **kw)
    assert not eng._bitwise
    limit = eng._rel_tol
    run, agree, pooled = eng._run, eng._agree, []

    def one_slot_wrong(phase, tier, args):
        out = run(phase, tier, args)
        if phase != "decode" or tier != 0 or len(args[0]) < 3 or pooled:
            return out
        logits = out[1].clone()
        live = list(args[0])
        norms = logits[live].float().norm(dim=-1)
        slot = live[int(norms.argmin())]
        noise = torch.randn(logits.shape[-1],
                            generator=torch.Generator().manual_seed(0))
        logits[slot] += (1.6 * limit * norms.min() / noise.norm()
                         * noise).to(logits.dtype)
        pooled.append(None)
        return eng._serve(phase, logits)

    def spy(got, want):
        if pooled and pooled[-1] is None:
            w = want.float()
            pooled[-1] = float((got.float() - w).norm() / w.norm())
        return agree(got, want)

    monkeypatch.setattr(eng, "_run", one_slot_wrong)
    monkeypatch.setattr(eng, "_agree", spy)
    with sentinels.shadowing(1.0, probe=False):
        res, stats = eng.run(list(reqs))
    assert len(pooled) == 1 and pooled[0] < limit < eng.shadow_gap
    assert stats["shadow_mismatches"] == 1
    assert stats["tier_demotions"] == 1
    assert [r.tokens for r in res] == [r.tokens for r in base]


def test_golden_probe_demotes_before_traffic(_model):
    """A wrong answer on the construction probe's canned dispatch means
    the engine never serves a token from the bad tier: demoted to the
    torch twin before the first request, tokens identical."""
    model, params = _model
    p = _prompt(5)
    base, _ = ServingEngine(model, params, **ENG_KW).run([(p, 4)])
    with sentinels.shadowing(0.0, probe=True):
        with faults.injected(
                "wrong_answer",
                trigger=lambda ctx: ctx.get("op") == "engine-golden"):
            eng = ServingEngine(model, params, **ENG_KW)
    assert eng.exec_tier == 1
    assert eng.stats["golden_probes"] == 1
    assert eng.stats["golden_mismatches"] == 1
    assert eng.stats["tier_demotions"] == 1
    assert eng.golden_probe_s > 0
    res, _ = eng.run([(p, 4)])
    assert [r.tokens for r in res] == [r.tokens for r in base]


def test_health_monitor_evicts_nan_decode_slot(_model):
    _, params = _model
    model = LM(CFG, Runtime(sentinels=True), device="cpu")
    eng = ServingEngine(model, params, **ENG_KW)
    p = _prompt(5)
    eng.submit(p, 6)
    eng.step()                         # healthy admit + first decode
    orig = eng._step

    def poisoned(m):
        return eng._outputs(torch.full_like(orig(m)[1], float("nan")))

    eng._step = poisoned
    eng.step()
    (res,) = eng.finished
    assert res.outcome == "health"
    assert 1 <= len(res.tokens) < 6    # honest partial tokens
    assert eng.stats["health_evictions"] == 1
    assert eng.pool.n_free == eng.pool.n_pages - 1
    eng._step = orig                   # engine stays serviceable
    res2, _ = eng.run([(p, 2)])
    assert res2[-1].outcome == "complete"


def test_health_monitor_rejects_inf_prefill(_model):
    _, params = _model
    model = LM(CFG, Runtime(sentinels=True), device="cpu")
    eng = ServingEngine(model, params, **ENG_KW)
    orig = eng._run

    def poisoned(phase, tier, args):
        out = orig(phase, tier, args)
        return torch.full_like(out, float("inf")) if phase == "prefill" \
            else out

    eng._run = poisoned
    eng.submit(_prompt(5), 4)
    eng.step()
    (res,) = eng.finished
    assert res.outcome == "health" and res.tokens == []
    assert eng.stats["health_evictions"] == 1
    assert all(s is None for s in eng.slots)
    assert eng.pool.n_free == eng.pool.n_pages - 1


def test_healthy_flags_nan_inf_and_explosion():
    rows = torch.tensor([
        [0.5, -1.0, 2.0],                      # fine
        [0.5, float("nan"), 2.0],              # NaN
        [0.5, float("inf"), 2.0],              # Inf
        [0.5, -1.0, 2e4],                      # exploded
    ])
    assert sentinels.healthy(rows).tolist() == [True, False, False, False]


# ---------------------------------------------------------------------------
# warm-load golden probes + schedule re-validation (core/api.py)
# ---------------------------------------------------------------------------

GEMM_ARGS = (256, 256, 128, 128)


def _gemm_record_path():
    key = ("gemm", *GEMM_ARGS, 1, "float32", H100.name, H100.tile_unit,
           None, 0)
    return schedule_cache.entry_path(key, H100)


def test_warm_load_probe_on_host_change(tmp_path):
    tk = api.fuse_gemm_chain(*GEMM_ARGS)
    path = _gemm_record_path()
    rec = json.loads(path.read_text())
    assert rec["host"] == schedule_cache.host_fingerprint()
    rec["host"] = "0" * 16             # pretend it tuned elsewhere
    path.write_text(json.dumps(rec))
    api.clear_cache()
    with sentinels.shadowing(0.0) as spec:
        warm = api.fuse_gemm_chain(*GEMM_ARGS)
    assert warm.source == "disk"       # probe passed, entry trusted
    assert spec.n_probed == 1 and spec.n_probe_mismatched == 0
    assert tk.report.best.key() == warm.report.best.key()
    # the record was re-stamped: the next load on this host skips the
    # probe entirely
    assert json.loads(path.read_text())["host"] == \
        schedule_cache.host_fingerprint()
    api.clear_cache()
    with sentinels.shadowing(0.0) as spec2:
        again = api.fuse_gemm_chain(*GEMM_ARGS)
    assert again.source == "disk" and spec2.n_probed == 0


def test_warm_load_probe_mismatch_quarantines_and_retunes(tmp_path):
    api.fuse_gemm_chain(*GEMM_ARGS)
    path = _gemm_record_path()
    rec = json.loads(path.read_text())
    rec["host"] = "0" * 16
    path.write_text(json.dumps(rec))
    api.clear_cache()
    with sentinels.shadowing(0.0) as spec:
        with faults.injected(
                "wrong_answer",
                trigger=lambda ctx: ctx.get("op") == "probe-gemm"):
            warm = api.fuse_gemm_chain(*GEMM_ARGS)
    assert spec.n_probed == 1 and spec.n_probe_mismatched == 1
    assert warm.source == "search"     # entry distrusted -> retune
    assert glob.glob(str(tmp_path / "*.corrupt"))  # evidence kept
    # the retuned record replays clean (current host, no probe due)
    api.clear_cache()
    assert api.fuse_gemm_chain(*GEMM_ARGS).source == "disk"


def test_warm_load_probe_not_due_without_sentinels(tmp_path):
    """Host changes alone never block serving: with the sentinels
    disarmed the warm load replays exactly as before this layer."""
    api.fuse_gemm_chain(*GEMM_ARGS)
    path = _gemm_record_path()
    rec = json.loads(path.read_text())
    rec["host"] = "0" * 16
    path.write_text(json.dumps(rec))
    api.clear_cache()
    warm = api.fuse_gemm_chain(*GEMM_ARGS)
    assert warm.source == "disk"
    assert json.loads(path.read_text())["host"] == "0" * 16


def test_warm_load_revalidates_pruning_rules(tmp_path):
    """A parseable record whose schedule violates Rule 3 (mangled tile
    consistent across tile_sizes and params, so the kwargs cross-check
    passes) is quarantined and retuned — never dispatched."""
    api.fuse_gemm_chain(*GEMM_ARGS)
    path = _gemm_record_path()
    rec = json.loads(path.read_text())
    rec["tile_sizes"]["m"] = 96        # 256/96: 12.5% padding waste
    rec["params"]["bm"] = 96
    path.write_text(json.dumps(rec))
    api.clear_cache()
    warm = api.fuse_gemm_chain(*GEMM_ARGS)
    assert warm.source == "search"
    assert glob.glob(str(tmp_path / "*.corrupt"))
    api.clear_cache()
    assert api.fuse_gemm_chain(*GEMM_ARGS).source == "disk"


# ---------------------------------------------------------------------------
# chaos acceptance: wrong_answer (silent corruption) end to end
# ---------------------------------------------------------------------------

def test_chaos_wrong_answer_golden_probe_blocks_before_traffic():
    """Corruption armed on every sentinel seam: the construction probe
    catches it before the first request, the decode plan is
    quarantined on disk, every served token comes from the twin
    (bit-identical), and the relaunch replays clean at tier
    ``configured`` with zero demotions."""
    out = chaos.run_chaos("wrong_answer", {"rate": 1.0}, planner=True,
                          sentinel_rate=1.0, device="cpu")
    assert out.fired >= 1
    assert out.tokens_identical
    f, r = out.faulted_stats, out.relaunch_stats
    assert f["golden_probes"] == 1 and f["golden_mismatches"] == 1
    assert f["exec_tier"] == "torch-twin" and f["tier_demotions"] == 1
    rec = schedule_cache.is_quarantined(_decode_plan_key(), H100)
    assert rec is not None and "golden probe" in rec["reason"]
    assert r["exec_tier"] == "configured"
    assert r["tier_demotions"] == 0 and r["golden_mismatches"] == 0


def test_chaos_wrong_answer_shadow_detects_mid_traffic():
    """Corruption restricted to live decode dispatches (the golden
    probe's canned input stays clean): the shadow sampler detects on
    the first corrupted decode, the detecting call already serves the
    twin's output, and tokens stay bit-identical throughout."""
    out = chaos.run_chaos(
        "wrong_answer",
        {"trigger": lambda ctx: ctx.get("op") == "engine-decode"},
        planner=True, sentinel_rate=1.0, device="cpu")
    assert out.fired >= 1
    assert out.tokens_identical
    f, r = out.faulted_stats, out.relaunch_stats
    assert f["golden_mismatches"] == 0      # probe input was clean
    assert f["shadow_mismatches"] == 1      # first decode detected
    assert f["exec_tier"] == "torch-twin" and f["tier_demotions"] == 1
    rec = schedule_cache.is_quarantined(_decode_plan_key(), H100)
    assert rec is not None and "shadow mismatch" in rec["reason"]
    assert r["exec_tier"] == "configured"
    assert r["tier_demotions"] == 0 and r["shadow_mismatches"] == 0


# ---------------------------------------------------------------------------
# watchdog under a slow step, quarantine round-trip
# ---------------------------------------------------------------------------

def test_watchdog_counts_slow_injected_step(_model):
    """A deliberately slow (not failing) injected step breaches the
    watchdog budget without killing the request."""
    model, params = _model
    eng = ServingEngine(model, params, watchdog_s=0.01, **ENG_KW)
    eng.submit(_prompt(4), 2)
    with faults.injected(
            "engine_step",
            trigger=lambda ctx: time.sleep(0.05) or False):
        eng.step()
    assert eng.watchdog.breaches >= 1
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
    assert eng.finished[0].outcome == "complete"
    assert eng.stats["tier_demotions"] == 0   # slow is not broken


def test_clear_quarantine_reenables_decode_preplan(_model):
    """Operator round-trip: quarantining the decode plan fingerprint
    makes engine construction skip the pre-carve; clear_quarantine +
    a breaker reset restores it on the next relaunch."""
    _, params = _model
    planned = LM(CFG, Runtime(planner=True, stitch=False), device="cpu")
    dkey = planner.plan_key(CFG, 2, 1, False, phase="decode", paged=4,
                            kv_len=16)
    breaker.record_failure(dkey, reason="operator test")
    assert ServingEngine(planned, params, **ENG_KW).decode_plan is None
    assert all(k[8] != "decode" for k in planner._PLAN_MEMO)
    assert schedule_cache.clear_quarantine(dkey, H100)
    breaker.reset()                    # relaunch: fresh memoization
    planner.clear_memo()
    assert ServingEngine(planned, params, **ENG_KW).decode_plan is not None
    assert any(k[8] == "decode" for k in planner._PLAN_MEMO)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cpu():
    """jax with the CPU as default device for the module: the reference
    runs as the JAX package's own tests run it."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture
def ref_rel(jax_cpu):
    """The reference's reliability modules, their process state reset
    around the test like the port's."""
    from repro.core import api as rapi
    from repro.core import planner as rplanner
    from repro.reliability import breaker as rbreaker
    from repro.reliability import chaos as rchaos
    from repro.reliability import faults as rfaults
    from repro.reliability import sentinels as rsentinels

    def reset():
        rfaults.clear()
        rbreaker.reset()
        rsentinels.disable()
        rplanner.clear_memo()
        rapi.clear_cache()

    reset()
    yield dict(faults=rfaults, sentinels=rsentinels, chaos=rchaos)
    reset()


@pytest.fixture(scope="module")
def ref_params(jax_cpu):
    """The reference's SMOKE weights (``PRNGKey(0)``, what its
    ``run_chaos`` builds) carried into the port through numpy."""
    jax = jax_cpu
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    ref_model = RefLM(ref_config("qwen3_8b", smoke=True))
    ref_p = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, ref_p), CFG)


@pytest.mark.parametrize("kind,kw", [
    ("engine_step", dict(rate=0.3, seed=7)),
    ("kernel_dispatch", dict(rate=0.05, seed=1)),
    ("wrong_answer", dict(rate=0.5, seed=123, limit=9)),
    ("page_exhaustion", dict(nth=17)),
])
def test_fault_firing_matches_reference(ref_rel, kind, kw):
    """One injection fires on the same call ordinals in both packages
    (the sha256 of (seed, kind, ordinal), unchanged)."""
    rfaults = ref_rel["faults"]

    def pattern(reg):
        with reg.injected(kind, **kw) as spec:
            fired = [reg.check(kind, op="x") for _ in range(300)]
            return fired, spec.n_fired, spec.n_seen

    got, want = pattern(faults), pattern(rfaults)
    assert got == want
    assert any(got[0])


@pytest.mark.parametrize("rate,seed", [(1.0 / 64, 0), (0.25, 3),
                                       (0.5, 11)])
def test_shadow_sampler_draws_match_reference(ref_rel, rate, seed):
    """The shadow sampler verifies the same dispatch ordinals in both
    packages, across draw blocks (1200 ordinals, blocks of 512)."""
    rspec = ref_rel["sentinels"].SentinelSpec(rate=rate, seed=seed)
    spec = sentinels.SentinelSpec(rate=rate, seed=seed)
    got = [spec.sample() for _ in range(1200)]
    assert got == [rspec.sample() for _ in range(1200)]
    assert any(got)


def _close_pair(eps):
    rng = np.random.RandomState(0)
    a = rng.randn(4, 64).astype(np.float32)
    return a, a * (1 + eps) + eps


@pytest.mark.parametrize("eps", [0.0, 3e-6, 1e-3, 5e-2])
def test_outputs_close_matches_reference(ref_rel, eps):
    """The kernel seams' comparison gives the reference's verdict in
    f32: the same ``TOLERANCES``."""
    import jax.numpy as jnp
    a, b = _close_pair(eps)
    want = ref_rel["sentinels"].outputs_close(jnp.asarray(a),
                                              jnp.asarray(b))
    got = sentinels.outputs_close(torch.from_numpy(a), torch.from_numpy(b))
    assert got == bool(want)


@pytest.mark.parametrize("eps,close", [(0.0, True), (1e-3, True),
                                       (5e-2, False)])
def test_outputs_close_holds_bf16_to_its_tolerances(eps, close):
    """bf16 within ``TOLERANCES["bfloat16"]`` (2e-2, 2e-2).  The
    reference compares bf16 bitwise here, as numpy does not count its
    bf16 as inexact (ROADMAP Queue 3)."""
    a, b = (torch.from_numpy(t).bfloat16() for t in _close_pair(eps))
    assert sentinels.outputs_close(a, b) == close


#: (inject kwargs, run_chaos options) of each fault kind: the JAX
#: package's chaos tests, plus engine_step at its first dispatch
CHAOS_CASES = {
    "kernel_dispatch": ({"nth": 0}, dict(planner=True)),
    "cache_corrupt": ({"nth": 0}, dict(choose_regime=True)),
    "plan_load": ({"nth": 0}, dict(planner=True)),
    "page_exhaustion": ({"nth": 2}, {}),
    "engine_step": ({"nth": 0}, {}),
    "wrong_answer": ({"rate": 1.0}, dict(planner=True,
                                         sentinel_rate=1.0)),
}

#: the counters of ``stats`` the reliability layer moves
RELIABILITY_STATS = ("decode_steps", "prefills", "generated",
                     "preemptions", "admit_requeues", "tier_demotions",
                     "deadline_evictions", "preempt_failures", "drained",
                     "shadow_checks", "shadow_mismatches", "golden_probes",
                     "golden_mismatches", "health_evictions",
                     "watchdog_breaches")


@pytest.mark.parametrize("kind", sorted(CHAOS_CASES))
def test_chaos_matches_reference(ref_rel, ref_params, kind):
    """``run_chaos`` under each fault kind gives the reference's
    outcome: how often the fault fired, the tokens of the baseline,
    faulted and relaunch phases by rid, the reliability counters and
    the tier each phase ended on."""
    inject_kw, opts = CHAOS_CASES[kind]
    want = ref_rel["chaos"].run_chaos(kind, dict(inject_kw), **opts)
    got = chaos.run_chaos(kind, dict(inject_kw), **opts, device="cpu",
                          params=ref_params)
    assert got.fired == want.fired >= 1
    assert got.baseline == want.baseline
    assert got.faulted == want.faulted
    assert got.relaunch == want.relaunch
    assert got.tokens_identical
    for mine, ref in ((got.faulted_stats, want.faulted_stats),
                      (got.relaunch_stats, want.relaunch_stats)):
        assert {k: mine[k] for k in RELIABILITY_STATS} == \
            {k: ref[k] for k in RELIABILITY_STATS}
        tiers = (("configured", "xla-twin", "eager-twin"),
                 ("configured", "torch-twin", "eager-twin"))
        assert tiers[1].index(mine["exec_tier"]) == \
            tiers[0].index(ref["exec_tier"])


# ---------------------------------------------------------------------------
# what no guard degrades from: anything but an injected fault or a
# launch the card refused without running it
# ---------------------------------------------------------------------------

NEVER_DEGRADED = {
    "build": lambda: KernelBuildError("nvcc not found"),
    "sticky": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "sticky-launch": lambda: KernelLaunchError(
        "attn_partial_launch", 700,
        "an illegal memory access was encountered"),
    "launch-invalid-value": lambda: KernelLaunchError(
        "mlp_chain_launch", 1, "invalid argument"),
    "unsupported": lambda: RuntimeError(
        "fused_attention has no backward: call it under "
        "torch.no_grad() or torch.inference_mode()"),
    "wrapper": lambda: ValueError(
        "tiles bq=128 bkv=128 need 300000 B of shared memory"),
    "bug": lambda: TypeError("unsupported operand type(s)"),
    "oom": lambda: torch.OutOfMemoryError("CUDA out of memory"),
}
DEGRADED = lambda: KernelLaunchError(  # noqa: E731
    "mlp_chain_launch", 9, "invalid configuration argument")


def test_degradable_is_an_allowlist():
    """An injected fault and the two launch errors that leave the
    context usable degrade; nothing else does."""
    assert breaker.degradable(InjectedFault("kernel_dispatch"))
    for code in breaker.USABLE_LAUNCH_ERRORS:
        assert breaker.degradable(KernelLaunchError("x", code, "refused"))
    for make in NEVER_DEGRADED.values():
        assert not breaker.degradable(make())


def _kind(error: str) -> type:
    return type(NEVER_DEGRADED[error]())


def _raiser(make):
    def fn(*a, **k):
        raise make()
    return fn


@pytest.mark.parametrize("error", sorted(NEVER_DEGRADED))
def test_kernel_guard_reraises_build_and_sticky_errors(monkeypatch,
                                                       error):
    """``ops._guarded`` (the kernel tails and the paged branch): a build
    that raises, monkeypatched in, goes through; so do a sticky CUDA
    error, a launch error other than a refused one, a wrapper's own
    ``ValueError``, a bug and running out of memory; a launch the card
    refused degrades."""
    from repro_torch.kernels import ops
    x, wu, wd = _mlp_inputs()
    monkeypatch.setattr(api, "fuse_mlp_chain",
                        _raiser(NEVER_DEGRADED[error]))
    with pytest.raises(_kind(error)) as ei:
        ops.mlp_chain(x, wu, wd)
    assert not breaker.degradable(ei.value)
    assert breaker.failures(MLP_FP) == 0 and not breaker.is_open(MLP_FP)
    monkeypatch.setattr(api, "fuse_mlp_chain", _raiser(DEGRADED))
    ops.mlp_chain(x, wu, wd)
    assert breaker.failures(MLP_FP) == 1


@pytest.mark.parametrize("error", sorted(NEVER_DEGRADED))
def test_planned_layer_guard_reraises_build_and_sticky_errors(
        _model, monkeypatch, error):
    from repro_torch.models import layers as L
    _, params = _model
    planned = LM(CFG, Runtime(planner=True), device="cpu")
    eng = ServingEngine(planned, params, **ENG_KW)
    monkeypatch.setattr(L, "run_planned_layer",
                        _raiser(NEVER_DEGRADED[error]))
    eng.submit(_prompt(5), 2)
    with pytest.raises(_kind(error)):
        eng.step()
    assert not schedule_cache.list_quarantined()
    assert eng.exec_tier == 0 and eng.stats["tier_demotions"] == 0


def test_planned_layer_guard_degrades_a_planner_failure(_model,
                                                        monkeypatch):
    """A planned block whose launch the card refused is quarantined
    under its plan key and served by the hand-wired block: the same
    tokens."""
    from repro_torch.models import layers as L
    _, params = _model
    planned = LM(CFG, Runtime(planner=True, stitch=False), device="cpu")
    base, _ = ServingEngine(planned, params, **ENG_KW).run(
        [(_prompt(5), 3)])
    monkeypatch.setattr(L, "run_planned_layer", _raiser(DEGRADED))
    eng = ServingEngine(planned, params, **ENG_KW)
    res, stats = eng.run([(_prompt(5), 3)])
    assert [r.tokens for r in res] == [r.tokens for r in base]
    reasons = [r["reason"] for r in schedule_cache.list_quarantined()]
    assert len(reasons) == 2           # the prefill and the decode plan
    assert all("invalid configuration" in r for r in reasons)
    assert stats["tier_demotions"] == 0


@pytest.mark.parametrize("error", sorted(NEVER_DEGRADED))
def test_engine_tiers_reraise_build_and_sticky_errors(_model,
                                                      monkeypatch, error):
    """``_exec`` demotes on nothing of the kind, at any tier."""
    model, params = _model
    eng = ServingEngine(model, params, **ENG_KW)
    monkeypatch.setattr(eng, "_run", _raiser(NEVER_DEGRADED[error]))
    eng.submit(_prompt(5), 2)
    with pytest.raises(_kind(error)):
        eng.step()
    assert eng.exec_tier == 0 and eng.stats["tier_demotions"] == 0


@pytest.mark.parametrize("error", sorted(NEVER_DEGRADED))
def test_golden_probe_reraises_build_and_sticky_errors(_model,
                                                       monkeypatch, error):
    _, params = _model
    model = LM(CFG, device="cpu")
    monkeypatch.setattr(model, "decode_step_paged",
                        _raiser(NEVER_DEGRADED[error]))
    with sentinels.shadowing(0.0, probe=True):
        with pytest.raises(_kind(error)):
            ServingEngine(model, params, **ENG_KW)


@pytest.mark.parametrize("error", sorted(NEVER_DEGRADED))
def test_warm_load_probe_reraises_build_and_sticky_errors(error):
    with sentinels.shadowing(0.0):
        with pytest.raises(_kind(error)):
            api._run_probe("gemm", _raiser(NEVER_DEGRADED[error]),
                           lambda: torch.zeros(1))
        assert not api._run_probe("gemm", _raiser(DEGRADED),
                                  lambda: torch.zeros(1))


# ---------------------------------------------------------------------------
# on the card (needs an sm_90 card)
# ---------------------------------------------------------------------------

@pytest.fixture
def sm90(tmp_path, monkeypatch):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.sm90
@pytest.mark.parametrize("error", sorted(NEVER_DEGRADED))
def test_paged_kernel_guard_reraises_on_card(sm90, monkeypatch, error):
    """The paged branch behind ``Runtime(kernel_ops=True)``: a build
    that raises goes through the guard, as does every other failure
    but a refused launch; the breaker records nothing."""
    from repro_torch.kernels import _build
    from repro_torch.serving import kv_pages as KP
    model = LM(CFG, Runtime(kernel_ops=True), device=sm90)
    params = model.init_params(0)
    cache = model.init_paged_cache(8, 4)
    monkeypatch.setattr(_build, "load", _raiser(NEVER_DEGRADED[error]))
    table = torch.full((2, 4), -1, dtype=torch.int32, device=sm90)
    table[:, 0] = KP.SCRATCH_PAGE
    with pytest.raises(_kind(error)):
        model.decode_step_paged(
            params, cache, torch.zeros(2, dtype=torch.long, device=sm90),
            torch.zeros(2, dtype=torch.int32, device=sm90), table)
    assert not schedule_cache.list_quarantined()


@pytest.mark.sm90
@pytest.mark.parametrize("lib,errors", [
    ("attention_partial", "attn_error_string"),
    ("mlp_chain", "mlp_error_string"),
    ("gemm_chain", "chain_error_string")])
def test_usable_launch_errors_name_refused_launches_on_card(sm90, lib,
                                                            errors):
    """The codes ``degradable`` lets through are, in each kernel
    library's ``cudaGetErrorString``, the two launch refusals; a sticky
    code is not let through."""
    from repro_torch.kernels import _build
    texts = {}
    for code in (*breaker.USABLE_LAUNCH_ERRORS, 700):
        with pytest.raises(KernelLaunchError) as ei:
            _build.check_launch(_build.load(lib), "entry", code, errors)
        texts[code] = (str(ei.value), breaker.degradable(ei.value))
    assert texts == {
        9: ("entry failed: invalid configuration argument", True),
        701: ("entry failed: too many resources requested for launch",
              True),
        700: ("entry failed: an illegal memory access was encountered",
              False)}


@pytest.mark.sm90
@pytest.mark.parametrize("planned", [False, True])
def test_captured_engine_shadows_and_demotes_on_card(sm90, planned):
    """Captured engine on the card: shadows at rate 1.0 with no fault
    leave the tokens of a disarmed run (the pool rows put back) with
    no mismatch; an engine-prefill dispatch fault demotes to the
    captured twin and every request completes."""
    from repro_torch.kernels import capture
    cfg = get_config("qwen3_8b", smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True, planner=planned),
               device=sm90)
    params = model.init_params(0)
    reqs = chaos.ragged_workload(cfg)
    kw = dict(max_batch=3, page_size=4, n_pages=32, max_pages_per_seq=8)
    base, _ = ServingEngine(model, params, **kw).run(list(reqs))
    with sentinels.shadowing(1.0) as spec:
        eng = ServingEngine(model, params, **kw)
        res, stats = eng.run(list(reqs))
    assert [r.tokens for r in res] == [r.tokens for r in base]
    assert stats["shadow_checks"] == (stats["decode_steps"]
                                      + stats["prefills"])
    assert stats["shadow_mismatches"] == 0 == spec.n_mismatched
    assert stats["golden_mismatches"] == 0
    assert stats["exec_tier"] == "configured"
    with faults.injected("kernel_dispatch", nth=0,
                         trigger=lambda c: c.get("op") == "engine-prefill"):
        eng = ServingEngine(model, params, **kw)
        before = capture.snapshot()
        res, stats = eng.run(list(reqs))
    assert stats["exec_tier"] == "torch-twin"
    assert stats["tier_demotions"] == 1
    assert all(r.outcome == "complete" for r in res)
    assert capture.since(before).get("fused_attention_partial", 0) == 0
