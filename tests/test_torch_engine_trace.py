"""The serving engine's phase spans and counters (``serving.engine.PHASES``)
at qwen3 SMOKE on the CPU: the counters are host seconds that fit in
the watchdog's step, the queue wait counts a request held back, the
gathered-pages counter counts the whole page table each decode step, the
spans are host-only ``torch.profiler`` events nested in the caller's
range, tracing changes no served token, and ``reset()`` zeroes the
counters."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import LM, Runtime  # noqa: E402
from repro_torch.reliability import sentinels  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.engine import PHASES  # noqa: E402

CFG = get_config("qwen3_8b", smoke=True)
ENG_KW = dict(page_size=4, n_pages=32, max_pages_per_seq=8)
COUNTERS = list(PHASES.values()) + ["queue_wait_s", "gathered_page_steps"]


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    sentinels.disable()
    yield
    sentinels.disable()


@pytest.fixture(scope="module")
def model_params():
    model = LM(CFG, Runtime(kernel_ops=True), device="cpu")
    return model, model.init_params(0)


def _engine(model_params, max_batch=3):
    model, params = model_params
    return ServingEngine(model, params, max_batch=max_batch, **ENG_KW)


def _reqs():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, CFG.vocab, size=int(rng.randint(3, 14))), g)
            for g in (3, 9, 1, 6, 12, 2)]


def test_phase_counters_fit_in_each_step(model_params):
    eng = _engine(model_params)
    for prompt, g in _reqs():
        eng.submit(prompt, g)
    phases = list(PHASES.values())
    while eng.queue or any(s is not None for s in eng.slots):
        before = {k: eng.stats[k] for k in phases}
        eng.step()
        moved = {k: eng.stats[k] - before[k] for k in phases}
        assert all(v >= 0 for v in moved.values()), moved
        assert sum(moved.values()) <= eng.watchdog.last_step_s
    assert eng.stats["decode_steps"] > 0
    for k in phases:
        assert eng.stats[k] > 0, k


def test_queue_wait_counts_a_request_held_back(model_params):
    eng = _engine(model_params, max_batch=1)
    prompt = np.arange(5)
    eng.submit(prompt, 3)
    eng.step()
    first = eng.stats["queue_wait_s"]
    assert eng.stats["prefills"] == 1 and first >= 0
    eng.submit(prompt, 2)
    held = time.perf_counter()
    time.sleep(0.05)
    while eng.stats["prefills"] < 2:
        t0 = time.perf_counter()
        eng.step()
    # the second request waited from its submit to its admission's step
    assert eng.stats["queue_wait_s"] - first >= t0 - held >= 0.05


def test_gathered_pages_count_the_whole_table(model_params):
    eng = _engine(model_params)
    _, stats = eng.run(_reqs())
    table = eng.max_batch * ENG_KW["max_pages_per_seq"]
    assert stats["gathered_page_steps"] == stats["decode_steps"] * table
    assert 0 < stats["page_slot_steps"] < stats["gathered_page_steps"]


def test_spans_are_host_events_nested_in_the_callers_range(model_params):
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = _engine(model_params)
    sentinels.enable(1.0, probe=False)   # every dispatch shadowed
    for prompt, g in _reqs()[:2]:
        eng.submit(prompt, g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            for _ in range(3):
                eng.step()
    events = prof.events()
    (outer,) = [e for e in events if e.name == "caller"]
    ours = [e for e in events if e.name.startswith("engine.")]
    want = {"engine.step"} | set(PHASES)
    assert {e.name for e in ours} == want
    for e in ours:
        assert not e.is_user_annotation, e.name
        assert (outer.time_range.start <= e.time_range.start
                <= e.time_range.end <= outer.time_range.end), e.name
        p = e.cpu_parent
        while p is not None and p is not outer:
            p = p.cpu_parent
        assert p is outer, e.name


def test_tracing_changes_no_token(model_params):
    from torch.profiler import ProfilerActivity, profile
    plain, _ = _engine(model_params).run(_reqs())
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = _engine(model_params).run(_reqs())
    assert [r.tokens for r in traced] == [r.tokens for r in plain]


def test_reset_zeroes_the_counters(model_params):
    from repro_torch.launch.serve import phase_line
    eng = _engine(model_params, max_batch=2)
    _, stats = eng.run(_reqs())
    assert all(stats[k] > 0 for k in COUNTERS), stats
    assert "ctx_tokens" not in stats
    line = phase_line(stats)
    assert all(f"{k[:-2]}=" in line for k in PHASES.values())
    eng.reset()
    assert all(eng.stats[k] == 0 for k in COUNTERS)
