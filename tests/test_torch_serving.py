"""The port's serving slice against the JAX package's.

qwen3 SMOKE in f32 with weights carried over from the JAX init
(``models.convert.params_from_jax``): the port's paged prefill/decode
logits match the reference's within TOL, and the port's continuous
engine emits the same greedy tokens as the reference engine on ragged
workloads, preemption included — hand-wired, and planner-served with
the fused MLP chain dispatched through ``kernels.ops.mlp_chain``.  Plus
the port's hygiene: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports jax or the JAX package.
"""
import ast
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import LM, Runtime  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import kv_pages as KP  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-4, atol=1e-3)      # tests/test_kernels.py
CFG = get_config("qwen3_8b", smoke=True)


@pytest.fixture(scope="module")
def jax_cpu():
    """jax with the CPU as default device for the module: the reference
    runs as the JAX package's own tests run it (a GPU backend would
    compute f32 matmuls at its lower default precision)."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture(scope="module")
def weights(jax_cpu):
    """(reference model, reference params, port params) — one JAX init,
    carried into the port through numpy."""
    jax = jax_cpu
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    ref_model = RefLM(ref_config("qwen3_8b", smoke=True))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    return ref_model, ref_params, params_from_jax(np_params, CFG)


@pytest.fixture(autouse=True)
def _port_cache(tmp_path, monkeypatch):
    from repro_torch.core import planner
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    planner.clear_memo()
    yield
    planner.clear_memo()


def _port_model(kernel_ops=True, **rt):
    return LM(CFG, Runtime(kernel_ops=kernel_ops, **rt), device="cpu")


def test_paged_logits_match_reference(weights):
    """Prefill then ragged decode through shuffled pages, with an
    inactive slot: the port's logits equal the reference's within
    TOL at every step."""
    import jax.numpy as jnp
    ref_model, ref_params, params = weights
    model = _port_model()
    ps, mp, n_pages, b = 4, 6, 20, 3
    rng = np.random.RandomState(0)
    ref_cache = ref_model.init_paged_cache(n_pages, ps)
    cache = model.init_paged_cache(n_pages, ps)
    pool = KP.PagePool(n_pages, ps)
    plens = [5, 9, 3]
    allocs = [KP.RequestPages() for _ in range(b)]
    last = []
    for i, plen in enumerate(plens):
        assert allocs[i].ensure(plen, pool)
        toks = np.zeros((1, math.ceil(plen / ps) * ps), np.int32)
        toks[0, :plen] = rng.randint(0, CFG.vocab, size=plen)
        table = KP.table_array([allocs[i]], mp)
        want, ref_cache = ref_model.prefill_paged(
            ref_params, jnp.asarray(toks), ref_cache, jnp.asarray(table),
            jnp.int32(plen))
        got, cache = model.prefill_paged(
            params, torch.from_numpy(toks).long(), cache,
            torch.from_numpy(table), plen)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        last.append(int(np.argmax(np.asarray(want)[0])))
    lengths = list(plens)
    for step in range(4):
        active = [0, 1] if step % 2 else [0, 1, 2]   # slot 2 idles
        pos = np.full(b, -1, np.int32)
        toks = np.zeros(b, np.int32)
        for i in active:
            assert allocs[i].ensure(lengths[i] + 1, pool)
            pos[i], toks[i] = lengths[i], last[i]
        table = KP.table_array(
            [allocs[i] if i in active else None for i in range(b)], mp)
        want, ref_cache = ref_model.decode_step_paged(
            ref_params, ref_cache, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(table))
        got, cache = model.decode_step_paged(
            params, cache, torch.from_numpy(toks).long(),
            torch.from_numpy(pos), torch.from_numpy(table))
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy()[active], w[active], **TOL)
        for i in active:
            lengths[i] += 1
            last[i] = int(np.argmax(w[i]))


def _serve_both(weights, reqs, rt=None, **kw):
    """Serve ``reqs`` on the reference engine and the port's; ``rt``
    (planner, stitch) runs both planner-served."""
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro.serving import ServingEngine as RefEngine
    ref_model, ref_params, params = weights
    if rt:
        ref_model = RefLM(ref_model.cfg, RefRuntime(**rt))
    ref_out, ref_stats = RefEngine(ref_model, ref_params,
                                   choose_regime=False, **kw).run(reqs)
    eng = ServingEngine(_port_model(**(rt or {})), params, **kw)
    out, stats = eng.run(reqs)
    assert eng.pool.n_free == eng.pool.n_pages - 1
    return ref_out, ref_stats, out, stats


def _ragged_reqs():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, CFG.vocab, size=int(rng.randint(3, 14)))
             .astype(np.int32), int(g)) for g in (3, 9, 1, 6, 12, 2)]


def test_engine_tokens_match_reference_engine(weights):
    reqs = _ragged_reqs()
    ref_out, ref_stats, out, stats = _serve_both(
        weights, reqs, max_batch=3, page_size=4, n_pages=32,
        max_pages_per_seq=8)
    assert [r.tokens for r in out] == [r.tokens for r in ref_out]
    assert [len(r.tokens) for r in out] == [g for _, g in reqs]
    for k in ("decode_steps", "prefills", "generated"):
        assert stats[k] == ref_stats[k]
    assert stats["decode_steps"] < sum(g for _, g in reqs)


def test_engine_preemption_matches_reference_engine(weights):
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, CFG.vocab, size=6).astype(np.int32), 10)
            for _ in range(4)]
    ref_out, ref_stats, out, stats = _serve_both(
        weights, reqs, max_batch=4, page_size=4, n_pages=10,
        max_pages_per_seq=4)
    assert stats["preemptions"] == ref_stats["preemptions"] > 0
    assert [r.tokens for r in out] == [r.tokens for r in ref_out]
    assert [r.n_preempted for r in out] == [r.n_preempted for r in ref_out]
    assert [len(r.tokens) for r in out] == [10] * 4


@pytest.mark.parametrize("stitch", [False, True])
def test_planned_engine_tokens_match_reference_planned_engine(weights,
                                                              stitch):
    """Planner-served on both sides (the port plans under the H100
    descriptor, the reference under V5E; on this f32 config stitched
    glue computes the same numbers either way), with the port's fused
    MLP chains dispatched as kernels."""
    reqs = _ragged_reqs()
    rt = dict(planner=True, stitch=stitch)
    ref_out, ref_stats, out, stats = _serve_both(
        weights, reqs, rt=rt, max_batch=3, page_size=4, n_pages=32,
        max_pages_per_seq=8)
    assert [r.tokens for r in out] == [r.tokens for r in ref_out]
    assert [len(r.tokens) for r in out] == [g for _, g in reqs]
    for k in ("decode_steps", "prefills", "generated"):
        assert stats[k] == ref_stats[k]


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("arch", ["granite_20b", "codeqwen15_7b",
                                  "granite_34b", "olmoe_1b_7b",
                                  "mixtral_8x7b"])
def test_engine_tokens_match_reference_engine_per_config(jax_cpu, arch,
                                                         planned):
    """The other configs (MQA granite, MHA codeqwen, the MoE olmoe and
    mixtral) at SMOKE, weights carried from one JAX init: the port's
    engine emits the reference engine's greedy tokens, hand-wired and
    planner-requested (planner-served where the config can be planned,
    hand-wired blocks where it cannot, on both sides)."""
    jax = jax_cpu
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.models.convert import params_from_jax
    cfg = get_config(arch, smoke=True)
    ref_model = RefLM(ref_config(arch, smoke=True),
                      RefRuntime(planner=planned))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg)
    rng = np.random.RandomState(2)
    reqs = [(rng.randint(0, cfg.vocab, size=int(rng.randint(3, 14)))
             .astype(np.int32), int(g)) for g in (5, 1, 8, 3)]
    kw = dict(max_batch=3, page_size=4, n_pages=24, max_pages_per_seq=6)
    ref_out, ref_stats = RefEngine(ref_model, ref_params,
                                   choose_regime=False, **kw).run(reqs)
    model = LM(cfg, Runtime(kernel_ops=True, planner=planned),
               device="cpu")
    out, stats = ServingEngine(model, params, **kw).run(reqs)
    assert [r.tokens for r in out] == [r.tokens for r in ref_out]
    assert [len(r.tokens) for r in out] == [g for _, g in reqs]
    for k in ("decode_steps", "prefills", "generated"):
        assert stats[k] == ref_stats[k]


def test_planned_engine_preemption_matches_reference(weights):
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, CFG.vocab, size=6).astype(np.int32), 10)
            for _ in range(4)]
    ref_out, ref_stats, out, stats = _serve_both(
        weights, reqs, rt=dict(planner=True), max_batch=4, page_size=4,
        n_pages=10, max_pages_per_seq=4)
    assert stats["preemptions"] == ref_stats["preemptions"] > 0
    assert [r.tokens for r in out] == [r.tokens for r in ref_out]
    assert [len(r.tokens) for r in out] == [10] * 4


def test_planned_mlp_dispatch_once_per_layer_per_step(weights,
                                                      monkeypatch):
    """The fused MLP chain of every planned block goes through
    ``kernels.ops.mlp_chain``: once per layer per prefill and per decode
    step, and the engine plans decode at construction."""
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    _, _, params = weights
    calls = []
    real = ops.mlp_chain
    monkeypatch.setattr(ops, "mlp_chain",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    eng = ServingEngine(_port_model(planner=True), params, max_batch=3,
                        page_size=4, n_pages=32, max_pages_per_seq=8)
    assert eng.decode_plan is not None
    assert any(c.kind == "mlp" and c.fused
               for c in eng.decode_plan.layer.chains)
    _, stats = eng.run(_ragged_reqs())
    steps = stats["decode_steps"] + stats["prefills"]
    assert len(calls) == steps * CFG.n_layers
    assert calls.count((3, CFG.d_model)) == (stats["decode_steps"]
                                             * CFG.n_layers)
    phases = {k[8] for k in planner._PLAN_MEMO}
    assert phases == {"prefill", "decode"}
    # the hand-wired runtime never reaches the dispatch
    calls.clear()
    ServingEngine(_port_model(), params, max_batch=3, page_size=4,
                  n_pages=32, max_pages_per_seq=8).run(_ragged_reqs()[:2])
    assert not calls


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("stitch", [False, True])
def test_run_planned_layer_matches_reference(weights, phase, stitch):
    """One smoke block from its plan, the port's (H100 plan, fused MLP
    through the dispatch) against the reference's (V5E plan): the same
    output and the same pages written, within TOL."""
    import jax
    import jax.numpy as jnp
    from repro.core import planner as ref_planner
    from repro.models import layers as RL
    from repro.models.lm import Runtime as RefRuntime
    from repro_torch.core import planner
    from repro_torch.models import layers as L
    ref_model, ref_params, params = weights
    ps, mp, n_pages = 4, 4, 12
    b, s = (3, 1) if phase == "decode" else (1, 8)
    rng = np.random.RandomState(5)
    x = rng.randn(b, s, CFG.d_model).astype(np.float32)
    if phase == "decode":
        pos = np.array([[6], [-1], [13]], np.int32)   # slot 1 idles
        table = np.array([[3, 5, -1, -1], [-1] * 4, [1, 2, 4, 6]],
                         np.int32)
    else:
        pos = np.where(np.arange(s) < 6, np.arange(s), -1)[None]
        table = np.array([[7, 2, -1, -1]], np.int32)
    pos = pos.astype(np.int32)
    pools = [rng.randn(n_pages, CFG.n_kv_heads, ps, CFG.dh)
             .astype(np.float32) for _ in range(2)]
    kw = dict(stitch=stitch, phase=phase, paged=ps, kv_len=mp * ps)
    rplan = ref_planner.plan_model(ref_model.cfg, b, s, use_cache=False,
                                   **kw)
    rrt = RefRuntime(planner=True, stitch=stitch)
    rp = jax.tree.map(lambda a: a[0], ref_params["stack"]["b0_attn"])
    want, wcache = RL.run_planned_layer(
        rplan.layer, rp, jnp.asarray(x), ref_model.cfg, rrt.rules,
        positions=jnp.asarray(pos), rt=rrt,
        cache={"k_pages": jnp.asarray(pools[0]),
               "v_pages": jnp.asarray(pools[1])},
        page_table=jnp.asarray(table))
    plan = planner.plan_model(CFG, b, s, **kw)
    assert any(c.kind == "mlp" and c.fused for c in plan.layer.chains)
    cache = {"k_pages": torch.from_numpy(pools[0].copy()),
             "v_pages": torch.from_numpy(pools[1].copy())}
    got, cache = L.run_planned_layer(
        plan.layer, params["layers"][0], torch.from_numpy(x), CFG,
        positions=torch.from_numpy(pos),
        rt=Runtime(kernel_ops=True, planner=True, stitch=stitch),
        cache=cache, page_table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k_pages", "v_pages"):   # scratch page 0 may differ
        np.testing.assert_allclose(cache[k].numpy()[1:],
                                   np.asarray(wcache[k])[1:], **TOL)


def test_window_reclamation_matches_reference_engine(weights):
    """Sliding-window page reclamation (``kv_pages.reclaim_below`` wired
    into the engine step): pages wholly below the attention window go
    back to the pool mid-request, and the served tokens equal the same
    engine's with reclamation off (``_window = 0``, the window mask
    still on) and the reference engine's on the same carried weights,
    which reclaims as many pages."""
    import dataclasses
    from repro.models.lm import LM as RefLM
    from repro.serving import ServingEngine as RefEngine
    ref_model, ref_params, params = weights
    cfg = dataclasses.replace(CFG, window=6)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab, size=8).astype(np.int32), 10),
            (rng.randint(0, cfg.vocab, size=5).astype(np.int32), 12)]
    kw = dict(max_batch=2, page_size=4, n_pages=32, max_pages_per_seq=8)

    def port_engine():
        return ServingEngine(LM(cfg, Runtime(kernel_ops=True), device="cpu"),
                             params, **kw)

    base_eng = port_engine()
    base_eng._window = 0
    base, base_stats = base_eng.run(list(reqs))
    assert base_stats["reclaimed_pages"] == 0
    eng = port_engine()
    out, stats = eng.run(list(reqs))
    assert stats["reclaimed_pages"] > 0
    assert [r.tokens for r in out] == [r.tokens for r in base]
    assert [len(r.tokens) for r in out] == [10, 12]
    assert eng.pool.n_free == eng.pool.n_pages - 1
    ref_out, ref_stats = RefEngine(
        RefLM(dataclasses.replace(ref_model.cfg, window=6)), ref_params,
        choose_regime=False, **kw).run(list(reqs))
    assert [r.tokens for r in out] == [r.tokens for r in ref_out]
    assert stats["reclaimed_pages"] == ref_stats["reclaimed_pages"]


def test_reclaim_below_matches_reference(jax_cpu):
    """``RequestPages.reclaim_below`` frees the same pages as the
    reference's, leaves ``RECLAIMED`` placeholders that the page table
    shows as -1, and ``release`` skips them."""
    from repro.serving import kv_pages as RKP
    assert KP.RECLAIMED == RKP.RECLAIMED == -1
    pool, rpool = KP.PagePool(12, 4), RKP.PagePool(12, 4)
    got, want = KP.RequestPages(), RKP.RequestPages()
    assert got.ensure(22, pool) and want.ensure(22, rpool)
    for min_pos in (3, 9, 9, 17, 40):
        assert (got.reclaim_below(min_pos, pool)
                == want.reclaim_below(min_pos, rpool))
        assert got.pages == want.pages and pool.n_free == rpool.n_free
    assert KP.table_array([got], 8)[0].tolist() == [-1] * 6 + [-1, -1]
    got.release(pool)
    assert got.pages == [] and pool.n_free == pool.n_pages - 1


def test_engine_deadline_drain_and_validation():
    """Deadlines, the preemption budget and drain report honest partial
    outcomes; submit rejects what the geometry cannot hold."""
    model = _port_model()
    params = model.init_params(0)
    kw = dict(max_batch=2, page_size=4, n_pages=12, max_pages_per_seq=4,
              choose_regime=False)
    eng = ServingEngine(model, params, **kw)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(20, np.int32), 1)          # > n_ctx
    prompt = np.arange(5, dtype=np.int32)
    eng.submit(prompt, 8, deadline_steps=2)
    eng.submit(prompt, 8)
    eng.submit(prompt, 8)                              # waits in queue
    for _ in range(3):
        eng.step()
    assert [r.outcome for r in eng.finished] == ["deadline"]
    assert 0 < len(eng.finished[0].tokens) < 8
    drained = eng.drain(max_steps=1)
    assert sorted(r.outcome for r in drained) == ["drained"] * 2
    assert eng.pool.n_free == eng.pool.n_pages - 1
    budget = ServingEngine(model, params, max_preemptions=0, **kw)
    budget.submit(prompt, 8)
    budget.step()
    budget._preempt(0)
    (res,) = budget.finished
    assert res.outcome == "preempt_budget" and res.n_preempted == 1


def test_engine_threads_tuned_tiles_and_cli_runs(capsys):
    """The engine tunes its decode shape for the H100 and threads the
    tiles into the model; the CLI serves on the plain path with
    ``--device cpu``."""
    from repro_torch.launch import serve
    model = _port_model()
    eng = ServingEngine(model, model.init_params(0), max_batch=2,
                        page_size=4, n_pages=12, max_pages_per_seq=4)
    bq, bkv = eng.model.rt.paged_block
    assert bq == 1 and eng.n_ctx % bkv == 0
    assert eng.model.rt.kernel_ops and eng.regime_source == "search"
    results = serve.main(["--continuous", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4",
                          "--page-size", "4", "--requests", "3"])
    assert len(results) == 3 and all(r.tokens for r in results)
    assert "3 requests" in capsys.readouterr().out


def test_kv_pages_match_reference(jax_cpu):
    jnp = jax_cpu.numpy
    from repro.serving import kv_pages as RKP
    rng = np.random.RandomState(3)
    table = np.array([[3, 1, -1], [2, -1, -1]], np.int32)
    pos = np.array([[4, 5, -1], [0, 1, 2]], np.int32)
    for first in (0, 2):
        got = KP.paged_kv_positions(torch.from_numpy(table), 4, invalid=-7,
                                    first_page=first)
        want = RKP.paged_kv_positions(jnp.asarray(table), 4, invalid=-7,
                                      first_page=first)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gp, go = KP.slot_coords(torch.from_numpy(table), torch.from_numpy(pos), 4)
    wp, wo = RKP.slot_coords(jnp.asarray(table), jnp.asarray(pos), 4)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    pages = rng.randn(5, 2, 4, 8).astype(np.float32)
    np.testing.assert_array_equal(
        KP.gather_pages(torch.from_numpy(pages),
                        torch.from_numpy(table)).numpy(),
        np.asarray(RKP.gather_pages(jnp.asarray(pages), jnp.asarray(table))))
    vals = rng.randn(2, 3, 2, 8).astype(np.float32)
    got = KP.scatter_pages(torch.from_numpy(pages.copy()), gp, go,
                           torch.from_numpy(vals)).numpy()
    want = np.asarray(RKP.scatter_pages(jnp.asarray(pages), wp, wo,
                                        jnp.asarray(vals)))
    # pages other than scratch must agree (scratch write order is free)
    np.testing.assert_array_equal(got[1:], want[1:])


# ---------------------------------------------------------------------------
# the captured decode step on the card (needs an sm_90 card)
# ---------------------------------------------------------------------------

@pytest.fixture
def sm90(tmp_path, monkeypatch):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.sm90
@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_20b"])
def test_captured_engine_equals_eager_on_card(sm90, arch, planned):
    """The engine replays its captured decode step on the card: its
    greedy tokens equal the eager engine's, and the kernels' counters
    read what the served steps launched — the paged attention kernel
    once per layer and decode step, the MLP kernel (planned) once per
    layer and decode step or prefill — with the capture's warm-up
    counted apart."""
    from repro_torch.kernels import capture
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True, planner=planned), device=sm90)
    params = model.init_params(0)
    reqs = _ragged_reqs()
    kw = dict(max_batch=3, page_size=4, n_pages=32, max_pages_per_seq=8)
    runs = {}
    for eager in (False, True):
        eng = ServingEngine(model, params, eager_decode=eager, **kw)
        assert (eng.captured is None) == eager
        before = capture.snapshot()
        out, stats = eng.run(reqs)
        torch.cuda.synchronize()
        runs[eager] = ([r.tokens for r in out], stats,
                       capture.since(before), eng.captured)
    (got, stats, launches, captured), (want, _, eager_launches, _) = (
        runs[False], runs[True])
    warm = captured.warmup_launches
    assert got == want
    assert launches == eager_launches
    steps, layers = stats["decode_steps"], cfg.n_layers
    assert launches["fused_attention_partial"] == steps * layers
    assert warm["fused_attention_partial"] == layers
    if planned:
        assert launches["fused_mlp_chain"] == (
            (steps + stats["prefills"]) * layers)
        assert warm["fused_mlp_chain"] == layers


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    files += [smoke] if smoke.exists() else []
    assert len(files) > 15
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
