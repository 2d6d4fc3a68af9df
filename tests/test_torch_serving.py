"""The port's serving slice against the JAX package's.

qwen3 SMOKE in f32 with weights carried over from the JAX init
(``models.convert.params_from_jax``): the port's paged prefill/decode
logits match the reference's within TOL, and the port's continuous
engine emits the same greedy tokens as the reference engine on ragged
workloads, preemption included.  Plus the port's hygiene: no module of
``repro_torch`` (nor ``chip_smoke.py``) imports jax or the JAX package.
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
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))


def _port_model(kernel_ops=True):
    return LM(CFG, Runtime(kernel_ops=kernel_ops), device="cpu")


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


def _serve_both(weights, reqs, **kw):
    from repro.serving import ServingEngine as RefEngine
    ref_model, ref_params, params = weights
    ref_out, ref_stats = RefEngine(ref_model, ref_params,
                                   choose_regime=False, **kw).run(reqs)
    eng = ServingEngine(_port_model(), params, **kw)
    out, stats = eng.run(reqs)
    assert eng.pool.n_free == eng.pool.n_pages - 1
    return ref_out, ref_stats, out, stats


def test_engine_tokens_match_reference_engine(weights):
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, CFG.vocab, size=int(rng.randint(3, 14)))
             .astype(np.int32), int(g)) for g in (3, 9, 1, 6, 12, 2)]
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
