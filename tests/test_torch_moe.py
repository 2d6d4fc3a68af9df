"""The port's mixture-of-experts family against the JAX package's.

olmoe-1b-7b and mixtral-8x7b SMOKE in f32, weights carried over from
the JAX init (``models.convert.params_from_jax``): ``moe_local`` (the
routing, capacity drops, the per-expert loop, the expert and capacity
partitions) against the reference's ``_moe_local`` and a dense oracle;
``LM.forward``/``loss``, the gradients of one train step, mixtral's
windowed ring cache across its window, and the continuous engine's
tokens — hand-wired, planner-requested (the planner cannot plan MoE, so
both sides serve hand-wired blocks) and with padded prompts whose pad
tokens take expert capacity — against the reference's.  The captured
engine against the eager one needs the card (``sm90``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models.lm import LM, Runtime, requires_grad  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# f32 sums of the same products in other orders (tests/test_kernels.py
# holds f32 kernels to 3e-4); the reference's own MoE tests use 2e-4
MOE_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=3e-4, atol=1e-3)
GRAD_REL_TOL = 1e-4
LOSS_REL_TOL = 1e-4
ARCHS = ["olmoe_1b_7b", "mixtral_8x7b"]
ENG_KW = dict(max_batch=3, page_size=4, n_pages=40, max_pages_per_seq=12)


@pytest.fixture(scope="module")
def jax_cpu():
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture(scope="module")
def ref(jax_cpu):
    """arch -> (reference model, reference params, port params): one
    JAX init per config on the CPU."""
    jax = jax_cpu
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    out = {}
    for arch in ARCHS:
        model = RefLM(ref_config(arch, smoke=True))
        params = jax.jit(model.init_params)(jax.random.PRNGKey(0))
        out[arch] = (model, params, params_from_jax(
            jax.tree.map(np.asarray, params), get_config(arch, smoke=True)))
    return out


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    from repro_torch.core import api, planner
    from repro_torch.reliability import breaker, faults, sentinels
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    for reset in (faults.clear, breaker.reset, sentinels.disable,
                  planner.clear_memo, api.clear_cache):
        reset()
    yield
    for reset in (faults.clear, breaker.reset, sentinels.disable,
                  planner.clear_memo, api.clear_cache):
        reset()


# ---------------------------------------------------------------------------
# moe_local: the counterparts of tests/test_moe_and_loss.py's MoE tests
# ---------------------------------------------------------------------------

def _cfgs(e=4, k=2, cf=16.0):
    """(port config, reference config) of tests/test_moe_and_loss.py."""
    from repro.models.config import ModelConfig as RefConfig
    from repro.models.config import MoEConfig as RefMoE
    return (ModelConfig("t", "moe", 2, 32, 4, 4, 64, 128,
                        moe=MoEConfig(e, k, cf), dtype="float32"),
            RefConfig("t", "moe", 2, 32, 4, 4, 64, 128,
                      moe=RefMoE(e, k, cf), dtype="float32"))


def _moe_inputs(jax, rcfg, seed=0, t=64):
    """The reference's init_moe weights and normal tokens (T, 32), as
    numpy, and the port's tensors of the same."""
    from repro.models.layers import init_moe
    p = jax.tree.map(np.asarray, init_moe(jax.random.PRNGKey(seed), rcfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (t, 32)))
    return p, x, {k: torch.from_numpy(v.copy()) for k, v in p.items()}, \
        torch.from_numpy(x.copy())


def _dense_oracle(p, x, cfg):
    """Every expert over every token, weighted by its renormalised top-k
    probability (zero where not chosen): MoE without capacity."""
    topw, topi = L.route(p, x, cfg)
    out = torch.zeros_like(x)
    for i in range(cfg.moe.n_experts):
        h = torch.nn.functional.silu(x @ p["w_gate"][i]) * (x @ p["w_up"][i])
        w = torch.where(topi == i, topw, 0.0).sum(-1)
        out += (h @ p["w_down"][i]) * w[:, None]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_matches_dense_oracle(jax_cpu, seed):
    cfg, rcfg = _cfgs()
    _, _, p, x = _moe_inputs(jax_cpu, rcfg, seed)
    np.testing.assert_allclose(L.moe_local(p, x, cfg).numpy(),
                               _dense_oracle(p, x, cfg).numpy(), **MOE_TOL)


def test_moe_expert_partition_sums_to_whole(jax_cpu):
    """Partial outputs over disjoint expert slices sum to the whole
    (what the reference's psum over the model axis computes)."""
    cfg, rcfg = _cfgs()
    _, _, p, x = _moe_inputs(jax_cpu, rcfg)
    full = L.moe_local(p, x, cfg)
    parts = [L.moe_local({"router": p["router"],
                          **{w: p[w][e0:e0 + 1]
                             for w in ("w_up", "w_down", "w_gate")}},
                         x, cfg, expert_slice=(e0, 1)) for e0 in range(4)]
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), **MOE_TOL)


def test_moe_capacity_partition_sums_to_whole(jax_cpu):
    """Partial outputs over disjoint capacity windows (the reference's
    replicated-expert layout) sum to the whole, drops included."""
    cfg, rcfg = _cfgs(cf=1.0)
    _, _, p, x = _moe_inputs(jax_cpu, rcfg)
    full = L.moe_local(p, x, cfg)
    cap = 32                          # max(8, ceil(2*64*1.0/4/8)*8)
    parts = [L.moe_local(p, x, cfg, cap_slice=(c0, 8))
             for c0 in range(0, cap, 8)]
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), **MOE_TOL)


def test_moe_capacity_drops_tokens(jax_cpu):
    """A tiny capacity drops assignments: the output leaves the dense
    oracle, and drops exactly the reference's."""
    from repro.models.layers import _moe_local
    cfg, rcfg = _cfgs(cf=0.25)
    pn, xn, p, x = _moe_inputs(jax_cpu, rcfg, t=128)
    dropped = L.moe_local(p, x, cfg)
    assert float((dropped - _dense_oracle(p, x, cfg)).abs().max()) > 1e-3
    np.testing.assert_allclose(dropped.numpy(),
                               np.asarray(_moe_local(pn, xn, rcfg)),
                               **MOE_TOL)


def test_moe_scan_path_matches_vectorized(jax_cpu):
    """The per-expert loop (a dispatch buffer past ``scan_threshold``)
    computes the vectorised body's numbers."""
    cfg, rcfg = _cfgs()
    _, _, p, x = _moe_inputs(jax_cpu, rcfg)
    np.testing.assert_allclose(
        L.moe_local(p, x, cfg, scan_threshold=0).numpy(),
        L.moe_local(p, x, cfg).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_local_matches_reference(jax_cpu, cf, scan):
    """The port's ``moe_local`` against the reference's ``_moe_local``
    on the same weights and tokens; at capacity factor 1.25 some
    assignments drop on both sides."""
    from repro.models.layers import _moe_local
    cfg, rcfg = _cfgs(e=8, k=2, cf=cf)
    pn, xn, p, x = _moe_inputs(jax_cpu, rcfg, seed=3, t=96)
    kw = dict(scan_threshold=0) if scan else {}
    want = np.asarray(_moe_local(pn, xn, rcfg, **kw))
    np.testing.assert_allclose(L.moe_local(p, x, cfg, **kw).numpy(), want,
                               **MOE_TOL)
    drops = float((L.moe_local(p, x, cfg) - _dense_oracle(p, x, cfg)
                   ).abs().max())
    assert (drops > 1e-3) == (cf == 1.25)


def test_combine_is_the_sorted_scatter_add_bit_for_bit():
    """The gathering combine sums each token's rows in the order the
    reference's scatter-add over expert-sorted slots does: bitwise
    equal to ``index_add_`` over those slots on the CPU."""
    g = torch.Generator().manual_seed(0)
    t, k, e, cap, d = 40, 3, 6, 16, 24
    topi = torch.stack([torch.randperm(e, generator=g)[:k]
                        for _ in range(t)])
    flat_e = topi.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(se, torch.arange(e))
    pos = torch.arange(t * k) - first[se]
    dest = torch.where(pos < cap, se * cap + pos, e * cap)
    st = (torch.arange(t * k) // k)[order]
    slot_tok = torch.zeros(e * cap + 1, dtype=torch.long).scatter(
        0, dest, st)[:-1]
    yflat = torch.randn(e * cap, d, generator=g) * 10
    yflat[(torch.arange(e * cap)[:, None] != dest[None]).all(1)] = 0.0
    want = torch.zeros(t, d).index_add_(0, slot_tok, yflat)
    assert torch.equal(L._combine(yflat, dest, order, t, k), want)


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients, the ring cache
# ---------------------------------------------------------------------------

def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return tokens, labels


@pytest.mark.parametrize("kernel_ops", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(ref, arch, kernel_ops):
    import jax.numpy as jnp
    ref_model, ref_params, params = ref[arch]
    model = LM(get_config(arch, smoke=True),
               Runtime(kernel_ops=kernel_ops), device="cpu")
    tokens, labels = _batch(model.cfg.vocab)
    want = np.asarray(ref_model.forward(ref_params, jnp.asarray(tokens)))
    want_loss = float(ref_model.loss(ref_params, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}))
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        np.testing.assert_allclose(model.forward(params, t).numpy(), want,
                                   **TOL)
        loss = float(model.loss(params, {
            "tokens": t, "labels": torch.from_numpy(labels).long()}))
    assert loss == pytest.approx(want_loss, rel=LOSS_REL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(ref, arch, jax_cpu):
    """One train step's gradients under autograd — through the router's
    renormalised top-k weights, the dispatch gathers and the combine —
    against ``jax.grad`` of the reference's loss, per leaf within
    GRAD_REL_TOL (relative 2-norm), the router included."""
    import jax.numpy as jnp
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro_torch.models.convert import params_from_jax
    ref_model, ref_params, params = ref[arch]
    cfg = get_config(arch, smoke=True)
    tokens, labels = _batch(cfg.vocab)
    want_loss, grads = jax_cpu.value_and_grad(
        RefLM(ref_model.cfg, RefRuntime(remat=False)).loss)(
        ref_params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)})
    want = params_from_jax(jax_cpu.tree.map(np.asarray, grads), cfg)
    params = requires_grad(T.map_tree(torch.clone, params))
    loss = LM(cfg, device="cpu").loss(params, {
        "tokens": torch.from_numpy(tokens).long(),
        "labels": torch.from_numpy(labels).long()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_REL_TOL)
    worst = {}
    for (key, p), w in zip(T.leaves_with_paths(params), T.leaves(want)):
        assert p.grad is not None and p.grad.shape == w.shape, key
        worst[key] = float((p.grad - w).norm() / w.norm().clamp(min=1e-30))
    assert any(key.endswith("ff/router") for key in worst)
    assert max(worst.values()) <= GRAD_REL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


def test_mixtral_ring_cache_across_its_window(ref):
    """mixtral SMOKE's own window (32): a 28-token prompt and 10 decode
    steps wrap the ring; ``generate`` emits the reference's tokens and
    the last step's logits agree within TOL."""
    import jax.numpy as jnp
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    ref_model, ref_params, params = ref["mixtral_8x7b"]
    model = LM(get_config("mixtral_8x7b", smoke=True), device="cpu")
    assert model.cfg.window == 32
    prompts = np.random.RandomState(7).randint(
        0, model.cfg.vocab, (2, 28)).astype(np.int32)
    want = ref_serve.generate(ref_model, ref_params, jnp.asarray(prompts),
                              10)
    got, logits = serve.generate(model, params,
                                 torch.from_numpy(prompts).long(), 10)
    np.testing.assert_array_equal(got, want)
    cache = model.init_cache(2, 38)
    assert cache[0]["k"].shape[2] == 32                  # a ring
    full = np.concatenate([prompts, want[:, :-1]], axis=1)
    last = ref_model.forward(ref_params, jnp.asarray(full))[:, -1]
    np.testing.assert_allclose(logits.numpy(), np.asarray(last), rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _reqs(vocab, seed=2, lens=(13, 5, 22, 9), gens=(6, 2, 9, 4)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=n).astype(np.int32), g)
            for n, g in zip(lens, gens)]


def test_planner_requested_engine_serves_hand_wired_blocks(ref,
                                                           monkeypatch):
    """``Runtime(planner=True)`` on a config the planner cannot plan:
    the engine plans nothing, builds no MLP library, dispatches no MLP
    chain and records nothing with the breaker; it serves the
    reference's planner-requested engine's greedy tokens (the
    reference's hand-wired blocks), and the cache-free forward runs
    hand-wired instead of raising.  (Both MoE configs' planner-requested
    tokens: ``test_engine_tokens_match_reference_engine_per_config``.)"""
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.core import planner, schedule_cache
    from repro_torch.kernels import ops
    ref_model, ref_params, params = ref["olmoe_1b_7b"]
    cfg = get_config("olmoe_1b_7b", smoke=True)
    assert not planner.plannable(cfg)
    calls = []
    monkeypatch.setattr(ops, "mlp_chain",
                        lambda *a, **k: calls.append(a) or None)
    reqs = _reqs(cfg.vocab)
    want, want_stats = RefEngine(
        RefLM(ref_model.cfg, RefRuntime(planner=True)), ref_params,
        choose_regime=False, **ENG_KW).run(list(reqs))
    eng = ServingEngine(LM(cfg, Runtime(kernel_ops=True, planner=True),
                           device="cpu"), params, **ENG_KW)
    assert eng.decode_plan is None and not eng._planned
    out, stats = eng.run(list(reqs))
    assert [r.tokens for r in out] == [r.tokens for r in want]
    for key in ("decode_steps", "prefills", "generated"):
        assert stats[key] == want_stats[key]
    assert stats["exec_tier"] == "configured"
    assert not calls and not planner._PLAN_MEMO
    assert schedule_cache.list_quarantined() == []
    tokens = torch.from_numpy(_batch(cfg.vocab)[0]).long()
    with torch.no_grad():
        planned = LM(cfg, Runtime(planner=True), device="cpu").forward(
            params, tokens)
        plain = LM(cfg, device="cpu").forward(params, tokens)
    assert torch.equal(planned, plain)


def test_padded_prefill_routes_its_pad_tokens(ref, jax_cpu):
    """At capacity factor 1.25 a page-padded prompt's pad tokens are
    routed in the batch-1 prefill, as the reference's are: its 52
    tokens give each expert 24 slots where the 50 real ones alone would
    give 16, so the prefill logits equal the reference's and differ
    from the same prompt prefilled unpadded (fewer drops); the engines
    then serve the same tokens."""
    import jax.numpy as jnp
    from repro.models.lm import LM as RefLM
    from repro.serving import ServingEngine as RefEngine
    ref_model, ref_params, params = ref["olmoe_1b_7b"]
    moe = dataclasses.replace(ref_model.cfg.moe, capacity_factor=1.25)
    rcfg = dataclasses.replace(ref_model.cfg, moe=moe)
    cfg = dataclasses.replace(get_config("olmoe_1b_7b", smoke=True),
                              moe=MoEConfig(8, 2, 1.25))
    model = LM(cfg, device="cpu")
    plen, ps = 50, 4
    prompt = np.random.RandomState(5).randint(0, cfg.vocab, plen)
    logits = {}
    for padded in (True, False):
        s = -(-plen // ps) * ps if padded else plen
        toks = np.zeros((1, s), np.int32)
        toks[0, :plen] = prompt
        table = np.arange(1, -(-s // ps) + 1, dtype=np.int32)[None]
        got, _ = model.prefill_paged(
            params, torch.from_numpy(toks).long(),
            model.init_paged_cache(16, ps), torch.from_numpy(table), plen)
        logits[padded] = got.numpy()
    want, _ = RefLM(rcfg).prefill_paged(
        ref_params, jnp.asarray(np.pad(prompt, (0, 2))[None]
                                .astype(np.int32)),
        RefLM(rcfg).init_paged_cache(16, ps),
        jnp.asarray(np.arange(1, 14, dtype=np.int32)[None]),
        jnp.int32(plen))
    np.testing.assert_allclose(logits[True], np.asarray(want), **TOL)
    assert not np.allclose(logits[True], logits[False], **TOL)
    reqs = [(prompt.astype(np.int32), 5),
            *_reqs(cfg.vocab, seed=4, lens=(30, 11), gens=(4, 7))]
    kw = dict(max_batch=3, page_size=ps, n_pages=40, max_pages_per_seq=14)
    want_out, _ = RefEngine(RefLM(rcfg), ref_params, choose_regime=False,
                            **kw).run(list(reqs))
    out, _ = ServingEngine(LM(cfg, Runtime(kernel_ops=True), device="cpu"),
                           params, **kw).run(list(reqs))
    assert [r.tokens for r in out] == [r.tokens for r in want_out]


def test_mixtral_engine_reclaims_across_its_window(ref):
    """The engine's window comes from mixtral's config: requests that
    run past 32 positions give their pages below the window back, and
    serve the tokens of the same engine with reclamation off and of
    the reference engine."""
    from repro.serving import ServingEngine as RefEngine
    ref_model, ref_params, params = ref["mixtral_8x7b"]
    cfg = get_config("mixtral_8x7b", smoke=True)
    reqs = _reqs(cfg.vocab, seed=6, lens=(30, 12), gens=(12, 25))

    def engine():
        return ServingEngine(LM(cfg, Runtime(kernel_ops=True),
                                device="cpu"), params, **ENG_KW)

    eng = engine()
    assert eng._window == 32
    out, stats = eng.run(list(reqs))
    assert stats["reclaimed_pages"] > 0
    base_eng = engine()
    base_eng._window = 0
    base, base_stats = base_eng.run(list(reqs))
    assert base_stats["reclaimed_pages"] == 0
    assert [r.tokens for r in out] == [r.tokens for r in base]
    want, want_stats = RefEngine(ref_model, ref_params, choose_regime=False,
                                 **ENG_KW).run(list(reqs))
    assert [r.tokens for r in out] == [r.tokens for r in want]
    assert stats["reclaimed_pages"] == want_stats["reclaimed_pages"]


def test_reliability_tiers_serve_the_moe_twin(ref):
    """The golden probe, shadows at rate 1.0 and the torch-twin tier on
    olmoe SMOKE: the twin is the same MoE code with the attention
    kernel off, so the probe and every shadow agree, and an engine
    demoted to the twin by a failed dispatch serves the same tokens."""
    from repro_torch.reliability import faults, sentinels
    _, _, params = ref["olmoe_1b_7b"]
    model = LM(get_config("olmoe_1b_7b", smoke=True),
               Runtime(kernel_ops=True), device="cpu")
    reqs = _reqs(model.cfg.vocab)
    base, _ = ServingEngine(model, params, **ENG_KW).run(list(reqs))
    with sentinels.shadowing(1.0, probe=True):
        res, stats = ServingEngine(model, params, **ENG_KW).run(list(reqs))
    assert [r.tokens for r in res] == [r.tokens for r in base]
    assert (stats["golden_probes"], stats["golden_mismatches"]) == (1, 0)
    assert stats["shadow_checks"] == (stats["decode_steps"]
                                      + stats["prefills"])
    assert stats["shadow_mismatches"] == 0
    assert stats["exec_tier"] == "configured"
    with faults.injected("engine_step", nth=0):
        res, stats = ServingEngine(model, params, **ENG_KW).run(list(reqs))
    assert stats["exec_tier"] == "torch-twin"
    assert [r.tokens for r in res] == [r.tokens for r in base]


# ---------------------------------------------------------------------------
# entry points and hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_serve_cli_runs_both_modes(arch, capsys):
    from repro_torch.launch import serve
    tokens = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--prompt-len", "6", "--gen", "3"])
    assert tokens.shape == (2, 3)
    results = serve.main(["--continuous", "--device", "cpu", "--arch", arch,
                          "--batch", "2", "--prompt-len", "8", "--gen",
                          "4", "--page-size", "4", "--requests", "3"])
    assert len(results) == 3 and all(r.tokens for r in results)
    assert "3 requests" in capsys.readouterr().out


def test_plannable_matches_reference_for_every_ported_config():
    from repro.configs import get_config as ref_config
    from repro.core import planner as ref_planner
    from repro_torch.configs import ARCHS as PORTED
    from repro_torch.core import planner
    for arch in PORTED:
        for smoke in (False, True):
            assert planner.plannable(get_config(arch, smoke=smoke)) == \
                ref_planner.plannable(ref_config(arch, smoke=smoke)), arch


def test_model_and_builder_take_moe_and_refuse_the_rest():
    from repro_torch.launch import steps as S
    cfg = get_config("olmoe_1b_7b", smoke=True)
    model = S.build_model(cfg, device="cpu")
    ff = model.init_params(0)["layers"][0]["ff"]
    assert ff["router"].dtype == torch.float32
    assert ff["w_up"].shape == (8, 64, 64)
    # what still refuses: an encoder-decoder config (EncDec's), a layer
    # kind LM does not know, and a kind without its config field
    with pytest.raises(NotImplementedError, match="EncDec"):
        LM(dataclasses.replace(cfg, family="encdec"), device="cpu")
    with pytest.raises(NotImplementedError, match="conv"):
        LM(dataclasses.replace(cfg, pattern=("conv", "attn")), device="cpu")
    with pytest.raises(NotImplementedError, match="mamba"):
        LM(dataclasses.replace(cfg, pattern=("mamba", "attn")), device="cpu")
    # a layernorm MoE stack builds: each norm has its w and b
    ln = LM(dataclasses.replace(cfg, norm="layernorm"), device="cpu")
    assert sorted(ln.init_params(0)["layers"][0]["ln2"]) == ["b", "w"]


def test_convert_keeps_the_router_f32_in_bf16(jax_cpu):
    """A bf16 config's experts carry over in bf16 with their leading E
    axis; the router stays f32 (a bf16 router would round the routing
    logits' weights)."""
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    rcfg = dataclasses.replace(ref_config("mixtral_8x7b", smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("mixtral_8x7b", smoke=True),
                              dtype="bfloat16")
    rp = jax_cpu.tree.map(np.asarray, RefLM(rcfg).init_params(
        jax_cpu.random.PRNGKey(0)))
    ff = params_from_jax(rp, cfg)["layers"][1]["ff"]
    assert ff["router"].dtype == torch.float32
    np.testing.assert_array_equal(ff["router"].numpy(),
                                  rp["stack"]["b0_attn"]["ff"]["router"][1])
    assert ff["w_down"].dtype == torch.bfloat16
    assert ff["w_down"].shape == (4, 128, 64)


# ---------------------------------------------------------------------------
# the captured engine on the card (needs an sm_90 card)
# ---------------------------------------------------------------------------

@pytest.fixture
def sm90(tmp_path, monkeypatch):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.sm90
@pytest.mark.parametrize("planned", [False, True])
def test_captured_moe_engine_equals_eager_on_card(sm90, planned):
    """olmoe SMOKE on the card: the captured decode step, top-k routing
    and the gathering combine inside the graph, serves the eager
    engine's greedy tokens; the paged attention kernel launches once
    per layer and decode step, the MLP kernel never (MoE cannot be
    planned)."""
    from repro_torch.kernels import capture
    cfg = get_config("olmoe_1b_7b", smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True, planner=planned), device=sm90)
    params = model.init_params(0)
    reqs = _reqs(cfg.vocab)
    runs = {}
    for eager in (False, True):
        eng = ServingEngine(model, params, eager_decode=eager, **ENG_KW)
        before = capture.snapshot()
        out, stats = eng.run(list(reqs))
        torch.cuda.synchronize()
        runs[eager] = ([r.tokens for r in out], stats, capture.since(before))
    (got, stats, launches), (want, _, eager_launches) = runs[False], \
        runs[True]
    assert got == want
    assert launches == eager_launches == {
        "fused_attention_partial": stats["decode_steps"] * cfg.n_layers}
