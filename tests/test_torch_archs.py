"""The hybrid and vision-prefix decoders against the JAX package's.

recurrentgemma-2b (RG-LRU blocks and local attention in the pattern
(rglru, rglru, attn), GeGLU, tied and scaled embeddings) and pixtral-12b
(a dense backbone after ``n_prefix_embeds`` stand-in patch embeddings)
at SMOKE in f32 on the CPU, weights carried over from the JAX init
(``models.convert.params_from_jax``), inputs from a numpy seed:

* the layers: ``causal_conv1d`` with and without a state, ``rglru_block``
  (the parallel scan at S = 1, 7 and 64, from a zero and a nonzero
  state, and the one-token decode branch), the GeGLU ``mlp_block``;
* the weight conversion leaf by leaf (the interleaved super-blocks, the
  tail, the f32 leaves of a bf16 model, no ``lm_head`` when tied);
* ``LM.forward`` and ``loss`` with ``kernel_ops`` off and on (the fused
  attention's plain version on the CPU, entered once per attention
  layer), prefill and multi-step decode across the local window,
  ``generate``'s tokens, and a training step's loss and gradients
  against ``jax.grad``;
* ``n_params``, ``active_params`` and ``sub_quadratic`` of every ported
  config, and the paged engine's refusal of both families;
* the captured-step contract of the recurrent state: a decode step
  writes the same ``conv``/``lru`` tensors in place.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.lm import LM, Runtime, requires_grad  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)      # tests/test_kernels.py
LOSS_ATOL = 1e-5                      # tests/test_torch_forward.py
# f32 gradients summed in other orders (tests/test_torch_train.py)
GRAD_REL_TOL = 1e-4
FAMILIES = ["recurrentgemma_2b", "pixtral_12b"]
BATCH = 2


@pytest.fixture(scope="module")
def jax_cpu():
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture(autouse=True)
def _hermetic_caches(tmp_path, monkeypatch):
    from repro_torch.core import api
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    api.clear_cache()
    yield
    api.clear_cache()


@pytest.fixture(scope="module")
def pairs(jax_cpu):
    """arch -> (reference config, reference params, port params), one
    JAX init per config."""
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    out = {}
    for arch in FAMILIES:
        rcfg = ref_config(arch, smoke=True)
        ref_params = jax_cpu.jit(RefLM(rcfg).init_params)(
            jax_cpu.random.PRNGKey(0))
        out[arch] = (rcfg, ref_params, params_from_jax(
            jax_cpu.tree.map(np.asarray, ref_params),
            get_config(arch, smoke=True)))
    return out


def _rules():
    from repro.dist.sharding import Rules
    return Rules.disabled()


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(vocab, s, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (BATCH, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return tokens, labels


def _prefix(cfg, seed=7):
    """The stand-in patch embeddings of a vision config, else None."""
    if not cfg.n_prefix_embeds:
        return None
    return _randn(seed, BATCH, cfg.n_prefix_embeds, cfg.d_model)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(jax_cpu, s, with_state):
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    x, w = _randn(0, 2, s, 16), _randn(1, 4, 16, scale=0.5)
    state = _randn(2, 2, 3, 16) if with_state else None
    want_y, want_state = RL.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    y, new_state = L.causal_conv1d(_t(x), _t(w), _t(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(new_state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("s", [1, 7, 64])
@pytest.mark.parametrize("state", ["none", "zero", "nonzero"])
def test_rglru_block_matches_reference(jax_cpu, pairs, s, state):
    """The block's output and new state against the reference's: the
    parallel scan over S tokens (cache-free, or from a state it folds
    in), and at S=1 with a state the one-token decode branch."""
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pairs["recurrentgemma_2b"]
    cfg = get_config("recurrentgemma_2b", smoke=True)
    rp = jax_cpu.tree.map(lambda a: a[0], ref_params["stack"]["b0_rglru"])
    p = params["layers"][0]["mix"]
    w = int(cfg.rglru.width_mult * cfg.d_model)
    x = _randn(3, BATCH, s, cfg.d_model)
    st = None
    if state != "none":
        k = cfg.rglru.conv_kernel - 1
        scale = 0.0 if state == "zero" else 1.0
        st = {"conv": _randn(4, BATCH, k, w, scale=scale),
              "lru": _randn(5, BATCH, w, scale=scale)}
    want, want_state = RL.rglru_block(
        rp["mix"], jnp.asarray(x), rcfg, _rules(),
        state=None if st is None else jax_cpu.tree.map(jnp.asarray, st))
    port_state = None if st is None else {k: _t(v).clone()
                                          for k, v in st.items()}
    got = L.rglru_block(p, _t(x), cfg, state=port_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if st is not None:
        for k in ("conv", "lru"):
            np.testing.assert_allclose(port_state[k].numpy(),
                                       np.asarray(want_state[k]), **TOL)


def test_linear_scan_equals_the_sequential_recurrence():
    """The Hillis-Steele scan against h_t = a_t h_{t-1} + b_t token by
    token, at a length that is no power of two."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 37, 5, generator=g)
    b = torch.randn(2, 37, 5, generator=g)
    a_sc, h = L.linear_scan(a, b)
    hp, ap = torch.zeros(2, 5), torch.ones(2, 5)
    for t in range(37):
        hp, ap = a[:, t] * hp + b[:, t], ap * a[:, t]
        torch.testing.assert_close(h[:, t], hp, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a_sc[:, t], ap, rtol=1e-5, atol=1e-7)


def test_geglu_mlp_matches_reference(jax_cpu, pairs):
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pairs["recurrentgemma_2b"]
    cfg = get_config("recurrentgemma_2b", smoke=True)
    assert cfg.act == "geglu"
    x = _randn(6, BATCH, 5, cfg.d_model)
    rp = jax_cpu.tree.map(lambda a: a[0], ref_params["stack"]["b0_rglru"])
    want = RL.mlp_block(rp["ff"], jnp.asarray(x), rcfg, _rules())
    got = L.mlp_block(params["layers"][0]["ff"], _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_at_d256_group_10_matches_pallas(jax_cpu, dtype):
    """recurrentgemma's attention shape — head dim 256, ten q-heads on
    one kv head, a causal window — through the fused attention's plain
    version against the JAX kernel in interpret mode (f32, and bf16
    inputs upcast on the reference's side as the plain version widens
    them)."""
    from repro.kernels import attention as RA
    jnp = jax_cpu.numpy
    b, hq, hkv, s, d, win, bq, bkv = 1, 10, 1, 64, 256, 32, 16, 16
    q, k, v = (_randn(i, b, h, s, d) for i, h in ((0, hq), (1, hkv),
                                                     (2, hkv)))
    dt = getattr(torch, dtype)
    tq, tk, tv = (_t(a).to(dt) for a in (q, k, v))
    want = RA.fused_attention(*(jnp.asarray(t.float().numpy())
                                for t in (tq, tk, tv)), bq=bq, bkv=bkv,
                              causal=True, window=win, interpret=True)
    got = A.fused_attention(tq, tk, tv, bq=bq, bkv=bkv, causal=True,
                            window=win)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("arch,b,s", [("recurrentgemma_2b", 1, 4096),
                                      ("pixtral_12b", 2, 2048)])
def test_tuner_tiles_fit_the_kernel_at_the_forward_shapes(arch, b, s):
    """The H100 tuner's (bq, bkv) at each family's card forward: tiles
    of the bf16 kernel's register bucket for the head dim (kv tiles up
    to 64 at 256) whose shared memory one block of the card holds."""
    from repro_torch.core import api
    from repro_torch.core import perf_model as PM
    cfg = get_config(arch)
    window = cfg.attn_window
    tk = api.fuse_attention(s, s, cfg.dh, cfg.dh, heads=cfg.n_heads,
                            batch=b, dtype="bfloat16", causal=True,
                            window=window)
    bq, bkv = tk.params.bq, tk.params.bkv
    assert s % bq == 0 and s % bkv == 0
    assert PM.attention_tiles_ok(bq, bkv, cfg.dh, cfg.dh, 2)
    assert bkv <= PM.attention_mma_bkv_max(cfg.dh)
    assert PM.attention_smem_bytes(bq, bkv, cfg.dh, cfg.dh, 2) \
        <= PM.H100.smem_per_block


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_leaf_by_leaf(jax_cpu, arch, dtype):
    """Layer i of the port is super-block i // len(pattern)'s entry of
    ``stack["b{i % len(pattern)}_{kind}"]``, then the tail; every leaf
    equal to the reference's; in bf16 the matrices bf16 and the norm
    scales, ``lam`` and ``conv_w`` f32; no ``lm_head`` when tied."""
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    ref = jax_cpu.tree.map(np.asarray, RefLM(rcfg).init_params(
        jax_cpu.random.PRNGKey(1)))
    params = params_from_jax(ref, cfg)
    model = LM(cfg, device="cpu")
    pat = list(cfg.pattern)
    n_super = cfg.n_layers // len(pat)
    want_layers = [jax_cpu.tree.map(lambda a, j=j: a[j],
                                    ref["stack"][f"b{i}_{kind}"])
                   for j in range(n_super) for i, kind in enumerate(pat)]
    want_layers += list(ref["tail"])
    assert len(params["layers"]) == len(want_layers) == cfg.n_layers
    assert [("lam" in p["mix"]) for p in params["layers"]] == [
        k == "rglru" for k in model.kinds]
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    want = {"embed": ref["embed"], "final_norm": ref["final_norm"],
            "layers": want_layers}
    if "lm_head" in ref:
        want["lm_head"] = ref["lm_head"]
    paths = dict(T.leaves_with_paths(params))
    assert len(paths) == len(jax_cpu.tree.leaves(want))
    for key, got in paths.items():
        w = want
        for part in key.split("/"):
            w = w[int(part)] if isinstance(w, list) else w[part]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w, np.float32), key)
        want_dt = (torch.float32 if key.split("/")[-1] in ("w", "lam",
                                                           "conv_w")
                   else getattr(torch, dtype))
        assert got.dtype == want_dt, key
    init = dict(T.leaves_with_paths(model.init_params(0)))
    assert {k: (tuple(t.shape), t.dtype) for k, t in init.items()} == {
        k: (tuple(t.shape), t.dtype) for k, t in paths.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# (S, bkv): the recurrentgemma SMOKE window is 32, so S=40 crosses it;
# bkv 8 sends the twin through streaming_attention (S > 2 bkv)
SHAPES = [(40, 512), (40, 8)]


@pytest.mark.parametrize("s,bkv", SHAPES)
@pytest.mark.parametrize("kernel_ops", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match_reference(jax_cpu, pairs, monkeypatch,
                                          arch, kernel_ops, s, bkv):
    """Logits over prefix and tokens, and the loss over the tokens, equal
    the reference's; with ``kernel_ops`` the fused attention's plain
    version runs once per attention layer and forward, at the layer's
    window."""
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pairs[arch]
    cfg = get_config(arch, smoke=True)
    tokens, labels = _tokens(cfg.vocab, s - cfg.n_prefix_embeds)
    prefix = _prefix(cfg)
    ref = RefLM(rcfg, RefRuntime(kernel_ops=kernel_ops, bkv=bkv,
                                 remat=False))
    jpre = None if prefix is None else jnp.asarray(prefix)
    want = np.asarray(ref.forward(ref_params, jnp.asarray(tokens), jpre))
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    if prefix is not None:
        rbatch["prefix_embeds"] = jpre
        batch["prefix_embeds"] = _t(prefix)
    want_loss = float(ref.loss(ref_params, rbatch))
    calls = []
    plain = A.fused_attention_plain
    monkeypatch.setattr(A, "fused_attention_plain",
                        lambda *a: calls.append(a[5]) or plain(*a))
    model = LM(cfg, Runtime(kernel_ops=kernel_ops, bkv=bkv), device="cpu")
    with torch.inference_mode():
        got = model.forward(params, batch["tokens"], batch.get(
            "prefix_embeds"))
        loss = model.loss(params, batch)
    assert got.shape == (BATCH, s, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(loss) - want_loss) < LOSS_ATOL
    n_attn = model.kinds.count("attn")
    window = cfg.attn_window
    assert calls == ([window] * 2 * n_attn if kernel_ops else [])


def _decode_pair(jax_cpu, pairs, arch, plen, gen):
    """The logits of prefill + ``gen - 1`` decode steps, each fed the
    reference's greedy token, on both sides; returns the lists and the
    port's cache."""
    from repro.models.lm import LM as RefLM
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pairs[arch]
    cfg = get_config(arch, smoke=True)
    prompts, _ = _tokens(cfg.vocab, plen, seed=4)
    prefix = _prefix(cfg)
    extra = cfg.n_prefix_embeds
    ref = RefLM(rcfg)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    ref_cache = ref.init_cache(BATCH, extra + plen + gen)
    cache = model.init_cache(BATCH, extra + plen + gen)
    kw = {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}
    want, ref_cache = jax_cpu.jit(ref.prefill)(ref_params,
                                               jnp.asarray(prompts),
                                               ref_cache, **kw)
    got, cache = model.prefill(params, _t(prompts).long(), cache,
                               prefix_embeds=_t(prefix))
    wants, gots = [np.asarray(want)], [got.numpy()]
    decode = jax_cpu.jit(ref.decode_step)
    for i in range(gen - 1):
        tok = np.argmax(wants[-1], axis=-1).astype(np.int32)
        want, ref_cache = decode(ref_params, ref_cache, jnp.asarray(tok),
                                 jnp.int32(extra + plen + i))
        got, cache = model.decode_step(
            params, cache, _t(tok).long(),
            torch.tensor(extra + plen + i, dtype=torch.int32))
        wants.append(np.asarray(want))
        gots.append(got.numpy())
    return wants, gots, cache


# recurrentgemma's window of 32: a prompt of 30 decodes across it; one
# of 40 is a prefill longer than the ring
@pytest.mark.parametrize("arch,plen", [("recurrentgemma_2b", 30),
                                       ("recurrentgemma_2b", 40),
                                       ("pixtral_12b", 7)])
def test_prefill_and_decode_steps_match_reference(jax_cpu, pairs, arch,
                                                  plen):
    wants, gots, _ = _decode_pair(jax_cpu, pairs, arch, plen, 6)
    for got, want in zip(gots, wants):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_tokens_match_reference(jax_cpu, pairs, arch):
    from repro.launch import serve as ref_serve
    from repro.models.lm import LM as RefLM
    from repro_torch.launch import serve
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pairs[arch]
    cfg = get_config(arch, smoke=True)
    prompts, _ = _tokens(cfg.vocab, 30, seed=5)
    prefix = _prefix(cfg)
    kw = {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}
    want = ref_serve.generate(RefLM(rcfg), ref_params, jnp.asarray(prompts),
                              6, **kw)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    got, logits = serve.generate(model, params, _t(prompts).long(), 6,
                                 prefix_embeds=_t(prefix))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), got[:, -1])


def test_decode_step_writes_the_recurrent_state_in_place(jax_cpu, pairs):
    """Two decode steps on one cache: every ``conv``/``lru`` and k/v
    tensor is the same object at the same address after each step (what
    a CUDA graph's replay needs), its contents move, and the second
    step's logits are the reference's."""
    cfg = get_config("recurrentgemma_2b", smoke=True)
    _, ref_params, params = pairs["recurrentgemma_2b"]
    wants, _, _ = _decode_pair(jax_cpu, pairs, "recurrentgemma_2b", 30, 3)
    model = LM(cfg, Runtime(), device="cpu")
    prompts, _ = _tokens(cfg.vocab, 30, seed=4)
    cache = model.init_cache(BATCH, 33)
    logits, _ = model.prefill(params, _t(prompts).long(), cache)
    leaves = [(c, k, c[k], c[k].data_ptr()) for c in cache for k in c]
    for i in range(2):
        before = [t.clone() for _, _, t, _ in leaves]
        tok = torch.from_numpy(np.argmax(wants[i], axis=-1)).long()
        logits, out = model.decode_step(params, cache, tok,
                                        torch.tensor(30 + i,
                                                     dtype=torch.int32))
        assert out is cache
        for (c, k, t, ptr), old in zip(leaves, before):
            assert c[k] is t and t.data_ptr() == ptr, k
        moved = [k for (_, k, t, _), old in zip(leaves, before)
                 if k in ("conv", "lru") and not torch.equal(t, old)]
        assert len(moved) == 2 * model.kinds.count("rglru")
    np.testing.assert_allclose(logits.numpy(), wants[2], **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(jax_cpu, pairs, arch):
    """``LM.loss`` gradients against ``jax.grad`` per leaf, then one
    ``make_train_step`` step against the reference's jitted step (the
    RG-LRU scan under autograd, the prefix embeddings in the batch)."""
    import jax
    jnp = jax.numpy
    from repro.launch import steps as RS
    from repro.models.lm import Runtime as RefRuntime
    from repro.optim import adamw as ref_adamw
    from repro_torch.launch import steps as S
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    rcfg, ref_params, params = pairs[arch]
    cfg = get_config(arch, smoke=True)
    tokens, labels = _tokens(cfg.vocab, 40 - cfg.n_prefix_embeds, seed=8)
    prefix = _prefix(cfg, seed=9)
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    if prefix is not None:
        rbatch["prefix_embeds"] = jnp.asarray(prefix)
        batch["prefix_embeds"] = _t(prefix)
    rmodel = RS.build_model(rcfg, RefRuntime(remat=False, bkv=8))
    want_loss, want_grads = jax.value_and_grad(rmodel.loss)(ref_params,
                                                            rbatch)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads), cfg)
    model = S.build_model(cfg, Runtime(bkv=8), device="cpu")
    p = requires_grad(T.map_tree(lambda t: t.detach().clone(), params))
    loss = model.loss(p, batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=1e-4)
    worst = {}
    for (key, leaf), w in zip(T.leaves_with_paths(p), T.leaves(want)):
        assert leaf.grad is not None and leaf.grad.shape == w.shape, key
        worst[key] = float((leaf.grad - w).norm()
                           / w.norm().clamp(min=1e-30))
    assert max(worst.values()) <= GRAD_REL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]

    lr = 1e-3
    ropt = ref_adamw.AdamW(lr=ref_adamw.cosine_schedule(lr, warmup=2,
                                                        total=10))
    jp, _, jinfo = jax.jit(RS.make_train_step(rmodel, ropt))(
        ref_params, ropt.init(ref_params), rbatch)
    opt = AdamW(lr=cosine_schedule(lr, warmup=2, total=10))
    p = T.map_tree(lambda t: t.detach().clone(), params)
    p, _, info = S.make_train_step(model, opt)(p, opt.init(p), batch)
    assert float(info["loss"]) == pytest.approx(float(jinfo["loss"]),
                                                rel=1e-4)
    assert float(info["grad_norm"]) == pytest.approx(
        float(jinfo["grad_norm"]), rel=GRAD_REL_TOL)
    new = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    diffs = torch.cat([(a.detach() - b).abs().flatten()
                       for a, b in zip(T.leaves(p), T.leaves(new))])
    assert float(diffs.max()) <= 2 * lr
    # a flip moves a weight by ~2 lr; the rest agree to f32 rounding
    assert float((diffs > 1e-5).float().mean()) < 1e-3


# ---------------------------------------------------------------------------
# configs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch, smoke):
    """``n_params``, ``active_params`` and ``sub_quadratic`` equal the
    reference's for every ported config, the GeGLU undercount
    included."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    cfg, rcfg = get_config(arch, smoke=smoke), ref_config(arch, smoke=smoke)
    assert cfg.n_params() == rcfg.n_params()
    assert cfg.active_params() == rcfg.active_params()
    assert cfg.sub_quadratic == rcfg.sub_quadratic


def test_recurrentgemma_tensors_outnumber_n_params():
    """The reference's formula counts GeGLU as two matrices; the tensors
    hold three (2.894 B against 2.383 B at FULL, ROADMAP Queue 3).  At
    SMOKE the same gap: one d_model x d_ff matrix per layer."""
    cfg = get_config("recurrentgemma_2b", smoke=True)
    held = sum(t.numel() for t in T.leaves(LM(cfg, device="cpu")
                                           .init_params(0))
               if t.ndim >= 2)
    conv = (cfg.rglru.conv_kernel * cfg.d_model
            * LM(cfg, device="cpu").kinds.count("rglru"))
    assert held - conv - cfg.n_params() == cfg.n_layers * cfg.d_model \
        * cfg.d_ff
    full = get_config("recurrentgemma_2b")
    assert round(full.n_params() / 1e9, 3) == 2.383


@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_serving_refuses_both_families(arch):
    from repro_torch.launch.serve import run_continuous
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    params = model.init_params(0)
    with pytest.raises(NotImplementedError, match="paged serving"):
        model.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError):
        run_continuous(cfg, model, params, batch=2, n_requests=2,
                       prompt_len=8, gen=2, page_size=4)


@pytest.mark.parametrize("arch", ["pixtral-12b", "recurrentgemma-2b"])
def test_serve_and_train_clis_run_both_families(arch, capsys):
    """The fixed-batch serve CLI (a vision config with its demo prefix
    embeddings) and the train CLI (a vision config's batch with its
    per-step prefix embeddings) on the CPU."""
    from repro_torch.launch import serve, train
    tokens = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--prompt-len", "6", "--gen", "3"])
    assert tokens.shape == (2, 3)
    out = train.main(["--device", "cpu", "--arch", arch, "--steps", "3",
                      "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert "generated (2, 3)" in capsys.readouterr().out


def test_prefix_embeds_are_seeded_per_step():
    from repro_torch.launch.train import prefix_embeds
    cfg = get_config("pixtral_12b", smoke=True)
    a = prefix_embeds(cfg, 2, 0, 3, "cpu")
    assert a.shape == (2, cfg.n_prefix_embeds, cfg.d_model)
    assert torch.equal(a, prefix_embeds(cfg, 2, 0, 3, "cpu"))
    assert not torch.equal(a, prefix_embeds(cfg, 2, 0, 4, "cpu"))
    assert not torch.equal(a, prefix_embeds(cfg, 2, 1, 3, "cpu"))
