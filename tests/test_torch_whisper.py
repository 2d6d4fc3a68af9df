"""The encoder-decoder family against the JAX package's: whisper-small.

At SMOKE in f32 on the CPU (2 encoder and 2 decoder layers over 16
stand-in frames, layernorms, gelu MLPs, learned positions, tied and
unscaled embeddings), weights carried over from the JAX init
(``models.convert.encdec_params_from_jax``), inputs from a numpy seed:

* the layers: ``layernorm``, ``cross_attention_block`` from the encoder
  output and from its cache, ``attention_block(causal=False)`` without
  rope, on the naive and on the streaming twin (a length the kv block
  does not divide, as whisper's 1500 frames);
* ``EncDec.forward``, ``loss``, ``prefill`` and ``decode_step`` (the
  8-step multistep decode), ``generate``'s tokens (decoding from
  position P + n_frames, as the reference's ``generate`` does), and a
  training step's loss and gradients against ``jax.grad``;
* the weight conversion leaf by leaf, ``build_model``, and the
  refusals that remain.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.lm import LM, Runtime, requires_grad  # noqa: E402
from repro_torch.models.whisper import EncDec  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)      # tests/test_kernels.py
LOSS_ATOL = 1e-5                      # tests/test_torch_forward.py
GRAD_REL_TOL = 1e-4                   # tests/test_torch_train.py
ARCH = "whisper_small"
BATCH = 2


@pytest.fixture(scope="module")
def jax_cpu():
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture(scope="module")
def pair(jax_cpu):
    """(reference config, reference params, port params), one JAX
    init."""
    from repro.configs import get_config as ref_config
    from repro.models.whisper import EncDec as RefEncDec
    from repro_torch.models.convert import encdec_params_from_jax
    rcfg = ref_config(ARCH, smoke=True)
    ref_params = jax_cpu.jit(RefEncDec(rcfg).init_params)(
        jax_cpu.random.PRNGKey(0))
    return rcfg, ref_params, encdec_params_from_jax(
        jax_cpu.tree.map(np.asarray, ref_params), get_config(ARCH, smoke=True))


def _rules():
    from repro.dist.sharding import Rules
    return Rules.disabled()


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(vocab, s, seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (batch, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return tokens, labels


def _frames(cfg, seed=7, batch=BATCH):
    return _randn(seed, batch, cfg.encoder.n_frames, cfg.d_model)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ref_layer(jax_cpu, ref_params, side, j):
    return jax_cpu.tree.map(lambda a: a[j], ref_params[f"{side}_stack"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layernorm_matches_reference(jax_cpu):
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    x = _randn(0, 3, 5, 64, scale=3.0) + 1.5
    w, b = _randn(1, 64) + 1.0, _randn(2, 64)
    want = RL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    got = L.layernorm(_t(x), _t(w), _t(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cfg = get_config(ARCH, smoke=True)
    p = L.init_norm(cfg, "cpu")
    assert torch.equal(p["w"], torch.ones(64)) and torch.equal(
        p["b"], torch.zeros(64))
    torch.testing.assert_close(L.apply_norm(p, _t(x), cfg),
                               L.layernorm(_t(x), p["w"], p["b"],
                                           cfg.norm_eps))


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_block_matches_reference(jax_cpu, pair, s):
    """From the encoder output (a prefill: the projected k/v written
    into the cache in place) and from that cache (a decode step), each
    against the reference's."""
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    rp = _ref_layer(jax_cpu, ref_params, "dec", 1)["cross_attn"]
    p = params["dec_layers"][1]["cross_attn"]
    x, enc = _randn(3, BATCH, s, cfg.d_model), _frames(cfg, seed=4)
    want, want_kv = RL.cross_attention_block(rp, jnp.asarray(x), rcfg,
                                             _rules(),
                                             enc_out=jnp.asarray(enc))
    cache = EncDec(cfg, device="cpu").init_cache(BATCH, 8)[1]["cross"]
    got = L.cross_attention_block(p, _t(x), cfg, enc_out=_t(enc),
                                  kv_cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(want_kv[k]),
                                   **TOL)
    x2 = _randn(5, BATCH, 1, cfg.d_model)
    want, _ = RL.cross_attention_block(rp, jnp.asarray(x2), rcfg, _rules(),
                                       kv_cache=want_kv)
    got = L.cross_attention_block(p, _t(x2), cfg, kv_cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,bkv", [(16, 512), (30, 8)])
def test_bidirectional_attention_without_rope_matches_reference(
        jax_cpu, pair, s, bkv):
    """The encoder's ``attention_block(causal=False)``: whisper has no
    rope, so the positions change nothing; at S=30 with bkv 8 the
    streaming twin runs blocks of 6 keys (30 is no multiple of 8, as
    1500 is none of 512)."""
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    assert not cfg.use_rope
    rp = _ref_layer(jax_cpu, ref_params, "enc", 0)["attn"]
    p = params["enc_layers"][0]["attn"]
    x = _randn(6, BATCH, s, cfg.d_model)
    pos = np.arange(s, dtype=np.int32)
    want, _ = RL.attention_block(rp, jnp.asarray(x), rcfg, _rules(),
                                 positions=jnp.asarray(pos), causal=False,
                                 bkv=bkv)
    got = L.attention_block(p, _t(x), cfg, positions=_t(pos) + 100,
                            causal=False, bkv=bkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    causal = L.attention_block(p, _t(x), cfg, positions=_t(pos), bkv=bkv)
    assert not torch.allclose(causal, got)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_params_from_jax_leaf_by_leaf(jax_cpu, dtype):
    """Encoder layer j and decoder layer j are entry j of ``enc_stack``
    and ``dec_stack``; every leaf equal to the reference's, matrices
    and the learned positions in the config's type, the layernorms'
    ``w`` and ``b`` f32; the port's init makes the same shapes and
    types."""
    from repro.configs import get_config as ref_config
    from repro.models.whisper import EncDec as RefEncDec
    from repro_torch.models.convert import encdec_params_from_jax
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    ref = jax_cpu.tree.map(np.asarray, RefEncDec(rcfg).init_params(
        jax_cpu.random.PRNGKey(1)))
    params = encdec_params_from_jax(ref, cfg)
    want = {k: ref[k] for k in ("enc_pos", "enc_norm", "embed", "dec_pos",
                                "final_norm")}
    for side, n in (("enc", cfg.encoder.n_layers), ("dec", cfg.n_layers)):
        want[f"{side}_layers"] = [jax_cpu.tree.map(lambda a, j=j: a[j],
                                                   ref[f"{side}_stack"])
                                  for j in range(n)]
    paths = dict(T.leaves_with_paths(params))
    assert len(paths) == len(jax_cpu.tree.leaves(want))
    for key, got in paths.items():
        w = want
        for part in key.split("/"):
            w = w[int(part)] if isinstance(w, list) else w[part]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w, np.float32), key)
        assert got.dtype == (torch.float32 if key.split("/")[-1] in ("w", "b")
                             else getattr(torch, dtype)), key
    init = dict(T.leaves_with_paths(EncDec(cfg, device="cpu")
                                    .init_params(0)))
    assert {k: (tuple(t.shape), t.dtype) for k, t in init.items()} == {
        k: (tuple(t.shape), t.dtype) for k, t in paths.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_reference(jax_cpu, pair):
    from repro.models.lm import Runtime as RefRuntime
    from repro.models.whisper import EncDec as RefEncDec
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    tokens, labels = _tokens(cfg.vocab, 24)
    frames = _frames(cfg)
    ref = RefEncDec(rcfg, RefRuntime(remat=False))
    want = np.asarray(ref.forward(ref_params, jnp.asarray(tokens),
                                  jnp.asarray(frames)))
    want_loss = float(ref.loss(ref_params, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "frames": jnp.asarray(frames)}))
    model = EncDec(cfg, Runtime(kernel_ops=True), device="cpu")
    with torch.inference_mode():
        got = model.forward(params, _t(tokens).long(), _t(frames))
        loss = model.loss(params, {"tokens": _t(tokens).long(),
                                   "labels": _t(labels).long(),
                                   "frames": _t(frames)})
    assert got.shape == (BATCH, 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(loss) - want_loss) < LOSS_ATOL


@pytest.mark.parametrize("bkv", [512, 8])
def test_prefill_and_multistep_decode_match_reference(jax_cpu, pair, bkv):
    """A prefill of 20 tokens over the frames, then 8 teacher-forced
    decode steps at positions 20..27 (the reference's
    tests/test_archs_smoke.py positions): every step's logits against the
    reference's, and the last against the port's own forward within
    2e-2.  bkv 8 sends the prefill through the streaming twin over the
    cache's slots."""
    from repro.models.lm import Runtime as RefRuntime
    from repro.models.whisper import EncDec as RefEncDec
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    toks, _ = _tokens(cfg.vocab, 28, seed=1)
    frames = _frames(cfg, seed=2)
    ref = RefEncDec(rcfg, RefRuntime(remat=False, bkv=bkv))
    model = EncDec(cfg, Runtime(bkv=bkv), device="cpu")
    ref_cache = ref.init_cache(BATCH, 40)
    cache = model.init_cache(BATCH, 40)
    want, ref_cache = jax_cpu.jit(ref.prefill)(
        ref_params, jnp.asarray(toks[:, :20]), ref_cache, jnp.asarray(frames))
    got, _ = model.prefill(params, _t(toks[:, :20]).long(), cache,
                           frames=_t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, c in enumerate(cache):
        for k in ("k", "v"):
            np.testing.assert_allclose(c["cross"][k].numpy(), np.asarray(
                ref_cache["cross"][k][i]), **TOL)
    decode = jax_cpu.jit(ref.decode_step)
    for t in range(20, 28):
        want, ref_cache = decode(ref_params, ref_cache,
                                 jnp.asarray(toks[:, t]), jnp.int32(t))
        got, _ = model.decode_step(params, cache, _t(toks[:, t]).long(),
                                   torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.inference_mode():
        full = model.forward(params, _t(toks).long(), _t(frames))
    assert float((got - full[:, -1]).abs().max()) < 2e-2


def test_generate_tokens_match_reference(jax_cpu, pair):
    """``generate`` over the frames: its tokens equal the reference's,
    whose decode steps start at position P + n_frames; so the first
    decode step reads the learned position P + n_frames, not P."""
    from repro.launch import serve as ref_serve
    from repro.models.whisper import EncDec as RefEncDec
    from repro_torch.launch import serve
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    prompts, _ = _tokens(cfg.vocab, 10, seed=5)
    frames = _frames(cfg, seed=6)
    want = ref_serve.generate(RefEncDec(rcfg), ref_params,
                              jnp.asarray(prompts), 6,
                              frames=jnp.asarray(frames))
    model = EncDec(cfg, Runtime(kernel_ops=True), device="cpu")
    got, logits = serve.generate(model, params, _t(prompts).long(), 6,
                                 frames=_t(frames))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), got[:, -1])
    cache = model.init_cache(BATCH, 10 + cfg.encoder.n_frames + 6)
    first, _ = model.prefill(params, _t(prompts).long(), cache,
                             frames=_t(frames))
    tok = first.argmax(-1)
    n = cfg.encoder.n_frames
    at = {}
    for pos in (10 + n, 10):
        c = [T.map_tree(torch.clone, layer) for layer in cache]
        at[pos], _ = model.decode_step(params, c, tok,
                                       torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(at[10 + n].argmax(-1).numpy(), got[:, 1])
    assert not torch.equal(at[10 + n], at[10])


def test_train_step_matches_reference(jax_cpu, pair):
    """``EncDec.loss`` gradients against ``jax.grad`` per leaf (the
    encoder, both attentions and the learned positions under
    autograd), then one ``make_train_step`` step against the
    reference's jitted step."""
    import jax
    jnp = jax.numpy
    from repro.launch import steps as RS
    from repro.models.lm import Runtime as RefRuntime
    from repro.optim import adamw as ref_adamw
    from repro_torch.launch import steps as S
    from repro_torch.models.convert import encdec_params_from_jax
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    tokens, labels = _tokens(cfg.vocab, 24, seed=8)
    frames = _frames(cfg, seed=9)
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              "frames": jnp.asarray(frames)}
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long(),
             "frames": _t(frames)}
    rmodel = RS.build_model(rcfg, RefRuntime(remat=False))
    want_loss, want_grads = jax.value_and_grad(rmodel.loss)(ref_params,
                                                            rbatch)
    want = encdec_params_from_jax(jax.tree.map(np.asarray, want_grads), cfg)
    model = S.build_model(cfg, Runtime(), device="cpu")
    assert isinstance(model, EncDec)
    p = requires_grad(T.map_tree(lambda t: t.detach().clone(), params))
    loss = model.loss(p, batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-4)
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
    new = encdec_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    diffs = torch.cat([(a.detach() - b).abs().flatten()
                       for a, b in zip(T.leaves(p), T.leaves(new))])
    assert float(diffs.max()) <= 2 * lr
    assert float((diffs > 1e-5).float().mean()) < 1e-3


def test_frames_are_seeded_per_step():
    from repro_torch.launch.train import side_embeds
    cfg = get_config(ARCH, smoke=True)

    def frames(seed, step):
        return side_embeds(cfg, cfg.encoder.n_frames, 2, seed, step, "cpu")
    a = frames(0, 3)
    assert a.shape == (2, cfg.encoder.n_frames, cfg.d_model)
    assert a.dtype == torch.float32
    assert torch.equal(a, frames(0, 3))
    assert not torch.equal(a, frames(0, 4))
    assert not torch.equal(a, frames(1, 3))


def test_lm_with_layernorm_and_learned_positions_matches_reference(jax_cpu):
    """A decoder-only config without rope and with layernorms (no
    ported architecture has one; the reference's ``LM`` takes it with
    ``pos_embed``): the forward, a prefill and two decode steps against
    the reference's."""
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    jnp = jax_cpu.numpy
    kw = dict(use_rope=False, norm="layernorm")
    rcfg = dataclasses.replace(ref_config("qwen3_8b", smoke=True), **kw)
    cfg = dataclasses.replace(get_config("qwen3_8b", smoke=True), **kw)
    ref = RefLM(rcfg)
    ref_params = jax_cpu.jit(ref.init_params)(jax_cpu.random.PRNGKey(3))
    params = params_from_jax(jax_cpu.tree.map(np.asarray, ref_params), cfg)
    assert params["pos_embed"].shape == (65536, cfg.d_model)
    assert sorted(params["layers"][0]["ln1"]) == ["b", "w"]
    model = LM(cfg, device="cpu")
    toks, _ = _tokens(cfg.vocab, 12, seed=2)
    with torch.inference_mode():
        got = model.forward(params, _t(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.forward(
        ref_params, jnp.asarray(toks))), **TOL)
    ref_cache, cache = ref.init_cache(BATCH, 12), model.init_cache(BATCH, 12)
    want, ref_cache = ref.prefill(ref_params, jnp.asarray(toks[:, :10]),
                                  ref_cache)
    got, _ = model.prefill(params, _t(toks[:, :10]).long(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in (10, 11):
        want, ref_cache = ref.decode_step(ref_params, ref_cache,
                                          jnp.asarray(toks[:, t]),
                                          jnp.int32(t))
        got, _ = model.decode_step(params, cache, _t(toks[:, t]).long(),
                                   torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_refusals_that_remain():
    """``LM`` refuses an encoder-decoder config (``EncDec``'s) and an
    unknown layer kind; ``EncDec`` a config without an encoder; paged
    serving an encoder-decoder, as the reference's ``run_continuous``
    does."""
    from repro_torch.launch.serve import run_continuous
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="EncDec"):
        LM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="conv"):
        LM(dataclasses.replace(get_config("qwen3_8b", smoke=True),
                               pattern=("conv",)), device="cpu")
    with pytest.raises(ValueError, match="no encoder"):
        EncDec(get_config("qwen3_8b", smoke=True), device="cpu")
    model = EncDec(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="fixed-batch"):
        run_continuous(cfg, model, model.init_params(0), batch=2,
                       n_requests=2, prompt_len=8, gen=2, page_size=4)
