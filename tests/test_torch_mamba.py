"""The state-space family against the JAX package's: mamba2-1.3b.

At SMOKE in f32 on the CPU (2 Mamba-2 layers, no MLP, tied and scaled
embeddings, SSD chunk 16), weights carried over from the JAX init
(``models.convert.params_from_jax``), inputs from a numpy seed:

* the SSD: ``_ssd_chunked`` at lengths that are and are not a multiple
  of the chunk (zero-padded, as ``mamba_block`` pads), against the
  reference's and against the sequential recurrence ``ssd_step``; its
  gradient finite at a chunk of 256, where the reference's
  exp-then-select overflows;
* ``mamba_block`` cache-free, and a prefill then one-token decode steps
  over a state written in place;
* ``LM.forward``, ``loss``, ``prefill`` and ``decode_step`` (the
  reference's 8-step multistep decode), ``generate``'s tokens, and a
  training step's loss and gradients against ``jax.grad``;
* the weight conversion leaf by leaf, the cache's shapes, and the paged
  engine's refusal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.lm import LM, Runtime, requires_grad  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)      # tests/test_kernels.py
LOSS_ATOL = 1e-5                      # tests/test_torch_forward.py
GRAD_REL_TOL = 1e-4                   # tests/test_torch_train.py
ARCH = "mamba2_1p3b"
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
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    rcfg = ref_config(ARCH, smoke=True)
    ref_params = jax_cpu.jit(RefLM(rcfg).init_params)(
        jax_cpu.random.PRNGKey(0))
    return rcfg, ref_params, params_from_jax(
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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ssd_inputs(s, seed=0, h=3, p=4, n=8, dt_scale=0.5):
    """xh (B, s, H, P), dA (B, s, H) <= 0, B and C (B, s, N)."""
    xh = _randn(seed, BATCH, s, h, p)
    da = -np.abs(_randn(seed + 1, BATCH, s, h, scale=dt_scale))
    return xh, da, _randn(seed + 2, BATCH, s, n), _randn(seed + 3, BATCH, s, n)


# ---------------------------------------------------------------------------
# the SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,pad", [(32, 0), (48, 0), (40, 8)])
def test_ssd_chunked_matches_reference(jax_cpu, s, pad):
    """y and the final state against the reference's ``_ssd_chunked``
    at chunk 16: two and three chunks, and 40 steps zero-padded to 48
    (the padded steps carry dA = 0 and x = 0: the state is unchanged)."""
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    xh, da, b, c = _ssd_inputs(s)
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (xh, da, b, c)]
    want_y, want_h = RL._ssd_chunked(*map(jnp.asarray, padded), 16)
    y, h = L._ssd_chunked(*map(_t, padded), 16)
    np.testing.assert_allclose(y[:, :s].numpy(), np.asarray(want_y)[:, :s],
                               **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    hs = torch.zeros_like(h)
    for t in range(s):
        _, hs = L.ssd_step(hs, *(_t(a[:, t]) for a in (xh, da, b, c)))
    torch.testing.assert_close(h, hs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_equals_the_sequential_recurrence(chunk):
    """The chunked form against ``ssd_step`` stepped over all 64
    positions: every y_t and the final state."""
    xh, da, b, c = map(_t, _ssd_inputs(64, seed=3))
    y, h = L._ssd_chunked(xh, da, b, c, chunk)
    hs = torch.zeros(BATCH, 3, 8, 4)
    for t in range(64):
        yt, hs = L.ssd_step(hs, xh[:, t], da[:, t], b[:, t], c[:, t])
        torch.testing.assert_close(y[:, t], yt, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(h, hs, rtol=1e-4, atol=1e-5)


def test_ssd_gradient_is_finite_where_the_reference_overflows(jax_cpu):
    """At a chunk of 256 the decay's upper triangle reaches exp(seg)
    past f32's range (seg ~ 205 here).  The reference exponentiates and
    then selects, so its gradient multiplies inf by a zero cotangent
    (NaN; ROADMAP Queue 3); the port masks before the exp: the same
    forward, a finite gradient, the reference's where it is finite."""
    import jax
    from repro.models import layers as RL
    jnp = jax.numpy
    xh, da, b, c = _ssd_inputs(256, seed=5, dt_scale=1.0)

    def ref_sum(*args):
        y, h = RL._ssd_chunked(*args, 256)
        return jnp.sum(y) + jnp.sum(h)
    want = jax.grad(ref_sum, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (xh, da, b, c)))
    args = [_t(a).requires_grad_(True) for a in (xh, da, b, c)]
    y, h = L._ssd_chunked(*args, 256)
    (y.sum() + h.sum()).backward()
    assert np.isnan(np.asarray(want[1])).any()
    for a, w in zip(args, want):
        assert torch.isfinite(a.grad).all()
        w = np.asarray(w)
        ok = np.isfinite(w)
        np.testing.assert_allclose(a.grad.numpy()[ok], w[ok], rtol=1e-3,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _ref_layer(jax_cpu, ref_params, j=0):
    return jax_cpu.tree.map(lambda a: a[j], ref_params["stack"]["b0_mamba"])


@pytest.mark.parametrize("s", [1, 40, 48])
def test_mamba_block_cache_free_matches_reference(jax_cpu, pair, s):
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    x = _randn(7, BATCH, s, cfg.d_model)
    want, _ = RL.mamba_block(_ref_layer(jax_cpu, ref_params)["mix"],
                             jnp.asarray(x), rcfg, _rules())
    got = L.mamba_block(params["layers"][0]["mix"], _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_block_prefill_then_decode_matches_reference(jax_cpu, pair):
    """A prefill of 21 tokens (padded to two chunks) into a zero state,
    then three one-token steps: each output and the new ``conv`` and
    ``ssm`` state against the reference's, the state tensors written in
    place."""
    from repro.models import layers as RL
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    rp = _ref_layer(jax_cpu, ref_params, 1)["mix"]
    p = params["layers"][1]["mix"]
    state = LM(cfg, device="cpu").init_cache(BATCH, 24)[1]
    ref_state = jax_cpu.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    ptrs = {k: t.data_ptr() for k, t in state.items()}
    x = _randn(8, BATCH, 24, cfg.d_model)
    for t0, t1 in ((0, 21), (21, 22), (22, 23), (23, 24)):
        want, ref_state = RL.mamba_block(rp, jnp.asarray(x[:, t0:t1]), rcfg,
                                         _rules(), state=ref_state)
        got = L.mamba_block(p, _t(x[:, t0:t1]), cfg, state=state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("conv", "ssm"):
            assert state[k].data_ptr() == ptrs[k]
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(ref_state[k]), **TOL)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_leaf_by_leaf(jax_cpu, dtype):
    """Every leaf equal to the reference's layer j of ``b0_mamba``; in
    bf16 the matrices bf16 and ``conv_w``, ``A_log``, ``D``,
    ``dt_bias``, ``norm_w`` and the norms f32; no ``ln2``/``ff`` (d_ff
    = 0) and no ``lm_head`` (tied); the port's init makes the same
    shapes and types."""
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    ref = jax_cpu.tree.map(np.asarray, RefLM(rcfg).init_params(
        jax_cpu.random.PRNGKey(1)))
    params = params_from_jax(ref, cfg)
    assert sorted(params) == ["embed", "final_norm", "layers"]
    assert all(sorted(p) == ["ln1", "mix"] for p in params["layers"])
    for j, p in enumerate(params["layers"]):
        want = jax_cpu.tree.map(lambda a: a[j], ref["stack"]["b0_mamba"])
        for key, got in T.leaves_with_paths(p):
            w = want
            for part in key.split("/"):
                w = w[part]
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(w, np.float32), key)
            matrix = key.split("/")[-1] in ("w_in", "w_out")
            assert got.dtype == (getattr(torch, dtype) if matrix
                                 else torch.float32), key
    init = dict(T.leaves_with_paths(LM(cfg, device="cpu").init_params(0)))
    assert {k: (tuple(t.shape), t.dtype) for k, t in init.items()} == {
        k: (tuple(t.shape), t.dtype)
        for k, t in T.leaves_with_paths(params)}


def test_cache_shapes_match_reference(jax_cpu):
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        want = jax_cpu.eval_shape(lambda: RefLM(ref_config(
            ARCH, smoke=smoke)).init_cache(3, 40))["stack"][0]
        dev = "meta"
        got = LM(cfg, device=dev).init_cache(3, 40)
        assert len(got) == cfg.n_layers
        for k in ("conv", "ssm"):
            assert tuple(got[0][k].shape) == want[k].shape[1:]
            assert str(got[0][k].dtype).replace("torch.", "") == str(
                want[k].dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [37, 48])
def test_forward_and_loss_match_reference(jax_cpu, pair, s):
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    tokens, labels = _tokens(cfg.vocab, s)
    ref = RefLM(rcfg, RefRuntime(remat=False))
    want = np.asarray(ref.forward(ref_params, jnp.asarray(tokens)))
    want_loss = float(ref.loss(ref_params, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels)}))
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    with torch.inference_mode():
        got = model.forward(params, _t(tokens).long())
        loss = model.loss(params, {"tokens": _t(tokens).long(),
                                   "labels": _t(labels).long()})
    assert got.shape == (BATCH, s, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(loss) - want_loss) < LOSS_ATOL


def test_prefill_and_multistep_decode_match_reference(jax_cpu, pair):
    """tests/test_archs_smoke.py:89-106 on both sides: a prefill of 40
    tokens, then 8 teacher-forced decode steps; every step's logits
    against the reference's, and the last against the port's own
    forward within the reference test's 2e-2."""
    from repro.models.lm import LM as RefLM
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    toks, _ = _tokens(cfg.vocab, 48, seed=1, batch=1)
    ref = RefLM(rcfg)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    ref_cache = ref.init_cache(1, 64)
    cache = model.init_cache(1, 64)
    want, ref_cache = jax_cpu.jit(ref.prefill)(ref_params,
                                               jnp.asarray(toks[:, :40]),
                                               ref_cache)
    got, _ = model.prefill(params, _t(toks[:, :40]).long(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    decode = jax_cpu.jit(ref.decode_step)
    for t in range(40, 48):
        want, ref_cache = decode(ref_params, ref_cache,
                                 jnp.asarray(toks[:, t]), jnp.int32(t))
        got, _ = model.decode_step(params, cache, _t(toks[:, t]).long(),
                                   torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.inference_mode():
        full = model.forward(params, _t(toks).long())
    assert float((got - full[:, -1]).abs().max()) < 2e-2


def test_generate_tokens_match_reference(jax_cpu, pair):
    from repro.launch import serve as ref_serve
    from repro.models.lm import LM as RefLM
    from repro_torch.launch import serve
    jnp = jax_cpu.numpy
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    prompts, _ = _tokens(cfg.vocab, 20, seed=5)
    want = ref_serve.generate(RefLM(rcfg), ref_params, jnp.asarray(prompts),
                              6)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    got, logits = serve.generate(model, params, _t(prompts).long(), 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), got[:, -1])


def test_train_step_matches_reference(jax_cpu, pair):
    """``LM.loss`` gradients against ``jax.grad`` per leaf (the chunked
    SSD and the conv under autograd, 40 tokens: a padded chunk), then
    one ``make_train_step`` step against the reference's jitted step."""
    import jax
    jnp = jax.numpy
    from repro.launch import steps as RS
    from repro.models.lm import Runtime as RefRuntime
    from repro.optim import adamw as ref_adamw
    from repro_torch.launch import steps as S
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    rcfg, ref_params, params = pair
    cfg = get_config(ARCH, smoke=True)
    tokens, labels = _tokens(cfg.vocab, 40, seed=8)
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    rmodel = RS.build_model(rcfg, RefRuntime(remat=False))
    want_loss, want_grads = jax.value_and_grad(rmodel.loss)(ref_params,
                                                            rbatch)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads), cfg)
    model = S.build_model(cfg, Runtime(), device="cpu")
    assert isinstance(model, LM)
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
    new = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    diffs = torch.cat([(a.detach() - b).abs().flatten()
                       for a, b in zip(T.leaves(p), T.leaves(new))])
    assert float(diffs.max()) <= 2 * lr
    assert float((diffs > 1e-5).float().mean()) < 1e-3


def test_decode_step_writes_the_state_in_place(pair):
    """Two decode steps on one cache: every ``conv``/``ssm`` tensor is
    the same object at the same address after each step (what a CUDA
    graph's replay needs), and its contents move."""
    cfg = get_config(ARCH, smoke=True)
    _, _, params = pair
    model = LM(cfg, Runtime(), device="cpu")
    prompts, _ = _tokens(cfg.vocab, 20, seed=4)
    cache = model.init_cache(BATCH, 24)
    model.prefill(params, _t(prompts).long(), cache)
    leaves = [(c, k, c[k], c[k].data_ptr()) for c in cache for k in c]
    for i in range(2):
        before = [t.clone() for _, _, t, _ in leaves]
        _, out = model.decode_step(params, cache, _t(prompts[:, i]).long(),
                                   torch.tensor(20 + i, dtype=torch.int32))
        assert out is cache
        for (c, k, t, ptr), old in zip(leaves, before):
            assert c[k] is t and t.data_ptr() == ptr, k
            assert not torch.equal(t, old), k


@pytest.mark.parametrize("smoke", [True, False])
def test_neither_config_is_plannable(smoke):
    from repro_torch.core import planner
    for arch in (ARCH, "whisper_small"):
        assert not planner.plannable(get_config(arch, smoke=smoke))


def test_paged_serving_refuses_the_state_space_stack():
    from repro_torch.launch.serve import run_continuous
    cfg = get_config(ARCH, smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        model.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError):
        run_continuous(cfg, model, model.init_params(0), batch=2,
                       n_requests=2, prompt_len=8, gen=2, page_size=4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-small"])
def test_serve_and_train_clis_run_both_families(arch, capsys):
    """The fixed-batch serve CLI (an encoder-decoder with its demo
    frames) and the train CLI (an encoder-decoder's batch with its
    per-step frames) on the CPU."""
    from repro_torch.launch import serve, train
    tokens = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--prompt-len", "6", "--gen", "3"])
    assert tokens.shape == (2, 3)
    out = train.main(["--device", "cpu", "--arch", arch, "--steps", "3",
                      "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert "generated (2, 3)" in capsys.readouterr().out
