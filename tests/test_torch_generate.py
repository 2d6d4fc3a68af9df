"""The port's fixed-batch decoder against the JAX package's.

SMOKE configs in f32 with weights carried over from the JAX init
(``models.convert.params_from_jax``): ``LM.prefill``/``decode_step``
over a contiguous KV cache match the reference's logits within TOL at
every step, ``launch.serve.generate`` emits the reference's greedy
tokens, and every ported config equals the reference's field by field.
Parametrised over qwen3-8b (GQA, qk-norm), granite-20b (MQA),
codeqwen1.5-7b (MHA) and the MoE olmoe-1b-7b and mixtral-8x7b, plus a
sliding-window qwen3 whose cache is a ring and whose prefill streams kv
blocks.  The captured (CUDA-graph) decode
is held against the eager one on the card (``sm90``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models.lm import LM, Runtime  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)      # tests/test_kernels.py
BATCH, PLEN, GEN = 3, 7, 6
# (arch, window, bkv): the sliding-window case runs a ring of 5 slots
# and a prefill of 7 >= the window; bkv 2 sends a prefill over a cache
# longer than two kv blocks through streaming_attention
CASES = {"qwen3_8b": ("qwen3_8b", 0, 512),
         "granite_20b": ("granite_20b", 0, 512),
         "codeqwen15_7b": ("codeqwen15_7b", 0, 512),
         "olmoe_1b_7b": ("olmoe_1b_7b", 0, 512),
         "mixtral_8x7b": ("mixtral_8x7b", 32, 512),
         "qwen3_8b-window": ("qwen3_8b", 5, 2),
         "qwen3_8b-streamed": ("qwen3_8b", 0, 2)}


@pytest.fixture(scope="module")
def jax_cpu():
    """jax with the CPU as default device for the module, as in the JAX
    package's own tests."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


def _pair(jax, case):
    """(reference model, reference params, port model, port params)
    for one case, from one JAX init."""
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro_torch.models.convert import params_from_jax
    arch, window, bkv = CASES[case]
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), window=window)
    cfg = dataclasses.replace(get_config(arch, smoke=True), window=window)
    ref = RefLM(rcfg, RefRuntime(bkv=bkv))
    ref_params = jax.jit(ref.init_params)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg)
    return ref, ref_params, LM(cfg, Runtime(kernel_ops=True, bkv=bkv),
                               device="cpu"), params


def _prompts(vocab):
    rng = np.random.RandomState(4)
    return rng.randint(0, vocab, size=(BATCH, PLEN)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_steps_match_reference(jax_cpu, case):
    """Prefill then GEN - 1 lock-step decode steps, each fed the
    reference's greedy token: the logits agree within TOL at every
    step, and so do the caches' positions."""
    jnp = jax_cpu.numpy
    ref, ref_params, model, params = _pair(jax_cpu, case)
    prompts = _prompts(model.cfg.vocab)
    ref_cache = ref.init_cache(BATCH, PLEN + GEN)
    cache = model.init_cache(BATCH, PLEN + GEN)
    want, ref_cache = jax_cpu.jit(ref.prefill)(ref_params,
                                               jnp.asarray(prompts),
                                               ref_cache)
    got, cache = model.prefill(params, torch.from_numpy(prompts).long(),
                               cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    decode = jax_cpu.jit(ref.decode_step)
    for i in range(GEN - 1):
        tok = np.argmax(np.asarray(want), axis=-1).astype(np.int32)
        want, ref_cache = decode(ref_params, ref_cache, jnp.asarray(tok),
                                 jnp.int32(PLEN + i))
        got, cache = model.decode_step(
            params, cache, torch.from_numpy(tok).long(),
            torch.tensor(PLEN + i, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for c, rc in zip(cache, [*_ref_layer_caches(ref_cache)]):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(rc))


def _ref_layer_caches(ref_cache):
    """The reference cache's per-layer ``pos`` rows, in layer order:
    the scanned stack's (n_super, n) rows, then the tail's."""
    (stack,) = ref_cache["stack"]
    yield from np.asarray(stack["pos"])
    for t in ref_cache["tail"]:
        yield t["pos"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_tokens_match_reference(jax_cpu, case):
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    jnp = jax_cpu.numpy
    ref, ref_params, model, params = _pair(jax_cpu, case)
    prompts = _prompts(model.cfg.vocab)
    want = ref_serve.generate(ref, ref_params, jnp.asarray(prompts), GEN)
    got, logits = serve.generate(model, params,
                                 torch.from_numpy(prompts).long(), GEN)
    assert got.shape == (BATCH, GEN) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert logits.shape == (BATCH, model.cfg.vocab)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), got[:, -1])
    one, _ = serve.generate(model, params, torch.from_numpy(prompts).long(),
                            1)
    np.testing.assert_array_equal(one, want[:, :1])


def test_fixed_batch_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    tokens = serve.main(["--device", "cpu", "--arch", "granite-20b",
                         "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    assert tokens.shape == (2, 3)
    assert "generated (2, 3)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_equal_reference(arch, smoke):
    """Every field of a ported config equals the JAX package's (an MoE
    config's ``moe``, a hybrid's ``rglru``, a state-space config's
    ``ssm`` and an encoder-decoder's ``encoder`` field by field: the two
    packages' classes never compare equal), and the port has every
    field the reference has."""
    pytest.importorskip("jax")
    from repro.configs import ALIASES as REF_ALIASES
    from repro.configs import get_config as ref_config
    from repro_torch.configs import ALIASES
    cfg, rcfg = get_config(arch, smoke=smoke), ref_config(arch, smoke=smoke)
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(rcfg, f.name)
        if (f.name in ("moe", "ssm", "rglru", "encoder")
                and want is not None):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert {f.name for f in dataclasses.fields(cfg)} == {
        f.name for f in dataclasses.fields(rcfg)}
    assert (cfg.moe is None) == (cfg.family != "moe")
    assert (cfg.rglru is None) == (cfg.family != "hybrid")
    assert (cfg.ssm is None) == (cfg.family != "ssm")
    assert (cfg.encoder is None) == (cfg.family != "encdec")
    assert {a: m for a, m in REF_ALIASES.items() if m == arch} == {
        a: m for a, m in ALIASES.items() if m == arch}


def test_config_weight_sizes():
    """The bf16 weight bytes the ROADMAP states: granite-34b does not
    fit one 80 GB card, granite-20b and codeqwen1.5-7b do; nor does
    mixtral-8x7b at its 32 layers, but 16 of them do, and olmoe-1b-7b
    does (its f32 router counted at 2 bytes, as the ROADMAP's sums)."""
    def params(cfg, n_layers=None):
        attn = cfg.d_model * cfg.dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        ff = 3 * cfg.d_model * cfg.d_ff
        if cfg.moe:
            ff = cfg.moe.n_experts * (ff + cfg.d_model)
        return ((n_layers or cfg.n_layers) * (attn + ff)
                + 2 * cfg.vocab * cfg.d_model)
    gb = {a: 2 * params(get_config(a)) / 1e9 for a in ARCHS}
    assert round(gb["granite_34b"], 1) == 94.5
    assert round(gb["granite_20b"], 1) == 56.3
    assert round(gb["codeqwen15_7b"], 1) == 16.4
    assert round(gb["olmoe_1b_7b"], 2) == 13.84
    assert round(gb["mixtral_8x7b"], 1) == 93.4
    assert round(2 * params(get_config("mixtral_8x7b"), 16) / 1e9, 2) == 46.96


# ---------------------------------------------------------------------------
# the captured decode step against the eager one (needs an sm_90 card)
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
@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_20b"])
def test_captured_generate_equals_eager_on_card(sm90, arch):
    """``generate`` on the card replays one captured decode step per
    token; its tokens and last logits equal the eager run's bit for
    bit (the same kernels on the same inputs)."""
    from repro_torch.launch import serve
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True), device=sm90)
    params = model.init_params(0)
    prompts = torch.from_numpy(_prompts(cfg.vocab)).long().to(sm90)
    got, logits = serve.generate(model, params, prompts, GEN)
    want, want_logits = serve.generate(model, params, prompts, GEN,
                                       eager=True)
    np.testing.assert_array_equal(got, want)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
