"""The port's cache-free forward and loss against the JAX package's.

qwen3 SMOKE in f32 with weights carried over from the JAX init
(``models.convert.params_from_jax``): ``LM.forward`` logits and
``LM.loss`` equal the reference's with ``kernel_ops`` off (the model's
naive and streaming twins) and on (the fused attention kernel — its
plain version on the CPU, entered once per layer).  The kernel path is
forward-only, as the JAX kernel is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import attention as A  # noqa: E402
from repro_torch.models.lm import LM, Runtime, chunked_ce  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)      # tests/test_kernels.py
# the loss is one f32 mean of a few dozen ~7-magnitude terms: the bound
# tests/test_mesh_perf_model.py holds the reference's own losses to
LOSS_ATOL = 1e-5
CFG = get_config("qwen3_8b", smoke=True)
B, S = 2, 16


@pytest.fixture(scope="module")
def weights():
    """(reference config, reference params, port params) — one JAX init
    on the CPU, carried into the port through numpy."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro_torch.models.convert import params_from_jax
    rcfg = ref_config("qwen3_8b", smoke=True)
    with jax.default_device(jax.devices("cpu")[0]):
        ref_params = jax.jit(RefLM(rcfg).init_params)(jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, ref_params)
        yield rcfg, ref_params, params_from_jax(np_params, CFG)


@pytest.fixture(autouse=True)
def _port_cache(tmp_path, monkeypatch):
    from repro_torch.core import api
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    api.clear_cache()
    yield
    api.clear_cache()


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return tokens, labels


# bkv=4 takes the streaming twin (S > 2 bkv); 512 the naive one
@pytest.mark.parametrize("bkv", [512, 4])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_forward_and_loss_match_reference(weights, kernel_ops, bkv):
    import jax.numpy as jnp
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    rcfg, ref_params, params = weights
    tokens, labels = _batch()
    ref = RefLM(rcfg, RefRuntime(kernel_ops=kernel_ops, bkv=bkv))
    want = np.asarray(ref.forward(ref_params, jnp.asarray(tokens)))
    want_loss = float(ref.loss(ref_params, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}))
    model = LM(CFG, Runtime(kernel_ops=kernel_ops, bkv=bkv), device="cpu")
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got = model.forward(params, t)
        loss = model.loss(params, {"tokens": t,
                                   "labels": torch.from_numpy(labels).long()})
    assert got.shape == (B, S, CFG.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(loss) - want_loss) < LOSS_ATOL


@pytest.mark.parametrize("kernel_ops", [False, True])
def test_kernel_ops_enters_fused_attention_once_per_layer(weights,
                                                          monkeypatch,
                                                          kernel_ops):
    """On the CPU ``Runtime(kernel_ops=True)`` reaches ``fused_attention``
    (its plain version, as the tensors lie on the CPU) once per layer
    and forward; without ``kernel_ops`` never."""
    _, _, params = weights
    calls = []
    plain = A.fused_attention_plain
    monkeypatch.setattr(A, "fused_attention_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    model = LM(CFG, Runtime(kernel_ops=kernel_ops), device="cpu")
    with torch.inference_mode():
        model.forward(params, torch.from_numpy(_batch()[0]).long())
    assert len(calls) == (CFG.n_layers if kernel_ops else 0)
    assert all(c == (B, CFG.n_heads, S, CFG.dh) for c in calls)


def test_kernel_path_is_forward_only(weights):
    """Parameters that require grad under grad mode: the kernel path
    raises (the JAX kernel has no gradient either); the twin path runs
    and back-propagates."""
    _, _, params = weights
    p = {**params, "layers": [
        {**lp, "mix": {**lp["mix"],
                       "wq": lp["mix"]["wq"].clone().requires_grad_()}}
        for lp in params["layers"]]}
    t = torch.from_numpy(_batch()[0]).long()
    with pytest.raises(RuntimeError, match="no backward"):
        LM(CFG, Runtime(kernel_ops=True), device="cpu").forward(p, t)
    loss = LM(CFG, Runtime(), device="cpu").forward(p, t).float().mean()
    loss.backward()
    assert torch.isfinite(p["layers"][0]["mix"]["wq"].grad).all()


def test_planned_forward_runs(weights):
    """``Runtime(planner=True)`` runs the cache-free forward and loss
    from the planner's plans: without stitching the hand-wired numbers
    bit for bit (tests/test_torch_planned_forward.py holds the planned
    path to the reference)."""
    _, _, params = weights
    tokens, labels = (torch.from_numpy(a).long() for a in _batch())
    batch = {"tokens": tokens, "labels": labels}
    with torch.no_grad():
        want = LM(CFG, Runtime(), device="cpu").forward(params, tokens)
        model = LM(CFG, Runtime(planner=True, stitch=False), device="cpu")
        got = model.forward(params, tokens)
        assert torch.equal(model.loss(params, batch),
                           LM(CFG, Runtime(), device="cpu").loss(params,
                                                                 batch))
    assert torch.equal(got, want)


def test_chunked_ce_matches_reference_over_several_chunks():
    """S = 1536 runs three chunks of 512; labels -100 are masked."""
    jax = pytest.importorskip("jax")
    from repro.models.lm import chunked_ce as ref_ce
    rng = np.random.RandomState(4)
    hidden = rng.randn(1, 1536, 16).astype(np.float32)
    w = rng.randn(16, 40).astype(np.float32)
    labels = rng.randint(-1, 40, (1, 1536)).astype(np.int32)
    labels[labels < 0] = -100
    got = chunked_ce(torch.from_numpy(hidden), torch.from_numpy(w),
                     torch.from_numpy(labels).long())
    with jax.default_device(jax.devices("cpu")[0]):
        want = ref_ce(jax.numpy.asarray(hidden), jax.numpy.asarray(w),
                      jax.numpy.asarray(labels), tied=False)
    assert abs(float(got) - float(want)) < LOSS_ATOL
