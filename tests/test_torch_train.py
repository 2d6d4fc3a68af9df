"""The port's training path against the JAX package's on the CPU.

* ``LM.loss`` gradients under autograd against ``jax.grad`` of the JAX
  ``LM.loss`` — qwen3, granite-20b and codeqwen SMOKE in f32, weights
  carried by ``models.convert.params_from_jax`` (the JAX gradient tree
  has the parameter tree's structure and goes through it too), at S=16
  (the naive attention twin) and at S=48 with ``bkv=16`` (S > 2 bkv:
  the streaming twin) — within 1e-4 relative (2-norm) per leaf.
* ``launch.steps.make_train_step`` over 5 steps against the JAX step:
  losses within 1e-4 relative; parameters within 2·lr·k, the most one
  Adam sign flip can move a weight in k steps.
* ``python -m repro_torch.launch.train --device cpu``: the loss falls
  and checkpoints land; the distributed flags' refused combinations
  exit with their error.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models.lm import LM, Runtime, requires_grad  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402

# f32 gradients of a 2-layer model: both sides sum the same products in
# other orders (tests/test_kernels.py's f32 limit is 3e-4 elementwise)
GRAD_REL_TOL = 1e-4
LOSS_REL_TOL = 1e-4
ARCHS = ["qwen3_8b", "granite_20b", "codeqwen15_7b"]
# (S, bkv): S <= 2 bkv runs the naive twin, S > 2 bkv the streaming one
SHAPES = [(16, 512), (48, 16)]
B = 2


@pytest.fixture(autouse=True)
def _hermetic_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))


@pytest.fixture(scope="module")
def reference():
    """arch -> (reference config, reference params, numpy params): one
    JAX init per config on the CPU."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch in ARCHS:
            rcfg = ref_config(arch, smoke=True)
            params = RefLM(rcfg).init_params(jax.random.PRNGKey(0))
            out[arch] = (rcfg, params, jax.tree.map(np.asarray, params))
    return out


def _batch(vocab: int, s: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return tokens, labels


def _port(np_tree, cfg):
    from repro_torch.models.convert import params_from_jax
    return params_from_jax(np_tree, cfg)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("s,bkv", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(reference, arch, s, bkv):
    import jax
    import jax.numpy as jnp
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    rcfg, ref_params, np_params = reference[arch]
    cfg = get_config(arch, smoke=True)
    tokens, labels = _batch(cfg.vocab, s)
    ref = RefLM(rcfg, RefRuntime(remat=False, bkv=bkv))
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        ref_params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)})
    want = _port(jax.tree.map(np.asarray, want_grads), cfg)

    model = LM(cfg, Runtime(bkv=bkv), device="cpu")
    params = requires_grad(_port(np_params, cfg))
    loss = model.loss(params, {"tokens": torch.from_numpy(tokens).long(),
                               "labels": torch.from_numpy(labels).long()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_REL_TOL)
    worst = {}
    for (key, p), w in zip(T.leaves_with_paths(params), T.leaves(want)):
        assert p.grad is not None and p.grad.shape == w.shape, key
        worst[key] = _rel(p.grad, w)
    assert max(worst.values()) <= GRAD_REL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


def test_streaming_twin_runs_under_autograd(monkeypatch):
    """At S > 2 bkv the loss goes through ``streaming_attention`` (once
    per layer), not the naive twin, with grad mode on."""
    from repro_torch.models import layers as L
    cfg = get_config("qwen3_8b", smoke=True)
    calls = []
    stream = L.streaming_attention
    monkeypatch.setattr(L, "streaming_attention",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    model = LM(cfg, Runtime(bkv=16), device="cpu")
    params = requires_grad(model.init_params(0))
    tokens, labels = _batch(cfg.vocab, 48)
    model.loss(params, {"tokens": torch.from_numpy(tokens).long(),
                        "labels": torch.from_numpy(labels).long()}
               ).backward()
    assert len(calls) == cfg.n_layers
    assert all(torch.isfinite(p.grad).all() for p in T.leaves(params))


def test_train_steps_match_reference(reference):
    """Five steps of ``make_train_step`` against the JAX package's jitted
    step on the same weights and pipeline batches."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as RS
    from repro.models.lm import Runtime as RefRuntime
    from repro.optim import adamw as ref_adamw
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    arch, k, lr = "qwen3_8b", 5, 1e-3
    rcfg, ref_params, np_params = reference[arch]
    cfg = get_config(arch, smoke=True)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=B, seed=0))
    ropt = ref_adamw.AdamW(lr=ref_adamw.cosine_schedule(lr, warmup=2,
                                                        total=10))
    rstep = jax.jit(RS.make_train_step(
        RS.build_model(rcfg, RefRuntime(remat=False)), ropt))
    opt = AdamW(lr=cosine_schedule(lr, warmup=2, total=10))
    model = S.build_model(cfg, Runtime(), device="cpu")
    step = S.make_train_step(model, opt)
    jp, jo = ref_params, ropt.init(ref_params)
    params = _port(np_params, cfg)
    state = opt.init(params)
    for t in range(k):
        batch = pipe.batch_at(t)
        jp, jo, jinfo = rstep(jp, jo, {n: jnp.asarray(v)
                                       for n, v in batch.items()})
        params, state, info = step(params, state, {
            n: torch.from_numpy(v).long() for n, v in batch.items()})
        assert float(info["loss"]) == pytest.approx(float(jinfo["loss"]),
                                                    rel=LOSS_REL_TOL)
        assert float(info["grad_norm"]) == pytest.approx(
            float(jinfo["grad_norm"]), rel=GRAD_REL_TOL)
        assert float(info["lr"]) == pytest.approx(float(jinfo["lr"]),
                                                  rel=1e-6)
        assert all(p.grad is None for p in T.leaves(params))
    want = _port(jax.tree.map(np.asarray, jp), cfg)
    diffs = torch.cat([(p.detach() - w).abs().flatten()
                       for p, w in zip(T.leaves(params), T.leaves(want))])
    assert float(diffs.max()) <= 2 * lr * k
    # a flip moves a weight by ~2 lr; the rest agree to f32 rounding
    assert float((diffs > 1e-5).float().mean()) < 1e-3
    assert int(state["step"]) == k


def test_train_cli_on_cpu_reduces_loss_and_checkpoints(tmp_path):
    """The counterpart of ``tests/test_system.py``'s end-to-end run:
    20 steps through the fault-tolerant runner on the CPU."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--steps", "20", "--batch", "4",
                      "--seq", "32", "--lr", "1e-2", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "10"])
    assert set(out) == {"first_loss", "final_loss", "losses"}
    losses = out["losses"]
    assert len(losses) == 20 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert ckpt.latest_step(str(tmp_path)) == 20
    # the checkpoint holds (params, optimizer state), step included
    like = train.train(get_config("qwen3_8b", smoke=True), steps=1,
                       batch=4, seq=32, device="cpu")["state"]
    params, opt_state = ckpt.restore(str(tmp_path), 20, like)
    assert int(opt_state["step"]) == 20


@pytest.mark.parametrize("flag,says", [
    (["--model-axis", "2", "--compress-grads"], "tensor parallelism"),
    (["--model-axis", "2", "--world", "3"], "does not divide")])
def test_train_cli_refuses_distributed_flags(flag, says, capsys):
    """``--model-axis`` and ``--compress-grads`` train on a world now
    (``tests/test_torch_dist_train.py``); what refuses is their
    combination, with the JAX package's message, and a model axis that
    does not divide the world."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--steps", "1"] + flag)
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


def test_build_model_refuses_other_families():
    """``build_model`` gives an encoder-decoder config to ``EncDec`` and
    every other to ``LM``; what refuses now is a layer kind neither
    knows."""
    import dataclasses
    from repro_torch.models.whisper import EncDec
    assert isinstance(S.build_model(get_config("whisper_small", smoke=True),
                                    device="cpu"), EncDec)
    assert isinstance(S.build_model(get_config("mamba2_1p3b", smoke=True),
                                    device="cpu"), LM)
    cfg = dataclasses.replace(get_config("qwen3_8b", smoke=True),
                              pattern=("conv",))
    with pytest.raises(NotImplementedError, match="conv"):
        S.build_model(cfg, device="cpu")


def test_kernel_path_still_refuses_grad():
    """``Runtime(kernel_ops=True)`` keeps raising under grad mode: the
    training path runs the twins, as the JAX package's ``launch.train``
    does."""
    cfg = get_config("qwen3_8b", smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    params = requires_grad(model.init_params(0))
    tokens, labels = _batch(cfg.vocab, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, {"tokens": torch.from_numpy(tokens).long(),
                            "labels": torch.from_numpy(labels).long()})
