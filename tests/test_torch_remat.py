"""Activation recomputation (``Runtime.remat`` / ``remat_policy``)
against the JAX package's ``jax.checkpoint`` on the CPU.

For qwen3 (one layer a super-block, at S = 48 with ``bkv`` 16: the
streaming twin), recurrentgemma (the ``(rglru, rglru, attn)``
super-block and an unscanned tail of two) and whisper (each encoder
and decoder layer) at SMOKE in f32: ``loss`` gradients with remat off,
full and ``dots`` equal to each other, and each within f32 TOL of
``jax.grad`` of the reference's loss under ``Runtime(remat=...,
remat_policy=...)``; the checkpoint really wraps the super-blocks, and
the policy keeps exactly the 2-D weight products.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models.lm import Runtime, requires_grad  # noqa: E402

GRAD_REL_TOL = 1e-4                   # tests/test_torch_train.py
LOSS_REL_TOL = 1e-4
ARCHS = ["qwen3_8b", "recurrentgemma_2b", "whisper_small"]
MODES = {"none": (False, None), "full": (True, None), "dots": (True, "dots")}
B, SEQ, BKV = 2, 48, 16


@pytest.fixture(autouse=True)
def _hermetic_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))


def _batch(cfg):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab, (B, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _convert(np_tree, cfg):
    from repro_torch.models.convert import (encdec_params_from_jax,
                                            params_from_jax)
    return (encdec_params_from_jax if cfg.family == "encdec"
            else params_from_jax)(np_tree, cfg)


@pytest.fixture(scope="module")
def results():
    """arch -> {mode: (loss, gradients)} of the port and of the
    reference (weights carried from the reference's init)."""
    from repro.configs import get_config as ref_config
    from repro.launch import steps as RS
    from repro.models.lm import Runtime as RefRuntime
    jnp = jax.numpy
    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch in ARCHS:
            rcfg, cfg = ref_config(arch, smoke=True), get_config(arch,
                                                                 smoke=True)
            np_batch = _batch(cfg)
            rbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
            batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
            ref_params = RS.build_model(rcfg).init_params(
                jax.random.PRNGKey(0))
            np_params = jax.tree.map(np.asarray, ref_params)
            res = {}
            for mode, (remat, policy) in MODES.items():
                rmodel = RS.build_model(rcfg, RefRuntime(
                    remat=remat, remat_policy=policy, bkv=BKV))
                loss, grads = jax.value_and_grad(rmodel.loss)(ref_params,
                                                              rbatch)
                want = _convert(jax.tree.map(np.asarray, grads), cfg)
                model = S.build_model(cfg, Runtime(remat=remat,
                                                   remat_policy=policy,
                                                   bkv=BKV), device="cpu")
                params = requires_grad(_convert(np_params, cfg))
                got = model.loss(params, batch)
                got.backward()
                res[mode] = (float(got.detach()), float(loss),
                             [p.grad for p in T.leaves(params)],
                             T.leaves(want),
                             [k for k, _ in T.leaves_with_paths(params)])
            out[arch] = res
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_jax_grad(results, arch, mode):
    loss, want_loss, grads, want, keys = results[arch][mode]
    assert loss == pytest.approx(want_loss, rel=LOSS_REL_TOL)
    worst = {k: float((g - w).norm() / w.norm().clamp(min=1e-30))
             for k, g, w in zip(keys, grads, want)}
    assert max(worst.values()) <= GRAD_REL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("mode", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_plain(results, arch, mode):
    """Recomputation runs the same ops on the same values on the CPU:
    the loss and every gradient equal the plain backward's."""
    loss, _, grads, _, keys = results[arch][mode]
    loss0, _, grads0, _, _ = results[arch]["none"]
    assert loss == loss0
    for k, g, g0 in zip(keys, grads, grads0):
        assert torch.equal(g, g0), k


def test_remat_wraps_each_super_block(monkeypatch):
    """recurrentgemma SMOKE (5 layers, pattern of 3): one checkpoint
    around layers 0-2, the tail of 2 plain; none without grad mode."""
    from repro_torch.models import lm
    calls = []
    real = lm._ckpt.checkpoint
    monkeypatch.setattr(lm._ckpt, "checkpoint", lambda fn, *a, **k: (
        calls.append([kind for kind, _ in a[0]]), real(fn, *a, **k))[1])
    cfg = get_config("recurrentgemma_2b", smoke=True)
    model = lm.LM(cfg, Runtime(remat=True), device="cpu")
    params = requires_grad(model.init_params(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    model.loss(params, batch).backward()
    assert calls == [["rglru", "rglru", "attn"]]
    calls.clear()
    with torch.no_grad():
        model.loss(params, batch)
    assert calls == []


def test_dots_policy_saves_only_weight_products():
    from repro_torch.models.lm import _dots_policy
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    assert _dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert _dots_policy(None, aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.baddbmm.default, aten.exp.default,
               aten.add.Tensor):
        assert _dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    cfg = get_config("qwen3_8b", smoke=True)
    model = S.build_model(cfg, Runtime(remat=True, remat_policy="bogus"),
                          device="cpu")
    params = requires_grad(model.init_params(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="remat_policy"):
        model.loss(params, batch)
