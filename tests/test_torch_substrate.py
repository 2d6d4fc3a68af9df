"""The port's training substrate against the JAX package's: the token
pipeline, AdamW, the clip and the schedule, checkpoints, the step
runner and the straggler monitor.

A counterpart of each test of ``tests/test_substrate.py`` for these
modules (its compression and elastic re-mesh tests wait for the
port's distributed slice), then parity with the reference on the CPU:
pipeline batches bit for bit (synthetic and memory-mapped), three
AdamW updates from the same numpy parameters and gradients (f32 and
bf16) within rtol 1e-5, and checkpoints that round-trip bf16 and f32
leaves bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import PrefetchingLoader  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.optim.adamw import (AdamW, clip_by_global_norm,  # noqa: E402
                                     cosine_schedule, global_norm)
from repro_torch.runtime.fault_tolerance import (StepFailure,  # noqa: E402
                                                 StepRunner,
                                                 StragglerMonitor)

# AdamW against the reference: the same f32 arithmetic in the same
# order, up to the sum order of the global norm and fused multiply-adds
ADAM_RTOL = 1e-5


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_determinism():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=7)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in (0, 3, 17):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_shards_disjoint_and_labels_shifted():
    mk = lambda s: TokenPipeline(DataConfig(vocab=1000, seq_len=16,
                                            global_batch=8, n_shards=2,
                                            shard_id=s))
    b0, b1 = mk(0).batch_at(5), mk(1).batch_at(5)
    assert b0["tokens"].shape == (4, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])


def test_prefetch_resume():
    pipe = TokenPipeline(DataConfig(vocab=100, seq_len=8, global_batch=2))
    loader = PrefetchingLoader(pipe, start_step=5)
    step, batch = next(loader)
    loader.close()
    assert step == 5
    assert not loader._thread.is_alive()
    np.testing.assert_array_equal(batch["tokens"],
                                  pipe.batch_at(5)["tokens"])


def _corpus(tmp_path) -> str:
    path = str(tmp_path / "corpus.u16")
    np.random.default_rng(3).integers(0, 60000, size=5000,
                                      dtype=np.uint16).tofile(path)
    return path


@pytest.mark.parametrize("memmap", [False, True])
def test_pipeline_batches_bitwise_equal_reference(tmp_path, memmap):
    pytest.importorskip("jax")
    from repro.data import pipeline as ref
    kw = dict(vocab=151936, seq_len=64, global_batch=6, seed=11,
              n_shards=2, shard_id=1,
              path=_corpus(tmp_path) if memmap else None)
    got = TokenPipeline(DataConfig(**kw))
    want = ref.TokenPipeline(ref.DataConfig(**kw))
    for step in (0, 1, 9, 1234):
        g, w = got.batch_at(step), want.batch_at(step)
        for key in ("tokens", "labels"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic_loss():
    opt = AdamW(lr=cosine_schedule(0.1, warmup=1, total=100),
                weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    w_id = params["w"]
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        torch.sum(w ** 2).backward()
        opt.update(params, {"w": w.grad}, state)
    assert params["w"] is w_id          # written in place
    assert float(torch.sum(params["w"] ** 2)) < 1.0
    assert int(state["step"]) == 50


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0), "b": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(800.0), rel=1e-5)


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(lr(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(100, dtype=torch.int32))) == pytest.approx(
        0.1, rel=1e-3)


def test_schedule_and_clip_match_reference():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import adamw as ref
    want_lr = ref.cosine_schedule(3e-4, warmup=6, total=100)
    got_lr = cosine_schedule(3e-4, warmup=6, total=100)
    for step in (0, 1, 5, 6, 7, 50, 99, 100, 150):
        assert float(got_lr(torch.tensor(step, dtype=torch.int32))) == \
            float(want_lr(jnp.int32(step)))
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 5)).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32)]}
    want, want_norm = ref.clip_by_global_norm(
        {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(tree["b"][0])]}, 1.0)
    got, got_norm = clip_by_global_norm(
        T.map_tree(torch.from_numpy, tree), 1.0)
    assert float(got_norm) == pytest.approx(float(want_norm), rel=1e-6)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)


def _adam_case(dtype: str, seed: int = 0):
    """Numpy parameters and three steps' gradients: a matrix, a vector,
    a 0-d leaf, in dicts and a list; gradients large enough that the
    clip scales every step."""
    rng = np.random.default_rng(seed)
    shapes = {"w": np.empty((16, 24)), "n": {"s": np.empty(24)},
              "l": [np.empty(5), np.empty(())]}
    draw = lambda a, s=1.0: np.asarray(s * rng.normal(size=a.shape),
                                       dtype=np.float32)
    params = T.map_tree(draw, shapes)
    grads = [T.map_tree(lambda a: draw(a, 3.0), shapes) for _ in range(3)]
    if dtype == "bfloat16":     # values exactly representable in bf16
        rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        params = T.map_tree(rnd, params)
        grads = [T.map_tree(rnd, g) for g in grads]
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_updates_match_reference(dtype):
    """m, v, master, the params, grad_norm and lr after each of three
    updates from the same numpy parameters and gradients."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as ref
    params_np, grads_np = _adam_case(dtype)
    tdt = getattr(torch, dtype)
    jdt = jnp.dtype(dtype)
    to_t = lambda a: torch.from_numpy(np.array(a)).to(tdt)
    to_j = lambda a: jnp.asarray(a, dtype=jdt)
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    want_opt = ref.AdamW(lr=ref.cosine_schedule(1e-2, warmup=2, total=10),
                         **kw)
    got_opt = AdamW(lr=cosine_schedule(1e-2, warmup=2, total=10), **kw)
    jp = T.map_tree(to_j, params_np)
    jstate = want_opt.init(jp)
    tp = T.map_tree(to_t, params_np)
    tstate = got_opt.init(tp)
    ids = [id(t) for t in T.leaves(tp)]
    update = jax.jit(want_opt.update)
    f32 = lambda t: t.float().numpy()
    for g in grads_np:
        jp, jstate, jinfo = update(jp, T.map_tree(to_j, g), jstate)
        info = got_opt.update(tp, T.map_tree(to_t, g), tstate)
        assert float(info["grad_norm"]) == pytest.approx(
            float(jinfo["grad_norm"]), rel=ADAM_RTOL)
        assert float(info["lr"]) == pytest.approx(float(jinfo["lr"]),
                                                  rel=ADAM_RTOL)
        assert int(tstate["step"]) == int(jstate["step"])
        for key in ("m", "v", "master"):
            for got, want in zip(T.leaves(tstate[key]),
                                 T.leaves(_ref_order(jstate[key]))):
                np.testing.assert_allclose(f32(got), np.asarray(want),
                                           rtol=ADAM_RTOL, atol=1e-7)
        for got, want in zip(T.leaves(tp), T.leaves(_ref_order(jp))):
            assert got.dtype == tdt
            np.testing.assert_allclose(
                f32(got), np.asarray(want, dtype=np.float32),
                rtol=ADAM_RTOL)
    assert [id(t) for t in T.leaves(tp)] == ids


def _ref_order(tree):
    """A JAX tree of the test's shapes as plain dicts and lists in the
    port's (insertion) leaf order: the test's keys w, n, l."""
    return {"w": tree["w"], "n": {"s": tree["n"]["s"]}, "l": list(tree["l"])}


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.tensor(3.5)},
            "lst": [torch.ones((2,), dtype=torch.int32)]}
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    got = ckpt.restore(str(tmp_path), 7, tree)
    for a, b in zip(T.leaves(tree), T.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_uncommitted_invisible(tmp_path):
    os.makedirs(tmp_path / "step_9")  # no DONE marker -> crash artifact
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 3, {"x": torch.zeros(2)})
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_checkpoint_prune(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"x": torch.zeros(1)})
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert not os.path.exists(tmp_path / "step_1")


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoint_bf16_and_f32_bit_exact(tmp_path, blocking):
    """bf16 leaves go to disk as their raw 16 bits and come back bit for
    bit, f32 ones too (NaN, inf and -0.0 included); the manifest keys
    leaves by path.  An async save copies to the host before its thread
    starts: writing the tensors after ``save`` returns changes nothing
    on disk."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(33, 17, generator=g)
    w[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    tree = ({"layers": [{"mix": {"wq": w.to(torch.bfloat16)}},
                        {"mix": {"wq": -w.to(torch.bfloat16)}}],
             "norm": w[0].clone()},
            {"step": torch.tensor(12, dtype=torch.int32), "master": w})
    want = T.map_tree(torch.clone, tree)
    thread = ckpt.save(str(tmp_path), 5, tree, blocking=blocking)
    for t in T.leaves(tree):
        t.zero_()
    if thread is not None:
        thread.join(timeout=30)
        assert not thread.is_alive()
    like = T.map_tree(torch.empty_like, want)
    got = ckpt.restore(str(tmp_path), 5, like)
    for a, b in zip(T.leaves(want), T.leaves(got)):
        assert b.dtype == a.dtype and b.device == a.device
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                      else torch.int32),
                               b.view(torch.int16 if b.dtype == torch.bfloat16
                                      else torch.int32))
        else:
            assert torch.equal(a, b)
    import json
    with open(tmp_path / "step_5" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert [entry["key"] for entry in leaves][:2] == [
        "0/layers/0/mix/wq", "0/layers/1/mix/wq"]
    assert leaves[0]["dtype"] == "bfloat16"


def test_checkpoint_restore_checks_shapes(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(2, 3)})


def test_checkpoint_restores_into_like_dtype(tmp_path):
    """``restore`` gives each leaf its ``like`` leaf's dtype, as the JAX
    package's restore into a ShapeDtypeStruct tree does."""
    ckpt.save(str(tmp_path), 2, {"x": torch.full((4,), 1.5)})
    got = ckpt.restore(str(tmp_path), 2,
                       {"x": torch.zeros(4, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].float(), torch.full((4,), 1.5))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_steprunner_recovers_from_failure(tmp_path):
    pipe = TokenPipeline(DataConfig(vocab=10, seq_len=4, global_batch=1))
    fail_at = {"armed": True}
    seen_batches = []

    def step_fn(state, batch):
        step = int(state["step"])
        if step == 7 and fail_at["armed"]:
            fail_at["armed"] = False
            raise StepFailure("simulated node loss")
        seen_batches.append((step, batch["tokens"].tobytes()))
        return {"step": state["step"] + 1}, {"loss": 1.0 / (step + 1)}

    runner = StepRunner(step_fn=step_fn, batch_at=pipe.batch_at,
                        ckpt_dir=str(tmp_path), ckpt_every=5)
    state, log = runner.run({"step": torch.tensor(0)}, 10)
    assert int(state["step"]) == 10
    # step 5..7 replayed after restore from step-5 checkpoint with
    # bit-identical data (the determinism contract)
    replayed = [b for s, b in seen_batches if s == 5]
    assert len(replayed) == 2 and replayed[0] == replayed[1]


def test_steprunner_resumes_across_runs(tmp_path):
    pipe = TokenPipeline(DataConfig(vocab=10, seq_len=4, global_batch=1))

    def step_fn(state, batch):
        return {"step": state["step"] + 1}, {}

    r1 = StepRunner(step_fn, pipe.batch_at, str(tmp_path), ckpt_every=4)
    r1.run({"step": torch.tensor(0)}, 8)
    # "process restart": new runner resumes from the last checkpoint
    calls = []
    r2 = StepRunner(lambda s, b: (calls.append(1) or
                                  ({"step": s["step"] + 1}, {})),
                    pipe.batch_at, str(tmp_path), ckpt_every=4)
    state, _ = r2.run({"step": torch.tensor(0)}, 10)
    assert int(state["step"]) == 10
    assert len(calls) == 2  # only steps 8, 9 re-run


def test_steprunner_gives_up_after_retry_budget(tmp_path):
    pipe = TokenPipeline(DataConfig(vocab=10, seq_len=4, global_batch=1))

    def step_fn(state, batch):
        raise StepFailure("a node that never comes back")

    runner = StepRunner(step_fn, pipe.batch_at, str(tmp_path),
                        max_retries=2)
    with pytest.raises(StepFailure):
        runner.run({"step": torch.tensor(0)}, 3)


def test_straggler_monitor():
    mon = StragglerMonitor(n_hosts=4, threshold=1.5)
    for _ in range(10):
        flagged = mon.record(np.array([1.0, 1.0, 1.0, 2.5]))
    assert flagged == [3]
