"""The port's planned cache-free forward against the JAX package's on
the CPU.

Every plannable SMOKE config (qwen3, granite-20b, codeqwen, granite-34b
and pixtral-12b over its prefix embeddings) in f32, the weights carried
from the JAX init (``models.convert.params_from_jax``): with stitching
off ``LM(cfg, Runtime(planner=True))``'s forward and loss equal its
hand-wired ones bit for bit, and both sides' planned forwards agree
within ``TOL`` (the port plans under ``H100``, the reference under
``V5E``: other glue is stitched, the f32 numbers are the same); with
stitching on within ``TOL``, and a bf16 qwen3 within ``TOL_BF16``.  The
kernel dispatch (``kernel_ops``, the kernels' plain versions on the CPU)
reaches ``ops.attention`` once a layer and ``ops.mlp_chain`` once a
layer where the plan fuses the MLP, never where it does not (full-width
qwen3-8b's plan at 1 x 512).  The planned loss's gradients against
``jax.grad`` of the reference's planned loss; recomputation; the circuit
breaker; the configs the planner cannot plan.  Under a gloo mesh (1 x 2
and 2 x 2, tensor parallelism with and without sequence parallelism,
and the zero3 regime's rows form on 2 x 1 x 2) the planned forward and
loss without stitching equal the hand-wired ones under the same mesh
bit for bit, and with stitching are within ``TOL`` of one process's
planned forward.  The rank bodies import no jax.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.models.lm import LM, Runtime, requires_grad  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)          # tests/test_kernels.py
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)     # tests/test_kernels.py
LOSS_ATOL = 1e-5                          # tests/test_torch_forward.py
GRAD_REL_TOL = 1e-4                       # tests/test_torch_train.py
PLANNABLE = ("qwen3-8b", "granite-20b", "codeqwen1.5-7b", "granite-34b",
             "pixtral-12b")
MESH_ARCHS = ("qwen3-8b", "granite-20b")
B, S = 2, 16


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    from repro_torch.reliability import breaker
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    planner.clear_memo()
    breaker.reset()
    yield
    planner.clear_memo()
    breaker.reset()


def _inputs(cfg, seed: int = 1) -> dict:
    """Seeded numpy tokens, labels and (a vision config's) prefix."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    out = {"tokens": tokens, "labels": labels}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(inp: dict) -> dict:
    return {k: (torch.from_numpy(v) if v.dtype == np.float32
                else torch.from_numpy(v).long()) for k, v in inp.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """arch -> numpy params, and the reference's planned forward with
    stitching off and on, its planned loss and (qwen3) the gradients of
    its planned loss; each on one CPU device from a plan memo and a
    schedule cache of its own."""
    import os

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.core import planner as ref_planner
    from repro.launch import steps as RS
    from repro.models.lm import Runtime as RefRuntime
    old = os.environ.get("REPRO_CACHE_DIR")
    os.environ["REPRO_CACHE_DIR"] = str(tmp_path_factory.mktemp("ref"))
    out = {}
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            for arch in PLANNABLE:
                rcfg = ref_config(arch, smoke=True)
                params = RS.build_model(rcfg, RefRuntime(remat=False)
                                        ).init_params(jax.random.PRNGKey(0))
                out["np", arch] = jax.tree.map(np.asarray, params)
                batch = {k: jnp.asarray(v) for k, v in _inputs(
                    get_config(arch, smoke=True)).items()}
                for stitch in (False, True):
                    ref_planner.clear_memo()
                    model = RS.build_model(rcfg, RefRuntime(
                        remat=False, planner=True, stitch=stitch))
                    out["forward", arch, stitch] = np.asarray(jax.jit(
                        model.forward)(params, batch["tokens"],
                                       batch.get("prefix_embeds")))
                if arch == "qwen3-8b":
                    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
                        params, batch)
                    out["loss", arch] = float(loss)
                    out["grads", arch] = jax.tree.map(np.asarray, grads)
                    bf16 = dataclasses.replace(rcfg, dtype="bfloat16")
                    ref_planner.clear_memo()
                    model = RS.build_model(bf16, RefRuntime(
                        remat=False, planner=True, stitch=True))
                    out["bf16"] = np.asarray(jax.jit(model.forward)(
                        jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                                     if a.dtype == jnp.float32 else a,
                                     params), batch["tokens"]),
                        np.float32)
                else:
                    out["loss", arch] = float(jax.jit(model.loss)(params,
                                                                  batch))
            ref_planner.clear_memo()
    finally:
        if old is None:
            os.environ.pop("REPRO_CACHE_DIR")
        else:
            os.environ["REPRO_CACHE_DIR"] = old
    return out


def _port(np_tree, cfg, dtype=None):
    from repro_torch.models.convert import params_from_jax
    params = params_from_jax(np_tree, cfg)
    if dtype is not None:
        params = T.map_tree(lambda t: t.to(dtype) if t.is_floating_point()
                            else t, params)
    return params


def _run(cfg, params, inp, **rt):
    """(logits, loss) of one model under ``Runtime(**rt)``, no grad."""
    model = LM(cfg, Runtime(**rt), device="cpu")
    batch = _torch_batch(inp)
    with torch.no_grad():
        logits = model.forward(params, batch["tokens"],
                               batch.get("prefix_embeds"))
        loss = model.loss(params, batch)
    return logits, loss


@pytest.mark.parametrize("arch", PLANNABLE)
def test_planned_without_stitching_is_the_hand_wired_forward(ref, arch):
    """Stitching off: the planned forward and loss equal the hand-wired
    ones bit for bit, and the reference's planned forward and loss
    within ``TOL`` (pixtral over its prefix: the plan's sequence counts
    the prefix rows)."""
    cfg = get_config(arch, smoke=True)
    params, inp = _port(ref["np", arch], cfg), _inputs(cfg)
    hand, hand_loss = _run(cfg, params, inp)
    got, loss = _run(cfg, params, inp, planner=True, stitch=False)
    assert torch.equal(got, hand) and torch.equal(loss, hand_loss)
    assert got.shape == (B, S + cfg.n_prefix_embeds, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), ref["forward", arch, False],
                               **TOL)
    assert abs(float(loss) - ref["loss", arch]) < LOSS_ATOL
    assert planner.plan_key(cfg, B, S + cfg.n_prefix_embeds, False) in \
        planner._PLAN_MEMO


@pytest.mark.parametrize("arch", PLANNABLE)
def test_planned_with_stitching_matches_reference(ref, arch):
    """Stitching on: f32 glue stitched into the carved units computes
    the same numbers — within ``TOL`` of the reference's stitched
    planned forward."""
    cfg = get_config(arch, smoke=True)
    params, inp = _port(ref["np", arch], cfg), _inputs(cfg)
    got, loss = _run(cfg, params, inp, planner=True, stitch=True)
    plan = planner.plan_model(cfg, B, S + cfg.n_prefix_embeds)
    assert any(c.prologue or c.epilogue for c in plan.layer.chains)
    np.testing.assert_allclose(got.numpy(), ref["forward", arch, True],
                               **TOL)
    assert abs(float(loss) - ref["loss", arch]) < LOSS_ATOL


def test_planned_bf16_with_stitching_matches_reference(ref):
    """bf16: rounding lands where each side's plan stitches — within
    ``TOL_BF16`` of the reference's stitched planned forward."""
    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True),
                              dtype="bfloat16")
    params = _port(ref["np", "qwen3-8b"], cfg, torch.bfloat16)
    got, _ = _run(cfg, params, _inputs(cfg), planner=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref["bf16"], **TOL_BF16)


def _counting(monkeypatch):
    from repro_torch.kernels import ops
    calls = {"attention": 0, "mlp_chain": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    return calls


def test_kernel_ops_dispatches_attention_and_the_fused_mlp(ref, monkeypatch):
    """Under ``kernel_ops`` the planned forward reaches ``ops.attention``
    and, where the plan fuses the MLP (qwen3 SMOKE at 2 x 16),
    ``ops.mlp_chain`` once a layer; the numbers stay within ``TOL`` of
    the reference's planned forward."""
    cfg = get_config("qwen3-8b", smoke=True)
    plan = planner.plan_model(cfg, B, S)
    assert any(c.kind == "mlp" and c.fused for c in plan.layer.chains)
    calls = _counting(monkeypatch)
    params, inp = _port(ref["np", "qwen3-8b"], cfg), _inputs(cfg)
    model = LM(cfg, Runtime(planner=True, kernel_ops=True), device="cpu")
    with torch.inference_mode():
        got = model.forward(params, torch.from_numpy(inp["tokens"]).long())
    assert calls == {"attention": cfg.n_layers, "mlp_chain": cfg.n_layers}
    np.testing.assert_allclose(got.numpy(), ref["forward", "qwen3-8b", True],
                               **TOL)


def test_kernel_ops_skips_the_mlp_kernel_where_the_plan_does_not_fuse(
        ref, monkeypatch):
    """qwen3-8b's full-width forward plan at 1 x 512 keeps the MLP
    three GEMMs (only the attention fused): a forward run from that
    plan (its op DAG is the SMOKE config's) calls ``ops.attention``
    once a layer and ``ops.mlp_chain`` never, and computes the
    hand-wired numbers."""
    full = planner.plan_model(get_config("qwen3-8b"), 1, 512)
    assert not any(c.kind == "mlp" and c.fused for c in full.layer.chains)
    assert any(c.kind == "attention" and c.fused for c in full.layer.chains)
    cfg = get_config("qwen3-8b", smoke=True)
    monkeypatch.setattr(planner, "plan_model", lambda *a, **k: full)
    calls = _counting(monkeypatch)
    params, inp = _port(ref["np", "qwen3-8b"], cfg), _inputs(cfg)
    tokens = torch.from_numpy(inp["tokens"]).long()
    with torch.inference_mode():
        got = LM(cfg, Runtime(planner=True, kernel_ops=True),
                 device="cpu").forward(params, tokens)
        hand = LM(cfg, Runtime(kernel_ops=True), device="cpu").forward(
            params, tokens)
    assert calls == {"attention": 2 * cfg.n_layers, "mlp_chain": 0}
    np.testing.assert_allclose(got.numpy(), hand.numpy(), **TOL)


def test_kernel_ops_under_grad_raises_no_backward(ref):
    """The fused attention has no backward, on the planned path too."""
    cfg = get_config("qwen3-8b", smoke=True)
    params = requires_grad(_port(ref["np", "qwen3-8b"], cfg))
    model = LM(cfg, Runtime(planner=True, kernel_ops=True), device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, _torch_batch(_inputs(cfg)))


def _loss_and_grads(cfg, params, inp, **rt):
    params = requires_grad(params)
    loss = LM(cfg, Runtime(**rt), device="cpu").loss(params,
                                                     _torch_batch(inp))
    loss.backward()
    return loss.detach(), [p.grad for p in T.leaves(params)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def test_planned_loss_gradients_match_reference(ref):
    """Autograd through the stitched planned loss: the loss and every
    leaf's gradient within ``GRAD_REL_TOL`` of ``jax.grad`` of the
    reference's planned loss."""
    cfg = get_config("qwen3-8b", smoke=True)
    loss, grads = _loss_and_grads(cfg, _port(ref["np", "qwen3-8b"], cfg),
                                  _inputs(cfg), planner=True)
    want = T.leaves(_port(ref["grads", "qwen3-8b"], cfg))
    assert abs(float(loss) - ref["loss", "qwen3-8b"]) < LOSS_ATOL
    worst = max(_rel(g, w) for g, w in zip(grads, want))
    assert worst <= GRAD_REL_TOL


@pytest.mark.parametrize("policy", [None, "dots"])
def test_planned_loss_under_recomputation(ref, policy):
    """``Runtime(remat=True)`` (whole blocks, and the ``dots`` policy)
    recomputes the planned blocks in the backward: the same loss and
    gradients as without recomputation."""
    cfg = get_config("qwen3-8b", smoke=True)
    inp = _inputs(cfg)
    want_loss, want = _loss_and_grads(cfg, _port(ref["np", "qwen3-8b"], cfg),
                                      inp, planner=True)
    loss, grads = _loss_and_grads(cfg, _port(ref["np", "qwen3-8b"], cfg),
                                  inp, planner=True, remat=True,
                                  remat_policy=policy)
    assert torch.equal(loss, want_loss)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_an_open_plan_key_serves_the_hand_wired_block(ref, monkeypatch):
    """A quarantined forward plan key serves the hand-wired block (the
    same logits as ``planner=False``) without running the plan; a
    planned block that fails in a way the breaker may degrade from is
    recorded and served hand-wired; any other failure raises."""
    from repro_torch.core import schedule_cache
    from repro_torch.core.perf_model import H100
    from repro_torch.kernels._build import KernelLaunchError
    from repro_torch.models import layers as L
    from repro_torch.reliability import breaker
    cfg = get_config("qwen3-8b", smoke=True)
    params, inp = _port(ref["np", "qwen3-8b"], cfg), _inputs(cfg)
    hand, _ = _run(cfg, params, inp)
    pkey = planner.plan_key(cfg, B, S, True)
    calls = []
    planned = L.run_planned_layer
    monkeypatch.setattr(L, "run_planned_layer",
                        lambda *a, **k: calls.append(1) or planned(*a, **k))
    assert breaker.record_failure(pkey, reason="operator test")
    got, _ = _run(cfg, params, inp, planner=True)
    assert torch.equal(got, hand) and not calls
    assert schedule_cache.clear_quarantine(pkey, H100)
    breaker.reset()

    def refused(*a, **k):
        raise KernelLaunchError("mlp_chain_launch", 9,
                                "invalid configuration argument")
    monkeypatch.setattr(L, "run_planned_layer", refused)
    got, _ = _run(cfg, params, inp, planner=True)
    assert torch.equal(got, hand) and breaker.is_open(pkey)
    assert schedule_cache.clear_quarantine(pkey, H100)
    breaker.reset()
    monkeypatch.setattr(L, "run_planned_layer", lambda *a, **k: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        _run(cfg, params, inp, planner=True)
    assert not breaker.is_open(pkey)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b"])
def test_configs_the_planner_cannot_plan_stay_hand_wired(arch, monkeypatch):
    from repro_torch.models import layers as L
    cfg = get_config(arch, smoke=True)
    assert not planner.plannable(cfg)
    monkeypatch.setattr(L, "run_planned_layer", lambda *a, **k: 1 / 0)
    params = LM(cfg, Runtime(), device="cpu").init_params(0)
    inp = _inputs(cfg)
    hand, hand_loss = _run(cfg, params, inp)
    got, loss = _run(cfg, params, inp, planner=True)
    assert torch.equal(got, hand) and torch.equal(loss, hand_loss)


# ---------------------------------------------------------------------------
# under a mesh: gloo worlds of spawned ranks (module-level bodies, no jax)
# ---------------------------------------------------------------------------

def _mesh_rules(regime: str):
    from repro_torch.dist.sharding import Rules
    if regime == "zero3":
        from repro_torch.launch.dryrun import cell_rules
        return cell_rules("train", True, "zero3")[1]
    return Rules(data=("data",), model="model", tp="model",
                 seq="model" if regime == "tp+sp" else None)


def _mesh_runs(mesh, regime: str, np_params: dict) -> dict:
    """Each arch's forward, loss and this rank's gradient shards under
    ``regime`` on ``mesh``: hand-wired, planned without and with
    stitching."""
    from repro_torch.launch.steps import build_model, shard_params
    from repro_torch.models.convert import params_from_jax
    out = {}
    for arch in MESH_ARCHS:
        cfg = get_config(arch, smoke=True)
        batch = _torch_batch(_inputs(cfg))
        for label, rt in (("hand", {}),
                          ("planned", dict(planner=True, stitch=False)),
                          ("stitched", dict(planner=True))):
            model = build_model(cfg, Runtime(rules=_mesh_rules(regime),
                                             mesh=mesh, **rt), device="cpu")
            params = requires_grad(shard_params(
                model, params_from_jax(np_params[arch], cfg)))
            with torch.no_grad():
                logits = model.forward(params, batch["tokens"]).numpy()
            loss = model.loss(params, batch)
            loss.backward()
            out[arch, label] = (logits.copy(), float(loss.detach()),
                                [p.grad.numpy().copy()
                                 for p in T.leaves(params)])
    return out


def _mesh_rank(rank, np_params, model_axis):
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    mesh = make_host_mesh(model_axis)
    for regime in ("tp", "tp+sp"):
        out[regime] = _mesh_runs(mesh, regime, np_params)
    if torch.distributed.get_world_size() == 4:
        pods = make_host_mesh(2, pods=2)
        out["zero3"] = _mesh_runs(pods, "zero3", np_params)
        out["zero3 refusal"] = _zero3_kernel_refusal(pods)
    return out


def _zero3_kernel_refusal(mesh) -> str:
    """The zero3 rows form's refusal under ``kernel_ops`` holds on the
    planned path too: the refusal's message, or "ran"."""
    from repro_torch.launch.steps import build_model
    cfg = get_config("qwen3-8b", smoke=True)
    model = build_model(cfg, Runtime(rules=_mesh_rules("zero3"), mesh=mesh,
                                     planner=True, kernel_ops=True),
                        device="cpu")
    params = model.init_params(0)
    try:
        with torch.no_grad():
            model.forward(params, _torch_batch(_inputs(cfg))["tokens"])
    except NotImplementedError as e:
        return str(e)
    return "ran"


@pytest.fixture(scope="module")
def one_process(ref):
    """Each mesh arch's stitched planned forward and loss in this
    process, on no mesh."""
    out = {}
    for arch in MESH_ARCHS:
        cfg = get_config(arch, smoke=True)
        logits, loss = _run(cfg, _port(ref["np", arch], cfg), _inputs(cfg),
                            planner=True)
        out[arch] = (logits.numpy(), float(loss))
    return out


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)],
                ids=["1x2", "2x2"])
def world(request, ref):
    from repro_torch.launch.mesh import spawn
    n, model_axis = request.param
    np_params = {arch: ref["np", arch] for arch in MESH_ARCHS}
    return spawn(_mesh_rank, n, np_params, model_axis, timeout_s=600)


def test_planned_forward_under_a_mesh(world, one_process):
    """On each rank, in every regime: the planned forward and loss
    without stitching equal the hand-wired ones under the same mesh bit
    for bit, and the rank's gradient shards within f32 summation order
    of theirs (a missing reduction of a shared weight's gradient would
    be off by the dim's size); with stitching the forward and loss are
    within ``TOL`` (the loss ``LOSS_ATOL``) of one process's planned
    forward."""
    for out in world:
        refusal = out.pop("zero3 refusal", None)
        assert len(world) == 2 or "no fused-kernel form" in refusal
        for regime, runs in out.items():
            for arch in MESH_ARCHS:
                hand, planned = runs[arch, "hand"], runs[arch, "planned"]
                np.testing.assert_array_equal(planned[0], hand[0])
                assert planned[1] == hand[1], (regime, arch)
                # the walk sums a shared input's gradient contributions
                # in its own order: equal to the last few f32 ulps
                for g, h in zip(planned[2], hand[2]):
                    np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-6)
                logits, loss, _ = runs[arch, "stitched"]
                want, want_loss = one_process[arch]
                np.testing.assert_allclose(logits, want, **TOL)
                assert abs(loss - want_loss) < LOSS_ATOL, (regime, arch)
    assert set(world[0]) == ({"tp", "tp+sp", "zero3"} if len(world) == 4
                             else {"tp", "tp+sp"})
