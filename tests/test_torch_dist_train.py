"""Training under the mesh — the port's differentiable collectives, the
sharded train step, the int8 error-feedback compressed step, sharded
checkpoints, the elastic re-mesh and MoE's mesh layouts — against the
JAX package on the CPU.

Worlds of spawned ranks (gloo over a FileStore, ``launch.mesh.spawn``)
at SMOKE in f32, weights carried by ``models.convert``; each world runs
once per module and the tests read its results:

* a world of 2: each conjugate collective pair under autograd against
  the one-process function; the compressed step over a data dim of 2
  against the reference's ``make_compressed_train_step`` on 2 forced
  host devices (a subprocess, ``XLA_FLAGS`` set before jax loads); the
  elastic restore of the 2 x 2 world's checkpoint onto a 1 x 2 world
  (``tests/test_dist_exec.py``'s elastic test); the engine under the
  mesh on olmoe SMOKE against the single-card engine's tokens;
* 2 x 2, 1 x 4 and 4 x 1 worlds: ``LM.loss`` gradients, gathered
  whole, against ``jax.grad`` of the reference's single-device loss
  within 1e-4 a leaf (qwen3, granite-20b whose kv head the model dim
  cannot divide, olmoe and mixtral on 2 x 2, olmoe at 6 experts on 1 x
  4: the ``tp`` layout); ``moe_block`` in its ``ep``, ``tp`` and
  ``local`` layouts against the reference's single-device block within
  2e-4; five sharded ``make_train_step`` steps against the reference's
  jitted steps; ``StepRunner`` on the 2 x 2 world with a planted
  ``StepFailure``.

Single-process counterparts of ``tests/test_substrate.py``'s
compression and elastic tests, and the train CLI's ``--model-axis``
and ``--compress-grads`` on spawned worlds.  The rank bodies import no
jax.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402

# f32 sums of the same products in other orders (test_torch_train.py)
GRAD_REL_TOL = 1e-4
LOSS_REL_TOL = 1e-4
MOE_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_moe_and_loss.py
ELASTIC_LOSS_TOL = 1e-3                   # tests/test_dist_exec.py
B, S = 4, 16
GRAD_ARCHS = {"2x2": ("qwen3-8b", "granite-20b", "olmoe-1b-7b",
                      "mixtral-8x7b"),
              "1x4": ("qwen3-8b", "granite-20b", "olmoe-6"),
              "4x1": ("qwen3-8b", "granite-20b")}
STEPS, LR = 5, 1e-3
COMP_STEPS = 3
ENGINE = dict(max_batch=4, page_size=8, n_pages=24, max_pages_per_seq=8)
BUDGETS = (3, 8, 5, 2)


def _cfg(arch):
    """The port's SMOKE config; ``olmoe-6`` is olmoe with 6 experts,
    which a model dim of 4 does not divide (the ``tp`` layout)."""
    import dataclasses
    from repro_torch.configs import get_config
    if arch == "olmoe-6":
        cfg = get_config("olmoe-1b-7b", smoke=True)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=6))
    return get_config(arch, smoke=True)


def _ref_cfg(arch):
    import dataclasses
    from repro.configs import get_config
    if arch == "olmoe-6":
        cfg = get_config("olmoe-1b-7b", smoke=True)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=6))
    return get_config(arch, smoke=True)


def _batch(vocab: int):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100          # the ranks' token counts differ
    return tokens, labels


def _moe_x():
    return np.random.RandomState(3).standard_normal((B, 8, 64)).astype(
        np.float32)


def _elastic_tokens():
    return np.random.RandomState(1).randint(0, 512, (4, 32)).astype(
        np.int32)


def _requests():
    rs = np.random.RandomState(0)
    return [(rs.randint(0, 512, size=9).astype(np.int32), g)
            for g in BUDGETS]


def _rules(model_axis):
    from repro_torch.dist.sharding import Rules
    return Rules(data=("data",), model="model",
                 tp="model" if model_axis > 1 else None)


def _mesh_model(arch, model_axis):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, Runtime
    mesh = make_host_mesh(model_axis)
    return LM(_cfg(arch), Runtime(rules=_rules(model_axis), mesh=mesh),
              device="cpu"), mesh


def _port_params(np_params, cfg):
    from repro_torch.models.convert import params_from_jax
    return params_from_jax(np_params, cfg)


def _gathered(tree, specs, mesh) -> list:
    """Every leaf of this rank's shards gathered whole, as numpy."""
    from repro_torch.dist.collectives import gather_dims
    out: list = []
    with torch.no_grad():
        T.map_tree(lambda t, sp: out.append(
            gather_dims(t, sp, mesh).numpy().copy()), tree, specs)
    return out


# ---------------------------------------------------------------------------
# rank bodies (module level, no jax)
# ---------------------------------------------------------------------------

def _grads(np_params, arch, model_axis):
    """(loss, every gradient leaf reduced and gathered whole)."""
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import requires_grad
    model, mesh = _mesh_model(arch, model_axis)
    params = requires_grad(S.shard_params(
        model, _port_params(np_params, model.cfg)))
    tokens, labels = _batch(model.cfg.vocab)
    loss = model.loss(params, {"tokens": torch.from_numpy(tokens).long(),
                               "labels": torch.from_numpy(labels).long()})
    loss.backward()
    grads = [p.grad for p in T.leaves(params)]
    S.reduce_gradients(model, grads, T.leaves(model.param_specs(),
                                              like=params), B)
    return float(loss.detach()), _gathered(
        T.map_tree(lambda p: p.grad, params), model.param_specs(), mesh)


def _moe(np_moe, model_axis, arch):
    """``moe_block`` of the mesh layout ``model_axis`` gives, on this
    rank's shards of the reference's expert weights, gathered whole."""
    from repro_torch.dist.collectives import shard_dims
    from repro_torch.models import layers as L
    model, mesh = _mesh_model(arch, model_axis)
    cfg = model.cfg
    specs = L.specs_moe(cfg, model.rt.rules, model_axis)
    ctx = model._ctx(B)
    p = {k: model._whole(shard_dims(torch.from_numpy(v), specs[k], mesh),
                         specs[k], ctx) for k, v in np_moe.items()}
    with torch.no_grad():
        out = L.moe_block(p, model._local(torch.from_numpy(_moe_x()), B),
                          cfg, ctx)
        return model._global(out, B).numpy()


def _train_steps(np_params):
    """Five sharded steps of qwen3 SMOKE on the 2 x 2 world."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    model, mesh = _mesh_model("qwen3-8b", 2)
    opt = AdamW(lr=cosine_schedule(LR, warmup=2, total=10))
    step = S.make_train_step(model, opt)
    params = S.shard_params(model, _port_params(np_params, model.cfg))
    state = opt.init(params)
    pipe = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=S_STEP,
                                    global_batch=B, seed=0))
    infos = []
    for t in range(STEPS):
        params, state, info = step(params, state, {
            n: torch.from_numpy(v).long()
            for n, v in pipe.batch_at(t).items()})
        infos.append({k: float(v) for k, v in info.items()})
    return infos, _gathered(params, model.param_specs(), mesh)


S_STEP = 16


def _runner(tmp, fail_at):
    """``StepRunner`` over six sharded steps (checkpoints every 2),
    with a ``StepFailure`` raised on every rank at step ``fail_at`` the
    first time it runs (None: no fault): each step's last loss."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.fault_tolerance import StepFailure, StepRunner
    model, mesh = _mesh_model("qwen3-8b", 2)
    opt = AdamW(lr=cosine_schedule(LR, warmup=2, total=10))
    step = S.make_train_step(model, opt)
    params = model.init_params(0)
    state = (params, opt.init(params))
    pipe = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=S_STEP,
                                    global_batch=B, seed=0))
    fired = []

    def step_fn(st, batch):
        if fail_at is not None and not fired and int(st[1]["step"]) \
                == fail_at:
            fired.append(1)
            raise StepFailure("planted")
        p, o, info = step(*st, batch)
        return (p, o), {"loss": float(info["loss"])}

    runner = StepRunner(step_fn=step_fn, batch_at=lambda t: {
        n: torch.from_numpy(v).long() for n, v in pipe.batch_at(t).items()},
        ckpt_dir=tmp, ckpt_every=2, mesh=mesh,
        layouts=S.state_layouts(model, state))
    _, log = runner.run(state, 6)
    return {m["step"]: m["loss"] for m in log}, len(fired)


def _world_4(rank, layout, np_by_arch, np_moe, tmp):
    model_axis = {"2x2": 2, "1x4": 4, "4x1": 1}[layout]
    out = {"grads": {a: _grads(np_by_arch[a], a, model_axis)
                     for a in GRAD_ARCHS[layout]}}
    moe_arch = "olmoe-6" if layout == "1x4" else "olmoe-1b-7b"
    out["moe"] = _moe(np_moe[moe_arch], model_axis, moe_arch)
    if layout != "2x2":
        return out
    out["steps"] = _train_steps(np_by_arch["qwen3-8b"])
    # the elastic test's checkpoint: granite's weights, written once,
    # gathered whole
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import steps as S
    model, mesh = _mesh_model("granite-20b", 2)
    params = S.shard_params(model, _port_params(np_by_arch["granite-20b"],
                                                model.cfg))
    toks = torch.from_numpy(_elastic_tokens()).long()
    with torch.no_grad():
        out["elastic loss4"] = float(model.loss(params, {"tokens": toks,
                                                         "labels": toks}))
    ckpt.save(os.path.join(tmp, "elastic"), 1, params,
              layouts=model.param_specs(), mesh=mesh)
    out["runner"] = _runner(os.path.join(tmp, "faulted"), 3)
    out["runner plain"] = _runner(os.path.join(tmp, "plain"), None)
    return out


def _pairs():
    """Each conjugate pair on the model dim of 2, under autograd:
    this rank's gradients, as numpy."""
    from repro_torch.dist.collectives import axis
    from repro_torch.launch.mesh import make_host_mesh
    ax = axis(make_host_mesh(2), "model")
    r = ax.index
    x, w = _pair_inputs()
    out = {}
    # gather (sum): rank-specific consumers of the gathered rows
    xr = torch.from_numpy(x[2 * r:2 * r + 2]).requires_grad_(True)
    (ax.gather(xr, 0) * torch.from_numpy(w[r])).sum().backward()
    out["gather sum"] = xr.grad.numpy()
    # gather (own): a consumer every rank runs alike
    xr = torch.from_numpy(x[2 * r:2 * r + 2]).requires_grad_(True)
    (ax.gather(xr, 0, "own") * torch.from_numpy(w[0])).sum().backward()
    out["gather own"] = xr.grad.numpy()
    # reduce: rank-partial products summed, a replicated consumer
    th = torch.from_numpy(w[r][:2, :3].copy()).requires_grad_(True)
    y = ax.reduce(torch.from_numpy(x[2 * r:2 * r + 2].T.copy()) @ th)
    (y ** 2).sum().backward()
    out["reduce"] = th.grad.numpy()
    # enter: a replicated input into rank-specific columns
    xx = torch.from_numpy(x[:2].copy()).requires_grad_(True)
    z = ax.reduce(ax.enter(xx) @ torch.from_numpy(w[r].T.copy()))
    (z ** 2).sum().backward()
    out["enter"] = xx.grad.numpy()
    return out


def _pair_inputs():
    rs = np.random.RandomState(5)
    return (rs.standard_normal((4, 5)).astype(np.float32),
            rs.standard_normal((2, 4, 5)).astype(np.float32))


def _compressed(np_params):
    """The compressed step over the data dim of 2 (params replicated,
    the model without a mesh): losses, norms, the final params (rank
    0's), this rank's residual row."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    model = LM(_cfg("qwen3-8b"), device="cpu")
    opt = AdamW(lr=cosine_schedule(LR, warmup=1, total=100))
    step = S.make_compressed_train_step(model, opt, make_host_mesh(1))
    params = _port_params(np_params, model.cfg)
    state, res = opt.init(params), S.init_grad_residuals(params)
    pipe = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=S_STEP,
                                    global_batch=B, seed=0))
    infos = []
    for t in range(COMP_STEPS):
        params, state, res, info = step(params, state, res, {
            n: torch.from_numpy(v).long()
            for n, v in pipe.batch_at(t).items()})
        infos.append({k: float(v) for k, v in info.items()})
        if t == 0:
            res0 = [r[0].numpy().copy() for r in T.leaves(res)]
    return (infos, [p.detach().numpy().copy() for p in T.leaves(params)],
            res0, [r[0].numpy().copy() for r in T.leaves(res)])


def _elastic(tmp):
    """Two of the 2 x 2 world's ranks survive (and a third, whose data
    row is incomplete): ``elastic_remesh`` gives 1 x 2, and the whole
    checkpoint is re-sharded onto it by ``replace_state``."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.runtime.fault_tolerance import (elastic_remesh,
                                                     replace_state)
    shape, kept = elastic_remesh([0, 1, 2], model_axis_size=2)
    model, mesh = _mesh_model("granite-20b", shape[1])
    whole = ckpt.restore(os.path.join(tmp, "elastic"), 1)
    params = replace_state(whole, mesh, model.param_specs())
    toks = torch.from_numpy(_elastic_tokens()[:2]).long()
    with torch.no_grad():
        loss = float(model.loss(params, {"tokens": toks, "labels": toks}))
    return {"shape": shape, "kept": kept, "loss": loss,
            "local wq": tuple(params["layers"][0]["mix"]["wq"].shape)}


def _engine(np_olmoe):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import sharded_runtime
    from repro_torch.launch.steps import build_model, shard_params
    from repro_torch.serving import ServingEngine
    _, _, rt = sharded_runtime(2, make_host_mesh(2))
    model = build_model(_cfg("olmoe-1b-7b"), rt, device="cpu")
    eng = ServingEngine(model, shard_params(model, _port_params(
        np_olmoe, model.cfg)), **ENGINE)
    res, stats = eng.run(_requests())
    return {"tokens": [r.tokens for r in res], "regime": eng.regime,
            "pools": tuple(eng.cache[0]["k_pages"].shape),
            "exec_tier": stats["exec_tier"]}


def _world_2(rank, np_qwen, np_olmoe, tmp):
    return {"pairs": _pairs(), "compressed": _compressed(np_qwen),
            "elastic": _elastic(tmp), "engine": _engine(np_olmoe)}


# ---------------------------------------------------------------------------
# the reference and the worlds, once per module
# ---------------------------------------------------------------------------

REF_COMPRESSED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch import steps as S
from repro.launch.mesh import make_host_mesh
from repro.models.lm import LM, Runtime
from repro.optim.adamw import AdamW, cosine_schedule
cfg = get_config("qwen3_8b", smoke=True)
mesh = make_host_mesh(model_axis=1)
assert mesh.shape["data"] == 2
model = LM(cfg, Runtime(remat=False))
opt = AdamW(lr=cosine_schedule(%(lr)r, warmup=1, total=100))
params = model.init_params(jax.random.PRNGKey(0))
pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=%(s)d,
                                global_batch=%(b)d, seed=0))
comp = jax.jit(S.make_compressed_train_step(model, opt, mesh))
p, o, r = params, opt.init(params), S.init_grad_residuals(params, 2)
out = {}
for step in range(%(steps)d):
    batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()}
    p, o, r, info = comp(p, o, r, batch)
    for k, v in info.items():
        out[f"info/{step}/{k}"] = np.asarray(v)
    if step == 0:
        for i, leaf in enumerate(jax.tree.leaves(r)):
            out[f"res0/{i}"] = np.asarray(leaf)
for i, leaf in enumerate(jax.tree.leaves(p)):
    out[f"param/{i}"] = np.asarray(leaf)
for i, leaf in enumerate(jax.tree.leaves(r)):
    out[f"res/{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's results on the CPU: each config's weights and
    ``jax.grad`` of its single-device loss, the MoE blocks, five jitted
    steps, the elastic test's loss, and the compressed steps on 2
    forced host devices (a subprocess)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.dist.sharding import Rules
    from repro.launch import steps as RS
    from repro.models import layers as RL
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro.optim import adamw as ref_adamw
    tmp = tmp_path_factory.mktemp("ref")
    script = tmp / "compressed.py"
    script.write_text(REF_COMPRESSED % dict(lr=LR, s=S_STEP, b=B,
                                            steps=COMP_STEPS))
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(script),
                             str(tmp / "compressed.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    out = {"np": {}, "grads": {}, "moe": {}, "np moe": {}}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch in ("qwen3-8b", "granite-20b", "olmoe-1b-7b",
                     "mixtral-8x7b", "olmoe-6"):
            rcfg = _ref_cfg(arch)
            model = RefLM(rcfg, RefRuntime(remat=False))
            params = model.init_params(jax.random.PRNGKey(0))
            out["np"][arch] = jax.tree.map(np.asarray, params)
            tokens, labels = _batch(rcfg.vocab)
            loss, grads = jax.value_and_grad(model.loss)(params, {
                "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
            out["grads"][arch] = (float(loss), _port_params(
                jax.tree.map(np.asarray, grads), _cfg(arch)))
            if arch.startswith("olmoe"):
                p = RL.init_moe(jax.random.PRNGKey(7), rcfg)
                out["np moe"][arch] = jax.tree.map(np.asarray, p)
                out["moe"][arch] = np.asarray(RL.moe_block(
                    p, jnp.asarray(_moe_x()), rcfg, Rules.disabled(), None))
        rcfg = _ref_cfg("qwen3-8b")
        ropt = ref_adamw.AdamW(lr=ref_adamw.cosine_schedule(LR, warmup=2,
                                                            total=10))
        rstep = jax.jit(RS.make_train_step(
            RS.build_model(rcfg, RefRuntime(remat=False)), ropt))
        jp = jax.tree.map(jnp.asarray, out["np"]["qwen3-8b"])
        jo = ropt.init(jp)
        pipe = TokenPipeline(DataConfig(vocab=rcfg.vocab, seq_len=S_STEP,
                                        global_batch=B, seed=0))
        infos = []
        for t in range(STEPS):
            jp, jo, info = rstep(jp, jo, {n: jnp.asarray(v) for n, v in
                                          pipe.batch_at(t).items()})
            infos.append({k: float(v) for k, v in info.items()})
        out["steps"] = (infos, _port_params(jax.tree.map(np.asarray, jp),
                                            _cfg("qwen3-8b")))
        gm = RefLM(_ref_cfg("granite-20b"), RefRuntime(remat=False))
        gp = jax.tree.map(jnp.asarray, out["np"]["granite-20b"])
        for key, rows in (("elastic", 2), ("elastic4", 4)):
            toks = jnp.asarray(_elastic_tokens()[:rows])
            out[key] = float(gm.loss(gp, {"tokens": toks, "labels": toks}))
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    out["compressed"] = dict(np.load(tmp / "compressed.npz"))
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = str(tmp_path_factory.mktemp("worlds"))
    npa = ref["np"]
    out = {layout: spawn(_world_4, 4, layout, npa, ref["np moe"], tmp,
                         timeout_s=600)
           for layout in GRAD_ARCHS}
    out["2"] = spawn(_world_2, 2, npa["qwen3-8b"], npa["olmoe-1b-7b"], tmp,
                     timeout_s=600)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# the collectives, the gradients, MoE's layouts
# ---------------------------------------------------------------------------

def test_each_collective_pair_matches_the_one_process_function(worlds):
    """Each rank's gradient through each conjugate pair equals the one
    process's gradient of the same function of the whole tensors."""
    x, w = _pair_inputs()
    xt = torch.from_numpy(x).requires_grad_(True)
    sum((xt * torch.from_numpy(w[r])).sum() for r in range(2)).backward()
    g_sum = xt.grad.numpy()
    g_own = w[0]
    ths = [torch.from_numpy(w[r][:2, :3].copy()).requires_grad_(True)
           for r in range(2)]
    (sum(torch.from_numpy(x[2 * r:2 * r + 2].T.copy()) @ ths[r]
         for r in range(2)) ** 2).sum().backward()
    xx = torch.from_numpy(x[:2].copy()).requires_grad_(True)
    (sum(xx @ torch.from_numpy(w[r].T.copy())
         for r in range(2)) ** 2).sum().backward()
    for r, out in enumerate(worlds["2"]):
        got = out["pairs"]
        np.testing.assert_allclose(got["gather sum"],
                                   g_sum[2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_allclose(got["gather own"],
                                   g_own[2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_allclose(got["reduce"], ths[r].grad.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["enter"], xx.grad.numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("layout,arch", [
    (layout, arch) for layout, archs in GRAD_ARCHS.items()
    for arch in archs])
def test_sharded_gradients_match_jax_grad(worlds, ref, layout, arch):
    """``LM.loss`` on the world's shards: the global-batch loss on every
    rank, and each gradient leaf, reduced (``reduce_gradients``) and
    gathered whole, within GRAD_REL_TOL of ``jax.grad`` of the
    reference's single-device loss — the vocab-parallel loss, the FSDP
    gather's reduce-scatter, the kv heads gathered where the model dim
    does not divide them, MoE's ``ep`` and ``tp`` layouts."""
    want_loss, want = ref["grads"][arch]
    worst = {}
    for out in worlds[layout]:
        loss, grads = out["grads"][arch]
        assert loss == pytest.approx(want_loss, rel=LOSS_REL_TOL)
        for (key, w), g in zip(T.leaves_with_paths(want), grads):
            worst[key] = max(worst.get(key, 0.0), _rel(g, w.numpy()))
    assert max(worst.values()) <= GRAD_REL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("layout,mode", [("2x2", "ep"), ("1x4", "tp"),
                                         ("4x1", "local")])
def test_moe_block_each_mesh_layout_matches_reference(worlds, ref, layout,
                                                      mode):
    """``moe_block`` in the reference's three layouts — ``ep`` (8
    experts over a model dim of 2), ``tp`` (6 experts over 4: the ffn
    dim sliced), ``local`` (no tensor-parallel dim: the experts gathered
    whole, each data rank routing its own tokens) — against the
    reference's single-device block."""
    from repro_torch.models import layers as L
    arch = "olmoe-6" if mode == "tp" else "olmoe-1b-7b"
    n_model = {"ep": 2, "tp": 4, "local": 1}[mode]
    specs = L.specs_moe(_cfg(arch), _rules(n_model), n_model)
    assert (specs["w_up"][0] == "model") == (mode != "tp")
    for out in worlds[layout]:
        np.testing.assert_allclose(out["moe"], ref["moe"][arch], **MOE_TOL)


def test_sharded_train_steps_match_reference(worlds, ref):
    """Five ``make_train_step`` steps on the 2 x 2 world's shards
    against the reference's jitted steps: losses and norms (the clip's
    global norm over the shards, each replicated leaf counted once)
    within 1e-4, params within 2·lr·k (an Adam sign flip), as
    ``test_torch_train.py`` holds one device."""
    want_infos, want = ref["steps"]
    for out in worlds["2x2"]:
        infos, params = out["steps"]
        for got, w in zip(infos, want_infos):
            assert got["loss"] == pytest.approx(w["loss"], rel=LOSS_REL_TOL)
            assert got["grad_norm"] == pytest.approx(w["grad_norm"],
                                                     rel=GRAD_REL_TOL)
            assert got["lr"] == pytest.approx(w["lr"], rel=1e-6)
        diffs = np.concatenate([np.abs(p - w.numpy()).ravel()
                                for p, w in zip(params, T.leaves(want))])
        assert diffs.max() <= 2 * LR * STEPS
        assert (diffs > 1e-5).mean() < 1e-3


def test_step_runner_on_a_world_restores_after_a_failure(worlds):
    """A ``StepFailure`` planted on every rank at step 3 restores the
    sharded checkpoint of step 2 (written whole by rank 0, re-sharded)
    and replays: every step's loss equals the unfaulted run's."""
    for out in worlds["2x2"]:
        faulted, fired = out["runner"]
        plain, _ = out["runner plain"]
        assert fired == 1 and sorted(faulted) == list(range(6))
        assert faulted == plain


# ---------------------------------------------------------------------------
# the elastic re-mesh, the engine
# ---------------------------------------------------------------------------

def test_elastic_reshard_after_rank_loss(worlds, ref):
    """The counterpart of ``tests/test_dist_exec.py``'s elastic test:
    a checkpoint written whole by the 2 x 2 world, two ranks lost,
    ``elastic_remesh`` keeps the model dim whole (1 x 2 of three
    survivors), ``replace_state`` re-shards it, and the loss is the
    reference's within 1e-3."""
    for out in worlds["2x2"]:
        assert abs(out["elastic loss4"] - ref["elastic4"]) < ELASTIC_LOSS_TOL
    for out in worlds["2"]:
        e = out["elastic"]
        assert e["shape"] == (1, 2) and e["kept"] == [0, 1]
        assert e["local wq"] == (64, 32)          # this rank's q heads
        assert abs(e["loss"] - ref["elastic"]) < ELASTIC_LOSS_TOL


def test_elastic_remesh_shapes():
    """``tests/test_substrate.py``'s: 8 survivors at model axis 2 give
    4 x 2; 7 give 2 x 2 (the data dim rounds down to a power of two)."""
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    assert elastic_remesh(list(range(8)), 2) == ((4, 2), list(range(8)))
    assert elastic_remesh(list(range(7)), 2) == ((2, 2), [0, 1, 2, 3])
    with pytest.raises(ValueError, match="one model replica"):
        elastic_remesh([0], 2)


def test_engine_under_the_mesh_serves_olmoe(worlds, ref):
    """olmoe SMOKE's engine on a 1 x 2 world (4 q and 4 kv heads: 2 a
    rank; 8 experts: 4 a rank) gives the single-card engine's tokens."""
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.serving import ServingEngine
    cfg = _cfg("olmoe-1b-7b")
    eng = ServingEngine(LM(cfg, Runtime(kernel_ops=True), device="cpu"),
                        _port_params(ref["np"]["olmoe-1b-7b"], cfg),
                        **ENGINE)
    res, _ = eng.run(_requests())
    want = [r.tokens for r in res]
    for out in worlds["2"]:
        e = out["engine"]
        assert [len(t) for t in e["tokens"]] == list(BUDGETS)
        assert e["tokens"] == want
        assert e["exec_tier"] == "configured"
        assert e["regime"] in ("paged-spatial", "paged-ring",
                               "paged-ring-pipelined")


# ---------------------------------------------------------------------------
# compression: tests/test_substrate.py's, and the step on 2 ranks
# ---------------------------------------------------------------------------

def test_compressed_step_matches_reference_on_two_ranks(worlds, ref):
    """The compressed step over a data dim of 2 against the reference's
    ``make_compressed_train_step`` on 2 forced host devices — one int8
    scale for a weight of every scanned layer, as the reference's
    stacked leaves have (``steps.stack_groups``): losses and norms
    within 1e-4, params within an Adam sign flip (2·lr·k), and each
    rank's residual after step 0 the reference's row within 1e-3 of the
    leaf's largest, but where an int8 rounding fell the other way (one
    quantum)."""
    want = ref["compressed"]
    for r, out in enumerate(worlds["2"]):
        infos, params, res0, res = out["compressed"]
        for t, got in enumerate(infos):
            assert got["loss"] == pytest.approx(
                float(want[f"info/{t}/loss"]), rel=LOSS_REL_TOL)
            assert got["grad_norm"] == pytest.approx(
                float(want[f"info/{t}/grad_norm"]), rel=GRAD_REL_TOL)
        n = sum(k.startswith("param/") for k in want)
        wp = _ref_leaves(ref, [want[f"param/{i}"] for i in range(n)])
        diffs = np.concatenate([np.abs(p - w).ravel()
                                for p, w in zip(params, wp)])
        assert diffs.max() <= 2 * LR * COMP_STEPS
        wr = _ref_leaves(ref, [want[f"res0/{i}"][r] for i in range(n)])
        close = np.concatenate([(np.abs(g - w) <= 1e-3 * np.abs(w).max())
                                .ravel() for g, w in zip(res0, wr)])
        assert close.mean() > 0.99
        assert any(np.abs(g).max() > 0 for g in res)


def _ref_leaves(ref, leaves) -> list:
    """qwen3 SMOKE leaves in the reference's leaf order (``jax.tree``'s)
    as the port's leaves, in its order."""
    import jax
    tree = jax.tree.unflatten(jax.tree.structure(ref["np"]["qwen3-8b"]),
                              leaves)
    return [t.numpy() for t in T.leaves(_port_params(tree,
                                                     _cfg("qwen3-8b")))]


def test_quantize_int8_matches_reference():
    """The same arrays through both packages: q equal, the scale within
    one f32 ulp."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dist import compression as RC
    from repro_torch.dist import compression as C
    rs = np.random.RandomState(0)
    for x in (rs.standard_normal(1000).astype(np.float32) * 10,
              rs.standard_normal((64, 33)).astype(np.float32) * 1e-4,
              np.zeros(16, np.float32), np.float32([0.5, -1.5, 2.5, 127])):
        q, scale = C.quantize_int8(torch.from_numpy(x))
        rq, rscale = RC.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert abs(float(scale) - float(rscale)) <= float(
            np.spacing(np.float32(rscale)))


def _quantize_bound(seed):
    from repro_torch.dist.compression import dequantize_int8, quantize_int8
    x = torch.randn(256, generator=torch.Generator().manual_seed(seed)) * 10
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(st.integers(0, 1000))
    @settings(max_examples=20, deadline=None)
    def test_quantize_error_bound(seed):
        _quantize_bound(seed)
except ImportError:      # pragma: no cover - conftest stubs hypothesis
    pass


def test_error_feedback_accumulates():
    """The residual carries the quantization error, so the sum over 64
    steps of what was sent converges to the true sum."""
    from repro_torch.dist.compression import (compress_with_feedback,
                                              dequantize_int8)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(128,))
                         * 1e-4).float()
    residual = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(64):
        q, scale, residual = compress_with_feedback(g, residual)
        sent = sent + dequantize_int8(q, scale)
    rel = float((sent - g * 64).norm() / (g * 64).norm())
    assert rel < 0.05


def test_compressed_psum_on_one_rank():
    from repro_torch.dist.compression import compressed_psum
    g = torch.linspace(-1, 1, 64)
    out, res = compressed_psum(g, torch.zeros_like(g), None)
    np.testing.assert_allclose(out.numpy(), g.numpy(), atol=1e-2)
    np.testing.assert_allclose((out + res).numpy(), g.numpy(), atol=1e-6)


def test_compressed_train_step_tracks_uncompressed():
    """``tests/test_substrate.py``'s on one rank: the same step-0 loss,
    every step within 5 %, and the residuals carrying an error."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = get_config("qwen3_8b", smoke=True)
    model = LM(cfg, device="cpu")
    opt = AdamW(lr=cosine_schedule(1e-3, warmup=1, total=100))
    p1 = model.init_params(0)
    p2 = T.map_tree(torch.clone, p1)
    o1, o2 = opt.init(p1), opt.init(p2)
    r2 = S.init_grad_residuals(p2)
    plain = S.make_train_step(model, opt)
    comp = S.make_compressed_train_step(model, opt)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=2, seed=0))
    losses = []
    for step in range(4):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in pipe.batch_at(step).items()}
        p1, o1, i1 = plain(p1, o1, batch)
        p2, o2, r2, i2 = comp(p2, o2, r2, batch)
        losses.append((float(i1["loss"]), float(i2["loss"])))
    assert losses[0][1] == pytest.approx(losses[0][0], rel=1e-5)
    for a, b in losses:
        assert b == pytest.approx(a, rel=0.05)
    assert any(float(r.abs().max()) > 0 for r in T.leaves(r2))


# ---------------------------------------------------------------------------
# the train CLI on a world
# ---------------------------------------------------------------------------

def test_train_cli_model_axis_trains_on_a_world(capfd):
    """``--model-axis 2`` spawns a 1 x 2 world (tensor-parallel shards)
    and trains the one-rank run's losses; ``--world 4`` makes it 2 x 2."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq",
            "16", "--lr", "1e-2"]
    one = train.main(argv)["losses"]
    for extra in (["--model-axis", "2"], ["--model-axis", "2", "--world",
                                          "4"]):
        got = train.main(argv + extra)["losses"]
        np.testing.assert_allclose(got, one, rtol=1e-5)
    assert "world=4 mesh=data2xmodel2" in capfd.readouterr().out


def test_train_cli_compress_grads_on_a_world(tmp_path, capfd):
    """``--compress-grads --world 2`` trains with int8 error feedback
    over a data dim of 2: the one-rank uncompressed run's first loss,
    later ones within 5 %, and its checkpoint holds both ranks' residual
    rows (the JAX package's stacked residuals)."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq",
            "16", "--lr", "1e-2"]
    one = train.main(argv)["losses"]
    got = train.main(argv + ["--compress-grads", "--world", "2",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "2"])["losses"]
    assert got[0] == pytest.approx(one[0], rel=1e-5)
    np.testing.assert_allclose(got, one, rtol=0.05)
    assert "int8+EF all-reduce over the data dim (2 shards)" in \
        capfd.readouterr().out
    params, opt_state, res = ckpt.restore(str(tmp_path), 4)
    assert int(opt_state["step"]) == 4
    assert res["embed"].shape == (2,) + tuple(params["embed"].shape)
    assert float(res["embed"].abs().max()) > 0


def test_mesh_still_refuses_the_planned_path():
    """A dense config's planned path under a mesh refuses, naming the
    queue item that brings it."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Rules
    from repro_torch.models.lm import LM, Runtime

    class FakeMesh:
        shape = {"data": 1, "model": 2}
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        LM(get_config("qwen3-8b", smoke=True),
           Runtime(rules=Rules(data=("data",), model="model", tp="model"),
                   mesh=FakeMesh(), planner=True), device="cpu")


def test_tree_leaves_like_gives_layouts_in_leaf_order():
    """``tree.leaves(layouts, like=params)``: the layout tuples at the
    params' leaf places, in their order, the tuples kept whole."""
    params = {"embed": torch.zeros(4, 2),
              "layers": [{"wq": torch.zeros(2, 2), "ln": torch.zeros(2)}]}
    layouts = {"embed": ("model", None),
               "layers": [{"wq": (None, "model"), "ln": (None,)}]}
    assert T.leaves(layouts, like=params) == [("model", None),
                                              (None, "model"), (None,)]
    assert T.leaves(params) == T.leaves(params, like=params)


def test_sharded_checkpoints_refuse_an_async_write(tmp_path):
    """A sharded state is written blocking (every rank waits for rank
    0's write): ``ckpt.save`` on a mesh and ``StepRunner`` on a mesh
    refuse an async write instead of ignoring it."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.runtime.fault_tolerance import StepRunner
    tree = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="blocking"):
        ckpt.save(str(tmp_path), 1, tree, blocking=False,
                  layouts={"w": (None,)}, mesh=object())
    with pytest.raises(ValueError, match="blocking"):
        StepRunner(step_fn=lambda s, b: (s, {}), batch_at=lambda t: {},
                   ckpt_dir=str(tmp_path), async_save=True, mesh=object(),
                   layouts={"w": (None,)})
    assert not os.listdir(tmp_path)
