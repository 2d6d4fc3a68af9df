"""The hybrid, state-space and encoder-decoder families under the mesh —
recurrentgemma-2b (RG-LRU and local attention), mamba2-1.3b (Mamba-2)
and whisper-small (the encoder-decoder) — against the JAX package on
the CPU.

The reference runs once per module in a subprocess on four forced host
devices (``XLA_FLAGS`` set before jax loads): each SMOKE config's
weights, its single-device loss and ``jax.grad``, its ``prefill`` and
teacher-forced ``decode_step`` logits, and its own sharded loss under
the 2 x 2 mesh's ``tp+sp`` rules.  The port runs in spawned gloo worlds
(``launch.mesh.spawn``), once per module, in f32 with the reference's
weights carried by ``models.convert``:

* 2 x 2, under ``tp`` and under ``tp+sp``: the loss, and every
  gradient leaf reduced and gathered whole; under ``tp`` (the serving
  rules) a prefill and decode steps, recurrentgemma's crossing its
  32-slot window (a ring on the slots, sequence-sharded), and each
  rank's cache against the layouts of ``cache_specs`` at a batch of
  one row, fewer than the data ranks;
* 1 x 3, under ``tp`` and ``tp+sp``: widths that divide over 3 and 4
  heads that do not — every mixer runs every head on its weights
  gathered whole (``layers._split_heads``);
* 1 x 4, SP: mamba's and whisper's vocab replaced by 510, which the
  model dim does not divide (the embedding sharded on ``d_model``).

And the entry points on a world: ``launch.train --model-axis 2 --world
4`` and ``launch.serve --shard-model 2`` for all three.  The rank
bodies import no jax.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import tree as T  # noqa: E402

# f32 sums of the same products in other orders (test_torch_dist_train.py)
LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4
LOGITS_TOL = dict(rtol=3e-4, atol=1e-3)     # f32 (chip_smoke.py's TOL)
FAMS = ("recurrentgemma-2b", "mamba2-1.3b", "whisper-small")
B, S = 4, 48
DECODE = {"recurrentgemma-2b": (28, 8),     # (prompt, steps): the steps
          "mamba2-1.3b": (20, 4),           # cross the 32-slot window
          "whisper-small": (8, 4)}
WORLDS = {"2x2": (4, 2), "1x3": (3, 3), "1x4": (4, 4)}
CASES = {"2x2": [(f, "base", r) for f in FAMS for r in ("tp", "tp+sp")],
         "1x3": [(f, "n3", r) for f in FAMS for r in ("tp", "tp+sp")],
         "1x4": [(f, "v510", "tp+sp") for f in FAMS[1:]]}


def _variant(cfg, variant: str):
    """``n3``: widths that divide over 3 (d_model 48, d_ff 96, mamba's
    head_dim 24) beside 4 heads that do not; ``v510``: the vocab 510."""
    if variant == "n3":
        kw = dict(d_model=48, d_ff=96 if cfg.d_ff else 0)
        if cfg.ssm is not None:
            kw["ssm"] = dataclasses.replace(cfg.ssm, head_dim=24)
        return dataclasses.replace(cfg, **kw)
    if variant == "v510":
        return dataclasses.replace(cfg, vocab=510)
    return cfg


def _cfg(arch, variant="base"):
    from repro_torch.configs import get_config
    return _variant(get_config(arch, smoke=True), variant)


def _inputs(cfg, batch=B, seq=S):
    """Tokens, labels (the last and row 0's first three masked) and,
    for an encoder-decoder, frames: numpy, from seed 0."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    out = {"tokens": tokens, "labels": labels}
    if cfg.encoder is not None:
        out["frames"] = rs.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return out


REF = r"""
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %(tests)r)
import jax, jax.numpy as jnp
import numpy as np
import repro
from repro.configs import get_config
from repro.dist.sharding import Rules
from repro.launch import steps as RS
from repro.models.lm import Runtime
import test_torch_dist_families as H

out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
sp_rules = Rules(data=("data",), model="model", tp="model", seq="model")
cases = {(f, v) for cs in H.CASES.values() for f, v, _ in cs}
for fam, variant in sorted(c for c in cases if c[0] == sys.argv[2]):
    cfg = H._variant(get_config(fam, smoke=True), variant)
    model = RS.build_model(cfg, Runtime(remat=False))
    params = model.init_params(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in H._inputs(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    rec = {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
           "grads": jax.tree.map(np.asarray, grads)}
    if variant == "base":
        sh = RS.build_model(cfg, Runtime(rules=sp_rules, mesh=mesh,
                                         remat=False))
        with jax.set_mesh(mesh):
            ps = jax.device_put(params, RS.shardings_for(
                mesh, sh.param_specs()))
            rec["sharded loss"] = float(jax.jit(sh.loss)(ps, batch))
        p, k = H.DECODE[fam]
        toks = batch["tokens"]
        cache = model.init_cache(H.B, p + k)
        side = ((batch["frames"],) if cfg.encoder is not None else ())
        lg, cache = jax.jit(model.prefill)(params, toks[:, :p], cache,
                                           *side)
        logits = [np.asarray(lg)]
        step = jax.jit(model.decode_step)
        for t in range(k - 1):
            lg, cache = step(params, cache, toks[:, p + t], jnp.int32(p + t))
            logits.append(np.asarray(lg))
        rec["decode"] = logits
    out[fam, variant] = rec
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results (module doc), computed on four forced
    host devices in a subprocess a family, the three at once."""
    tmp = tmp_path_factory.mktemp("ref")
    script = tmp / "ref.py"
    script.write_text(REF % dict(tests=os.path.dirname(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp / f"{fam}.pkl"), fam],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fam in FAMS]
    out = {}
    for fam, proc in zip(FAMS, procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"{fam}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# rank bodies (module level, no jax)
# ---------------------------------------------------------------------------

def _rules(regime: str, serving: bool = False):
    from repro_torch.dist.sharding import Rules
    return Rules(data=("data",), model="model", tp="model",
                 seq="model" if regime == "tp+sp" else None,
                 fsdp=not serving)


def _model(cfg, regime, model_axis, serving=False):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_model
    from repro_torch.models.lm import Runtime
    mesh = make_host_mesh(model_axis)
    rt = Runtime(rules=_rules(regime, serving), mesh=mesh,
                 dist_decode_attn=serving)
    return build_model(cfg, rt, device="cpu"), mesh


def _port_params(np_params, cfg):
    from repro_torch.models.convert import (encdec_params_from_jax,
                                            params_from_jax)
    conv = encdec_params_from_jax if cfg.encoder else params_from_jax
    return conv(np_params, cfg)


def _batch(cfg, rows=B, seq=S) -> dict:
    return {k: (torch.from_numpy(v) if v.dtype == np.float32
                else torch.from_numpy(v).long())
            for k, v in _inputs(cfg, rows, seq).items()}


def _gathered(tree, specs, mesh) -> list:
    from repro_torch.dist.collectives import gather_dims
    out: list = []
    with torch.no_grad():
        T.map_tree(lambda t, sp: out.append(
            gather_dims(t, sp, mesh).numpy().copy()), tree, specs)
    return out


def _grads(np_params, cfg, regime, model_axis):
    """(loss, every gradient leaf reduced and gathered whole)."""
    from repro_torch.launch import steps as St
    from repro_torch.models.lm import requires_grad
    model, mesh = _model(cfg, regime, model_axis)
    params = requires_grad(St.shard_params(model,
                                           _port_params(np_params, cfg)))
    loss = model.loss(params, _batch(cfg))
    loss.backward()
    grads = [p.grad for p in T.leaves(params)]
    St.reduce_gradients(model, grads, T.leaves(model.param_specs(),
                                               like=params), B)
    return float(loss.detach()), _gathered(
        T.map_tree(lambda p: p.grad, params), model.param_specs(), mesh)


def _decode(np_params, cfg, fam):
    """The serving rules on 2 x 2: a prefill, then teacher-forced decode
    steps; every step's logits (whole, as rank 0 returns them)."""
    from repro_torch.launch import steps as St
    model, _ = _model(cfg, "tp", 2, serving=True)
    params = St.shard_params(model, _port_params(np_params, cfg))
    batch = _batch(cfg)
    p, k = DECODE[fam]
    toks = batch["tokens"]
    cache = model.init_cache(B, p + k)
    side = (batch["frames"],) if cfg.encoder is not None else ()
    lg, cache = model.prefill(params, toks[:, :p], cache, *side)
    out = [lg.numpy().copy()]
    for t in range(k - 1):
        lg, cache = model.decode_step(params, cache, toks[:, p + t],
                                      torch.tensor(p + t, dtype=torch.int32))
        out.append(lg.numpy().copy())
    return out


def _states(np_params, cfg, fam):
    """A batch of one row (fewer than the 2 data ranks: the batch whole
    on every rank) prefilled under the serving rules: for each cache
    tensor, whether its shape is its ``cache_specs`` layout's block and
    its largest distance from that block of one process's cache."""
    from repro_torch.dist.collectives import axis, shard_dims
    from repro_torch.dist.sharding import local_shape
    from repro_torch.launch import steps as St
    from repro_torch.launch.steps import build_model
    from repro_torch.models.lm import Runtime
    model, mesh = _model(cfg, "tp", 2, serving=True)
    one = build_model(cfg, Runtime(), device="cpu")
    weights = _port_params(np_params, cfg)
    batch = _batch(cfg, rows=1)
    p, _ = DECODE[fam]
    side = (batch["frames"],) if cfg.encoder is not None else ()
    caches = []
    for m, w in ((model, St.shard_params(model, weights)), (one, weights)):
        c = m.init_cache(1, p + 4)
        m.prefill(w, batch["tokens"][:, :p], c, *side)
        caches.append(c)
    specs = model.cache_specs(1)
    out = []
    T.map_tree(lambda got, want, lay: out.append((
        tuple(got.shape) == local_shape(want.shape, lay, mesh),
        float((got.float() - shard_dims(want, lay, mesh).float())
              .abs().max()))), caches[0], caches[1], specs)
    return {"leaves": out, "batch": axis(mesh, "data").size,
            "layouts": [lay for lay in T.leaves(specs, like=caches[0])]}


def _world(rank, layout, ref_np):
    model_axis = WORLDS[layout][1]
    out = {}
    for fam, variant, regime in CASES[layout]:
        cfg = _cfg(fam, variant)
        out["grads", fam, regime] = _grads(ref_np[fam, variant], cfg,
                                           regime, model_axis)
    if layout == "2x2":
        for fam in FAMS:
            out["decode", fam] = _decode(ref_np[fam, "base"], _cfg(fam), fam)
            out["states", fam] = _states(ref_np[fam, "base"], _cfg(fam), fam)
    return out


@pytest.fixture(scope="module")
def worlds(ref):
    from repro_torch.launch.mesh import spawn
    ref_np = {key: rec["params"] for key, rec in ref.items()}
    return {layout: spawn(_world, n, layout, ref_np, timeout_s=600)
            for layout, (n, _) in WORLDS.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,fam,variant,regime", [
    (layout, f, v, r) for layout, cases in CASES.items()
    for f, v, r in cases])
def test_sharded_loss_and_gradients_match_jax_grad(worlds, ref, layout,
                                                   fam, variant, regime):
    """Each family's ``loss`` on the world's shards, under ``tp`` and
    ``tp+sp``: the global-batch loss on every rank within LOSS_REL_TOL
    of the reference's, and every gradient leaf, reduced and gathered
    whole, within GRAD_REL_TOL of ``jax.grad``'s — the RG-LRU's gathered
    main branch and Mamba-2's gathered projection and summed norm on 2 x
    2, the mixers run whole where 3 ranks do not divide 4 heads, the
    ``d_model``-sharded embedding under SP at a vocab of 510."""
    rec = ref[fam, variant]
    want = _port_params(rec["grads"], _cfg(fam, variant))
    worst = {}
    for out in worlds[layout]:
        loss, grads = out["grads", fam, regime]
        assert loss == pytest.approx(rec["loss"], rel=LOSS_REL_TOL)
        if "sharded loss" in rec and regime == "tp+sp":
            assert loss == pytest.approx(rec["sharded loss"],
                                         rel=LOSS_REL_TOL)
        for (key, w), g in zip(T.leaves_with_paths(want), grads):
            worst[key] = max(worst.get(key, 0.0), _rel(g, w.numpy()))
    assert len(worst) == len(T.leaves(want))
    assert max(worst.values()) <= GRAD_REL_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("fam", FAMS)
def test_sharded_prefill_and_decode_match_reference(worlds, ref, fam):
    """Under the serving rules on 2 x 2 (resident tensor-parallel
    weights, distributed decode over a sequence-sharded cache): the
    prefill's and each teacher-forced decode step's logits within
    rtol 3e-4 / atol 1e-3 of the reference's ``prefill`` and
    ``decode_step`` — recurrentgemma's steps cross its 32-slot window
    on a ring cache sharded over its slots, whisper's read the cross
    cache written whole on every rank."""
    want = ref[fam, "base"]["decode"]
    for out in worlds["2x2"]:
        got = out["decode", fam]
        assert len(got) == len(want) == DECODE[fam][1]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **LOGITS_TOL)


@pytest.mark.parametrize("fam", FAMS)
def test_caches_come_out_in_their_layouts(worlds, fam):
    """A one-row batch on 2 x 2 (the data dim cannot split it): every
    rank's cache tensors have the shapes of ``cache_specs``' layouts —
    the conv states and the cross cache whole over the model dim, the
    ``lru`` and ``ssm`` states this rank's channels or heads, the
    attention caches their block of the slots — and hold that block of
    one process's prefilled cache."""
    for out in worlds["2x2"]:
        st = out["states", fam]
        assert st["batch"] == 2
        assert all(lay[0] is None for lay in st["layouts"] if lay != (None,))
        assert all(ok for ok, _ in st["leaves"]), st
        assert max(d for _, d in st["leaves"]) <= 1e-4, st
        kinds = {("model" in lay) for lay in st["layouts"]}
        assert kinds == {True, False}


def test_whole_mixer_rule_and_layouts():
    """``layers._split_heads``: a dim that divides the heads and keeps
    GQA groups whole splits them; 3 ranks over 4 heads, 16 over
    recurrentgemma-2b's 10 and whisper-small's 12 do not; Mamba-2's 64
    heads split over 16.  ``EncDec``'s layouts are the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import DryMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.steps import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.lm import Runtime

    class Ax:
        def __init__(self, size):
            self.size = size
    rg, mb, wh = (get_config(a) for a in FAMS)
    assert L._split_heads(rg, Ax(2)) and L._split_heads(wh, Ax(4))
    assert not L._split_heads(rg, Ax(16)) and not L._split_heads(wh, Ax(16))
    assert not L._split_heads(_cfg("whisper-small", "n3"), Ax(3))
    heads = mb.ssm.expand * mb.d_model // mb.ssm.head_dim
    assert L._split_heads(mb, Ax(16), heads)
    assert not L._split_heads(mb, None, heads)
    rules = Rules(data=("data",), model="model", tp="model", seq="model")
    m = build_model(wh, Runtime(rules=rules, mesh=DryMesh(
        {"data": 16, "model": 16})), device="meta")
    specs = m.param_specs()
    assert specs["embed"] == (None, "model")             # 51865 over 16
    assert specs["enc_pos"] == specs["dec_pos"] == (None, ("data",))
    assert specs["dec_layers"][0]["cross_attn"]["wo"] == ("model",
                                                          ("data",))
    c = m.cache_specs(128)[0]
    assert c["self"]["k"] == (("data",), None, "model", None)
    assert c["cross"]["k"] == (("data",), None, None, None)


# ---------------------------------------------------------------------------
# the entry points on a world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMS)
def test_train_cli_model_axis_trains_each_family(fam, capfd):
    """``launch.train --model-axis 2 --world 4`` trains the family on a
    spawned 2 x 2 world: the one-rank run's losses within LOSS_REL_TOL."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--arch", fam, "--steps", "2", "--batch",
            "4", "--seq", "16", "--lr", "1e-2"]
    one = train.main(argv)["losses"]
    got = train.main(argv + ["--model-axis", "2", "--world", "4"])["losses"]
    np.testing.assert_allclose(got, one, rtol=LOSS_REL_TOL)
    assert "world=4 mesh=data2xmodel2" in capfd.readouterr().out


@pytest.mark.parametrize("fam", FAMS)
def test_serve_cli_shard_model_generates_each_family(fam):
    """``launch.serve --shard-model 2`` (fixed-batch ``generate`` on a
    spawned 1 x 2 world, the serving rules) gives the one-rank run's
    greedy tokens."""
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--arch", fam, "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    one = serve.main(argv)
    got = serve.main(argv + ["--shard-model", "2"])
    np.testing.assert_array_equal(got, one)
