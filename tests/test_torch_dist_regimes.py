"""The remaining distributed regimes of the port against the JAX package
on the CPU: the planned path under a mesh, paged serving under sequence
parallelism, and the ``zero3`` regime's multi-pod form.

The reference runs once per module in this process, on one CPU device:
qwen3 SMOKE's planned engine (``Runtime(planner=True)``, stitching on
and off) and its planned paged logits, teacher-forced, and a hand-wired
paged prefill;
one planned block from its plan; a prefill and decode steps over a
contiguous cache; and ``jax.value_and_grad`` of the loss for a dense
(qwen3), a hybrid (recurrentgemma), a state-space (mamba2) and the
encoder-decoder (whisper) SMOKE config.  The port runs in one spawned
gloo world of four ranks (``launch.mesh.spawn``), in f32 with the
reference's weights carried by ``models.convert``, over two meshes:

* 2 x 2 ("data", "model") under the serving rules: the planned engine
  in paged-spatial and paged-ring, stitching on and off (greedy tokens
  equal to the reference's planned engine on one device), the planned
  paged logits against the reference's within ``TOL``, and — with
  stitching and the kernel dispatch off — bitwise equal to the
  hand-wired block's under the same mesh; a paged prefill under
  ``Rules(seq="model")`` (sequence-parallel over the tensor-parallel
  dim), hand-wired and planned, then decode steps under plain tensor
  parallelism; one planned block with its stitched ``res2`` epilogue
  against the reference's block (a residual added before the MLP's
  reduction counts once a rank);
* 2 x 1 x 2 ("pod", "data", "model") under the ``zero3`` multi-pod
  rules (no tensor parallelism, the batch over the pods, the sequence
  over the model dim): the loss within ``LOSS_REL_TOL`` and every
  gradient leaf, reduced and gathered whole, within ``GRAD_REL_TOL`` of
  ``jax.grad``'s (a block scaled by the dim's size is off by 100 %), a
  hand-wired paged prefill, and a contiguous-cache prefill and decode
  steps.

The rank bodies import no jax.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import tree as T  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)              # tests/test_kernels.py
LOSS_REL_TOL = 1e-4                           # test_torch_dist_families.py
GRAD_REL_TOL = 1e-4
QWEN = "qwen3-8b"
FAMS = (QWEN, "recurrentgemma-2b", "mamba2-1.3b", "whisper-small")
B, S = 4, 32                                   # (c)'s batch
ENGINE = dict(max_batch=4, page_size=4, n_pages=40, max_pages_per_seq=6)
PAGED = dict(ps=4, mp=6, n_pages=24, plens=(5, 9, 3, 7), steps=3)
PREFILL_LEN = 13                               # (b): padded to 16 rows
CACHED = dict(prompt=16, steps=3)              # zero3's contiguous cache
REGIMES = ("paged-spatial", "paged-ring")


def _cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True)


def _inputs() -> dict:
    """Every seeded input of the module (numpy, seed 0)."""
    rs = np.random.RandomState(0)
    cfg = _cfg(QWEN)
    out = {"requests": [(rs.randint(0, cfg.vocab, size=int(n))
                         .astype(np.int32), g)
                        for n, g in ((9, 3), (5, 7), (12, 4), (7, 5),
                                     (3, 6))],
           "paged": rs.randint(0, cfg.vocab, size=(4, 16)).astype(np.int32),
           "prefill": rs.randint(0, cfg.vocab, size=(1, 16)).astype(np.int32),
           "cached": rs.randint(0, cfg.vocab, size=(B, 20)).astype(np.int32),
           "block_x": {ph: rs.standard_normal(
               (4, 1, cfg.d_model) if ph == "decode"
               else (1, 8, cfg.d_model)).astype(np.float32)
               for ph in ("decode", "prefill")},
           "pools": [rs.standard_normal((12, cfg.n_kv_heads, 4, cfg.dh))
                     .astype(np.float32) for _ in range(2)]}
    for arch in FAMS:
        c = _cfg(arch)
        tokens = rs.randint(0, c.vocab, (B, S)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        labels[0, :3] = -100
        batch = {"tokens": tokens, "labels": labels}
        if c.encoder is not None:
            batch["frames"] = rs.standard_normal(
                (B, c.encoder.n_frames, c.d_model)).astype(np.float32)
        out["batch", arch] = batch
    return out


def _paged_schedule():
    """The teacher-forced paged run: each request's page table, its
    prefill's padded tokens, then each decode step's slot positions,
    tokens and page table (slot 2 idles on odd steps)."""
    from repro_torch.serving import kv_pages as KP
    p = PAGED
    toks = _inputs()["paged"]
    pool = KP.PagePool(p["n_pages"], p["ps"])
    allocs = [KP.RequestPages() for _ in p["plens"]]
    prefills = []
    for i, n in enumerate(p["plens"]):
        assert allocs[i].ensure(n, pool)
        padded = np.zeros((1, math.ceil(n / p["ps"]) * p["ps"]), np.int32)
        padded[0, :n] = toks[i, :n]
        prefills.append((padded, KP.table_array([allocs[i]], p["mp"]), n))
    lengths, steps = list(p["plens"]), []
    for j in range(p["steps"]):
        active = [0, 1, 3] if j % 2 else [0, 1, 2, 3]
        pos = np.full(4, -1, np.int32)
        tk = np.zeros(4, np.int32)
        for i in active:
            assert allocs[i].ensure(lengths[i] + 1, pool)
            pos[i], tk[i] = lengths[i], toks[i, lengths[i]]
            lengths[i] += 1
        steps.append((tk, pos, KP.table_array(
            [allocs[i] if i in active else None for i in range(4)],
            p["mp"]), active))
    return prefills, steps


# ---------------------------------------------------------------------------
# the reference, once per module (one CPU device)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _schedules(tmp_path_factory):
    """A schedule cache of the module's own, which the spawned ranks
    inherit."""
    import os
    old = os.environ.get("REPRO_TORCH_CACHE_DIR")
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(tmp_path_factory.mktemp(
        "schedules"))
    yield
    if old is None:
        os.environ.pop("REPRO_TORCH_CACHE_DIR")
    else:
        os.environ["REPRO_TORCH_CACHE_DIR"] = old


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.core import planner as ref_planner
    from repro.launch import steps as RS
    from repro.models import layers as RL
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    from repro.serving import ServingEngine as RefEngine
    inp = _inputs()
    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch in FAMS:
            cfg = ref_config(arch, smoke=True)
            model = RS.build_model(cfg, RefRuntime(remat=False))
            params = model.init_params(jax.random.PRNGKey(0))
            batch = {k: jnp.asarray(v) for k, v in inp["batch", arch].items()}
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(params,
                                                                 batch)
            out["np", arch] = jax.tree.map(np.asarray, params)
            out["loss", arch] = float(loss)
            out["grads", arch] = jax.tree.map(np.asarray, grads)
            if arch in (QWEN, "recurrentgemma-2b"):
                toks = jnp.asarray(inp["cached"])
                p, k = CACHED["prompt"], CACHED["steps"]
                cache = model.init_cache(B, p + k)
                lg, cache = jax.jit(model.prefill)(params, toks[:, :p], cache)
                logits = [np.asarray(lg)]
                step = jax.jit(model.decode_step)
                for t in range(k):
                    lg, cache = step(params, cache, toks[:, p + t],
                                     jnp.int32(p + t))
                    logits.append(np.asarray(lg))
                out["cached", arch] = logits
            if arch != QWEN:
                continue
            ref_params = params
            for stitch in (False, True):
                rm = RefLM(cfg, RefRuntime(planner=True, stitch=stitch))
                res, _ = RefEngine(rm, params, choose_regime=False,
                                   **ENGINE).run(inp["requests"])
                out["engine", stitch] = [r.tokens for r in res]
            out["paged"] = _ref_paged(rm, params)
            out["prefill"] = _ref_prefill(RefLM(cfg, RefRuntime()), params)
            # one planned block, its stitched res2 after the MLP
            rp = jax.tree.map(lambda a: a[0], ref_params["stack"]["b0_attn"])
            for phase, x in inp["block_x"].items():
                out["block", phase] = _ref_block(
                    RL, ref_planner, cfg, rp, x, phase, inp["pools"])
    return out


def _ref_paged(model, params) -> list:
    """The teacher-forced paged run (``_paged_schedule``) on the
    reference's planned path: every logits row of the live slots."""
    import jax
    import jax.numpy as jnp
    p = PAGED
    prefill, decode = (jax.jit(model.prefill_paged),
                       jax.jit(model.decode_step_paged))
    cache = model.init_paged_cache(p["n_pages"], p["ps"])
    prefills, steps = _paged_schedule()
    got = []
    for toks, table, n in prefills:
        lg, cache = prefill(params, jnp.asarray(toks), cache,
                            jnp.asarray(table), jnp.int32(n))
        got.append(np.asarray(lg))
    for tk, pos, table, active in steps:
        lg, cache = decode(params, cache, jnp.asarray(tk), jnp.asarray(pos),
                           jnp.asarray(table))
        got.append(np.asarray(lg)[active])
    return got


def _ref_prefill(model, params) -> list:
    """(b): one prompt's paged prefill, then two decode steps."""
    import jax
    import jax.numpy as jnp
    toks = _inputs()["prefill"]
    cache = model.init_paged_cache(12, 4)
    table = np.array([[3, 5, 1, 7, 9, -1]], np.int32)
    decode = jax.jit(model.decode_step_paged)
    lg, cache = jax.jit(model.prefill_paged)(
        params, jnp.asarray(toks), cache, jnp.asarray(table),
        jnp.int32(PREFILL_LEN))
    got = [np.asarray(lg)]
    for j in range(2):
        lg, cache = decode(
            params, cache, jnp.asarray(toks[:, PREFILL_LEN + j]),
            jnp.asarray([PREFILL_LEN + j], np.int32), jnp.asarray(table))
        got.append(np.asarray(lg))
    return got


def _block_args(phase):
    b, s = (4, 1) if phase == "decode" else (1, 8)
    if phase == "decode":
        pos = np.array([[6], [-1], [13], [2]], np.int32)
        table = np.array([[3, 5, -1, -1], [-1] * 4, [1, 2, 4, 6],
                          [8, -1, -1, -1]], np.int32)
    else:
        pos = np.where(np.arange(s) < 6, np.arange(s), -1)[None].astype(
            np.int32)
        table = np.array([[7, 2, -1, -1]], np.int32)
    return b, s, pos, table, dict(stitch=True, phase=phase, paged=4,
                                  kv_len=16)


def _ref_block(RL, ref_planner, cfg, rp, x, phase, pools):
    import jax.numpy as jnp
    from repro.models.lm import Runtime as RefRuntime
    b, s, pos, table, kw = _block_args(phase)
    plan = ref_planner.plan_model(cfg, b, s, use_cache=False, **kw)
    rt = RefRuntime(planner=True, stitch=True)
    got, _ = RL.run_planned_layer(
        plan.layer, rp, jnp.asarray(x), cfg, rt.rules,
        positions=jnp.asarray(pos), rt=rt,
        cache={"k_pages": jnp.asarray(pools[0]),
               "v_pages": jnp.asarray(pools[1])},
        page_table=jnp.asarray(table))
    return np.asarray(got)


# ---------------------------------------------------------------------------
# rank bodies (module level, no jax)
# ---------------------------------------------------------------------------

def _serving_rules(seq=None):
    from repro_torch.dist.sharding import Rules
    return Rules(data=("data",), model="model", tp="model", seq=seq,
                 fsdp=False)


def _zero3_rules():
    """The JAX package's ``zero3`` multi-pod rules (``launch.dryrun``
    ``cell_rules``)."""
    from repro_torch.launch.dryrun import cell_rules
    return cell_rules("train", True, "zero3")[1]


def _model(arch, mesh, rules, **rt):
    from repro_torch.launch.steps import build_model, shard_params
    from repro_torch.models.convert import (encdec_params_from_jax,
                                            params_from_jax)
    from repro_torch.models.lm import Runtime
    cfg = _cfg(arch)
    model = build_model(cfg, Runtime(rules=rules, mesh=mesh, **rt),
                        device="cpu")
    return model, cfg, (encdec_params_from_jax if cfg.encoder
                        else params_from_jax)


def _paged_logits(model, params) -> list:
    """``_ref_paged`` on the port's model."""
    p = PAGED
    cache = model.init_paged_cache(p["n_pages"], p["ps"])
    prefills, steps = _paged_schedule()
    got = []
    with torch.no_grad():
        for toks, table, n in prefills:
            lg, cache = model.prefill_paged(
                params, torch.from_numpy(toks).long(), cache,
                torch.from_numpy(table), n)
            got.append(lg.numpy().copy())
        for tk, pos, table, active in steps:
            lg, cache = model.decode_step_paged(
                params, cache, torch.from_numpy(tk).long(),
                torch.from_numpy(pos), torch.from_numpy(table))
            got.append(lg.numpy()[active].copy())
    return got


def _prefill_logits(model, params) -> list:
    """``_ref_prefill`` on the port's model: the prefill under the
    model's rules, the decode steps with S = 1 (no sequence
    parallelism)."""
    toks = torch.from_numpy(_inputs()["prefill"]).long()
    cache = model.init_paged_cache(12, 4)
    table = torch.tensor([[3, 5, 1, 7, 9, -1]], dtype=torch.int32)
    lg, cache = model.prefill_paged(params, toks, cache, table, PREFILL_LEN)
    got = [lg.numpy().copy()]
    for j in range(2):
        lg, cache = model.decode_step_paged(
            params, cache, toks[:, PREFILL_LEN + j],
            torch.tensor([PREFILL_LEN + j], dtype=torch.int32), table)
        got.append(lg.numpy().copy())
    return got


def _engine(model, params, requests):
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, params, choose_regime=False, **ENGINE)
    res, stats = eng.run(requests)
    return {"tokens": [r.tokens for r in res], "regime": eng.regime,
            "planned": eng.decode_plan is not None,
            "pools": tuple(eng.cache[0]["k_pages"].shape),
            "clean": eng.pool.n_free == eng.pool.n_pages - 1,
            "tier": stats["exec_tier"], "graph": stats["decode_graph"],
            "deny": stats["tier_demotions"]}


def _planned_block(np_params, mesh, phase):
    """(d): qwen3's first block from its stitched plan on this rank's
    shards (tensor-parallel over the model dim, every rank its batch
    rows whole), the fused MLP chain through the kernel dispatch."""
    from repro_torch.core import planner
    from repro_torch.launch.steps import shard_params
    from repro_torch.models import layers as L
    model, cfg, conv = _model(QWEN, mesh, _serving_rules(),
                              kernel_ops=True, planner=True)
    params = shard_params(model, conv(np_params, cfg))
    inp = _inputs()
    b, s, pos, table, kw = _block_args(phase)
    plan = planner.plan_model(cfg, b, s, **kw)
    assert any(c.kind == "mlp" and c.fused and "res2" in c.epilogue
               for c in plan.layer.chains)
    tp = model._tp
    cache = {k: tp.shard(torch.from_numpy(pl.copy()), 1).contiguous()
             for k, pl in zip(("k_pages", "v_pages"), inp["pools"])}
    # the block alone: every rank takes the rows whole
    ctx = L.Mesh(mesh, model.rt.rules, tp, b)
    with torch.no_grad():
        out, _ = L.run_planned_layer(
            plan.layer, params["layers"][0], torch.from_numpy(
                inp["block_x"][phase]), cfg, positions=torch.from_numpy(pos),
            rt=model.rt, cache=cache, page_table=torch.from_numpy(table),
            ctx=ctx)
    return out.numpy().copy()


def _zero3(np_params, arch, mesh):
    """(c): the loss and every gradient leaf, reduced and gathered
    whole, under the zero3 multi-pod rules."""
    from repro_torch.dist.collectives import gather_dims
    from repro_torch.launch import steps as St
    from repro_torch.models.lm import requires_grad
    model, cfg, conv = _model(arch, mesh, _zero3_rules())
    params = requires_grad(St.shard_params(model, conv(np_params, cfg)))
    batch = {k: (torch.from_numpy(v) if v.dtype == np.float32
                 else torch.from_numpy(v).long())
             for k, v in _inputs()["batch", arch].items()}
    loss = model.loss(params, batch)
    loss.backward()
    grads = [p.grad for p in T.leaves(params)]
    specs = model.param_specs()
    St.reduce_gradients(model, grads, T.leaves(specs, like=params), B)
    out: list = []
    with torch.no_grad():
        T.map_tree(lambda t, sp: out.append(
            gather_dims(t.grad, sp, mesh).numpy().copy()), params, specs)
    return float(loss.detach()), out


def _cached(np_params, arch, mesh):
    """A contiguous-cache prefill under the zero3 multi-pod rules (the
    prompt sequence-parallel, the caches whole but for the batch), then
    decode steps."""
    from repro_torch.launch.steps import shard_params
    model, cfg, conv = _model(arch, mesh, _zero3_rules())
    params = shard_params(model, conv(np_params, cfg))
    toks = torch.from_numpy(_inputs()["cached"]).long()
    p, k = CACHED["prompt"], CACHED["steps"]
    cache = model.init_cache(B, p + k)
    with torch.no_grad():
        lg, cache = model.prefill(params, toks[:, :p], cache)
        got = [lg.numpy().copy()]
        for t in range(k):
            lg, cache = model.decode_step(params, cache, toks[:, p + t],
                                          torch.tensor(p + t))
            got.append(lg.numpy().copy())
    return got


def _world(rank, ref_np):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import shard_params
    mesh = make_host_mesh(2)
    pods = make_host_mesh(2, pods=2)
    inp = _inputs()
    qwen = ref_np[QWEN]
    out = {"mesh": dict(zip(pods.mesh_dim_names, pods.shape))}

    def served(**rt):
        model, cfg, conv = _model(QWEN, mesh, _serving_rules(), **rt)
        return model, shard_params(model, conv(qwen, cfg))

    for regime in REGIMES:
        ring = dict(dist_decode_attn=regime == "paged-ring")
        for stitch in (False, True):
            model, params = served(kernel_ops=True, planner=True,
                                   stitch=stitch, **ring)
            out["engine", regime, stitch] = _engine(model, params,
                                                    inp["requests"])
            out["paged", regime, stitch] = _paged_logits(model, params)
        # stitching and the kernel dispatch off: the hand-wired block's
        # numbers, bit for bit
        for planned in (False, True):
            model, params = served(planner=planned, stitch=False, **ring)
            out["bitwise", regime, planned] = _paged_logits(model, params)
    for planned in (False, True):
        model, cfg, conv = _model(QWEN, mesh, _serving_rules("model"),
                                  kernel_ops=True, planner=planned)
        params = shard_params(model, conv(qwen, cfg))
        with torch.no_grad():
            out["prefill sp", planned] = _prefill_logits(model, params)
    for phase in ("decode", "prefill"):
        out["block", phase] = _planned_block(qwen, mesh, phase)
    model, cfg, conv = _model(QWEN, pods, _zero3_rules())
    with torch.no_grad():
        out["prefill zero3"] = _prefill_logits(
            model, shard_params(model, conv(qwen, cfg)))
    for arch in FAMS:
        out["zero3", arch] = _zero3(ref_np[arch], arch, pods)
    for arch in (QWEN, "recurrentgemma-2b"):
        out["cached", arch] = _cached(ref_np[arch], arch, pods)
    return out


@pytest.fixture(scope="module")
def world(ref):
    from repro_torch.launch.mesh import spawn
    ref_np = {arch: ref["np", arch] for arch in FAMS}
    return spawn(_world, 4, ref_np, timeout_s=600)


def _port(arch, tree):
    from repro_torch.models.convert import (encdec_params_from_jax,
                                            params_from_jax)
    cfg = _cfg(arch)
    return (encdec_params_from_jax if cfg.encoder else params_from_jax)(
        tree, cfg)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# (a) the planned engine under the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("stitch", [False, True])
def test_planned_engine_under_the_mesh_matches_reference(world, ref, regime,
                                                         stitch):
    """The planned engine (``Runtime(kernel_ops=True, planner=True)``) on
    2 x 2 in the forced regime: the reference planned engine's greedy
    tokens on one device, the decode plan built (the global one), the
    pools heads-sharded for paged-spatial and whole for paged-ring,
    every step eager, nothing degraded."""
    for out in world:
        eng = out["engine", regime, stitch]
        assert eng["regime"] == regime and eng["planned"]
        assert eng["tokens"] == ref["engine", stitch]
        assert eng["pools"][1] == (2 if regime == "paged-ring" else 1)
        assert eng["clean"] and eng["tier"] == "configured"
        assert eng["graph"] == "eager" and eng["deny"] == 0


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("stitch", [False, True])
def test_planned_paged_logits_under_the_mesh_match_reference(world, ref,
                                                             regime, stitch):
    """Teacher-forced prefills and ragged decode steps (an idle slot) of
    the planned path on 2 x 2: every logits row within ``TOL`` of the
    reference's planned path on one device (stitched glue computes the
    same f32 numbers within ``TOL``, so one reference serves both)."""
    want = ref["paged"]
    for out in world:
        got = out["paged", regime, stitch]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("regime", REGIMES)
def test_planned_path_without_stitching_is_the_hand_wired_bit_for_bit(
        world, regime):
    """With stitching and the kernel dispatch off, the planned layer
    under the mesh computes the hand-wired layer's numbers under the
    same mesh, bit for bit, as it does on one card."""
    for out in world:
        hand, planned = (out["bitwise", regime, p] for p in (False, True))
        assert len(hand) == len(planned) == len(PAGED["plens"]) + \
            PAGED["steps"]
        for h, p in zip(hand, planned):
            np.testing.assert_array_equal(p, h)


# ---------------------------------------------------------------------------
# (b) paged serving under sequence parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planned", [False, True])
def test_paged_prefill_under_sequence_parallelism(world, ref, planned):
    """A 13-token prompt padded to 16 rows, prefilled under
    ``Rules(seq="model")`` (8 rows a rank on the tensor-parallel dim),
    hand-wired and planned, then two decode steps under plain tensor
    parallelism: every logits within ``TOL`` of the reference's paged
    prefill and decode on one device."""
    for out in world:
        for g, w in zip(out["prefill sp", planned], ref["prefill"]):
            np.testing.assert_allclose(g, w, **TOL)


def test_paged_prefill_under_the_zero3_rules(world, ref):
    """The same prefill under the zero3 multi-pod rules: no tensor
    parallelism, the pools whole, each rank's block of the prompt's
    rows kept after each block (no reduce-scatter)."""
    for out in world:
        for g, w in zip(out["prefill zero3"], ref["prefill"]):
            np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# (c) the zero3 regime's multi-pod form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMS)
def test_zero3_multi_pod_loss_and_gradients_match_jax_grad(world, ref, arch):
    """``loss`` on the 2 x 1 x 2 world under ``cell_rules("train", True,
    "zero3")`` (every weight gathered whole, the batch over the pods,
    the sequence over the model dim): the global-batch loss on every
    rank within LOSS_REL_TOL of the reference's, and every gradient
    leaf, reduced and gathered whole, within GRAD_REL_TOL of
    ``jax.grad``'s on one device — the rows attention, the whole RG-LRU,
    Mamba-2 and cross-attention blocks, the row-local MLP, each rank's
    cross-entropy over its block of the sequence."""
    want = _port(arch, ref["grads", arch])
    for out in world:
        assert out["mesh"] == {"pod": 2, "data": 1, "model": 2}
        loss, grads = out["zero3", arch]
        assert loss == pytest.approx(ref["loss", arch], rel=LOSS_REL_TOL)
        leaves = list(T.leaves_with_paths(want))
        assert len(grads) == len(leaves)
        worst = max(((_rel(g, w.numpy()), key)
                     for (key, w), g in zip(leaves, grads)))
        assert worst[0] <= GRAD_REL_TOL, worst


@pytest.mark.parametrize("arch", [QWEN, "recurrentgemma-2b"])
def test_zero3_multi_pod_prefill_and_decode_match_reference(world, ref,
                                                            arch):
    """A 16-token prefill over a contiguous cache under the zero3
    multi-pod rules (the prompt sequence-parallel: the rows attention
    writing the whole cache, the RG-LRU whole), then three decode steps
    without sequence parallelism: every logits within ``TOL`` of the
    reference's ``prefill`` and ``decode_step``."""
    for out in world:
        got, want = out["cached", arch], ref["cached", arch]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# (d) one planned block under the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_planned_block_sums_the_mlp_before_its_residual(world, ref, phase):
    """qwen3's first block from its stitched plan on each rank's shards:
    the MLP kernel's rank-partial output summed over the model dim
    before the stitched ``res2`` adds the residual — within ``TOL`` of
    the reference's block, where a residual added on each rank before
    the sum would count twice."""
    for out in world:
        np.testing.assert_allclose(out["block", phase], ref["block", phase],
                                   **TOL)


def test_mlp_tuner_tiles_at_the_rank_blocks():
    """``ops.mlp_chain`` tunes at the rank's block (M, d_ff / tp, H): the
    tuner finds tiles within the MLP kernel's tile rule
    (``perf_model.mlp_tiles_ok``) at qwen3-8b's block on 4 ranks (N =
    3072 of 12288, K = H = 4096), at decode and prefill rows."""
    from repro_torch.core import api
    from repro_torch.core.perf_model import mlp_tiles_ok
    for m in (4, 144):
        tk = api.fuse_mlp_chain(m, 3072, 4096, dtype="bfloat16")
        kw = tk.params.as_kwargs()
        assert bool(mlp_tiles_ok(kw["bm"], kw["bn"], 3072, 2, 2)), kw
