"""Mesh execution of the port against the JAX package's single-device
results: worlds of spawned ranks on the CPU (gloo over a FileStore,
``launch.mesh.spawn``), each rank holding its shards.

Counterparts of ``tests/test_dist_exec.py``, of the ring dispatch and
engine checks of ``tests/test_serving.py`` (its 8-device paged-ring
test) and ``tests/test_ring_attention.py``: the sharded kernel dispatch
(``ops.gemm_chain``, ``ops.attention`` in each regime, forced) within
1e-3 of the reference's, ``LM.loss`` of qwen3 SMOKE within 1e-3 with
``kernel_ops`` on and off, ``decode_step`` over a heads-sharded (qwen3)
and a sequence-sharded (granite-20b) cache with ``dist_decode_attn``
within 1e-2, the paged ring decode attention against the reference's
gather twin within 1e-5, the serving engine under the mesh in each
paged regime with the single-card engine's tokens (f32), and the serve
CLI's ``--shard-model 2``.  The weights are the reference's, carried by
``models.convert``.  The rank bodies import no jax: each world runs
once per module and the tests read its results.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

B, M, K, N, H = 4, 256, 128, 256, 512           # tests/test_dist_exec.py
ATTN = (2, 8, 4, 256, 64)                       # B, Hq, Hkv, S, D
RING = dict(b=2, hq=4, hkv=2, d=16, ps=8, mp=8, n_pages=20)
ENGINE = dict(max_batch=4, page_size=8, n_pages=24, max_pages_per_seq=8)
BUDGETS = (3, 8, 5, 2)


def _inputs() -> dict:
    rs = np.random.RandomState(0)
    f = np.float32
    bq, hq, hkv, s, d = ATTN
    toks = rs.randint(0, 512, size=(4, 32)).astype(np.int32)
    r = RING
    table = np.full((r["b"], r["mp"]), -1, np.int32)
    table[0, :3] = [7, 2, 11]
    table[1, :2] = [4, 5]
    return {
        "a": rs.standard_normal((B, M, K)).astype(f),
        "b": rs.standard_normal((B, K, N)).astype(f),
        "d": (rs.standard_normal((B, N, H)) * 0.1).astype(f),
        "q": rs.standard_normal((bq, hq, s, d)).astype(f),
        "k": rs.standard_normal((bq, hkv, s, d)).astype(f),
        "v": rs.standard_normal((bq, hkv, s, d)).astype(f),
        "toks": toks,
        "kp": rs.standard_normal((r["n_pages"], r["hkv"], r["ps"],
                                  r["d"])).astype(f),
        "vp": rs.standard_normal((r["n_pages"], r["hkv"], r["ps"],
                                  r["d"])).astype(f),
        "rq": rs.standard_normal((r["b"], r["hq"], 1, r["d"])).astype(f),
        "table": table,
        "positions": np.array([18, 11], np.int32),
        "requests": [(rs.randint(0, 512, size=9).astype(np.int32), g)
                     for g in BUDGETS],
    }


def _ref_params(arch: str):
    import jax

    from repro.configs import get_config as ref_config
    from repro.models.lm import LM as RefLM
    from repro.models.lm import Runtime as RefRuntime
    model = RefLM(ref_config(arch, smoke=True), RefRuntime(remat=False))
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# rank bodies (module level, no jax)
# ---------------------------------------------------------------------------

def _port_params(np_params, model):
    from repro_torch.launch.steps import shard_params
    from repro_torch.models.convert import params_from_jax
    return shard_params(model, params_from_jax(np_params, model.cfg))


def _decode(np_params, arch, rules, mesh, dist_decode):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, Runtime
    inp = _inputs()
    model = LM(get_config(arch, smoke=True),
               Runtime(rules=rules, mesh=mesh, dist_decode_attn=dist_decode),
               device="cpu")
    params = _port_params(np_params, model)
    toks = torch.from_numpy(inp["toks"]).long()
    cache = model.init_cache(4, 64)
    _, cache = model.prefill(params, toks[:, :31], cache)
    logits, _ = model.decode_step(params, cache, toks[:, 31],
                                  torch.tensor(31))
    return logits.numpy(), tuple(cache[0]["k"].shape)


def _loss(np_params, rules, mesh, kernel_ops):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, Runtime
    toks = torch.from_numpy(_inputs()["toks"]).long()
    model = LM(get_config("qwen3-8b", smoke=True),
               Runtime(rules=rules, mesh=mesh, kernel_ops=kernel_ops),
               device="cpu")
    params = _port_params(np_params, model)
    with torch.no_grad():
        return float(model.loss(params, {"tokens": toks, "labels": toks}))


def _forced_attention(q, k, v, mesh, rules, regime):
    """``ops.attention`` on the mesh with ``regime`` forced by calling
    its function on this rank's block of the whole tensors: the spatial
    body on the batch and heads the spatial placement gives the rank,
    or ``ring_attention`` on the rank's batch with every head, at the
    tiles the tuner gives the ring's partial kernel; the output
    gathered whole."""
    from repro_torch.core import api
    from repro_torch.core.perf_model import H100
    from repro_torch.dist.collectives import axis
    from repro_torch.dist.ring_dispatch import (plan_ring_attention,
                                                ring_attention, ring_group)
    from repro_torch.dist.sharding import dispatch_mesh_spec
    from repro_torch.kernels import ops
    b, hq, m, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    spec, baxes, hax = dispatch_mesh_spec(
        rules, mesh, kind="attention", batch=b, feature_dims=(hkv, hq),
        ici_bw=H100.ici_bw)
    bx = axis(mesh, baxes)
    hx = axis(mesh, hax) if regime == "spatial" else None
    if bx is not None:
        q, k, v = (bx.shard(t, 0) for t in (q, k, v))
    if hx is not None:
        q, k, v = (hx.shard(t, 1) for t in (q, k, v))
    if regime == "spatial":
        o = ops._attn_body(q, k, v, spec=spec, batch=b, heads=hq,
                           causal=True, window=0, scale=None)
    else:
        plan = plan_ring_attention(rules, mesh, batch=b, kv_len=n,
                                   feature_dims=(hkv, hq),
                                   ici_bw=H100.ici_bw)
        p = api.fuse_attention(m, n, d, d, heads=hq, batch=b,
                               causal=True, mesh=plan.spec,
                               group=ring_group(hq, hkv, m)).params
        o = ring_attention(q, k, v, mesh=mesh, axis_name=plan.axis,
                           causal=True, bq=p.bq, bkv=p.bkv,
                           pipelined=regime == "ring-pipelined")
    if hx is not None:
        o = hx.all_gather(o, 1)
    return bx.all_gather(o, 0) if bx is not None else o


def _world_2x2(rank, np_qwen, np_granite):
    from repro_torch.dist.collectives import axis
    from repro_torch.dist.ring_dispatch import paged_ring_decode_attention
    from repro_torch.dist.sharding import Rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import sharded_runtime
    from repro_torch.launch.steps import build_model
    from repro_torch.configs import get_config
    inp = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in _inputs().items()}
    mesh = make_host_mesh(2)
    rules = Rules(data=("data",), model="model", tp="model")
    out = {"gemm": ops.gemm_chain(inp["a"], inp["b"], inp["d"], mesh=mesh,
                                  rules=rules).numpy()}
    for regime in ("spatial", "ring", "ring-pipelined"):
        out[f"attn {regime}"] = _forced_attention(
            inp["q"], inp["k"], inp["v"], mesh, rules, regime).numpy()
    out["attn tuner"] = ops.attention(inp["q"], inp["k"], inp["v"],
                                      causal=True, mesh=mesh,
                                      rules=rules).numpy()
    for ko in (False, True):
        out[f"loss kernel_ops={ko}"] = _loss(np_qwen, rules, mesh, ko)
    for arch, npp in (("qwen3-8b", np_qwen), ("granite-20b", np_granite)):
        for dd in (False, True):
            out[f"decode {arch} {dd}"], out[f"cache {arch}"] = _decode(
                npp, arch, rules, mesh, dd)

    # the paged ring decode attention: this rank's batch row, gathered
    data = axis(mesh, "data")
    r = RING
    for pipelined in (False, True):
        for win in (0, 10):
            o = paged_ring_decode_attention(
                data.shard(inp["rq"], 0), inp["kp"], inp["vp"],
                data.shard(inp["table"], 0), data.shard(inp["positions"], 0),
                window=win, scale=r["d"] ** -0.5, mesh=mesh,
                axis_name="model", pipelined=pipelined)
            out[f"paged ring {pipelined} {win}"] = data.all_gather(
                o, 0).numpy()

    # the engine under the mesh: the tuner's regime, then each forced by
    # the Runtime's flags with the search off
    _, _, rt = sharded_runtime(2, mesh)
    from repro_torch.serving import ServingEngine
    for forced in (None, "paged-ring", "paged-ring-pipelined",
                   "paged-spatial"):
        frt = rt if forced is None else dataclasses.replace(
            rt, dist_decode_attn=forced != "paged-spatial",
            dist_decode_pipelined=forced == "paged-ring-pipelined")
        model = build_model(get_config("qwen3-8b", smoke=True), frt,
                            device="cpu")
        eng = ServingEngine(model, _port_params(np_qwen, model),
                            choose_regime=forced is None, **ENGINE)
        res, stats = eng.run(inp["requests"])
        out[f"engine {forced}"] = {
            "regime": eng.regime, "tokens": [r.tokens for r in res],
            "ring": eng.model.rt.dist_decode_attn,
            "pipe": eng.model.rt.dist_decode_pipelined,
            "pool_clean": eng.pool.n_free == eng.pool.n_pages - 1,
            "pools": tuple(eng.cache[0]["k_pages"].shape),
            "decode_graph": stats["decode_graph"],
            "exec_tier": stats["exec_tier"]}
    return out


def _world_2x4(rank, np_qwen):
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4)
    rules = Rules(data=("data",), model="model", tp="model", seq=None)
    out = {"loss": _loss(np_qwen, rules, mesh, False)}
    out["decode"], out["cache"] = _decode(np_qwen, "qwen3-8b", rules, mesh,
                                          True)
    return out


# ---------------------------------------------------------------------------
# the worlds and the reference, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ops as rops
    from repro.models.layers import _paged_positional_attention
    from repro.serving import kv_pages as KP
    inp = _inputs()
    j = {k: jnp.asarray(v) for k, v in inp.items() if k != "requests"}
    out = {"gemm": np.asarray(rops.gemm_chain(j["a"], j["b"], j["d"],
                                              mode="ref")),
           "attn": np.asarray(rops.attention(j["q"], j["k"], j["v"],
                                             causal=True, mode="ref"))}
    toks = j["toks"]
    for arch in ("qwen3-8b", "granite-20b"):
        model, params, np_params = _ref_params(arch)
        out[f"np {arch}"] = np_params
        out[f"params {arch}"] = params
        if arch == "qwen3-8b":
            out["loss"] = float(model.loss(params, {"tokens": toks,
                                                    "labels": toks}))
        cache = model.init_cache(4, 64)
        _, cache = model.prefill(params, toks[:, :31], cache)
        lg, _ = model.decode_step(params, cache, toks[:, 31], jnp.int32(31))
        out[f"decode {arch}"] = np.asarray(lg)
    r = RING
    group = r["hq"] // r["hkv"]
    kk = jnp.repeat(KP.gather_pages(j["kp"], j["table"]), group, axis=1)
    vv = jnp.repeat(KP.gather_pages(j["vp"], j["table"]), group, axis=1)
    kv_pos = KP.paged_kv_positions(j["table"], r["ps"])
    for win in (0, 10):
        out[f"paged {win}"] = np.asarray(_paged_positional_attention(
            j["rq"], kk, vv, j["positions"][:, None], kv_pos, win,
            r["d"] ** -0.5))
    return out


@pytest.fixture(scope="module")
def world(ref):
    from repro_torch.launch.mesh import spawn
    outs = spawn(_world_2x2, 4, ref["np qwen3-8b"], ref["np granite-20b"],
                 timeout_s=600)
    return outs


@pytest.fixture(scope="module")
def single_engine(ref):
    """The single-card port engine on the same weights and requests."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.serving import ServingEngine
    cfg = get_config("qwen3-8b", smoke=True)
    model = LM(cfg, Runtime(kernel_ops=True), device="cpu")
    eng = ServingEngine(model, params_from_jax(ref["np qwen3-8b"], cfg),
                        **ENGINE)
    res, _ = eng.run(_inputs()["requests"])
    return [r.tokens for r in res]


def test_every_rank_returns_the_same_results(world):
    for out in world[1:]:
        for key, val in world[0].items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(out[key], val, err_msg=key)
            else:
                assert out[key] == val, key


def test_sharded_gemm_chain_matches_reference(world, ref):
    assert np.abs(world[0]["gemm"] - ref["gemm"]).max() < 1e-3


@pytest.mark.parametrize("regime", ["spatial", "ring", "ring-pipelined",
                                    "tuner"])
def test_sharded_attention_each_regime_matches_reference(world, ref,
                                                         regime):
    assert np.abs(world[0][f"attn {regime}"] - ref["attn"]).max() < 1e-3


@pytest.mark.parametrize("kernel_ops", [False, True])
def test_sharded_loss_matches_reference(world, ref, kernel_ops):
    got = world[0][f"loss kernel_ops={kernel_ops}"]
    assert abs(got - ref["loss"]) < 1e-3


@pytest.mark.parametrize("arch,cache", [("qwen3-8b", (2, 1, 64, 16)),
                                        ("granite-20b", (2, 1, 32, 16))])
@pytest.mark.parametrize("dist_decode", [False, True])
def test_sharded_decode_matches_reference(world, ref, arch, cache,
                                          dist_decode):
    """qwen3's 2 kv heads split over the model dim of 2 (a heads-sharded
    cache); granite's single kv head cannot, so its cache is
    sequence-sharded and its decode step runs
    ``distributed_decode_attention``."""
    got = world[0][f"decode {arch} {dist_decode}"]
    assert world[0][f"cache {arch}"] == cache
    assert np.abs(got - ref[f"decode {arch}"]).max() < 1e-2


@pytest.mark.parametrize("win", [0, 10])
def test_paged_ring_decode_attention_matches_the_gather_twin(world, ref,
                                                             win):
    serial = world[0][f"paged ring False {win}"]
    piped = world[0][f"paged ring True {win}"]
    assert np.abs(serial - ref[f"paged {win}"]).max() < 1e-5
    assert np.abs(piped - ref[f"paged {win}"]).max() < 1e-5
    # the same rescaled addends, the ring's rotated f32 summation
    assert np.abs(piped - serial).max() < 2e-6


@pytest.mark.parametrize("forced", [None, "paged-ring",
                                    "paged-ring-pipelined", "paged-spatial"])
def test_engine_under_the_mesh(world, single_engine, forced):
    """The assertions of the reference's paged-ring engine test, with
    the single-card engine's tokens (f32): the regime threads into the
    Runtime the engine runs, the pools are whole on every rank for the
    ring regimes and heads-sharded otherwise, every step eager."""
    out = world[0][f"engine {forced}"]
    assert out["regime"] in ("paged-spatial", "paged-ring",
                             "paged-ring-pipelined")
    if forced is not None:
        assert out["regime"] == forced
    assert out["ring"] == (out["regime"] != "paged-spatial")
    assert out["pipe"] == (out["regime"] == "paged-ring-pipelined")
    assert out["pools"][1] == (2 if out["ring"] else 1)
    assert [len(t) for t in out["tokens"]] == list(BUDGETS)
    assert out["tokens"] == single_engine
    assert out["pool_clean"] and out["exec_tier"] == "configured"
    assert out["decode_graph"] == "eager"      # on the CPU


def test_2x4_world_matches_reference(ref):
    """The reference's own 2 x 4 mesh: qwen3's 2 kv heads do not split 4
    ways, so its cache is sequence-sharded."""
    from repro_torch.launch.mesh import spawn
    outs = spawn(_world_2x4, 8, ref["np qwen3-8b"], timeout_s=600)
    assert abs(outs[0]["loss"] - ref["loss"]) < 1e-3
    assert outs[0]["cache"] == (2, 2, 16, 16)
    assert np.abs(outs[0]["decode"] - ref["decode qwen3-8b"]).max() < 1e-2


def test_serve_cli_shard_model(capsys):
    """``--shard-model 2 --device cpu`` spawns its ranks and generates
    the one-card CLI's tokens (f32), printing the tuner's regimes."""
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen", "4"]
    one = serve.main(argv)
    two = serve.main(argv + ["--shard-model", "2"])
    np.testing.assert_array_equal(one, two)
    cont = serve.main(argv + ["--continuous", "--page-size", "4",
                              "--shard-model", "2"])
    one = serve.main(argv + ["--continuous", "--page-size", "4"])
    assert [r.tokens for r in cont] == [r.tokens for r in one]


def test_spawn_reports_a_failing_rank():
    from repro_torch.launch.mesh import spawn
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(_fail_on_rank_1, 2, timeout_s=120)


def _fail_on_rank_1(rank):
    if rank == 1:
        raise ValueError("planted")
    return rank


def test_engine_refuses_a_ring_regime_without_a_mesh():
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.serving import ServingEngine
    cfg = get_config("qwen3-8b", smoke=True)
    model = LM(cfg, Runtime(dist_decode_attn=True), device="cpu")
    params = model.init_params(0)
    with pytest.raises(ValueError, match="needs a mesh"):
        ServingEngine(model, params, choose_regime=False)
    assert ServingEngine(LM(cfg, device="cpu"), params,
                         choose_regime=False).regime == "paged-spatial"
