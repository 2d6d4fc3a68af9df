"""The port's fusion planner and its Rule-4 pricing.

Under the TPU descriptor ``V5E`` the port's planner must reproduce the
JAX package's golden decisions (``tests/golden_plans.json``) decision for
decision.  Under the H100 descriptor the qwen3-8b serving plans are
pinned literally, plan records persist on disk (a mangled one is
quarantined), and every MLP tile the tuner returns at the main path's
shapes fits the CUDA kernel's shared memory.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import api, planner, schedule_cache  # noqa: E402
from repro_torch.core.batch_model import (ExprClassTable,  # noqa: E402
                                          as_tile_matrix)
from repro_torch.core.chain import mlp_chain  # noqa: E402
from repro_torch.core.dag import build_schedule  # noqa: E402
from repro_torch.core.perf_model import (H100, V5E, estimate,  # noqa: E402
                                         mlp_smem_bytes, mlp_splits,
                                         rule4_bytes)
from repro_torch.core.pruning import (iter_tile_assignments,  # noqa: E402
                                      stitched_vmem_ok)
from repro_torch.core.search import heuristic_search  # noqa: E402
from repro_torch.core.tiling import enumerate_tilings  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "golden_plans.json").read_text())
FULL = get_config("qwen3-8b")


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    planner.clear_memo()
    api.clear_cache()
    yield tmp_path
    planner.clear_memo()
    api.clear_cache()


# ---------------------------------------------------------------------------
# V5E: the JAX package's golden decisions
# ---------------------------------------------------------------------------

def test_v5e_forward_plan_matches_golden():
    plan = planner.plan_model(get_config("qwen3_8b"), GOLDEN["batch"],
                              GOLDEN["seq"], hw=V5E, use_cache=False)
    assert planner.plan_to_json(plan) == GOLDEN["plans"]["qwen3_8b"]


@pytest.mark.parametrize("idx", range(len(GOLDEN["phase_plans"])))
def test_v5e_phase_plans_match_golden(idx):
    entry = GOLDEN["phase_plans"][idx]
    cfg = get_config(entry["arch"], smoke=entry["smoke"])
    plan = planner.plan_model(
        cfg, entry["batch"], entry["seq"], stitch=entry["stitch"], hw=V5E,
        phase=entry["phase"], paged=entry["paged"], kv_len=entry["kv_len"],
        use_cache=False)
    assert planner.plan_to_json(plan) == entry["plan"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("stitch", [False, True])
def test_v5e_plans_match_the_reference_planner(smoke, phase, stitch):
    """Beyond the fixture: stitch off too, at the serving shapes."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.core import planner as ref_planner
    seq = 1 if phase == "decode" else 48
    kw = dict(stitch=stitch, phase=phase, paged=16, kv_len=160,
              use_cache=False)
    got = planner.plan_model(get_config("qwen3_8b", smoke=smoke), 4, seq,
                             hw=V5E, **kw)
    want = ref_planner.plan_model(ref_config("qwen3_8b", smoke=smoke), 4,
                                  seq, **kw)
    assert planner.plan_to_json(got) == ref_planner.plan_to_json(want)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("full_loops", [(), ("k",)])
def test_stitch_gate_matches_reference_under_v5e(gated, full_loops):
    pytest.importorskip("jax")
    from repro.core import chain as RC
    from repro.core import pruning as RP
    for m, ff, d in ((1, 12288, 4096), (512, 128, 64)):
        for extra in (0, 4096, 10 ** 8):
            got = stitched_vmem_ok(mlp_chain(m, ff, d, gated=gated), extra,
                                   V5E, unit=128, full_loops=full_loops)
            want = RP.stitched_vmem_ok(RC.mlp_chain(m, ff, d, gated=gated),
                                       extra, unit=128,
                                       full_loops=full_loops)
            assert got == want


def test_fuse_mlp_chain_matches_reference_under_v5e(tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from repro.core import api as ref_api
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "ref"))
    kw = dict(batch=1, dtype="float32", gated=True, act="silu")
    ref = ref_api.fuse_mlp_chain(64, 256, 128, **kw)
    got = api.fuse_mlp_chain(64, 256, 128, hw=V5E, **kw)
    assert got.params.as_kwargs() == ref.params.as_kwargs()
    assert got.report.best_time == ref.report.best_time


# ---------------------------------------------------------------------------
# H100: the serving plans of the main path, pinned
# ---------------------------------------------------------------------------

def _summary(plan):
    return ([(c.kind, c.ops, c.fused, c.prologue, c.epilogue)
             for c in plan.layer.chains],
            plan.layer.glue, plan.layer.dropped)


_MLP = ("w_gate", "w_up", "act_gate", "w_down")
_ATTN = ("qk", "softmax", "pv")
# stitch on, H100: qk_norm+rope ride the q/k projections, the residuals
# ride wo and the MLP, and ln2 is DROPPED as the MLP's prologue — the
# norm reduces over k, so the stitch forces k whole, and the kernel's
# shared memory at k = 4096 (the A row and the two weight columns)
# exceeds a block's 232,448 B
PINNED_STITCHED = (
    [("gemm", ("wq",), False, (), ("qk_norm_q", "rope_q")),
     ("gemm", ("wk",), False, (), ("qk_norm_k", "rope_k")),
     ("gemm", ("wv",), False, (), ()),
     ("attention", _ATTN, True, (), ()),
     ("gemm", ("wo",), False, (), ("res1",)),
     ("mlp", _MLP, True, (), ("res2",))],
    ("ln1", "kv_write", "ln2"), ("ln2",))
PINNED_UNSTITCHED = (
    [("gemm", ("wq",), False, (), ()), ("gemm", ("wk",), False, (), ()),
     ("gemm", ("wv",), False, (), ()), ("attention", _ATTN, True, (), ()),
     ("gemm", ("wo",), False, (), ()), ("mlp", _MLP, True, (), ())],
    ("ln1", "qk_norm_q", "qk_norm_k", "rope_q", "rope_k", "kv_write",
     "res1", "ln2", "res2"), ())


@pytest.mark.parametrize("phase,batch,seq,mlp_ai", [
    ("decode", 4, 1, 0.999783033195921),
    ("prefill", 1, 144, 139.63636363636363)])
@pytest.mark.parametrize("stitch", [True, False])
def test_h100_serving_plans_pinned(phase, batch, seq, mlp_ai, stitch):
    plan = planner.plan_model(FULL, batch, seq, stitch=stitch,
                              phase=phase, paged=16, kv_len=160)
    assert _summary(plan) == (PINNED_STITCHED if stitch
                              else PINNED_UNSTITCHED)
    mlp = next(c for c in plan.layer.chains if c.kind == "mlp")
    # fused because it is memory-bound on an H100: below the ridge 295
    assert mlp.ai == mlp_ai < planner.ridge_intensity(H100)
    assert planner.ridge_intensity(H100) == pytest.approx(295.22, abs=0.01)


def test_h100_ln2_stitch_floor_exceeds_shared_memory():
    ch = mlp_chain(1, 12288, 4096, dtype="bfloat16")
    floor = mlp_smem_bytes(1, 16, 4096, 16, 2, 2, True)
    assert floor > H100.smem_per_block
    assert not stitched_vmem_ok(ch, 4096 * 4, H100, unit=16,
                                full_loops=("k",))
    assert stitched_vmem_ok(ch, 16 * 16 * 2, H100, unit=16)  # res2


def test_h100_price_plan_never_above_hand_wired():
    plan = planner.plan_model(FULL, 4, 1, phase="decode", paged=16,
                              kv_len=160)
    priced = planner.price_plan(plan, FULL)
    assert priced["planner_seconds"] <= priced["hand_seconds"]
    mlp = priced["chains"]["+".join(_MLP)]
    # the tuner's own model still prices the fused MLP's best schedule
    # above the unfused GEMMs at decode: both read the weights at the
    # byte bound, and eq (5') multiplies the fused kernel's by its
    # occupancy factor (N_block + 132) / N_block over its split blocks
    assert mlp["demoted"] and mlp["fused_seconds"] > mlp["unfused_seconds"]
    # cache-free plans price through api.fuse_attention the same way
    fwd = planner.price_plan(planner.plan_model(FULL, 1, 64), FULL)
    assert fwd["planner_seconds"] <= fwd["hand_seconds"]
    assert "fused_seconds" in fwd["chains"]["qk+softmax+pv"]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("stitch", [True, False])
def test_v5e_cache_free_price_plan_matches_the_reference(port_cache,
                                                         monkeypatch, smoke,
                                                         stitch):
    """A cache-free (forward) plan priced under V5E: every number of the
    port's ``price_plan`` equals the reference's."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.core import planner as ref_planner
    monkeypatch.setenv("REPRO_CACHE_DIR", str(port_cache / "reference"))
    rcfg = ref_config("qwen3_8b", smoke=smoke)
    cfg = get_config("qwen3_8b", smoke=smoke)
    want = ref_planner.price_plan(
        ref_planner.plan_model(rcfg, 2, 64, stitch=stitch, use_cache=False),
        rcfg)
    got = planner.price_plan(
        planner.plan_model(cfg, 2, 64, stitch=stitch, hw=V5E,
                           use_cache=False), cfg, hw=V5E)
    assert got == want


# ---------------------------------------------------------------------------
# plan records on disk
# ---------------------------------------------------------------------------

def test_plan_records_round_trip_and_quarantine(port_cache, monkeypatch):
    kw = dict(stitch=True, phase="decode", paged=16, kv_len=160)
    plan = planner.plan_model(FULL, 4, 1, **kw)
    key = planner.plan_key(FULL, 4, 1, True, H100, None, "decode", 16, 160)
    path = schedule_cache.plan_entry_path(key, H100)
    assert path.exists() and path.parent == port_cache
    assert schedule_cache.load_plan(key, H100) == planner.plan_to_json(plan)
    # a relaunch replays the record without carving
    planner.clear_memo()
    monkeypatch.setattr(planner, "_carve_and_stitch",
                        lambda *a, **k: pytest.fail("re-carved"))
    assert planner.plan_model(FULL, 4, 1, **kw) == plan
    monkeypatch.undo()
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(port_cache))
    # a record that parses but whose payload is mangled is quarantined
    # and the plan re-carved beside it
    rec = json.loads(path.read_text())
    del rec["plan"]["layer"]["chains"]
    path.write_text(json.dumps(rec))
    planner.clear_memo()
    assert planner.plan_model(FULL, 4, 1, **kw) == plan
    assert path.with_name(path.name + ".corrupt").exists()
    # unparseable bytes too
    path.write_text("{not json")
    assert schedule_cache.load_plan(key, H100) is None
    assert not path.exists()
    # plan records never collide with schedule records
    assert path != schedule_cache.entry_path(key, H100)


# ---------------------------------------------------------------------------
# Rule 4 follows the CUDA kernel's shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 16, 144, 160, 4096])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_h100_mlp_tiles_fit_the_kernel(m, dtype):
    """Rule 4 prices the tuner's pick by the kernel's own layout at the
    split the wrapper launches, and the wrapper takes the pick."""
    from repro_torch.kernels import gemm_chain as G
    from repro_torch.kernels.gemm_chain import clamp_tiles
    tk = api.fuse_mlp_chain(m, 12288, 4096, dtype=dtype)
    p = tk.params
    tiles = clamp_tiles(m, 12288, 4096, 4096, p.bm, p.bn, p.bk, p.bh,
                        p.style)
    nbytes = {"bfloat16": 2, "float32": 4}[dtype]
    _, per = mlp_splits(1, m, 12288, 4096, 4096, *tiles, nbytes, nbytes,
                        True)
    smem = mlp_smem_bytes(*tiles, nbytes, nbytes, True, per)
    assert smem == rule4_bytes(tk.report.best, H100)
    assert smem <= H100.smem_per_block
    # the wrapper's guard takes the pick (shapes only: meta tensors)
    import torch
    dt = getattr(torch, dtype)
    a = torch.empty(1, m, 4096, dtype=dt, device="meta")
    w = torch.empty(1, 4096, 12288, dtype=dt, device="meta")
    wd = torch.empty(1, 12288, 4096, dtype=dt, device="meta")
    assert G._check(a, w, wd, w, "silu", **p.as_kwargs()) == (
        tiles, mlp_splits(1, m, 12288, 4096, 4096, *tiles, nbytes, nbytes,
                          True))
    # bf16 weights under an f32 A (a stitched ln2) stage in fewer bytes
    if dtype == "float32":
        assert mlp_smem_bytes(*tiles, nbytes, 2, True) <= smem


def test_h100_flat_prefill_pick_is_gone():
    """The flat class used to keep the whole f32 E row on chip (262,144 B
    at bm=16, H=4096), so no flat pick could run at prefill.  The bf16
    kernel now walks H in E chunks held in registers: its shared memory
    does not grow with the E tile, and at M=144 the tuner picks the flat
    class, whose tiles the wrapper takes.  A flat tile whose ring stages
    alone exceed a block still raises, and the 16/880 tile of the old
    flat pick is outside the kernel's tile rule."""
    assert 16 * 4096 * 4 > H100.smem_per_block
    assert mlp_smem_bytes(16, 96, 32, 4096, 2, 2, True) == \
        mlp_smem_bytes(16, 96, 32, 128, 2, 2, True)
    assert mlp_smem_bytes(16, 96, 32, 4096, 4, 4, True) > \
        mlp_smem_bytes(16, 96, 32, 128, 4, 4, True)   # f32 keeps its E
    p = api.fuse_mlp_chain(144, 12288, 4096, dtype="bfloat16").params
    assert p.style == "flat"
    import torch
    from repro_torch.kernels import gemm_chain as G
    a = torch.zeros(1, 144, 4096, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(1, 4096, 12288, dtype=torch.bfloat16, device="meta")
    wd = torch.zeros(1, 12288, 4096, dtype=torch.bfloat16, device="meta")
    G._check(a, w, wd, w, "silu", **p.as_kwargs())
    with pytest.raises(ValueError, match="shared memory"):
        G._check(a, w, wd, w, "silu", bm=64, bn=256, bk=256, bh=16,
                 style="flat")
    with pytest.raises(ValueError, match="bf16 kernel"):
        G._check(a, w, wd, w, "silu", bm=16, bn=880, bk=32, bh=16,
                 style="flat")


def test_h100_batched_mlp_rule4_matches_scalar():
    chain = mlp_chain(20, 192, 64, dtype="bfloat16")
    rows = list(iter_tile_assignments(chain, unit=16, rule3=True))
    tiles = as_tile_matrix(chain, rows)
    for expr in enumerate_tilings(chain):
        p = ExprClassTable.build(chain, expr, unit=16).price(tiles, H100)
        for i, ts in enumerate(rows):
            s = build_schedule(chain, expr, ts, hard_rule2=False)
            assert estimate(s, H100) == p.est[i]
            assert rule4_bytes(s, H100) == p.vmem[i]
    rb = heuristic_search(chain, hw=H100, seed=0, engine="batch")
    rs = heuristic_search(chain, hw=H100, seed=0, engine="scalar")
    assert rb.best.key() == rs.best.key()
    assert rule4_bytes(rb.best, H100) <= H100.smem_per_block
    assert math.isfinite(rb.best_time) and np.all(p.vmem > 0)


@pytest.mark.parametrize("hw_name", ["H100", "V5E"])
def test_price_plan_prices_the_decode_mlp_where_the_executor_runs_it(
        hw_name):
    """The executor runs a decode block's MLP flattened to M = B*S at
    batch 1 (``layers.run_planned_layer``, ``ops.mlp_chain``), so under
    ``GpuSpec`` ``price_plan`` prices the fused MLP and its unfused
    alternative there: the shared weights are read once, not once a
    request.  Under ``V5E`` it keeps the reference's (S, batch=B)."""
    hw = {"H100": H100, "V5E": V5E}[hw_name]
    plan = planner.plan_model(FULL, 4, 1, phase="decode", paged=16,
                              kv_len=160, hw=hw, use_cache=False)
    mlp = planner.price_plan(plan, FULL, hw=hw)["chains"]["+".join(_MLP)]
    m, batch = (4, 1) if hw is H100 else (1, 4)
    tk = api.fuse_mlp_chain(m, FULL.d_ff, FULL.d_model, batch=batch,
                            dtype=FULL.dtype, gated=True, act="silu", hw=hw)
    assert mlp["fused_seconds"] == tk.report.best_time
    # the unfused GEMMs at the same shape: three weight reads at the
    # byte bound, once (H100) or once a request (V5E)
    weights = 3 * FULL.d_ff * FULL.d_model * 2
    assert mlp["unfused_seconds"] >= weights * batch / hw.hbm_bw
    assert mlp["unfused_seconds"] < weights * batch * 1.1 / hw.hbm_bw
