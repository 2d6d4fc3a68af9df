"""The port's MCFuser tuner against the JAX package's.

With the TPU descriptor ``V5E`` passed in, the port's search must pick
the same schedules with bit-identical estimates as the reference (the
tuner code is a copy; only the descriptor differs).  Under the H100
descriptor every winner must pass the shared-memory Rule 4 with the
CUDA kernel's own footprint formula.
"""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

from repro_torch.core import api  # noqa: E402
from repro_torch.core import schedule_cache  # noqa: E402
from repro_torch.core.batch_model import (ExprClassTable,  # noqa: E402
                                          as_tile_matrix)
from repro_torch.core.chain import (attention_chain, gemm_chain,  # noqa: E402
                                    gemm_chain3, mlp_chain)
from repro_torch.core.dag import build_schedule  # noqa: E402
from repro_torch.core.perf_model import (H100, V5E, alpha,  # noqa: E402
                                         attention_smem_bytes, estimate,
                                         kernel_split_terms,
                                         mlp_partial_bytes, rule4_bytes,
                                         t_mem)
from repro_torch.core.pruning import iter_tile_assignments  # noqa: E402
from repro_torch.core.search import heuristic_search  # noqa: E402
from repro_torch.core.tiling import enumerate_tilings  # noqa: E402
from repro_torch.kernels.attention import clamp_tiles  # noqa: E402

# (family, dims, kwargs): the chains of tests/test_search_and_model.py
# and tests/test_batch_model.py
CHAINS = [
    ("gemm", (1024, 1024, 256, 256), {}),
    ("gemm", (512, 512, 128, 128), {}),
    ("gemm", (2048, 2048, 16, 16), {"dtype": "bfloat16"}),
    ("gemm", (1024, 1024, 64, 64), {"dtype": "bfloat16"}),
    ("gemm", (1024, 1024, 128, 128), {"batch": 4, "dtype": "bfloat16"}),
    ("attn", (2048, 2048, 128, 128), {}),
    ("attn", (512, 512, 64, 64), {"heads": 8, "dtype": "bfloat16"}),
    ("attn", (1, 160, 128, 128), {"heads": 32, "batch": 4,
                                  "dtype": "bfloat16"}),
]


def _chains(mod):
    return [(mod.gemm_chain if fam == "gemm" else mod.attention_chain)(
        *dims, **kw) for fam, dims, kw in CHAINS]


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    api.clear_cache()
    yield tmp_path
    api.clear_cache()


@pytest.mark.parametrize("idx", range(len(CHAINS)))
def test_search_matches_reference_under_v5e(idx):
    pytest.importorskip("jax")
    from repro.core import chain as ref_chain
    from repro.core import search as ref_search
    from repro_torch.core import chain as port_chain
    ref = ref_search.heuristic_search(_chains(ref_chain)[idx], seed=0)
    got = heuristic_search(_chains(port_chain)[idx], hw=V5E, seed=0)
    assert got.best.key() == ref.best.key()
    assert got.best.tile_sizes == ref.best.tile_sizes
    assert got.best_time == ref.best_time               # bit-equal
    assert got.history == ref.history
    assert got.prune_stats == ref.prune_stats


def test_estimates_bitwise_equal_to_reference_under_v5e():
    pytest.importorskip("jax")
    from repro.core import chain as RC, dag as RD, perf_model as RP
    from repro.core.tiling import enumerate_tilings as ref_enum
    for port_c, ref_c in [(gemm_chain(256, 256, 128, 128, dtype="bfloat16"),
                           RC.gemm_chain(256, 256, 128, 128,
                                         dtype="bfloat16")),
                          (attention_chain(384, 384, 64, 64, heads=2),
                           RC.attention_chain(384, 384, 64, 64, heads=2))]:
        exprs, rexprs = enumerate_tilings(port_c), ref_enum(ref_c)
        assert [repr(e) for e in exprs] == [repr(e) for e in rexprs]
        for e, re_ in zip(exprs, rexprs):
            for ts in iter_tile_assignments(port_c, rule3=True):
                s = build_schedule(port_c, e, ts, hard_rule2=False)
                r = RD.build_schedule(ref_c, re_, ts, hard_rule2=False)
                assert estimate(s, V5E) == RP.estimate(r, RP.V5E)
                assert rule4_bytes(s, V5E) == RP.vmem_estimate(r, RP.V5E)


def test_fuse_attention_paged_matches_reference_under_v5e(port_cache):
    pytest.importorskip("jax")
    from repro.core import api as ref_api
    kw = dict(page_size=16, heads=4, batch=2, dtype="float32")
    ref = ref_api.fuse_attention_paged(1, 128, 64, 64, **kw)
    got = api.fuse_attention_paged(1, 128, 64, 64, hw=V5E, kv_heads=4,
                                   **kw)
    assert got.report.best.key() == ref.report.best.key()
    assert got.params.as_kwargs() == ref.params.as_kwargs()
    assert got.report.best_time == ref.report.best_time


@pytest.mark.parametrize("idx", range(len(CHAINS)))
def test_h100_winners_pass_shared_memory_rule4(idx):
    from repro_torch.core import chain as port_chain
    chain = _chains(port_chain)[idx]
    r = heuristic_search(chain, hw=H100, seed=0)
    assert rule4_bytes(r.best, H100) <= H100.smem_per_block
    if "Q" in chain.tensors:   # the CUDA kernel's own footprint
        ts = r.best.tile_sizes
        bq, bkv = clamp_tiles(chain.loops["m"], chain.loops["n"],
                              ts["m"], ts["n"])
        assert (bq, bkv) == (ts["m"], ts["n"])
        assert rule4_bytes(r.best, H100) == attention_smem_bytes(
            bq, bkv, chain.loops["k"], chain.loops["h"],
            chain.tensors["Q"].dtype_bytes)


def test_h100_batched_model_matches_scalar():
    """The batched pricing (search's hot path) equals the scalar model
    under the H100 descriptor too — estimates bit-equal, Rule-4 bytes
    equal — and both search engines pick the same schedule."""
    for chain in (attention_chain(1, 160, 128, 128, heads=8, batch=2,
                                  dtype="bfloat16"),
                  gemm_chain(256, 256, 64, 64, dtype="bfloat16"),
                  mlp_chain(4, 384, 64, dtype="bfloat16", gated=False,
                            act="gelu")):
        rows = list(iter_tile_assignments(chain, unit=H100.tile_unit,
                                          rule3=True))
        tiles = as_tile_matrix(chain, rows)
        for expr in enumerate_tilings(chain)[:6]:
            p = ExprClassTable.build(chain, expr, unit=16).price(tiles, H100)
            for i, ts in enumerate(rows):
                s = build_schedule(chain, expr, ts, hard_rule2=False)
                assert estimate(s, H100) == p.est[i]
                assert rule4_bytes(s, H100) == p.vmem[i]
        rb = heuristic_search(chain, hw=H100, seed=0, engine="batch")
        rs = heuristic_search(chain, hw=H100, seed=0, engine="scalar")
        assert rb.best.key() == rs.best.key()
        assert rb.best_time == rs.best_time


def test_h100_descriptor_terms():
    """alpha takes the paper's SM-occupancy form and the tile unit is
    the tensor-core granularity."""
    chain = attention_chain(1, 160, 128, 128, heads=32, batch=4)
    s = build_schedule(chain, enumerate_tilings(chain)[0],
                       {"m": 1, "n": 32, "k": 128, "h": 128})
    g = s.grid_size()
    assert alpha(s, H100) == (g + H100.n_sm) / g
    assert alpha(s, V5E) == (g + V5E.pipeline_stages) / g
    assert H100.tile_unit == 16 and V5E.tile_unit == 128
    assert H100.smem_per_block == 232_448


@pytest.mark.parametrize("m,batch", [(4, 1), (1, 1), (1, 4)])
def test_h100_mlp_decode_pick_fills_the_sms(port_cache, m, batch):
    """At decode the MLP kernel's grid, with the n splits the wrapper
    launches, puts a block on at least 99 of the 132 SMs."""
    tk = api.fuse_mlp_chain(m, 12288, 4096, batch=batch, dtype="bfloat16")
    s = tk.report.best
    splits, _ = kernel_split_terms(s.chain, s.tile_sizes,
                                   "(" in s.sub_expr(), H100)
    assert min(s.grid_size() * splits, H100.n_sm) >= 99


def test_h100_mlp_split_enters_eqs_2_and_5():
    """Under H100 eq (5') counts the MLP kernel's n splits and eq (2')'s
    memory term its partial E; under V5E neither moves."""
    chain = mlp_chain(4, 12288, 4096, dtype="bfloat16")
    expr = next(e for e in enumerate_tilings(chain)
                if "(" in build_schedule(chain, e, {"m": 4, "n": 96,
                                                    "k": 32, "h": 4096}
                                         ).sub_expr())
    s = build_schedule(chain, expr, {"m": 4, "n": 96, "k": 32, "h": 4096})
    splits, extra = kernel_split_terms(s.chain, s.tile_sizes, True, H100)
    assert splits == 128 and extra == mlp_partial_bytes(1, 4, 4096, 128)
    g = s.grid_size() * splits
    assert alpha(s, H100) == (g + H100.n_sm) / g
    base = t_mem(s, V5E) * V5E.hbm_bw
    assert t_mem(s, H100) * H100.hbm_bw == pytest.approx(base + extra)
    assert kernel_split_terms(s.chain, s.tile_sizes, True, V5E) == (1, 0)
    assert alpha(s, V5E) == (s.grid_size() + 2) / s.grid_size()


def test_h100_chain_tie_break_orders_only_ties():
    """Under H100 eq (2') breaks the bf16 GEMM chains' ties by ring
    steps (``chain_tie_break``): the two-GEMM chain's narrow n tiles,
    which the memory and operation terms price alike, now order by the
    steps they run, by far less than any cost the model tells apart; so
    do the three-GEMM chain's; the MLP, f32, the attention chain and
    every chain under V5E add nothing."""
    from repro_torch.core.perf_model import (CHAIN_TIE_S, chain_tie_break,
                                             t_comp)
    chain = gemm_chain(1024, 1024, 128, 128, batch=8, dtype="bfloat16")
    expr = next(e for e in enumerate_tilings(chain)
                if "(" in build_schedule(chain, e, {"m": 128, "n": 64,
                                                    "k": 128, "h": 128}
                                         ).sub_expr())
    est, base = {}, {}
    for bn in (16, 64):
        s = build_schedule(chain, expr, {"m": 128, "n": bn, "k": 128,
                                         "h": 128})
        tie = chain_tie_break(chain, s.tile_sizes, True, H100)
        assert tie > 0
        assert tie / CHAIN_TIE_S == pytest.approx(round(tie / CHAIN_TIE_S))
        base[bn] = (t_mem(s, H100) + t_comp(s, H100)) * alpha(s, H100)
        assert estimate(s, H100) == base[bn] + tie
        est[bn] = estimate(s, H100)
        assert tie < 1e-6 * base[bn]
        assert chain_tie_break(chain, s.tile_sizes, True, V5E) == 0
    assert base[16] == base[64] and est[16] > est[64]
    ts3 = {"m": 32, "n": 32, "k": 64, "h": 64, "g": 64}
    wide = {**ts3, "n": 128}
    chain3 = gemm_chain3(1024, 512, 64, 64, 64, dtype="bfloat16")
    assert chain_tie_break(chain3, ts3, True, H100) > \
        chain_tie_break(chain3, wide, True, H100) > 0
    for other in (gemm_chain(1024, 1024, 128, 128, dtype="float32"),
                  gemm_chain3(1024, 512, 64, 64, 64, dtype="float32"),
                  mlp_chain(4, 384, 64, dtype="bfloat16"),
                  attention_chain(1, 160, 128, 128, heads=8,
                                  dtype="bfloat16")):
        ts = {d: 16 for d in other.loops}
        assert chain_tie_break(other, ts, True, H100) == 0


def test_schedule_cache_is_the_ports_own(port_cache, monkeypatch, tmp_path):
    other = tmp_path / "jax-cache"
    monkeypatch.setenv("REPRO_CACHE_DIR", str(other))
    kw = dict(page_size=16, heads=2, kv_heads=2, batch=1)
    tk = api.fuse_attention_paged(1, 4096, 128, 128, **kw)
    assert tk.source == "search"
    assert schedule_cache.host_fingerprint()
    (entry,) = port_cache.glob("*.json")
    assert not other.exists()
    api._CACHE.clear()
    warm = api.fuse_attention_paged(1, 4096, 128, 128, **kw)
    assert warm.source == "disk" and warm.params == tk.params
    assert warm.report.best_time == tk.report.best_time
    # a record edited to a tile over the shared-memory bound is
    # quarantined and retuned, never handed to the kernel
    rec = json.loads(entry.read_text())
    rec["tile_sizes"]["n"] = rec["params"]["bkv"] = 4096
    assert attention_smem_bytes(1, 4096, 128, 128, 4) > H100.smem_per_block
    entry.write_text(json.dumps(rec))
    api._CACHE.clear()
    again = api.fuse_attention_paged(1, 4096, 128, 128, **kw)
    assert again.source == "search" and again.params == tk.params
    assert list(port_cache.glob("*.json.corrupt"))


# ---------------------------------------------------------------------------
# the tuner's reporting functions: roofline_bound, fits_vmem,
# expression_classes, the batch model's per-term views, clear
# ---------------------------------------------------------------------------

ROOFLINE_CHAINS = [(512, 32), (1024, 256)]   # tests/test_search_and_model


@pytest.mark.parametrize("m,k", ROOFLINE_CHAINS)
def test_roofline_bound_and_fits_vmem_match_reference_under_v5e(m, k):
    """Under ``V5E`` the bound and Rule 4's budget equal the
    reference's on its candidates, and on every tile assignment of a
    small chain (the ones past the budget included)."""
    pytest.importorskip("jax")
    from repro.core import chain as RC
    from repro.core import dag as RD
    from repro.core import perf_model as RP
    from repro.core import pruning as RPr
    from repro.core.tiling import enumerate_tilings as ref_tilings
    from repro_torch.core.perf_model import fits_vmem, roofline_bound
    from repro_torch.core.pruning import generate_candidates
    ours = generate_candidates(gemm_chain(m, m, k, k), V5E)[:50]
    theirs = RPr.generate_candidates(RC.gemm_chain(m, m, k, k))[:50]
    assert [s.key() for s in ours] == [s.key() for s in theirs]
    for a, b in zip(ours, theirs):
        assert roofline_bound(a, V5E) == RP.roofline_bound(b, RP.V5E)
        assert fits_vmem(a, V5E) and RP.fits_vmem(b, RP.V5E)
    chain, rchain = (gemm_chain(8192, 8192, 8192, 8192),
                     RC.gemm_chain(8192, 8192, 8192, 8192))
    expr, rexpr = enumerate_tilings(chain)[0], ref_tilings(rchain)[0]
    fits = []
    for t in (128, 1024, 8192):      # in budget, and past it
        ts = dict.fromkeys("mnkh", t)
        fits.append(fits_vmem(build_schedule(chain, expr, ts), V5E))
        assert fits[-1] == RP.fits_vmem(RD.build_schedule(rchain, rexpr, ts),
                                        RP.V5E)
    assert fits[0] and not fits[-1]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_roofline_bound_takes_the_peak_of_the_chains_type(dtype):
    """Under ``H100`` a 16-bit chain is bounded at the tensor cores'
    peak, an f32 one at the CUDA cores' (the kernels allow no TF32)."""
    from repro_torch.core.perf_model import chain_peak_flops, roofline_bound
    chain = gemm_chain(1024, 1024, 256, 256, dtype=dtype)
    peak = H100.peak_flops if dtype == "bfloat16" else H100.peak_flops_f32
    assert chain_peak_flops(chain, H100) == peak
    assert chain_peak_flops(chain, V5E) == V5E.peak_flops
    sched = heuristic_search(chain, hw=H100, seed=0).best
    assert roofline_bound(sched, H100) == max(
        chain.fused_io_bytes() / H100.hbm_bw, chain.total_flops() / peak)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k", [(512, 32), (512, 256), (1024, 64)])
def test_estimate_above_roofline_bound_under_h100(m, k, dtype):
    """The port's form of tests/test_search_and_model.py's bound: every
    candidate the H100 tuner keeps is estimated at or above the
    roofline, an f32 chain's products priced at the CUDA cores' peak as
    its bound is."""
    from repro_torch.core.perf_model import roofline_bound
    from repro_torch.core.pruning import generate_candidates
    cands = generate_candidates(gemm_chain(m, m, k, k, dtype=dtype), H100)
    assert cands
    for c in cands:
        assert estimate(c, H100) >= roofline_bound(c, H100) * 0.99


@pytest.mark.parametrize("hard_rule2", [False, True])
def test_expression_classes_match_reference_under_v5e(hard_rule2):
    """tests/test_core_tiling.py's chains: the same Rule-1 classes, each
    first met at the same expression."""
    pytest.importorskip("jax")
    from repro.core import chain as RC
    from repro.core.pruning import expression_classes as ref_classes
    from repro.core.tiling import expr_repr as ref_repr
    from repro_torch.core.pruning import expression_classes
    from repro_torch.core.tiling import expr_repr
    for ours, theirs in ((gemm_chain(1024, 1024, 512, 512),
                          RC.gemm_chain(1024, 1024, 512, 512)),
                         (attention_chain(512, 512, 64, 64),
                          RC.attention_chain(512, 512, 64, 64))):
        got = expression_classes(ours, hard_rule2=hard_rule2, hw=V5E)
        want = ref_classes(theirs, hard_rule2=hard_rule2)
        assert {k: expr_repr(v) for k, v in got.items()} == {
            k: ref_repr(v) for k, v in want.items()}
    assert set(expression_classes(gemm_chain(1024, 1024, 512, 512),
                                  hw=V5E)) == {"nk", "kn", "n(k,h)"}
    # under H100 the reference tiles are the tensor core's 16: the
    # same three classes of the GEMM chain
    assert set(expression_classes(gemm_chain(1024, 1024, 512, 512))) == {
        "nk", "kn", "n(k,h)"}


def _ref_mesh(mesh):
    from repro.core.perf_model import MeshSpec as RefMeshSpec
    return RefMeshSpec(axes=mesh.axes, placement=mesh.placement,
                       batch_axes=mesh.batch_axes, pipelined=mesh.pipelined)


def test_batch_functions_match_reference_under_v5e():
    """tests/test_batch_model.py's chains, every expression class and
    tile assignment: each per-term view and the module functions equal
    the reference's bit for bit, under a mesh too."""
    pytest.importorskip("jax")
    import numpy as np
    from repro.core import batch_model as RB
    from repro.core import chain as RC
    from repro.core.tiling import enumerate_tilings as ref_tilings
    from repro_torch.core import batch_model as B
    from repro_torch.core.perf_model import MeshSpec
    serial = MeshSpec(axes=(("data", 2), ("model", 4)),
                      placement=(("n", "model"),), batch_axes=("data",))
    # the reference's batch function prices every mesh serially: the
    # pipelined ring is held to the port's scalar estimate alone
    piped = dataclasses.replace(serial, pipelined=True)
    for ours, theirs in ((gemm_chain(256, 256, 128, 128, dtype="bfloat16"),
                          RC.gemm_chain(256, 256, 128, 128,
                                        dtype="bfloat16")),
                         (attention_chain(384, 384, 64, 64, heads=2),
                          RC.attention_chain(384, 384, 64, 64, heads=2))):
        rows = list(iter_tile_assignments(ours, rule3=False))
        tiles = as_tile_matrix(ours, rows)
        for expr, rexpr in zip(enumerate_tilings(ours),
                               ref_tilings(theirs)):
            t, r = (ExprClassTable.build(ours, expr),
                    RB.ExprClassTable.build(theirs, rexpr))
            for name in ("t_mem_batch", "t_comp_batch", "alpha_batch",
                         "vmem_batch"):
                assert np.array_equal(getattr(t, name)(tiles, V5E),
                                      getattr(r, name)(tiles)), name
            assert np.array_equal(t.rule2_valid(tiles),
                                  r.rule2_valid(tiles))
            for mesh in (None, serial):
                rmesh = None if mesh is None else _ref_mesh(mesh)
                assert np.array_equal(
                    B.estimate_batch(ours, expr, rows, V5E, mesh),
                    RB.estimate_batch(theirs, rexpr, rows, mesh=rmesh))
            for mesh in (None, serial, piped):
                for i in (0, len(rows) // 2, len(rows) - 1):
                    assert B.estimate_batch(ours, expr, rows[i:i + 1],
                                            V5E, mesh)[0] == estimate(
                        build_schedule(ours, expr, rows[i]), V5E, mesh)
            assert np.array_equal(
                B.vmem_estimate_batch(ours, expr, tiles, V5E),
                RB.vmem_estimate_batch(theirs, rexpr, tiles))


def test_schedule_cache_clear_returns_its_count(port_cache):
    """``clear`` removes the entries, plan records and denylist records
    (their lock and quarantine companions too) and returns their count;
    another tool's files stay.  ``api.clear_cache(disk=True)`` clears
    the directory as well as the memo."""
    from repro_torch.core import planner
    from repro_torch.configs import get_config
    api.fuse_gemm_chain(M=256, N=128, K=64, H=64, dtype="bfloat16")
    planner.clear_memo()
    planner.plan_model(get_config("qwen3-8b", smoke=True), 1, 8)
    planner.clear_memo()
    assert schedule_cache.quarantine(("probe",), H100, reason="test")
    ours = sorted(p.name for p in port_cache.glob("*.json"))
    assert len(ours) >= 3 and any(n.startswith("deny-") for n in ours)
    (port_cache / ours[0]).with_suffix(".json.lock").write_text("")
    foreign = port_cache / "other-tool.json"
    foreign.write_text("{}")
    assert schedule_cache.clear() == len(ours)
    assert sorted(p.name for p in port_cache.iterdir()) == [foreign.name]
    assert schedule_cache.clear() == 0
    api.clear_cache()
    api.fuse_gemm_chain(M=256, N=128, K=64, H=64, dtype="bfloat16")
    api.clear_cache()
    assert api.fuse_gemm_chain(M=256, N=128, K=64, H=64,
                               dtype="bfloat16").source == "disk"
    api.clear_cache(disk=True)
    assert sorted(p.name for p in port_cache.iterdir()) == [foreign.name]
    assert api.fuse_gemm_chain(M=256, N=128, K=64, H=64,
                               dtype="bfloat16").source == "search"


# ---------------------------------------------------------------------------
# measured trials (Algorithm 1's wall-clocked top-n): ``measure_fn``
# ---------------------------------------------------------------------------

def _forbid_search(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("heuristic_search ran on a warm entry")
    monkeypatch.setattr(api, "heuristic_search", boom)


@pytest.mark.parametrize("hw", [H100, V5E], ids=["h100", "v5e"])
def test_measured_and_analytic_entries_never_collide(port_cache,
                                                     monkeypatch, hw):
    """The twin of tests/test_schedule_cache.py's test: a ``measure_fn``
    outcome persists under the "measured" trial kind, so an analytic
    record never satisfies a measured lookup or the other way round, in
    the process's memo or on disk, and each population round-trips
    within its own kind."""
    key = ("gemm", 512, 512, 128, 128, 1, "bfloat16", hw.name, hw.tile_unit,
           None, 0)
    assert schedule_cache.entry_path(key, hw, "analytic") \
        != schedule_cache.entry_path(key, hw, "measured")
    with pytest.raises(ValueError):
        schedule_cache.entry_path(key, hw, "wallclock")
    calls = []

    def measure(s):
        calls.append(s.key())
        return estimate(s, hw)

    kw = dict(dtype="bfloat16", hw=hw)
    analytic = api.fuse_gemm_chain(512, 512, 128, 128, **kw)
    assert len(list(port_cache.glob("*.json"))) == 1 and not calls
    # neither the memo nor the disk entry answers a measured call
    measured = api.fuse_gemm_chain(512, 512, 128, 128, measure_fn=measure,
                                   **kw)
    assert measured.source == "search" and measured is not analytic
    assert len(calls) == measured.report.n_measured > 0
    assert len(list(port_cache.glob("*.json"))) == 2
    api.clear_cache()
    _forbid_search(monkeypatch)
    warm = api.fuse_gemm_chain(512, 512, 128, 128, **kw)
    assert warm.source == "disk" and warm.params == analytic.params
    api.clear_cache()
    warm_measured = api.fuse_gemm_chain(512, 512, 128, 128,
                                        measure_fn=measure, **kw)
    assert warm_measured.source == "disk"
    assert warm_measured.params == measured.params
    assert warm_measured.report.n_measured == measured.report.n_measured
    for trial in schedule_cache.TRIAL_KINDS:
        assert schedule_cache.load(key, hw, trial) is not None
        assert json.loads(schedule_cache.entry_path(
            key, hw, trial).read_text())["trial"] == trial


@pytest.mark.parametrize("family", ["gemm", "mlp", "attn"])
def test_measured_trials_match_reference_under_v5e(port_cache, monkeypatch,
                                                   tmp_path, family):
    """Under ``V5E`` with the model itself as the wall clock, the port's
    measured search picks what the JAX package's does, with as many
    measured candidates and iterations, through each front door that
    takes ``measure_fn``."""
    pytest.importorskip("jax")
    from repro.core import api as ref_api
    from repro.core import perf_model as RP
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    ref_api.clear_cache()
    call = {"gemm": lambda m, **k: m.fuse_gemm_chain(
                512, 512, 128, 128, dtype="bfloat16", **k),
            "mlp": lambda m, **k: m.fuse_mlp_chain(
                256, 1024, 512, dtype="bfloat16", **k),
            "attn": lambda m, **k: m.fuse_attention(
                512, 512, 64, 64, heads=4, dtype="bfloat16", causal=True,
                **k)}[family]
    ref = call(ref_api, measure_fn=lambda s: RP.estimate(s, RP.V5E))
    got = call(api, hw=V5E, measure_fn=lambda s: estimate(s, V5E))
    assert got.report.best.key() == ref.report.best.key()
    assert got.params.as_kwargs() == ref.params.as_kwargs()
    assert got.report.n_measured == ref.report.n_measured
    assert got.report.n_iterations == ref.report.n_iterations
    assert got.report.best_time == ref.report.best_time
    (entry,) = port_cache.glob("*.json")
    assert json.loads(entry.read_text())["trial"] == "measured"
    ref_api.clear_cache()
