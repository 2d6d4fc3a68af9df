"""The port's MCFuser tuner against the JAX package's.

With the TPU descriptor ``V5E`` passed in, the port's search must pick
the same schedules with bit-identical estimates as the reference (the
tuner code is a copy; only the descriptor differs).  Under the H100
descriptor every winner must pass the shared-memory Rule 4 with the
CUDA kernel's own footprint formula.
"""
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
