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
from repro_torch.core.chain import attention_chain, gemm_chain  # noqa: E402
from repro_torch.core.dag import build_schedule  # noqa: E402
from repro_torch.core.perf_model import (H100, V5E, alpha,  # noqa: E402
                                         attention_smem_bytes, estimate,
                                         rule4_bytes)
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
    got = api.fuse_attention_paged(1, 128, 64, 64, hw=V5E, **kw)
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
                  gemm_chain(256, 256, 64, 64, dtype="bfloat16")):
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


def test_schedule_cache_is_the_ports_own(port_cache, monkeypatch, tmp_path):
    other = tmp_path / "jax-cache"
    monkeypatch.setenv("REPRO_CACHE_DIR", str(other))
    kw = dict(page_size=16, heads=2, batch=1)
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
