"""The port's ring (kv-sequence-sharded) attention pieces against the
JAX package's: the log-sum-exp combine, the regime search, and the
ring's gating.

The combine functions take the same numpy inputs in both packages.
Where no transcendental is evaluated — ``finalize_partials``, and
``combine_partials`` with every shard at the global max (each rescale
exactly 1) — the port's output is bitwise the reference's, which shows
the same single rescale and the same shard-index summation order.
Elsewhere torch's f32 ``exp`` and XLA's differ in the last bit for
about one input in ten, so the port is held within 1e-6; and the port
is bitwise invariant under arrival order itself, as the reference is
(``tests/test_ring_attention.py``).
"""
import itertools
import random
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core import api  # noqa: E402
from repro_torch.core.perf_model import H100, V5E, MeshSpec  # noqa: E402
from repro_torch.dist.ring_dispatch import (combine_partials,  # noqa: E402
                                            finalize_partials,
                                            merge_partials,
                                            plan_ring_attention)
from repro_torch.dist.sharding import Rules, ring_dispatch_spec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.attention import fused_attention_partial  # noqa: E402


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "ref"))
    api.clear_cache()
    yield tmp_path
    api.clear_cache()


def _qkv(b=1, hq=4, hkv=2, m=64, n=256, d=32, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.standard_normal(s).astype(np.float32))
                 for s in ((b, hq, m, d), (b, hkv, n, d), (b, hkv, n, d)))


def _parts(shards, *, causal, window, m=64, n=256, seed=0, row_start=None):
    """The port's partial kernel (its plain version on the CPU) per kv
    block at global positions: what each rank of the ring computes."""
    q, k, v = _qkv(m=m, n=n, seed=seed)
    nl = n // shards
    rows = (n - m if row_start is None else row_start) + torch.arange(
        m, dtype=torch.int32)
    out = []
    for i in range(shards):
        sl = slice(i * nl, (i + 1) * nl)
        out.append((i, fused_attention_partial(
            q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(),
            torch.arange(i * nl, (i + 1) * nl, dtype=torch.int32), rows,
            bq=32, bkv=32, causal=causal, window=window)))
    return q, k, v, out


def _np(parts):
    return [(i, tuple(t.numpy() for t in p)) for i, p in parts]


def _to_ref(parts):
    import jax.numpy as jnp
    return [(i, tuple(jnp.asarray(t) for t in p)) for i, p in parts]


def _to_port(parts):
    return [(i, tuple(torch.from_numpy(t) for t in p)) for i, p in parts]


# ---------------------------------------------------------------------------
# the combine against the reference
# ---------------------------------------------------------------------------

def test_finalize_partials_bitwise_reference():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dist import ring_dispatch as R
    rs = np.random.RandomState(0)
    o = rs.standard_normal((2, 4, 8, 16)).astype(np.float32)
    l = rs.rand(2, 4, 8, 1).astype(np.float32)
    o[0, 1, :3] = 0.0                          # fully masked rows
    l[0, 1, :3] = 0.0
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = finalize_partials(torch.from_numpy(o), torch.from_numpy(l), dt)
        want = np.asarray(R.finalize_partials(jnp.asarray(o), jnp.asarray(l),
                                              jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert float(got[0, 1, :3].abs().max()) == 0.0


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_combine_bitwise_reference_at_unit_rescale(shards):
    """Every shard at the global max: each rescale is exp(0) = 1, so the
    sum's association alone decides the bits — the port's shard-index
    order is the reference's."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dist import ring_dispatch as R
    rs = np.random.RandomState(shards)
    m = rs.standard_normal((1, 4, 32, 1)).astype(np.float32)
    parts = [(i, (rs.standard_normal((1, 4, 32, 16)).astype(np.float32),
                  m.copy(), rs.rand(1, 4, 32, 1).astype(np.float32) + 0.5))
             for i in range(shards)]
    random.Random(shards).shuffle(parts)
    got = combine_partials(_to_port(parts), torch.float32).numpy()
    want = np.asarray(R.combine_partials(_to_ref(parts), jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", [(False, 0), (True, 0), (True, 100)])
def test_combine_and_merge_match_reference(shards, mode):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dist import ring_dispatch as R
    causal, window = mode
    _, _, _, parts = _parts(shards, causal=causal, window=window)
    nparts = _np(parts)
    got = combine_partials(parts, torch.float32).numpy()
    want = np.asarray(R.combine_partials(_to_ref(nparts), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    acc_p, acc_r = parts[0][1], _to_ref(nparts)[0][1]
    for (_, p), (_, r) in zip(parts[1:], _to_ref(nparts)[1:]):
        acc_p, acc_r = merge_partials(acc_p, p), R.merge_partials(acc_r, r)
    for g, w in zip(acc_p, acc_r):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", [(False, 0), (True, 0), (True, 100),
                                  (True, 24)])
def test_combine_matches_the_attention_reference(shards, mode):
    """The ring's combine of the per-block partials is the reference's
    single-device attention (jax) on the same inputs, within f32."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ref import gqa_attention_ref as jref
    causal, window = mode
    q, k, v, parts = _parts(shards, causal=causal, window=window)
    got = combine_partials(parts, torch.float32).numpy()
    want = np.asarray(jref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           causal=causal, window=window))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(
        got, ref.gqa_attention_ref(q, k, v, causal=causal,
                                   window=window).numpy(),
        atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_combine_arrival_order_invariance_bitwise(shards):
    """Any rotation (what a ring delivers) and any permutation give the
    index-ordered fold's bits, causal and windowed."""
    for causal, window in ((False, 0), (True, 0), (True, 24)):
        _, _, _, parts = _parts(shards, causal=causal, window=window)
        base = combine_partials(parts, torch.float32)
        for rot in range(shards):
            assert torch.equal(combine_partials(parts[rot:] + parts[:rot],
                                                torch.float32), base)
        for seed in range(3):
            sh = list(parts)
            random.Random(seed).shuffle(sh)
            assert torch.equal(combine_partials(sh, torch.float32), base)


def test_fully_masked_shards_are_the_identity():
    """A block entirely above the query rows emits (0, -1e30, 0); adding
    such shards anywhere leaves the combine bit-identical."""
    _, _, _, live = _parts(4, causal=True, window=0, m=32, n=128,
                           row_start=0)
    base = combine_partials(live, torch.float32)
    q, k, v = _qkv(m=32, n=256)
    masked = []
    for j, sl in enumerate([slice(128, 192), slice(192, 256)]):
        kk, vv = k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
        o, m, l = fused_attention_partial(
            q, kk, vv,
            torch.arange(sl.start, sl.stop, dtype=torch.int32),
            torch.arange(32, dtype=torch.int32), bq=32, bkv=32, causal=True)
        assert float(o.abs().max()) == 0.0 and float(l.max()) == 0.0
        assert float(m.max()) < -1e29
        masked.append((4 + j, (o, m, l)))
        # the one-pass oracle the guard serves emits the same identity
        oo, mo, lo = ref.partial_attention_ref(
            q, kk, vv,
            torch.arange(sl.start, sl.stop, dtype=torch.int32),
            torch.arange(32, dtype=torch.int32))
        assert float(oo.abs().max()) == 0.0 and float(lo.max()) == 0.0
    for arrival in ([*live, *masked], [*masked, *live],
                    [live[0], masked[1], *live[1:], masked[0]]):
        assert torch.equal(combine_partials(arrival, torch.float32), base)


def test_merge_is_permutation_invariant_within_f32():
    _, _, _, parts = _parts(4, causal=True, window=0)
    parts = [p for _, p in parts]

    def fold(ps):
        acc = ps[0]
        for p in ps[1:]:
            acc = merge_partials(acc, p)
        return finalize_partials(acc[0], acc[2], torch.float32)

    base = fold(parts)
    for perm in itertools.permutations(range(4)):
        torch.testing.assert_close(fold([parts[i] for i in perm]), base,
                                   rtol=1e-6, atol=1e-6)


def test_partial_oracle_matches_the_plain_partial():
    q, k, v = _qkv(m=16, n=128)
    kv_pos = torch.arange(64, 192, dtype=torch.int32)
    q_pos = torch.arange(100, 116, dtype=torch.int32)
    for causal, window in ((True, 0), (True, 30), (False, 0)):
        got = ref.partial_attention_ref(q, k, v, kv_pos, q_pos, causal,
                                        window)
        want = fused_attention_partial(q, k, v, kv_pos, q_pos, bq=16,
                                       bkv=32, causal=causal, window=window)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_empty_raises():
    with pytest.raises(ValueError):
        combine_partials([], torch.float32)


# ---------------------------------------------------------------------------
# regime search
# ---------------------------------------------------------------------------

MESH8 = SimpleNamespace(shape={"model": 8})
RING_CASES = [(1, 4, 2, 128, 8192, 64), (1, 2, 2, 256, 4096, 64),
              (1, 2, 2, 64, 8192, 64), (1, 4, 2, 128, 512, 64)]
# the reference's acceptance picks on its 8-way mesh (test_ring_attention)
V5E_PICKS = ["ring-pipelined", "ring-pipelined", "ring", "spatial"]
# the H100 descriptor offers the ring at one query row only (at more
# rows its partial kernel runs on repeated kv heads, measured far over
# its price): spatial at these forward shapes; at one row over the same
# keys (NVLink at 450 GB/s a direction) the ring's combine is cheap
# beside an eighth of the tile work, so ring
H100_PICKS = ["spatial", "spatial", "spatial", "spatial"]


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_attention_regime_choice_matches_reference_under_v5e(caches, case):
    pytest.importorskip("jax")
    from repro.dist.sharding import Rules as RefRules
    from repro.kernels import ops as rops
    b, hq, hkv, m, n, d = RING_CASES[case]
    kw = dict(batch=b, q_heads=hq, kv_heads=hkv, q_len=m, kv_len=n,
              head_dim=d, causal=True)
    got, plan = ops.attention_regime_choice(
        Rules(model="model", tp="model"), MESH8, hw=V5E, **kw)
    want, wplan = rops.attention_regime_choice(
        RefRules(model="model", tp="model"), MESH8, interpret=True, **kw)
    assert got.regime == want.regime == V5E_PICKS[case]
    assert got.times == want.times
    assert (got.kernel.params.bq, got.kernel.params.bkv) == (
        want.kernel.params.bq, want.kernel.params.bkv)
    assert plan.spec.canonical() == wplan.spec.canonical()


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_attention_regime_choice_pinned_under_h100(caches, case):
    b, hq, hkv, m, n, d = RING_CASES[case]
    got, plan = ops.attention_regime_choice(
        Rules(model="model", tp="model"), MESH8, batch=b, q_heads=hq,
        kv_heads=hkv, q_len=m, kv_len=n, head_dim=d, causal=True)
    assert got.regime == H100_PICKS[case]
    assert plan.spec.ici_bw == H100.ici_bw
    assert set(got.times) == {"spatial"}


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_h100_offers_the_ring_at_one_query_row(caches, case):
    b, hq, hkv, _, n, d = RING_CASES[case]
    got, plan = ops.attention_regime_choice(
        Rules(model="model", tp="model"), MESH8, batch=b, q_heads=hq,
        kv_heads=hkv, q_len=1, kv_len=n, head_dim=d, causal=True)
    assert got.regime == "ring" and plan.n_shards == 8
    # b * hq rows do not chunk over a ring of 8: no pipelined ring
    assert set(got.times) == {"spatial", "ring"}
    assert got.times["ring"] < got.times["spatial"]


PAGED_CASES = [(4, 32, 8, 160, 16), (4, 4, 2, 64, 8), (8, 48, 1, 4096, 16),
               (4, 32, 8, 128, 16)]
PAGED_V5E = ["paged-spatial", "paged-ring", "paged-ring-pipelined",
             "paged-spatial"]
PAGED_H100 = ["paged-spatial", "paged-ring", "paged-ring", "paged-ring"]


@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_paged_regime_choice_matches_reference_and_pins_h100(caches, case):
    pytest.importorskip("jax")
    from repro.dist.sharding import Rules as RefRules
    from repro.kernels import ops as rops
    b, hq, hkv, n, ps = PAGED_CASES[case]
    kw = dict(batch=b, q_heads=hq, kv_heads=hkv, q_len=1, kv_len=n,
              head_dim=128, page_size=ps, dtype="bfloat16")
    got, _ = ops.paged_attention_regime_choice(
        Rules(model="model", tp="model"), MESH8, hw=V5E, **kw)
    want, _ = rops.paged_attention_regime_choice(
        RefRules(model="model", tp="model"), MESH8, **kw)
    assert got.regime == want.regime == PAGED_V5E[case]
    assert got.times == want.times
    h100, _ = ops.paged_attention_regime_choice(
        Rules(model="model", tp="model"), MESH8, **kw)
    assert h100.regime == PAGED_H100[case]


def test_regime_search_crosses_over_with_context_length(caches):
    """``fuse_attention_regimes`` under V5E: ring at a long context,
    spatial at a short one, each regime cached under its own key — the
    reference's numbers."""
    pytest.importorskip("jax")
    from repro.core import api as rapi
    from repro.core.perf_model import MeshSpec as RefMeshSpec
    ring8 = MeshSpec(axes=(("model", 8),), placement=(("n", "model"),))
    rring8 = RefMeshSpec(axes=(("model", 8),), placement=(("n", "model"),))
    for n, want_regime in ((8192, "ring"), (512, "spatial")):
        got = api.fuse_attention_regimes(
            128, n, 64, 64, heads=4, batch=1, causal=True, hw=V5E,
            regimes={"spatial": None, "ring": ring8})
        want = rapi.fuse_attention_regimes(
            128, n, 64, 64, heads=4, batch=1, causal=True,
            regimes={"spatial": None, "ring": rring8})
        assert got.regime == want.regime == want_regime
        assert got.times == want.times
    assert ring8.canonical() != MeshSpec.single().canonical()
    with pytest.raises(ValueError):
        api.fuse_attention_regimes(1, 8, 8, 8, regimes={})


def test_rank_regimes_is_deterministic_on_ties():
    from repro_torch.core.search import rank_regimes
    a, b = SimpleNamespace(best_time=1.0), SimpleNamespace(best_time=1.0)
    assert rank_regimes({"spatial": a, "ring": b})[0] == "spatial"
    assert rank_regimes({"ring": b, "spatial": a})[0] == "ring"


# ---------------------------------------------------------------------------
# ring gating
# ---------------------------------------------------------------------------

def test_ring_spec_gating():
    mesh = SimpleNamespace(shape={"data": 2, "model": 4})
    rules = Rules(data=("data",), model="model", tp="model")
    spec, baxes, ax = ring_dispatch_spec(rules, mesh, batch=4, kv_len=4096)
    assert ax == "model" and spec.placement == (("n", "model"),)
    assert baxes == ("data",) and spec.batch_axes == ("data",)
    assert ring_dispatch_spec(rules, mesh, batch=4, kv_len=4098)[2] is None
    assert plan_ring_attention(rules, mesh, batch=4, kv_len=4098) is None
    plan = plan_ring_attention(rules, mesh, batch=4, kv_len=4096)
    assert plan.axis == "model" and plan.n_shards == 4
    # a model dim the batch already rides offers no ring
    zero3 = Rules(data=("data",), model="model",
                  batch_axes=("data", "model"))
    assert plan_ring_attention(zero3, mesh, batch=8, kv_len=4096) is None


def test_tuner_and_dispatcher_build_identical_ring_spec():
    from repro_torch.launch.mesh import tuner_mesh_spec
    mesh = SimpleNamespace(shape={"data": 2, "model": 4})
    rules = Rules(data=("data",), model="model", tp="model")
    spec, _, _ = ring_dispatch_spec(rules, mesh, batch=4, kv_len=8192)
    assert spec == tuner_mesh_spec(mesh, rules, kind="attention", batch=4,
                                   reduction_dim=8192,
                                   shard_reduction=True)


def test_pipelined_and_paged_ring_gating(caches):
    """ring-pipelined is offered only when the rows chunk over the
    ring; paged-ring only when the dim divides the page count."""
    rules = Rules(model="model", tp="model")
    mesh = SimpleNamespace(shape={"model": 4})
    plan = plan_ring_attention(rules, mesh, batch=1, kv_len=4096)
    assert ops._pipelined_rows_ok(plan, 1, 2, 64)
    assert not ops._pipelined_rows_ok(plan, 1, 3, 1)
    choice, _ = ops.attention_regime_choice(
        rules, mesh, batch=1, q_heads=3, kv_heads=1, q_len=1, kv_len=4096,
        head_dim=64)
    assert "ring-pipelined" not in choice.times
    # 10 pages of 16 do not split 4 ways: paged-spatial alone
    ten, plan = ops.paged_attention_regime_choice(
        rules, mesh, batch=4, q_heads=32, kv_heads=8, q_len=1, kv_len=160,
        head_dim=128, page_size=16)
    assert plan is None and set(ten.times) == {"paged-spatial"}
    eight, plan = ops.paged_attention_regime_choice(
        rules, mesh, batch=4, q_heads=32, kv_heads=8, q_len=1, kv_len=128,
        head_dim=128, page_size=16)
    assert plan is not None and "paged-ring" in eight.times
    # no kv split at all: the dense search has nothing to choose
    assert ops.attention_regime_choice(
        rules, mesh, batch=1, q_heads=4, kv_heads=4, q_len=8, kv_len=10,
        head_dim=64) == (None, None)
