"""The port's fused MLP chain (``repro_torch.kernels.gemm_chain``)
against the JAX package's Pallas ``fused_mlp_chain``.

On the CPU the wrapper runs the kernel's plain version; it must match
the Pallas kernel run in interpret mode (as the JAX package's own tests
run it) on inputs made by numpy from a seed, with the n axis split as
the kernel splits it or not, and the unfused oracle at tiles that do not
divide the dims.  The split rule (``perf_model.mlp_splits``) and the
bf16 kernel's tile rule are checked here too.  Tests marked ``sm90``
launch the CUDA kernel and hold it to the plain version on the card;
they skip everywhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.perf_model import (H100, mlp_smem_bytes,  # noqa: E402
                                         mlp_split_costs, mlp_splits)
from repro_torch.kernels import gemm_chain as G  # noqa: E402
from repro_torch.kernels.ref import mlp_chain_ref  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)        # f32: sum order only
# bf16: the hidden block and E round to bf16 at the same points in both
# versions; an f32 sum-order difference can still flip one rounding
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jref():
    """(jnp, the JAX gemm_chain module) on the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import gemm_chain as ref
    with jax.default_device(jax.devices("cpu")[0]):
        yield jnp, ref


def _inputs(b, m, n, k, h, gated, seed):
    """(a, wu, wd, wg) as f32 numpy, weights scaled like dense_init."""
    rng = np.random.RandomState(seed)
    a = rng.randn(b, m, k).astype(np.float32)
    wu = (rng.randn(b, k, n) / np.sqrt(k)).astype(np.float32)
    wd = (rng.randn(b, n, h) / np.sqrt(n)).astype(np.float32)
    wg = ((rng.randn(b, k, n) / np.sqrt(k)).astype(np.float32)
          if gated else None)
    return a, wu, wd, wg


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("style", ["deep", "flat"])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("relu", False)])
def test_plain_matches_pallas_interpret(jref, style, act, gated):
    jnp, ref = jref
    a, wu, wd, wg = _inputs(2, 32, 128, 64, 64, gated, seed=len(act))
    tiles = dict(bm=16, bn=64, bk=32, bh=32)
    want = ref.fused_mlp_chain(
        jnp.asarray(a), jnp.asarray(wu), jnp.asarray(wd),
        wg=None if wg is None else jnp.asarray(wg), act=act, style=style,
        interpret=True, **tiles)
    got = G.fused_mlp_chain(_t(a), _t(wu), _t(wd), wg=_t(wg), act=act,
                            style=style, **tiles)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_matches_pallas_interpret_bf16(jref):
    """All-bf16: the hidden block rounds to bf16 before the down
    projection in both, and E rounds once at the end."""
    jnp, ref = jref
    a, wu, wd, wg = _inputs(1, 16, 128, 64, 64, True, seed=7)
    tiles = dict(bm=16, bn=64, bk=32, bh=64)
    want = ref.fused_mlp_chain(
        *(jnp.asarray(x, jnp.bfloat16) for x in (a, wu, wd)),
        wg=jnp.asarray(wg, jnp.bfloat16), act="silu", style="deep",
        interpret=True, **tiles)
    bf = torch.bfloat16
    got = G.fused_mlp_chain(_t(a, bf), _t(wu, bf), _t(wd, bf),
                            wg=_t(wg, bf), act="silu", style="deep",
                            **tiles)
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL_BF16)


def test_f32_activation_bf16_weights_match_promote_then_run(jref):
    """The stitched-ln2 case: f32 A with bf16 weights.  The reference
    promotes the weights to f32 and runs the f32 kernel; the port widens
    them inside the kernel — the same numbers, with no weight copy."""
    jnp, ref = jref
    a, wu, wd, wg = _inputs(1, 4, 128, 64, 64, True, seed=11)
    bf = torch.bfloat16
    wu_b, wd_b, wg_b = _t(wu, bf), _t(wd, bf), _t(wg, bf)
    tiles = dict(bm=4, bn=64, bk=32, bh=64)
    want = ref.fused_mlp_chain(
        jnp.asarray(a), *(jnp.asarray(w.float().numpy())
                          for w in (wu_b, wd_b)),
        wg=jnp.asarray(wg_b.float().numpy()), act="silu", style="deep",
        interpret=True, **tiles)
    got = G.fused_mlp_chain(_t(a), wu_b, wd_b, wg=wg_b, act="silu",
                            style="deep", **tiles)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("style", ["deep", "flat"])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False)])
def test_plain_matches_oracle_at_non_dividing_tiles(style, act, gated):
    """Ragged edges everywhere: M=5 over bm=4, N=100 over bn=32, K=48
    over bk=32, H=40 over bh=16."""
    a, wu, wd, wg = _inputs(1, 5, 100, 48, 40, gated, seed=3)
    got = G.fused_mlp_chain(_t(a), _t(wu), _t(wd), wg=_t(wg), act=act,
                            bm=4, bn=32, bk=32, bh=16, style=style)
    want = mlp_chain_ref(_t(a), _t(wu), _t(wd), wg=_t(wg), act=act)
    torch.testing.assert_close(got, want, **TOL)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    want = 0.5 * x * (1 + torch.tanh(np.sqrt(2 / np.pi)
                                     * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(G.act_fn("gelu")(x), want)


@pytest.mark.parametrize("bad", ["dtype", "mixed_weights", "shape",
                                 "contig", "style", "act", "smem"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, wu, wd, wg = (_t(x) for x in _inputs(1, 4, 32, 16, 16, True, 0))
    kw = dict(bm=4, bn=32, bk=16, bh=16, style="deep", act="silu")
    if bad == "dtype":
        a = a.half()
    elif bad == "mixed_weights":
        wg = wg.bfloat16()
    elif bad == "shape":
        wd = torch.zeros(1, 31, 16)
    elif bad == "contig":
        wu = torch.zeros(1, 32, 16).transpose(1, 2)
    elif bad == "style":
        kw["style"] = "materialize"
    elif bad == "act":
        kw["act"] = "swish"
    else:
        a = torch.zeros(1, 64, 4096)
        wu = wg = torch.zeros(1, 4096, 512)
        wd = torch.zeros(1, 512, 4096)
        kw.update(bm=16, bn=512, bk=64, style="flat")
        assert mlp_smem_bytes(16, 512, 64, 4096, 4, 4, True) \
            > H100.smem_per_block
    with pytest.raises((TypeError, ValueError)):
        G.fused_mlp_chain(a, wu, wd, wg=wg, **kw)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU launches the kernel or raises: on a device
    with no kernel it raises, and where the toolchain or card is
    missing the CUDA launch raises instead of computing anything."""
    a = torch.zeros(1, 4, 16, device="meta")
    w = torch.zeros(1, 16, 32, device="meta")
    wd = torch.zeros(1, 32, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        G.fused_mlp_chain(a, w, wd, wg=w, bm=4, bn=32, bk=16, bh=16)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launch would run")
    a, w, wd = torch.zeros(1, 4, 16), torch.zeros(1, 16, 32), \
        torch.zeros(1, 32, 16)
    before = G.fused_mlp_chain.launches
    with pytest.raises(RuntimeError):
        G._launch(a, w, wd, w, "silu", 4, 32, 16, 16, splits=1)
    assert G.fused_mlp_chain.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [2, 3])
def test_plain_with_splits_matches_pallas_interpret(jref, dtype, splits):
    """The n axis cut into runs of whole bn blocks (N=160 over bn=32: 5
    blocks, so 3 splits are uneven), each run's f32 partial E summed in
    split order, against the unsplit Pallas kernel."""
    jnp, ref = jref
    a, wu, wd, wg = _inputs(2, 32, 160, 64, 48, True, seed=splits)
    tiles = dict(bm=16, bn=32, bk=32, bh=48)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = ref.fused_mlp_chain(
        *(jnp.asarray(x, jt) for x in (a, wu, wd)), wg=jnp.asarray(wg, jt),
        act="silu", style="deep", interpret=True, **tiles)
    tt = getattr(torch, dtype)
    got = G.fused_mlp_chain_plain(_t(a, tt), _t(wu, tt), _t(wd, tt),
                                  _t(wg, tt), "silu", 32, splits)
    assert got.dtype == tt and got.shape == (2, 32, 48)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else TOL_BF16))


def _unsplit_plain(a, wu, wd, wg, act, bn):
    """The plain version as it was before the split: E summed in f32 over
    every n block from zero, cast once."""
    f = G.act_fn(act)
    hidden_t = torch.promote_types(a.dtype, wu.dtype)
    af = a.float()
    e = torch.zeros(a.shape[0], a.shape[1], wd.shape[2])
    for n0 in range(0, wu.shape[2], bn):
        u = torch.bmm(af, wu[:, :, n0:n0 + bn].float())
        hid = (f(u) if wg is None
               else f(torch.bmm(af, wg[:, :, n0:n0 + bn].float())) * u)
        e += torch.bmm(hid.to(hidden_t).float(), wd[:, n0:n0 + bn].float())
    return e.to(a.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [True, False])
def test_one_split_is_bit_for_bit_the_unsplit_plain(dtype, gated):
    a, wu, wd, wg = (_t(x, dtype) for x in _inputs(1, 5, 100, 48, 40,
                                                     gated, seed=5))
    got = G.fused_mlp_chain_plain(a, wu, wd, wg, "gelu", 32, 1)
    assert torch.equal(got, _unsplit_plain(a, wu, wd, wg, "gelu", 32))
    assert torch.equal(G.fused_mlp_chain_plain(a, wu, wd, wg, "gelu", 32),
                       got)


_FULL = dict(batch=1, n=12288, k=4096, h=4096)


@pytest.mark.parametrize("m,bm,bn,be,nbytes", [
    (4, 4, 96, 4096, 2), (4, 4, 16, 512, 2), (144, 144, 32, 4096, 2),
    (144, 48, 224, 4096, 2), (4096, 128, 112, 4096, 2),
    (4, 4, 96, 4096, 4), (4, 4, 16, 512, 4), (144, 48, 176, 512, 4)])
def test_mlp_splits_fewest_among_equal_costs(m, bm, bn, be, nbytes):
    """The split the rule returns is the cheapest count it weighs, the
    fewest splits among equal costs, and its layout fits a block."""
    args = (_FULL["batch"], m, _FULL["n"], _FULL["k"], _FULL["h"], bm, bn,
            32, be, nbytes, nbytes, True)
    splits, per = mlp_splits(*args)
    costs = mlp_split_costs(*args)
    best = min(costs, key=lambda s: (sum(costs[s]), s))
    assert splits == best
    assert all(sum(costs[s]) > sum(costs[best]) for s in costs if s < best)
    assert mlp_smem_bytes(bm, bn, 32, be, nbytes, nbytes, True, per) \
        <= H100.smem_per_block


@pytest.mark.parametrize("n,bn", [(12288, 96), (12288, 16), (1000, 96),
                                  (160, 32), (100, 16), (48, 48)])
@pytest.mark.parametrize("m", [1, 4, 144])
def test_mlp_splits_leave_no_split_empty(n, bn, m):
    blocks = -(-n // bn)
    splits, per = mlp_splits(1, m, n, 64, 64, m, bn, 32, 64, 2, 2, True)
    assert 1 <= splits <= blocks
    assert (splits - 1) * per < blocks <= splits * per
    # the plain version cuts the same runs from the split count alone
    assert -(-blocks // splits) == per


def test_mlp_splits_partial_e_limits_the_count_at_prefill():
    """At M=144 every split adds 144 x 4096 x 8 bytes of partial E: the
    count that keeps the SMs busiest (128, 3 of 384 n blocks each) loses
    to fewer splits once those bytes are charged; at decode (M=4) the
    partial E is small and the count fills the card."""
    args = (1, 144, 12288, 4096, 4096, 144, 32, 64, 4096, 2, 2, True)
    costs = mlp_split_costs(*args)
    stream_only = min(costs, key=lambda s: (costs[s][0], s))
    splits, _ = mlp_splits(*args)
    assert stream_only == 128 and splits < stream_only
    assert costs[splits][1] < costs[stream_only][1]
    assert mlp_splits(1, 4, 12288, 4096, 4096, 4, 96, 32, 4096, 2, 2,
                      True)[0] == 128


@pytest.mark.parametrize("bad", ["rows", "units", "wide", "bn16"])
def test_bf16_tile_rule_guard_on_cpu(bad):
    """The bf16 kernel's tile rule (``perf_model.mlp_tiles_ok``) raises on
    the CPU too; the f32 kernel takes the same tiles."""
    m, n, kw = 160, 256, dict(bm=160, bn=32, bk=32, bh=64)
    if bad == "units":
        m, kw = 48, dict(bm=48, bn=352, bk=16, bh=64)
        n = 512
    elif bad == "wide":           # 5 row groups with 9 column groups
        m, kw = 80, dict(bm=80, bn=144, bk=16, bh=64)
    elif bad == "bn16":
        m, kw = 16, dict(bm=16, bn=24, bk=32, bh=64)
    for dtype in (torch.bfloat16, torch.float32):
        a, wu, wd, wg = (_t(x, dtype)
                         for x in _inputs(1, m, n, 32, 64, True, 0))
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="bf16 kernel"):
                G.fused_mlp_chain(a, wu, wd, wg=wg, **kw)
        else:
            assert G.fused_mlp_chain(a, wu, wd, wg=wg, **kw).shape == \
                (1, m, 64)


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (needs an sm_90 card)
# ---------------------------------------------------------------------------

@pytest.fixture
def sm90(tmp_path, monkeypatch):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.sm90
@pytest.mark.parametrize("a_dtype,w_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("m,n,k,h,tiles,style,act,gated", [
    (4, 1536, 512, 512, (4, 160, 16, 128), "deep", "silu", True),
    (37, 1000, 256, 200, (16, 96, 32, 64), "deep", "gelu", True),
    (37, 1000, 256, 200, (16, 96, 32, 64), "flat", "relu", False),
    (144, 768, 256, 256, (48, 208, 32, 128), "deep", "gelu", False),
])
def test_kernel_matches_plain_on_card(sm90, a_dtype, w_dtype, m, n, k, h,
                                      tiles, style, act, gated):
    g = torch.Generator(device="cuda").manual_seed(m + n)
    at, wt = getattr(torch, a_dtype), getattr(torch, w_dtype)
    a = torch.randn(1, m, k, generator=g, device=sm90).to(at)
    wu = (torch.randn(1, k, n, generator=g, device=sm90) / k ** 0.5).to(wt)
    wd = (torch.randn(1, n, h, generator=g, device=sm90) / n ** 0.5).to(wt)
    wg = ((torch.randn(1, k, n, generator=g, device=sm90)
           / k ** 0.5).to(wt) if gated else None)
    bm, bn, bk, bh = tiles
    (_, bn, _, _), (splits, _) = G._check(a, wu, wd, wg, act, bm, bn, bk, bh,
                                          style)
    before = G.fused_mlp_chain.launches
    got = G.fused_mlp_chain(a, wu, wd, wg=wg, act=act, bm=bm, bn=bn, bk=bk,
                            bh=bh, style=style)
    torch.cuda.synchronize()
    assert G.fused_mlp_chain.launches == before + 1
    want = G.fused_mlp_chain_plain(a, wu, wd, wg, act, bn, splits)
    tol = TOL if at == torch.float32 else TOL_BF16
    torch.testing.assert_close(got, want, **tol)


def _card_inputs(dev, m, n, k, h, a_dtype, w_dtype, gated, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    at, wt = getattr(torch, a_dtype), getattr(torch, w_dtype)
    a = torch.randn(1, m, k, generator=g, device=dev).to(at)
    wu = (torch.randn(1, k, n, generator=g, device=dev) / k ** 0.5).to(wt)
    wd = (torch.randn(1, n, h, generator=g, device=dev) / n ** 0.5).to(wt)
    wg = ((torch.randn(1, k, n, generator=g, device=dev)
           / k ** 0.5).to(wt) if gated else None)
    return a, wu, wd, wg


@pytest.mark.sm90
@pytest.mark.parametrize("splits", [None, 1, 5])
@pytest.mark.parametrize("m,act,gated,a_dtype,style", [
    (1, "silu", True, "bfloat16", "flat"),
    (4, "silu", True, "float32", "flat"),
    (37, "gelu", False, "bfloat16", "deep"),
    (37, "relu", False, "bfloat16", "flat"),
    (144, "silu", True, "bfloat16", "flat")])
def test_kernel_splits_match_plain_on_card(sm90, splits, m, act, gated,
                                           a_dtype, style):
    """Ragged M, N=1000 over bn=96 and H=200 over bh=64, with the
    wrapper's split (None), one split and an uneven one (5 runs of 3 of
    the 11 n blocks, the last of 2), against the plain version with the
    same split."""
    n, k, h = 1000, 256, 200
    a, wu, wd, wg = _card_inputs(sm90, m, n, k, h, a_dtype, "bfloat16",
                                 gated, m + len(act))
    (bm, bn, bk, be), (own, _) = G._check(a, wu, wd, wg, act,
                                          48 if m > 64 else 16, 96, 32, 64,
                                          style)
    before = G.fused_mlp_chain.launches
    if splits is None:
        splits = own
        got = G.fused_mlp_chain(a, wu, wd, wg=wg, act=act, bm=bm, bn=bn,
                                bk=bk, bh=64, style=style)
    else:
        got = G._launch(a, wu, wd, wg, act, bm, bn, bk, be, splits)
    torch.cuda.synchronize()
    assert G.fused_mlp_chain.launches == before + 1
    want = G.fused_mlp_chain_plain(a, wu, wd, wg, act, bn, splits)
    assert got.shape == (1, m, h) and torch.isfinite(got).all()
    tol = TOL if a.dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.sm90
def test_kernel_is_deterministic_on_card(sm90):
    """A split decode call merges its partial E in split order, without
    atomics: two launches are bitwise equal."""
    a, wu, wd, wg = _card_inputs(sm90, 4, 3072, 1024, 1024, "bfloat16",
                                 "bfloat16", True, 0)
    kw = dict(bm=4, bn=96, bk=32, bh=1024, style="flat")
    _, (splits, _) = G._check(a, wu, wd, wg, "silu", **kw)
    assert splits > 1
    first = G.fused_mlp_chain(a, wu, wd, wg=wg, **kw)
    second = G.fused_mlp_chain(a, wu, wd, wg=wg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
