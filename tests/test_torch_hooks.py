"""The stitching hooks of the port's kernels (``repro_torch.kernels.hooks``)
against the JAX package's Pallas kernels with the same hooks.

The JAX kernels take any tile-local callable as ``prologue`` /
``epilogue`` (the GEMM chains, the MLP chain, the three-GEMM chain and
``ops.mlp_chain``) and ``q_prologue`` / ``k_prologue`` / ``o_epilogue``
(``fused_attention``); the port takes ``Elementwise`` expressions of a
closed vocabulary.  On the CPU each wrapper runs its plain version, which
must match the Pallas kernel run in interpret mode (as the JAX package's
own tests run it, ``tests/test_planner.py``) on inputs made by numpy
from a seed, with the equivalent JAX callables.  A non-linear epilogue
must follow the sum of the MLP machine's n splits.  Tests marked
``sm90`` launch the CUDA kernels with hooks and hold them to their plain
versions on the card; they skip everywhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as A  # noqa: E402
from repro_torch.kernels import gemm_chain as G  # noqa: E402
from repro_torch.kernels import gemm_chain3 as G3  # noqa: E402
from repro_torch.kernels import hooks, ops  # noqa: E402
from repro_torch.kernels.hooks import Elementwise  # noqa: E402

TOL = dict(rtol=3e-4, atol=1e-3)        # f32: sum order only
# bf16: the hooked tiles and the outputs round to bf16 at the same points
# in both versions; an f32 sum-order or ulp difference can flip a rounding
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)

TANH = Elementwise.of("tanh")
HALF = Elementwise.of(("mul", 0.5))
HALF_TANH = Elementwise.of(("mul", 0.5), "tanh")
TWICE = Elementwise.of(("mul", 2.0))
PLUS_ONE = Elementwise.of(("add", 1.0))


@pytest.fixture(scope="module")
def jx():
    """(jax, jnp) on the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax, jnp


def _jax_fn(jax, jnp, e: Elementwise):
    """The JAX callable of an ``Elementwise``, in the tile's own type, as
    a hook of the JAX kernels computes it."""
    ops_ = {"mul": lambda x, c: x * c, "add": lambda x, c: x + c,
            "max": lambda x, c: jnp.maximum(x, c),
            "min": lambda x, c: jnp.minimum(x, c),
            "tanh": lambda x, c: jnp.tanh(x),
            "sigmoid": lambda x, c: jax.nn.sigmoid(x),
            "exp": lambda x, c: jnp.exp(x),
            "square": lambda x, c: x * x,
            "relu": lambda x, c: jax.nn.relu(x),
            "silu": lambda x, c: jax.nn.silu(x),
            "gelu": lambda x, c: jax.nn.gelu(x)}

    def fn(x):
        for op, c in e.steps:
            x = ops_[op](x, c)
        return x
    return fn


def _rand(shapes, seed, scales=None):
    rng = np.random.RandomState(seed)
    scales = scales or [1.0] * len(shapes)
    return [(rng.randn(*s) * c).astype(np.float32)
            for s, c in zip(shapes, scales)]


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


# ---------------------------------------------------------------------------
# the Elementwise expression itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(hooks.OPS))
def test_each_op_matches_jax(jx, op):
    """Every op of the vocabulary, in f32, against the JAX function the
    JAX package's hooks would call."""
    jax, jnp = jx
    e = Elementwise.of((op, 0.25) if op in hooks.WITH_CONSTANT else op)
    (x,) = _rand([(64,)], seed=hooks.OPS[op])
    want = np.asarray(_jax_fn(jax, jnp, e)(jnp.asarray(x)))
    np.testing.assert_allclose(e(_t(x)).numpy(), want, rtol=1e-6, atol=1e-6)


def test_elementwise_rounds_once_to_the_tiles_type():
    """Every step in f32, one rounding at the end: a bf16 tile comes back
    bf16, equal to the f32 result rounded."""
    (x,) = _rand([(256,)], seed=3)
    xb = _t(x, torch.bfloat16)
    got = HALF_TANH(xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.tanh(xb.float() * 0.5).to(torch.bfloat16))


def test_elementwise_views():
    e = Elementwise.of(("mul", 0.1), "tanh", ("max", -0.5))
    assert e.key() == (("mul", np.float32(0.1).item()), ("tanh",),
                       ("max", -0.5))
    assert hash(e) == hash(Elementwise.of(("mul", 0.1), "tanh",
                                          ("max", -0.5)))
    s = e.as_c()
    assert s.n == 3 and list(s.op)[:3] == [hooks.OPS["mul"],
                                           hooks.OPS["tanh"],
                                           hooks.OPS["max"]]
    assert s.c[0] == np.float32(0.1) and s.c[2] == -0.5
    assert hooks.as_c(None).n == 0 and not Elementwise()
    assert hooks.check(Elementwise()) is None


@pytest.mark.parametrize("bad", [
    lambda: Elementwise.of("cosh"), lambda: Elementwise.of(("tanh", 1.0)),
    lambda: Elementwise.of("mul"), lambda: Elementwise.of(*["exp"] * 9),
    lambda: Elementwise((("mul",),))])
def test_elementwise_refuses_what_the_kernels_do_not_run(bad):
    with pytest.raises(ValueError):
        bad()


def _chain_call(name, hook):
    a, b, d, f = (torch.zeros(1, 16, 16) for _ in range(4))
    return {
        "fused_gemm_chain prologue": lambda: G.fused_gemm_chain(
            a, b, d, prologue=hook),
        "fused_gemm_chain epilogue": lambda: G.fused_gemm_chain(
            a, b, d, epilogue=hook),
        "fused_mlp_chain prologue": lambda: G.fused_mlp_chain(
            a, b, d, prologue=hook),
        "fused_mlp_chain epilogue": lambda: G.fused_mlp_chain(
            a, b, d, wg=b, epilogue=hook),
        "fused_gemm_chain3 prologue": lambda: G3.fused_gemm_chain3(
            a, b, d, f, prologue=hook),
        "fused_gemm_chain3 epilogue": lambda: G3.fused_gemm_chain3(
            a, b, d, f, epilogue=hook),
        "fused_attention q_prologue": lambda: A.fused_attention(
            a[None], b[None], d[None], q_prologue=hook),
        "fused_attention k_prologue": lambda: A.fused_attention(
            a[None], b[None], d[None], k_prologue=hook),
        "fused_attention o_epilogue": lambda: A.fused_attention(
            a[None], b[None], d[None], o_epilogue=hook),
        "ops.mlp_chain prologue": lambda: ops.mlp_chain(
            a[0], b[0], d[0], prologue=hook),
        "ops.mlp_chain epilogue": lambda: ops.mlp_chain(
            a[0], b[0], d[0], epilogue=hook),
    }[name]


HOOKED = ["fused_gemm_chain prologue", "fused_gemm_chain epilogue",
          "fused_mlp_chain prologue", "fused_mlp_chain epilogue",
          "fused_gemm_chain3 prologue", "fused_gemm_chain3 epilogue",
          "fused_attention q_prologue", "fused_attention k_prologue",
          "fused_attention o_epilogue", "ops.mlp_chain prologue",
          "ops.mlp_chain epilogue"]


@pytest.mark.parametrize("name", HOOKED)
def test_callable_hook_raises_type_error_on_the_cpu(name, tmp_path,
                                                    monkeypatch):
    """A Python callable is refused on every device, the CPU included:
    no fallback runs it, and the message names the vocabulary."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    with pytest.raises(TypeError, match="closed vocabulary"):
        _chain_call(name, torch.tanh)()
    with pytest.raises(TypeError, match="Elementwise"):
        _chain_call(name, "tanh")()
    _chain_call(name, TANH)()     # the same call with an Elementwise runs


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["flat", "deep"])
def test_gemm_chain_hooks_interpret(jx, style):
    """tests/test_planner.py::test_gemm_chain_hooks_interpret's case:
    tanh prologue, x * 0.5 epilogue, both classes."""
    jax, jnp = jx
    from repro.kernels.gemm_chain import fused_gemm_chain
    a, b, d = _rand([(1, 128, 64), (1, 64, 128), (1, 128, 64)], seed=0)
    tiles = dict(bm=64, bn=64, bk=64, bh=64)
    want = fused_gemm_chain(*map(jnp.asarray, (a, b, d)), style=style,
                            interpret=True, prologue=jnp.tanh,
                            epilogue=lambda x: x * 0.5, **tiles)
    got = G.fused_gemm_chain(_t(a), _t(b), _t(d), style=style,
                             prologue=TANH, epilogue=HALF, **tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    unhooked = G.fused_gemm_chain(_t(a), _t(b), _t(d), style=style, **tiles)
    assert not torch.allclose(got, unhooked, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_chain3_hooks_interpret(jx, dtype):
    jax, jnp = jx
    from repro.kernels.gemm_chain3 import fused_gemm_chain3
    xs = _rand([(2, 64, 32), (2, 32, 128), (2, 128, 32), (2, 32, 48)],
               seed=1, scales=[1.0, 32 ** -0.5, 128 ** -0.5, 32 ** -0.5])
    tiles = dict(bm=32, bn=64, bk=32)
    pro, epi = TANH, Elementwise.of(("mul", 3.0), "sigmoid")
    want = fused_gemm_chain3(*(jnp.asarray(x, dtype) for x in xs),
                             interpret=True, prologue=_jax_fn(jax, jnp, pro),
                             epilogue=_jax_fn(jax, jnp, epi), **tiles)
    got = G3.fused_gemm_chain3(*(_t(x, getattr(torch, dtype)) for x in xs),
                               prologue=pro, epilogue=epi, **tiles)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(TOL if dtype == "float32" else TOL_BF16))


def _mlp_inputs(gated, seed, m=4, n=512, k=64, h=64):
    """(a, wu, wd, wg): weights at twice the model's scale, so that E is
    of order 1 and a non-linear epilogue is far from linear."""
    a, wu, wd, wg = _rand([(1, m, k), (1, k, n), (1, n, h), (1, k, n)],
                          seed, scales=[2.0, 2 / k ** 0.5, 2 / n ** 0.5,
                                        2 / k ** 0.5])
    return a, wu, wd, wg if gated else None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_mlp_chain_nonlinear_epilogue_after_the_splits(jx, act, gated,
                                                       dtype):
    """The MLP machine at 8 n splits with ``prologue=tanh`` and
    ``epilogue=tanh(0.5 x)``: the plain version takes the kernel's split
    and applies the epilogue to the sum of the splits, so it matches the
    Pallas kernel (which has no split); the epilogue of each split,
    summed, does not."""
    jax, jnp = jx
    from repro.kernels.gemm_chain import fused_mlp_chain
    a, wu, wd, wg = _mlp_inputs(gated, seed=len(act))
    dt = getattr(torch, dtype)
    kw = dict(bm=4, bn=64, bk=32, bh=64, style="flat")
    ta, twu, twd, twg = (_t(x, dt) for x in (a, wu, wd, wg))
    _, (splits, _) = G._check(ta, twu, twd, twg, act, **kw)
    assert splits >= 4
    want = fused_mlp_chain(
        *(jnp.asarray(x, dtype) for x in (a, wu, wd)),
        wg=None if wg is None else jnp.asarray(wg, dtype), act=act,
        interpret=True, prologue=jnp.tanh,
        epilogue=_jax_fn(jax, jnp, HALF_TANH), **kw)
    got = G.fused_mlp_chain(ta, twu, twd, wg=twg, act=act, prologue=TANH,
                            epilogue=HALF_TANH, **kw)
    want = np.asarray(want.astype(jnp.float32))
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # an epilogue applied per split instead of after the merge
    step = 512 // splits
    per_split = sum(
        HALF_TANH(G.fused_mlp_chain_plain(
            ta, twu[:, :, s:s + step].contiguous(),
            twd[:, s:s + step].contiguous(),
            None if twg is None else twg[:, :, s:s + step].contiguous(),
            act, 64, 1, TANH).float())
        for s in range(0, 512, step))
    assert not np.allclose(per_split.numpy(), want, **tol)


@pytest.mark.parametrize("case", ["mha causal", "gqa window", "bf16 gqa"])
def test_attention_hooks_interpret(jx, case):
    """tests/test_planner.py::test_attention_hooks_interpret's case (q * 2
    and o + 1) plus a k prologue, against the Pallas kernel with the
    same callables; GQA, a window and bf16 too."""
    jax, jnp = jx
    from repro.kernels.attention import fused_attention
    hq, hkv, window, dtype = {"mha causal": (2, 2, 0, "float32"),
                              "gqa window": (4, 2, 48, "float32"),
                              "bf16 gqa": (4, 2, 0, "bfloat16")}[case]
    q, k, v = _rand([(1, hq, 128, 64), (1, hkv, 128, 64),
                     (1, hkv, 128, 64)], seed=hq + window)
    kp = Elementwise.of("tanh", ("mul", 3.0))
    want = fused_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=True,
        window=window, bq=64, bkv=64, interpret=True,
        q_prologue=lambda x: x * 2.0, k_prologue=_jax_fn(jax, jnp, kp),
        o_epilogue=lambda x: x + 1.0)
    dt = getattr(torch, dtype)
    got = A.fused_attention(*(_t(x, dt) for x in (q, k, v)), causal=True,
                            window=window, bq=64, bkv=64, q_prologue=TWICE,
                            k_prologue=kp, o_epilogue=PLUS_ONE)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.parametrize("gated", [True, False])
def test_ops_mlp_chain_hooks_match_reference_interpret(jx, gated, tmp_path,
                                                       monkeypatch):
    """``ops.mlp_chain`` forwards its hooks to the tuned kernel (on the CPU
    its plain version); the JAX package's ``ops.mlp_chain`` in interpret
    mode runs its tuned Pallas kernel with the same hooks."""
    jax, jnp = jx
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    from repro.kernels import ops as rops
    from repro_torch.core import api
    api.clear_cache()
    x, wu, wd, wg = (t[0] if t is not None else None
                     for t in _mlp_inputs(gated, seed=11, m=16, n=256,
                                          k=128, h=128))
    act = "silu" if gated else "gelu"
    pro = Elementwise.of(("min", 1.0), ("max", -1.0))
    epi = Elementwise.of("sigmoid", ("add", -0.5))
    want = rops.mlp_chain(
        jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wd),
        w_gate=None if wg is None else jnp.asarray(wg), act=act,
        mode="interpret", prologue=_jax_fn(jax, jnp, pro),
        epilogue=_jax_fn(jax, jnp, epi))
    got = ops.mlp_chain(_t(x), _t(wu), _t(wd), w_gate=_t(wg), act=act,
                        prologue=pro, epilogue=epi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    api.clear_cache()


# ---------------------------------------------------------------------------
# the CUDA kernels with hooks against their plain versions (sm_90 card)
# ---------------------------------------------------------------------------

@pytest.fixture
def sm90(tmp_path, monkeypatch):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _card(shapes, dtype, seed, scales):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(*s, generator=g, device="cuda") * c).to(dtype)
            for s, c in zip(shapes, scales)]


@pytest.mark.sm90
@pytest.mark.parametrize("a_dtype,w_dtype", [
    ("bfloat16", "bfloat16"), ("float32", "float32"),
    ("float32", "bfloat16")])
@pytest.mark.parametrize("m,n,k,h,tiles,style,act,gated", [
    (4, 3072, 512, 512, (4, 96, 32, 512), "flat", "silu", True),
    (37, 1000, 256, 200, (16, 96, 32, 64), "deep", "gelu", False),
    (144, 768, 256, 256, (48, 128, 32, 256), "flat", "silu", True)])
def test_mlp_kernel_hooks_match_plain_on_card(sm90, a_dtype, w_dtype, m, n,
                                              k, h, tiles, style, act,
                                              gated):
    at, wt = getattr(torch, a_dtype), getattr(torch, w_dtype)
    a, = _card([(1, m, k)], at, m, [2.0])
    wu, wd, wg = _card([(1, k, n), (1, n, h), (1, k, n)], wt, n,
                       [2 / k ** 0.5, 2 / n ** 0.5, 2 / k ** 0.5])
    wg = wg if gated else None
    bm, bn, bk, bh = tiles
    kw = dict(bm=bm, bn=bn, bk=bk, bh=bh, style=style)
    (_, bn, _, _), (splits, _) = G._check(a, wu, wd, wg, act, **kw)
    before, hooked = G.fused_mlp_chain.launches, dict(G.fused_mlp_chain.hooked)
    got = G.fused_mlp_chain(a, wu, wd, wg=wg, act=act, prologue=TANH,
                            epilogue=HALF_TANH, **kw)
    torch.cuda.synchronize()
    assert G.fused_mlp_chain.launches == before + 1
    key = (TANH.key(), HALF_TANH.key())
    assert G.fused_mlp_chain.hooked[key] == hooked.get(key, 0) + 1
    want = G.fused_mlp_chain_plain(a, wu, wd, wg, act, bn, splits, TANH,
                                   HALF_TANH)
    torch.testing.assert_close(got, want, **(TOL if at == torch.float32
                                             else TOL_BF16))


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("style", ["flat", "deep"])
def test_gemm_chain_kernel_hooks_match_plain_on_card(sm90, dtype, style):
    dt = getattr(torch, dtype)
    a, b, d = _card([(8, 256, 128), (8, 128, 512), (8, 512, 128)], dt, 1,
                    [1.0, 128 ** -0.5, 512 ** -0.5])
    kw = dict(bm=64, bn=64, bk=128, bh=64, style=style)
    (_, bn, _, _), (splits, _), _ = G.check_gemm_chain(a, b, d, **kw)
    got = G.fused_gemm_chain(a, b, d, prologue=TANH, epilogue=HALF, **kw)
    torch.cuda.synchronize()
    want = G.fused_gemm_chain_plain(a, b, d, bn, splits, TANH, HALF)
    torch.testing.assert_close(got, want, **(TOL if dt == torch.float32
                                             else TOL_BF16))


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gemm_chain3_kernel_hooks_match_plain_on_card(sm90, dtype):
    dt = getattr(torch, dtype)
    xs = _card([(2, 256, 64), (2, 64, 256), (2, 256, 64), (2, 64, 64)], dt,
               2, [1.0, 0.125, 1 / 16, 0.125])
    kw = dict(bm=32, bn=64, bk=64)
    epi = Elementwise.of(("mul", 3.0), "sigmoid")
    got = G3.fused_gemm_chain3(*xs, prologue=TANH, epilogue=epi, **kw)
    torch.cuda.synchronize()
    want = G3.fused_gemm_chain3_plain(*xs, kw["bn"], TANH, epi)
    torch.testing.assert_close(got, want, **(TOL if dt == torch.float32
                                             else TOL_BF16))


@pytest.mark.sm90
@pytest.mark.parametrize("dtype,hq,hkv,m,n,d,tiles,window", [
    ("bfloat16", 8, 2, 256, 256, 128, (128, 16), 0),
    ("bfloat16", 4, 1, 64, 100, 64, (64, 100), 0),
    ("bfloat16", 4, 4, 128, 256, 64, (64, 64), 96),
    ("float32", 4, 2, 128, 128, 64, (32, 64), 0)])
def test_attention_kernel_hooks_match_plain_on_card(sm90, dtype, hq, hkv, m,
                                                    n, d, tiles, window):
    dt = getattr(torch, dtype)
    q, k, v = _card([(2, hq, m, d), (2, hkv, n, d), (2, hkv, n, d)], dt,
                    hq + n, [1.0, 1.0, 1.0])
    kp = Elementwise.of("tanh")
    with torch.inference_mode():
        got = A.fused_attention(q, k, v, bq=tiles[0], bkv=tiles[1],
                                causal=True, window=window, q_prologue=TWICE,
                                k_prologue=kp, o_epilogue=PLUS_ONE)
        torch.cuda.synchronize()
        want = A.fused_attention_plain(q, k, v, tiles[1], True, window,
                                       d ** -0.5, TWICE, kp, PLUS_ONE)
    torch.testing.assert_close(got, want, **(TOL if dt == torch.float32
                                             else TOL_BF16))
