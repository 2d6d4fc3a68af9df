"""The port's GEMM-chain kernel modules against the JAX reference.

On the CPU the port's ``fused_gemm_chain`` and ``fused_gemm_chain3`` run
their plain versions, held here to the JAX kernels in Pallas interpret
mode at the shapes and tiles ``tests/test_kernels.py`` sweeps, flat and
deep, f32 and bf16.  ``api.fuse_gemm_chain`` under ``V5E`` picks the
reference's schedules on the paper's Table II chains, and under the H100
descriptor every pick passes the kernel wrapper's own checks.  The tests
marked ``sm90`` launch the CUDA kernels and hold them to the plain
versions on the card; they skip everywhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api  # noqa: E402
from repro_torch.core.perf_model import (H100, V5E,  # noqa: E402
                                         gemm_chain_smem_bytes)
from repro_torch.kernels import gemm_chain as G  # noqa: E402
from repro_torch.kernels import gemm_chain3 as G3  # noqa: E402
from repro_torch.kernels.ref import gemm_chain3_ref, gemm_chain_ref  # noqa: E402

# tests/test_kernels.py: f32 accumulation-order differences between two
# blocked implementations on outputs of magnitude ~1
TOL = dict(rtol=3e-4, atol=1e-3)
# bf16: both round C to bf16 at the same place but sum in different
# orders, so an element of C can land one bf16 ulp apart before C D
# (tests/test_kernels.py's TOL_BF16)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)

# Table II (benchmarks/workloads.py): (batch, M, N, K, H)
TABLE_II = {
    "G1": (1, 512, 256, 64, 64), "G2": (1, 512, 256, 64, 128),
    "G3": (1, 512, 256, 64, 256), "G4": (1, 512, 512, 256, 256),
    "G5": (1, 512, 512, 512, 256), "G6": (1, 512, 512, 1024, 256),
    "G7": (1, 512, 512, 128, 128), "G8": (1, 1024, 512, 128, 128),
    "G9": (1, 2048, 512, 128, 128), "G10": (1, 1024, 1024, 128, 128),
    "G11": (4, 1024, 1024, 128, 128), "G12": (8, 1024, 1024, 128, 128),
}


@pytest.fixture(scope="module")
def jref():
    """(jnp, the JAX gemm-chain modules), run on the CPU as the JAX
    package's own tests run them."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import gemm_chain, gemm_chain3
    with jax.default_device(jax.devices("cpu")[0]):
        yield jnp, gemm_chain, gemm_chain3


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    api.clear_cache()
    yield tmp_path
    api.clear_cache()


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _pair(x, jnp, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``
    (bf16 rounded once, by torch, and handed to both)."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# plain versions vs the JAX kernels (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["flat", "deep"])
@pytest.mark.parametrize("shape,tiles,dtype", [
    ((1, 256, 256, 128, 128), (128, 128, 64, 64), "float32"),
    ((2, 256, 128, 256, 128), (128, 128, 64, 64), "float32"),
    ((1, 512, 256, 64, 64), (128, 128, 64, 64), "float32"),  # G1-ish
    # bm=64: at bm=128 the flat (bm, H=256) f32 E row and C block need
    # 262,144 B, past the 232,448 B a block may use (the wrapper raises)
    ((1, 128, 512, 128, 256), (64, 128, 64, 64), "float32"),
    ((1, 256, 256, 128, 128), (128, 128, 128, 128), "bfloat16"),
])
def test_chain_plain_matches_pallas_interpret(jref, style, shape, tiles,
                                              dtype):
    jnp, ref, _ = jref
    b, m, n, k, h = shape
    bm, bn, bk, bh = tiles
    xa, xb, xd = _arrays([(b, m, k), (b, k, n), (b, n, h)], m + n + k)
    (ta, ja), (tb, jb), (td, jd) = (_pair(x, jnp, dtype)
                                    for x in (xa, xb, xd))
    got = G.fused_gemm_chain(ta, tb, td, bm=bm, bn=bn, bk=bk, bh=bh,
                             style=style)
    want = ref.fused_gemm_chain(ja, jb, jd, bm=bm, bn=bn, bk=bk, bh=bh,
                                style=style, interpret=True)
    assert got.dtype == ta.dtype and got.shape == (b, m, h)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else TOL_BF16))


# tests/test_kernels.py's sweep, with (256, 16) for its (256, 128): a
# 256-row flat tile at bn=128 needs 360,448 B of shared memory
@pytest.mark.parametrize("tile", [(64, 64), (128, 128), (128, 64),
                                  (256, 16)])
def test_chain_plain_tile_sweep(jref, tile):
    jnp, ref, _ = jref
    bm, bn = tile
    xa, xb, xd = _arrays([(1, 256, 128), (1, 128, 256), (1, 256, 128)], 1)
    got = G.fused_gemm_chain(*map(torch.from_numpy, (xa, xb, xd)), bm=bm,
                             bn=bn, bk=64, bh=64, style="flat")
    want = ref.fused_gemm_chain(*map(jnp.asarray, (xa, xb, xd)), bm=bm,
                                bn=bn, bk=64, bh=64, style="flat",
                                interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,tiles,dtype", [
    ((2, 256, 256, 128, 64, 64), (128, 128, 64), "float32"),
    ((1, 128, 128, 128, 128, 64), (64, 128, 128), "float32"),
    ((1, 128, 128, 128, 128, 64), (128, 64, 64), "float32"),
    ((1, 256, 128, 64, 64, 64), (64, 64, 64), "bfloat16"),
])
def test_chain3_plain_matches_pallas_interpret(jref, shape, tiles, dtype):
    jnp, _, ref3 = jref
    b, m, n, k, h, g = shape
    bm, bn, bk = tiles
    xs = _arrays([(b, m, k), (b, k, n), (b, n, h), (b, h, g)], m + g)
    # weights scaled by 1/sqrt(fan-in), as a model's are, keep the three
    # chained products at magnitude ~1 (unscaled, G reaches ~1e3 and a
    # bf16 ulp of E is ~4)
    xs = [x / np.sqrt(x.shape[1]) if i else x for i, x in enumerate(xs)]
    pairs = [_pair(x, jnp, dtype) for x in xs]
    got = G3.fused_gemm_chain3(*(p[0] for p in pairs), bm=bm, bn=bn, bk=bk)
    want = ref3.fused_gemm_chain3(*(p[1] for p in pairs), bm=bm, bn=bn,
                                  bk=bk, interpret=True)
    assert got.dtype == pairs[0][0].dtype and got.shape == (b, m, g)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracles_match_reference(jref, dtype):
    jnp = jref[0]
    from repro.kernels import ref
    xs = _arrays([(2, 64, 32), (2, 32, 48), (2, 48, 16), (2, 16, 24)], 3)
    pairs = [_pair(x, jnp, dtype) for x in xs]
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(
        _np(gemm_chain_ref(*(p[0] for p in pairs[:3]))),
        np.asarray(ref.gemm_chain_ref(*(p[1] for p in pairs[:3])),
                   np.float32), **tol)
    np.testing.assert_allclose(
        _np(gemm_chain3_ref(*(p[0] for p in pairs))),
        np.asarray(ref.gemm_chain3_ref(*(p[1] for p in pairs)), np.float32),
        **tol)


# ---------------------------------------------------------------------------
# the wrappers' guards
# ---------------------------------------------------------------------------

def _zeros(b, m, n, k, h, dtype=torch.float32, device="cpu"):
    return (torch.zeros(b, m, k, dtype=dtype, device=device),
            torch.zeros(b, k, n, dtype=dtype, device=device),
            torch.zeros(b, n, h, dtype=dtype, device=device))


@pytest.mark.parametrize("bad", ["bm", "bn", "bk", "bh"])
def test_wrapper_raises_on_tiles_that_do_not_divide(bad):
    tiles = dict(bm=32, bn=32, bk=32, bh=32)
    tiles[bad] = 24
    with pytest.raises(ValueError, match="divide"):
        G.fused_gemm_chain(*_zeros(1, 64, 64, 64, 64), style="deep",
                           **tiles)
    if bad != "bh":
        a, b, d = _zeros(1, 64, 64, 64, 64)
        with pytest.raises(ValueError, match="divide"):
            G3.fused_gemm_chain3(a, b, d, torch.zeros(1, 64, 16),
                                 **{k: v for k, v in tiles.items()
                                    if k != "bh"})


def test_wrapper_raises_over_shared_memory_bound():
    a, b, d = _zeros(1, 256, 256, 64, 256)
    assert gemm_chain_smem_bytes(256, 256, 64, 256, 4) > H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        G.fused_gemm_chain(a, b, d, bm=256, bn=256, bk=64, style="flat")
    with pytest.raises(ValueError, match="shared"):
        G3.fused_gemm_chain3(a, b, d, torch.zeros(1, 256, 8), bm=256,
                             bn=256, bk=64)
    G.fused_gemm_chain(a, b, d, bm=16, bn=64, bk=64, style="flat")  # fits


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "contig",
                                 "style"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b, d = _zeros(1, 32, 32, 32, 32)
    kw = dict(bm=16, bn=16, bk=16, bh=16)
    if bad == "dtype":
        a, b, d = a.half(), b.half(), d.half()
    elif bad == "mixed":
        d = d.bfloat16()
    elif bad == "shape":
        d = torch.zeros(1, 16, 32)
    elif bad == "contig":
        b = torch.zeros(1, 64, 32)[:, ::2]
    else:
        kw["style"] = "materialize"
    with pytest.raises((TypeError, ValueError)):
        G.fused_gemm_chain(a, b, d, **kw)
    if bad in ("dtype", "mixed", "shape", "contig"):
        with pytest.raises((TypeError, ValueError)):
            G3.fused_gemm_chain3(a, b, d, torch.zeros(1, 32, 8), bm=16,
                                 bn=16, bk=16)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU launches the kernel or raises: on a device
    with no kernel it raises, and where the toolchain or card is
    missing the CUDA launch raises instead of computing anything."""
    a, b, d = _zeros(1, 32, 32, 32, 32, device="meta")
    f = torch.zeros(1, 32, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        G.fused_gemm_chain(a, b, d, bm=16, bn=16, bk=16, bh=16)
    with pytest.raises(ValueError, match="no kernel"):
        G3.fused_gemm_chain3(a, b, d, f, bm=16, bn=16, bk=16)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launch would run")
    a, b, d = _zeros(1, 32, 32, 32, 32)
    f = torch.zeros(1, 32, 8)
    before = (G.fused_gemm_chain.launches, G3.fused_gemm_chain3.launches)
    with pytest.raises(RuntimeError):
        G._launch_chain(a, b, d, 16, 16, 16, 16,
                        gemm_chain_smem_bytes(16, 16, 16, 16, 4))
    with pytest.raises(RuntimeError):
        G3._launch(a, b, d, f, 16, 16, 16,
                   gemm_chain_smem_bytes(16, 16, 16, 32, 4))
    assert (G.fused_gemm_chain.launches,
            G3.fused_gemm_chain3.launches) == before


# ---------------------------------------------------------------------------
# the tuner's picks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TABLE_II))
def test_fuse_gemm_chain_matches_reference_under_v5e(port_cache, name):
    pytest.importorskip("jax")
    from repro.core import api as ref_api
    b, m, n, k, h = TABLE_II[name]
    ref = ref_api.fuse_gemm_chain(m, n, k, h, batch=b)
    got = api.fuse_gemm_chain(m, n, k, h, batch=b, hw=V5E)
    assert got.report.best.key() == ref.report.best.key()
    assert got.params.as_kwargs() == ref.params.as_kwargs()
    assert got.report.best_time == ref.report.best_time


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h100_picks_pass_the_wrappers_checks(port_cache, dtype):
    """Every Table II pick under H100 is a launch the kernel takes: the
    wrapper's own checks (tiles divide, shared memory fits) on meta
    tensors of the chain's shapes."""
    dt = getattr(torch, dtype)
    for b, m, n, k, h in TABLE_II.values():
        tk = api.fuse_gemm_chain(m, n, k, h, batch=b, dtype=dtype)
        tiles, smem = G.check_gemm_chain(
            *_zeros(b, m, n, k, h, dtype=dt, device="meta"),
            **tk.params.as_kwargs())
        assert smem <= H100.smem_per_block
        assert tiles[:3] == (tk.params.bm, tk.params.bn, tk.params.bk)


def test_ops_gemm_chain_runs_the_tuned_schedule(port_cache):
    from repro_torch.kernels import ops
    xa, xb, xd = _arrays([(1, 128, 64), (1, 64, 128), (1, 128, 32)], 5)
    a, b, d = map(torch.from_numpy, (xa, xb, xd))
    torch.testing.assert_close(ops.gemm_chain(a, b, d),
                               gemm_chain_ref(a, b, d), **TOL)
    assert ("gemm", 128, 128, 64, 32, 1, "float32", H100.name,
            H100.tile_unit, None, 0) in api._CACHE


def test_quickstart_runs_on_the_cpu(port_cache, capsys):
    from repro_torch.launch import quickstart
    errors = quickstart.main(["--device", "cpu"])
    for err, scale in errors.values():
        assert err <= TOL["atol"] + TOL["rtol"] * scale
    out = capsys.readouterr().out
    assert "est. H100 time" in out and "max |err| vs oracle" in out


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (needs an sm_90 card)
# ---------------------------------------------------------------------------

@pytest.fixture
def sm90(tmp_path, monkeypatch):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _card_inputs(shapes, dtype, seed, device):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(*s, generator=g, device=device) / s[1] ** 0.5
             ).to(dtype) for s in shapes]


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["flat", "deep"])
@pytest.mark.parametrize("shape,tiles", [
    ((1, 512, 256, 64, 64), (16, 256, 64, 64)),     # G1, the H100 pick
    ((1, 512, 512, 256, 256), (16, 512, 64, 256)),  # G4
    ((8, 1024, 1024, 128, 128), (128, 16, 128, 64)),  # G12 bf16 pick
    ((2, 96, 72, 36, 40), (32, 24, 12, 8)),         # unaligned widths
])
def test_chain_kernel_matches_plain_on_card(sm90, dtype, style, shape,
                                            tiles):
    b, m, n, k, h = shape
    bm, bn, bk, bh = tiles
    dt = getattr(torch, dtype)
    a, bb, d = _card_inputs([(b, m, k), (b, k, n), (b, n, h)], dt, m + n,
                            sm90)
    before = G.fused_gemm_chain.launches
    got = G.fused_gemm_chain(a, bb, d, bm=bm, bn=bn, bk=bk, bh=bh,
                             style=style)
    torch.cuda.synchronize()
    assert G.fused_gemm_chain.launches == before + 1
    want = G.fused_gemm_chain_plain(a, bb, d, bn)
    torch.testing.assert_close(got, want,
                               **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tiles", [
    ((1, 1024, 512, 64, 64, 64), (16, 512, 64)),   # fuse_custom_chain
    ((2, 128, 64, 32, 48, 200), (32, 32, 16)),     # G wider than bn
])
def test_chain3_kernel_matches_plain_on_card(sm90, dtype, shape, tiles):
    b, m, n, k, h, g = shape
    bm, bn, bk = tiles
    dt = getattr(torch, dtype)
    xs = _card_inputs([(b, m, k), (b, k, n), (b, n, h), (b, h, g)], dt,
                      m + g, sm90)
    before = G3.fused_gemm_chain3.launches
    got = G3.fused_gemm_chain3(*xs, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert G3.fused_gemm_chain3.launches == before + 1
    want = G3.fused_gemm_chain3_plain(*xs, bn)
    torch.testing.assert_close(got, want,
                               **(TOL if dtype == "float32" else TOL_BF16))
