"""The port's GEMM-chain kernel modules against the JAX reference.

On the CPU the port's ``fused_gemm_chain`` and ``fused_gemm_chain3`` run
their plain versions, held here to the JAX kernels in Pallas interpret
mode at the shapes and tiles ``tests/test_kernels.py`` sweeps, flat and
deep, f32 and bf16, and with the n split of the MLP machine the
two-GEMM kernel runs on (one split, the wrapper's, an uneven one).
``api.fuse_gemm_chain`` under ``V5E`` picks the reference's schedules on
the paper's Table II chains, and under the H100 descriptor every pick
passes the kernel wrapper's own checks and the tile rule; the tuner
prices the split under ``H100`` only.  The tests marked ``sm90`` launch
the CUDA kernels and hold them to the plain versions on the card; they
skip everywhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api  # noqa: E402
from repro_torch.core.perf_model import (H100, V5E,  # noqa: E402
                                         gemm_chain3_smem_bytes,
                                         kernel_split_terms, mlp_hidden_bytes,
                                         mlp_partial_bytes, mlp_ring,
                                         mlp_smem_bytes, mlp_tiles_ok,
                                         rule4_bytes)
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


# (B, M, N, K, H), tiles (bm, bn, bk, bh): 8 n blocks of 64, which
# ``mlp_splits`` cuts into 8 splits at these tiles
SPLIT_SHAPE, SPLIT_TILES = (2, 64, 512, 64, 128), (32, 64, 64, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["flat", "deep"])
@pytest.mark.parametrize("splits", [1, "wrapper", 3])
def test_chain_split_plain_matches_pallas_interpret(jref, dtype, style,
                                                    splits):
    """The plain version with the n split the kernel runs — one split,
    the wrapper's own (``fused_gemm_chain`` on a CPU tensor), and an
    uneven one (8 blocks in runs of 3, 3, 2) — against the JAX kernel,
    which sums E over the n blocks in one run."""
    jnp, ref, _ = jref
    b, m, n, k, h = SPLIT_SHAPE
    bm, bn, bk, bh = SPLIT_TILES
    xs = _arrays([(b, m, k), (b, k, n), (b, n, h)], 7)
    xs = [x / np.sqrt(x.shape[1]) if i else x for i, x in enumerate(xs)]
    (ta, ja), (tb, jb), (td, jd) = (_pair(x, jnp, dtype) for x in xs)
    if splits == "wrapper":
        _, (own, _), _ = G.check_gemm_chain(ta, tb, td, bm, bn, bk, bh,
                                            style)
        assert own == 8
        got = G.fused_gemm_chain(ta, tb, td, bm=bm, bn=bn, bk=bk, bh=bh,
                                 style=style)
        assert torch.equal(got, G.fused_gemm_chain_plain(ta, tb, td, bn, 8))
    else:
        got = G.fused_gemm_chain_plain(ta, tb, td, bn, splits)
    want = ref.fused_gemm_chain(ja, jb, jd, bm=bm, bn=bn, bk=bk, bh=bh,
                                style=style, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_plain_one_split_is_the_old_version(dtype):
    """With one split the plain version is bit for bit the unsplit one:
    E summed in f32 over the n blocks from zero, then cast once."""
    xs = _arrays([(2, 48, 40), (2, 40, 96), (2, 96, 24)], 11)
    a, b, d = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs)
    want = torch.zeros(2, 48, 24)
    for n0 in range(0, 96, 32):
        c = torch.bmm(a.float(), b[:, :, n0:n0 + 32].float())
        want += torch.bmm(c.to(d.dtype).float(), d[:, n0:n0 + 32].float())
    assert torch.equal(G.fused_gemm_chain_plain(a, b, d, 32), want.to(a.dtype))
    assert torch.equal(G.fused_gemm_chain_plain(a, b, d, 32, 1),
                       want.to(a.dtype))


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
    assert mlp_smem_bytes(256, 256, 64, 256, 4, 4, False) > \
        H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        G.fused_gemm_chain(a, b, d, bm=256, bn=256, bk=64, style="flat")
    with pytest.raises(ValueError, match="shared"):
        G3.fused_gemm_chain3(a, b, d, torch.zeros(1, 256, 8), bm=256,
                             bn=256, bk=64)
    G.fused_gemm_chain(a, b, d, bm=16, bn=64, bk=64, style="flat")  # fits
    # bf16: the machine's ring and hidden tile (two-GEMM), C of all of N
    # and the E row (three-GEMM); the ring gives up stages, down to two,
    # before a tile is refused
    a, b, d = _zeros(1, 256, 256, 256, 128, dtype=torch.bfloat16)
    f = torch.zeros(1, 128, 8, dtype=torch.bfloat16)
    assert mlp_smem_bytes(64, 256, 256, 128, 2, 2, False, 1, True) > \
        H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        G.fused_gemm_chain(a, b, d, bm=64, bn=256, bk=256, style="flat")
    assert gemm_chain3_smem_bytes(128, 128, 128, 256, 128, 2) > \
        H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        G3.fused_gemm_chain3(a, b, d, f, bm=128, bn=128, bk=128)
    # the defaults, 128 everywhere, on a two-stage ring
    assert mlp_ring(128, 128, 128, False, mlp_hidden_bytes(128, 128))[0] == 2
    G.fused_gemm_chain(a, b, d)
    G3.fused_gemm_chain3(a, b, d, f, bm=64, bn=128, bk=64)


# (B, M, N, K, H[, G]) and tiles the f32 kernels take and the bf16
# machine does not: bn no multiple of 16 below N, and bn past 256 (the
# f32 cases of the card tests below)
TILE_RULE_CASES = {
    "unaligned": ((2, 96, 72, 36, 40, 8), (32, 24, 12, 8)),
    "G4": ((1, 512, 512, 256, 256, 8), (16, 512, 64, 256)),
    "CHAIN3": ((1, 1024, 512, 64, 64, 64), (16, 512, 64, 64)),
}


@pytest.mark.parametrize("case", sorted(TILE_RULE_CASES))
def test_wrapper_raises_outside_the_bf16_tile_rule(case):
    """In bf16 both chains run the tensor-core machine, whose register
    buckets and hidden layout take the tiles of ``mlp_tiles_ok`` only;
    f32 takes any tile that divides.  The JAX kernels take these bf16
    tiles: a divergence of the port (ROADMAP Queue 3)."""
    (bsz, m, n, k, h, g), (bm, bn, bk, bh) = TILE_RULE_CASES[case]
    for dt, ok in ((torch.bfloat16, False), (torch.float32, True)):
        a, b, d = _zeros(bsz, m, n, k, h, dtype=dt)
        f = torch.zeros(bsz, h, g, dtype=dt)
        assert bool(mlp_tiles_ok(bm, bn, n, a.element_size(),
                                 a.element_size())) == ok
        for call in (lambda: G.fused_gemm_chain(a, b, d, bm=bm, bn=bn,
                                                bk=bk, bh=bh, style="deep"),
                     lambda: G3.fused_gemm_chain3(a, b, d, f, bm=bm, bn=bn,
                                                  bk=bk)):
            if ok:
                call()
            else:
                with pytest.raises(ValueError, match="tile"):
                    call()


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
        G._launch_chain(a, b, d, 16, 16, 16, 16, 2)
    with pytest.raises(RuntimeError):
        G3._launch(a, b, d, f, 16, 16, 16,
                   gemm_chain3_smem_bytes(16, 16, 16, 32, 32, 4))
    assert (G.fused_gemm_chain.launches,
            G3.fused_gemm_chain3.launches) == before


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A kernel's library is named by its source and every header of
    ``csrc/`` it includes, directly or through another header, so an
    edit to a shared header never loads a stale library; a header it
    does not include changes nothing."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\nint k;\n')
    (tmp_path / "outer.cuh").write_text(' #  include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// one\n")
    (tmp_path / "other.cuh").write_text("// one\n")
    assert sorted(p.name for p in _build.sources("k")) == [
        "inner.cuh", "k.cu", "outer.cuh"]
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// two\n")
    assert _build.library_path("k") == first
    (tmp_path / "inner.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\nint k2;\n')
    assert _build.library_path("k") not in (first, second)


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


# examples/fuse_custom_chain.py: (batch, M, N, K, H, G)
CHAIN3 = (1, 1024, 512, 64, 64, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h100_picks_pass_the_wrappers_checks(port_cache, dtype):
    """Every Table II and CHAIN3 pick under H100 is a launch the kernel
    takes: the wrapper's own checks (tiles divide, the tile rule, shared
    memory fits at the wrapper's split) on meta tensors of the chain's
    shapes, with the tuner's Rule-4 bytes those of the launch."""
    from repro_torch.core.chain import gemm_chain3
    from repro_torch.core.search import heuristic_search
    dt = getattr(torch, dtype)
    nbytes = torch.empty(0, dtype=dt).element_size()
    for b, m, n, k, h in TABLE_II.values():
        tk = api.fuse_gemm_chain(m, n, k, h, batch=b, dtype=dtype)
        tiles, _, smem = G.check_gemm_chain(
            *_zeros(b, m, n, k, h, dtype=dt, device="meta"),
            **tk.params.as_kwargs())
        assert smem <= H100.smem_per_block
        assert smem == rule4_bytes(tk.report.best, H100)
        assert tiles[:3] == (tk.params.bm, tk.params.bn, tk.params.bk)
        assert mlp_tiles_ok(tiles[0], tiles[1], n, nbytes, nbytes)
    b, m, n, k, h, g = CHAIN3
    best = heuristic_search(gemm_chain3(m, n, k, h, g, batch=b, dtype=dtype),
                            hw=H100, seed=0).best
    ts = best.tile_sizes
    assert mlp_tiles_ok(ts["m"], ts["n"], n, nbytes, nbytes)
    assert rule4_bytes(best, H100) == gemm_chain3_smem_bytes(
        ts["m"], ts["n"], ts["k"], n, h, nbytes) <= H100.smem_per_block
    xs = [torch.zeros(*s, dtype=dt, device="meta")
          for s in ((b, m, k), (b, k, n), (b, n, h), (b, h, g))]
    with pytest.raises(ValueError, match="no kernel"):   # past every check
        G3.fused_gemm_chain3(*xs, bm=ts["m"], bn=ts["n"], bk=ts["k"])


def test_gemm_chain_split_enters_eqs_2_and_5():
    """Under H100 the two-GEMM chain's schedule counts the machine's n
    splits (more than one at G12's pick) and their partial E; under V5E
    it gets (1, 0), and the three-GEMM chain never splits."""
    from repro_torch.core.chain import gemm_chain3
    from repro_torch.core.dag import build_schedule
    from repro_torch.core.tiling import enumerate_tilings
    b, m, n, k, h = TABLE_II["G12"]
    best = api.fuse_gemm_chain(m, n, k, h, batch=b, dtype="bfloat16",
                               hw=H100).report.best
    flat = "(" in best.sub_expr()
    splits, extra = kernel_split_terms(best.chain, best.tile_sizes, flat,
                                       H100)
    assert splits > 1 and extra == mlp_partial_bytes(b, m, h, splits)
    assert kernel_split_terms(best.chain, best.tile_sizes, flat,
                              V5E) == (1, 0)
    chain3 = gemm_chain3(*CHAIN3[1:], batch=CHAIN3[0], dtype="bfloat16")
    s3 = build_schedule(chain3, enumerate_tilings(chain3)[0],
                        {"m": 32, "n": 128, "k": 64, "h": 64, "g": 64},
                        hard_rule2=False)
    assert kernel_split_terms(chain3, s3.tile_sizes, True, H100) == (1, 0)


@pytest.mark.parametrize("chain_args", [
    ("gemm", (128, 256, 64, 64), {"batch": 2, "dtype": "bfloat16"}),
    ("gemm", (128, 256, 64, 64), {"dtype": "float32"}),
    ("chain3", (128, 128, 64, 64, 32), {"dtype": "bfloat16"}),
])
def test_h100_batched_model_matches_scalar_for_gemm_chains(chain_args):
    """The batched pricing equals the scalar model for the GEMM chains'
    schedules under H100 — estimates bit-equal, Rule-4 bytes and the
    tile rule equal — now that the split and the machine's layout enter
    both."""
    from repro_torch.core.batch_model import ExprClassTable, as_tile_matrix
    from repro_torch.core.chain import gemm_chain, gemm_chain3
    from repro_torch.core.dag import build_schedule
    from repro_torch.core.perf_model import estimate, kernel_tiles_ok
    from repro_torch.core.pruning import iter_tile_assignments
    from repro_torch.core.tiling import enumerate_tilings
    fam, dims, kw = chain_args
    chain = (gemm_chain if fam == "gemm" else gemm_chain3)(*dims, **kw)
    rows = list(iter_tile_assignments(chain, unit=H100.tile_unit,
                                      rule3=True))
    tiles = as_tile_matrix(chain, rows)
    for expr in enumerate_tilings(chain)[:4]:
        p = ExprClassTable.build(chain, expr, unit=16).price(tiles, H100)
        for i, ts in enumerate(rows):
            s = build_schedule(chain, expr, ts, hard_rule2=False)
            assert estimate(s, H100) == p.est[i]
            assert rule4_bytes(s, H100) == p.vmem[i]
            assert bool(kernel_tiles_ok(chain, ts)) == bool(p.tiles_ok[i])


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


def _card_split_case(a, bb, d, tiles, style, splits):
    """(kernel's E, plain E) of one launch: the wrapper's own split
    (``splits=None``) or a forced count through ``_launch_chain``; None
    where the forced count's hidden tile does not fit a block, after
    checking that the launch refuses it."""
    (bm, bn, bk, be), (own, _), _ = G.check_gemm_chain(a, bb, d, *tiles,
                                                       style)
    before = G.fused_gemm_chain.launches
    if splits is None:
        splits = own
        got = G.fused_gemm_chain(a, bb, d, bm=bm, bn=bn, bk=bk, bh=tiles[3],
                                 style=style)
    else:
        nb = -(-bb.shape[2] // bn)
        per = -(-nb // splits)
        if mlp_smem_bytes(bm, bn, bk, be, a.element_size(),
                          a.element_size(), False, per, True) > \
                H100.smem_per_block:
            with pytest.raises(ValueError, match="shared"):
                G._launch_chain(a, bb, d, bm, bn, bk, be, splits)
            return None
        got = G._launch_chain(a, bb, d, bm, bn, bk, be, splits)
    torch.cuda.synchronize()
    assert G.fused_gemm_chain.launches == before + 1   # merge included
    return got, G.fused_gemm_chain_plain(a, bb, d, bn, splits)


@pytest.mark.sm90
@pytest.mark.parametrize("style", ["flat", "deep"])
@pytest.mark.parametrize("dtype,shape,tiles", [
    *(pytest.param(dt, (1, 512, 256, 64, 64), (16, 256, 64, 64),
                   id=f"G1-{dt}") for dt in ("float32", "bfloat16")),
    *(pytest.param(dt, (8, 1024, 1024, 128, 128), (128, 16, 128, 64),
                   id=f"G12-{dt}") for dt in ("float32", "bfloat16")),
    # f32 takes any dividing tile; bf16 only the machine's tile rule
    # (test_wrapper_raises_outside_the_bf16_tile_rule), so its cases
    # keep bn within it
    pytest.param("float32", (1, 512, 512, 256, 256), (16, 512, 64, 256),
                 id="G4-float32"),
    pytest.param("bfloat16", (1, 512, 512, 256, 256), (16, 256, 64, 256),
                 id="G4-bfloat16"),
    pytest.param("float32", (2, 96, 72, 36, 40), (32, 24, 12, 8),
                 id="unaligned-float32"),
    pytest.param("bfloat16", (2, 96, 72, 36, 40), (32, 72, 12, 8),
                 id="unaligned-bfloat16"),
    # the wrapper's defaults, on a two-stage ring in bf16
    pytest.param("bfloat16", (8, 1024, 1024, 128, 128), (128, 128, 128, 128),
                 id="G12-defaults-bfloat16"),
])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_chain_kernel_matches_plain_on_card(sm90, dtype, style, shape,
                                            tiles, splits):
    """Hand-picked tiles, with the wrapper's n split, one split and an
    uneven one; the plain version takes the same split."""
    b, m, n, k, h = shape
    dt = getattr(torch, dtype)
    a, bb, d = _card_inputs([(b, m, k), (b, k, n), (b, n, h)], dt, m + n,
                            sm90)
    case = _card_split_case(a, bb, d, tiles, style, splits)
    if case is not None:
        torch.testing.assert_close(
            *case, **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["G1", "G2", "G5", "G12"])
def test_chain_kernel_at_the_tuners_tiles_on_card(sm90, port_cache, dtype,
                                                  name):
    """The tuner's H100 pick in its class and the other class, against
    the plain version with the wrapper's split; two launches of the
    pick are bitwise equal."""
    b, m, n, k, h = TABLE_II[name]
    dt = getattr(torch, dtype)
    kw = api.fuse_gemm_chain(m, n, k, h, batch=b,
                             dtype=dtype).params.as_kwargs()
    a, bb, d = _card_inputs([(b, m, k), (b, k, n), (b, n, h)], dt, m + k,
                            sm90)
    tiles = (kw["bm"], kw["bn"], kw["bk"], kw["bh"])
    for style in (kw["style"], "flat" if kw["style"] == "deep" else "deep"):
        try:
            G.check_gemm_chain(a, bb, d, *tiles, style)
        except ValueError:
            assert style != kw["style"]    # the other class may not fit
            continue
        got, want = _card_split_case(a, bb, d, tiles, style, None)
        torch.testing.assert_close(
            got, want, **(TOL if dtype == "float32" else TOL_BF16))
    first = G.fused_gemm_chain(a, bb, d, **kw)
    second = G.fused_gemm_chain(a, bb, d, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.sm90
@pytest.mark.parametrize("dtype,shape,tiles", [
    # fuse_custom_chain; bn = 512 lies outside the bf16 tile rule
    pytest.param("float32", (1, 1024, 512, 64, 64, 64), (16, 512, 64),
                 id="custom-float32"),
    pytest.param("bfloat16", (1, 1024, 512, 64, 64, 64), (16, 256, 64),
                 id="custom-bfloat16"),
    *(pytest.param(dt, shape, tiles, id=f"{tag}-{dt}")
      for dt in ("float32", "bfloat16")
      for tag, shape, tiles in (
          ("tuned", (1, 1024, 512, 64, 64, 64), None),   # the tuner's tiles
          ("wide-g", (2, 128, 64, 32, 48, 200), (32, 32, 16)),  # G > bn
          ("h-k-ragged", (1, 64, 96, 24, 40, 72), (16, 96, 8)))),
])
def test_chain3_kernel_matches_plain_on_card(sm90, dtype, shape, tiles):
    b, m, n, k, h, g = shape
    dt = getattr(torch, dtype)
    if tiles is None:
        from repro_torch.core.chain import gemm_chain3
        from repro_torch.core.search import heuristic_search
        ts = heuristic_search(gemm_chain3(m, n, k, h, g, batch=b,
                                          dtype=dtype), hw=H100,
                              seed=0).best.tile_sizes
        tiles = (ts["m"], ts["n"], ts["k"])
    bm, bn, bk = tiles
    xs = _card_inputs([(b, m, k), (b, k, n), (b, n, h), (b, h, g)], dt,
                      m + g, sm90)
    before = G3.fused_gemm_chain3.launches
    got = G3.fused_gemm_chain3(*xs, bm=bm, bn=bn, bk=bk)
    again = G3.fused_gemm_chain3(*xs, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert G3.fused_gemm_chain3.launches == before + 2
    assert torch.equal(got, again)
    want = G3.fused_gemm_chain3_plain(*xs, bn)
    torch.testing.assert_close(got, want,
                               **(TOL if dtype == "float32" else TOL_BF16))
