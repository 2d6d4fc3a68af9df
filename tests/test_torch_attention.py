"""The port's attention kernel module against the JAX reference.

On the CPU the port's ``fused_attention_partial`` runs its plain
version, held here to the JAX kernel (Pallas interpret mode) within
``TOL`` on ragged lengths, windows, dead rows and chunked merges.  The
tests marked ``sm90`` launch the CUDA kernel and hold it to the plain
version on the card; they skip everywhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.perf_model import H100, attention_smem_bytes  # noqa: E402
from repro_torch.kernels import attention as A  # noqa: E402

# tests/test_kernels.py: f32 accumulation-order differences between two
# blocked implementations on outputs of magnitude ~1
TOL = dict(rtol=3e-4, atol=1e-3)
# bf16 on the card: kernel and plain version round P to bf16 at the
# same place but sum in different orders, so an element can land one
# bf16 ulp apart before the f32 P V
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jref():
    """(jnp, the JAX attention module), run on the CPU as the JAX
    package's own tests run it: a GPU backend would compute f32 matmuls
    at its lower default precision."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import attention as ref
    with jax.default_device(jax.devices("cpu")[0]):
        yield jnp, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_setup(rng, b, hkv, d, ps, mp, n_pool, lengths):
    """Per-request kv scattered into a shuffled page assignment; returns
    (pool_k, pool_v, table) as numpy."""
    pool_k = rng.randn(n_pool, hkv, ps, d).astype(np.float32)
    pool_v = rng.randn(n_pool, hkv, ps, d).astype(np.float32)
    order = rng.permutation(n_pool - 1) + 1          # never scratch
    table = np.full((b, mp), -1, np.int32)
    nxt = 0
    for i in range(b):
        for j in range(-(-lengths[i] // ps)):
            table[i, j] = order[nxt]
            nxt += 1
    return pool_k, pool_v, table


# ---------------------------------------------------------------------------
# plain version vs the JAX kernel (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,bq,bkv,window,per_request", [
    (1, 1, 8, 0, True),      # decode row, per-request positions
    (3, 1, 8, 5, True),      # window straddling tiles, a dead row
    (4, 2, 16, 0, False),    # shared positions, bq > 1
    (4, 4, 24, 7, True),     # N not a multiple of the default tile
])
def test_partial_plain_matches_reference(jref, m, bq, bkv, window,
                                         per_request):
    jnp, ref = jref
    rng = np.random.RandomState(m * 7 + bkv)
    b, hq, hkv, n, d = 2, 4, 2, 24, 8
    q = rng.randn(b, hq, m, d).astype(np.float32)
    k = rng.randn(b, hkv, n, d).astype(np.float32)
    v = rng.randn(b, hkv, n, d).astype(np.float32)
    if per_request:
        kv_pos = np.tile(np.arange(n, dtype=np.int32), (b, 1))
        kv_pos[1, 5:9] = A.INVALID_POS                # unallocated slots
        q_pos = np.stack([np.arange(m) + 10, np.arange(m) + 15]
                         ).astype(np.int32)
        q_pos[1, 0] = -1                               # dead row
    else:
        kv_pos = np.arange(n, dtype=np.int32)
        q_pos = (np.arange(m) + n - m).astype(np.int32)
    want = ref.fused_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_pos),
        jnp.asarray(q_pos), bq=bq, bkv=bkv, causal=True, window=window,
        interpret=True)
    got = A.fused_attention_partial(_t(q), _t(k), _t(v), _t(kv_pos),
                                    _t(q_pos), bq=bq, bkv=bkv, causal=True,
                                    window=window)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if per_request:                    # the dead row is the merge identity
        assert float(got[1][1, 0, 0, 0]) == float(np.float32(A.NEG_INF))
        assert float(got[2][1, 0, 0, 0]) == 0.0
        assert not got[0][1, :, 0].any()


@pytest.mark.parametrize("seed,m,window,cpp", [
    (0, 1, 0, 0), (1, 1, 6, 0), (2, 4, 11, 0), (3, 1, 0, 2), (4, 1, 6, 1),
])
def test_paged_matches_reference_and_twin(jref, seed, m, window, cpp):
    """Ragged lengths, windows across page boundaries, chunked merges:
    the port's paged attention equals the JAX paged kernel and the JAX
    gather twin within TOL (not bitwise — the reference's own paged
    kernel is not bitwise equal to its partial kernel on this tree)."""
    jnp, ref = jref
    from repro.models.layers import _paged_positional_attention
    from repro.serving import kv_pages as KP
    rng = np.random.RandomState(seed)
    b, hq, hkv, d, ps, mp = 3, 4, 2, 8, 4, 5
    lengths = [int(rng.randint(m, mp * ps + 1)) for _ in range(b)]
    pk, pv, table = _paged_setup(rng, b, hkv, d, ps, mp, b * mp + 2,
                                 lengths)
    q = rng.randn(b, hq, m, d).astype(np.float32)
    larr = np.asarray(lengths, np.int32)
    got = A.fused_attention_paged(_t(q), _t(pk), _t(pv), _t(table),
                                  _t(larr), bq=4, bkv=8, window=window,
                                  pages_per_chunk=cpp).numpy()
    want = ref.fused_attention_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(larr), bq=4, bkv=8, window=window, pages_per_chunk=cpp,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    jt = jnp.asarray(table)
    kk = jnp.repeat(KP.gather_pages(jnp.asarray(pk), jt), hq // hkv, axis=1)
    vv = jnp.repeat(KP.gather_pages(jnp.asarray(pv), jt), hq // hkv, axis=1)
    rows = jnp.asarray(larr)[:, None] - m + jnp.arange(m)[None, :]
    twin = _paged_positional_attention(
        jnp.asarray(q), kk, vv, rows, KP.paged_kv_positions(jt, ps),
        window, 1.0 / np.sqrt(d))
    np.testing.assert_allclose(got, np.asarray(twin), **TOL)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 5)])
def test_gqa_oracle_matches_reference(jref, causal, window):
    jnp, _ = jref
    from repro.kernels.ref import gqa_attention_ref as jax_oracle
    from repro_torch.kernels.ref import gqa_attention_ref
    rng = np.random.RandomState(11)
    q = rng.randn(2, 4, 3, 8).astype(np.float32)
    k = rng.randn(2, 2, 12, 8).astype(np.float32)
    v = rng.randn(2, 2, 12, 8).astype(np.float32)
    got = gqa_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            window=window)
    want = jax_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_full_context_matches_oracle():
    """With every slot of every page live, paged decode is plain causal
    GQA attention over the contiguous context."""
    from repro_torch.kernels.ref import gqa_attention_ref
    from repro_torch.serving import kv_pages as KP
    rng = np.random.RandomState(5)
    b, hq, hkv, d, ps, mp, m = 2, 4, 2, 8, 4, 4, 2
    pk, pv, table = _paged_setup(rng, b, hkv, d, ps, mp, b * mp + 2,
                                 [mp * ps] * b)
    q = _t(rng.randn(b, hq, m, d).astype(np.float32))
    tbl = _t(table)
    got = A.fused_attention_paged(q, _t(pk), _t(pv), tbl,
                                  torch.full((b,), mp * ps), bq=2, bkv=8)
    want = gqa_attention_ref(q, KP.gather_pages(_t(pk), tbl),
                             KP.gather_pages(_t(pv), tbl), causal=True)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the wrapper's guards
# ---------------------------------------------------------------------------

def test_wrapper_raises_over_shared_memory_bound():
    n, d = 1024, 128
    q = torch.zeros(1, 1, 1, d)
    k = torch.zeros(1, 1, n, d)
    assert attention_smem_bytes(1, n, d, d, 4) > H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        A.fused_attention_partial(q, k, k, bq=1, bkv=n)
    A.fused_attention_partial(q, k, k, bq=1, bkv=128)      # fits


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU launches the kernel or raises: on a device
    with no kernel it raises, and where the toolchain or card is
    missing the CUDA launch raises instead of computing anything."""
    q = torch.zeros(1, 2, 1, 8, device="meta")
    k = torch.zeros(1, 1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        A.fused_attention_partial(q, k, k)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launch would run")
    qc, kc = torch.zeros(1, 2, 1, 8), torch.zeros(1, 1, 16, 8)
    pos = torch.arange(16, dtype=torch.int32)
    before = A.fused_attention_partial.launches
    with pytest.raises(RuntimeError):
        A._launch(qc, kc, kc, pos, pos[:1], 1, 16, True, 0, 0.5,
                  attention_smem_bytes(1, 16, 8, 8, 4))
    assert A.fused_attention_partial.launches == before


@pytest.mark.parametrize("bad", ["dtype", "heads", "contig", "pos"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 2, 16, 8)
    kw = {}
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "heads":
        k = torch.zeros(1, 3, 16, 8)
    elif bad == "contig":
        q = torch.zeros(1, 4, 8, 2).transpose(2, 3)
    else:
        kw["kv_pos"] = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        A.fused_attention_partial(q, k, k, **kw)


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,bq,n,bkv,window,per_request", [
    (1, 1, 160, 160, 0, True),     # the slice's decode shape
    (1, 1, 160, 32, 0, True),      # dead row + INVALID_POS slots
    (1, 1, 160, 80, 24, True),     # sliding window
    (8, 4, 96, 32, 0, False),      # M > 1 with bq > 1
    (1, 1, 200, 128, 0, True),     # N not a multiple of the tile
])
def test_kernel_matches_plain_on_card(sm90, dtype, m, bq, n, bkv, window,
                                      per_request):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(n + bkv)
    b, hq, hkv, d = 4, 32, 8, 128
    q = torch.randn(b, hq, m, d, generator=g, device=sm90).to(dt)
    k = torch.randn(b, hkv, n, d, generator=g, device=sm90).to(dt)
    v = torch.randn(b, hkv, n, d, generator=g, device=sm90).to(dt)
    if per_request:
        kv_pos = torch.arange(n, dtype=torch.int32, device=sm90).repeat(b, 1)
        kv_pos[1, 17:40] = A.INVALID_POS
        q_pos = torch.tensor([[n - 1], [90], [-1], [n // 2]],
                             dtype=torch.int32, device=sm90)
    else:
        kv_pos = torch.arange(n, dtype=torch.int32, device=sm90)
        q_pos = n - m + torch.arange(m, dtype=torch.int32, device=sm90)
    before = A.fused_attention_partial.launches
    got = A.fused_attention_partial(q, k, v, kv_pos, q_pos, bq=bq, bkv=bkv,
                                    causal=True, window=window)
    torch.cuda.synchronize()
    assert A.fused_attention_partial.launches == before + 1
    bq_c, bkv_c = A.clamp_tiles(m, n, bq, bkv)
    want = A.fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv_c,
                                           True, window, d ** -0.5)
    tol = TOL if dtype == "float32" else TOL_BF16
    for w, x in zip(want, got):
        torch.testing.assert_close(x, w, **tol)
