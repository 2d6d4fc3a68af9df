"""The port's attention kernel module against the JAX reference.

On the CPU the port's ``fused_attention_partial`` and ``fused_attention``
run their plain versions, held here to the JAX kernels (Pallas interpret
mode) within ``TOL`` on ragged lengths, windows, dead rows (the merge
identity for the partial kernel, the mean of v for the normalised one),
tail offsets and chunked merges; ``api.fuse_attention`` picks the
reference's tiles on the paper's Table III under ``V5E``.  The tests
marked ``sm90`` launch the CUDA kernels and hold them to the plain
versions on the card; they skip everywhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.perf_model import (  # noqa: E402
    H100, attention_partial_smem_bytes, attention_smem_bytes)
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


def _todays_partial_plain(q, k, v, kv_pos, q_pos, bkv, masked, window,
                          scale):
    """The unsplit plain version as it stood before the kv split: one
    online-softmax pass over all kv tiles, dead rows zeroed."""
    o, m_run, l_run = A._online_softmax(q, k, v, kv_pos, q_pos, bkv, masked,
                                        window, scale)
    dead = m_run <= A.NEG_INF * 0.5
    return (torch.where(dead, 0.0, o), m_run,
            torch.where(dead, 0.0, l_run))


def _ragged_paged_batch(rng, b, hq, hkv, m, n, d, short):
    """(q, k, v, kv_pos, q_pos) of a ragged paged batch: request 1 has
    unallocated slots in its context, request 0 is ``short`` tokens long
    so every kv slot past them is masked for its rows."""
    q = rng.randn(b, hq, m, d).astype(np.float32)
    k = rng.randn(b, hkv, n, d).astype(np.float32)
    v = rng.randn(b, hkv, n, d).astype(np.float32)
    kv_pos = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    kv_pos[1, 3:6] = A.INVALID_POS
    lengths = np.full(b, n, np.int32)
    lengths[0] = short
    q_pos = (lengths[:, None] - m + np.arange(m)[None, :]).astype(np.int32)
    return q, k, v, kv_pos, q_pos


@pytest.mark.parametrize("n,bkv,splits,window", [
    (24, 8, 1, 0),      # one split: today's recurrence
    (24, 8, 2, 0),      # uneven: 16 keys, then 8
    (24, 8, 3, 0),      # one tile each
    (32, 8, 3, 5),      # uneven (16, 16, 0 -> two splits) with a window
    (40, 8, 2, 0),      # uneven: 24 keys, then 16
])
def test_partial_plain_splits_match_reference(jref, n, bkv, splits,
                                              window):
    """The split plain version (the kernel's kv split and log-sum-exp
    merge) against the unsplit JAX kernel.  Request 0 is 6 tokens
    long: every split past its first is wholly masked for its rows and
    must add nothing; with one split it equals today's plain version
    bit for bit."""
    jnp, ref = jref
    rng = np.random.RandomState(n + 10 * splits + window)
    m, d = 2, 8
    q, k, v, kv_pos, q_pos = _ragged_paged_batch(rng, 3, 4, 2, m, n, d,
                                                 short=6)
    kw = dict(bkv=bkv, masked=True, window=window, scale=d ** -0.5)
    args = [_t(x) for x in (q, k, v, kv_pos, q_pos)]
    got = A.fused_attention_partial_plain(*args, splits=splits, **kw)
    want = ref.fused_attention_partial(
        *(jnp.asarray(x) for x in (q, k, v, kv_pos, q_pos)), bq=m, bkv=bkv,
        causal=True, window=window, interpret=True)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if splits == 1:
        for w, g in zip(_todays_partial_plain(*args, **kw), got):
            assert torch.equal(w, g)


def test_partial_plain_split_of_a_wholly_masked_row_is_the_identity():
    """A row dead in every split comes out as the merge identity, as
    from the unsplit recurrence; a row dead in some splits only keeps
    its live splits' state."""
    rng = np.random.RandomState(4)
    q, k, v, kv_pos, q_pos = _ragged_paged_batch(rng, 3, 4, 2, 1, 32, 8,
                                                 short=5)
    q_pos[2, 0] = -1                                  # an inactive slot
    args = [_t(x) for x in (q, k, v, kv_pos, q_pos)]
    kw = dict(bkv=8, masked=True, window=0, scale=8 ** -0.5)
    one = A.fused_attention_partial_plain(*args, splits=1, **kw)
    four = A.fused_attention_partial_plain(*args, splits=4, **kw)
    for a, b in zip(one, four):
        torch.testing.assert_close(a, b, **TOL)
    assert not four[0][2].any() and not four[2][2].any()
    assert (four[1][2] == np.float32(A.NEG_INF)).all()


def test_partial_wrapper_runs_the_plain_with_the_kernels_split(monkeypatch):
    seen = []
    plain = A.fused_attention_partial_plain
    monkeypatch.setattr(A, "fused_attention_partial_plain",
                        lambda *a: seen.append(a[-1]) or plain(*a))
    q = torch.zeros(1, 4, 1, 8)
    k = torch.zeros(1, 2, 64, 8)
    A.fused_attention_partial(q, k, k, bq=1, bkv=8, causal=True)
    smem = attention_partial_smem_bytes(1, 8, 8, 8, 4, 2)
    assert seen == [A.partial_splits(1, 2, 1, 64, 8, smem)[0]] == [8]


def test_partial_split_choice_for_the_decode_shapes(port_cache):
    """B=4, Hkv=8, M=1 at the tuner's decode tiles: the kv axis cut into
    whole tiles, none empty, into as many splits as one wave of resident
    blocks (one per SM at these tiles' 142 KB) takes — not into a second
    wave of a few blocks."""
    from repro_torch.core import api
    b, hq, hkv = 4, 32, 8

    def smem(bkv):
        return attention_partial_smem_bytes(1, bkv, 128, 128, 2, hq // hkv)

    assert A.partial_splits(b, hkv, 1, 160, 160, smem(160)) == (1, 1)
    assert A.partial_splits(b, hkv, 1, 4096, 128, smem(128)) == (4, 8)
    assert A.partial_splits(b, hkv, 1, 4096, 16, smem(16)) == (4, 64)
    assert A.partial_splits(64, hkv, 1, 4096, 16, smem(16)) == (1, 256)
    # small blocks share an SM, 8 of 256 threads each: 1024 blocks fit
    assert A.partial_splits(b, hkv, 1, 4096, 64, 20_000) == (32, 2)
    for n in (160, 4096):
        p = api.fuse_attention_paged(1, n, 128, 128, page_size=16,
                                     heads=hq, kv_heads=hkv, batch=b,
                                     dtype="bfloat16").params
        _, bkv = A.clamp_tiles(1, n, p.bq, p.bkv)
        tiles = n // bkv
        splits, per = A.partial_splits(b, hkv, 1, n, bkv, smem(bkv))
        assert (splits - 1) * per < tiles <= splits * per
        assert splits == tiles or b * hkv * splits >= 0.9 * H100.n_sm


@pytest.mark.parametrize("bq,bkv,d,dv,ok", [
    (128, 16, 128, 128, True), (16, 128, 128, 128, True),
    (8, 16, 64, 64, True),           # a padded warp of rows
    (256, 16, 128, 128, False),      # 16 warps: past the register budget
    (128, 24, 128, 128, True),       # padded to 32 inside the kernel
    (100, 100, 128, 128, True),      # a whole N of 100: padded to 112
    (128, 144, 128, 128, False),     # past the kv tile's registers
    (64, 64, 256, 256, True), (64, 80, 256, 256, False),
    (64, 16, 24, 24, False),         # head dim not a multiple of 16
    (64, 16, 272, 272, False),       # head dim past 256
])
def test_attention_tile_rule(bq, bkv, d, dv, ok):
    from repro_torch.core.perf_model import attention_tiles_ok
    assert bool(attention_tiles_ok(bq, bkv, d, dv, 2)) == ok
    assert bool(attention_tiles_ok(bq, bkv, d, dv, 4))     # f32: any tile
    arr = attention_tiles_ok(np.array([bq, 16]), np.array([bkv, 16]), d,
                             dv, 2)
    assert arr.shape == (2,) and bool(arr[0]) == ok


def test_h100_attention_picks_obey_the_kernels_layouts(port_cache):
    """The tuner's H100 picks for the forward's and the decode shapes
    are tiles the kernels take, and Rule 4 charged each exactly the
    shared memory its kernel allocates."""
    from repro_torch.core import api
    from repro_torch.core.perf_model import attention_tiles_ok, rule4_bytes
    fwd = api.fuse_attention(2048, 2048, 128, 128, heads=32, batch=2,
                             dtype="bfloat16", causal=True)
    p = fwd.params
    assert attention_tiles_ok(p.bq, p.bkv, 128, 128, 2)
    assert rule4_bytes(fwd.report.best, H100) == attention_smem_bytes(
        p.bq, p.bkv, 128, 128, 2) <= H100.smem_per_block
    for n in (160, 4096):
        tk = api.fuse_attention_paged(1, n, 128, 128, page_size=16,
                                      heads=32, kv_heads=8, batch=4,
                                      dtype="bfloat16")
        p = tk.params
        assert rule4_bytes(tk.report.best, H100) == \
            attention_partial_smem_bytes(p.bq, p.bkv, 128, 128, 2, 4) \
            <= H100.smem_per_block
        q = torch.zeros(4, 32, 1, 128, dtype=torch.bfloat16)
        k = torch.zeros(4, 8, n, 128, dtype=torch.bfloat16)
        A.fused_attention_partial(q, k, k, bq=p.bq, bkv=p.bkv, causal=True)


@pytest.mark.parametrize("d", [24, 8, 272])
def test_attention_bf16_head_dim_guard(d):
    """The tensor-core kernel takes bf16 head dims that are multiples of
    16 up to 256: the wrapper raises on any other, on the CPU too; f32
    takes them."""
    q = torch.zeros(1, 2, 16, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        A.fused_attention(q, q, q, bq=16, bkv=16)
    A.fused_attention(q.float(), q.float(), q.float(), bq=16, bkv=16)


# (seed, M, window, pages a chunk, case): the case shapes the batch
PAGED_CASES = [
    (0, 1, 0, 0, ""), (1, 1, 6, 0, ""), (2, 4, 11, 0, ""), (3, 1, 0, 2, ""),
    (4, 1, 6, 1, ""),
    (5, 1, 0, 0, "empty"),        # a slot of length 0
    (6, 1, 0, 0, "hole"),         # a page of -1 inside the live range
    (7, 1, 0, 0, "mid_page"),     # lengths that end mid-page
    (8, 1, 5, 0, "window_mid"),   # a window from mid-table, pages before
    #                               it reclaimed
    (9, 4, 0, 2, ""),             # M = 4, two pages a chunk
    (10, 1, 6, 0, "head_slice"),  # two of six kv heads, read in place
]


@pytest.mark.parametrize("seed,m,window,cpp,case", [
    pytest.param(*c, id="-".join(map(str, c[:4])) + (c[4] and f"-{c[4]}"))
    for c in PAGED_CASES])
def test_paged_matches_reference_and_twin(jref, seed, m, window, cpp, case):
    """Ragged lengths, windows across page boundaries, chunked merges,
    an empty slot, a hole in the table, a head slice of the pool: the
    port's paged attention (on the CPU its plain walk of the live pages)
    equals the JAX paged kernel and, on every slot that holds a key,
    the JAX gather twin within TOL (not bitwise — the reference's own
    paged kernel is not bitwise equal to its partial kernel on this
    tree).  An empty slot is zero, as from the JAX kernel."""
    jnp, ref = jref
    from repro.models.layers import _paged_positional_attention
    from repro.serving import kv_pages as KP
    rng = np.random.RandomState(seed)
    b, hq, hkv, d, ps, mp = 3, 4, 2, 8, 4, 5
    lengths = [int(rng.randint(m, mp * ps + 1)) for _ in range(b)]
    lengths = {"empty": [0] + lengths[1:], "hole": [lengths[0], 17, 9],
               "mid_page": [13, 6, 19],
               "window_mid": [18, 20, 7]}.get(case, lengths)
    pool_heads = 6 if case == "head_slice" else hkv
    pk, pv, table = _paged_setup(rng, b, pool_heads, d, ps, mp, b * mp + 2,
                                 lengths)
    if case == "hole":
        table[1, 2] = -1
    if case == "window_mid":      # reclaimed below request 0's window
        table[0, :(lengths[0] - window) // ps] = -1
    q = rng.randn(b, hq, m, d).astype(np.float32)
    larr = np.asarray(lengths, np.int32)
    tk, tv = _t(pk), _t(pv)
    if case == "head_slice":
        tk, tv = tk[:, 2:4], tv[:, 2:4]
        pk, pv = pk[:, 2:4], pv[:, 2:4]
        assert not tk.is_contiguous()
    got = A.fused_attention_paged(_t(q), tk, tv, _t(table), _t(larr), bq=4,
                                  bkv=8, window=window,
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
    live = larr > 0
    np.testing.assert_allclose(got[live], np.asarray(twin)[live], **TOL)
    assert not got[~live].any()


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
# fused_attention (normalised, queries at the tail) vs the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,m,n,d,bq,bkv,causal,window", [
    (1, 4, 4, 64, 64, 16, 32, 32, False, 0),     # MHA, no mask
    (2, 4, 2, 64, 64, 16, 32, 16, True, 0),      # GQA, causal
    (1, 4, 1, 64, 64, 32, 16, 32, True, 24),     # window across tiles
    (1, 2, 2, 32, 96, 16, 16, 32, True, 0),      # M < N: tail offset
    (1, 2, 1, 64, 64, 24, 64, 64, False, 0),     # D not a power of two
    (1, 2, 2, 64, 64, 16, 16, 64, True, 0),      # bq / bkv sweep
    (1, 2, 2, 64, 64, 16, 64, 16, True, 0),
])
def test_attention_plain_matches_reference(jref, b, hq, hkv, m, n, d, bq,
                                           bkv, causal, window):
    jnp, ref = jref
    rng = np.random.RandomState(m + n + bq)
    q = rng.randn(b, hq, m, d).astype(np.float32)
    k = rng.randn(b, hkv, n, d).astype(np.float32)
    v = rng.randn(b, hkv, n, d).astype(np.float32)
    got = A.fused_attention(_t(q), _t(k), _t(v), bq=bq, bkv=bkv,
                            causal=causal, window=window)
    want = ref.fused_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), bq=bq, bkv=bkv,
                               causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_rows_without_keys_get_the_mean_of_v(jref, window):
    """M > N under a causal mask: rows 0 .. M-N-1 have no key at all.
    The JAX kernel accumulates exp(NEG_INF - NEG_INF) = 1 for every key,
    so those rows come out as the mean of v (the partial kernel zeroes
    them instead); the port's normalised kernel must do the same."""
    jnp, ref = jref
    rng = np.random.RandomState(7)
    b, hq, hkv, m, n, d = 1, 4, 2, 48, 16, 16
    q = rng.randn(b, hq, m, d).astype(np.float32)
    k = rng.randn(b, hkv, n, d).astype(np.float32)
    v = rng.randn(b, hkv, n, d).astype(np.float32)
    got = A.fused_attention(_t(q), _t(k), _t(v), bq=16, bkv=8, causal=True,
                            window=window).numpy()
    want = ref.fused_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), bq=16, bkv=8, causal=True,
                               window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    mean_v = np.repeat(v.mean(axis=2), hq // hkv, axis=1)    # (B, Hq, D)
    dead = m - n
    np.testing.assert_allclose(got[:, :, :dead],
                               np.broadcast_to(mean_v[:, :, None],
                                               (b, hq, dead, d)), **TOL)
    assert np.abs(got[:, :, dead:] - mean_v[:, :, None]).max() > 0.1


def test_attention_bf16_matches_reference(jref):
    jnp, ref = jref
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 64, 16).astype(np.float32)
                                ).bfloat16() for _ in range(3))
    got = A.fused_attention(q, k, v, bq=32, bkv=16, causal=True)
    want = ref.fused_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), bq=32, bkv=16, causal=True, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL_BF16)


def test_attention_equals_the_oracle_and_the_model_twins():
    """The three cache-free bodies of one semantics: the kernel's plain
    version, the streaming twin and the naive twin (kv heads repeated)
    against the unfused oracle, causal with a window."""
    from repro_torch.kernels.ref import gqa_attention_ref
    from repro_torch.models.layers import naive_attention, streaming_attention
    rng = np.random.RandomState(9)
    q = _t(rng.randn(2, 4, 32, 16).astype(np.float32))
    k = _t(rng.randn(2, 2, 32, 16).astype(np.float32))
    v = _t(rng.randn(2, 2, 32, 16).astype(np.float32))
    want = gqa_attention_ref(q, k, v, causal=True, window=9)
    torch.testing.assert_close(
        A.fused_attention(q, k, v, bq=8, bkv=8, causal=True, window=9),
        want, **TOL)
    kk, vv = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    kw = dict(causal=True, window=9, scale=0.25)
    torch.testing.assert_close(streaming_attention(q, kk, vv, bkv=8, **kw),
                               want, **TOL)
    torch.testing.assert_close(naive_attention(q, kk, vv, **kw), want,
                               **TOL)


# ---------------------------------------------------------------------------
# the tuner's attention picks
# ---------------------------------------------------------------------------

# Table III (benchmarks/workloads.py): (heads, M, N, K, H)
TABLE_III = {
    "S1": (8, 512, 512, 64, 64), "S2": (12, 512, 512, 64, 64),
    "S3": (16, 512, 512, 64, 64), "S4": (12, 256, 256, 64, 64),
    "S5": (16, 256, 256, 64, 64), "S6": (16, 256, 256, 80, 80),
    "S7": (1, 512, 256, 64, 64), "S8": (1, 768, 384, 64, 64),
    "S9": (1, 1024, 512, 64, 64),
}


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    from repro_torch.core import api
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    api.clear_cache()
    yield tmp_path
    api.clear_cache()


@pytest.mark.parametrize("name", sorted(TABLE_III))
def test_fuse_attention_matches_reference_under_v5e(port_cache, name):
    pytest.importorskip("jax")
    from repro.core import api as ref_api
    from repro_torch.core import api
    from repro_torch.core.perf_model import V5E
    hq, m, n, k, h = TABLE_III[name]
    ref = ref_api.fuse_attention(m, n, k, h, heads=hq)
    got = api.fuse_attention(m, n, k, h, heads=hq, hw=V5E)
    assert got.report.best.key() == ref.report.best.key()
    assert got.params.as_kwargs() == ref.params.as_kwargs()
    assert got.report.best_time == ref.report.best_time


def test_h100_attention_picks_are_launches_the_kernel_takes(port_cache):
    """Table III (f32) and the qwen3-8b forward's attention (bf16,
    causal) under H100: the tuner's tiles divide the dims and fit the
    kernel's shared memory; ``ops.attention`` runs them."""
    from repro_torch.core import api
    shapes = [(1, hq, m, n, k, h, "float32", False)
              for hq, m, n, k, h in TABLE_III.values()]
    shapes.append((2, 32, 2048, 2048, 128, 128, "bfloat16", True))
    for b, hq, m, n, k, h, dtype, causal in shapes:
        p = api.fuse_attention(m, n, k, h, heads=hq, batch=b, dtype=dtype,
                               causal=causal).params
        assert m % p.bq == 0 and n % p.bkv == 0
        assert attention_smem_bytes(p.bq, p.bkv, k, h, 4 if dtype ==
                                    "float32" else 2) <= H100.smem_per_block


def test_ops_attention_runs_the_tuned_tiles(port_cache, monkeypatch):
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gqa_attention_ref
    seen = []
    plain = A.fused_attention_plain
    monkeypatch.setattr(A, "fused_attention_plain",
                        lambda *a: seen.append(a[3]) or plain(*a))
    rng = np.random.RandomState(2)
    q = _t(rng.randn(1, 4, 16, 64).astype(np.float32)).transpose(2, 3)
    assert not q.is_contiguous()
    k = _t(rng.randn(1, 2, 64, 16).astype(np.float32))
    got = ops.attention(q, k, k, causal=True)
    torch.testing.assert_close(got, gqa_attention_ref(q, k, k, causal=True),
                               **TOL)
    tk = api.fuse_attention(64, 64, 16, 16, heads=4, batch=1, causal=True)
    assert seen == [tk.params.bkv]


def test_bf16_attention_at_a_length_no_multiple_of_16(jref, port_cache):
    """bf16 at S = 100, where only the whole 100-key tile passes
    Rule 3: the tuner admits it, the tensor-core kernel takes it (padded
    inside the kernel to 112 keys), and ``ops.attention`` matches the
    JAX kernel at those tiles."""
    s = 100
    from repro_torch.core import api
    from repro_torch.core.perf_model import attention_tiles_ok
    from repro_torch.kernels import ops
    jnp, ref = jref
    rng = np.random.RandomState(s)
    q, k, v = (torch.from_numpy(rng.randn(1, hh, s, 128).astype(np.float32)
                                ).bfloat16() for hh in (4, 2, 2))
    p = api.fuse_attention(s, s, 128, 128, heads=4, batch=1,
                           dtype="bfloat16", causal=True).params
    bq, bkv = A.clamp_tiles(s, s, p.bq, p.bkv)
    assert bkv % 16 and attention_tiles_ok(bq, bkv, 128, 128, 2)
    got = ops.attention(q, k, v, causal=True)
    want = ref.fused_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), bq=bq, bkv=bkv, causal=True, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL_BF16)


# ---------------------------------------------------------------------------
# the wrappers' guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [(24, 16), (16, 24)])
def test_attention_wrapper_raises_on_tiles_that_do_not_divide(tiles):
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="divide"):
        A.fused_attention(q, q, q, bq=tiles[0], bkv=tiles[1])


def test_attention_wrapper_raises_over_shared_memory_bound():
    q = torch.zeros(1, 1, 1024, 128)
    assert attention_smem_bytes(512, 512, 128, 128, 4) > H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        A.fused_attention(q, q, q, bq=512, bkv=512)


def test_attention_has_no_backward():
    """Forward only, like the JAX kernel: an input that requires grad
    under grad mode raises; under no_grad the same call runs."""
    q = torch.zeros(1, 2, 16, 8, requires_grad=True)
    k = torch.zeros(1, 1, 16, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        A.fused_attention(q, k, k, bq=16, bkv=16)
    with torch.no_grad():
        A.fused_attention(q, k, k, bq=16, bkv=16)


def test_attention_non_cpu_tensor_never_takes_the_plain_path():
    q = torch.zeros(1, 2, 16, 8, device="meta")
    k = torch.zeros(1, 1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        A.fused_attention(q, k, k, bq=16, bkv=16)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launch would run")
    qc, kc = torch.zeros(1, 2, 16, 8), torch.zeros(1, 1, 16, 8)
    before = A.fused_attention.launches
    with pytest.raises(RuntimeError):
        A._launch_final(qc, kc, kc, 16, 16, True, 0, 0.5,
                        attention_smem_bytes(16, 16, 8, 8, 4))
    assert A.fused_attention.launches == before


# ---------------------------------------------------------------------------
# the partial wrapper's guards
# ---------------------------------------------------------------------------

def test_wrapper_raises_over_shared_memory_bound():
    n, d = 1024, 128
    q = torch.zeros(1, 1, 1, d)
    k = torch.zeros(1, 1, n, d)
    assert attention_partial_smem_bytes(1, n, d, d, 4, 1) \
        > H100.smem_per_block
    with pytest.raises(ValueError, match="shared"):
        A.fused_attention_partial(q, k, k, bq=1, bkv=n)
    # the 2-stage f32 kv ring of 128-key tiles is past the bound too
    assert attention_partial_smem_bytes(1, 128, d, d, 4, 1) \
        > H100.smem_per_block
    A.fused_attention_partial(q, k, k, bq=1, bkv=64)       # fits


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


def _fit_partial_tiles(dtype, m, n, bq, bkv, d, group):
    """The clamped tiles, bkv halved until the 2-stage kv ring fits (an
    f32 ring holds half the keys of a bf16 one)."""
    bq, bkv = A.clamp_tiles(m, n, bq, bkv)
    while attention_partial_smem_bytes(bq, bkv, d, d, 4 if dtype ==
                                       torch.float32 else 2,
                                       group) > H100.smem_per_block:
        bq, bkv = A.clamp_tiles(m, n, bq, bkv // 2)
    return bq, bkv


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,bq,n,bkv,window,per_request", [
    (1, 1, 160, 160, 0, True),     # the slice's decode shape
    (1, 1, 160, 32, 0, True),      # dead row + INVALID_POS slots
    (1, 1, 160, 80, 24, True),     # sliding window
    (8, 4, 96, 32, 0, False),      # M > 1 with bq > 1
    (1, 1, 200, 128, 0, True),     # N not a multiple of the tile
    (1, 1, 4096, 16, 0, True),     # long decode at the tuner's tile
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
    bq, bkv = _fit_partial_tiles(dt, m, n, bq, bkv, d, hq // hkv)
    before = A.fused_attention_partial.launches
    got = A.fused_attention_partial(q, k, v, kv_pos, q_pos, bq=bq, bkv=bkv,
                                    causal=True, window=window)
    torch.cuda.synchronize()
    assert A.fused_attention_partial.launches == before + 1
    splits, _ = A.partial_splits(
        b, hkv, m // bq, n, bkv,
        attention_partial_smem_bytes(bq, bkv, d, d, q.element_size(),
                                     hq // hkv))
    want = A.fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv,
                                           True, window, d ** -0.5, splits)
    tol = TOL if dtype == "float32" else TOL_BF16
    for w, x in zip(want, got):
        torch.testing.assert_close(x, w, **tol)


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,bkv,splits", [
    (160, 160, 1), (160, 16, 1), (160, 16, 3), (160, 16, 10),
    (4096, 16, 1), (4096, 16, 9), (4096, 128, 1), (4096, 128, 8),
    (4096, 128, 5),                # uneven: 7 tiles a split, the last 4
])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 8, 64),
                                      (32, 4, 128), (48, 1, 128)])
def test_partial_kernel_splits_on_card(sm90, dtype, n, bkv, splits, hq, hkv,
                                       d):
    """The partial kernel at one and several kv splits (each merged by
    the merge kernel) against the plain version with the same splits, on
    a ragged batch with a dead row and a request too short to reach
    most splits; GQA groups 1, 4, 8 and 48 (granite's MQA), head dims 64
    and 128."""
    dt = getattr(torch, dtype)
    b = 4
    g = torch.Generator(device="cuda").manual_seed(n + splits + hq)
    q = torch.randn(b, hq, 1, d, generator=g, device=sm90).to(dt)
    k = torch.randn(b, hkv, n, d, generator=g, device=sm90).to(dt)
    v = torch.randn(b, hkv, n, d, generator=g, device=sm90).to(dt)
    kv_pos = torch.arange(n, dtype=torch.int32, device=sm90).repeat(b, 1)
    kv_pos[1, 17:40] = A.INVALID_POS
    q_pos = torch.tensor([[n - 1], [9], [-1], [n // 2]], dtype=torch.int32,
                         device=sm90)
    bq, bkv = _fit_partial_tiles(dt, 1, n, 1, bkv, d, hq // hkv)
    tiles = n // bkv
    splits = min(splits, tiles)
    per = -(-tiles // splits)
    splits = -(-tiles // per)
    bq, bkv, smem = A._check(q, k, v, kv_pos, q_pos, bq, bkv)
    scale = d ** -0.5
    got = A._launch(q, k, v, kv_pos, q_pos, bq, bkv, True, 0, scale, smem,
                    splits)
    torch.cuda.synchronize()
    want = A.fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv,
                                           True, 0, scale, splits)
    tol = TOL if dtype == "float32" else TOL_BF16
    for w, x in zip(want, got):
        torch.testing.assert_close(x, w, **tol)
    assert not got[0][2].any() and not got[2][2].any()    # the dead row


# The benchmark cells' paged decode shapes: slots, q heads, kv heads read
# (of the pool's), table width; contexts log-uniform over [lo, hi], and
# `empty` slots of length 0
PAGED_CELL_SHAPES = {
    "olmoe-reasoning": dict(b=48, hq=16, hkv=16, pool_hkv=16, mp=256,
                            lo=128, hi=4096, empty=0),
    "qwen3-chat-planned": dict(b=32, hq=32, hkv=8, pool_hkv=8, mp=288,
                               lo=256, hi=4608, empty=11),
    # a rank of four's head slice of the qwen3 pool, read in place
    "qwen3-rank-slice": dict(b=32, hq=8, hkv=2, pool_hkv=8, mp=288, lo=256,
                             hi=4608, empty=11),
}


@pytest.mark.sm90
@pytest.mark.parametrize("cell", sorted(PAGED_CELL_SHAPES))
def test_paged_kernel_matches_plain_at_the_cells_shapes(sm90, monkeypatch,
                                                        cell):
    """The paged kernel at the benchmark cells' decode shapes and the
    tuner's tiles, ragged contexts and empty slots, against its plain
    walk with the same splits; one launch, and no page gathered on the
    way (``gather_pages`` raises)."""
    from repro_torch.core import api
    from repro_torch.serving import kv_pages as KP
    c = PAGED_CELL_SHAPES[cell]
    b, hq, hkv, mp, ps, d = c["b"], c["hq"], c["hkv"], c["mp"], 16, 128
    rng = np.random.RandomState(33)
    lengths = np.exp(rng.uniform(np.log(c["lo"]), np.log(c["hi"]), b)
                     ).astype(np.int32)
    lengths[rng.permutation(b)[:c["empty"]]] = 0
    need = -(-lengths // ps)
    table = np.full((b, mp), -1, np.int32)
    table[np.arange(mp)[None, :] < need[:, None]] = \
        rng.permutation(int(need.sum())) + 1
    g = torch.Generator(device="cuda").manual_seed(33)
    kp, vp = (torch.randn(int(need.sum()) + 1, c["pool_hkv"], ps, d,
                          generator=g, device=sm90).to(torch.bfloat16)
              for _ in range(2))
    if hkv < c["pool_hkv"]:
        kp, vp = kp[:, 2:2 + hkv], vp[:, 2:2 + hkv]
    q = torch.randn(b, hq, 1, d, generator=g, device=sm90).to(torch.bfloat16)
    tbl = torch.from_numpy(table).to(sm90)
    lens = torch.from_numpy(lengths).to(sm90)
    p = api.fuse_attention_paged(1, mp * ps, d, d, page_size=ps, heads=hq,
                                 kv_heads=hkv, batch=b,
                                 dtype="bfloat16").params

    def no_gather(*_):
        raise AssertionError("the kernel path gathered pages")

    monkeypatch.setattr(KP, "gather_pages", no_gather)
    before = A.fused_attention_partial.launches
    got = A.fused_attention_paged(q, kp, vp, tbl, lens, bq=p.bq, bkv=p.bkv)
    torch.cuda.synchronize()
    assert A.fused_attention_partial.launches == before + 1
    _, bkv, smem = A._check_paged(q, kp, vp, tbl, lens, p.bq, p.bkv,
                                  mp * ps)
    splits = A.paged_splits(b, hkv, 1, mp * ps // bkv, bkv, smem)
    o, _, l_run = A.fused_attention_paged_plain(q, kp, vp, tbl, lens, bkv, 0,
                                                d ** -0.5, splits)
    want = (o / torch.where(l_run == 0.0, 1.0, l_run)).to(q.dtype)
    torch.testing.assert_close(got, want, **TOL_BF16)
    assert not got[torch.from_numpy(lengths == 0).to(sm90)].any()


@pytest.mark.sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,m,n,d,bq,bkv,causal,window", [
    (2, 32, 8, 2048, 2048, 128, 128, 16, True, 0),  # the forward's shape
    (2, 8, 2, 100, 100, 128, 100, 100, True, 0),    # N = 100: padded tile
    (1, 8, 2, 240, 240, 64, 48, 24, True, 60),      # 24-key tiles, window
    (1, 8, 2, 1000, 1000, 128, 40, 100, True, 0),   # ten 100-key tiles
    (1, 4, 2, 120, 40, 64, 40, 40, True, 0),        # M > N, padded tile
    (2, 32, 8, 2048, 2048, 128, 64, 64, True, 0),   # around the pick
    (1, 32, 8, 1024, 1024, 128, 128, 128, True, 0),
    (1, 32, 4, 256, 256, 128, 128, 32, True, 0),    # GQA group 8
    (1, 12, 12, 512, 512, 64, 128, 128, False, 0),  # S2 (Bert-Base)
    (1, 16, 16, 256, 256, 80, 16, 256, False, 0),   # S6 (ViT-Huge)
    (1, 8, 2, 256, 256, 64, 32, 64, True, 100),     # window: skipped tiles
    (1, 8, 2, 512, 512, 128, 128, 16, False, 48),   # window (causal too)
    (1, 8, 2, 512, 512, 64, 64, 16, True, 200),     # window, 4-tile stages
    (1, 4, 2, 128, 384, 64, 64, 32, True, 0),       # M < N: tail offset
    (1, 4, 2, 192, 64, 64, 64, 32, True, 0),        # M > N: mean of v rows
    (1, 4, 2, 24, 64, 64, 24, 16, True, 0),         # padded rows (bq 24)
    (1, 4, 2, 128, 128, 256, 64, 32, True, 0),      # head dim 256
    (1, 4, 2, 128, 128, 256, 32, 64, True, 0),
])
def test_fused_attention_kernel_matches_plain_on_card(
        sm90, dtype, b, hq, hkv, m, n, d, bq, bkv, causal, window):
    from repro_torch.core.perf_model import attention_tiles_ok
    dt = getattr(torch, dtype)
    if dt == torch.float32:
        while attention_smem_bytes(bq, bkv, d, d, 4) > H100.smem_per_block:
            bq //= 2                   # the f32 tiles of the same shape
    else:
        bkv = min(bkv, 128)            # S6's 256 is past the bf16 kernel's
        assert attention_tiles_ok(bq, bkv, d, d, 2)
    g = torch.Generator(device="cuda").manual_seed(m + n + d)
    q = torch.randn(b, hq, m, d, generator=g, device=sm90).to(dt)
    k = torch.randn(b, hkv, n, d, generator=g, device=sm90).to(dt)
    v = torch.randn(b, hkv, n, d, generator=g, device=sm90).to(dt)
    before = A.fused_attention.launches
    with torch.no_grad():
        got = A.fused_attention(q, k, v, bq=bq, bkv=bkv, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before + 1
    want = A.fused_attention_plain(q, k, v, bkv, causal or window > 0,
                                   window, d ** -0.5)
    torch.testing.assert_close(got, want,
                               **(TOL if dtype == "float32" else TOL_BF16))
