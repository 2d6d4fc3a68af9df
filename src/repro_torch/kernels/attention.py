"""Fused attention: the CUDA kernels ``fused_attention`` (cache-free
forward, queries at the tail of the kv sequence) and
``fused_attention_partial`` (one kv shard's raw online-softmax state),
both in ``csrc/attention_partial.cu``, their plain PyTorch versions, and
``fused_attention_paged`` around the partial kernel for paged decode.

The attention chain  S = Q K^T ; P = softmax(S) ; O = P V  streams the
kv axis with an online softmax, so the score tile never reaches device
memory.  The block sizes (bq, bkv) come from MCFuser's analytical
search for each concrete shape (``core.api.fuse_attention`` /
``fuse_attention_paged``).

``fused_attention`` takes the JAX kernel's stitching hooks,
``q_prologue`` / ``k_prologue`` on the q and k tiles before the scores'
``* scale`` and ``o_epilogue`` on the normalised o, as
``hooks.Elementwise`` expressions; the partial and paged entries take
none, as in the JAX package.

A CUDA tensor launches the kernel or raises; only a CPU tensor runs the
plain version, which is the same recurrence over kv blocks of ``bkv``
in torch ops (for the partial kernel, over the same kv splits, merged
by the same log-sum-exp combine; for the paged entry, over the same
pages of each request, in the same splits).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.perf_model import (H100, attention_partial_smem_bytes,
                               attention_smem_bytes, attention_tiles_ok)
from . import hooks

NEG_INF = -1e30
# Sentinel "position" for unallocated / out-of-range paged-KV slots:
# larger than any real position, so the (always-on) causal mask of the
# paged kernel rejects the slot for every query row.
INVALID_POS = 1 << 30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def clamp_tiles(m: int, n: int, bq: int, bkv: int) -> tuple[int, int]:
    """The JAX kernel's tile clamp: tiles no larger than the dims, then
    shrunk until they divide them, so the port runs the tiles the tuner
    priced."""
    bq, bkv = min(bq, m), min(bkv, n)
    while m % bq:
        bq -= 1
    while n % bkv:
        bkv -= 1
    return bq, bkv


def _check_qkv(q, k, v, *others):
    """Raise on q/k/v the CUDA kernels do not take (``others``: further
    tensors that must share their device)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, H, L, D)")
    b, hq, m, d = q.shape
    _, hkv, n, dv = v.shape
    if k.shape != (b, hkv, n, d) or v.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} q-heads do not group over {hkv} kv-heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or dv % 8:
        raise ValueError(f"head dims must be multiples of 8, got {d}/{dv}")
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    devices = {t.device for t in (q, k, v, *others)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _fits(smem: int, bq: int, bkv: int) -> int:
    """``smem``; raises past the block's limit."""
    if smem > H100.smem_per_block:
        raise ValueError(f"tiles bq={bq} bkv={bkv} need {smem} B of shared "
                         f"memory per block > {H100.smem_per_block}")
    return smem


def _smem(bq: int, bkv: int, q, v) -> int:
    """The normalised kernel's shared-memory bytes at these tiles;
    raises on a bf16 head dim or tile the tensor-core kernel does not
    take and past the block's limit."""
    d, dv = q.shape[3], v.shape[3]
    if q.dtype == torch.bfloat16:
        if d % 16 or dv % 16 or d > 256 or dv > 256:
            raise ValueError(f"bf16 head dims must be multiples of 16 up to "
                             f"256, got {d}/{dv}")
        if not attention_tiles_ok(bq, bkv, d, dv, 2):
            raise ValueError(f"tiles bq={bq} bkv={bkv} are not tiles of the "
                             f"bf16 kernel (bq <= 128, bkv up to the "
                             f"register bound)")
    return _fits(attention_smem_bytes(bq, bkv, d, dv, q.element_size()),
                 bq, bkv)


def _check(q, k, v, kv_pos, q_pos, bq, bkv):
    """Raise on anything the partial kernel does not take; returns the
    clamped tiles and their shared-memory bytes."""
    _check_qkv(q, k, v, kv_pos, q_pos)
    b, hq, m, d = q.shape
    hkv, n, dv = v.shape[1], v.shape[2], v.shape[3]
    if kv_pos.shape not in ((n,), (b, n)) or q_pos.shape not in ((m,),
                                                                 (b, m)):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} must be (N,)|(B,N) and "
                         f"(M,)|(B,M)")
    bq, bkv = clamp_tiles(m, n, bq, bkv)
    smem = attention_partial_smem_bytes(bq, bkv, d, dv, q.element_size(),
                                        hq // hkv)
    return bq, bkv, _fits(smem, bq, bkv)


#: threads of one partial-kernel block (``kPartialThreads``)
PARTIAL_THREADS = 256
#: a partial-kernel block's fixed cost in keys of kv work, fitted to a
#: sweep of split counts on an H100 (B=4, Hkv=8, N=4096, bf16: 1/16 and
#: 1/128 tiles): a second wave of a few blocks, or many short blocks,
#: each lost to one wave of long ones
SPLIT_OVERHEAD_KEYS = 64


def _resident_blocks(smem: int, hw=H100) -> int:
    """Partial-kernel blocks of ``smem`` bytes the card runs at once:
    as many on each SM as its shared memory and threads hold."""
    per_sm = min(hw.smem_per_sm // (smem + hw.smem_reserved),
                 hw.threads_per_sm // PARTIAL_THREADS)
    return hw.n_sm * max(1, per_sm)


def partial_splits(batch: int, hkv: int, q_tiles: int, n: int, bkv: int,
                   smem: int, hw=H100) -> tuple[int, int]:
    """(splits, kv tiles per split) of the partial kernel over ``n``
    keys in tiles of ``bkv``: each split a run of whole tiles, none
    empty (the last may be shorter).  The grid has batch x kv heads x q
    tiles x splits blocks, of which ``slots`` run at once (as many as
    the SMs' shared memory and threads hold).  A split count costs the
    waves it needs times the keys of its longest split plus
    ``SPLIT_OVERHEAD_KEYS`` (a block's fixed work: q in, state out, its
    share of the merge); the cheapest count wins, the fewest splits
    among equals."""
    kv_tiles = n // bkv
    blocks = batch * hkv * q_tiles
    slots = _resident_blocks(smem, hw)

    def cost(s):
        waves = -(-blocks * s // slots)
        return waves * (-(-kv_tiles // s) * bkv + SPLIT_OVERHEAD_KEYS), s

    best = min(range(1, kv_tiles + 1), key=cost)
    per = -(-kv_tiles // best)
    return -(-kv_tiles // per), per


def _check_aligned(*ts):
    """The kernels copy k and v (and the tensor-core kernel q) in 16-byte
    steps from their first element."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("q, k and v must start on a 16-byte boundary")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 128, bkv: int = 128, causal: bool = False,
                    window: int = 0, scale: Optional[float] = None,
                    q_prologue: Optional[hooks.Elementwise] = None,
                    k_prologue: Optional[hooks.Elementwise] = None,
                    o_epilogue: Optional[hooks.Elementwise] = None
                    ) -> torch.Tensor:
    """O = softmax(Q K^T * scale + mask) V, fused, GQA-aware.

    q: (B, Hq, M, D), k/v: (B, Hkv, N, D/Dv), float32 or bfloat16;
    Hq % Hkv == 0.  Queries sit at the *tail* of the kv sequence: row r
    has position N - M + r, kv slot j position j.  ``window > 0`` is
    sliding-window attention.  Returns (B, Hq, M, Dv) in q's type.  The
    tiles, clamped to the dims, must divide M and N, as the JAX kernel
    asserts.  A row with no key (N < M under a causal mask) gets the
    mean of v, as the JAX kernel gives it.  bf16 runs on tensor cores,
    which take head dims that are multiples of 16 up to 256 and the
    tiles of ``perf_model.attention_tiles_ok``; anything else raises,
    on the CPU too.  ``q_prologue`` / ``k_prologue`` run on q and k
    (each rounded to its type) before the scores, ``o_epilogue`` on the
    f32 o / l before the cast, rows with no key included.

    Forward only, like the JAX kernel: with grad mode on and an input
    that requires grad it raises rather than return a tensor without a
    backward.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("fused_attention has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    hks = tuple(hooks.check(h, name) for h, name in (
        (q_prologue, "q_prologue"), (k_prologue, "k_prologue"),
        (o_epilogue, "o_epilogue")))
    _check_qkv(q, k, v)
    m, d, n = q.shape[2], q.shape[3], k.shape[2]
    bq, bkv = min(bq, m), min(bkv, n)
    if bq < 1 or bkv < 1 or m % bq or n % bkv:
        raise ValueError(f"tiles (bq, bkv) = ({bq}, {bkv}) must divide "
                         f"(M, N) = ({m}, {n})")
    smem = _smem(bq, bkv, q, v)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    masked = causal or window > 0
    dev = q.device
    if dev.type == "cpu":
        return fused_attention_plain(q, k, v, bkv, masked, window, scale,
                                     *hks)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch_final(q, k, v, bq, bkv, masked, window, scale, smem, hks)


def _launch_final(q, k, v, bq, bkv, masked, window, scale, smem,
                  hks=(None, None, None)):
    from . import _build

    lib = _build.load("attention_partial")
    _check_aligned(q, k, v)
    fn = lib.attn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 11 + [ctypes.c_float,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p]
                   + [hooks.HookStruct] * 3)
    b, hq, m, d = q.shape
    hkv, n, dv = v.shape[1], v.shape[2], v.shape[3]
    o = torch.empty((b, hq, m, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), b, hq, hkv, m, n, d, dv, bq, bkv,
             int(masked), int(window), float(scale), int(smem), stream,
             *(hooks.as_c(h) for h in hks))
    _build.check_launch(lib, "attn_launch", err, "attn_error_string")
    fused_attention.launches += 1
    hooks.note(fused_attention, *hks)
    return o


fused_attention.launches = 0
fused_attention.hooked = {}   # hooked launches by (q, k, o) hook key


def fused_attention_plain(q, k, v, bkv: int, masked: bool, window: int,
                          scale: float,
                          q_prologue: Optional[hooks.Elementwise] = None,
                          k_prologue: Optional[hooks.Elementwise] = None,
                          o_epilogue: Optional[hooks.Elementwise] = None
                          ) -> torch.Tensor:
    """``fused_attention``'s plain PyTorch version: the online-softmax
    recurrence over kv blocks of ``bkv`` with the query rows at the tail
    (``_online_softmax``), then o / l with l == 0 -> 1, in q's type.
    Rows with no key keep the mean of v, as kernel and JAX kernel do.
    The hooks as the kernel runs them: the prologues on q and k before
    the scores, the epilogue on the f32 o / l."""
    q, k = hooks.apply(q_prologue, q), hooks.apply(k_prologue, k)
    m, n = q.shape[2], k.shape[2]
    kv_pos = torch.arange(n, dtype=torch.int32, device=q.device)
    q_pos = n - m + torch.arange(m, dtype=torch.int32, device=q.device)
    o, _, l_run = _online_softmax(q, k, v, kv_pos, q_pos, bkv, masked,
                                  window, scale)
    o = o / torch.where(l_run == 0.0, 1.0, l_run)
    return hooks.apply(o_epilogue, o).to(q.dtype)


def fused_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            kv_pos: Optional[torch.Tensor] = None,
                            q_pos: Optional[torch.Tensor] = None,
                            bq: int = 128, bkv: int = 128,
                            causal: bool = False, window: int = 0,
                            scale: Optional[float] = None):
    """One shard's partial softmax-attention over its local kv slice.

    q: (B, Hq, M, D), k/v: (B, Hkv, N, D/Dv), float32 or bfloat16.
    ``kv_pos`` holds the GLOBAL position of each local kv slot — (N,)
    shared across the batch (default ``arange``) or (B, N) per request
    (the paged layout).  ``q_pos`` likewise is the global position of
    each query row, (M,) or (B, M), default ``arange``.
    Returns ``(o_unnorm, m_run, l_run)``::

        o_unnorm (B, Hq, M, Dv) f32 = sum_n exp(s_n - m_run) * v_n
        m_run    (B, Hq, M, 1)  f32 = running max of masked scores
        l_run    (B, Hq, M, 1)  f32 = sum_n exp(s_n - m_run)

    Rows entirely masked within this shard come back as
    ``(0, NEG_INF, 0)`` — the identity of ``merge_partials``.

    The kernel cuts the kv axis into ``partial_splits`` runs of whole
    ``bkv`` tiles, one block each per kv head, and merges them; the
    plain version on a CPU tensor takes the same splits.
    """
    b, hq, m, d = q.shape
    n = k.shape[2]
    dev = q.device
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if kv_pos is None:
        kv_pos = torch.arange(n, dtype=torch.int32, device=dev)
    if q_pos is None:
        q_pos = torch.arange(m, dtype=torch.int32, device=dev)
    kv_pos = kv_pos.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    bq, bkv, smem = _check(q, k, v, kv_pos, q_pos, bq, bkv)
    masked = causal or window > 0
    splits, _ = partial_splits(b, k.shape[1], m // bq, n, bkv, smem)
    if dev.type == "cpu":
        return fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv,
                                             masked, window, scale, splits)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch(q, k, v, kv_pos, q_pos, bq, bkv, masked, window, scale,
                   smem, splits)


fused_attention_partial.launches = 0


def _launch(q, k, v, kv_pos, q_pos, bq, bkv, masked, window, scale, smem,
            splits=1):
    from . import _build

    lib = _build.load("attention_partial")
    _check_aligned(k, v)
    fn = lib.attn_partial_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 15 + [ctypes.c_float,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p])
    b, hq, m, d = q.shape
    _, hkv, n, dv = v.shape
    tiles = n // bkv
    per = -(-tiles // splits)
    outs, parts = _partial_outputs(q, dv, splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
             *_pointers(outs, parts), b, hq, hkv, m, n, d, dv, bq, bkv,
             splits, per, n if kv_pos.ndim == 2 else 0,
             m if q_pos.ndim == 2 else 0, int(masked), int(window),
             float(scale), int(smem), stream)
    _build.check_launch(lib, "attn_partial_launch", err, "attn_error_string")
    fused_attention_partial.launches += 1
    return outs


def _partial_outputs(q, dv: int, splits: int):
    """The partial kernel's f32 outputs ``(o, m_run, l_run)`` for q's
    rows, and the splits' raw states the merge reads (none with one
    split)."""
    b, hq, m, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = (torch.empty((b, hq, m, dv), **f32),
            torch.empty((b, hq, m, 1), **f32),
            torch.empty((b, hq, m, 1), **f32))
    parts = [torch.empty((splits, b * hq * m, dv), **f32),
             torch.empty((splits, b * hq * m), **f32),
             torch.empty((splits, b * hq * m), **f32)] if splits > 1 else []
    return outs, parts


def _pointers(outs, parts):
    """The six output pointers of a partial launch (null scratch with
    one split)."""
    return [t.data_ptr() for t in outs] + (
        [t.data_ptr() for t in parts] or [None] * 3)


def _online_softmax(q, k, v, kv_pos, q_pos, bkv: int, masked: bool,
                    window: int, scale: float):
    """The kernels' recurrence in torch ops: f32 scores over kv blocks
    of ``bkv``, masked from the positions with NEG_INF, running max and
    sum in f32, P rounded to v's type before P V.  Returns the raw
    (o, m_run, l_run); rows with no key end with l = the keys' count
    and o = their sum of v (exp(NEG_INF - NEG_INF) = 1 per key).
    ``kv_pos``/``q_pos`` are int32 (N,)|(B, N) and (M,)|(B, M)."""
    b, hq, m, _ = q.shape
    hkv, n, dv = v.shape[1], v.shape[2], v.shape[3]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    rows = q_pos.reshape(-1, 1, m, 1)
    cols_all = kv_pos.reshape(-1, 1, 1, n)
    qf = q.float()
    o = torch.zeros((b, hq, m, dv), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, hq, m, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, hq, m, 1), dtype=torch.float32, device=q.device)
    for j0 in range(0, n, bkv):
        s = torch.einsum("bhmd,bhnd->bhmn", qf,
                         kk[:, :, j0:j0 + bkv].float()) * scale
        if masked:
            cols = cols_all[..., j0:j0 + bkv]
            keep = cols <= rows
            if window > 0:
                keep &= cols > rows - window
            s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum(
            "bhmn,bhnv->bhmv", p.to(v.dtype).float(),
            vv[:, :, j0:j0 + bkv].float())
        m_run = m_new
    return o, m_run, l_run


def fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv: int,
                                  masked: bool, window: int, scale: float,
                                  splits: int = 1):
    """The partial kernel's plain PyTorch version: ``_online_softmax``
    over each of ``splits`` runs of whole ``bkv`` tiles (as many tiles
    each, the last run shorter), the runs' raw states merged in order
    with the log-sum-exp combine as the kernel merges them, and rows
    dead across the shard zeroed at the end (a run in which a row is
    wholly masked weighs exp(NEG_INF - m) = 0 against a live one).
    ``kv_pos``/``q_pos`` are int32 (N,)|(B, N) and (M,)|(B, M)."""
    n = k.shape[2]
    step = -(-(n // bkv) // splits) * bkv
    return _merge_splits([
        _online_softmax(q, k[:, :, j:j + step], v[:, :, j:j + step],
                        kv_pos[..., j:j + step], q_pos, bkv, masked,
                        window, scale)
        for j in range(0, n, step)])


def _merge_splits(states):
    """The splits' raw states combined as the merge kernel combines
    them (the max over the splits, then each weighed by exp(m_s - max)
    in split order; one split as it is), and rows dead across them all
    zeroed."""
    if len(states) == 1:
        o, m_run, l_run = states[0]
    else:
        m_run = states[0][1]
        for _, m_s, _ in states[1:]:
            m_run = torch.maximum(m_run, m_s)
        o = torch.zeros_like(states[0][0])
        l_run = torch.zeros_like(m_run)
        for o_s, m_s, l_s in states:
            w = torch.exp(m_s - m_run)
            o = o + o_s * w
            l_run = l_run + l_s * w
    dead = m_run <= NEG_INF * 0.5
    return (torch.where(dead, 0.0, o), m_run,
            torch.where(dead, 0.0, l_run))


#: bf16 keys a stage of the paged kernel's kv ring holds: half the
#: unpaged kernel's, so that three blocks share an SM at the decode
#: tiles (a sweep on an H100 at the benchmark cells' shapes: 128 keys
#: took 1.7x (olmoe) and 1.3x (qwen3) the time of 64; 48 as 64, 32
#: and 96 slower)
PAGED_STAGE_KEYS = 64


def paged_splits(batch: int, hkv: int, q_tiles: int, tiles: int,
                 bkv: int, smem: int, hw=H100) -> int:
    """The split count of the paged kernel over a chunk of ``tiles`` kv
    tiles of ``bkv`` keys, from static shapes alone (a captured decode
    step replays it whatever the lengths).  Each block takes an equal
    share of its request's live tiles, so a count costs the work of
    every block spread over the ``slots`` resident at once (all tiles
    live, each block with its fixed ``SPLIT_OVERHEAD_KEYS``) plus the
    longest block, a whole request's share, which runs on after the
    rest; the cheapest count wins, the fewest splits among equals."""
    blocks = batch * hkv * q_tiles
    slots = _resident_blocks(smem, hw)

    def cost(s):
        work = blocks * s * (-(-tiles // s) * bkv + SPLIT_OVERHEAD_KEYS)
        return work / slots + -(-tiles // s) * bkv, s

    return min(range(1, tiles + 1), key=cost)


def _check_paged(q, k_pages, v_pages, page_table, lengths, bq, bkv, n):
    """Raise on anything the paged kernel does not take: the pools
    (n_pages, Hkv, page_size, D/Dv) in q's type, each page's rows
    contiguous, their page and head strides whole 16-byte steps (a slice
    of kv heads is read in place); an int32 table whose rows are
    contiguous; int32 lengths, one a request.  Returns the tiles,
    clamped to (M, n), and their shared-memory bytes."""
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.ndim != 4:
        raise ValueError("q must be (B, H, M, D) and the pools (n_pages, "
                         "Hkv, page_size, D)")
    b, hq, m, d = q.shape
    n_pages, hkv, ps, dv = v_pages.shape
    if k_pages.shape != (n_pages, hkv, ps, d):
        raise ValueError(f"k_pages {tuple(k_pages.shape)} / v_pages "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} q-heads do not group over {hkv} kv-heads")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q and the pools must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if d % 8 or dv % 8:
        raise ValueError(f"head dims must be multiples of 8, got {d}/{dv}")
    size = q.element_size()
    for t, w in ((k_pages, d), (v_pages, dv)):
        if t.stride(3) != 1 or t.stride(2) != w \
                or (t.stride(0) * size) % 16 or (t.stride(1) * size) % 16:
            raise ValueError(f"a pool's pages must hold contiguous rows at "
                             f"16-byte strides, got {t.stride()}")
    if page_table.ndim != 2 or page_table.shape[0] != b \
            or page_table.dtype != torch.int32 or page_table.stride(1) != 1:
        raise ValueError(f"page_table must be (B, max_pages) int32 with "
                         f"contiguous rows, got {tuple(page_table.shape)} "
                         f"{page_table.dtype}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 \
            or lengths.stride(0) != 1:
        raise ValueError(f"lengths must be (B,) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    bq, bkv = clamp_tiles(m, n, bq, bkv)
    smem = attention_partial_smem_bytes(bq, bkv, d, dv, size, hq // hkv,
                                        PAGED_STAGE_KEYS)
    return bq, bkv, _fits(smem, bq, bkv)


def fused_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, bq: int = 128,
                          bkv: int = 128, window: int = 0,
                          scale: Optional[float] = None,
                          pages_per_chunk: int = 0) -> torch.Tensor:
    """Fused attention over a paged KV cache, read where it lies.

    q: (B, Hq, M, D) — request b's query rows sit at the TAIL of its
    context, global positions ``lengths[b]-M .. lengths[b]-1``
    (attention is causal by construction).  k_pages/v_pages:
    (n_pages, Hkv, page_size, D/Dv), the shared page pool
    (``serving.kv_pages``), or a slice of its kv heads (read in place
    with its strides); page_table: (B, max_pages) int32 physical page
    per logical page, -1 = unallocated; lengths: (B,) int32.

    Each chunk of ``pages_per_chunk`` table columns (the whole table at
    0) is one launch of the partial kernel's paged instantiation, which
    walks the chunk's columns on the card: a request reads only the
    pages ``kv_pages.walked_pages`` names (none at length 0), each
    from the pool, and its keys take their positions from their logical
    page; a page of -1 in that range is not read, its keys masked.  The
    split count comes from static shapes (``paged_splits``), the splits
    share each request's tiles on the card, so no length is read on the
    host and a captured step stays valid.  Chunk states merge with the
    log-sum-exp combine (``dist.ring_dispatch.merge_partials``).  On a
    CPU tensor the plain version walks the same pages in the same
    splits; on a CUDA tensor the kernel launches or this raises.
    """
    from ..dist.ring_dispatch import finalize_partials, merge_partials

    b, _, m, d = q.shape
    q = q.contiguous()
    # no-ops on the engine's int32 inputs (a copy would be a new tensor
    # of every captured step)
    page_table = page_table.to(torch.int32)
    lengths = lengths.to(torch.int32).contiguous()
    ps, max_pages = k_pages.shape[2], page_table.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    cpp = (pages_per_chunk if 0 < pages_per_chunk < max_pages
           else max_pages)
    bq, bkv, smem = _check_paged(q, k_pages, v_pages, page_table, lengths,
                                 bq, bkv, cpp * ps)
    splits = paged_splits(b, k_pages.shape[1], m // bq, -(-cpp * ps // bkv),
                          bkv, smem)
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    state = None
    for c0 in range(0, max_pages, cpp):
        tbl = page_table[:, c0:c0 + cpp]
        if dev.type == "cpu":
            part = fused_attention_paged_plain(
                q, k_pages, v_pages, tbl, lengths, bkv, window, scale,
                splits, first_page=c0)
        else:
            part = _launch_paged(q, k_pages, v_pages, tbl, lengths, c0, bq,
                                 bkv, window, scale, smem, splits)
        state = part if state is None else merge_partials(state, part)
    o, _, l_run = state
    return finalize_partials(o, l_run, q.dtype)


def _launch_paged(q, k_pages, v_pages, table, lengths, first_page, bq,
                  bkv, window, scale, smem, splits):
    """One launch of the paged kernel over the table columns ``table``
    (a view of the whole table from column ``first_page`` on)."""
    from . import _build

    lib = _build.load("attention_partial")
    _check_aligned(k_pages, v_pages)
    fn = lib.attn_partial_paged_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 13 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_longlong,
                                           ctypes.c_void_p])
    b, hq, m, d = q.shape
    _, hkv, ps, dv = v_pages.shape
    outs, parts = _partial_outputs(q, dv, splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), table.data_ptr(), lengths.data_ptr(),
             *_pointers(outs, parts),
             b, hq, hkv, m, d, dv, bq, bkv, splits, table.stride(0),
             table.shape[1], first_page, ps, k_pages.stride(0),
             k_pages.stride(1), v_pages.stride(0), v_pages.stride(1),
             PAGED_STAGE_KEYS, int(window), float(scale), int(smem), stream)
    _build.check_launch(lib, "attn_partial_paged_launch", err,
                        "attn_error_string")
    fused_attention_partial.launches += 1
    return outs


def fused_attention_paged_plain(q, k_pages, v_pages, page_table, lengths,
                                bkv: int, window: int, scale: float,
                                splits: int = 1, first_page: int = 0):
    """The paged kernel's plain PyTorch version over one chunk of table
    columns (``page_table``, logical pages ``first_page`` on): for each
    request the pages ``kv_pages.walked_pages`` names, cut into tiles of
    ``bkv`` keys from the first one's first key, shared by ``splits``
    as the kernel shares them; each split's keys taken from the pool
    (zeros and ``INVALID_POS`` where the walk reads no page) through
    ``_online_softmax``, the splits merged as the merge kernel merges
    them.  Returns the raw ``(o, m_run, l_run)``, dead rows the merge
    identity."""
    from ..serving.kv_pages import walked_pages

    b, hq, m, _ = q.shape
    ps, pages = k_pages.shape[2], page_table.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    out = [torch.zeros((b, hq, m, v_pages.shape[3]), **f32),
           torch.full((b, hq, m, 1), NEG_INF, **f32),
           torch.zeros((b, hq, m, 1), **f32)]
    for i, length in enumerate(lengths.tolist()):
        lo, hi = walked_pages(length, ps, window, m)
        lo, hi = max(lo, first_page), min(hi, first_page + pages)
        tiles = -(-max(0, hi - lo) * ps // bkv)
        q_pos = length - m + torch.arange(m, dtype=torch.int32,
                                          device=q.device)[None]
        states = []
        for s in range(splits):
            t0, t1 = s * tiles // splits, (s + 1) * tiles // splits
            if t1 == t0:
                continue
            pos = lo * ps + torch.arange(t0 * bkv, t1 * bkv,
                                         dtype=torch.int32, device=q.device)
            phys = page_table[i, (pos // ps - first_page).clamp(
                max=pages - 1).long()]
            live = (pos < hi * ps) & (phys >= 0)
            idx, off = phys.clamp(min=0).long(), (pos % ps).long()
            kk, vv = (torch.where(live[:, None, None], t[idx, :, off], 0)
                      .transpose(0, 1)[None] for t in (k_pages, v_pages))
            kv_pos = torch.where(live, pos, INVALID_POS)[None]
            states.append(_online_softmax(q[i:i + 1], kk, vv, kv_pos, q_pos,
                                          bkv, True, window, scale))
        if states:
            for t, x in zip(out, _merge_splits(states)):
                t[i] = x[0]
    return tuple(out)
