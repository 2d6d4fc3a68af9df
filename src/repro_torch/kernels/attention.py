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

A CUDA tensor launches the kernel or raises; only a CPU tensor runs the
plain version, which is the same recurrence over kv blocks of ``bkv``
in torch ops (for the partial kernel, over the same kv splits, merged
by the same log-sum-exp combine).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.perf_model import (H100, attention_partial_smem_bytes,
                               attention_smem_bytes, attention_tiles_ok)

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
    per_sm = min(hw.smem_per_sm // (smem + hw.smem_reserved),
                 hw.threads_per_sm // PARTIAL_THREADS)
    slots = hw.n_sm * max(1, per_sm)

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
                    window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
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
    on the CPU too.

    Forward only, like the JAX kernel: with grad mode on and an input
    that requires grad it raises rather than return a tensor without a
    backward.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("fused_attention has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")
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
        return fused_attention_plain(q, k, v, bkv, masked, window, scale)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch_final(q, k, v, bq, bkv, masked, window, scale, smem)


def _launch_final(q, k, v, bq, bkv, masked, window, scale, smem):
    from . import _build

    lib = _build.load("attention_partial")
    _check_aligned(q, k, v)
    fn = lib.attn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 11 + [ctypes.c_float,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p])
    b, hq, m, d = q.shape
    hkv, n, dv = v.shape[1], v.shape[2], v.shape[3]
    o = torch.empty((b, hq, m, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), b, hq, hkv, m, n, d, dv, bq, bkv,
             int(masked), int(window), float(scale), int(smem), stream)
    _build.check_launch(lib, "attn_launch", err, "attn_error_string")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0


def fused_attention_plain(q, k, v, bkv: int, masked: bool, window: int,
                          scale: float) -> torch.Tensor:
    """``fused_attention``'s plain PyTorch version: the online-softmax
    recurrence over kv blocks of ``bkv`` with the query rows at the tail
    (``_online_softmax``), then o / l with l == 0 -> 1, in q's type.
    Rows with no key keep the mean of v, as kernel and JAX kernel do."""
    m, n = q.shape[2], k.shape[2]
    kv_pos = torch.arange(n, dtype=torch.int32, device=q.device)
    q_pos = n - m + torch.arange(m, dtype=torch.int32, device=q.device)
    o, _, l_run = _online_softmax(q, k, v, kv_pos, q_pos, bkv, masked,
                                  window, scale)
    return (o / torch.where(l_run == 0.0, 1.0, l_run)).to(q.dtype)


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
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, hq, m, dv), **f32)
    m_run = torch.empty((b, hq, m, 1), **f32)
    l_run = torch.empty((b, hq, m, 1), **f32)
    # the splits' raw states (unused with one split)
    parts = [torch.empty((splits, b * hq * m, dv), **f32),
             torch.empty((splits, b * hq * m), **f32),
             torch.empty((splits, b * hq * m), **f32)] if splits > 1 else []
    part_ptrs = [t.data_ptr() for t in parts] or [None] * 3
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(), o.data_ptr(),
             m_run.data_ptr(), l_run.data_ptr(), *part_ptrs, b, hq, hkv, m,
             n, d, dv, bq, bkv, splits, per, n if kv_pos.ndim == 2 else 0,
             m if q_pos.ndim == 2 else 0, int(masked), int(window),
             float(scale), int(smem), stream)
    _build.check_launch(lib, "attn_partial_launch", err, "attn_error_string")
    fused_attention_partial.launches += 1
    return o, m_run, l_run


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
    if step >= n:
        o, m_run, l_run = _online_softmax(q, k, v, kv_pos, q_pos, bkv,
                                          masked, window, scale)
    else:
        states = [_online_softmax(q, k[:, :, j:j + step],
                                  v[:, :, j:j + step],
                                  kv_pos[..., j:j + step], q_pos, bkv,
                                  masked, window, scale)
                  for j in range(0, n, step)]
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


def fused_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, bq: int = 128,
                          bkv: int = 128, window: int = 0,
                          scale: Optional[float] = None,
                          pages_per_chunk: int = 0) -> torch.Tensor:
    """Fused attention over a paged KV cache.

    q: (B, Hq, M, D) — request b's query rows sit at the TAIL of its
    context, global positions ``lengths[b]-M .. lengths[b]-1``
    (attention is causal by construction).  k_pages/v_pages:
    (n_pages, Hkv, page_size, D/Dv), the shared page pool
    (``serving.kv_pages``); page_table: (B, max_pages) int32 physical
    page per logical page, -1 = unallocated; lengths: (B,) int32.

    Each chunk of the page table is gathered into the contiguous layout
    the kernel streams and run through ``fused_attention_partial`` (one
    launch per chunk) with per-request global positions: unallocated
    slots carry ``INVALID_POS``, which the causal mask always rejects,
    and slots past ``lengths[b]`` fail ``col <= row`` the same way.
    Chunk states merge with the log-sum-exp combine
    (``dist.ring_dispatch.merge_partials``); ``pages_per_chunk`` bounds
    the gather staging buffer at the cost of one extra rescale per
    chunk boundary.
    """
    from ..dist.ring_dispatch import finalize_partials, merge_partials
    from ..serving.kv_pages import gather_pages, paged_kv_positions

    b, _, m, d = q.shape
    q = q.contiguous()
    ps = k_pages.shape[2]
    max_pages = page_table.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    q_pos = (lengths.to(torch.int32)[:, None] - m
             + torch.arange(m, dtype=torch.int32, device=q.device)[None, :])
    cpp = (pages_per_chunk if 0 < pages_per_chunk < max_pages
           else max_pages)
    pad = (-max_pages) % cpp
    if pad:
        page_table = torch.cat(
            [page_table, torch.full((b, pad), -1, dtype=page_table.dtype,
                                    device=page_table.device)], dim=1)
    state = None
    for c0 in range(0, page_table.shape[1], cpp):
        tbl = page_table[:, c0:c0 + cpp]
        kc = gather_pages(k_pages, tbl)
        vc = gather_pages(v_pages, tbl)
        kv_pos = paged_kv_positions(tbl, ps, invalid=INVALID_POS,
                                    first_page=c0)
        part = fused_attention_partial(
            q, kc, vc, kv_pos, q_pos, bq=bq, bkv=bkv, causal=True,
            window=window, scale=scale)
        state = part if state is None else merge_partials(state, part)
    o, _, l_run = state
    return finalize_partials(o, l_run, q.dtype)
