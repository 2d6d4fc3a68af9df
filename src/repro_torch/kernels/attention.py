"""Fused attention for the paged decode path: the CUDA kernel
``fused_attention_partial`` (``csrc/attention_partial.cu``), its plain
PyTorch version, and ``fused_attention_paged`` around them.

The attention chain  S = Q K^T ; P = softmax(S) ; O = P V  streams the
kv axis with an online softmax, so the score tile never reaches device
memory.  The block sizes (bq, bkv) come from MCFuser's analytical
search for each concrete shape (``core.api.fuse_attention_paged``).

A CUDA tensor launches the kernel or raises; only a CPU tensor runs the
plain version, which is the same recurrence over kv blocks of ``bkv``
in torch ops.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.perf_model import H100, attention_smem_bytes

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


def _check(q, k, v, kv_pos, q_pos, bq, bkv):
    """Raise on anything the CUDA kernel does not take; returns the
    clamped tiles and their shared-memory bytes."""
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
    devices = {t.device for t in (q, k, v, kv_pos, q_pos)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if kv_pos.shape not in ((n,), (b, n)) or q_pos.shape not in ((m,),
                                                                 (b, m)):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} must be (N,)|(B,N) and "
                         f"(M,)|(B,M)")
    bq, bkv = clamp_tiles(m, n, bq, bkv)
    smem = attention_smem_bytes(bq, bkv, d, dv, q.element_size())
    if smem > H100.smem_per_block:
        raise ValueError(f"tiles bq={bq} bkv={bkv} need {smem} B of shared "
                         f"memory per block > {H100.smem_per_block}")
    return bq, bkv, smem


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
    if dev.type == "cpu":
        return fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv,
                                             masked, window, scale)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch(q, k, v, kv_pos, q_pos, bq, bkv, masked, window, scale,
                   smem)


fused_attention_partial.launches = 0


def _launch(q, k, v, kv_pos, q_pos, bq, bkv, masked, window, scale, smem):
    from . import _build

    lib = _build.load("attention_partial")
    fn = lib.attn_partial_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 13 + [ctypes.c_float,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p])
    b, hq, m, d = q.shape
    _, hkv, n, dv = v.shape
    o = torch.empty((b, hq, m, dv), dtype=torch.float32, device=q.device)
    m_run = torch.empty((b, hq, m, 1), dtype=torch.float32, device=q.device)
    l_run = torch.empty((b, hq, m, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(), o.data_ptr(),
             m_run.data_ptr(), l_run.data_ptr(), b, hq, hkv, m, n, d, dv, bq,
             bkv, n if kv_pos.ndim == 2 else 0,
             m if q_pos.ndim == 2 else 0, int(masked), int(window),
             float(scale), int(smem), stream)
    if err:
        lib.attn_error_string.restype = ctypes.c_char_p
        lib.attn_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError("attn_partial_launch failed: "
                           + lib.attn_error_string(err).decode())
    fused_attention_partial.launches += 1
    return o, m_run, l_run


def fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv: int,
                                  masked: bool, window: int, scale: float):
    """The kernel's plain PyTorch version: the same online-softmax
    recurrence over kv blocks of ``bkv``, f32 scores and statistics, P
    rounded to v's type before P V, dead rows zeroed at the end.
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
