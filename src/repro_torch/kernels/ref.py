"""Unfused PyTorch oracles for the port's kernels: correctness
references for tests, and the twins ``kernels/ops.py`` serves when a
guarded kernel is quarantined or fails to dispatch."""
from __future__ import annotations

from typing import Optional

import torch


def gemm_chain_ref(a: torch.Tensor, b: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """E = (A @ B) @ D accumulating in f32, C rounded to a's type before
    the second product.  a: (..., M, K), b: (..., K, N), d: (..., N, H)
    -> (..., M, H) in a's type."""
    c = (a.float() @ b.float()).to(a.dtype)
    return (c.float() @ d.float()).to(a.dtype)


def gemm_chain3_ref(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                    f: torch.Tensor) -> torch.Tensor:
    """G = ((A @ B) @ D) @ F: ``gemm_chain_ref`` (E in a's type), then
    E @ F accumulated in f32.  f: (..., H, G) -> (..., M, G)."""
    e = gemm_chain_ref(a, b, d)
    return (e.float() @ f.float()).to(a.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """O = softmax(Q K^T * scale + mask) V with an f32 softmax.

    q: (B, M, D), k: (B, N, D), v: (B, N, Dv) -> (B, M, Dv).  Queries
    sit at the tail of the kv sequence (decode); ``window > 0`` is
    sliding-window attention (causal implied)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bmd,bnd->bmn", q.float(), k.float()) * scale
    m, n = q.shape[1], k.shape[1]
    if causal or window > 0:
        rows = torch.arange(m, device=q.device)[:, None] + (n - m)
        cols = torch.arange(n, device=q.device)[None, :]
        mask = cols <= rows
        if window > 0:
            mask &= cols > rows - window
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bmn,bnh->bmh", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def gqa_attention_ref(q, k, v, causal: bool = False, window: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """GQA: q (B, Hq, M, D), k/v (B, Hkv, N, D); Hq % Hkv == 0."""
    b, hq, m, d = q.shape
    group = hq // k.shape[1]
    kf = k.repeat_interleave(group, dim=1).reshape(b * hq, k.shape[2], d)
    vf = v.repeat_interleave(group, dim=1).reshape(b * hq, v.shape[2],
                                                   v.shape[3])
    o = attention_ref(q.reshape(b * hq, m, d), kf, vf, causal=causal,
                      window=window, scale=scale)
    return o.reshape(b, hq, m, v.shape[3])


def mlp_chain_ref(a: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                  wg: Optional[torch.Tensor] = None,
                  act: str = "silu", prologue=None,
                  epilogue=None) -> torch.Tensor:
    """The unfused (gated) MLP in f32: (act(A Wg) * (A Wu)) Wd, or
    act(A Wu) Wd without ``wg``; gelu is the tanh form.  Any leading
    batch dims; returns a's type.  The stitching hooks
    (``hooks.Elementwise``) apply whole-array: ``prologue`` on a,
    ``epilogue`` on the f32 E."""
    from . import hooks
    from .gemm_chain import act_fn
    f = act_fn(act)
    af = hooks.apply(prologue, a).float()
    u = af @ wu.float()
    hid = f(u) if wg is None else f(af @ wg.float()) * u
    return hooks.apply(epilogue, hid @ wd.float()).to(a.dtype)


def partial_attention_ref(q, k, v, kv_pos, q_pos, causal: bool = True,
                          window: int = 0, scale: Optional[float] = None
                          ) -> tuple:
    """One kv shard's partial softmax in one pass, the oracle of
    ``fused_attention_partial``: (o_unnorm, m, l) in f32 with P rounded
    to v's type before P V.  q (B, Hq, M, D), k/v (B, Hkv, N, D);
    kv_pos (N,) or (B, N) and q_pos (M,) or (B, M) global positions
    (a negative kv position is an empty slot).  Rows with no key in the
    shard come back as (0, -1e30, 0), the identity of the merge."""
    b, hq, m, d = q.shape
    n = k.shape[2]
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(),
                     k.repeat_interleave(group, dim=1).float()) * scale
    if causal or window > 0:
        cols = kv_pos.reshape(-1, 1, 1, n)
        rows = q_pos.reshape(-1, 1, m, 1)
        keep = (cols >= 0) & (cols <= rows)
        if window > 0:
            keep &= cols > rows - window
        s = s.masked_fill(~keep, -1e30)
    m_run = s.amax(dim=-1, keepdim=True)
    dead = m_run <= -5e29
    p = torch.exp(s - m_run).masked_fill(dead, 0.0)
    l_run = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhmn,bhnv->bhmv", p.to(v.dtype).float(),
                     v.repeat_interleave(group, dim=1).float())
    return o, m_run, l_run
