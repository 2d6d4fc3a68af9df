"""Unfused PyTorch oracles for the port's kernels: correctness
references for tests, never called on the serving path."""
from __future__ import annotations

from typing import Optional

import torch


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
