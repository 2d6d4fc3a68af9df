"""Dense decoder layers as plain functions on tensors: norms, RoPE,
GQA attention over a paged KV cache, and the SwiGLU MLP.

Parameters are dicts of tensors with the JAX package's names and
layouts (``wq`` is (d_model, n_heads * dh), and so on), so weights carry
across unchanged (``models.convert``).

Paged attention has two bodies with one semantics: the fused CUDA
kernel (``kernels.attention.fused_attention_paged``) for decode steps on
the card under ``kernel_ops``, and the gather twin — page-table gather
plus per-request positional attention in torch ops — everywhere else
(prefill, and any run on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..serving import kv_pages as KP
from .config import ModelConfig

NEG_INF = -1e30


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def _rmsnorm_f32(x: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """rmsnorm without the trailing downcast."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + w.float())


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _rmsnorm_f32(x, w, eps).to(x.dtype)


def _rope_f32(x: torch.Tensor, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """rope without the trailing downcast.  x: (B, S, H, Dh),
    positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs      # (B, S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    return _rope_f32(x, positions, theta).to(x.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device) -> dict:
    dt = getattr(torch, cfg.dtype)
    d, dh = cfg.d_model, cfg.dh
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * dh), dt, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * dh), dt, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * dh), dt, device),
        "wo": dense_init(gen, (cfg.n_heads * dh, d), dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, device=device)
        p["k_norm"] = torch.zeros(dh, device=device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = getattr(torch, cfg.dtype)
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_init(gen, (d, ff), dt, device),
            "w_up": dense_init(gen, (d, ff), dt, device),
            "w_down": dense_init(gen, (ff, d), dt, device)}


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x Wg) * (x Wu)) Wd."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _paged_positional_attention(q, k, v, rows_pos, kv_pos, window: int,
                                scale: float) -> torch.Tensor:
    """Attention with PER-REQUEST position vectors — the paged gather
    twin.  q: (B, H, M, D), k/v: (B, H, N, D) (kv heads already
    repeated); rows_pos: (B, M) global query positions (-1 = masked
    row); kv_pos: (B, N) global position of each gathered slot (-1 =
    unallocated)."""
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    cols = kv_pos[:, None, None, :]
    rows = rows_pos[:, None, :, None]
    mask = (cols >= 0) & (cols <= rows)
    if window > 0:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhmn,bhnv->bhmv", p.to(v.dtype), v).to(q.dtype)


def paged_attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                          positions: torch.Tensor, cache: dict,
                          page_table: torch.Tensor,
                          kernel_ops: bool = False,
                          block: Optional[tuple] = None
                          ) -> tuple[torch.Tensor, dict]:
    """Attention over a paged KV cache.

    x: (B, S, D); positions: (B, S) absolute position of each row
    (-1 = masked: prompt padding or an inactive engine slot); cache:
    ``{"k_pages", "v_pages"}`` of shape (n_pages, Hkv, page_size, dh)
    — the shared pool, written IN PLACE; page_table: (B, max_pages)
    physical page per logical page (-1 = unallocated).  Serving is
    causal by construction.
    """
    b, s, _ = x.shape
    dh = cfg.dh
    ps = cache["k_pages"].shape[2]
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, dh)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    phys, off = KP.slot_coords(page_table, positions, ps)
    KP.scatter_pages(cache["k_pages"], phys, off, k)
    KP.scatter_pages(cache["v_pages"], phys, off, v)

    o = _paged_attention_body(q.transpose(1, 2), cache, page_table,
                              positions,
                              group=cfg.n_heads // cfg.n_kv_heads,
                              win=cfg.window, scale=1.0 / math.sqrt(dh),
                              kernel_ops=kernel_ops, block=block)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * dh)
    return o @ p["wo"], cache


def _paged_attention_body(qt: torch.Tensor, cache: dict,
                          page_table: torch.Tensor,
                          positions: torch.Tensor, *, group: int,
                          win: int, scale: float,
                          kernel_ops: bool = False,
                          block: Optional[tuple] = None) -> torch.Tensor:
    """The paged attention core: the fused kernel or the gather twin.
    qt: (B, Hq, S, dh); cache holds the POST-write page pools."""
    s = qt.shape[2]
    if kernel_ops and s == 1 and qt.is_cuda:
        # decode only: the kernel's tail convention needs q rows at
        # lengths-M..lengths-1, which padded prefill rows violate.
        # ``block`` carries the tuner's winning tiles, so the executed
        # schedule is the one the model priced.
        from ..kernels.attention import fused_attention_paged
        bq, bkv = block if block is not None else (128, 128)
        return fused_attention_paged(
            qt, cache["k_pages"], cache["v_pages"], page_table,
            positions[:, -1] + 1, bq=bq, bkv=bkv, window=win, scale=scale)
    ps = cache["k_pages"].shape[2]
    kk = KP.gather_pages(cache["k_pages"], page_table).repeat_interleave(
        group, dim=1)
    vv = KP.gather_pages(cache["v_pages"], page_table).repeat_interleave(
        group, dim=1)
    kv_pos = KP.paged_kv_positions(page_table, ps)
    return _paged_positional_attention(qt, kk, vv, positions, kv_pos, win,
                                       scale)
