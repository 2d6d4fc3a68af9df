"""Dispatch points from model code to the tuned kernels, single
device (mesh dispatch is not ported yet).

* ``gemm_chain`` and ``attention`` are the quickstart front door and the
  cache-free forward's attention (``models/layers.attention_block``
  under ``Runtime(kernel_ops=True)``): each runs the CUDA kernel with
  the schedule ``core.api.fuse_gemm_chain`` / ``fuse_attention`` tuned
  for its shape.
* ``mlp_chain`` is the planner executor's MLP dispatch
  (``models/layers.run_planned_layer`` under
  ``Runtime(kernel_ops=True, planner=True)``): a planner-carved MLP
  chain runs the ``gemm_chain.fused_mlp_chain`` schedule that
  ``core.api.fuse_mlp_chain`` tuned for its shape.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the
kernel's plain version.  Nothing here catches a failure.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import api


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def gemm_chain(a: torch.Tensor, b: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    """Fused E = (A B) D with the tuned schedule.  a: (B, M, K),
    b: (B, K, N), d: (B, N, H)."""
    bsz, m, k = a.shape
    n, h = b.shape[-1], d.shape[-1]
    tk = api.fuse_gemm_chain(m, n, k, h, batch=bsz, dtype=_dtype_name(a))
    return tk(a.contiguous(), b.contiguous(), d.contiguous())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Fused GQA attention with the tuned (bq, bkv).  q: (B, Hq, M, D),
    k/v: (B, Hkv, N, D/Dv); queries at the tail of the kv sequence."""
    b, hq, m, d = q.shape
    n, dv = v.shape[-2], v.shape[-1]
    tk = api.fuse_attention(m, n, d, dv, heads=hq, batch=b,
                            dtype=_dtype_name(q), causal=causal,
                            window=window, scale=scale)
    return tk(q.contiguous(), k.contiguous(), v.contiguous())


def mlp_chain(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              w_gate: Optional[torch.Tensor] = None,
              act: str = "silu") -> torch.Tensor:
    """Fused E = (act(X Wg) * (X Wu)) Wd with the tuned schedule
    (``w_gate=None`` computes act(X Wu) Wd).

    x: (M, K); w_up/w_gate: (K, N); w_down: (N, H).  The schedule is
    tuned at ``dtype=str(x.dtype)`` — the chain the caller actually
    runs, f32 when a stitched ln2 leaves x f32-wide — while the weights
    keep their own type (the kernel widens them in registers)."""
    m, _ = x.shape
    n, h = w_up.shape[-1], w_down.shape[-1]
    gated = w_gate is not None
    tk = api.fuse_mlp_chain(m, n, h, batch=1, dtype=_dtype_name(x),
                            gated=gated, act=act)
    out = tk(x.contiguous()[None], w_up[None], w_down[None],
             wg=w_gate[None] if gated else None)
    return out[0]
