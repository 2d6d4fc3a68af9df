"""Dispatch points from model code to the tuned kernels.

``mlp_chain`` is the planner executor's MLP dispatch
(``models/layers.run_planned_layer`` under
``Runtime(kernel_ops=True, planner=True)``): a planner-carved MLP chain
runs the ``gemm_chain.fused_mlp_chain`` schedule that
``core.api.fuse_mlp_chain`` tuned for its shape.  A CUDA tensor
launches the kernel or raises; a CPU tensor runs the kernel's plain
version.  Nothing here catches a failure.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import api


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
    tk = api.fuse_mlp_chain(m, n, h, batch=1,
                            dtype=str(x.dtype).replace("torch.", ""),
                            gated=gated, act=act)
    out = tk(x.contiguous()[None], w_up[None], w_down[None],
             wg=w_gate[None] if gated else None)
    return out[0]
