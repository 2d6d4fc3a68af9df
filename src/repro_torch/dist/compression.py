"""Gradient compression: int8 quantization with error feedback — the
port of the JAX package's ``dist.compression``.

* ``quantize_int8`` — symmetric per-tensor int8 with one f32 scale;
  the worst element error is ``scale / 2`` (round to nearest, ties to
  even, as ``jnp.round``).
* ``compress_with_feedback`` — the residual carries each step's
  quantization error into the next, so the *sum* of the transmitted
  gradients converges to the true sum (EF-SGD).
* ``compressed_psum`` — the all-reduce over a data ``Axis``
  (``dist.collectives``) of error-feedback-compressed gradients.  As in
  the JAX package the all-reduce carries the dequantized f32 payload;
  an int8 wire format would be a feature the reference lacks.
"""
from __future__ import annotations

from typing import Optional

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q int8, scale f32 0-d) with ``x ~= q *
    scale`` and the largest element error <= scale / 2."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Quantize ``g + residual``; the new residual is the quantization
    error, carried into the next step (EF-SGD).  Returns (q, scale, new
    residual f32)."""
    corrected = g.float() + residual
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_psum(g: torch.Tensor, residual: torch.Tensor,
                    ax: Optional[object]) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The sum over the data ``Axis`` ``ax`` (None: one rank) of every
    rank's error-feedback-compressed ``g``.  Returns (the reduced
    gradient f32, this rank's new residual)."""
    q, scale, new_residual = compress_with_feedback(g, residual)
    out = dequantize_int8(q, scale)
    return (ax.all_reduce(out) if ax is not None else out), new_residual
