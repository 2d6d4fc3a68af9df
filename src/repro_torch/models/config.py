"""Model configuration schema: the fields of the JAX package's
``ModelConfig`` that the dense decoder path reads.  The other families'
fields (MoE, SSM, recurrent, encoder) come with their slices."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    window: int = 0             # sliding-window attention (0 = full)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads
