"""Model configuration schema: the fields of the JAX package's
``ModelConfig`` that the dense and mixture-of-experts decoder paths
read.  The other families' fields (SSM, recurrent, encoder) come with
their slices."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k routing over ``n_experts`` gated MLPs, each
    expert taking at most ``capacity_factor`` times its even share of
    the token-expert assignments (``models.layers.moe_local``)."""

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    window: int = 0             # sliding-window attention (0 = full)
    use_fused_attention: bool = True  # cache-free twin: stream kv blocks
    act: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    use_rope: bool = True       # False: learned absolute positions
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads
