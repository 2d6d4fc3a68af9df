"""Model configuration schema: the JAX package's ``ModelConfig`` for
the dense, mixture-of-experts, hybrid (RG-LRU plus local attention),
vision-prefix, state-space (Mamba-2) and encoder-decoder (whisper)
families."""
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
class SSMConfig:
    """Mamba-2 SSD block (``models.layers.mamba_block``)."""

    d_state: int = 128
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    chunk: int = 128            # SSD chunk length
    conv_kernel: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin / RecurrentGemma recurrent block
    (``models.layers.rglru_block``)."""

    width_mult: float = 1.0     # lru width = d_model * mult (RG uses 1.0)
    conv_kernel: int = 4
    c_exponent: float = 8.0
    local_window: int = 2048    # window of the interleaved local-attn layers


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (``models.whisper.EncDec``; the frontend is
    a stand-in: precomputed frame embeddings)."""

    n_layers: int
    n_frames: int = 1500        # whisper 30s @ 50Hz after conv stem
    d_model: Optional[int] = None  # defaults to decoder d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
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
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None   # audio | vision: precomputed embeds
    n_prefix_embeds: int = 0         # vision stub: patch embeds per sample
    # layer layout for hybrids: e.g. ("rglru", "rglru", "attn") repeated
    pattern: tuple[str, ...] = ("attn",)

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attn_window(self) -> int:
        """The attention layers' window (0 = full): a hybrid's local
        window, else ``window``."""
        return self.rglru.local_window if self.rglru else self.window

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (the reference's skip
        rule)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), the JAX
        package's formula as it stands: a GeGLU MLP counts two matrices
        where ``init_mlp`` makes three (ROADMAP Queue 3), so
        recurrentgemma-2b reads 2.383 B against the 2.894 B its tensors
        hold.  Bytes on the card are counted from the tensors."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        counts = {"attn": 0, "mamba": 0, "rglru": 0}
        pat = list(self.pattern)
        for i in range(self.n_layers):
            counts[pat[i % len(pat)]] += 1
        qkv = d * self.n_heads * self.dh + 2 * d * self.n_kv_heads * self.dh
        attn = qkv + self.n_heads * self.dh * d
        mats = 3 if self.act == "swiglu" else 2    # geglu: 3 held
        if self.moe:
            ff = self.moe.n_experts * mats * d * f
            ff += d * self.moe.n_experts  # router
        else:
            ff = mats * d * f
        per = counts["attn"] * (attn + ff)
        if counts["mamba"]:
            s = self.ssm
            din = s.expand * d
            per += counts["mamba"] * (d * (2 * din + 2 * s.n_groups * s.d_state
                                           + din // s.head_dim) + din * d + ff)
        if counts["rglru"]:
            w = int(self.rglru.width_mult * d)
            per += counts["rglru"] * (d * 2 * w + 2 * w * w + w * d + ff)
        return per + 2 * d * v if not self.tie_embeddings else per + d * v

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_ff = (3 if self.act == "swiglu" else 2) * d * f
        inactive = (self.moe.n_experts - self.moe.top_k) * dense_ff
        return self.n_params() - self.n_layers * inactive
