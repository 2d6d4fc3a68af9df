"""mixtral-8x7b [arXiv:2401.04088]: MoE 8 experts top-2, SWA window 4096.
32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000."""
from ..models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    window=4096, rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2),
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, window=32,
    # high capacity factor: no assignment is dropped at the test sizes
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0),
    dtype="float32",
)
