"""olmoe-1b-7b [arXiv:2409.02060]: MoE 64 experts top-8.
16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304."""
from ..models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8),
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=8.0),
    dtype="float32",
)
