"""qwen3-8b [hf:Qwen/Qwen3-8B]: dense, qk_norm, GQA.
36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, qk_norm=True, dtype="float32",
)
