"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: qwen1.5-arch, MHA (kv=32).
32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.

FULL holds 8.19 B parameters, 16.4 GB of bf16 weights."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, dtype="float32",
)
