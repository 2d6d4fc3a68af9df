"""granite-20b [arXiv:2405.04324]: llama-arch code model, MQA (kv=1).
52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.

FULL holds 28.17 B parameters, 56.3 GB of bf16 weights: one 80 GB card
serves it.  Its paged decode runs ``fused_attention_partial`` at a GQA
group of 48."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, dtype="float32",
)
