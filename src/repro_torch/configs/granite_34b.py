"""granite-34b [arXiv:2405.04324]: llama-arch code model, MQA, depth 88.
88L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.

FULL holds 47.25 B parameters (three swiglu MLP matrices a layer),
94.5 GB of bf16 weights: more than one 80 GB card holds, so its
full-width run waits for the distributed slice.  SMOKE runs anywhere."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, dtype="float32",
)
