"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: pixtral-ViT frontend STUB
+ mistral-nemo backbone.  40L d_model=5120 32H (kv=8) d_ff=14336
vocab=131072.  The frontend is 1024 precomputed patch embeddings ahead
of the prompt (``prefix_embeds``)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1e6,
    frontend="vision", n_prefix_embeds=1024,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, frontend="vision", n_prefix_embeds=8,
    dtype="float32",
)
