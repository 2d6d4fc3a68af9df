"""recurrentgemma-2b [arXiv:2402.19427]: RG-LRU + local attn, 1:2 ratio.
26L d_model=2560 10H (kv=1) d_ff=7680 vocab=256000.
26 = 8 x (R,R,A) super-blocks + trailing (R,R)."""
from ..models.config import ModelConfig, RGLRUConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256, act="geglu",
    rglru=RGLRUConfig(width_mult=1.0, local_window=2048),
    pattern=("rglru", "rglru", "attn"), tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, act="geglu",
    rglru=RGLRUConfig(width_mult=1.0, local_window=32),
    pattern=("rglru", "rglru", "attn"), tie_embeddings=True,
    dtype="float32",
)
