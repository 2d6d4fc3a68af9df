"""whisper-small [arXiv:2212.04356]: enc-dec, the conv frontend a
stand-in (precomputed frame embeddings).
12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865."""
from ..models.config import EncoderConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    act="gelu", norm="layernorm", use_rope=False, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    frontend="audio",
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    act="gelu", norm="layernorm", use_rope=False, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=2, n_frames=16),
    frontend="audio", dtype="float32",
)
