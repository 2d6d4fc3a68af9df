"""mamba2-1.3b [arXiv:2405.21060]: SSD (state-space duality), attn-free.
48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128."""
from ..models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    pattern=("mamba",), tie_embeddings=True, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=512,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
    pattern=("mamba",), tie_embeddings=True, dtype="float32",
)
