"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1, d_head=64,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-130m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_head=16,
    d_ff=0, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    tie_embeddings=True,
)
