"""zamba2-2.7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32, MHA in the shared block) d_ff=10240
vocab=32000, ssm_state=64.  54 layers = 9 groups of (5 Mamba2 + 1
application of the ONE shared-weight attention block).
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, attn_every=3,
    ssm_chunk=16, tie_embeddings=True,
)
