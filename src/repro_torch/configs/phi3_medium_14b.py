"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_head=128,
    d_ff=17920, vocab=100352,
)

SMOKE = ArchConfig(
    name="phi3-medium-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=160, vocab=256,
)
