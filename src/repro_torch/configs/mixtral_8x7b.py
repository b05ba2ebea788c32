"""mixtral-8x7b — 8 experts top-2, SWA [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, moe_every=1, sliding_window=4096,
)

SMOKE = ArchConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=256,
    n_experts=4, top_k=2, moe_every=1, sliding_window=32, capacity_factor=4.0,
)
