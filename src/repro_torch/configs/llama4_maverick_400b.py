"""llama4-maverick-400b-a17b — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 on alternating layers (24 dense + 24 MoE ≈ 397 B params, matching
the 400b-a17b name; all-MoE at these dims would be ~790 B — see DESIGN.md).
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, moe_every=2,
)

SMOKE = ArchConfig(
    name="llama4-maverick-400b-a17b-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=256,
    n_experts=8, top_k=1, moe_every=2, capacity_factor=4.0,
)
