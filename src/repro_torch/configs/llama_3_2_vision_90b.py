"""llama-3.2-vision-90b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; 100 layers =
20 groups of (4 self-attn + 1 gated cross-attn to stub patch embeddings).
The vision frontend is a STUB per the assignment: ``batch["images"]``
carries precomputed patch embeddings (B, 1601, d_model).
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab=128256, cross_attn_every=5, n_image_tokens=1601,
    rope_theta=5e5,
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, cross_attn_every=5, n_image_tokens=17,
)
