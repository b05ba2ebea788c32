"""whisper-tiny — enc-dec, conv frontend (stub) [arXiv:2212.04356].

4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The conv/mel frontend is a STUB per the assignment: ``batch["frames"]``
carries precomputed frame embeddings (B, 1500, d_model).
"""
from .base import ArchConfig

FULL = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_head=64, d_ff=1536, vocab=51865,
    norm="layernorm", mlp="gelu", n_frames=1500, max_target_len=448,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256,
    norm="layernorm", mlp="gelu", n_frames=24, max_target_len=32,
)
