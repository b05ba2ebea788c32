"""Architecture config schema + shape presets (a copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0          # 0 -> d_model // n_heads
    # attention options
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"    # rmsnorm | layernorm
    mlp: str = "swiglu"      # swiglu | gelu
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1       # MoE on layers with (layer % moe_every == moe_every - 1)
    capacity_factor: float = 1.25
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # hybrid (zamba2): one *shared* attention block applied every attn_every
    attn_every: int = 0
    # vlm: cross-attn image layers every cross_attn_every (within a group)
    cross_attn_every: int = 0
    n_image_tokens: int = 1601
    # encdec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500
    max_target_len: int = 448

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Supports O(1)-state or bounded-window 500k-token decode."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.d_head
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        ffn_dense = 3 * d * f if self.mlp == "swiglu" else 2 * d * f
        n = 0
        if self.family == "ssm":
            dm = self.d_inner
            per = d * (2 * dm + 2 * self.ssm_state + self.ssm_heads) + dm * d
            n += self.n_layers * per
        elif self.family == "hybrid":
            dm = self.d_inner
            per = d * (2 * dm + 2 * self.ssm_state + self.ssm_heads) + dm * d
            n_mamba = self.n_layers - self.n_layers // self.attn_every
            n += n_mamba * per
            n += attn + ffn_dense  # ONE shared attention block
        elif self.family == "moe":
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            n += self.n_layers * attn
            n += n_dense * ffn_dense
            n += n_moe * (self.n_experts * ffn_dense + d * self.n_experts)
        elif self.family == "vlm":
            n += self.n_layers * (attn + ffn_dense)
            # cross layers replace self-attn with cross-attn (same shape)
        elif self.family == "encdec":
            n += self.n_enc_layers * (attn + ffn_dense)
            n += self.n_layers * (2 * attn + ffn_dense)  # self + cross
        else:
            n += self.n_layers * (attn + ffn_dense)
        n += v * d * (1 if self.tie_embeddings else 2)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only) — for 6·N_active·D."""
        if self.family != "moe":
            return self.param_count()
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.d_head
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        ffn = 3 * d * f
        n_moe = self.n_layers // self.moe_every
        n_dense = self.n_layers - n_moe
        n = self.n_layers * attn + n_dense * ffn
        n += n_moe * (self.top_k * ffn + d * self.n_experts)
        n += v * d * (1 if self.tie_embeddings else 2)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
