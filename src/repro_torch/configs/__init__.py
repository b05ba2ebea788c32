"""Architecture config registry (the port of ``repro.configs``).

``get_config(name)`` / ``get_smoke_config(name)`` resolve the 10 assigned
architectures; ``cell_supported`` says which (arch x shape) cells run;
``input_specs(cfg, shape)`` builds the meta-tensor stand-ins the dry run
traces against (no allocation).
"""
from __future__ import annotations

from typing import Dict

import torch

from .base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401

from . import (
    minitron_4b, phi3_medium_14b, h2o_danube_1_8b, qwen3_0_6b,
    llama_3_2_vision_90b, zamba2_2_7b, llama4_maverick_400b, mixtral_8x7b,
    whisper_tiny, mamba2_130m,
)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_NAMES", "get_config",
           "get_smoke_config", "cell_supported", "input_specs"]

_MODULES = {
    "minitron-4b": minitron_4b,
    "phi3-medium-14b": phi3_medium_14b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "qwen3-0.6b": qwen3_0_6b,
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
    "zamba2-2.7b": zamba2_2_7b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "mixtral-8x7b": mixtral_8x7b,
    "whisper-tiny": whisper_tiny,
    "mamba2-130m": mamba2_130m,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    try:
        return _MODULES[name].FULL
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")


def get_smoke_config(name: str) -> ArchConfig:
    return _MODULES[name].SMOKE


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable?  Returns (ok, reason-if-not).

    Assignment rules: ``long_500k`` needs sub-quadratic attention — skipped
    for pure full-attention archs; whisper's enc-dec lengths are bounded
    far below 500k.
    """
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return False, "enc-dec: source/target lengths << 500k"
        if not cfg.sub_quadratic:
            return False, "pure full-attention arch: O(S) KV decode at 500k infeasible"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of this cell: tensors on ``device``
    (``meta`` by default: a shape and a dtype, no storage)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind == "train":
        specs = {
            "tokens": sd((B, S), i32),
            "labels": sd((B, S), i32),
        }
        if cfg.family == "vlm":
            specs["images"] = sd((B, cfg.n_image_tokens, cfg.d_model), bf16)
        if cfg.family == "encdec":
            specs["frames"] = sd((B, cfg.n_frames, cfg.d_model), bf16)
            # decoder trains on bounded target lengths
            specs["tokens"] = sd((B, min(S, cfg.max_target_len)), i32)
            specs["labels"] = sd((B, min(S, cfg.max_target_len)), i32)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": sd((B, S), i32)}
        if cfg.family == "vlm":
            specs["images"] = sd((B, cfg.n_image_tokens, cfg.d_model), bf16)
        if cfg.family == "encdec":
            specs["frames"] = sd((B, cfg.n_frames, cfg.d_model), bf16)
            specs["tokens"] = sd((B, min(S, cfg.max_target_len)), i32)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": sd((B, 1), i32)}
