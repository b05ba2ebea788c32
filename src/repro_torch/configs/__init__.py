"""Architecture config registry (the port of ``repro.configs``).

``get_config(name)`` / ``get_smoke_config(name)`` resolve the 10 assigned
architectures; ``cell_supported`` says which (arch x shape) cells run.
The dry run's ``input_specs`` belongs to the launch layer and is not
ported here.
"""
from __future__ import annotations

from .base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401

from . import (
    minitron_4b, phi3_medium_14b, h2o_danube_1_8b, qwen3_0_6b,
    llama_3_2_vision_90b, zamba2_2_7b, llama4_maverick_400b, mixtral_8x7b,
    whisper_tiny, mamba2_130m,
)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_NAMES", "get_config",
           "get_smoke_config", "cell_supported"]

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
