"""Public wrappers for the CUDA kernels (port of :mod:`repro.kernels.ops`).

``fused_stencil`` runs the fused band kernel on a CUDA band and its plain
version on a CPU band, so the same call site serves the CPU tests and the
card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import CUDA_TILE
from repro_torch.kernels.stencil_multistep import fused_stencil_band

__all__ = ["fused_stencil", "kernel_fused_step"]


def fused_stencil(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    return fused_stencil_band(
        band, name, steps, keep_top=keep_top, keep_bottom=keep_bottom,
        tile=tile or CUDA_TILE,
    )


def kernel_fused_step(band, name, steps, keep_top=False, keep_bottom=False):
    """Signature-compatible ``fused_step`` for the out-of-core engines
    (:mod:`repro_torch.core.oocore`), backed by the CUDA kernel."""
    return fused_stencil(band, name, steps, keep_top=keep_top,
                         keep_bottom=keep_bottom)
