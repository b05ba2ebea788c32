"""CUDA kernel: persistent fused stencil with a two-slot ``cp.async`` ring.

Replaces the Pallas TPU kernel
:func:`repro.kernels.stencil_multistep_db.fused_stencil_band_db`
(``src/repro/kernels/stencil_multistep_db.py``, ``pallas_call`` at line
121), which overlaps tile ``g+1``'s HBM->VMEM copy with tile ``g``'s
compute (the paper's copy/compute overlap at the kernel level).  That
prefetch is valid on the TPU only because grid steps run in order on one
core; CUDA blocks run concurrently, so the order moves inside the block:
a persistent grid of at most one CTA per SM walks its tiles
``blockIdx.x, blockIdx.x + gridDim.x, ...`` and issues the ``cp.async``
copy of its next tile into the other ring slot before computing the
current one.  Source: ``csrc/fused_stencil_band_db.cu``.

Bound on an H100: device-memory bytes, as for
:mod:`repro_torch.kernels.stencil_multistep` (the same band function);
the ring hides the copy latency that one CTA per SM could not hide by
occupancy.  bf16 tiles are filled with ordinary loads (``cp.async``
moves at least 4 bytes), so bf16 does not overlap the copy.

Semantics equal :func:`repro_torch.core.reference.multi_step_band`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.reference import multi_step_band
from repro_torch.kernels import CUDA_TILE

__all__ = ["fused_stencil_band_db", "fused_stencil_band_db_plain"]


def fused_stencil_band_db_plain(band: torch.Tensor, name: str, steps: int,
                                keep_top: bool = False,
                                keep_bottom: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function (the oracle)."""
    return multi_step_band(band, name, steps, keep_top, keep_bottom)


def fused_stencil_band_db(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
    tile: Tuple[int, int] = CUDA_TILE,
) -> torch.Tensor:
    """``steps`` fused stencil time steps on a (H, X) band, persistent
    double-buffered kernel.  A CPU band runs the plain version; a CUDA band
    launches the kernel or raises.  ``fused_stencil_band_db.launches``
    counts the kernel launches."""
    if band.device.type == "cpu":
        return fused_stencil_band_db_plain(band, name, steps, keep_top,
                                           keep_bottom)
    from repro_torch.kernels._build import call_band_kernel

    out = call_band_kernel("repro_fused_stencil_band_db", band, name, steps,
                           keep_top, keep_bottom, tile, buffers=3)
    fused_stencil_band_db.launches += 1
    return out


fused_stencil_band_db.launches = 0
