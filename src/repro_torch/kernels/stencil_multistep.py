"""CUDA kernel: k_on-step fused 2-D stencil with on-chip (shared-memory) reuse.

Replaces the Pallas TPU kernel
:func:`repro.kernels.stencil_multistep.fused_stencil_band`
(``src/repro/kernels/stencil_multistep.py``, ``pallas_call`` at line 147),
the paper's AN5D-style multi-step kernel: each CTA loads one overlapping
tile + apron from device memory into shared memory, applies ``k_on`` time
steps there and writes its output tile back, the aprons recomputed by the
neighbouring tiles — the on-chip incarnation of SO2DR's deliberate
redundant computation.  Source: ``csrc/fused_stencil_band.cu``.

Bound on an H100: device-memory bytes.  The least traffic is one read of
the band and one write of the output (for gradient2d on a 9920 x 38400
fp32 band at 4 steps, 3.05 GB against 29 GFLOP: 0.91 ms of bandwidth
against 0.43 ms of fp32 issue).  The design reads each tile's apron again
(``(ty+2mr)(tx+2mr)/(ty*tx)`` of the band) and keeps every step in shared
memory, so the m steps cost one trip to device memory instead of m.

Semantics equal :func:`repro_torch.core.reference.multi_step_band`: column
frames always preserved, ``keep_top``/``keep_bottom`` row frames.  The
kernel masks the ragged edge and the band's ends itself — no padded copy
of the band and no fallback for bands smaller than one tile (see
``csrc/stencil_tile.cuh``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.reference import multi_step_band
from repro_torch.kernels import CUDA_TILE

__all__ = ["fused_stencil_band", "fused_stencil_band_plain"]


def fused_stencil_band_plain(band: torch.Tensor, name: str, steps: int,
                             keep_top: bool = False,
                             keep_bottom: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function (the oracle)."""
    return multi_step_band(band, name, steps, keep_top, keep_bottom)


def fused_stencil_band(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
    tile: Tuple[int, int] = CUDA_TILE,
) -> torch.Tensor:
    """``steps`` fused stencil time steps on a (H, X) band.

    Drop-in replacement for
    :func:`repro_torch.core.reference.multi_step_band`.  A CPU band runs
    the plain version; a CUDA band launches the kernel (fp32 or bf16,
    contiguous) or raises.  ``fused_stencil_band.launches`` counts the
    kernel launches."""
    if band.device.type == "cpu":
        return fused_stencil_band_plain(band, name, steps, keep_top,
                                        keep_bottom)
    from repro_torch.kernels._build import call_band_kernel

    out = call_band_kernel("repro_fused_stencil_band", band, name, steps,
                           keep_top, keep_bottom, tile, buffers=2)
    fused_stencil_band.launches += 1
    return out


fused_stencil_band.launches = 0
