"""CUDA kernel: k_on-step fused 2-D stencil, one CTA per tile loaded by TMA.

Replaces the Pallas TPU kernel
:func:`repro.kernels.stencil_multistep.fused_stencil_band`
(``src/repro/kernels/stencil_multistep.py:96``, ``pallas_call`` at line
147), the paper's AN5D-style multi-step kernel: each tile + apron is
loaded from device memory once, ``k_on`` time steps run on chip and the
output tile is written back, the aprons recomputed by the neighbouring
tiles — the on-chip incarnation of SO2DR's deliberate redundant
computation.  Source: ``csrc/fused_stencil_band.cu``.

Design for Hopper.  The TPU kernel's grid is independent tiles (one DMA
each, nothing carried between grid steps), and so is this one: grid
``(nx, ny)``, one CTA per output tile, latency hidden by the other CTAs
resident on the SM (the persistent ring is
:mod:`repro_torch.kernels.stencil_multistep_db`'s design).  One thread
loads the whole apron'd tile, from its 16-byte-aligned column, with one
TMA copy (``cp.async.bulk.tensor.2d``, completion on an ``mbarrier``); the
tensor map fills cells outside the band with zeros, which is the kernel's
edge rule, so the load has no edge code.  Where TMA's limits do not hold
(:func:`band_uses_tma`) the same kernel loads in 16-byte ``cp.async``
chunks.  The steps are the column walk shared with the persistent kernel
(``csrc/stencil_walk.cuh``): the window in registers, the taps unrolled
at compile time, the trapezoid, the frame mask only in edge tiles, the
last step written straight to the output.  Two shared buffers
(:func:`band_smem_bytes`) let three CTAs share an SM at box2d1r and
gradient2d, m=4.

Bound on an H100: device-memory bytes for box2d1r, gradient2d and the
narrow stencils (for box2d1r on a 9920 x 38400 fp32 band at 4 steps,
3.05 GB: 0.91 ms at 3.35 TB/s), fp32 issue for box2d4r (81 multiplies
and 80 adds per update, never contracted into FMAs, so the kernel stays
bitwise equal to its plain version in fp32).

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
from repro_torch.core.stencil import get_stencil
from repro_torch.kernels import BAND_CUDA_TILE, ceil_div, walk_row_stride

__all__ = ["fused_stencil_band", "fused_stencil_band_plain",
           "band_smem_bytes", "band_uses_tma", "band_launch_shape"]

# TMA's largest box side, in elements
TMA_BOX_MAX = 256


def band_smem_bytes(ty: int, tx: int, steps: int, radius: int,
                    itemsize: int) -> int:
    """Shared memory of one CTA (``launch`` in the CUDA source): two
    apron'd tiles (the loaded tile and the scratch buffer) of
    ``walk_row_stride`` rows, each padded to a multiple of 128 bytes, as
    TMA's destination must be aligned; then the 8-byte ``mbarrier``."""
    th, tw = ty + 2 * steps * radius, tx + 2 * steps * radius
    buf = ceil_div(th * walk_row_stride(tw, itemsize) * itemsize, 128) * 128
    return 2 * buf + 8


def band_uses_tma(X: int, itemsize: int, data_ptr: int,
                  tile: Tuple[int, int]) -> bool:
    """Whether the kernel loads its tiles by TMA (else by ``cp.async``) on
    a band of ``X`` columns at address ``data_ptr`` whose apron'd tile is
    ``tile = (th, tw)``: the band's address and row pitch must be
    multiples of 16 bytes, and the box (``th`` rows of ``walk_row_stride``
    columns) at most 256 x 256.  The host entry applies the same rule."""
    th, tw = tile
    return (data_ptr % 16 == 0 and X * itemsize % 16 == 0
            and th <= TMA_BOX_MAX
            and walk_row_stride(tw, itemsize) <= TMA_BOX_MAX)


def fused_stencil_band_plain(band: torch.Tensor, name: str, steps: int,
                             keep_top: bool = False,
                             keep_bottom: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function (the oracle)."""
    return multi_step_band(band, name, steps, keep_top, keep_bottom)


def _launch_args(band: torch.Tensor, name: str, steps: int):
    r, itemsize = get_stencil(name).radius, band.element_size()
    return dict(buffers=2, smem_bytes=lambda ty, tx: band_smem_bytes(
        ty, tx, steps, r, itemsize))


def fused_stencil_band(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
    tile: Tuple[int, int] = BAND_CUDA_TILE,
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
                           keep_top, keep_bottom, tile,
                           **_launch_args(band, name, steps))
    fused_stencil_band.launches += 1
    return out


fused_stencil_band.launches = 0


def band_launch_shape(band: torch.Tensor, name: str, steps: int,
                      keep_top: bool = False, keep_bottom: bool = False,
                      tile: Tuple[int, int] = BAND_CUDA_TILE) -> dict:
    """The launch :func:`fused_stencil_band` makes on this CUDA band
    (threads and shared bytes per CTA, CTAs per SM, grid, tile, and
    ``load``: ``"tma"`` or ``"cp.async"``), without launching it; see
    :func:`repro_torch.kernels._build.launch_shape`."""
    from repro_torch.kernels._build import launch_shape

    shape = launch_shape("repro_fused_stencil_band", band, name, steps,
                         keep_top, keep_bottom, tile,
                         **_launch_args(band, name, steps))
    shape["load"] = "tma" if shape.pop("tma") else "cp.async"
    return shape
