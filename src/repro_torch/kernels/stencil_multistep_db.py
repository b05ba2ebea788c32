"""CUDA kernel: persistent fused stencil with a two-slot ``cp.async`` ring.

Replaces the Pallas TPU kernel
:func:`repro.kernels.stencil_multistep_db.fused_stencil_band_db`
(``src/repro/kernels/stencil_multistep_db.py``, ``pallas_call`` at line
121), which overlaps tile ``g+1``'s HBM->VMEM copy with tile ``g``'s
compute (the paper's copy/compute overlap at the kernel level).  That
prefetch is valid on the TPU only because grid steps run in order on one
core; CUDA blocks run concurrently, so the order moves inside the block:
a persistent grid walks its tiles ``blockIdx.x, blockIdx.x + gridDim.x,
...`` and each CTA issues the ``cp.async`` copy of its next tile into the
other ring slot before computing the current one.  Source:
``csrc/fused_stencil_band_db.cu``.

Design for Hopper: the grid is as many CTAs as the occupancy API fits on
each SM (three of 256 threads at gradient2d; one of 512 at box2d4r, whose
three apron'd tiles take 126 KB), so one CTA's barriers and stores hide
under the others' steps; rows move in 16-byte ``cp.async.cg`` chunks from
an aligned tile origin (:func:`db_smem_bytes` sizes the shifted rows);
each thread walks one column down its rows with the ``(2r+1)^2`` window
in registers, the taps unrolled at compile time, so an update loads
``2r+1`` shared cells instead of one per tap; step ``s`` updates only the
cells within ``(m-1-s)r`` of the output tile, tiles off the band's edges
skip the frame mask, and the last step writes straight to the output.

Bound on an H100: device-memory bytes for gradient2d and the narrow
stencils (the same band function as
:mod:`repro_torch.kernels.stencil_multistep`), fp32 issue for box2d4r
(81 multiplies and 80 adds per update, never contracted into FMAs, so the
kernel stays bitwise equal to its plain version in fp32).  bf16 edge
chunks are filled with ordinary loads (``cp.async`` moves at least 4
bytes).

Semantics equal :func:`repro_torch.core.reference.multi_step_band`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.reference import multi_step_band
from repro_torch.core.stencil import get_stencil
from repro_torch.kernels import DB_CUDA_TILE, walk_row_stride

__all__ = ["fused_stencil_band_db", "fused_stencil_band_db_plain",
           "db_smem_bytes", "db_launch_shape"]


def db_smem_bytes(ty: int, tx: int, steps: int, radius: int,
                  itemsize: int) -> int:
    """Shared memory of one CTA (``launch`` in the CUDA source): three
    apron'd tiles (two ring slots and the scratch buffer) whose rows start
    at the 16-byte-aligned column at or left of the tile, so each row has
    room for ``16/itemsize - 1`` more elements, rounded to whole 16-byte
    chunks."""
    th, tw = ty + 2 * steps * radius, tx + 2 * steps * radius
    return 3 * th * walk_row_stride(tw, itemsize) * itemsize


def fused_stencil_band_db_plain(band: torch.Tensor, name: str, steps: int,
                                keep_top: bool = False,
                                keep_bottom: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function (the oracle)."""
    return multi_step_band(band, name, steps, keep_top, keep_bottom)


def _launch_args(band: torch.Tensor, name: str, steps: int):
    r, itemsize = get_stencil(name).radius, band.element_size()
    return dict(buffers=3, smem_bytes=lambda ty, tx: db_smem_bytes(
        ty, tx, steps, r, itemsize))


def fused_stencil_band_db(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
    tile: Tuple[int, int] = DB_CUDA_TILE,
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
                           keep_top, keep_bottom, tile,
                           **_launch_args(band, name, steps))
    fused_stencil_band_db.launches += 1
    return out


fused_stencil_band_db.launches = 0


def db_launch_shape(band: torch.Tensor, name: str, steps: int,
                    keep_top: bool = False, keep_bottom: bool = False,
                    tile: Tuple[int, int] = DB_CUDA_TILE) -> dict:
    """The launch :func:`fused_stencil_band_db` makes on this CUDA band
    (threads and shared bytes per CTA, CTAs per SM, grid, tile), without
    launching it; see :func:`repro_torch.kernels._build.launch_shape`."""
    from repro_torch.kernels._build import launch_shape

    return launch_shape("repro_fused_stencil_band_db", band, name, steps,
                        keep_top, keep_bottom, tile,
                        **_launch_args(band, name, steps))
