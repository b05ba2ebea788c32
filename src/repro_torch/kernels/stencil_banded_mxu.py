"""CUDA kernel: linear stencils as banded products on the tensor cores.

Replaces the Pallas TPU kernel
:func:`repro.kernels.stencil_banded_mxu.banded_fused_stencil`
(``src/repro/kernels/stencil_banded_mxu.py``, ``pallas_call`` at line
151), which recasts each time step of a *linear* stencil as ``2r+1``
banded matmuls on the MXU::

    centre = sum_dy  t[dy : TH-2r+dy, :] @ B_dy,     B_dy[x+dx, x] = c[dy, dx]

Source: ``csrc/banded_fused_stencil.cu``.  Each step's centre is computed
with ``mma.sync`` m16n8k8 TF32 in a 3xTF32 split (both operands, fp32
accumulation) so that it meets the reference's 2e-5; the band matrices
are built from the coefficients, never stored, and only their nonzero
K-blocks are multiplied.  It is not bitwise equal to its plain version
(the tensor cores sum in their own order), but it is deterministic: the
same band always gives the same bits.

Design for Hopper: persistent CTAs of 16 warps (one per SM at the
default tile, whose two fp32 tiles and B table take 142 KiB) walk the
tiles and load the next one with ``cp.async`` while the last step runs;
a warp owns a strip of up to four fragments and loads each A K-block
once per row offset with ``ldmatrix``, splitting it with two instructions
per element (the value cut to TF32 and the exact remainder); the B
fragments sit in a shared table; step ``s`` covers only the cells within
``(m-1-s)r`` of the output tile (:func:`banded_step_grids`).

Bound on an H100: operations for the wide box stencils (box2d4r at m=4:
161 FLOP per cell update at the 67 TFLOP/s fp32 rate outweigh the band's
bytes at 3.35 TB/s), bytes for the narrow ones.  What holds the kernel
above the time of its own MMAs at the dense TF32 peak
(:func:`banded_mma_count`) is the issue of the A operand (loads and
split) beside the MMAs; how near ``mma.sync`` itself comes to that peak
on this card is not measured.

:func:`mxu_wins` is the JAX package's napkin rule (same formula); with the
H100's data-sheet rates it sends no registry stencil here, which is what
``dispatch._auto_impl`` does on CUDA until measured rates say otherwise.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.stencil import Stencil, get_stencil
from repro_torch.kernels import MXU_CUDA_TILE, ceil_div

__all__ = ["banded_fused_stencil", "banded_fused_stencil_plain", "mxu_wins",
           "banded_smem_bytes", "banded_step_grids", "banded_mma_count",
           "banded_launch_shape"]


def mxu_wins(st: Stencil, tx: int = 128,
             vpu: float = 3.9e12, mxu: float = 197e12) -> bool:
    """Napkin check: does the banded recast beat the vector path?  (The
    JAX package's rule; the defaults are its TPU rates.)"""
    if not st.is_linear:
        return False
    n = 2 * st.radius + 1
    t_mxu = n * 2 * (tx + 2 * st.radius) / mxu
    t_vpu = st.flops_per_elem / vpu
    return t_mxu < t_vpu


def _band_matrices(st: Stencil, tx: int) -> np.ndarray:
    """(2r+1, TX+2r, TX) banded matrices, one per row offset dy (the JAX
    package's construction, bit for bit)."""
    r = st.radius
    n = 2 * r + 1
    out = np.zeros((n, tx + 2 * r, tx), np.float32)
    for dy in range(n):
        for dx in range(n):
            c = float(st.coeffs[dy, dx])
            for x in range(tx):
                out[dy, x + dx, x] = c
    return out


def banded_step_grids(ty: int, tx: int, steps: int,
                      radius: int) -> List[Tuple[int, int, int, int]]:
    """Each step's fragment grid in the kernel (``step_grid`` in the CUDA
    source): ``(row0, col0, mblocks, nblocks)`` in centre coordinates.
    Step ``s`` updates the cells within ``(steps-1-s)*radius`` of the
    output tile (the trapezoid): rows from ``s*r``, columns from ``s*r``
    rounded down to 4 (ldmatrix rows start on 16 bytes), in 16 x 8
    fragments."""
    r = radius
    hc = ty + 2 * (steps - 1) * r
    wc = tx + 2 * (steps - 1) * r
    grids = []
    for s in range(steps):
        lo = s * r
        row0, col0 = lo, lo & ~3
        grids.append((row0, col0, ceil_div(hc - lo - row0, 16),
                      ceil_div(wc - lo - col0, 8)))
    return grids


def banded_smem_bytes(ty: int, tx: int, steps: int, radius: int) -> int:
    """Shared memory of one CTA of the kernel (``banded_smem`` in the CUDA
    source): two fp32 tiles (bf16 bands are widened on load) holding
    every row and column some step's fragments read, the row stride
    raised to 4 mod 32 words, plus the B table of (2r+1) x 32 lanes x 8
    words."""
    r = radius
    rows = cols = 0
    for row0, col0, mb, nb in banded_step_grids(ty, tx, steps, r):
        rows = max(rows, row0 + 16 * mb + 2 * r)
        cols = max(cols, col0 + 8 * (nb + 1))
    stride = ceil_div(cols - 4, 32) * 32 + 4
    return 2 * rows * stride * 4 + (2 * r + 1) * 32 * 8 * 4


def banded_mma_count(ty: int, tx: int, steps: int, radius: int) -> int:
    """``mma.sync`` m16n8k8 instructions one tile's CTA issues: 3 (the
    3xTF32 split) x 2 K-blocks x (2r+1) row offsets per fragment of
    every step's grid."""
    frags = sum(mb * nb for _, _, mb, nb in
                banded_step_grids(ty, tx, steps, radius))
    return frags * (2 * radius + 1) * 6


def _banded_step_valid(x: torch.Tensor, st: Stencil, bands: torch.Tensor,
                       tx: int) -> torch.Tensor:
    """One step on the valid interior, ``(h, w) -> (h-2r, w-2r)``, as
    banded matmuls over column tiles of ``tx`` outputs: tile ``t`` reads
    columns ``[t*tx, t*tx + tx + 2r)`` and multiplies each row window
    ``dy`` by ``bands[dy]``; fp32 accumulation, rounded once to the
    band's dtype."""
    r = st.radius
    h, w = x.shape
    wo = w - 2 * r
    nt = ceil_div(wo, tx)
    xf = torch.nn.functional.pad(x.float(), (0, nt * tx + 2 * r - w))
    tiles = xf.unfold(1, tx + 2 * r, tx).permute(1, 0, 2)  # (nt, h, tx+2r)
    acc = None
    for dy in range(2 * r + 1):
        term = torch.matmul(tiles[:, dy:dy + h - 2 * r], bands[dy])
        acc = term if acc is None else acc + term
    return acc.permute(1, 0, 2).reshape(h - 2 * r, nt * tx)[:, :wo].to(
        x.dtype)


def banded_fused_stencil_plain(band: torch.Tensor, name: str, steps: int,
                               keep_top: bool = False,
                               keep_bottom: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function: ``steps``
    steps of :func:`repro_torch.core.reference.step_band`'s band
    semantics, each centre computed with ``torch.matmul`` over
    :func:`_band_matrices` (cast to the band's dtype, as the TPU kernel
    casts them) in fp32, on column tiles of the kernel's width.  On CUDA
    it needs fp32 matmuls in full precision
    (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default)
    and raises otherwise: TF32 would miss the 2e-5 it is held to."""
    st = get_stencil(name)
    if not st.is_linear or st.ndim != 2:
        raise ValueError(f"{name} is not a linear 2-D stencil; the banded "
                         f"path needs coefficients")
    if band.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("banded_fused_stencil_plain needs fp32 matmuls "
                           "(torch.backends.cuda.matmul.allow_tf32 is True)")
    r, tx = st.radius, MXU_CUDA_TILE[1]
    bands = torch.from_numpy(_band_matrices(st, tx)).to(band.device)
    bands = bands.to(band.dtype).float()
    for _ in range(steps):
        h = band.shape[0]
        interior = band[r:h - r].clone()
        interior[:, r:-r] = _banded_step_valid(band, st, bands, tx)
        parts = [band[:r]] if keep_top else []
        parts.append(interior)
        if keep_bottom:
            parts.append(band[h - r:])
        band = torch.cat(parts, dim=0) if len(parts) > 1 else interior
    return band


def banded_fused_stencil(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
    tile: Tuple[int, int] = MXU_CUDA_TILE,
) -> torch.Tensor:
    """``steps`` fused steps of a linear stencil on a (H, X) band, the
    centre of each step on the tensor cores.

    Drop-in alternative to
    :func:`repro_torch.kernels.stencil_multistep.fused_stencil_band` for
    linear stencils; nonlinear ones raise :class:`ValueError`.  A CPU band
    runs the plain version; a CUDA band launches the kernel (fp32 or
    bf16, contiguous) or raises.  ``banded_fused_stencil.launches``
    counts the kernel launches."""
    st = get_stencil(name)
    if not st.is_linear or st.ndim != 2:
        raise ValueError(f"{name} is not a linear 2-D stencil; the banded "
                         f"path needs coefficients")
    if band.device.type == "cpu":
        return banded_fused_stencil_plain(band, name, steps, keep_top,
                                          keep_bottom)
    from repro_torch.kernels._build import call_band_kernel

    out = call_band_kernel("repro_banded_fused_stencil", band, name, steps,
                           keep_top, keep_bottom, tile,
                           **_launch_args(name, steps))
    banded_fused_stencil.launches += 1
    return out


banded_fused_stencil.launches = 0


def _launch_args(name: str, steps: int):
    r = get_stencil(name).radius
    return dict(buffers=2, smem_bytes=lambda ty, tx: banded_smem_bytes(
        ty, tx, steps, r))


def banded_launch_shape(band: torch.Tensor, name: str, steps: int,
                        keep_top: bool = False, keep_bottom: bool = False,
                        tile: Tuple[int, int] = MXU_CUDA_TILE) -> dict:
    """The launch :func:`banded_fused_stencil` makes on this CUDA band
    (threads and shared bytes per CTA, CTAs per SM, grid, tile), without
    launching it; see :func:`repro_torch.kernels._build.launch_shape`."""
    from repro_torch.kernels._build import launch_shape

    return launch_shape("repro_banded_fused_stencil", band, name, steps,
                        keep_top, keep_bottom, tile,
                        **_launch_args(name, steps))
