"""CUDA kernel: linear stencils as banded products on the tensor cores.

Replaces the Pallas TPU kernel
:func:`repro.kernels.stencil_banded_mxu.banded_fused_stencil`
(``src/repro/kernels/stencil_banded_mxu.py``, ``pallas_call`` at line
151), which recasts each time step of a *linear* stencil as ``2r+1``
banded matmuls on the MXU::

    centre = sum_dy  t[dy : TH-2r+dy, :] @ B_dy,     B_dy[x+dx, x] = c[dy, dx]

Source: ``csrc/banded_fused_stencil.cu``.  One CTA per output tile, the m
steps in shared memory as in :mod:`repro_torch.kernels.stencil_multistep`,
each step's centre computed with ``mma.sync`` TF32 in a 3xTF32 split (both
operands, fp32 accumulation) so that it meets the reference's 2e-5; the
band matrices are built in registers from the coefficients, never stored,
and only their nonzero K-blocks are multiplied.  It is not bitwise equal
to its plain version (the tensor cores sum in their own order), but it is
deterministic: the same band always gives the same bits.

Bound on an H100: operations for the wide box stencils (box2d4r at m=4:
161 FLOP per cell update at the 67 TFLOP/s fp32 rate outweigh the band's
bytes at 3.35 TB/s), bytes for the narrow ones.

:func:`mxu_wins` is the JAX package's napkin rule (same formula); with the
H100's data-sheet rates it sends no registry stencil here, which is what
``dispatch._auto_impl`` does on CUDA until measured rates say otherwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.stencil import Stencil, get_stencil
from repro_torch.kernels import MXU_CUDA_TILE, ceil_div

__all__ = ["banded_fused_stencil", "banded_fused_stencil_plain", "mxu_wins",
           "banded_smem_bytes"]


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


def banded_smem_bytes(ty: int, tx: int, steps: int, radius: int,
                      itemsize: int) -> int:
    """Shared memory of one CTA of the kernel: two apron'd tiles padded
    to whole ``mma`` fragments (``BandedLayout`` in the CUDA source)."""
    r = radius
    th, tw = ty + 2 * steps * r, tx + 2 * steps * r
    kblocks = ceil_div(8 + 2 * r, 8)
    rows = 16 * ceil_div(th - 2 * r, 16) + 2 * r
    cols = 8 * (ceil_div(tw - 2 * r, 8) + kblocks - 1)
    stride = ceil_div(cols - 4, 32) * 32 + 4
    return 2 * rows * stride * itemsize


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

    itemsize = band.element_size()
    out = call_band_kernel(
        "repro_banded_fused_stencil", band, name, steps, keep_top,
        keep_bottom, tile, buffers=2,
        smem_bytes=lambda ty, tx: banded_smem_bytes(ty, tx, steps, st.radius,
                                                    itemsize))
    banded_fused_stencil.launches += 1
    return out


banded_fused_stencil.launches = 0
