"""Plain PyTorch oracle for stencil computation (port of
:mod:`repro.core.reference`).

This is the ground truth every engine and kernel of the port is validated
against.  It uses the interior-update convention: the ``r``-wide frame is
Dirichlet (constant in time); only interior elements update.  Every
function returns fresh tensors and never writes its input.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stencil import Stencil, get_stencil

__all__ = [
    "step_domain",
    "run_reference",
    "step_band",
    "multi_step_band",
    "step_band_nd",
    "multi_step_box",
]


def step_domain(x: torch.Tensor, st: Stencil) -> torch.Tensor:
    """One time step on the full framed domain (shape-preserving)."""
    r = st.radius
    idx = (Ellipsis,) + (slice(r, -r),) * st.ndim
    out = x.clone()
    out[idx] = st.step_valid(x)
    return out


def run_reference(x: torch.Tensor, st: Stencil, n: int,
                  block_rows: Optional[int] = None) -> torch.Tensor:
    """n reference time steps on the framed domain, ping-ponging two
    domain buffers.

    ``block_rows`` computes each step in blocks of that many rows of the
    first spatial axis (None: one block).  The arithmetic is elementwise,
    so every blocking gives the same bits; blocks only bound the
    temporaries, which is what lets the oracle run on a domain that fills
    a sizeable share of device memory."""
    r, nd = st.radius, st.ndim
    length = x.shape[-nd]
    block_rows = block_rows or length
    rest = (slice(r, -r),) * (nd - 1)
    cur, nxt = x.clone(), x.clone()
    for _ in range(n):
        for lo in range(r, length - r, block_rows):
            hi = min(lo + block_rows, length - r)
            nxt[(Ellipsis, slice(lo, hi)) + rest] = st.step_valid(
                cur[(Ellipsis, slice(lo - r, hi + r))
                    + (slice(None),) * (nd - 1)])
        cur, nxt = nxt, cur
    return cur


def step_band(
    band: torch.Tensor, st: Stencil, keep_top: bool, keep_bottom: bool
) -> torch.Tensor:
    """One step on a horizontal band of rows.

    ``band`` is (H, X) — full domain width (left/right frame columns
    included), an arbitrary contiguous row range.  The output covers the rows
    whose update is computable, i.e. the band shrinks by ``r`` rows at each
    side unless that side is the domain frame (``keep_*``), in which case the
    frame rows are passed through unchanged.

    output height = H - 2r + (keep_top + keep_bottom) * r
    """
    r = st.radius
    h = band.shape[0]
    interior = band[r: h - r].clone()
    interior[:, r:-r] = st.step_valid(band)
    parts = []
    if keep_top:
        parts.append(band[:r])
    parts.append(interior)
    if keep_bottom:
        parts.append(band[h - r:])
    return torch.cat(parts, dim=0) if len(parts) > 1 else interior


def multi_step_band(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_top: bool = False,
    keep_bottom: bool = False,
) -> torch.Tensor:
    """``steps`` fused time steps on a band (compute area shrinks r/step).

    This is the *reference* for the fused k_on-step kernels: the CUDA
    implementations in :mod:`repro_torch.kernels` must match it.
    """
    st = get_stencil(name)
    for _ in range(steps):
        band = step_band(band, st, keep_top, keep_bottom)
    return band


def step_band_nd(
    band: torch.Tensor, st: Stencil, keep_lo, keep_hi
) -> torch.Tensor:
    """One step on an N-D box band (the :func:`step_band` generalization).

    Every axis carries ``r`` apron cells per side; the output drops each
    side's apron unless that side is the domain frame (``keep_lo[a]`` /
    ``keep_hi[a]``), in which case the frame cells pass through unchanged:

        out extent[a] = S[a] - 2r + (keep_lo[a] + keep_hi[a]) * r
    """
    r = st.radius
    full = band.clone()
    full[tuple(slice(r, s - r) for s in band.shape)] = st.step_valid(band)
    crop = tuple(
        slice(0 if kl else r, s if kh else s - r)
        for s, kl, kh in zip(band.shape, keep_lo, keep_hi)
    )
    return full[crop]


def multi_step_box(
    band: torch.Tensor,
    name: str,
    steps: int,
    keep_lo: tuple = (),
    keep_hi: tuple = (),
) -> torch.Tensor:
    """``steps`` fused time steps on an N-D box band.

    The reference kernel for non-banded
    :class:`~repro_torch.core.plan.FusedKernel` ops (3-D tiles, column
    chunks): compute volume shrinks ``r`` per step on every non-frame
    side, matching :func:`repro_torch.core.plan.fused_box_geometry`."""
    st = get_stencil(name)
    for _ in range(steps):
        band = step_band_nd(band, st, keep_lo, keep_hi)
    return band
