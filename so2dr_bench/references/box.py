"""The box stencils of SO2DR's Table III: a ``(2r+1)**2``-point weighted
sum, ``2 (2r+1)**2 - 1`` FLOPs per element.

The weights are a frozen copy of the paper suite's non-separable,
sum-to-one table ``w[iy, ix] = 1 + 0.1 iy + 0.01 ix + 0.003 iy ix``
normalised, in float64, rounded once to float32.  A step is one
``conv2d`` (a cross-correlation, so tap ``(dy, dx)`` reads
``x[i + dy, j + dx]``) with cuDNN's TF32 off: plain float32 products and
sums.  The control, ``tf32``, rounds both operands of every product to
TF32's 10-bit mantissa first, as a tensor-core TF32 product does, and
sums in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CONTROL = "tf32"
# the type the state is held in, per precision
DTYPES = {"fp32": torch.float32, CONTROL: torch.float32}


def coefficients(radius: int) -> np.ndarray:
    n = 2 * radius + 1
    iy, ix = np.mgrid[0:n, 0:n]
    w = 1.0 + 0.1 * iy + 0.01 * ix + 0.003 * iy * ix
    return (w / w.sum()).astype(np.float64)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties away from
    zero (``cvt.rna.tf32.f32``): the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def make_step(config: dict, precision: str, device):
    if precision not in DTYPES:
        raise ValueError(f"box reference has no precision {precision!r}")
    w = torch.tensor(coefficients(config["radius"]), dtype=torch.float32,
                     device=device)
    if precision == CONTROL:
        w = round_tf32(w)
    w = w[None, None]

    def step(x: torch.Tensor) -> torch.Tensor:
        if precision == CONTROL:
            x = round_tf32(x)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv2d(x[None, None], w)[0, 0]
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    return step
