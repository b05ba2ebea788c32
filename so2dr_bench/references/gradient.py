"""SO2DR's ``gradient2d``: the nonlinear 5-point stencil of Table III,
19 FLOPs per element.

``c + dt * (gn + gs + gw + ge) / sqrt(eps + gn**2 + gs**2 + gw**2 + ge**2)``
with ``g*`` the one-sided differences to the four neighbours,
``dt = 0.1`` and ``eps = 1e-3`` rounded to the working type.  The
control, ``bf16``, keeps the state and every operation in bfloat16 (no
product of this stencil is a matrix product, so TF32 does not apply).
"""
from __future__ import annotations

import torch

CONTROL = "bf16"
# the type the state is held in, per precision
DTYPES = {"fp32": torch.float32, CONTROL: torch.bfloat16}


def make_step(config: dict, precision: str, device):
    if precision not in DTYPES:
        raise ValueError(f"gradient reference has no precision {precision!r}")
    if config["radius"] != 1:
        raise ValueError("gradient2d has radius 1")
    dtype = DTYPES[precision]
    eps = torch.tensor(1e-3, dtype=dtype).item()
    dt = torch.tensor(0.1, dtype=dtype).item()

    def step(x: torch.Tensor) -> torch.Tensor:
        x = x.to(dtype)
        c = x[1:-1, 1:-1]
        gn = x[:-2, 1:-1] - c
        gs = x[2:, 1:-1] - c
        gw = x[1:-1, :-2] - c
        ge = x[1:-1, 2:] - c
        num = gn + gs + gw + ge
        den = gn * gn + gs * gs + gw * gw + ge * ge
        return c + dt * num * torch.rsqrt(den + eps)

    return step
