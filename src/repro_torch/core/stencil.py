"""Stencil definitions (PyTorch port of :mod:`repro.core.stencil`).

A :class:`Stencil` is the computing template of the paper (Sec. II-A): every
interior element is updated from its neighbours within ``radius``.  The
registry mirrors the paper's benchmark suite (Table III):

* ``box2d{1,2,3,4}r`` — box-type, ``(2x+1)**2`` points, arithmetic intensity
  ``2*(2x+1)**2 - 1`` FLOPs/element,
* ``gradient2d``      — star-type, 5 points, 19 FLOPs/element (nonlinear),
* ``star2d{1..4}r``   — star-type axis-only stencils (extra, used in tests),
* ``heat3d1r``        — the 3-D 7-point heat stencil.

All stencils use the *interior-update* convention: an ``r``-wide Dirichlet
frame around the domain is held constant; only interior elements are updated.

The coefficient tables are built by the same numpy arithmetic as the JAX
package, so they are bit-equal.  ``step_valid`` is a sliced multiply-add sum
in ``_linear_step``'s tap order — never ``conv2d``, which cuDNN runs in TF32
on CUDA by default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["Stencil", "get_stencil", "REGISTRY", "box_coeffs", "star_coeffs",
           "PAPER_BENCHMARKS"]


def box_coeffs(radius: int) -> np.ndarray:
    """Deterministic, non-separable, sum-to-one box coefficients.

    Distinct per-tap weights rule out accidental separable shortcuts in
    optimized kernels while keeping iterates bounded (weights sum to 1).
    """
    n = 2 * radius + 1
    iy, ix = np.mgrid[0:n, 0:n]
    w = 1.0 + 0.1 * iy + 0.01 * ix + 0.003 * iy * ix  # non-separable
    return (w / w.sum()).astype(np.float64)


def star_coeffs(radius: int) -> np.ndarray:
    """Axis-only (star) coefficients embedded in a (2r+1)x(2r+1) grid."""
    n = 2 * radius + 1
    c = np.zeros((n, n))
    for k in range(1, radius + 1):
        c[radius + k, radius] = c[radius - k, radius] = 0.35 / (2 * k * radius)
        c[radius, radius + k] = c[radius, radius - k] = 0.4 / (2 * k * radius)
    c[radius, radius] = 1.0 - c.sum()
    return c


def _as_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (JAX's ``jnp.asarray(value, dtype)``),
    returned as a Python float that the dtype represents exactly."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype).item())


@dataclasses.dataclass(frozen=True)
class Stencil:
    """An N-D stencil template (``ndim`` trailing spatial axes).

    ``step_valid`` maps a tensor to its "valid" region — every spatial
    extent shrinks by ``2r`` — the primitive everything else is built from.
    """

    name: str
    radius: int
    kind: str                    # "box" | "star" | "gradient" | "heat"
    flops_per_elem: int          # arithmetic intensity (paper Table III)
    points: int                  # taps read per output element
    _step_valid: Callable[[torch.Tensor], torch.Tensor]
    coeffs: np.ndarray | None = None   # (2r+1, 2r+1) for linear 2-D stencils
    ndim: int = 2                # spatial rank of the template

    def step_valid(self, x: torch.Tensor) -> torch.Tensor:
        """One time step on the valid interior: every spatial extent
        shrinks by ``2r`` (e.g. ``(H, W) -> (H-2r, W-2r)``)."""
        return self._step_valid(x)

    @property
    def is_linear(self) -> bool:
        return self.coeffs is not None

    def taps(self):
        """Nonzero ``(dy, dx, c)`` taps in ``_linear_step``'s order (the
        order the CUDA kernels accumulate in); linear stencils only."""
        return _taps(self.coeffs)


def _taps(coeffs: np.ndarray):
    n = coeffs.shape[0]
    return [(dy, dx, float(coeffs[dy, dx]))
            for dy in range(n) for dx in range(n) if coeffs[dy, dx] != 0.0]


def _linear_step(coeffs: np.ndarray) -> Callable[[torch.Tensor], torch.Tensor]:
    n = coeffs.shape[0]
    taps = _taps(coeffs)

    def step(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        acc = None
        for dy, dx, c in taps:
            sl = x[..., dy: h - (n - 1) + dy, dx: w - (n - 1) + dx]
            term = _as_dtype(c, x.dtype) * sl
            acc = term if acc is None else acc + term
        return acc

    return step


def _gradient_step(x: torch.Tensor) -> torch.Tensor:
    """5-point nonlinear gradient stencil (19 FLOPs/element).

    c + dt * (gn+gs+gw+ge) / sqrt(eps + gn^2+gs^2+gw^2+ge^2)  with
    g* the one-sided differences — an anisotropic-diffusion style update.
    """
    c = x[..., 1:-1, 1:-1]
    gn = x[..., :-2, 1:-1] - c
    gs = x[..., 2:, 1:-1] - c
    gw = x[..., 1:-1, :-2] - c
    ge = x[..., 1:-1, 2:] - c
    num = gn + gs + gw + ge
    den = gn * gn + gs * gs + gw * gw + ge * ge
    eps = _as_dtype(1e-3, x.dtype)
    dt = _as_dtype(0.1, x.dtype)
    return c + dt * num * torch.rsqrt(den + eps)


def _make_box(radius: int) -> Stencil:
    c = box_coeffs(radius)
    pts = (2 * radius + 1) ** 2
    return Stencil(
        name=f"box2d{radius}r",
        radius=radius,
        kind="box",
        flops_per_elem=2 * pts - 1,
        points=pts,
        _step_valid=_linear_step(c),
        coeffs=c,
    )


def _make_star(radius: int) -> Stencil:
    c = star_coeffs(radius)
    pts = 4 * radius + 1
    return Stencil(
        name=f"star2d{radius}r",
        radius=radius,
        kind="star",
        flops_per_elem=2 * pts - 1,
        points=pts,
        _step_valid=_linear_step(c),
        coeffs=c,
    )


def _heat3d_step(x: torch.Tensor) -> torch.Tensor:
    """3-D 7-point heat (star) stencil: explicit Euler Laplacian update.

    ``c + dt * (sum of 6 face neighbours - 6c)`` with ``dt = 0.1`` —
    weights sum to 1 and stay non-negative, so iterates remain bounded.
    """
    c = x[..., 1:-1, 1:-1, 1:-1]
    lap = (
        x[..., :-2, 1:-1, 1:-1] + x[..., 2:, 1:-1, 1:-1]
        + x[..., 1:-1, :-2, 1:-1] + x[..., 1:-1, 2:, 1:-1]
        + x[..., 1:-1, 1:-1, :-2] + x[..., 1:-1, 1:-1, 2:]
    )
    dt = _as_dtype(0.1, x.dtype)
    six = _as_dtype(6.0, x.dtype)
    return c + dt * (lap - six * c)


REGISTRY: Dict[str, Stencil] = {}
for _r in (1, 2, 3, 4):
    REGISTRY[f"box2d{_r}r"] = _make_box(_r)
    REGISTRY[f"star2d{_r}r"] = _make_star(_r)
REGISTRY["heat3d1r"] = Stencil(
    name="heat3d1r",
    radius=1,
    kind="heat",
    flops_per_elem=13,
    points=7,
    _step_valid=_heat3d_step,
    coeffs=None,
    ndim=3,
)
REGISTRY["gradient2d"] = Stencil(
    name="gradient2d",
    radius=1,
    kind="gradient",
    flops_per_elem=19,
    points=5,
    _step_valid=_gradient_step,
    coeffs=None,
)

PAPER_BENCHMARKS = ("box2d1r", "box2d2r", "box2d3r", "box2d4r", "gradient2d")


def get_stencil(name: str) -> Stencil:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown stencil {name!r}; known: {sorted(REGISTRY)}")
