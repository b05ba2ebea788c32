"""The per-rank math of the L2 (inter-device) engine: the port of two
pure pieces of :mod:`repro.core.distributed`.

* :func:`masked_local_steps` — ``k`` fused stencil steps on a shard's
  halo-extended band, the Dirichlet frame enforced by a global-index
  mask.  The lowered lockstep simulator
  (:func:`repro_torch.core.lower.lower_sharded`) runs it for every
  ``ShardKernel`` and for every masked inner kernel of a hierarchical
  plan.  It is plain PyTorch on the band's device, as the JAX original
  is ``jnp`` under ``jax.jit`` (no Pallas kernel sits on this path).
* :func:`collective_bytes_per_round` — the analytic per-rank halo bytes
  per round (pure).

The multi-process backend (``run_distributed``,
``execute_sharded_plan``) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .stencil import Stencil

__all__ = ["masked_local_steps", "collective_bytes_per_round"]


def masked_local_steps(ext: torch.Tensor, st: Stencil, k: int, gy0: int,
                       gx0: int, Yg: int, Xg: int) -> torch.Tensor:
    """``k`` fused stencil steps on an extended band, Dirichlet frames
    enforced by a global-index mask.

    ``ext`` covers global rows/cols ``[gy0, gy0+ey) x [gx0, gx0+ex)`` of
    a ``(Yg, Xg)`` framed domain.  The mask is built per call from
    ``torch.arange`` on the band's device, so one callable serves every
    rank and round.  Returns a fresh tensor: ``ext`` is never written
    (a halo payload or a caller may still hold a view of it)."""
    r = st.radius
    ey, ex = ext.shape
    dev = ext.device
    # frame mask over the *centre* region only
    grow = gy0 + r + torch.arange(ey - 2 * r, device=dev)
    gcol = gx0 + r + torch.arange(ex - 2 * r, device=dev)
    interior = (((grow >= r) & (grow < Yg - r))[:, None]
                & ((gcol >= r) & (gcol < Xg - r))[None, :])
    out = ext.clone()
    for _ in range(k):
        centre = torch.where(interior, st.step_valid(out), out[r:-r, r:-r])
        out[r:-r, r:-r] = centre
    return out


def collective_bytes_per_round(
    local_shape: Tuple[int, int], radius: int, k_ici: int, itemsize: int
) -> int:
    """Analytic per-rank ICI bytes per round (send side): two row halos of
    ``k*r`` rows (full width) + two column halos of the extended height.

    The formula form of
    :attr:`repro_torch.core.plan.ShardedPlan.collective_bytes_per_round`,
    which derives the same number from the plan's HaloSend ops (equal
    for interior ranks)."""
    ly, lx = local_shape
    hk = k_ici * radius
    rows = 2 * hk * lx
    cols = 2 * hk * (ly + 2 * hk)
    return (rows + cols) * itemsize
