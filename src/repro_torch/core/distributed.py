"""L2 (inter-device) SO2DR execution backend over ``torch.distributed``
(the port of :mod:`repro.core.distributed`).

The paper's trade one level up: shard the domain over a mesh of ranks
and exchange halos of depth ``k_ici * r`` once per ``k_ici`` steps, every
rank redundantly advancing its ghost wedges (communication-avoiding
stencils); ``k_ici = 1`` is classic per-step halo exchange.

* :func:`masked_local_steps` — ``k`` fused stencil steps on a shard's
  halo-extended band, the Dirichlet frame enforced by a global-index
  mask.  Both backends run it: every rank here, and the lowered lockstep
  simulator (:func:`repro_torch.core.lower.lower_sharded`) for every
  ``ShardKernel`` and masked inner kernel.  It is plain PyTorch on the
  band's device, as the JAX original is ``jnp`` under ``jax.jit`` (no
  Pallas kernel sits on this path).
* :func:`execute_sharded_plan` runs a
  :class:`~repro_torch.core.plan.ShardedPlan` on a
  :class:`~repro_torch.core.ranks.RankMesh` — one process per rank, the
  port's counterpart of the JAX ``shard_map`` program;
  :func:`run_distributed` is the plan-free convenience (and a
  differential oracle next to
  :func:`repro_torch.core.reference.run_reference`).
* :func:`collective_bytes_per_round` — the analytic per-rank halo bytes
  per round (pure).

Implementation notes (those of the JAX module, carried over):

* 2-D domain decomposition (rows over one mesh axis, columns over the
  other); corner halos ride along by exchanging rows first, then the
  columns of the row-extended band.
* each ``ppermute`` shift becomes point-to-point ``isend``/``irecv``
  pairs (:func:`_shift`); a rank at a mesh edge receives zeros where
  ``ppermute`` leaves zeros, so every rank's band has one shape and the
  frame mask proves those zeros are never read by a valid cell.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .lower import check_domain
from .ranks import DEFAULT_TIMEOUT_S, RankMesh
from .stencil import Stencil, get_stencil

__all__ = [
    "distributed_stencil_step_fn", "run_distributed",
    "execute_sharded_plan", "masked_local_steps",
    "collective_bytes_per_round",
]


def _shift(x: torch.Tensor, ctx, axis: int, direction: int) -> torch.Tensor:
    """ppermute shift along mesh axis ``axis``: this rank's payload goes
    to the rank ``direction`` steps along it, and what the rank as far
    the other way sent comes back (zeros past the mesh edge).

    ``ctx`` is the rank's :class:`~repro_torch.core.ranks._RankContext`.
    With host staging the payload crosses as a page-locked CPU copy
    (gloo takes CPU tensors) and the received halo goes back to the
    band's device."""
    import torch.distributed as dist

    dst = ctx.neighbour(axis, direction)
    src = ctx.neighbour(axis, -direction)
    tag = 2 * axis + (direction > 0)
    ops, recv = [], None
    if dst is not None:
        # column slices are strided: send a contiguous copy
        send = x.contiguous()
        if ctx.staged:
            send = torch.empty(x.shape, dtype=x.dtype,
                               pin_memory=True).copy_(x)
        ops.append(dist.P2POp(dist.isend, send, dst, tag=tag))
    if src is not None:
        recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=ctx.staged,
                           device="cpu" if ctx.staged else x.device)
        ops.append(dist.P2POp(dist.irecv, recv, src, tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is None:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return recv.to(x.device) if ctx.staged else recv


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


def _local_rounds(own: torch.Tensor, st: Stencil, k: int, rounds: int,
                  ctx, Yg: int, Xg: int) -> torch.Tensor:
    """``rounds`` rounds of (halo exchange + k fused local steps) on one
    rank's owned block ``own``; ``ctx`` places the rank in the mesh and
    times its halo exchanges and masked updates."""
    r = st.radius
    hk = k * r
    ly, lx = own.shape
    # global coordinates of the extended band
    gy0 = ctx.row * ly - hk
    gx0 = ctx.col * lx - hk

    def exchange(own):
        # row halos (full local width), then column halos of the
        # row-extended band (corners ride along)
        top = _shift(own[-hk:], ctx, ctx.row_axis, +1)
        bot = _shift(own[:hk], ctx, ctx.row_axis, -1)
        ext = torch.cat([top, own, bot], dim=0)
        left = _shift(ext[:, -hk:], ctx, ctx.col_axis, +1)
        right = _shift(ext[:, :hk], ctx, ctx.col_axis, -1)
        return torch.cat([left, ext, right], dim=1)

    for _ in range(rounds):
        ext = ctx.timed_halo(lambda: exchange(own))
        ext = ctx.timed_update(
            lambda: masked_local_steps(ext, st, k, gy0, gx0, Yg, Xg))
        own = ext[hk:-hk, hk:-hk]
    return own


def distributed_stencil_step_fn(name: str, k_ici: int, n_steps: int,
                                mesh: RankMesh, row_axis: str = "data",
                                col_axis: str = "model"):
    """The program advancing a framed global domain by ``n_steps`` on
    ``mesh`` (``n/k`` rounds; n must be divisible by k for the uniform
    scan — the launcher enforces it): a function of a host domain that
    returns the new one."""
    st = get_stencil(name)
    if n_steps % k_ici:
        raise ValueError("n_steps must be divisible by k_ici (uniform scan)")
    rounds = n_steps // k_ici

    def global_fn(x) -> np.ndarray:
        return mesh.run(x, st.name, k_ici, rounds, row_axis, col_axis)

    return global_fn


def run_distributed(x, name: str, n_steps: int, k_ici: int, mesh: RankMesh,
                    row_axis: str = "data", col_axis: str = "model"):
    fn = distributed_stencil_step_fn(name, k_ici, n_steps, mesh, row_axis,
                                     col_axis)
    return fn(x)


def check_sharded_domain(plan, x) -> None:
    """The geometry checks both sharded backends share, made before any
    rank starts: trailing plans cannot execute, and the domain must
    match the plan's shape and itemsize."""
    if getattr(plan, "trailing", ()):
        raise ValueError(
            f"plan models trailing axes {plan.trailing}; trailing plans "
            "are dry-run-only (byte/flop accounting) and cannot execute")
    check_domain(plan, x)


def execute_sharded_plan(plan, x, mesh: RankMesh = None,
                         row_axis: str = "data", col_axis: str = "model",
                         device=None, timeout: float = DEFAULT_TIMEOUT_S):
    """Run a :class:`~repro_torch.core.plan.ShardedPlan` on the
    multi-process backend.

    ``mesh`` defaults to a fresh ``plan.mesh_shape``
    :class:`~repro_torch.core.ranks.RankMesh` on ``device`` (None means
    ``cuda``), closed again before this returns; an explicit mesh must
    match the plan's shape.  The plan carries the full geometry, so the
    schedule the accounting was derived from is the schedule that
    executes."""
    check_sharded_domain(plan, x)
    if mesh is None:
        with RankMesh(plan.mesh_shape, (row_axis, col_axis), device=device,
                      timeout=timeout) as mesh:
            return execute_sharded_plan(plan, x, mesh, row_axis, col_axis)
    shape = (mesh.shape[row_axis], mesh.shape[col_axis])
    if shape != tuple(plan.mesh_shape):
        raise ValueError(
            f"mesh shape {shape} does not match plan mesh {plan.mesh_shape}")
    fn = distributed_stencil_step_fn(plan.stencil, plan.k_ici, plan.n,
                                     mesh, row_axis, col_axis)
    return fn(np.asarray(x))


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
