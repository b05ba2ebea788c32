"""Sharded-plan planner: (shape, stencil, mesh shape, k_ici, n) → per-rank
op streams (the port of :mod:`repro.core.shard`; pure Python).

The multi-chip engine runs the paper's trade one level up: shard the
domain over the device mesh and exchange halos of depth ``k_ici * r``
once per ``k_ici`` steps, every rank redundantly advancing its ghost
wedges (communication-avoiding stencils, cf. Reguly & Mudalige, arXiv
1709.02125).  This module compiles that schedule into a
:class:`~repro_torch.core.plan.ShardedPlan`:

* one op stream per :class:`~repro_torch.core.plan.DeviceShard` — per
  round a row-halo exchange (``HaloSend``/``HaloRecv`` on the owned
  band), a column-halo exchange on the row-extended band (corners ride
  along), and a :class:`~repro_torch.core.plan.ShardKernel` running
  ``k_ici`` masked fused steps before cropping back to the owned region;
* a global barrier structure (``plan.barriers``): sends and recvs live
  in separate phases, so any executor that honours phase order is
  lockstep-correct and deadlock-free by construction;
* plan-derived accounting: per-rank ICI bytes, ghost-wedge redundancy,
  and ``collective_bytes_per_round`` all read off the op streams.

Executors: :class:`repro_torch.core.executor.DryRunExecutor` costs a
sharded plan with zero devices, and
:class:`repro_torch.core.executor.ShardedSimExecutor` runs the per-rank
streams through :func:`repro_torch.core.lower.lower_sharded` stage
programs on one device, and
:class:`repro_torch.core.executor.ShardMapExecutor` runs them on a mesh
of rank processes.  Infeasible geometry raises with the JAX package's
messages, word for word.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .plan import (
    DeviceShard, HaloRecv, HaloSend, ShardKernel, ShardLoad, ShardOp,
    ShardStore, ShardedPlan,
)
from .stencil import get_stencil

__all__ = ["compile_sharded", "ghost_wedge_elements", "shard_working_set"]


def shard_working_set(ly: int, lx: int, hk: int, itemsize: int,
                      trailing: Tuple[int, ...] = ()) -> int:
    """Bytes resident on a device while one round's kernel runs: the
    halo-extended input band plus the equally sized output band (the
    shard_map backend and the lockstep simulator both hold exactly this
    pair), times any unsharded trailing axes."""
    t_mult = math.prod(trailing) if trailing else 1
    return 2 * (ly + 2 * hk) * (lx + 2 * hk) * itemsize * t_mult


def _overlap(lo: int, hi: int, lo2: int, hi2: int) -> int:
    return max(0, min(hi, hi2) - max(lo, lo2))


def ghost_wedge_elements(Y: int, X: int, radius: int, k_ici: int, n: int,
                         mesh_shape: Tuple[int, int]) -> int:
    """Closed-form element-update count of the k_ici ghost-wedge schedule.

    Every rank updates the interior portion of its extended band's
    centre — ``(ly + 2*k*r - 2r) x (lx + 2*k*r - 2r)`` clipped to the
    global interior — on each of the ``k_ici`` steps of every round, so
    redundant work grows with the halo depth ``k_ici * r`` while the
    number of collective phases shrinks as ``1/k_ici``.  The planner's
    per-op ``elements`` sum to exactly this value (property-tested in
    ``tests/test_shard_plan.py``)."""
    n_row, n_col = mesh_shape
    ly, lx = Y // n_row, X // n_col
    hk = k_ici * radius
    r = radius
    total = 0
    for i in range(n_row):
        for j in range(n_col):
            y0, x0 = i * ly - hk, j * lx - hk
            rows = _overlap(y0 + r, y0 + ly + 2 * hk - r, r, Y - r)
            cols = _overlap(x0 + r, x0 + lx + 2 * hk - r, r, X - r)
            total += (n // k_ici) * k_ici * rows * cols
    return total


def compile_sharded(stencil, Y: int, X: int, n: int, k_ici: int,
                    mesh_shape: Tuple[int, int],
                    itemsize: int = 4,
                    c_dev: Optional[int] = None,
                    trailing: Tuple[int, ...] = ()) -> ShardedPlan:
    """Compile ``(shape, stencil, mesh shape, k_ici, n)`` into per-rank
    schedules — geometry only, no arrays and no devices touched.

    Feasibility mirrors the execution backend: the domain must divide
    evenly over the mesh (``shard_map`` requirement), ``n`` must be a
    multiple of ``k_ici`` (uniform scan), and the halo depth
    ``k_ici * r`` must fit inside a shard (one-hop ``ppermute``
    neighbour exchange).

    ``c_dev`` (bytes) bounds a shard's resident working set — the
    in/out halo-extended band pair (:func:`shard_working_set`); a shard
    that exceeds it is rejected here with a pointer at
    :func:`repro.core.hierarchy.compile_hierarchical`, which streams the
    band chunk-wise instead.  ``None`` skips the check (the historical
    behaviour).  ``trailing`` models extra unsharded axes (e.g. the
    third axis of a 3-D domain streamed wholesale): byte/flop/element
    accounting scales by the trailing volume; only ``trailing=()`` plans
    are executable."""
    st = get_stencil(stencil) if isinstance(stencil, str) else stencil
    r = st.radius
    n_row, n_col = mesh_shape
    if n_row < 1 or n_col < 1:
        raise ValueError(f"bad mesh shape {mesh_shape}")
    if n <= 0 or k_ici <= 0 or n % k_ici:
        raise ValueError(
            f"n={n} must be a positive multiple of k_ici={k_ici} "
            "(uniform scan, same constraint as the shard_map backend)")
    if Y % n_row or X % n_col:
        raise ValueError(
            f"domain ({Y}, {X}) does not divide evenly over mesh "
            f"{mesh_shape} (shard_map requires uniform shards)")
    ly, lx = Y // n_row, X // n_col
    hk = k_ici * r
    if (n_row > 1 and hk >= ly) or (n_col > 1 and hk >= lx):
        raise ValueError(
            f"halo depth k_ici*r={hk} does not fit in a ({ly}, {lx}) "
            "shard (one-hop neighbour exchange)")
    if any(t < 2 * r + 1 for t in trailing):
        raise ValueError(
            f"trailing axes {trailing} need at least 2r+1={2 * r + 1} "
            "points each (frame + one interior point)")
    if c_dev is not None:
        ws = shard_working_set(ly, lx, hk, itemsize, trailing)
        if ws > c_dev:
            raise ValueError(
                f"shard working set {ws} bytes (in/out band pair for a "
                f"({ly}, {lx}) shard with halo {hk}) exceeds the device "
                f"budget c_dev={c_dev}; use "
                "repro.core.hierarchy.compile_hierarchical to stream the "
                "shard chunk-wise")
    rounds = n // k_ici
    t_mult = math.prod(trailing) if trailing else 1
    t_interior = math.prod(t - 2 * r for t in trailing) if trailing else 1

    shards = tuple(
        DeviceShard(rank=i * n_col + j, row=i, col=j,
                    y0=i * ly, y1=(i + 1) * ly,
                    x0=j * lx, x1=(j + 1) * lx)
        for i in range(n_row) for j in range(n_col))
    streams: List[List[ShardOp]] = [[] for _ in shards]
    barriers: List[str] = []

    def phase(label: str) -> int:
        barriers.append(label)
        return len(barriers) - 1

    shard_bytes = ly * lx * itemsize * t_mult
    row_halo = hk * lx * itemsize * t_mult            # full local width
    col_halo = hk * (ly + 2 * hk) * itemsize * t_mult  # row-extended height

    p = phase("load")
    for sh in shards:
        streams[sh.rank].append(ShardLoad(
            rank=sh.rank, box=sh.box, nbytes=shard_bytes, round=0, phase=p))

    for rnd in range(rounds):
        # row halos of the owned band, then column halos of the
        # row-extended band — the ppermute order of _local_rounds, which
        # carries the corner halos along with the column exchange
        p = phase(f"r{rnd}:row-send")
        for sh in shards:
            if sh.row + 1 < n_row:
                streams[sh.rank].append(HaloSend(
                    rank=sh.rank, dst=sh.rank + n_col, axis=0, side="hi",
                    depth=hk, nbytes=row_halo, round=rnd, phase=p))
            if sh.row > 0:
                streams[sh.rank].append(HaloSend(
                    rank=sh.rank, dst=sh.rank - n_col, axis=0, side="lo",
                    depth=hk, nbytes=row_halo, round=rnd, phase=p))
        p = phase(f"r{rnd}:row-recv")
        for sh in shards:
            up = sh.rank - n_col if sh.row > 0 else -1
            dn = sh.rank + n_col if sh.row + 1 < n_row else -1
            streams[sh.rank].append(HaloRecv(
                rank=sh.rank, src=up, axis=0, side="lo", depth=hk,
                nbytes=row_halo if up >= 0 else 0, round=rnd, phase=p))
            streams[sh.rank].append(HaloRecv(
                rank=sh.rank, src=dn, axis=0, side="hi", depth=hk,
                nbytes=row_halo if dn >= 0 else 0, round=rnd, phase=p))
        p = phase(f"r{rnd}:col-send")
        for sh in shards:
            if sh.col + 1 < n_col:
                streams[sh.rank].append(HaloSend(
                    rank=sh.rank, dst=sh.rank + 1, axis=1, side="hi",
                    depth=hk, nbytes=col_halo, round=rnd, phase=p))
            if sh.col > 0:
                streams[sh.rank].append(HaloSend(
                    rank=sh.rank, dst=sh.rank - 1, axis=1, side="lo",
                    depth=hk, nbytes=col_halo, round=rnd, phase=p))
        p = phase(f"r{rnd}:col-recv")
        for sh in shards:
            lf = sh.rank - 1 if sh.col > 0 else -1
            rt = sh.rank + 1 if sh.col + 1 < n_col else -1
            streams[sh.rank].append(HaloRecv(
                rank=sh.rank, src=lf, axis=1, side="lo", depth=hk,
                nbytes=col_halo if lf >= 0 else 0, round=rnd, phase=p))
            streams[sh.rank].append(HaloRecv(
                rank=sh.rank, src=rt, axis=1, side="hi", depth=hk,
                nbytes=col_halo if rt >= 0 else 0, round=rnd, phase=p))
        p = phase(f"r{rnd}:compute")
        h, w = ly + 2 * hk, lx + 2 * hk
        for sh in shards:
            gy0, gx0 = sh.y0 - hk, sh.x0 - hk
            rows = _overlap(gy0 + r, gy0 + h - r, r, Y - r)
            cols = _overlap(gx0 + r, gx0 + w - r, r, X - r)
            elements = k_ici * rows * cols * t_interior
            streams[sh.rank].append(ShardKernel(
                rank=sh.rank, stencil=st.name, steps=k_ici,
                gy0=gy0, gx0=gx0, h=h, w=w,
                hbm_bytes=2 * h * w * itemsize * t_mult,
                flops=elements * st.flops_per_elem,
                elements=elements, round=rnd, phase=p))

    p = phase("store")
    for sh in shards:
        streams[sh.rank].append(ShardStore(
            rank=sh.rank, box=sh.box, nbytes=shard_bytes,
            round=rounds - 1, phase=p))

    exact = n * (Y - 2 * r) * (X - 2 * r) * t_interior
    return ShardedPlan(
        stencil=st.name, Y=Y, X=X, itemsize=itemsize, n=n, k_ici=k_ici,
        mesh_shape=(n_row, n_col), radius=r, shards=shards,
        streams=tuple(tuple(s) for s in streams), barriers=tuple(barriers),
        exact_elements=exact, trailing=tuple(trailing))
