"""Automatic run-time configuration selection (the paper's future work);
port of :mod:`repro.core.autotune`.

Sec. VII: "We also plan to refine the performance model which can be used
to automatically select the optimization target between kernel execution
and data transfer."  This module does exactly that: for a given stencil
code and hardware it enumerates the Sec. IV-C feasible set, *compiles the
candidate's full transfer/kernel op schedule* (a dry-run plan — exact
TransferStats geometry, zero engine execution, zero array allocation),
evaluates the Sec. III model over it, and returns the best
(engine, d, S_TB, k_on) with the predicted bottleneck.

Because the winning :class:`~repro_torch.core.plan.ExecutionPlan` is the very
object the executors run, a selected config's measured accounting equals
its predicted accounting field-for-field — the sweep costs what execution
costs.

Because the model is evaluated per engine, the selector also answers the
paper's Fig. 3a question ("which term should we optimize?") automatically:
if the feasible set's best SO2DR config is transfer-bound, more TB steps
are pointless and it says so.

The sharded (L2) sweep — :class:`ShardedChoice`, :func:`autotune_sharded`
and :func:`predicted_sharded_makespan` — ranks mesh decompositions x halo
depth on plans from :func:`repro_torch.core.shard.compile_sharded`; its
rankings equal the JAX package's on the same :class:`Hardware`.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import Iterable, List, Optional, Sequence, Tuple

from .analytic import EngineTimes, Hardware, model_times
from .compress import compress_plan
from .executor import DryRunExecutor
from .oocore import compile_box_plan, compile_plan
from .params import CodeSpec, feasible
from .plan import (
    BufferRead, BufferWrite, Compress, D2H, ExecutionPlan, FusedKernel, H2D,
)
from .stencil import Stencil
from .tiling import split_steps

__all__ = ["Choice", "autotune", "optimization_target",
           "BoxChoice", "autotune_box", "trapezoid_redundant_elements",
           "ShardedChoice", "autotune_sharded",
           "StageCost", "stage_costs", "pipeline_makespan",
           "predicted_makespan", "predicted_sharded_makespan"]


@dataclasses.dataclass(frozen=True)
class Choice:
    engine: str
    d: int
    s_tb: int
    k_on: int
    codec: str               # transfer codec ("identity" = uncompressed)
    time_s: float
    bottleneck: str          # "transfer" | "kernel"
    times: EngineTimes
    kernel_impl: str = "cuda_db"     # dispatch-registry implementation
    tile: Optional[tuple] = None     # kernel tile (None = impl default)

    @property
    def config(self):
        return dict(engine=self.engine, d=self.d, s_tb=self.s_tb,
                    k_on=self.k_on, codec=self.codec,
                    kernel_impl=self.kernel_impl, tile=self.tile)


def _bottleneck(t: EngineTimes, n_streams: int) -> str:
    return "transfer" if t.h2d + t.d2h >= t.kernel + t.odc else "kernel"


def _deprecated_tuner(old: str) -> None:
    warnings.warn(
        f"repro_torch.core.autotune.{old}() is deprecated; use "
        f"repro_torch.tune(repro_torch.TuneSpec(...)) — one entry point for "
        f"the row and box sweeps, with profile-aware costing and measured "
        f"refinement", DeprecationWarning, stacklevel=3)


def _autotune(
    st: Stencil,
    sz: int,
    n_steps: int,
    hw: Hardware,
    engines: Iterable[str] = ("so2dr", "resreu"),
    d_grid: Iterable[int] = (4, 8, 16),
    s_tb_grid: Iterable[int] = (20, 40, 80, 160, 320, 640),
    k_on_grid: Iterable[int] = (1, 2, 4, 8),
    codecs: Iterable[str] = ("identity", "zrle"),
    kernel_impls: Iterable[str] = ("reference", "cuda", "cuda_db"),
    tile_grid: Iterable[Optional[tuple]] = (None,),
    b_elem: int = 4,
    profile=None,
) -> List[Choice]:
    """Rank all feasible configs by modeled overlapped time (best first).

    Codec choice sweeps alongside ``(d, S_TB, k_on)``: the base plan is
    compiled once per geometry and rewritten per codec (the rewrite is a
    cheap op-stream pass), then costed by the same dry-run executor —
    wire bytes drive the transfer terms, so a codec only wins when the
    config is transfer-bound.

    The kernel-dispatch policy sweeps too: every candidate's kernel term
    is re-evaluated per implementation in ``kernel_impls`` x kernel tile
    in ``tile_grid`` (``None`` = the implementation's default tile) via
    :func:`repro_torch.kernels.dispatch.modeled_kernel_time` — per-step
    device-memory streaming for the reference path, tile-apron overhead
    and copy/compute (non-)overlap for the CUDA kernels.  Infeasible
    combinations (tile set exceeding the modeled shared memory,
    unsupported stencil) are skipped.  The beyond-paper ``mxu`` recast is
    opt-in (``kernel_impls=(..., "mxu")``): it changes which compute unit
    the Sec. III model assumes, which the paper-faithful sweep should not
    do silently.

    The default codec grid is lossless-only: the model charges no
    accuracy cost, so a lossy codec like ``bf16`` would weakly dominate
    whenever any transfer time exists and the tuner would silently
    recommend re-quantizing numerics.  Callers who accept the bf16 error
    bound opt in with ``codecs=("identity", "zrle", "bf16")``."""
    from repro_torch.kernels.dispatch import modeled_kernel_time

    code = CodeSpec(sz=sz, radius=st.radius, b_elem=b_elem,
                    total_steps=n_steps, n_arrays=2)
    Y = X = sz + 2 * st.radius
    out: List[Choice] = []
    for engine in engines:
        for d in d_grid:
            for s_tb in s_tb_grid:
                if s_tb > n_steps or not feasible(code, hw, d, s_tb):
                    continue
                k_ons = (1,) if engine == "resreu" else k_on_grid
                for k_on in k_ons:
                    try:
                        base = compile_plan(engine, st, Y, X, n_steps,
                                            d, s_tb, k_on, b_elem)
                    except ValueError:
                        continue
                    # kernel ops are codec-independent: model the
                    # (impl, tile) kernel terms once per geometry
                    kernel_terms = []
                    for impl in kernel_impls:
                        for tile in tile_grid:
                            kt = modeled_kernel_time(base, hw, impl, tile,
                                                     profile=profile)
                            if kt is not None:
                                kernel_terms.append((impl, tile, kt))
                    for codec in codecs:
                        try:
                            plan = compress_plan(base, codec)
                        except ValueError:
                            continue   # codec can't handle this itemsize
                        _, stats = DryRunExecutor().execute(plan)
                        t_base = model_times(stats, hw)
                        for impl, tile, (k_s, mem_s, cmp_s) in kernel_terms:
                            t = dataclasses.replace(
                                t_base, kernel=k_s, kernel_mem=mem_s,
                                kernel_compute=cmp_s)
                            out.append(Choice(
                                engine=engine, d=d, s_tb=s_tb, k_on=k_on,
                                codec=codec,
                                time_s=t.total_overlapped(hw.n_streams),
                                bottleneck=_bottleneck(t, hw.n_streams),
                                times=t,
                                kernel_impl=impl, tile=tile,
                            ))
    out.sort(key=lambda c: c.time_s)
    return out


def autotune(*args, **kwargs) -> List[Choice]:
    """Deprecated alias of the row-plan sweep — use :func:`repro_torch.tune`."""
    _deprecated_tuner("autotune")
    return _autotune(*args, **kwargs)


autotune.__doc__ = (autotune.__doc__ or "") + "\n\n" + (_autotune.__doc__ or "")


@dataclasses.dataclass(frozen=True)
class BoxChoice:
    """One ranked BoxTB configuration: tile grid x time depth (+ codec)."""

    tiles: Tuple[int, ...]
    time_depth: int
    k_on: int
    codec: str
    time_s: float
    bottleneck: str          # "transfer" | "kernel"
    times: EngineTimes
    redundant_elements: int  # trapezoid-apron overcompute, plan-derived
    redundancy: float        # redundant / exact

    @property
    def config(self):
        return dict(engine="box_tb", tiles=self.tiles,
                    time_depth=self.time_depth, k_on=self.k_on,
                    codec=self.codec)


def trapezoid_redundant_elements(st: Stencil, shape: Sequence[int],
                                 n_steps: int, tiles: Sequence[int],
                                 time_depth: int) -> int:
    """Closed-form redundant element-updates of a BoxTB schedule.

    Each round of ``k`` steps computes, per tile and per step ``s``
    (counting down, ``s = k-1`` last), an interior box whose extent along
    axis ``a`` is ``e_a + (k-1-s) * c_a * r`` where ``e_a`` is the tile's
    owned interior extent and ``c_a`` counts the tile's non-frame sides
    on that axis (0, 1, or 2) — the trapezoid: the apron starts ``k*r``
    deep per open side and loses ``r`` per step until only the owned box
    remains.  Summing the box volumes over steps, tiles, and rounds and
    subtracting the exact count ``n * prod(S_a - 2r)`` gives the
    redundancy the plan's :class:`~repro_torch.core.plan.TransferStats` must
    report (property-tested in ``tests/test_box_tb.py``)."""
    r = st.radius
    nd = len(shape)
    tiles = tuple(int(t) for t in tiles) + (1,) * (nd - len(tiles))
    if len(tiles) != nd:
        raise ValueError(f"tiles {tiles} over-ranks shape {tuple(shape)}")
    sizes = []   # per-axis near-even interior split (same as make_chunk_plan)
    for a in range(nd):
        interior, d = shape[a] - 2 * r, tiles[a]
        sizes.append([interior // d + (1 if i < interior % d else 0)
                      for i in range(d)])
    computed = 0
    for k in split_steps(n_steps, time_depth):
        for multi in itertools.product(*(range(t) for t in tiles)):
            base = [sizes[a][multi[a]] for a in range(nd)]
            open_sides = [(multi[a] != 0) + (multi[a] != tiles[a] - 1)
                          for a in range(nd)]
            for s in range(k):
                computed += math.prod(
                    base[a] + (k - 1 - s) * open_sides[a] * r
                    for a in range(nd))
    exact = n_steps * math.prod(s - 2 * r for s in shape)
    return computed - exact


def _autotune_box(
    st: Stencil,
    shape: Sequence[int],
    n_steps: int,
    hw: Hardware,
    tile_grid: Iterable[Sequence[int]] = ((1, 1), (2, 2), (4, 4)),
    time_depth_grid: Iterable[int] = (1, 2, 4),
    k_on_grid: Iterable[int] = (1,),
    codecs: Iterable[str] = ("identity",),
    b_elem: int = 4,
) -> List[BoxChoice]:
    """Rank BoxTB tile grids x time depths by modeled overlapped time
    (best first) — the box-plan companion of :func:`autotune`.

    Every candidate compiles its full :class:`~repro_torch.core.plan.
    ExecutionPlan` via :func:`~repro_torch.core.oocore.compile_box_plan`
    (infeasible geometry — an apron deeper than the smallest tile — is
    skipped exactly like the row sweep skips infeasible ``k_off``),
    rewrites it per codec, and is costed by the dry-run executor +
    Sec. III model.  The trade the ranking exposes: deeper ``time_depth``
    divides the H2D/D2H rounds by ``t`` while the trapezoid aprons grow
    the kernel term by the redundancy reported per choice — the N-D
    out-of-core analogue of the sharded engine's ``k_ici`` sweep."""
    out: List[BoxChoice] = []
    for tiles in tile_grid:
        for t in time_depth_grid:
            for k_on in k_on_grid:
                try:
                    base = compile_box_plan(st, shape, n_steps, tiles, t,
                                            k_on=k_on, itemsize=b_elem)
                except ValueError:
                    continue
                for codec in codecs:
                    try:
                        plan = compress_plan(base, codec)
                    except ValueError:
                        continue   # codec can't handle this itemsize
                    _, stats = DryRunExecutor().execute(plan)
                    tm = model_times(stats, hw)
                    out.append(BoxChoice(
                        tiles=tuple(int(x) for x in tiles), time_depth=t,
                        k_on=k_on, codec=codec,
                        time_s=tm.total_overlapped(hw.n_streams),
                        bottleneck=_bottleneck(tm, hw.n_streams),
                        times=tm,
                        redundant_elements=stats.redundant_elements,
                        redundancy=stats.redundancy))
    out.sort(key=lambda c: c.time_s)
    return out


def autotune_box(*args, **kwargs) -> List[BoxChoice]:
    """Deprecated alias of the BoxTB sweep — use :func:`repro_torch.tune`."""
    _deprecated_tuner("autotune_box")
    return _autotune_box(*args, **kwargs)


autotune_box.__doc__ = (autotune_box.__doc__ or "") + "\n\n" + (
    _autotune_box.__doc__ or "")


@dataclasses.dataclass(frozen=True)
class ShardedChoice:
    """One ranked L2 configuration: mesh decomposition + halo depth
    (+ halo codec)."""

    mesh: Tuple[int, int]
    k_ici: int
    time_s: float
    bottleneck: str          # "ici" | "kernel"
    ici_s: float
    kernel_s: float
    ici_bytes: int           # total send-side ICI payload (raw)
    redundancy: float        # plan-derived ghost-wedge overhead
    codec: str = "identity"  # halo codec ("identity" = raw exchange)
    ici_wire_bytes: int = 0  # total send-side ICI payload on the wire

    @property
    def config(self):
        return dict(mesh=self.mesh, k_ici=self.k_ici, codec=self.codec)


def _autotune_sharded(
    st: Stencil,
    Y: int,
    n_steps: int,
    hw: Hardware,
    n_devices: int = 8,
    k_ici_grid: Iterable[int] = (1, 2, 4, 8),
    codecs: Iterable[str] = ("identity",),
    b_elem: int = 4,
) -> List[ShardedChoice]:
    """Rank mesh decomposition x ``k_ici`` for the L2 sharded engine
    (best first) — the inter-chip companion of :func:`autotune`.

    Every factorization of ``n_devices`` into a ``(rows, cols)`` mesh is
    swept against the ``k_ici`` grid; each candidate compiles its full
    :class:`~repro_torch.core.plan.ShardedPlan` (infeasible geometry —
    indivisible domain, halo deeper than a shard, ``n % k_ici`` — is
    skipped exactly like the L1 sweep skips infeasible ``k_off``) and is
    costed from the plan-derived stats alone:

    * ICI time charges the max per-rank send bytes per round — *wire*
      bytes, so a halo codec shrinks this term — at ``bw_ici`` plus
      ``t_ici_latency`` per collective phase (two per round on a 2-D
      mesh) — the latency term is what makes the paper's trade visible:
      larger ``k_ici`` buys ``1/k`` fewer exchange phases for a
      near-constant per-step byte cost;
    * kernel time is the per-rank roofline over the max rank (ghost
      wedges included), so deeper halos pay their redundant compute.

    ``codecs`` sweeps the halo codec alongside ``(mesh, k_ici)``: the
    base plan is compiled once per geometry and rewritten per codec by
    :func:`~repro_torch.core.compress.compress_plan` (which learns the
    collective vocabulary on sharded plans), so ``ici_wire_bytes``
    replaces ``ici_bytes`` in the bandwidth term while a non-identity
    codec is charged one extra ``t_ici_latency`` per exchange phase for
    its encode/decode stage — zrle/bf16 halos only win when the config
    is latency-tolerant and bandwidth-bound.  The default grid is
    identity-only for the same reason the row sweep's is lossless-only:
    the model charges no accuracy cost.

    The two phases do not overlap in the exchange-then-compute schedule,
    so the total is their sum.  The per-device schedule knobs
    ``(d, S_TB, k_on, codec)`` stay orthogonal: compose this sweep with
    :func:`autotune` to pick the on-device plan each rank runs.

    ``Y`` is the *global framed* domain side (the sharded planner takes
    the full shape directly — mesh divisibility is part of feasibility).
    """
    from .shard import compile_sharded

    if hw.bw_ici <= 0:
        raise ValueError(f"hardware {hw.name!r} has no modeled ICI bandwidth")
    out: List[ShardedChoice] = []
    for n_row in range(1, n_devices + 1):
        if n_devices % n_row:
            continue
        mesh = (n_row, n_devices // n_row)
        for k_ici in k_ici_grid:
            try:
                base = compile_sharded(st.name, Y, Y, n_steps, k_ici, mesh,
                                       itemsize=b_elem)
            except ValueError:
                continue
            phases = (mesh[0] > 1) + (mesh[1] > 1)   # row + col exchanges
            # kernel ops are codec-independent: roofline once per geometry
            per = [base.per_rank_stats(r) for r in range(base.n_ranks)]
            k_mem = max(p.kernel_hbm_bytes for p in per) / hw.bw_dmem
            k_cmp = max(p.flops for p in per) / hw.peak_vpu_flops
            kernel_s = max(k_mem, k_cmp)
            for codec in codecs:
                try:
                    plan = (base if codec == "identity"
                            else compress_plan(base, codec))
                except ValueError:
                    continue   # codec can't handle this itemsize
                _, stats = DryRunExecutor().execute(plan)
                # a non-identity codec stages encode/decode around each
                # exchange phase: one extra latency charge per phase
                lat = phases * hw.t_ici_latency * (2 if codec != "identity"
                                                   else 1)
                ici_s = plan.rounds * (
                    lat + plan.collective_wire_bytes_per_round / hw.bw_ici)
                out.append(ShardedChoice(
                    mesh=mesh, k_ici=k_ici, time_s=ici_s + kernel_s,
                    bottleneck="ici" if ici_s >= kernel_s else "kernel",
                    ici_s=ici_s, kernel_s=kernel_s,
                    ici_bytes=stats.ici_bytes, redundancy=stats.redundancy,
                    codec=codec, ici_wire_bytes=stats.ici_wire_bytes))
    out.sort(key=lambda c: c.time_s)
    return out


def autotune_sharded(*args, **kwargs) -> List[ShardedChoice]:
    """Deprecated alias of the L2 sharded sweep — use :func:`repro_torch.tune`."""
    _deprecated_tuner("autotune_sharded")
    return _autotune_sharded(*args, **kwargs)


autotune_sharded.__doc__ = (autotune_sharded.__doc__ or "") + "\n\n" + (
    _autotune_sharded.__doc__ or "")


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Modeled resource demand of one ``(round, chunk)`` stage program.

    ``key is None`` marks a HostCommit barrier stage — zero demand, but
    a scheduling fence: the owning job's next H2D cannot start before
    every staged write of that job has drained."""

    key: Optional[Tuple[int, int]]
    h2d_s: float       # interconnect in  (wire bytes / bw_intc)
    d2h_s: float       # interconnect out (wire bytes / bw_intc)
    compute_s: float   # kernel roofline + on-device buffer copies


def stage_costs(plan: ExecutionPlan, hw: Hardware) -> List[StageCost]:
    """Cost every stage of ``plan`` under the Sec. III model.

    Transfers are charged at *wire* bytes (a ``Compress`` op adjusts its
    wrapped transfer by ``wire - raw``); BufferRead/Write traffic rides
    the device-memory bus, so it lands in the compute term alongside the kernel
    roofline — exactly the resource split
    :meth:`EngineTimes.total_overlapped` assumes, but per stage instead
    of per plan, which is what lets a scheduler reason about *inter-job*
    overlap."""
    out: List[StageCost] = []
    for key, ops in plan.stages():
        if key is None:
            out.append(StageCost(None, 0.0, 0.0, 0.0))
            continue
        h2d = d2h = 0
        compute = 0.0
        for op in ops:
            if isinstance(op, H2D):
                h2d += op.nbytes
            elif isinstance(op, D2H):
                d2h += op.nbytes
            elif isinstance(op, Compress):
                delta = op.wire_nbytes - op.raw_nbytes
                if op.direction == "h2d":
                    h2d += delta
                else:
                    d2h += delta
            elif isinstance(op, (BufferWrite, BufferRead)):
                compute += op.nbytes / hw.bw_dmem
            elif isinstance(op, FusedKernel):
                compute += max(op.hbm_bytes / hw.bw_dmem,
                               op.flops / hw.peak_vpu_flops)
        out.append(StageCost(key, h2d / hw.bw_intc, d2h / hw.bw_intc,
                             compute))
    return out


def pipeline_makespan(schedule: Iterable[Tuple[object, StageCost]]) -> float:
    """Makespan of a stage schedule on the three-engine machine.

    ``schedule`` is ``(job, StageCost)`` in issue order — possibly an
    interleaving of several jobs.  The machine is the paper's
    ``N_strm = 3`` pipeline: one H2D engine, one compute engine, one D2H
    engine, each serially ordered, a stage flowing H2D -> compute -> D2H.
    Barrier stages (``key is None``) model HostCommit: the owning job's
    next H2D waits until all of that job's staged writes have drained.
    Interleaving wins exactly when one job's transfer hides under
    another job's compute — idle engine time a single job cannot fill.
    """
    h2d_free = comp_free = d2h_free = 0.0
    commit: dict = {}    # job -> host rows ready (last barrier drain time)
    staged: dict = {}    # job -> drain time of its latest staged D2H
    t_end = 0.0
    for job, sc in schedule:
        if sc.key is None:
            t = staged.get(job, commit.get(job, 0.0))
            commit[job] = t
            t_end = max(t_end, t)
            continue
        start = max(h2d_free, commit.get(job, 0.0))
        h2d_free = start + sc.h2d_s
        comp_free = max(comp_free, h2d_free) + sc.compute_s
        d2h_free = max(d2h_free, comp_free) + sc.d2h_s
        staged[job] = d2h_free
        t_end = max(t_end, d2h_free)
    return t_end


def predicted_makespan(plan: ExecutionPlan, hw: Hardware) -> float:
    """Modeled solo makespan of one plan on the three-engine pipeline.

    The dry-run cost the serving layer's deadline-aware admission sorts
    on: no device work, no arrays — stage geometry in, seconds out."""
    return pipeline_makespan((0, sc) for sc in stage_costs(plan, hw))


def predicted_sharded_makespan(plan, hw: Hardware) -> float:
    """Modeled makespan of one sharded (or hierarchical) plan: the ICI
    exchange term plus the per-rank kernel roofline, priced exactly like
    one :func:`autotune_sharded` candidate.

    The ICI term charges *wire* bytes — a halo codec on the plan shrinks
    it, at the cost of one extra ``t_ici_latency`` per exchange phase
    for the encode/decode stage.  For a hierarchical plan the per-rank
    stats already roll the nested streaming program up, so the inner
    H2D/D2H traffic rides the kernel term's memory side the same way
    the sharded sweep sees ghost-wedge redundancy."""
    if hw.bw_ici <= 0:
        raise ValueError(f"hardware {hw.name!r} has no modeled ICI bandwidth")
    mesh = plan.mesh_shape
    phases = (mesh[0] > 1) + (mesh[1] > 1)
    codec = getattr(plan, "codec", "")
    lat = phases * hw.t_ici_latency * (2 if codec not in ("", "identity")
                                       else 1)
    ici_s = plan.rounds * (
        lat + plan.collective_wire_bytes_per_round / hw.bw_ici)
    per = [plan.per_rank_stats(r) for r in range(plan.n_ranks)]
    k_mem = max(p.kernel_hbm_bytes + p.h2d_wire_bytes + p.d2h_wire_bytes
                + p.buffer_bytes for p in per) / hw.bw_dmem
    k_cmp = max(p.flops for p in per) / hw.peak_vpu_flops
    return ici_s + max(k_mem, k_cmp)


def optimization_target(st: Stencil, sz: int, n_steps: int,
                        hw: Hardware) -> Optional[str]:
    """The paper's Fig. 3a decision, automated: what should be optimized
    next for the *best* config — 'kernel' or 'transfer'?

    Evaluated on uncompressed plans (the paper's setting): a transfer
    codec would shrink the wire term and skew the very comparison this
    reproduces.  Sweep ``tune(TuneSpec(..., codecs=...))`` directly to ask the
    codec-aware question."""
    ranked = _autotune(st, sz, n_steps, hw, codecs=("identity",))
    return ranked[0].bottleneck if ranked else None
