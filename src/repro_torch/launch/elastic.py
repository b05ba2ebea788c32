"""Elastic re-planning: survive topology change mid-run (the port of
:mod:`repro.launch.elastic`).

Two layers of elasticity live here:

* **Checkpoint resharding** (the LM half): checkpoints store full
  (unsharded) arrays and shardings are *derived* (``param_specs`` is a
  pure function of config + mesh), so an elastic restart reduces to
  rebuild mesh → re-derive placements (:func:`replan`) → place the
  restored leaves on the new mesh (:func:`reshard_restored`,
  ``distribute_tensor``); :func:`gather_full` is what a save reads from
  DTensor leaves.
* **Plan-IR elasticity** (the stencil half, below).


A :class:`~repro_torch.core.plan.ShardedPlan` commits host state once at
its final store phase, so :func:`run_elastic_sharded` executes it as a
sequence of *one-round continuation plans* — after every round the
cropped owned regions land on the host, which is exactly the
``HostCommit`` barrier state of the single-device engines.  On an
injected :class:`~repro_torch.core.faults.RankLossFault` (a preemption),
:func:`shrink_mesh` drops a mesh row/column, :func:`replan_sharded`
compiles the remaining rounds on the surviving mesh, and only the
faulted round is redone — **a preemption costs one round** of
transfers, never the run.  The default executor is a
:class:`~repro_torch.core.executor.ShardedSimExecutor` on ``device``
(None means ``cuda``); the real multi-process backend is
:class:`~repro_torch.core.executor.ShardMapExecutor`
(``executor_factory=lambda mesh: ShardMapExecutor(...)``), whose rank
processes the harness stops as soon as their mesh is left behind.

"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faults import FaultInjector, FaultPlan, InjectedFault, \
    RankLossFault, RetryPolicy
from repro_torch.core.plan import ShardedPlan
from repro_torch.core.recovery import PlanExecutionError, plan_fingerprint
from repro_torch.core.shard import compile_sharded

__all__ = ["replan", "reshard_restored", "gather_full",
           "ElasticReport", "shrink_mesh", "replan_sharded",
           "run_elastic_sharded"]


def replan(cfg, params_shape, mesh):
    """Derive shardings (a tree of :class:`~repro_torch.launch.sharding.
    NamedSharding`) for an arbitrary (possibly new) mesh."""
    from .sharding import named, param_specs

    return named(mesh, param_specs(cfg, params_shape, mesh))


def reshard_restored(restored, shardings):
    """Place host leaves from ``CheckpointManager.restore`` (numpy arrays,
    or CPU bf16 tensors) onto the new mesh: every rank passes the whole
    leaf, ``distribute_tensor`` keeps its shard on the mesh's device."""
    from torch.distributed.tensor import distribute_tensor

    from .sharding import map_with_path

    flat = {}
    map_with_path(lambda p, s: flat.__setitem__(p, s), shardings)

    def place(path, leaf):
        s = flat[path]
        # np.require keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
        t = leaf if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.require(leaf, requirements="C"))
        return distribute_tensor(t.to(s.mesh.device_type), s.mesh,
                                 s.placements)

    return map_with_path(place, restored)


def gather_full(tree):
    """Every DTensor leaf of ``tree`` as a whole tensor (an all-gather
    that every rank of its mesh joins); other leaves as they are."""
    from .sharding import map_with_path

    return map_with_path(
        lambda _, t: t.full_tensor() if hasattr(t, "full_tensor") else t,
        tree)


# --------------------------------------------------------------------------
# Plan-IR elasticity: ShardedPlan × rank loss → re-plan on the survivors.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ElasticReport:
    """What an elastic run cost: ``rounds_executed`` counts dispatched
    round attempts (each moves one round of shard transfers), so
    ``extra_rounds`` — attempts beyond the fault-free count — is exactly
    the transfer price of the preemptions survived."""

    rounds_total: int
    rounds_executed: int
    replans: int
    mesh_history: Tuple[Tuple[int, int], ...]
    faults_injected: int
    fingerprint: str

    @property
    def extra_rounds(self) -> int:
        return self.rounds_executed - self.rounds_total


def shrink_mesh(mesh_shape: Tuple[int, int],
                lost_rank: int) -> Tuple[int, int]:
    """The surviving mesh after losing one rank: drop the mesh row
    holding it (uniform shards make which row irrelevant), or a column
    when the mesh is a single row."""
    n_row, n_col = mesh_shape
    if lost_rank < 0 or lost_rank >= n_row * n_col:
        raise ValueError(f"rank {lost_rank} not in mesh {mesh_shape}")
    if n_row > 1:
        return (n_row - 1, n_col)
    if n_col > 1:
        return (n_row, n_col - 1)
    raise ValueError("cannot lose the only rank of a (1, 1) mesh")


def replan_sharded(plan: ShardedPlan, from_round: int,
                   mesh_shape: Optional[Tuple[int, int]] = None,
                   lost_rank: Optional[int] = None) -> ShardedPlan:
    """The continuation plan: the rounds at or after ``from_round`` on
    ``mesh_shape`` (default: the surviving mesh after ``lost_rank``
    died, or the original mesh).  Feasibility is re-checked by
    :func:`~repro_torch.core.shard.compile_sharded` — a domain that no longer
    divides the shrunken mesh raises, exactly like a fresh compile."""
    if mesh_shape is None:
        mesh_shape = shrink_mesh(plan.mesh_shape, lost_rank) \
            if lost_rank is not None else plan.mesh_shape
    remaining = (plan.rounds - from_round) * plan.k_ici
    if remaining <= 0:
        raise ValueError(f"nothing to replan: from_round={from_round} of "
                         f"{plan.rounds} rounds")
    return compile_sharded(plan.stencil, plan.Y, plan.X, remaining,
                           plan.k_ici, mesh_shape, itemsize=plan.itemsize)


def _close(executor) -> None:
    close = getattr(executor, "close", None)
    if close is not None:
        close()


def run_elastic_sharded(plan: ShardedPlan, x: np.ndarray,
                        faults: Optional[FaultPlan] = None,
                        retry: Optional[RetryPolicy] = None,
                        executor_factory: Optional[Callable] = None,
                        max_replans: int = 4,
                        device=None,
                        ) -> Tuple[np.ndarray, ElasticReport]:
    """Execute a sharded plan one round at a time, surviving rank loss.

    Each round runs as a one-round continuation plan
    (:func:`replan_sharded` with the current round and mesh); between
    rounds the host array holds the complete committed state.  A
    :class:`~repro_torch.core.faults.RankLossFault` injected mid-round (fault
    triggers address global ``(round, rank)`` sites) shrinks the mesh,
    re-plans the remaining rounds on the survivors, and redoes *only*
    the faulted round.  Any other terminal fault propagates as a
    :class:`~repro_torch.core.recovery.PlanExecutionError` whose
    ``last_committed_round`` is the newest fully-stored round.

    ``executor_factory(mesh_shape)`` builds the per-mesh executor
    (default: a fresh :class:`~repro_torch.core.executor.ShardedSimExecutor`
    on ``device``, None meaning ``cuda``).  An executor without
    per-op injection (``supports_injection`` false, e.g.
    :class:`~repro_torch.core.executor.ShardMapExecutor`) dispatches one
    fused program, so injection is probed per rank before dispatch
    instead.  Every executor the factory builds is closed (when it has a
    ``close``) once the harness is done with it — replaced after a rank
    loss, or at the end of the run — so no rank process outlives its
    mesh."""
    from repro_torch.core.executor import ShardedSimExecutor

    if executor_factory is None:
        def executor_factory(mesh_shape):
            return ShardedSimExecutor(device=device)

    injector = None
    if faults is not None:
        injector = faults if isinstance(faults, FaultInjector) \
            else faults.injector()

    fp = plan_fingerprint(plan)
    host = np.asarray(x)
    mesh = plan.mesh_shape
    rounds = plan.rounds
    mesh_history = [mesh]
    ex = executor_factory(mesh)
    rnd = replans = executed = 0
    try:
        while rnd < rounds:
            # one-round continuation plan on the current mesh
            step = replan_sharded(plan, plan.rounds - 1, mesh_shape=mesh)
            try:
                executed += 1
                if injector is None:
                    host, _ = ex.execute(step, host)
                elif getattr(ex, "supports_injection", False):
                    host, _ = ex.execute(
                        step, host, injector=injector.with_round_offset(rnd),
                        retry=retry)
                else:
                    # fused-program backend: probe every rank's site before
                    # dispatch (the program itself is all-or-nothing)
                    view = injector.with_round_offset(rnd)
                    for rank in range(step.n_ranks):
                        view.before_op(0, rank, "ShardKernel")
                    host, _ = ex.execute(step, host)
                rnd += 1
            except (PlanExecutionError, InjectedFault) as e:
                f = e.fault if isinstance(e, PlanExecutionError) else e
                if not isinstance(f, RankLossFault) or replans >= max_replans:
                    raise PlanExecutionError(
                        f"elastic sharded run failed at round {rnd}: {f}",
                        fault=f, last_committed_round=rnd - 1,
                        fingerprint=fp) from e
                # the surviving mesh takes over from the last stored round;
                # only the faulted round's transfers are repeated
                mesh = shrink_mesh(mesh, f.rank)
                mesh_history.append(mesh)
                replans += 1
                old, ex = ex, executor_factory(mesh)
                if ex is not old:
                    _close(old)
    finally:
        _close(ex)
    return host, ElasticReport(
        rounds_total=rounds, rounds_executed=executed, replans=replans,
        mesh_history=tuple(mesh_history),
        faults_injected=injector.faults_injected if injector else 0,
        fingerprint=fp)
