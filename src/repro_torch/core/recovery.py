"""Recovery: typed execution failure, HostCommit checkpoint/resume (the
port of :mod:`repro.core.recovery`).

``HostCommit`` is the only ordering barrier an executor must respect
(:class:`repro_torch.core.plan.HostCommit`), which makes round boundaries
exact, bit-reproducible recovery points: after round ``r`` commits, the
host array *is* the complete machine state — registers and buffers
never cross a barrier.  This module turns that property into a
fault-tolerance API:

* :class:`PlanExecutionError` — what a terminal
  :class:`~repro_torch.core.faults.InjectedFault`
  surfaces as, carrying the last committed round and the plan
  fingerprint so a supervisor knows exactly where to resume.
* :func:`plan_fingerprint` — a stable digest of a plan's full geometry
  and op stream; a checkpoint taken under one fingerprint is never
  resumed into a different plan.
* :func:`resume_plan` — compiles a continuation plan of the rounds at
  or after ``from_round`` by filtering the op stream (every op carries
  its round; registers/buffers are intra-round, so the suffix is a
  well-formed plan).
* :class:`PlanCheckpointer` — the per-round commit hook: snapshots
  ``(host array, round index, plan fingerprint)`` through
  :class:`repro_torch.checkpoint.manager.CheckpointManager` every ``every``
  rounds (the cadence knob).
* :func:`run_with_recovery` — the supervisor loop: execute; on a
  terminal fault restore the newest matching checkpoint, resume from
  the following round, repeat.  Crash at *any* round → resume →
  bit-identical to the uninterrupted run, for every engine × executor
  × codec (``tests/test_torch_faults.py``).

The plan's ``repr`` equals the JAX package's for the same plan, so
:func:`plan_fingerprint` does too, and a checkpoint written by either
package resumes in the other.  :func:`run_with_recovery`'s default
executor runs on the card (``EagerExecutor()``, ``device=None``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np

from .faults import FaultInjector, FaultPlan, RetryPolicy
from .plan import ExecutionPlan, FusedKernel

__all__ = [
    "PlanExecutionError", "plan_fingerprint", "resume_plan",
    "PlanCheckpointer", "run_with_recovery", "RetryPolicy",
]


class PlanExecutionError(RuntimeError):
    """Terminal execution failure with an exact recovery point.

    ``last_committed_round`` is the newest round whose ``HostCommit``
    barrier fully drained before the failure (``-1`` when nothing
    committed); resuming from ``last_committed_round + 1`` on the
    committed host state reproduces the uninterrupted run bitwise."""

    def __init__(self, message: str, fault: Optional[BaseException] = None,
                 last_committed_round: int = -1, fingerprint: str = ""):
        super().__init__(message)
        self.fault = fault
        self.last_committed_round = last_committed_round
        self.fingerprint = fingerprint

    @property
    def next_round(self) -> int:
        return self.last_committed_round + 1


def plan_fingerprint(plan) -> str:
    """Stable content digest of a plan (an
    :class:`~repro_torch.core.plan.ExecutionPlan`, a
    :class:`~repro_torch.core.plan.ShardedPlan` or a
    :class:`~repro_torch.core.hierarchy.HierarchicalPlan`): every field of
    every op is a plain value, so the dataclass repr is deterministic
    across processes and equals the JAX package's."""
    return hashlib.sha256(repr(plan).encode()).hexdigest()[:16]


def _round_steps(plan: ExecutionPlan) -> dict:
    """Time steps advanced per round, read off the op stream: for one
    representative chunk of each round, the FusedKernel ``steps`` sum to
    the round's step count (uniform across the round's chunks)."""
    rep_chunk: dict = {}
    for op in plan.ops:
        if isinstance(op, FusedKernel):
            c = rep_chunk.get(op.round)
            if c is None or op.chunk < c:
                rep_chunk[op.round] = op.chunk
    steps: dict = {}
    for op in plan.ops:
        if isinstance(op, FusedKernel) and op.chunk == rep_chunk[op.round]:
            steps[op.round] = steps.get(op.round, 0) + op.steps
    return steps


def resume_plan(plan: ExecutionPlan, from_round: int) -> ExecutionPlan:
    """The continuation plan: all ops of rounds ``>= from_round``.

    Valid because registers and buffers never cross a ``HostCommit``
    barrier — a round's op group is self-contained given the committed
    host state.  ``exact_elements`` is rescaled to the remaining time
    steps so redundancy accounting stays honest on the continuation."""
    if from_round <= 0:
        return plan
    ops = tuple(op for op in plan.ops if op.round >= from_round)
    steps = _round_steps(plan)
    remaining = sum(v for r, v in steps.items() if r >= from_round)
    per_step = plan.exact_elements // plan.n if plan.n else 0
    return dataclasses.replace(plan, ops=ops,
                               exact_elements=per_step * remaining)


class PlanCheckpointer:
    """The per-round commit hook: every ``every`` rounds, snapshot the
    committed host array + round index + plan fingerprint through a
    :class:`~repro_torch.checkpoint.manager.CheckpointManager`.

    Pass :attr:`on_commit` to an executor's ``execute`` (or to
    :func:`run_with_recovery`, which wires it for you); ``every`` is the
    cadence knob — a resume after a skipped round just recomputes from
    the newest snapshot, correctness is cadence-independent."""

    def __init__(self, manager, plan, every: int = 1):
        if every < 1:
            raise ValueError(f"checkpoint cadence every={every} must be >= 1")
        self.manager = manager
        self.fingerprint = plan_fingerprint(plan)
        self.every = every
        self.saves = 0

    def on_commit(self, rnd: int, host: np.ndarray) -> None:
        if rnd % self.every:
            return
        self.manager.save(rnd, {"host": host},
                          extra_meta={"round": rnd,
                                      "plan_fingerprint": self.fingerprint})
        self.saves += 1

    def latest(self) -> Optional[Tuple[int, np.ndarray]]:
        """Newest snapshot taken under this plan's fingerprint, as
        ``(round, host)`` — ``None`` when nothing matching exists."""
        for step in reversed(self.manager.all_steps()):
            tree, meta = self.manager.restore({"host": None}, step)
            if meta.get("plan_fingerprint") == self.fingerprint:
                return int(meta["round"]), tree["host"]
        return None


def run_with_recovery(plan: ExecutionPlan, x: np.ndarray, executor=None,
                      faults: Optional[FaultPlan] = None,
                      retry: Optional[RetryPolicy] = None,
                      checkpoint: Optional[PlanCheckpointer] = None,
                      max_resumes: int = 8):
    """Supervised execution: run ``plan``; on a terminal fault, restore
    the newest checkpoint and re-execute the continuation plan from the
    following round, up to ``max_resumes`` times.

    Returns ``(host, stats)`` like any executor; the executor's
    ``exec_stats`` afterwards carries the *lifetime* fault counters
    (``faults_injected``/``retries`` across all attempts, plus
    ``resumes``).  With ``checkpoint=None`` terminal faults propagate —
    recovery needs a durable round snapshot to resume from.  A crash
    before the first commit restarts the whole plan from ``x``.  The
    default executor runs on the card."""
    from .executor import EagerExecutor

    executor = executor if executor is not None else EagerExecutor()
    injector = None
    if faults is not None:
        injector = faults if isinstance(faults, FaultInjector) \
            else faults.injector()
    on_commit = checkpoint.on_commit if checkpoint is not None else None
    cur_plan, cur_x = plan, x
    resumes = 0
    while True:
        try:
            host, stats = executor.execute(cur_plan, cur_x,
                                           injector=injector, retry=retry,
                                           on_commit=on_commit)
        except PlanExecutionError:
            if checkpoint is None or resumes >= max_resumes:
                raise
            latest = checkpoint.latest()
            if latest is None:
                cur_plan, cur_x = plan, x        # nothing durable yet
            else:
                rnd, host_state = latest
                cur_plan, cur_x = resume_plan(plan, rnd + 1), host_state
            resumes += 1
            continue
        es = executor.exec_stats
        if es is not None:
            es.resumes = resumes
            if injector is not None:
                es.faults_injected = injector.faults_injected
                es.retries = injector.retries
        return host, stats
