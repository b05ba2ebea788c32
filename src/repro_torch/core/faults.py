"""Deterministic fault injection for plan execution (a copy of
:mod:`repro.core.faults`, which is pure Python).

A :class:`FaultPlan` is a seeded, reproducible schedule of injected
failures: each :class:`FaultTrigger` names a ``(round, chunk, op_class,
kind)`` site, and a per-run :class:`FaultInjector` raises the matching
:class:`InjectedFault` the moment the lowered stage loop reaches that
site — *before* the op's closure executes, so the op has not mutated any
slot yet and a retry is simply a re-attempt.  That makes every recovery
path in :mod:`repro_torch.core.recovery` testable on the CPU and with no
real flakiness:

* ``transient_transfer`` — a recoverable wire hiccup; the stage loop
  retries it under a bounded-exponential-backoff :class:`RetryPolicy`.
* ``kernel_fault`` — a terminal device-side failure; the run dies with
  the last committed round intact.
* ``rank_loss`` — a mesh peer disappeared (preemption); it addresses a
  rank of a sharded plan, and the elastic harness in
  :mod:`repro_torch.launch.elastic` re-plans the remaining rounds on the
  surviving mesh.
* ``slot_exhausted`` — device slot storage ran out; terminal for the
  run, but the leased slots still return to the pool (the try/finally
  discipline in :meth:`repro_torch.core.lower.CompiledPlan.execute`).

For single-device :class:`~repro_torch.core.plan.ExecutionPlan` stages
``chunk`` is the plan's chunk index; for sharded plans the same field
addresses the *rank*.  This module is dependency-free on purpose — the
lowering layer imports it, never the other way around.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = [
    "TRANSIENT_TRANSFER", "KERNEL_FAULT", "RANK_LOSS", "SLOT_EXHAUSTED",
    "FAULT_KINDS",
    "InjectedFault", "TransientTransferError", "KernelFault",
    "RankLossFault", "SlotExhaustedError",
    "FaultTrigger", "FaultPlan", "FaultInjector", "RetryPolicy", "consult",
]

TRANSIENT_TRANSFER = "transient_transfer"
KERNEL_FAULT = "kernel_fault"
RANK_LOSS = "rank_loss"
SLOT_EXHAUSTED = "slot_exhausted"
FAULT_KINDS = (TRANSIENT_TRANSFER, KERNEL_FAULT, RANK_LOSS, SLOT_EXHAUSTED)


class InjectedFault(Exception):
    """Base of every injected failure.  ``transient`` faults are safe to
    retry in place (the faulting op never ran); terminal faults abort
    the run with the last committed round as the recovery point."""

    kind = "injected"
    transient = False

    def __init__(self, round: int, chunk: int, op_class: str):
        self.round = round
        self.chunk = chunk
        self.op_class = op_class
        super().__init__(
            f"{self.kind} injected at round={round} chunk={chunk} "
            f"op={op_class}")


class TransientTransferError(InjectedFault):
    """A recoverable transfer hiccup (dropped DMA, PCIe retry)."""

    kind = TRANSIENT_TRANSFER
    transient = True


class KernelFault(InjectedFault):
    """A terminal device-side kernel failure."""

    kind = KERNEL_FAULT


class RankLossFault(InjectedFault):
    """A mesh peer disappeared mid-round (preemption).  ``chunk``
    addresses the lost rank for sharded plans."""

    kind = RANK_LOSS

    @property
    def rank(self) -> int:
        return self.chunk


class SlotExhaustedError(InjectedFault):
    """Device slot storage exhausted — terminal for this run."""

    kind = SLOT_EXHAUSTED


_FAULT_TYPES = {
    TRANSIENT_TRANSFER: TransientTransferError,
    KERNEL_FAULT: KernelFault,
    RANK_LOSS: RankLossFault,
    SLOT_EXHAUSTED: SlotExhaustedError,
}


@dataclasses.dataclass(frozen=True)
class FaultTrigger:
    """One injection site: fire ``kind`` the first ``count`` times the
    executor reaches ``(round, chunk, op_class)``.

    ``chunk=None`` matches any chunk/rank of the round; ``op_class`` is
    an :data:`repro_torch.core.lower.OP_TAGS` name or ``"*"``.  ``count > 1``
    models a fault that persists across retries (a transient trigger
    with ``count <= max_retries`` is fully absorbed by the retry loop)."""

    round: int
    chunk: Optional[int]
    op_class: str
    kind: str
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.round < 0 or self.count < 1:
            raise ValueError(f"bad trigger {self!r}")

    def matches(self, rnd: int, chunk: int, op_class: str) -> bool:
        return (self.round == rnd
                and (self.chunk is None or self.chunk == chunk)
                and (self.op_class == "*" or self.op_class == op_class))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, deterministic schedule of injected faults.  Build
    one per scenario; mint a fresh mutable :class:`FaultInjector` per
    run (or per run *sequence* when counting across resumes)."""

    triggers: Tuple[FaultTrigger, ...]

    def __init__(self, triggers: Sequence[FaultTrigger]):
        object.__setattr__(self, "triggers", tuple(triggers))

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    @classmethod
    def seeded(cls, seed: int, plan, n_faults: int = 1,
               kinds: Sequence[str] = (TRANSIENT_TRANSFER,),
               op_classes: Sequence[str] = ("H2D",)) -> "FaultPlan":
        """Derive a reproducible fault schedule from a plan's geometry.

        Sites are drawn (with a :class:`random.Random` seeded by
        ``seed``) from the plan's real ``(round, chunk)`` stage keys —
        or ``(round, rank)`` pairs for a sharded plan — so the same seed
        against the same plan always injects the same faults."""
        rng = random.Random(seed)
        if hasattr(plan, "streams"):        # ShardedPlan
            keys = [(r, rank) for r in range(plan.rounds)
                    for rank in range(plan.n_ranks)]
        else:
            keys = sorted({k for k, _ in plan.stages() if k is not None})
        if not keys:
            raise ValueError("plan has no chunk stages to fault")
        triggers = [
            FaultTrigger(round=rnd, chunk=chunk,
                         op_class=rng.choice(list(op_classes)),
                         kind=rng.choice(list(kinds)))
            for rnd, chunk in (rng.choice(keys) for _ in range(n_faults))
        ]
        return cls(triggers)


class FaultInjector:
    """Per-run-sequence mutable state of a :class:`FaultPlan`: remaining
    trigger counts plus lifetime ``faults_injected``/``retries`` tallies
    (the source the recovery loop copies into :class:`ExecStats`)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._remaining: List[int] = [t.count for t in plan.triggers]
        self.faults_injected = 0
        self.retries = 0

    def before_op(self, rnd: int, chunk: int, op_class: str) -> None:
        """Raise the scheduled fault, if any, for this op site.  Called
        by the stage loop *before* the op's closure runs, so a raising
        site leaves all slots exactly as they were."""
        for i, trig in enumerate(self.plan.triggers):
            if self._remaining[i] > 0 and trig.matches(rnd, chunk, op_class):
                self._remaining[i] -= 1
                self.faults_injected += 1
                raise _FAULT_TYPES[trig.kind](rnd, chunk, op_class)

    def pending(self) -> int:
        """Triggers not yet fully fired."""
        return sum(1 for r in self._remaining if r > 0)

    def with_round_offset(self, offset: int) -> "FaultInjector":
        """A view translating local round ``r`` to global ``r + offset``
        — what the elastic harness hands a one-round continuation plan
        so triggers keep addressing global rounds."""
        return _OffsetInjector(self, offset)


class _OffsetInjector:
    def __init__(self, inner: FaultInjector, offset: int):
        self._inner = inner
        self._offset = offset

    def before_op(self, rnd: int, chunk: int, op_class: str) -> None:
        self._inner.before_op(rnd + self._offset, chunk, op_class)

    @property
    def faults_injected(self) -> int:
        return self._inner.faults_injected

    @property
    def retries(self) -> int:
        return self._inner.retries

    def with_round_offset(self, offset: int) -> "FaultInjector":
        return _OffsetInjector(self._inner, self._offset + offset)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient faults.

    ``sleep`` is injectable so tests never actually wait; the default
    delays are tiny because the injected faults they absorb are
    simulated — a real deployment would tune ``backoff_s`` to its
    transport."""

    max_retries: int = 3
    backoff_s: float = 0.001
    backoff_factor: float = 2.0
    max_backoff_s: float = 0.25
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)


def consult(injector, retry: Optional[RetryPolicy],
            rnd: int, chunk: int, op_class: str) -> None:
    """The stage loop's injection point: ask ``injector`` whether this
    op site faults; absorb transient faults by retrying (with backoff)
    up to ``retry.max_retries`` times; re-raise anything terminal or
    past the retry budget.  Counters accrue on the injector itself so
    they survive the raise."""
    attempt = 0
    while True:
        try:
            injector.before_op(rnd, chunk, op_class)
            return
        except InjectedFault as f:
            if not f.transient or retry is None or attempt >= retry.max_retries:
                raise
            retry.sleep(retry.delay(attempt))
            attempt += 1
            if hasattr(injector, "_inner"):
                injector._inner.retries += 1
            else:
                injector.retries += 1
