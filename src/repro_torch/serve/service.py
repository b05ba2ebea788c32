"""Stencil-as-a-service: a persistent plan server with warm caches (the
port of :mod:`repro.serve.service`).

A :class:`StencilService` owns, for its whole lifetime:

* one :class:`~repro_torch.core.lower.KernelCache` — kernel signatures
  seen for any job stay warm for every later job;
* one :class:`~repro_torch.core.lower.BucketRegistry` — cross-job shape
  buckets, so a job with an *unseen* shape that fits an existing bucket
  lowers onto already-registered kernel signatures (zero new compiles on
  a warm cache);
* one :class:`~repro_torch.core.lower.SlotPool` — device slot storage
  leased per run and returned at job retirement;
* on a card, one :class:`~repro_torch.core.lower.DomainPool` — the
  page-locked host domains its jobs copy their inputs into, leased per
  job and kept, still page-locked, for later jobs of the same geometry.

Jobs are specified as ``(shape, stencil, steps, codec, deadline)``
(:class:`StencilJob`), compiled through the planners and
:func:`~repro_torch.core.lower.lower` at submit time, priced by the
dry-run cost model (:func:`~repro_torch.core.autotune.predicted_makespan`),
and executed in deadline-aware shortest-predicted-first order by the
cross-job pipelined scheduler (:mod:`repro_torch.serve.scheduler`) on
:meth:`flush` — on CUDA each job's transfers run on a copy stream of
its own under the other jobs' kernels.

Two differences from the JAX package: the default hardware model is
:data:`~repro_torch.core.analytic.H100_SXM` (a ``profile`` still wins),
and the service takes ``device=None``, which means the card — with no
GPU, ``StencilService()`` raises instead of running on the CPU.

``submit`` is thread-safe (compilation runs outside the queue lock;
the kernel cache and bucket registry take their own locks), so a
server loop can admit jobs from concurrent request handlers and flush
from a single executor thread.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.analytic import H100_SXM, Hardware
from repro_torch.core.autotune import (
    predicted_makespan, predicted_sharded_makespan)
from repro_torch.core.device import resolve_device
from repro_torch.core.lower import (
    BucketRegistry, CompiledPlan, DomainPool, ExecStats, KernelCache,
    SlotPool, lower,
)
from repro_torch.core.oocore import compile_plan
from repro_torch.core.plan import TransferStats
from repro_torch.core.stencil import get_stencil

from .scheduler import (
    ScheduledJob, admission_order, modeled_makespan, run_interleaved,
)

__all__ = ["StencilJob", "JobResult", "StencilService"]


@dataclasses.dataclass(frozen=True)
class StencilJob:
    """One service request: what to compute and how urgently.

    ``shape`` is the *framed* host domain ``(Y, X)``; ``deadline`` is a
    relative budget in seconds (``None`` = best effort, runs after all
    deadline jobs).  The engine knobs default to the paper's SO2DR
    configuration; ``s_tb=None`` fuses all ``steps`` into one
    temporal block."""

    shape: Tuple[int, int]
    stencil: str
    steps: int
    codec: str = "identity"
    deadline: Optional[float] = None
    engine: str = "so2dr"
    d: int = 4
    s_tb: Optional[int] = None
    k_on: int = 2
    # fault-injection schedule (tests/chaos drills only): a
    # repro_torch.core.faults.FaultPlan consulted at every op site of
    # this job's stages, with transient faults retried under ``retry``
    faults: Optional[object] = None
    retry: Optional[object] = None


@dataclasses.dataclass
class JobResult:
    """What :meth:`StencilService.flush` returns per job, in execution
    order.

    ``status`` is ``"ok"`` or ``"failed"``; a failed job carries the
    typed :class:`~repro_torch.core.recovery.PlanExecutionError` in
    ``fault`` (with the injected cause and last committed round) and
    ``out=None`` — its slots were released the moment it died, and the
    rest of the batch completed normally."""

    job_id: int
    out: Optional[np.ndarray]
    stats: TransferStats          # plan-side accounting
    exec_stats: ExecStats         # execution-side counters (per job)
    predicted_s: float            # dry-run price admission sorted on
    latency_s: float              # flush start -> this job's last commit
    status: str = "ok"
    fault: Optional[BaseException] = None


class StencilService:
    """Long-lived stencil server amortizing compilation across jobs.

    ``profile`` — a :class:`~repro_torch.core.calibrate.DeviceProfile`
    (or a path to one): admission then prices ``predicted_makespan`` with
    the profile's *calibrated* constants instead of the data-sheet ``hw``
    table.  When both are given the profile wins.  ``device`` (None
    means ``cuda``) is where every job runs."""

    def __init__(self, hw: Hardware = H100_SXM, policy=None, profile=None,
                 device=None):
        from repro_torch.core.calibrate import DeviceProfile, resolve_hardware

        self.device = resolve_device(device)
        if isinstance(profile, str):
            profile = DeviceProfile.load(profile)
        self.profile = profile
        self.hw = hw if profile is None else resolve_hardware(profile)
        self.policy = policy
        self.kernel_cache = KernelCache()
        self.buckets = BucketRegistry()
        self.slot_pool = SlotPool()
        # jobs on a card page-lock their host domains; elsewhere each job
        # copies its input once, into its answer
        self.domain_pool = DomainPool() if self.device.type == "cuda" \
            else None
        self._lock = threading.Lock()
        self._queue: List[ScheduledJob] = []
        self._next_id = 0
        self.jobs_submitted = 0
        self.jobs_completed = 0
        self.jobs_failed = 0
        # the admission order of the last flush (ScheduledJobs), kept so
        # callers can re-price the batch (modeled interleaved vs solo)
        self.last_admission: List[ScheduledJob] = []
        self.exec_stats = ExecStats(executor="service")   # lifetime merge

    # -- compilation ---------------------------------------------------

    def compile_job(self, job: StencilJob, itemsize: int = 4) -> CompiledPlan:
        """Compile a job through the warm caches (no execution).

        The plan comes from the engine planners; lowering shares the
        service's kernel cache *and* routes band heights through the
        cross-job bucket registry, so an unseen shape that fits an
        existing bucket presents no new kernel signature."""
        Y, X = job.shape
        st = get_stencil(job.stencil)
        s_tb = job.steps if job.s_tb is None else job.s_tb
        plan = compile_plan(job.engine, st, Y, X, job.steps, job.d,
                            s_tb, job.k_on, itemsize=itemsize,
                            codec=None if job.codec == "identity"
                            else job.codec)
        return lower(plan, policy=self.policy,
                     kernel_cache=self.kernel_cache,
                     bucket_registry=self.buckets, device=self.device)

    # -- admission -----------------------------------------------------

    def submit(self, job: StencilJob, x: np.ndarray) -> int:
        """Admit a job: compile (warm caches), price it with the
        dry-run model, enqueue.  Thread-safe; returns the job id."""
        compiled = self.compile_job(job, itemsize=x.dtype.itemsize)
        predicted = predicted_makespan(compiled.plan, self.hw)
        injector = job.faults.injector() if job.faults is not None else None
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
            self._queue.append(ScheduledJob(
                job_id=job_id, compiled=compiled, x=x,
                predicted_s=predicted, deadline=job.deadline,
                injector=injector, retry=job.retry))
            self.jobs_submitted += 1
        return job_id

    # -- execution -----------------------------------------------------

    def flush(self) -> List[JobResult]:
        """Run every queued job through the cross-job pipeline.

        Jobs execute in deadline-aware shortest-predicted-first
        admission order, their stage programs interleaved under the
        double-buffered discipline; results come back in that execution
        order.  Per-job ``ExecStats`` also merge into the service's
        lifetime ``exec_stats``.  A job whose injected fault is terminal
        degrades gracefully: it returns ``status="failed"`` with the
        fault attached and never poisons the rest of the batch; any other
        error propagates."""
        with self._lock:
            batch, self._queue = self._queue, []
        ordered = admission_order(batch)
        self.last_admission = ordered
        results: List[JobResult] = []
        n_ok = 0
        for job, host, stats, latency, fault in run_interleaved(
                ordered, slot_pool=self.slot_pool,
                domain_pool=self.domain_pool):
            self.exec_stats.merge(stats)
            results.append(JobResult(
                job_id=job.job_id, out=host,
                stats=job.compiled.plan.stats(), exec_stats=stats,
                predicted_s=job.predicted_s, latency_s=latency,
                status="ok" if fault is None else "failed", fault=fault))
            n_ok += fault is None
        with self._lock:
            self.jobs_completed += n_ok
            self.jobs_failed += len(results) - n_ok
        return results

    def run_solo(self, job: StencilJob, x: np.ndarray) -> JobResult:
        """Run one job immediately, alone, under the same
        double-buffered discipline (the back-to-back baseline the
        interleaved makespan is compared against).  Bypasses the queue;
        still uses every warm cache."""
        compiled = self.compile_job(job, itemsize=x.dtype.itemsize)
        predicted = predicted_makespan(compiled.plan, self.hw)
        host, stats, exec_stats = compiled.execute(
            x, pipeline=True, slot_pool=self.slot_pool,
            domain_pool=self.domain_pool)
        exec_stats.executor = "pipelined"
        self.exec_stats.merge(exec_stats)
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
            self.jobs_submitted += 1
            self.jobs_completed += 1
        return JobResult(job_id=job_id, out=host, stats=stats,
                         exec_stats=exec_stats, predicted_s=predicted,
                         latency_s=exec_stats.wall_s)

    def run_sharded(self, plan, x: np.ndarray,
                    faults=None, retry=None) -> JobResult:
        """Run a sharded or hierarchical plan on the lockstep simulator,
        on the service's device, through the service's warm state.

        The simulator shares the service ``kernel_cache``
        (masked inner signatures stay warm across jobs) and — for
        hierarchical plans — leases every nested chunk slot from the
        service ``slot_pool``, releasing on retirement *and* on fault
        paths: after a mid-flush failure
        :meth:`~repro_torch.core.lower.SlotPool.assert_balanced` still
        holds.  The plan is priced by
        :func:`~repro_torch.core.autotune.predicted_sharded_makespan` on
        the service's hardware model.  A terminal injected
        fault degrades exactly like a queued job: ``status="failed"``
        with the typed error attached, accounting from the plan."""
        from repro_torch.core.executor import ShardedSimExecutor
        from repro_torch.core.recovery import PlanExecutionError

        ex = ShardedSimExecutor(slot_pool=self.slot_pool,
                                kernel_cache=self.kernel_cache,
                                device=self.device)
        predicted = predicted_sharded_makespan(plan, self.hw)
        injector = faults.injector() if faults is not None else None
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
            self.jobs_submitted += 1
        host: Optional[np.ndarray] = None
        fault: Optional[BaseException] = None
        try:
            host, _ = ex.execute(plan, x, injector=injector, retry=retry)
        except PlanExecutionError as e:
            fault = e
        exec_stats = ex.exec_stats or ExecStats(executor=ex.name)
        self.exec_stats.merge(exec_stats)
        with self._lock:
            if fault is None:
                self.jobs_completed += 1
            else:
                self.jobs_failed += 1
        return JobResult(job_id=job_id, out=host, stats=plan.stats(),
                         exec_stats=exec_stats, predicted_s=predicted,
                         latency_s=exec_stats.wall_s,
                         status="ok" if fault is None else "failed",
                         fault=fault)

    # -- pricing / introspection --------------------------------------

    def modeled_makespan(self, jobs: Optional[List[ScheduledJob]] = None,
                         interleaved: bool = True) -> float:
        """Dry-run makespan of a batch (default: the last flushed one)
        on this service's hardware model — interleaved or
        back-to-back."""
        jobs = self.last_admission if jobs is None else jobs
        return modeled_makespan(jobs, self.hw, interleaved=interleaved)

    def service_stats(self) -> dict:
        """Lifetime counters: warm-cache health + pool reuse."""
        hits, misses = self.kernel_cache.snapshot()
        return {
            "profile_id": (self.profile.profile_id
                           if self.profile is not None else None),
            "jobs_submitted": self.jobs_submitted,
            "jobs_completed": self.jobs_completed,
            "jobs_failed": self.jobs_failed,
            "kernel_signatures": len(self.kernel_cache),
            "kernel_cache_hits": hits,
            "kernel_compiles": misses,
            "shape_buckets": len(self.buckets),
            "slot_pool": self.slot_pool.stats(),
            "domain_pool": (self.domain_pool.stats()
                            if self.domain_pool is not None else None),
        }
