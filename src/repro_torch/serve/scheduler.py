"""Cross-job pipelined scheduling for :class:`~repro_torch.serve.service.StencilService`
(the port of :mod:`repro.serve.scheduler`).

The paper's SO2DR schedule hides transfer under compute *within* one
job; a warm service can do strictly better by interleaving the
per-(round, chunk) stage programs of M concurrent jobs, so one job's
H2D rides under another job's kernels — overlap a single job's barrier
structure can never express.  On CUDA that overlap is real: each job's
H2D copies run on a copy stream of its own, from its page-locked host
array, under the kernels the compute stream runs for every job — the
paper's N_strm = 3 carried across jobs.  Streams are per job because a
job's HostCommit synchronizes its copy stream; on a shared one, job A's
commit would wait on job B's prefetched copies and serialise the jobs.

Soundness of the round-robin merge: each job's stages stay in its own
plan order, so every earlier stage of job *j* (including its HostCommit
barriers) has executed before any later stage of *j* is issued.  The
double-buffered prefetch discipline from
:class:`~repro_torch.core.lower.CompiledPlan` carries over unchanged — a
stage's prefetchable prefix (H2D + host-side Compress) is issued early
only when the stage is a chunk stage, never across its own job's
barrier, and always against its own job's runtime.

Admission ordering is deadline-aware shortest-predicted-first: the
dry-run cost model (:func:`repro_torch.core.autotune.predicted_makespan`)
prices each job with zero device work, jobs with deadlines sort ahead
of best-effort jobs, and ties break on job id for determinism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.analytic import Hardware
from repro_torch.core.autotune import pipeline_makespan, stage_costs
from repro_torch.core.faults import InjectedFault, consult
from repro_torch.core.lower import CompiledPlan, ExecStats, OP_TAGS, SlotPool
from repro_torch.core.recovery import PlanExecutionError

__all__ = ["ScheduledJob", "admission_order", "interleave_stages",
           "modeled_makespan", "run_interleaved"]

_KERNEL_TAG = OP_TAGS.index("FusedKernel")


@dataclasses.dataclass
class ScheduledJob:
    """One admitted job: its compiled plan, input domain, and the
    dry-run price admission sorted on."""

    job_id: int
    compiled: CompiledPlan
    x: np.ndarray
    predicted_s: float
    deadline: Optional[float] = None
    # fault-injection hooks (None in production): consulted before every
    # bound op of this job's stages, retried under ``retry``
    injector: Optional[object] = None
    retry: Optional[object] = None


def admission_order(jobs: Sequence[ScheduledJob]) -> List[ScheduledJob]:
    """Deadline-aware shortest-predicted-makespan-first admission.

    Jobs carrying a deadline run before best-effort jobs and among
    themselves by earliest deadline; within a deadline class the
    cheapest predicted job goes first (SJF minimizes mean latency);
    job id breaks the remaining ties deterministically."""
    return sorted(jobs, key=lambda j: (
        j.deadline if j.deadline is not None else float("inf"),
        j.predicted_s, j.job_id))


def interleave_stages(jobs: Sequence[ScheduledJob],
                      ) -> List[Tuple[ScheduledJob, int]]:
    """Round-robin merge of the jobs' stage programs.

    One stage per job per cycle, in admission order, preserving each
    job's internal stage order — the schedule both the makespan model
    and :func:`run_interleaved` walk."""
    merged: List[Tuple[ScheduledJob, int]] = []
    cursors = [0] * len(jobs)
    remaining = sum(len(j.compiled.stages) for j in jobs)
    while remaining:
        for i, job in enumerate(jobs):
            if cursors[i] < len(job.compiled.stages):
                merged.append((job, cursors[i]))
                cursors[i] += 1
                remaining -= 1
    return merged


def modeled_makespan(jobs: Sequence[ScheduledJob], hw: Hardware,
                     interleaved: bool = True, profile=None) -> float:
    """Dry-run makespan of the job set on the three-engine pipeline.

    ``interleaved=True`` prices the round-robin merge; ``False`` prices
    the same jobs back-to-back (no device work either way).  ``profile``
    (a :class:`~repro_torch.core.calibrate.DeviceProfile` or a path)
    substitutes calibrated constants for ``hw``."""
    if profile is not None:
        from repro_torch.core.calibrate import resolve_hardware

        hw = resolve_hardware(profile)
    costed = {j.job_id: stage_costs(j.compiled.plan, hw) for j in jobs}
    if interleaved:
        schedule = [(job.job_id, costed[job.job_id][s])
                    for job, s in interleave_stages(jobs)]
        return pipeline_makespan(schedule)
    return sum(pipeline_makespan((j.job_id, sc) for sc in costed[j.job_id])
               for j in jobs)


def run_interleaved(jobs: Sequence[ScheduledJob],
                    slot_pool: Optional[SlotPool] = None,
                    ) -> List[Tuple[ScheduledJob, Optional[np.ndarray],
                                    ExecStats, float,
                                    Optional[PlanExecutionError]]]:
    """Execute the merged schedule; one result tuple per job, in the
    given (admission) order: ``(job, host_out, exec_stats, latency_s,
    fault)``.

    Each job gets its own :class:`~repro_torch.core.lower._Runtime`
    (slot storage leased from ``slot_pool`` when given) and, on CUDA, its
    own copy stream and page-locked host array; the merged walk applies
    the double-buffered prefetch rule across the *merged* sequence, so
    job B's H2D is issued while job A's kernels are still in flight.  A
    job's host array is unregistered, after its copy stream drains, when
    the job retires, when it faults, or on the way out of a failed
    flush.  Latency is stamped when a job's last stage retires (its
    final barrier has drained its staged writes into the host array).

    Graceful degradation: a job whose injector raises a terminal fault
    is *isolated* — its leased slots are released on the spot, its
    remaining merged entries are skipped, and it comes back with
    ``host_out=None`` and the typed ``fault`` attached — while every
    other job's stage walk continues untouched.  Only an injected fault
    isolates a job; any other error (a CUDA error, a kernel build)
    propagates."""
    perf = time.perf_counter
    runtimes = {}
    try:
        for job in jobs:
            dev = job.compiled.device
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            rt = job.compiled.runtime(job.x, slot_pool, stream)
            runtimes[job.job_id] = rt
            rt.pin()
        merged = interleave_stages(jobs)
        n = len(merged)
        prefetched = [False] * n
        wall: Dict[int, List[float]] = {
            j.job_id: [0.0] * len(OP_TAGS) for j in jobs}
        counts: Dict[int, List[int]] = {
            j.job_id: [0] * len(OP_TAGS) for j in jobs}
        snap: Dict[int, Tuple[int, int]] = {}   # job -> (hits, misses) deltas
        inj0: Dict[int, Tuple[int, int]] = {}   # job -> (faults, retries) at t0
        for j in jobs:
            snap[j.job_id] = (0, 0)
            inj0[j.job_id] = ((j.injector.faults_injected, j.injector.retries)
                              if j.injector is not None else (0, 0))
        latency: Dict[int, float] = {}
        failed: Dict[int, PlanExecutionError] = {}
        last_stage = {j.job_id: len(j.compiled.stages) - 1 for j in jobs}

        def run(job: ScheduledJob, ops) -> None:
            rt = runtimes[job.job_id]
            w, c = wall[job.job_id], counts[job.job_id]
            cache = job.compiled.cache
            h0, m0 = cache.snapshot()
            try:
                for tag, fn, rnd, chunk in ops:
                    if job.injector is not None:
                        consult(job.injector, job.retry, rnd, chunk,
                                OP_TAGS[tag])
                    t0 = perf()
                    fn(rt)
                    w[tag] += perf() - t0
                    c[tag] += 1
            finally:
                h1, m1 = cache.snapshot()
                dh, dm = snap[job.job_id]
                snap[job.job_id] = (dh + h1 - h0, dm + m1 - m0)

        def try_run(job: ScheduledJob, ops) -> bool:
            """Run a job's ops; on a terminal injected fault, isolate the
            job (staged rows dropped, host array unregistered, slots back
            to the pool) and record the typed error.  Returns False when
            the job just died."""
            try:
                run(job, ops)
                return True
            except InjectedFault as f:
                rt = runtimes[job.job_id]
                failed[job.job_id] = PlanExecutionError(
                    f"job {job.job_id} failed at round={f.round} "
                    f"chunk={f.chunk} op={f.op_class}: {f.kind}",
                    fault=f, last_committed_round=rt.committed_round)
                rt.staged.clear()   # the fault's traceback keeps rt alive
                rt.unpin()
                CompiledPlan.release_runtime(rt, slot_pool)
                runtimes[job.job_id] = None
                latency[job.job_id] = perf() - t_start
                return False

        t_start = perf()
        for m, (job, s) in enumerate(merged):
            if job.job_id in failed:
                continue
            stage = job.compiled.stages[s]
            if stage.key is None:           # the job's HostCommit barrier
                try_run(job, stage.ops)
            else:
                # prefetch the next merged entry's transfer prefix (on
                # *its* job's runtime and copy stream) under this stage's
                # kernels; a barrier entry prefetches nothing — its own
                # job's host rows are about to change
                if m + 1 < n:
                    nxt_job, nxt_s = merged[m + 1]
                    if nxt_job.job_id not in failed:
                        nxt = nxt_job.compiled.stages[nxt_s]
                        if nxt.key is not None and try_run(nxt_job,
                                                           nxt.prefetch):
                            prefetched[m + 1] = True
                try_run(job, stage.rest if prefetched[m] else stage.ops)
            if job.job_id not in failed and s == last_stage[job.job_id]:
                rt = runtimes[job.job_id]
                rt.commit()   # planner-forgot-barrier no-op
                rt.unpin()    # retired: no copy of this job is in flight
                latency[job.job_id] = perf() - t_start

        out = []
        for job in jobs:
            c, w = counts[job.job_id], wall[job.job_id]
            dh, dm = snap[job.job_id]
            if job.injector is not None:
                df = job.injector.faults_injected - inj0[job.job_id][0]
                dr = job.injector.retries - inj0[job.job_id][1]
            else:
                df = dr = 0
            rt = runtimes[job.job_id]
            stats = ExecStats(
                executor="pipelined",
                kernel_impl=job.compiled.kernel_impl,
                op_counts={OP_TAGS[i]: v for i, v in enumerate(c) if v},
                op_wall_s={OP_TAGS[i]: w[i] for i, v in enumerate(c) if v},
                kernel_calls=c[_KERNEL_TAG],
                shape_buckets=job.compiled.shape_buckets,
                kernel_compiles=dm,
                kernel_cache_hits=dh,
                stage_count=sum(1 for st in job.compiled.stages
                                if st.key is not None),
                lower_s=job.compiled.lower_s,
                wall_s=latency[job.job_id],
                faults_injected=df,
                retries=dr,
                pad_bytes=rt.pad_bytes if rt is not None else 0,
                share_bytes=rt.share_bytes if rt is not None else 0,
            )
            fault = failed.get(job.job_id)
            out.append((job, rt.host if fault is None else None, stats,
                        latency[job.job_id], fault))
        return out
    finally:
        for job in jobs:
            rt = runtimes.get(job.job_id)
            if rt is not None:
                rt.unpin()
                CompiledPlan.release_runtime(rt, slot_pool)
