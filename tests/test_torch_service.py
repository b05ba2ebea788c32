"""The port's stencil service vs the JAX package's, on the CPU.

A concurrent flush is bitwise equal to sequential eager runs of the port
and within 1e-5 relative of the JAX service's flush of the same jobs;
admission order, ``predicted_s`` and the modeled makespans equal the JAX
package's with the same hardware model (``TPU_V5E`` in both); a warm
in-bucket job compiles no kernel; a poisoned job is isolated while the
survivors stay bitwise and the pool balances; transient faults are
retried transparently; and the shared counters survive thread hammering
(mirrors tests/test_service.py and the service half of
tests/test_faults.py).  Inputs from a numpy seed, ``device="cpu"``, the
reference kernel in both packages.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import analytic as jax_analytic
from repro.core import faults as jfa
from repro.core.autotune import \
    predicted_sharded_makespan as jax_predicted_sharded_makespan
from repro.core.hierarchy import \
    compile_hierarchical as jax_compile_hierarchical
from repro.core.shard import compile_sharded as jax_compile_sharded
from repro.kernels.dispatch import DispatchPolicy as JaxPolicy
from repro.serve import StencilJob as JaxJob
from repro.serve import StencilService as JaxService
from repro.serve import interleave_stages as jax_interleave_stages
from repro_torch.core import faults as tfa
from repro_torch.core.analytic import H100_SXM, TPU_V5E
from repro_torch.core.autotune import predicted_makespan
from repro_torch.core.executor import DoubleBufferedExecutor, EagerExecutor
from repro_torch.core.hierarchy import compile_hierarchical
from repro_torch.core.lower import BucketRegistry, ExecStats, KernelCache, SlotPool
from repro_torch.core.oocore import compile_plan
from repro_torch.core.recovery import PlanExecutionError
from repro_torch.core.reference import run_reference
from repro_torch.core.shard import compile_sharded
from repro_torch.core.stencil import get_stencil
from repro_torch.kernels.dispatch import DispatchPolicy
from repro_torch.serve import (
    ScheduledJob, StencilJob, StencilService, admission_order,
    interleave_stages, modeled_makespan,
)

RNG = np.random.default_rng(31)
TOL = 1e-5
POLICY = DispatchPolicy(impl="reference")
JAX_POLICY = JaxPolicy(impl="reference")
STEPS, D, S_TB, K_ON = 8, 4, 4, 2
NO_WAIT = tfa.RetryPolicy(sleep=lambda s: None)


def _service(**kw):
    return StencilService(hw=TPU_V5E, policy=POLICY, device="cpu", **kw)


def _job(shape, stencil="box2d1r", codec="identity", deadline=None, **kw):
    return StencilJob(shape=shape, stencil=stencil, steps=STEPS,
                      codec=codec, deadline=deadline, d=D, s_tb=S_TB,
                      k_on=K_ON, **kw)


def _jax_job(job):
    return JaxJob(shape=job.shape, stencil=job.stencil, steps=job.steps,
                  codec=job.codec, deadline=job.deadline, d=job.d,
                  s_tb=job.s_tb, k_on=job.k_on)


def _x(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _eager_reference(job, x):
    plan = compile_plan(job.engine, get_stencil(job.stencil), *job.shape,
                        job.steps, job.d, job.s_tb, job.k_on, itemsize=4,
                        codec=None if job.codec == "identity" else job.codec)
    out, _ = EagerExecutor(policy=POLICY, device="cpu").execute(plan, x)
    return out


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)


def test_concurrent_flush_bitwise_to_sequential_and_close_to_jax():
    svc = _service()
    jobs = [_job((66, 66)), _job((66, 66), stencil="gradient2d"),
            _job((50, 66), codec="zrle"), _job((66, 50), deadline=1.0)]
    xs = [_x(j.shape) for j in jobs]
    ids = {}
    threads = [threading.Thread(
        target=lambda j=j, x=x: ids.__setitem__(svc.submit(j, x), (j, x)))
        for j, x in zip(jobs, xs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = {r.job_id: r for r in svc.flush()}
    assert set(results) == set(ids)
    jsvc = JaxService(policy=JAX_POLICY)
    jids = {}
    for job_id in sorted(ids):
        job, x = ids[job_id]
        jids[jsvc.submit(_jax_job(job), x)] = job_id
    jres = {jids[r.job_id]: r for r in jsvc.flush()}
    for job_id, (job, x) in ids.items():
        r = results[job_id]
        assert r.status == "ok" and r.exec_stats.executor == "pipelined"
        np.testing.assert_array_equal(r.out, _eager_reference(job, x))
        assert _rel_err(r.out, jres[job_id].out) <= TOL
        assert vars(r.stats) == vars(jres[job_id].stats)
        for f in ("kernel_calls", "stage_count", "shape_buckets"):
            assert getattr(r.exec_stats, f) == getattr(jres[job_id].exec_stats,
                                                       f), f
    svc.slot_pool.assert_balanced()


def test_admission_pricing_and_makespan_equal_jax():
    """Same jobs, same hardware model: the same admission order, the
    same predicted seconds and the same modeled makespans."""
    svc, jsvc = _service(), JaxService(policy=JAX_POLICY)
    jobs = [_job((130, 130)), _job((66, 130)),
            _job((130, 130), deadline=0.1), _job((66, 130), deadline=0.9),
            _job((130, 130), stencil="gradient2d")]
    for job in jobs:
        x = _x(job.shape)
        svc.submit(job, x)
        jsvc.submit(_jax_job(job), x)
    order = [r.job_id for r in svc.flush()]
    assert order == [r.job_id for r in jsvc.flush()] == [2, 3, 1, 0, 4]
    assert [j.predicted_s for j in svc.last_admission] == \
        [j.predicted_s for j in jsvc.last_admission]
    for inter in (True, False):
        assert svc.modeled_makespan(interleaved=inter) == \
            jsvc.modeled_makespan(interleaved=inter)
    mi = svc.modeled_makespan(interleaved=True)
    assert 0 < mi < svc.modeled_makespan(interleaved=False)
    assert mi == modeled_makespan(svc.last_admission, TPU_V5E)
    assert [(j.job_id, s) for j, s in interleave_stages(svc.last_admission)] \
        == [(j.job_id, s) for j, s in
            jax_interleave_stages(jsvc.last_admission)]


def test_admission_order_pure_function():
    def mk(i, p, dl):
        return ScheduledJob(job_id=i, compiled=None, x=None,
                            predicted_s=p, deadline=dl)

    jobs = [mk(0, 5.0, None), mk(1, 1.0, None), mk(2, 9.0, 0.2),
            mk(3, 1.0, 0.5), mk(4, 2.0, None)]
    assert [j.job_id for j in admission_order(jobs)] == [2, 3, 1, 4, 0]


def test_default_hardware_is_the_h100_and_a_profile_wins(tmp_path):
    svc = StencilService(policy=POLICY, device="cpu")
    assert svc.hw == H100_SXM and svc.profile is None
    from repro_torch.core.calibrate import DeviceProfile

    hw = dict(vars(TPU_V5E))
    prof = DeviceProfile(profile_id="p1", fingerprint={}, hardware=hw,
                         kernel_terms={}, codec_throughput={}, residuals={},
                         created_at="", base_hardware="TPU_V5E")
    path = prof.save(str(tmp_path / "profile.json"))
    svc = StencilService(hw=H100_SXM, profile=path, device="cpu")
    assert svc.hw == TPU_V5E
    assert svc.service_stats()["profile_id"] == "p1"


def test_warm_bucket_compiles_zero_new_kernels_and_stays_bitwise():
    svc = _service()
    svc.submit(_job((130, 130)), _x((130, 130)))
    [first] = svc.flush()
    assert first.exec_stats.kernel_compiles > 0
    hits0, misses0 = svc.kernel_cache.snapshot()
    job, x = _job((106, 130)), _x((106, 130))
    svc.submit(job, x)
    [warm] = svc.flush()
    hits1, misses1 = svc.kernel_cache.snapshot()
    assert misses1 == misses0 and warm.exec_stats.kernel_compiles == 0
    assert warm.exec_stats.kernel_cache_hits > 0 and hits1 > hits0
    np.testing.assert_array_equal(warm.out, _eager_reference(job, x))
    # as in the JAX package
    jsvc = JaxService(policy=JAX_POLICY)
    jsvc.submit(_jax_job(_job((130, 130))), _x((130, 130)))
    jsvc.flush()
    jsvc.submit(_jax_job(job), x)
    [jwarm] = jsvc.flush()
    assert jwarm.exec_stats.kernel_compiles == 0
    assert len(svc.buckets) == len(jsvc.buckets)


def test_service_isolates_a_poisoned_job_as_jax_does():
    x = np.arange(32 * 16, dtype=np.float32).reshape(32, 16) / 7.0

    def batch(svc, fa, mk):
        faults = fa.FaultPlan([fa.FaultTrigger(round=1, chunk=0,
                                               op_class="*",
                                               kind=fa.KERNEL_FAULT)])
        for i in range(3):
            svc.submit(mk(shape=(32, 16), stencil="star2d1r", steps=8,
                          s_tb=4, faults=faults if i == 1 else None), x)
        return {r.job_id: r for r in svc.flush()}

    ref = {r.job_id: r.out for r in batch(_service(), tfa, StencilJob).values()}
    svc = _service()
    results = batch(svc, tfa, StencilJob)
    jres = batch(JaxService(policy=JAX_POLICY), jfa, JaxJob)
    assert results[1].status == jres[1].status == "failed"
    assert results[1].out is None
    assert isinstance(results[1].fault, PlanExecutionError)
    assert results[1].fault.last_committed_round == \
        jres[1].fault.last_committed_round == 0
    f, jf = results[1].fault.fault, jres[1].fault.fault
    assert (f.kind, f.round, f.chunk, f.op_class) == \
        (jf.kind, jf.round, jf.chunk, jf.op_class)
    assert results[1].exec_stats.kernel_calls == \
        jres[1].exec_stats.kernel_calls
    for jid in (0, 2):
        assert results[jid].status == "ok" and results[jid].fault is None
        np.testing.assert_array_equal(results[jid].out, ref[jid])
        assert _rel_err(results[jid].out, jres[jid].out) <= TOL
    svc.slot_pool.assert_balanced()
    stats = svc.service_stats()
    assert stats["jobs_failed"] == 1 and stats["jobs_completed"] == 2


def test_service_transient_faults_retried_transparently():
    x = _x((32, 16))
    job = StencilJob(shape=(32, 16), stencil="star2d1r", steps=8, s_tb=4)
    ref = _service().run_solo(job, x)
    faults = tfa.FaultPlan([tfa.FaultTrigger(
        round=0, chunk=0, op_class="H2D", kind=tfa.TRANSIENT_TRANSFER,
        count=2)])
    svc = _service()
    svc.submit(StencilJob(shape=(32, 16), stencil="star2d1r", steps=8,
                          s_tb=4, faults=faults, retry=NO_WAIT), x)
    res, = svc.flush()
    assert res.status == "ok"
    assert (res.exec_stats.faults_injected, res.exec_stats.retries) == (2, 2)
    np.testing.assert_array_equal(res.out, ref.out)
    assert svc.exec_stats.faults_injected == 2


def test_service_lifetime_stats_and_sharded_not_ported():
    """(The name predates the port of ``run_sharded``.)  Lifetime
    counters after a flush, a solo run and a sharded run."""
    svc = _service()
    svc.submit(_job((66, 66)), _x((66, 66)))
    svc.flush()
    solo = svc.run_solo(_job((66, 66)), _x((66, 66)))
    assert solo.exec_stats.executor == "pipelined" and solo.job_id == 1
    s = svc.service_stats()
    assert s["jobs_submitted"] == s["jobs_completed"] == 2
    assert s["kernel_compiles"] > 0 and s["kernel_cache_hits"] > 0
    assert s["slot_pool"]["leases"] == 2 and s["slot_pool"]["in_use"] == 0
    assert svc.exec_stats.kernel_calls > 0
    plan = compile_sharded("box2d1r", 48, 48, STEPS, 2, (2, 2))
    res = svc.run_sharded(plan, _x((48, 48)))
    assert res.status == "ok" and res.exec_stats.executor == "sharded_sim"
    assert res.predicted_s == jax_predicted_sharded_makespan(
        jax_compile_sharded("box2d1r", 48, 48, STEPS, 2, (2, 2)),
        jax_analytic.TPU_V5E)
    s = svc.service_stats()
    assert s["jobs_submitted"] == s["jobs_completed"] == 3
    assert svc.exec_stats.kernel_calls \
        > res.exec_stats.kernel_calls == plan.n_ranks * plan.rounds


def _hier_plans():
    return (compile_hierarchical("star2d1r", 48, 48, STEPS, 2, (2, 2),
                                 inner_engine="so2dr", inner_d=3),
            jax_compile_hierarchical("star2d1r", 48, 48, STEPS, 2, (2, 2),
                                     inner_engine="so2dr", inner_d=3))


def test_hierarchical_job_runs_through_service_warm_state():
    """A hierarchical job shares the service's slot pool and kernel
    cache: inner chunk slots are leased from the pool (and all
    returned), and a second run re-uses the masked kernel signature;
    output and counters equal the JAX service's."""
    svc = _service()
    jsvc = JaxService()
    plan, jplan = _hier_plans()
    x = _x((48, 48))
    res = svc.run_sharded(plan, x)
    jres = jsvc.run_sharded(jplan, x)
    assert res.status == "ok" and res.fault is None
    ref = run_reference(torch.from_numpy(x), get_stencil("star2d1r"), STEPS)
    assert np.abs(res.out - ref.numpy()).max() < TOL
    assert _rel_err(res.out, jres.out) < TOL
    assert res.predicted_s == jres.predicted_s > 0
    svc.slot_pool.assert_balanced()
    pool = svc.slot_pool.stats()
    assert pool["leases"] == jsvc.slot_pool.stats()["leases"] > 0
    assert pool["in_use"] == 0
    compiles0 = svc.service_stats()["kernel_compiles"]
    assert compiles0 == jsvc.service_stats()["kernel_compiles"] > 0
    res2 = svc.run_sharded(plan, x)
    assert res2.exec_stats.kernel_compiles == 0
    assert res2.exec_stats.kernel_cache_hits > 0
    assert svc.service_stats()["kernel_compiles"] == compiles0
    svc.slot_pool.assert_balanced()


def test_no_leaked_leases_when_hierarchical_job_raises_mid_flush():
    """A terminal fault after round 0's nested programs have leased and
    released their chunk slots leaves the pool balanced; the job fails
    as in the JAX service and the service survives."""
    svc = _service()
    plan, jplan = _hier_plans()
    trig = dict(round=1, chunk=None, op_class="ShardKernel",
                kind=tfa.KERNEL_FAULT)
    res = svc.run_sharded(plan, _x((48, 48)),
                          faults=tfa.FaultPlan([tfa.FaultTrigger(**trig)]))
    jsvc = JaxService()
    jres = jsvc.run_sharded(jplan, _x((48, 48)),
                            faults=jfa.FaultPlan([jfa.FaultTrigger(**trig)]))
    assert res.status == jres.status == "failed" and res.out is None
    assert isinstance(res.fault, PlanExecutionError)
    assert str(res.fault) == str(jres.fault)
    assert res.fault.last_committed_round \
        == jres.fault.last_committed_round == -1
    svc.slot_pool.assert_balanced()
    pool = svc.slot_pool.stats()
    # round 0's four inner programs each leased (and returned) a slot
    assert pool["leases"] == jsvc.slot_pool.stats()["leases"] >= 4
    assert pool["in_use"] == 0
    assert svc.service_stats()["jobs_failed"] == 1
    # the pool is still serviceable: the same job reruns clean
    assert svc.run_sharded(plan, _x((48, 48))).status == "ok"
    svc.slot_pool.assert_balanced()


def test_default_device_is_cuda_and_the_service_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StencilService()


def test_predicted_makespan_positive_and_monotone_in_size():
    st = get_stencil("box2d1r")
    small = compile_plan("so2dr", st, 66, 66, STEPS, D, S_TB, K_ON)
    big = compile_plan("so2dr", st, 130, 130, STEPS, D, S_TB, K_ON)
    for hw in (TPU_V5E, H100_SXM):
        assert 0 < predicted_makespan(small, hw) < predicted_makespan(big, hw)


# ----------------------------------------------------- thread hammers


def _hammer(work):
    """Run ``work(barrier)`` on more threads than cores, with a short
    switch interval so a lost update shows; returns the thread count."""
    n = (os.cpu_count() or 4) + 2
    barrier = threading.Barrier(n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(barrier,))
                   for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    return n


def test_kernel_cache_thread_hammer():
    cache = KernelCache()
    made = []

    def worker(barrier):
        barrier.wait()
        for i in range(200):
            key = ("sig", i % 10)
            cache.lookup(key, lambda k=key: made.append(k) or (lambda: k))

    n = _hammer(worker)
    hits, misses = cache.snapshot()
    assert hits + misses == n * 200
    assert misses == len(cache) == len(made) == 10


def test_exec_stats_merge_thread_safe():
    total = ExecStats(executor="service")
    part = ExecStats(kernel_calls=3, kernel_compiles=1, kernel_cache_hits=2,
                     stage_count=4, shape_buckets=2, wall_s=0.5,
                     faults_injected=1, retries=2, resumes=1,
                     op_counts={"H2D": 2}, op_wall_s={"H2D": 0.1})

    def worker(barrier):
        barrier.wait()
        for _ in range(50):
            total.merge(part)

    n = _hammer(worker) * 50
    assert total.kernel_calls == 3 * n and total.kernel_compiles == n
    assert (total.faults_injected, total.retries, total.resumes) == \
        (n, 2 * n, n)
    assert total.op_counts["H2D"] == 2 * n
    assert abs(total.op_wall_s["H2D"] - 0.1 * n) < 1e-6


def test_exec_stats_fields_in_the_jax_order():
    from repro.core.lower import ExecStats as JaxExecStats
    import dataclasses

    # then the port's own counters of the concatenations' bytes
    assert [f.name for f in dataclasses.fields(ExecStats)] == \
        [f.name for f in dataclasses.fields(JaxExecStats)] + \
        ["pad_bytes", "share_bytes"]


def test_slot_pool_thread_hammer_and_reuse():
    pool = SlotPool()

    def worker(barrier):
        barrier.wait()
        for _ in range(100):
            regs, bufs = pool.acquire(3, 2)
            regs[0] = "live"
            pool.release(regs, bufs)

    n = _hammer(worker)
    s = pool.stats()
    assert s["leases"] == n * 100 and s["in_use"] == 0
    assert s["leases"] - s["reuses"] == s["peak_in_use"] <= n
    pool.assert_balanced()
    regs, bufs = pool.acquire(4, 1)
    assert all(r is None for r in regs) and all(b is None for b in bufs)
    with pytest.raises(AssertionError, match="1 lease"):
        pool.assert_balanced()
    pool.release(regs, bufs)


def test_bucket_registry_routes_to_smallest_fitting_bucket():
    reg = BucketRegistry()
    group = ("box2d1r", 2, True, False, 130, 4)
    assert reg.resolve(group, 64) == 64
    assert reg.resolve(group, 40) == 64
    assert reg.resolve(group, 100) == 100
    assert reg.resolve(group, 70) == 100
    assert reg.resolve(("other",) + group[1:], 40) == 40
    assert len(reg) == 3


def test_executor_reentrant_thread_local_stats():
    st = get_stencil("box2d1r")
    ex = DoubleBufferedExecutor(policy=POLICY, device="cpu")
    plans = {
        "a": compile_plan("so2dr", st, 66, 66, STEPS, D, S_TB, K_ON),
        "b": compile_plan("so2dr", st, 130, 130, STEPS, D, S_TB, K_ON),
    }
    xs = {k: _x((p.Y, p.X)) for k, p in plans.items()}
    seen = {}
    barrier = threading.Barrier(2)

    def worker(k):
        barrier.wait()
        out, _ = ex.execute(plans[k], xs[k])
        seen[k] = (out, ex.exec_stats.stage_count)

    threads = [threading.Thread(target=worker, args=(k,)) for k in plans]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in plans:
        expected = sum(1 for key, _ in plans[k].stages() if key is not None)
        assert seen[k][1] == expected
        np.testing.assert_array_equal(
            seen[k][0], EagerExecutor(policy=POLICY, device="cpu").execute(
                plans[k], xs[k])[0])
    assert len(ex._lowered_memo) == 2


def test_serve_package_exports():
    import repro_torch
    import repro_torch.serve as serve

    for name in ("StencilService", "StencilJob", "JobResult",
                 "ScheduledJob", "admission_order", "interleave_stages",
                 "modeled_makespan", "run_interleaved"):
        assert hasattr(serve, name)
    for name in ("FaultPlan", "FaultTrigger", "RetryPolicy", "InjectedFault",
                 "PlanExecutionError", "PlanCheckpointer", "resume_plan",
                 "run_with_recovery", "StencilService", "StencilJob",
                 "JobResult", "CheckpointManager"):
        assert name in repro_torch.__all__ and hasattr(repro_torch, name)
