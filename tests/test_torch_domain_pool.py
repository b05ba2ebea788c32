"""The page-locked host domain pool (``repro_torch.core.lower.DomainPool``)
on the CPU.

A run that page-locks its host array (a pipelined run on a card) leases
a domain from its executor's or service's pool, copies the input in and
the answer out, and leaves the domain page-locked for the next run of the
geometry.  Here page-locking is faked by recording the arrays that
``host_register`` and ``host_unregister`` receive, so the pool runs its
card logic on the CPU: answers bitwise equal to the eager run and the
oracle, never sharing memory with a pooled domain, the input never
written, ``domain_reused`` 0 then 1, a faulted run's domain back in the
pool and its unused answer array freed, concurrent jobs on distinct
domains, and every domain unlocked when its owner goes.
"""
import gc
import sys
import threading
import types
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core.executor import DoubleBufferedExecutor, EagerExecutor
from repro_torch.core.faults import KERNEL_FAULT, FaultPlan, FaultTrigger
from repro_torch.core.lower import DomainPool
from repro_torch.core.oocore import compile_plan
from repro_torch.core.recovery import PlanExecutionError
from repro_torch.core.reference import run_reference
from repro_torch.core.stencil import get_stencil
from repro_torch.kernels.dispatch import DispatchPolicy
from repro_torch.serve import StencilJob, StencilService

# the module, not the function ``lower`` that repro_torch.core exports
LOWER = sys.modules[DomainPool.__module__]
RNG = np.random.default_rng(29)
# case -> compile_plan arguments (engine, stencil, Y, X, n, d, k_off, k_on)
PLANS = {
    "so2dr-gradient2d": ("so2dr", "gradient2d", 40, 30, 8, 3, 4, 2),
    "so2dr-box2d4r": ("so2dr", "box2d4r", 72, 40, 8, 3, 4, 2),
    "incore-box2d4r": ("incore", "box2d4r", 40, 40, 8, 1, 4, 2),
}


def _plan(case="so2dr-gradient2d"):
    engine, name, *args = PLANS[case]
    return compile_plan(engine, get_stencil(name), *args)


def _domain(plan):
    return RNG.standard_normal(tuple(plan.shape)).astype(np.float32)


@pytest.fixture
def locks(monkeypatch):
    """Fake page-locking: the arrays registered and unregistered, in
    order.  The pools a test drops are collected before the fake goes."""
    gc.collect()
    rec = {"register": [], "unregister": []}
    monkeypatch.setattr(LOWER, "host_register", rec["register"].append)
    monkeypatch.setattr(LOWER, "host_unregister", rec["unregister"].append)
    yield rec
    gc.collect()


def _leasing_executor():
    """A CPU double-buffered executor given a domain pool (page-locking
    faked), so its runs lease as a card's do."""
    ex = DoubleBufferedExecutor(device="cpu")
    ex.domain_pool = DomainPool()
    return ex


def test_two_solves_keep_the_first_answer_and_the_input(locks):
    plan = _plan()
    x = _domain(plan)
    x0 = x.copy()
    ex = _leasing_executor()
    first, _ = ex.execute(plan, x)
    assert ex.exec_stats.domain_reused == 0
    kept = first.copy()
    second, _ = ex.execute(plan, x)
    assert ex.exec_stats.domain_reused == 1
    dom, = locks["register"]          # one domain, page-locked once
    assert not locks["unregister"]
    for out in (first, second):
        assert not np.shares_memory(out, dom)
        assert not np.shares_memory(out, x)
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(second, first)
    np.testing.assert_array_equal(x, x0)
    assert ex.domain_pool.stats() == {
        "leases": 2, "reuses": 1, "in_use": 0, "peak_in_use": 1, "idle": 1,
        "pinned_bytes": x.nbytes}


@pytest.mark.parametrize("case", PLANS)
def test_leased_answers_equal_the_eager_run_and_the_oracle(locks, case):
    plan = _plan(case)
    engine, name, _, _, n, *_ = PLANS[case]
    x = _domain(plan)
    ex = _leasing_executor()
    eager, _ = EagerExecutor(device="cpu").execute(plan, x)
    oracle = run_reference(torch.from_numpy(x), get_stencil(name), n).numpy()
    for reused in (0, 1):
        out, _ = ex.execute(plan, x)
        assert ex.exec_stats.domain_reused == reused
        np.testing.assert_array_equal(out, eager)
        np.testing.assert_array_equal(out, oracle)


def test_a_faulted_run_returns_its_domain_then_a_solve_is_correct(locks):
    plan = _plan()
    x = _domain(plan)
    ex = _leasing_executor()
    want, _ = EagerExecutor(device="cpu").execute(plan, x)
    fault = FaultPlan([FaultTrigger(round=1, chunk=None,
                                    op_class="FusedKernel",
                                    kind=KERNEL_FAULT)])
    with pytest.raises(PlanExecutionError) as err:
        ex.execute(plan, x, injector=fault.injector())
    assert err.value.last_committed_round == 0
    stats = ex.domain_pool.stats()
    assert (stats["in_use"], stats["idle"], stats["leases"]) == (0, 1, 1)
    out, _ = ex.execute(plan, x)
    assert ex.exec_stats.domain_reused == 1
    np.testing.assert_array_equal(out, want)
    assert len(locks["register"]) == 1 and not locks["unregister"]


@pytest.mark.parametrize("path", ["executor", "service"])
def test_a_faulted_run_frees_its_answer_array_while_the_error_lives(
        locks, monkeypatch, path):
    """A run faulted before its answer drops the answer's fresh array;
    the error, whose traceback keeps the runtime, does not pin it."""
    made = []
    fresh_like = LOWER._fresh_like

    def recording(arr):
        out = fresh_like(arr)()       # waits for the prefault thread
        made.append(weakref.ref(out))
        return lambda: out

    monkeypatch.setattr(LOWER, "_fresh_like", recording)
    fault = FaultPlan([FaultTrigger(round=1, chunk=None,
                                    op_class="FusedKernel",
                                    kind=KERNEL_FAULT)])
    job = StencilJob(shape=(40, 30), stencil="gradient2d", steps=8, d=3,
                     s_tb=4, k_on=2, faults=fault)
    x = RNG.standard_normal((40, 30)).astype(np.float32)
    if path == "executor":
        ex = _leasing_executor()
        plan = compile_plan("so2dr", get_stencil("gradient2d"), 40, 30, 8,
                            3, 4, 2)
        with pytest.raises(PlanExecutionError) as caught:
            ex.execute(plan, x, injector=fault.injector())
        error, pool = caught.value, ex.domain_pool
    else:
        svc = StencilService(policy=DispatchPolicy(impl="reference"),
                             device="cpu")
        svc.domain_pool = DomainPool()
        svc.submit(job, x)
        result, = svc.flush()
        assert result.status == "failed" and result.out is None
        error, pool = result.fault, svc.domain_pool
    assert isinstance(error, PlanExecutionError)
    gc.collect()
    assert len(made) == 1 and made[0]() is None
    assert pool.stats()["in_use"] == 0


def test_card_jobs_need_a_domain_pool():
    """The scheduler refuses jobs on a card without a pool to lease their
    page-locked domains from, before it touches the card."""
    from repro_torch.serve.scheduler import run_interleaved

    job = types.SimpleNamespace(
        compiled=types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(AssertionError, match="domain_pool"):
        run_interleaved([job])


def test_concurrent_service_jobs_lease_distinct_domains(locks):
    svc = StencilService(policy=DispatchPolicy(impl="reference"),
                         device="cpu")
    svc.domain_pool = DomainPool()
    job = StencilJob(shape=(40, 30), stencil="gradient2d", steps=8, d=3,
                     s_tb=4, k_on=2)
    xs = [RNG.standard_normal((40, 30)).astype(np.float32)
          for _ in range(2)]
    want = [EagerExecutor(device="cpu").execute(
        svc.compile_job(job, itemsize=4).plan, x)[0] for x in xs]
    for flush in range(2):
        for x in xs:
            svc.submit(job, x)
        results = sorted(svc.flush(), key=lambda r: r.job_id)
        assert [r.exec_stats.domain_reused for r in results] == [flush] * 2
        for r, ref in zip(results, want):
            assert r.status == "ok"
            np.testing.assert_array_equal(r.out, ref)
            assert not any(np.shares_memory(r.out, d)
                           for d in locks["register"])
        assert not np.shares_memory(results[0].out, results[1].out)
    a, b = locks["register"]          # two domains, page-locked once each
    assert not np.shares_memory(a, b)
    assert not locks["unregister"]
    pool = svc.service_stats()["domain_pool"]
    assert (pool["leases"], pool["reuses"], pool["in_use"],
            pool["peak_in_use"], pool["idle"]) == (4, 2, 0, 2, 2)
    svc.slot_pool.assert_balanced()


def test_dropping_the_executor_unlocks_its_domains(locks):
    plan = _plan()
    ex = _leasing_executor()
    ex.execute(plan, _domain(plan))
    dom, = locks["register"]
    assert not locks["unregister"]
    del ex
    gc.collect()
    assert [id(a) for a in locks["unregister"]] == [id(dom)]


def test_a_new_geometry_frees_the_idle_domains_of_others(locks):
    pool = DomainPool()
    small = np.ones((4, 6), np.float32)
    big = np.ones((8, 6), np.float32)
    a, reused = pool.lease(small)
    assert not reused
    b, _ = pool.lease(small)          # a is leased: a second domain
    pool.release(a)
    pool.release(b)
    c, reused = pool.lease(big)       # both idle small domains go
    assert not reused and c.shape == big.shape
    assert [id(d) for d in locks["unregister"]] == [id(a), id(b)]
    assert pool.stats()["pinned_bytes"] == big.nbytes
    np.testing.assert_array_equal(c, big)
    pool.release(c)
    pool.close()
    assert len(locks["unregister"]) == 3
    assert pool.stats()["pinned_bytes"] == 0
    d, _ = pool.lease(small)          # a closed pool frees on release
    pool.release(d)
    assert locks["unregister"][-1] is d


def test_the_copy_in_takes_any_host_array(locks):
    """The copy in takes any host array the plan's geometry allows: a
    read-only, a reversed and a column-major one come in bitwise."""
    pool = DomainPool()
    base = RNG.standard_normal((12, 10)).astype(np.float32)
    ro = base.copy()
    ro.flags.writeable = False
    for x in (ro, base[::-1], np.asfortranarray(base)):
        dom, _ = pool.lease(x)
        np.testing.assert_array_equal(dom, x)
        pool.release(dom)
    stats = pool.stats()
    assert (stats["leases"], stats["reuses"], len(locks["register"])) == \
        (3, 2, 1)


def test_domain_pool_thread_hammer(locks):
    """More threads than cores lease and release two geometries; no
    domain is handed to two holders at once, and the pool balances."""
    pool = DomainPool()
    shapes = [(4, 4), (6, 4)]
    held, guard, errors = set(), threading.Lock(), []

    def worker(i):
        try:
            for k in range(60):
                x = np.full(shapes[(i + k) % 2], i, np.float32)
                dom, _ = pool.lease(x)
                with guard:
                    assert id(dom) not in held
                    held.add(id(dom))
                assert (dom == i).all()
                with guard:
                    held.discard(id(dom))
                pool.release(dom)
        except Exception as e:   # reported below, in the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    stats = pool.stats()
    assert stats["leases"] == 16 * 60 and stats["in_use"] == 0
    assert stats["peak_in_use"] <= 16
    # every domain made was page-locked once and freed at most once
    assert len(locks["register"]) - len(locks["unregister"]) == \
        stats["idle"]
