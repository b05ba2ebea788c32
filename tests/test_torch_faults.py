"""The port's fault injection and checkpoint/resume vs the JAX package,
on the CPU.

The crash matrix: a terminal fault at any round of any engine x
executor, recovered through the port's ``run_with_recovery`` and
``PlanCheckpointer``, gives a host array bitwise equal to the port's
uninterrupted run and within 1e-5 relative (tests/test_kernel_exec.py's
tolerance) of the JAX package's uninterrupted run of the same plan.  The
same fault plan raises the same typed error at the same site in both
packages, with the same counters; seeded fault plans, plan fingerprints
and resume plans are equal.  Small domains (32 x 16, as in
tests/test_faults.py), inputs from a numpy seed, ``device="cpu"`` and
the reference kernel in both packages.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.core import faults as jfa
from repro.core import oocore as joo
from repro.core import recovery as jre
from repro.core import stencil as jst
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.kernels.dispatch import DispatchPolicy as JaxPolicy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import executor as tex
from repro_torch.core import faults as tfa
from repro_torch.core import oocore as too
from repro_torch.core import stencil as tst
from repro_torch.core.faults import (
    KERNEL_FAULT, SLOT_EXHAUSTED, TRANSIENT_TRANSFER, FaultPlan,
    FaultTrigger, RetryPolicy, TransientTransferError,
)
from repro_torch.core.lower import SlotPool, lower
from repro_torch.core.recovery import (
    PlanCheckpointer, PlanExecutionError, plan_fingerprint, resume_plan,
    run_with_recovery,
)
from repro_torch.kernels.dispatch import DispatchPolicy

TOL = 1e-5
ENGINES = ("incore", "naive_tb", "resreu", "so2dr", "box_tb")
EXECUTORS = ("eager", "double_buffered")
POLICY = DispatchPolicy(impl="reference")
JAX_POLICY = JaxPolicy(impl="reference")
NO_WAIT = RetryPolicy(sleep=lambda s: None)
JAX_NO_WAIT = jfa.RetryPolicy(sleep=lambda s: None)


def _domain(seed=11, Y=32, X=16):
    return np.random.default_rng(seed).standard_normal((Y, X)).astype(
        np.float32)


def _plans(engine="so2dr", codec=None, Y=32, X=16, n=8, d=2, k_off=4,
           k_on=2):
    """The same plan compiled by the port and by the JAX package."""
    out = []
    for oo, st in ((too, tst), (joo, jst)):
        s = st.get_stencil("star2d1r")
        if engine == "box_tb":
            out.append(oo.compile_box_plan(s, (Y, X), n, (2, 1), k_off, k_on,
                                           codec=codec))
        else:
            out.append(oo.compile_plan(engine, s, Y, X, n, d, k_off, k_on,
                                       codec=codec))
    return out


def _executor(name, **kw):
    cls = {"eager": tex.EagerExecutor,
           "double_buffered": tex.DoubleBufferedExecutor}[name]
    return cls(policy=POLICY, device="cpu", **kw)


def _rounds(plan):
    return sorted({op.round for op in plan.ops})


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)


@functools.lru_cache(maxsize=None)
def _jax_uninterrupted(engine, codec=None):
    _, jplan = _plans(engine, codec)
    out, _ = jex.EagerExecutor(policy=JAX_POLICY).execute(jplan, _domain())
    return np.asarray(out)


def _kernel_fault_at(rnd, jax=False):
    fa = jfa if jax else tfa
    return fa.FaultPlan([fa.FaultTrigger(round=rnd, chunk=None, op_class="*",
                                         kind=fa.KERNEL_FAULT)])


# ------------------------------------------------------- crash matrix


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("engine", ENGINES)
def test_crash_at_every_round_resumes_bitwise(engine, executor, tmp_path):
    """Terminal kernel fault at each round -> checkpointed resume ->
    bitwise equal to the port's uninterrupted run, within 1e-5 of the JAX
    package's."""
    plan, _ = _plans(engine)
    x = _domain()
    ref, _ = _executor("eager").execute(plan, x)
    assert _rel_err(ref, _jax_uninterrupted(engine)) <= TOL
    for rnd in _rounds(plan):   # incore has one round: restart from x
        mgr = CheckpointManager(str(tmp_path / f"{engine}_{rnd}"))
        ex = _executor(executor)
        host, _ = run_with_recovery(
            plan, x, executor=ex, faults=_kernel_fault_at(rnd),
            checkpoint=PlanCheckpointer(mgr, plan))
        np.testing.assert_array_equal(host, ref)
        assert ex.exec_stats.resumes == 1
        assert ex.exec_stats.faults_injected == 1
        assert _rel_err(host, _jax_uninterrupted(engine)) <= TOL


@pytest.mark.parametrize("executor", EXECUTORS)
def test_crash_matrix_with_compression_codec(executor, tmp_path):
    """The resume property holds through the zrle transfer codec."""
    plan, _ = _plans("so2dr", codec="zrle")
    x = _domain()
    ref, _ = _executor("eager").execute(plan, x)
    for rnd in _rounds(plan):
        mgr = CheckpointManager(str(tmp_path / f"zrle_{rnd}"))
        ex = _executor(executor)
        host, _ = run_with_recovery(
            plan, x, executor=ex, faults=_kernel_fault_at(rnd),
            checkpoint=PlanCheckpointer(mgr, plan))
        np.testing.assert_array_equal(host, ref)
        assert ex.exec_stats.resumes == 1
        assert _rel_err(host, _jax_uninterrupted("so2dr", "zrle")) <= TOL


# ------------------------------------------ same errors as the JAX package


def _triggers(spec, fa):
    return fa.FaultPlan([fa.FaultTrigger(**t) for t in spec])


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("spec", [
    [dict(round=1, chunk=0, op_class="*", kind=KERNEL_FAULT)],
    [dict(round=1, chunk=1, op_class="FusedKernel", kind=KERNEL_FAULT)],
    [dict(round=0, chunk=0, op_class="H2D", kind=TRANSIENT_TRANSFER,
          count=10)],
    [dict(round=0, chunk=1, op_class="H2D", kind=TRANSIENT_TRANSFER,
          count=2),
     dict(round=1, chunk=None, op_class="D2H", kind=SLOT_EXHAUSTED)],
    [dict(round=1, chunk=-1, op_class="HostCommit", kind=KERNEL_FAULT)],
], ids=["kernel", "kernel_site", "retry_exhausted", "transient_then_slot",
        "at_commit"])
def test_same_fault_plan_raises_the_same_error_as_jax(spec, executor):
    plan, jplan = _plans("so2dr")
    x = _domain()
    inj = _triggers(spec, tfa).injector()
    jinj = _triggers(spec, jfa).injector()
    with pytest.raises(PlanExecutionError) as ei:
        _executor(executor).execute(plan, x, injector=inj, retry=NO_WAIT)
    jcls = {"eager": jex.EagerExecutor,
            "double_buffered": jex.DoubleBufferedExecutor}[executor]
    with pytest.raises(jre.PlanExecutionError) as jei:
        jcls(policy=JAX_POLICY).execute(jplan, x, injector=jinj,
                                        retry=JAX_NO_WAIT)
    e, je = ei.value, jei.value
    assert e.last_committed_round == je.last_committed_round
    assert e.fingerprint == je.fingerprint == plan_fingerprint(plan)
    f, jf = e.fault, je.fault
    assert (f.kind, f.round, f.chunk, f.op_class, f.transient) == \
        (jf.kind, jf.round, jf.chunk, jf.op_class, jf.transient)
    assert (inj.faults_injected, inj.retries, inj.pending()) == \
        (jinj.faults_injected, jinj.retries, jinj.pending())
    assert str(e) == str(je)


def test_retry_exhaustion_surfaces_typed_error():
    plan, _ = _plans()
    faults = FaultPlan([FaultTrigger(round=0, chunk=0, op_class="H2D",
                                     kind=TRANSIENT_TRANSFER, count=10)])
    injector = faults.injector()
    with pytest.raises(PlanExecutionError) as ei:
        run_with_recovery(plan, _domain(), executor=_executor("eager"),
                          faults=injector, retry=NO_WAIT)
    assert isinstance(ei.value.fault, TransientTransferError)
    assert ei.value.last_committed_round == -1
    assert ei.value.next_round == 0
    assert injector.retries == NO_WAIT.max_retries
    assert injector.faults_injected == NO_WAIT.max_retries + 1


def test_transient_fault_absorbed_by_retry_as_in_jax():
    plan, jplan = _plans()
    x = _domain()
    ref, _ = _executor("eager").execute(plan, x)
    spec = [dict(round=0, chunk=0, op_class="H2D", kind=TRANSIENT_TRANSFER,
                 count=2)]
    ex = _executor("double_buffered")
    host, _ = run_with_recovery(plan, x, executor=ex,
                                faults=_triggers(spec, tfa), retry=NO_WAIT)
    np.testing.assert_array_equal(host, ref)
    jex_ = jex.DoubleBufferedExecutor(policy=JAX_POLICY)
    jre.run_with_recovery(jplan, x, executor=jex_,
                          faults=_triggers(spec, jfa), retry=JAX_NO_WAIT)
    for field in ("faults_injected", "retries", "resumes"):
        assert getattr(ex.exec_stats, field) == \
            getattr(jex_.exec_stats, field)
    assert (ex.exec_stats.faults_injected, ex.exec_stats.retries,
            ex.exec_stats.resumes) == (2, 2, 0)


def test_clean_run_with_injector_is_invisible():
    plan, _ = _plans()
    x = _domain()
    ref, _ = _executor("eager").execute(plan, x)
    ex = _executor("eager")
    host, _ = ex.execute(plan, x, injector=FaultPlan([]).injector())
    np.testing.assert_array_equal(host, ref)
    assert ex.exec_stats.faults_injected == ex.exec_stats.retries == 0


def test_legacy_executor_path_rejects_hooks():
    with pytest.raises(ValueError, match="lowered"):
        _executor("eager", lowered=False).execute(
            _plans()[0], _domain(), injector=FaultPlan([]).injector())


def test_slot_pool_drains_after_faulted_run():
    """A run killed mid-stage still returns every leased slot and drops
    its staged rows; the pool stays serviceable."""
    pool = SlotPool()
    plan, _ = _plans()
    compiled = lower(plan, policy=POLICY, device="cpu")
    faults = FaultPlan([FaultTrigger(round=1, chunk=0, op_class="*",
                                     kind=SLOT_EXHAUSTED)])
    with pytest.raises(PlanExecutionError) as ei:
        compiled.execute(_domain(), slot_pool=pool,
                         injector=faults.injector())
    assert ei.value.last_committed_round == 0
    assert pool.in_use == 0 and pool.leases == 1
    compiled.execute(_domain(), slot_pool=pool)
    assert pool.in_use == 0 and pool.reuses == 1
    pool.assert_balanced()


@pytest.mark.parametrize("pipeline", [False, True])
def test_on_commit_sees_each_rounds_committed_rows(pipeline):
    """The hook fires once per round, after the barrier drained: its
    snapshot of round r equals the final host of the plan cut after
    round r."""
    plan, _ = _plans(n=12, k_off=4)       # three rounds
    x = _domain()
    snaps = {}
    compiled = lower(plan, policy=POLICY, device="cpu")
    out, _, _ = compiled.execute(
        x, pipeline=pipeline,
        on_commit=lambda rnd, host: snaps.__setitem__(rnd, host.copy()))
    assert sorted(snaps) == _rounds(plan) == [0, 1, 2]
    np.testing.assert_array_equal(snaps[2], out)
    for rnd in (0, 1):
        cut = plan.__class__(**{**plan.__dict__, "ops": tuple(
            op for op in plan.ops if op.round <= rnd)})
        ref, _, _ = lower(cut, policy=POLICY, device="cpu").execute(x)
        np.testing.assert_array_equal(snaps[rnd], ref)


def test_default_device_is_cuda_and_recovery_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    plan, _ = _plans()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_with_recovery(plan, _domain())


# ----------------------------------------- same bookkeeping as the JAX package


@pytest.mark.parametrize("seed", [0, 17, 18])
def test_seeded_fault_plans_equal_jax(seed):
    plan, jplan = _plans()
    kw = dict(n_faults=4, kinds=(TRANSIENT_TRANSFER, KERNEL_FAULT),
              op_classes=("H2D", "FusedKernel"))
    a = FaultPlan.seeded(seed, plan, **kw)
    j = jfa.FaultPlan.seeded(seed, jplan, **kw)
    assert [tuple(vars(t).values()) for t in a.triggers] == \
        [tuple(vars(t).values()) for t in j.triggers]
    assert a.triggers == FaultPlan.seeded(seed, plan, **kw).triggers
    keys = {k for k, _ in plan.stages() if k is not None}
    assert all((t.round, t.chunk) in keys for t in a.triggers)


@pytest.mark.parametrize("seed", [0, 5, 23])
def test_seeded_fault_plans_on_sharded_plans_equal_jax(seed):
    """A sharded plan's sites are its ``(round, rank)`` pairs: the same
    seed draws the same triggers as the JAX package, and the plan's
    fingerprint is the JAX package's too (also of a hierarchical plan)."""
    from repro.core.hierarchy import compile_hierarchical as jax_hier
    from repro.core.shard import compile_sharded as jax_sharded
    from repro_torch.core.hierarchy import compile_hierarchical
    from repro_torch.core.shard import compile_sharded

    plan = compile_sharded("star2d1r", 48, 32, 8, 2, (4, 2))
    jplan = jax_sharded("star2d1r", 48, 32, 8, 2, (4, 2))
    kw = dict(n_faults=5, kinds=(tfa.RANK_LOSS, KERNEL_FAULT),
              op_classes=("ShardKernel", "HaloRecv", "*"))
    a = FaultPlan.seeded(seed, plan, **kw)
    j = jfa.FaultPlan.seeded(seed, jplan, **kw)
    assert [tuple(vars(t).values()) for t in a.triggers] == \
        [tuple(vars(t).values()) for t in j.triggers]
    assert all(0 <= t.round < plan.rounds and 0 <= t.chunk < plan.n_ranks
               for t in a.triggers)
    assert plan_fingerprint(plan) == jre.plan_fingerprint(jplan)
    hier = compile_hierarchical("star2d1r", 48, 32, 8, 2, (4, 2), inner_d=2)
    assert plan_fingerprint(hier) == jre.plan_fingerprint(
        jax_hier("star2d1r", 48, 32, 8, 2, (4, 2), inner_d=2))


@pytest.mark.parametrize("engine", ENGINES)
def test_fingerprints_and_resume_plans_equal_jax(engine):
    plan, jplan = _plans(engine, n=12, k_off=4)
    assert repr(plan) == repr(jplan)
    assert plan_fingerprint(plan) == jre.plan_fingerprint(jplan)
    for rnd in range(0, 4):
        cont, jcont = resume_plan(plan, rnd), jre.resume_plan(jplan, rnd)
        assert repr(cont.ops) == repr(jcont.ops)
        assert cont.exact_elements == jcont.exact_elements
        assert plan_fingerprint(cont) == jre.plan_fingerprint(jcont)
    assert resume_plan(plan, 0) is plan
    cont = resume_plan(plan, 1)
    assert plan_fingerprint(cont) != plan_fingerprint(plan)
    if len(_rounds(plan)) > 1:        # incore runs one round
        assert min(op.round for op in cont.ops) == 1


def test_checkpointer_ignores_foreign_fingerprints_and_keeps_cadence(
        tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"))
    plan_a, _ = _plans("so2dr")
    plan_b, _ = _plans("resreu")
    ck_a = PlanCheckpointer(mgr, plan_a)
    ck_a.on_commit(0, _domain())
    assert ck_a.latest() is not None
    assert PlanCheckpointer(mgr, plan_b).latest() is None
    ck = PlanCheckpointer(CheckpointManager(str(tmp_path / "b"), keep=10),
                          plan_a, every=2)
    for rnd in range(4):
        ck.on_commit(rnd, _domain(seed=rnd))
    assert ck.saves == 2
    rnd, host = ck.latest()
    assert rnd == 2
    np.testing.assert_array_equal(host, _domain(seed=2))
    with pytest.raises(ValueError):
        PlanCheckpointer(mgr, plan_a, every=0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """Equal fingerprints make a round snapshot written by the JAX
    package's checkpointer a resume point for the port (and the port's
    for the JAX package)."""
    plan, jplan = _plans(n=12, k_off=4)
    x = _domain()
    ref, _ = _executor("eager").execute(plan, x)
    # the JAX run dies in round 2 after committing rounds 0 and 1
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"))
    with pytest.raises(jre.PlanExecutionError):
        jex.EagerExecutor(policy=JAX_POLICY).execute(
            jplan, x, injector=_kernel_fault_at(2, jax=True).injector(),
            on_commit=jre.PlanCheckpointer(jmgr, jplan).on_commit)
    snap = PlanCheckpointer(CheckpointManager(jmgr.dir), plan).latest()
    assert snap[0] == 1
    ex = _executor("double_buffered")
    host, _ = run_with_recovery(
        plan, x, executor=ex, faults=_kernel_fault_at(0),
        checkpoint=PlanCheckpointer(CheckpointManager(jmgr.dir), plan))
    # the port's round-0 fault resumed from the JAX run's round 1 (whose
    # rows the JAX package computed: equal to the port's within 1e-5)
    assert ex.exec_stats.resumes == 1
    assert _rel_err(host, ref) <= TOL
    np.testing.assert_array_equal(
        host, _executor("eager").execute(resume_plan(plan, 2), snap[1])[0])
    # and the other way round: the port's snapshot resumes the JAX run
    pmgr = CheckpointManager(str(tmp_path / "port"))
    with pytest.raises(PlanExecutionError):
        _executor("eager").execute(
            plan, x, injector=_kernel_fault_at(2).injector(),
            on_commit=PlanCheckpointer(pmgr, plan).on_commit)
    jck = jre.PlanCheckpointer(JaxCheckpointManager(pmgr.dir), jplan)
    rnd, host = jck.latest()
    assert rnd == 1
    jout, _ = jex.EagerExecutor(policy=JAX_POLICY).execute(
        jre.resume_plan(jplan, rnd + 1), host)
    assert _rel_err(jout, ref) <= TOL
