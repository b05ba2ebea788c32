"""The port's elastic re-planning of sharded plans vs the JAX package, on
the CPU (mirrors the elastic half of ``tests/test_faults.py``).

A rank loss on a (4, 2) mesh re-plans to (3, 2) and costs one round; the
port's ``ElasticReport`` fields, output and terminal-fault
``last_committed_round`` equal the JAX package's for the same plan and
fault plan, and the fault-free elastic run is bitwise equal to the
simulator's.  Inputs from a numpy seed, ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.core import faults as jfa
from repro.core import shard as jsh
from repro.core.recovery import PlanExecutionError as JaxPlanExecutionError
from repro.launch import elastic as jel
from repro_torch.core.executor import ShardedSimExecutor
from repro_torch.core.faults import (
    KERNEL_FAULT, RANK_LOSS, FaultPlan, FaultTrigger,
)
from repro_torch.core.recovery import PlanExecutionError
from repro_torch.core.shard import compile_sharded
from repro_torch.launch.elastic import (
    ElasticReport, replan_sharded, run_elastic_sharded, shrink_mesh,
)

TOL = 1e-5


def _plans(stencil="star2d1r"):
    return (compile_sharded(stencil, 48, 32, 8, 2, (4, 2)),
            jsh.compile_sharded(stencil, 48, 32, 8, 2, (4, 2)))


def _x(seed=3):
    return np.random.default_rng(seed).standard_normal((48, 32)).astype(
        np.float32)


def _faults(triggers):
    """The same trigger list as a port and a JAX fault plan."""
    return (FaultPlan([FaultTrigger(*t) for t in triggers]),
            jfa.FaultPlan([jfa.FaultTrigger(*t) for t in triggers]))


def _report(rep):
    return dataclasses.asdict(rep), rep.extra_rounds


@pytest.mark.parametrize("triggers, history", [
    ([], ((4, 2),)),
    ([(1, 3, "*", RANK_LOSS)], ((4, 2), (3, 2))),
    ([(0, 0, "*", RANK_LOSS), (2, 1, "*", RANK_LOSS)],
     ((4, 2), (3, 2), (2, 2))),
    ([(3, 5, "HaloRecv", RANK_LOSS)], ((4, 2), (3, 2))),
])
def test_elastic_report_and_output_equal_jax(triggers, history):
    plan, jplan = _plans()
    x = _x()
    ref, _ = ShardedSimExecutor(device="cpu").execute(plan, x)
    faults, jfaults = _faults(triggers)
    out, rep = run_elastic_sharded(plan, x, faults=faults, device="cpu")
    jout, jrep = jel.run_elastic_sharded(jplan, x, faults=jfaults)
    assert isinstance(rep, ElasticReport)
    assert _report(rep) == _report(jrep)
    assert rep.mesh_history == history
    assert rep.extra_rounds == rep.replans == len(triggers)
    assert np.abs(out - np.asarray(jout)).max() < TOL
    if triggers:
        np.testing.assert_allclose(out, ref, atol=TOL)
    else:
        np.testing.assert_array_equal(out, ref)


def test_terminal_fault_last_committed_round_equals_jax():
    plan, jplan = _plans()
    faults, jfaults = _faults([(2, None, "*", KERNEL_FAULT)])
    with pytest.raises(PlanExecutionError) as got:
        run_elastic_sharded(plan, _x(), faults=faults, device="cpu")
    with pytest.raises(JaxPlanExecutionError) as want:
        jel.run_elastic_sharded(jplan, _x(), faults=jfaults)
    assert got.value.last_committed_round \
        == want.value.last_committed_round == 1
    assert got.value.fingerprint == want.value.fingerprint
    assert str(got.value) == str(want.value)


def test_replan_budget_exhausted_raises_like_jax():
    plan, jplan = _plans()
    trig = [(0, 0, "*", RANK_LOSS), (1, 0, "*", RANK_LOSS)]
    faults, jfaults = _faults(trig)
    with pytest.raises(PlanExecutionError) as got:
        run_elastic_sharded(plan, _x(), faults=faults, max_replans=1,
                            device="cpu")
    with pytest.raises(JaxPlanExecutionError) as want:
        jel.run_elastic_sharded(jplan, _x(), faults=jfaults, max_replans=1)
    assert got.value.last_committed_round \
        == want.value.last_committed_round == 0


class _FusedOnly:
    """An executor that runs a plan as one program (no per-op
    injection): the elastic harness probes each rank before dispatch."""

    supports_injection = False

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, x):
        return self.inner.execute(plan, x)


def test_fused_program_executor_probes_ranks_like_jax():
    plan, jplan = _plans("box2d1r")
    faults, jfaults = _faults([(1, 6, "*", RANK_LOSS)])
    out, rep = run_elastic_sharded(
        plan, _x(4), faults=faults,
        executor_factory=lambda m: _FusedOnly(
            ShardedSimExecutor(device="cpu")))
    jout, jrep = jel.run_elastic_sharded(
        jplan, _x(4), faults=jfaults,
        executor_factory=lambda m: _FusedOnly(jex.ShardedSimExecutor()))
    assert _report(rep) == _report(jrep)
    assert rep.mesh_history == ((4, 2), (3, 2))
    assert np.abs(out - np.asarray(jout)).max() < TOL


@pytest.mark.parametrize("mesh, rank", [((4, 2), 7), ((1, 4), 0),
                                        ((3, 3), 4), ((1, 1), 0),
                                        ((2, 2), 4)])
def test_shrink_mesh_equals_jax(mesh, rank):
    try:
        want = jel.shrink_mesh(mesh, rank)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            shrink_mesh(mesh, rank)
        assert str(got.value) == str(e)
        return
    assert shrink_mesh(mesh, rank) == want


def test_replan_sharded_equals_jax():
    plan, jplan = _plans()
    for kw in (dict(from_round=2), dict(from_round=1, lost_rank=3),
               dict(from_round=0, mesh_shape=(2, 2))):
        assert repr(replan_sharded(plan, **kw)) \
            == repr(jel.replan_sharded(jplan, **kw))
    cont = replan_sharded(plan, 2)
    assert cont.rounds == 2 and cont.mesh_shape == (4, 2)
    with pytest.raises(ValueError, match="nothing to replan"):
        replan_sharded(plan, plan.rounds)
    with pytest.raises(ValueError, match="divide evenly"):
        replan_sharded(plan, 0, mesh_shape=(5, 2))


def test_default_device_is_cuda_and_elastic_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    plan, _ = _plans()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_elastic_sharded(plan, _x())
