"""The port's multi-process sharded backend vs the JAX package, on the CPU.

Mirrors the shard_map halves of ``tests/test_distributed.py``,
``tests/test_shard_plan.py``, ``tests/test_hierarchy.py`` and
``tests/test_faults.py``: where the JAX tests run ``shard_map`` on 8
fake devices in a subprocess, the port's ranks are processes joined by
gloo over CPU tensors (``device="cpu"``), one group per mesh shared by
the module.  ``run_distributed``, ``execute_sharded_plan`` and
``ShardMapExecutor`` are held within 1e-5 of the JAX package's
``run_reference`` and ``ShardedSimExecutor``, bitwise equal to the
port's own simulator (same bands, same ops), with stats equal to
``plan.stats()``, the JAX package's rejection messages, the JAX
``ElasticReport`` for a rank loss, and every wait bounded: a rank that
raises or dies fails the call within its deadline, and no rank process
outlives its mesh.  Inputs from numpy seeds.
"""
import dataclasses
import multiprocessing
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.compat import AxisType, make_mesh
from repro.core import executor as jex
from repro.core import faults as jfa
from repro.core import hierarchy as jhier
from repro.core import shard as jsh
from repro.core.distributed import execute_sharded_plan as jax_execute
from repro.core.distributed import run_distributed as jax_run_distributed
from repro.core.reference import run_reference as jax_run_reference
from repro.core.stencil import get_stencil as jax_get_stencil
from repro.launch import elastic as jel
from repro_torch.core.distributed import (
    execute_sharded_plan, run_distributed,
)
from repro_torch.core.executor import (
    ShardMapExecutor, ShardedSimExecutor, get_executor,
)
from repro_torch.core.faults import RANK_LOSS, FaultPlan, FaultTrigger
from repro_torch.core.hierarchy import compile_hierarchical
from repro_torch.core.ranks import RankFailure, RankMesh
from repro_torch.core.shard import compile_sharded
from repro_torch.launch.elastic import run_elastic_sharded

TOL = 1e-5
TIMEOUT = 60.0          # every wait on a rank: start, one call, close
STENCILS = ("box2d1r", "gradient2d", "box2d2r")
N_K = [(6, 1), (6, 3), (8, 4)]


def _rank_processes():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("repro_torch-rank")]


@pytest.fixture(scope="module")
def mesh42():
    with RankMesh((4, 2), device="cpu", timeout=TIMEOUT) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def mesh22():
    with RankMesh((2, 2), device="cpu", timeout=TIMEOUT) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def mesh11():
    with RankMesh((1, 1), device="cpu", timeout=TIMEOUT) as mesh:
        yield mesh


def _sim(plan, x):
    return ShardedSimExecutor(device="cpu").execute(plan, x)


def _domain_of(seed, name, shape=(64, 128)):
    """The domain the JAX test draws for ``name``: one draw per stencil,
    in ``STENCILS`` order, from one generator."""
    rng = np.random.default_rng(seed)
    for _ in range(STENCILS.index(name) + 1):
        x = rng.standard_normal(shape).astype(np.float32)
    return x


def _jax_ref(x, name, n):
    return np.asarray(jax_run_reference(jnp.asarray(x),
                                        jax_get_stencil(name), n))


def _jax_mesh11():
    return make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)


# ------------------------------------------------- run_distributed


@pytest.mark.parametrize("n,k", N_K)
@pytest.mark.parametrize("name", STENCILS)
def test_run_distributed_on_eight_ranks(mesh42, name, n, k):
    """tests/test_distributed.py's (4, 2) sweep: within 1e-5 of the JAX
    oracle and bitwise equal to the port's simulator."""
    x = _domain_of(2, name)
    x0 = x.copy()
    got = run_distributed(x, name, n, k, mesh42)
    np.testing.assert_array_equal(x, x0)          # the input is not written
    assert np.abs(got - _jax_ref(x, name, n)).max() < TOL
    want, _ = _sim(compile_sharded(name, 64, 128, n, k, (4, 2)), x)
    np.testing.assert_array_equal(got, want)
    assert mesh42.transport == "gloo"


def test_run_distributed_single_rank_mesh(mesh11):
    """The (1, 1) case of tests/test_distributed.py, beside the JAX
    backend on a one-device mesh."""
    x = np.random.default_rng(5).standard_normal((32, 32)).astype(
        np.float32)
    got = run_distributed(x, "box2d1r", 6, 2, mesh11)
    assert np.abs(got - _jax_ref(x, "box2d1r", 6)).max() < TOL
    jgot = np.asarray(jax_run_distributed(jnp.asarray(x), "box2d1r", 6, 2,
                                          _jax_mesh11()))
    assert np.abs(got - jgot).max() < TOL
    want, _ = _sim(compile_sharded("box2d1r", 32, 32, 6, 2, (1, 1)), x)
    np.testing.assert_array_equal(got, want)


def test_rows_over_the_second_mesh_axis(mesh42):
    """Rows sharded over ``model`` and columns over ``data``: a (4, 2)
    group runs a (2, 4) plan, bitwise equal to the simulator's (2, 4)
    run."""
    x = _domain_of(7, "box2d1r")
    plan = compile_sharded("box2d1r", 64, 128, 6, 3, (2, 4))
    got = execute_sharded_plan(plan, x, mesh42, row_axis="model",
                               col_axis="data")
    want, _ = _sim(plan, x)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- ShardMapExecutor


@pytest.mark.parametrize("name", STENCILS)
def test_shard_map_executor_matches_the_jax_simulator(mesh42, name):
    """tests/test_shard_plan.py's differential sweep: within 1e-5 of the
    JAX simulator and oracle, bitwise equal to the port's simulator,
    stats equal to ``plan.stats()`` and the JAX plan's, and the JAX
    backend's ``ExecStats`` fields."""
    x = _domain_of(7, name)
    ex = ShardMapExecutor(mesh=mesh42)
    for n, k in N_K:
        plan = compile_sharded(name, 64, 128, n, k, (4, 2))
        jplan = jsh.compile_sharded(name, 64, 128, n, k, (4, 2))
        got, stats = ex.execute(plan, x)
        jgot, jstats = jex.ShardedSimExecutor().execute(jplan, x)
        assert np.abs(got - np.asarray(jgot)).max() < TOL, (name, n, k)
        assert np.abs(got - _jax_ref(x, name, n)).max() < TOL, (name, n, k)
        want, _ = _sim(plan, x)
        np.testing.assert_array_equal(got, want)
        assert stats == plan.stats()
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
        es = ex.exec_stats
        assert (es.executor, es.kernel_impl, es.kernel_calls,
                es.stage_count) == ("shard_map", "shard_map",
                                    plan.n_ranks * plan.rounds,
                                    len(plan.barriers))
        assert es.op_wall_s["GroupStart"] == 0.0     # the caller's mesh
        assert [r["update_calls"] for r in ex.rank_stats] \
            == [plan.rounds] * plan.n_ranks
    assert ex.transport == "gloo" and not ex.supports_injection
    ex.close()                                # leaves the caller's mesh
    assert not mesh42.closed


def test_executor_starts_reuses_and_replaces_its_own_mesh():
    """Without a mesh the executor starts one at its first ``execute``,
    reuses it for a plan of the same shape, replaces it for another
    shape, and ``close`` stops it."""
    x = _domain_of(3, "box2d1r", (32, 32))
    with ShardMapExecutor(device="cpu", timeout=TIMEOUT) as ex:
        assert ex._own is None                    # nothing started yet
        plan12 = compile_sharded("box2d1r", 32, 32, 4, 2, (1, 2))
        got, _ = ex.execute(plan12, x)
        first = ex._own
        assert ex.exec_stats.op_wall_s["GroupStart"] > 0
        ex.execute(plan12, x)
        assert ex._own is first and ex.exec_stats.op_wall_s[
            "GroupStart"] == 0.0
        np.testing.assert_array_equal(got, _sim(plan12, x)[0])
        plan21 = compile_sharded("box2d1r", 32, 32, 4, 2, (2, 1))
        got, _ = ex.execute(plan21, x)
        assert first.closed and ex._own.sizes == (2, 1)
        np.testing.assert_array_equal(got, _sim(plan21, x)[0])
        procs = ex._own.processes
    assert ex._own is None and not any(p.is_alive() for p in procs)


def test_registry_returns_the_multi_process_backend():
    """tests/test_shard_plan.py's registry assertions."""
    assert type(get_executor("shard_map", device="cpu")) is ShardMapExecutor
    with pytest.raises(ValueError, match="fused_step/policy"):
        get_executor("shard_map", fused_step=lambda *a: None)


# ------------------------------------------------- hierarchical plans


@pytest.mark.parametrize("codec", [None, "zrle"])
@pytest.mark.parametrize("engine,kw", [
    ("so2dr", dict(inner_d=3)), ("resreu", dict(inner_d=4)),
    ("box_tb", dict(inner_tiles=(3, 2)))])
def test_hierarchical_plans_run_on_their_outer_geometry(mesh22, engine, kw,
                                                        codec):
    """tests/test_hierarchy.py's shard_map sweep: each rank holds its
    full band, so the result is bitwise equal to the simulator's
    hierarchical run and within 1e-5 of the oracle, with the plan's
    two-level stats (equal to the JAX plan's)."""
    x = np.random.default_rng(7).standard_normal((48, 48)).astype(
        np.float32)
    plan = compile_hierarchical("star2d1r", 48, 48, 8, 2, (2, 2),
                                inner_engine=engine, codec=codec, **kw)
    jplan = jhier.compile_hierarchical("star2d1r", 48, 48, 8, 2, (2, 2),
                                       inner_engine=engine, codec=codec,
                                       **kw)
    assert plan.inner_chunks >= 3
    got, stats = ShardMapExecutor(mesh=mesh22).execute(plan, x)
    want, sim_stats = _sim(plan, x)
    np.testing.assert_array_equal(got, want)
    ref = _jax_ref(x, "star2d1r", 8)
    scale = np.abs(ref).max() + 1e-6
    assert np.abs(got - ref).max() / scale < TOL
    assert stats == sim_stats == plan.stats()
    assert dataclasses.asdict(stats) == dataclasses.asdict(jplan.stats())


# ------------------------------------------------- rejections


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_rejections_carry_the_jax_messages(mesh11):
    """float64 against an itemsize-4 plan, a trailing plan, a mismatched
    mesh and ``n % k_ici``: the port raises the JAX package's message,
    and a rejected executor starts no rank."""
    x = np.random.default_rng(31).standard_normal((48, 48)).astype(
        np.float32)
    jmesh = _jax_mesh11()
    ex = ShardMapExecutor(device="cpu", timeout=TIMEOUT)

    plan = compile_sharded("box2d1r", 48, 48, 2, 1, (1, 1))
    jplan = jsh.compile_sharded("box2d1r", 48, 48, 2, 1, (1, 1))
    x64 = x.astype(np.float64)
    want = _message(lambda: jax_execute(jplan, x64, mesh=jmesh))
    assert "itemsize" in want
    assert _message(lambda: ex.execute(plan, x64)) == want
    assert _message(lambda: execute_sharded_plan(plan, x64, mesh11)) == want

    tplan = compile_sharded("box2d1r", 48, 48, 2, 1, (1, 1), trailing=(5,))
    jtplan = jsh.compile_sharded("box2d1r", 48, 48, 2, 1, (1, 1),
                                 trailing=(5,))
    want = _message(lambda: jax_execute(jtplan, x, mesh=jmesh))
    assert "dry-run-only" in want
    assert _message(lambda: ex.execute(tplan, x)) == want

    plan22 = compile_sharded("box2d1r", 48, 48, 2, 1, (2, 2))
    jplan22 = jsh.compile_sharded("box2d1r", 48, 48, 2, 1, (2, 2))
    want = _message(lambda: jax_execute(jplan22, x, mesh=jmesh))
    assert want == "mesh shape (1, 1) does not match plan mesh (2, 2)"
    assert _message(lambda: execute_sharded_plan(plan22, x, mesh11)) == want
    assert _message(lambda: ShardMapExecutor(mesh=mesh11).execute(
        plan22, x)) == want

    want = _message(lambda: jax_run_distributed(jnp.asarray(x), "box2d1r",
                                                6, 4, jmesh))
    assert want == "n_steps must be divisible by k_ici (uniform scan)"
    assert _message(lambda: run_distributed(x, "box2d1r", 6, 4,
                                            mesh11)) == want
    assert ex._own is None


# ------------------------------------------------- elastic rank loss


class _FusedOnly:
    """The JAX simulator dispatched as one program (no per-op injection),
    the way the JAX harness drives its ``ShardMapExecutor``."""

    supports_injection = False

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, x):
        return self.inner.execute(plan, x)


def test_elastic_rank_loss_through_the_real_backend():
    """tests/test_faults.py's shard_map story: injection is probed per
    rank before dispatch, the mesh goes (4, 2) -> (3, 2) with one
    re-plan and one extra round, the report equals the JAX harness's,
    the output equals the fault-free run, and both rank groups are
    stopped by the harness."""
    x = np.random.default_rng(3).standard_normal((48, 32)).astype(
        np.float32)
    trig = dict(round=1, chunk=6, op_class="*", kind=RANK_LOSS)
    plan = compile_sharded("box2d1r", 48, 32, 8, 2, (4, 2))
    jplan = jsh.compile_sharded("box2d1r", 48, 32, 8, 2, (4, 2))
    made = []

    def factory(mesh_shape):
        made.append(ShardMapExecutor(device="cpu", timeout=TIMEOUT))
        return made[-1]

    out, rep = run_elastic_sharded(plan, x,
                                   faults=FaultPlan([FaultTrigger(**trig)]),
                                   executor_factory=factory)
    jout, jrep = jel.run_elastic_sharded(
        jplan, x, faults=jfa.FaultPlan([jfa.FaultTrigger(**trig)]),
        executor_factory=lambda m: _FusedOnly(jex.ShardedSimExecutor()))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.replans == 1 and rep.extra_rounds == 1
    assert rep.mesh_history == ((4, 2), (3, 2))
    assert [e.transport for e in made] == ["gloo", "gloo"]
    assert all(e._own is None for e in made)
    assert np.abs(out - np.asarray(jout)).max() < TOL
    ref, _ = _sim(plan, x)
    np.testing.assert_array_equal(out, ref)


# ------------------------------------------------- failures and lifetime


def test_a_rank_that_raises_fails_the_call_within_its_deadline():
    """Rank 1 raises while rank 0 waits on its halo: the parent raises
    with rank 1's traceback long before the deadline, kills the group,
    and refuses further calls."""
    x = np.ones((16, 16), np.float32)
    mesh = RankMesh((1, 2), device="cpu", timeout=TIMEOUT)
    procs = mesh.processes
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="(?s)rank 1 .*raised.*fault drill"):
        mesh.run(x, "box2d1r", 1, 2, "data", "model", fail_rank=1)
    assert time.monotonic() - t0 < TIMEOUT / 2
    assert mesh.closed and not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        run_distributed(x, "box2d1r", 2, 1, mesh)


def test_no_rank_process_outlives_its_mesh(mesh11, mesh22, mesh42):
    """A rank that dies fails the next call at once; closing the
    module's meshes leaves no rank process alive."""
    mesh11.processes[0].kill()
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 0"):
        run_distributed(np.ones((8, 8), np.float32), "box2d1r", 2, 1, mesh11)
    assert time.monotonic() - t0 < TIMEOUT / 2 and mesh11.closed
    for mesh in (mesh22, mesh42):
        mesh.close()
        assert mesh.closed
        assert not any(p.is_alive() for p in mesh.processes)
    assert not _rank_processes()
