"""The port's sharded plans and lockstep simulator vs the JAX package, on
the CPU.

* every entry of ``tests/data/golden_sharded_plans.json`` recompiles to
  the exact schedule with the port's planner (infeasible entries fail
  with the same message), and the hierarchical compiler's flat path is a
  strict no-op;
* over the JAX test's own grid (``tests/test_shard_plan.py``: three
  stencils x five meshes on 48 x 48) and ``k_ici`` in {1, 2}, each plan's
  ``repr`` — hence ``plan_fingerprint`` — and its accounting equal the
  JAX package's;
* the port's ``ShardedSimExecutor`` is within 1e-5 of the JAX
  simulator's output and of the oracle, with equal ``ExecStats``
  counters, and no halo payload aliases a band;
* ``autotune_sharded``, ``predicted_sharded_makespan`` and
  ``tune(mesh=...)`` rank and price exactly as the JAX package does on
  the same ``Hardware``.

Inputs from a numpy seed, ``device="cpu"``.
"""
import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import compress as jcomp
from repro.core import distributed as jdist
from repro.core import executor as jex
from repro.core import hierarchy as jhier
from repro.core import recovery as jre
from repro.core import shard as jsh
from repro.core import stencil as jst
from repro.core.autotune import _autotune_sharded as jax_autotune_sharded
from repro.core.autotune import autotune_sharded as jax_autotune_sharded_alias
from repro.core.autotune import \
    predicted_sharded_makespan as jax_predicted_sharded_makespan
from repro.core.tune import TuneSpec as JaxTuneSpec
from repro.core.tune import tune as jax_tune
from repro.core.lower import lower_sharded as jax_lower_sharded
from repro_torch.core.autotune import (
    _autotune_sharded, autotune_sharded, predicted_sharded_makespan)
from repro_torch.core import compress as tcomp
from repro_torch.core import distributed as tdist
from repro_torch.core import executor as tex
from repro_torch.core import recovery as tre
from repro_torch.core import shard as tsh
from repro_torch.core import stencil as tst
from repro_torch.core.tune import TuneSpec, tune
from repro_torch.core.analytic import H100_SXM, RTX3080_PAPER, TPU_V5E
from repro_torch.core.hierarchy import compile_hierarchical
from repro_torch.core.lower import lower_sharded
from repro_torch.core.reference import run_reference

TOL = 1e-5
MESHES = [(1, 1), (2, 2), (3, 3), (4, 2), (1, 4)]
STENCILS = ["box2d1r", "box2d2r", "gradient2d"]
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_sharded_plans.json")
with open(GOLDEN) as _f:
    GOLDEN_PLANS = json.load(_f)


def _domain(seed=31, Y=48, X=48):
    return np.random.default_rng(seed).standard_normal((Y, X)).astype(
        np.float32)


def _sim():
    return tex.ShardedSimExecutor(device="cpu")


def _op_rec(op):
    """The golden fixture's record of one op (tests/test_shard_plan.py)."""
    t = type(op).__name__
    d = {"type": t}
    if t in ("ShardLoad", "ShardStore"):
        d.update(rank=op.rank, lo=list(op.box.lo), hi=list(op.box.hi),
                 nbytes=op.nbytes, round=op.round, phase=op.phase)
    elif t == "HaloSend":
        d.update(rank=op.rank, dst=op.dst, axis=op.axis, side=op.side,
                 depth=op.depth, nbytes=op.nbytes, round=op.round,
                 phase=op.phase)
    elif t == "HaloRecv":
        d.update(rank=op.rank, src=op.src, axis=op.axis, side=op.side,
                 depth=op.depth, nbytes=op.nbytes, round=op.round,
                 phase=op.phase)
    elif t == "ShardKernel":
        d.update(rank=op.rank, stencil=op.stencil, steps=op.steps,
                 gy0=op.gy0, gx0=op.gx0, h=op.h, w=op.w,
                 hbm_bytes=op.hbm_bytes, flops=op.flops,
                 elements=op.elements, round=op.round, phase=op.phase)
    elif t in ("HaloCompress", "HaloDecompress"):
        d.update(codec=op.codec, rank=op.rank, peer=op.peer,
                 axis=op.axis, side=op.side, direction=op.direction,
                 raw_nbytes=op.raw_nbytes, wire_nbytes=op.wire_nbytes,
                 round=op.round, phase=op.phase)
    return d


# ------------------------------------------------- golden fixture


@pytest.mark.parametrize("key", sorted(GOLDEN_PLANS))
def test_golden_sharded_plan_recompiles_exactly(key):
    rec = GOLDEN_PLANS[key]
    stname, geom, meshs, codec = key.split("/")
    Y, X, n, k = map(int, re.match(r"Y(\d+)X(\d+)n(\d+)k(\d+)",
                                   geom).groups())
    mesh = tuple(map(int, re.match(r"mesh(\d+)x(\d+)", meshs).groups()))
    if "error" in rec:
        with pytest.raises(ValueError) as exc:
            tsh.compile_sharded(stname, Y, X, n, k, mesh)
        assert str(exc.value) == rec["error"]
        return
    plan = tsh.compile_sharded(stname, Y, X, n, k, mesh)
    if codec != "identity":
        plan = tcomp.compress_plan(plan, codec)
    m = rec["plan"]
    assert plan.codec == m["codec"]
    assert plan.exact_elements == m["exact_elements"]
    assert [dataclasses.asdict(s) for s in plan.shards] == rec["shards"]
    assert [[_op_rec(op) for op in s] for s in plan.streams] \
        == rec["streams"]
    assert [list(b) for b in plan.barriers] == rec["barriers"]
    assert dataclasses.asdict(plan.stats()) == rec["stats"]
    assert plan.breakdown() == rec["breakdown"]
    assert plan.op_counts() == rec["op_counts"]
    assert plan.collective_bytes_per_round \
        == rec["collective_bytes_per_round"]
    assert plan.collective_wire_bytes_per_round \
        == rec["collective_wire_bytes_per_round"]
    # the hierarchical compiler's flat path is a strict no-op
    hier = compile_hierarchical(stname, Y, X, n, k, mesh, c_dev=1 << 40,
                                codec=None if codec == "identity" else codec)
    assert hier == plan


def test_golden_fixture_has_every_entry():
    errors = sum(1 for rec in GOLDEN_PLANS.values() if "error" in rec)
    assert len(GOLDEN_PLANS) == 39 and len(GOLDEN_PLANS) - errors >= 36


# ------------------------------------------------- parity with JAX plans


@pytest.mark.parametrize("k_ici", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", STENCILS)
def test_plan_repr_fingerprint_and_accounting_equal_jax(name, mesh, k_ici):
    tp = tsh.compile_sharded(name, 48, 48, 6, k_ici, mesh)
    jp = jsh.compile_sharded(name, 48, 48, 6, k_ici, mesh)
    assert repr(tp) == repr(jp)
    assert tre.plan_fingerprint(tp) == jre.plan_fingerprint(jp)
    assert dataclasses.asdict(tp.stats()) == dataclasses.asdict(jp.stats())
    for r in range(tp.n_ranks):
        assert dataclasses.asdict(tp.per_rank_stats(r)) \
            == dataclasses.asdict(jp.per_rank_stats(r))
        assert tp.ici_bytes_per_round(r) == jp.ici_bytes_per_round(r)
    assert tp.op_counts() == jp.op_counts()
    assert repr(tp.phases()) == repr(jp.phases())
    assert tp.collective_bytes_per_round == jp.collective_bytes_per_round
    z = tcomp.compress_plan(tp, "zrle")
    assert repr(z) == repr(jcomp.compress_plan(jp, "zrle"))
    assert z.collective_wire_bytes_per_round \
        < tp.collective_bytes_per_round or mesh == (1, 1)


@pytest.mark.parametrize("k_ici", [1, 2, 3])
def test_collective_formula_equals_jax_and_the_plan(k_ici):
    st = tst.get_stencil("box2d2r")
    plan = tsh.compile_sharded("box2d2r", 48, 48, 6, k_ici, (3, 3))
    full = tdist.collective_bytes_per_round((16, 16), st.radius, k_ici, 4)
    assert full == jdist.collective_bytes_per_round((16, 16), st.radius,
                                                    k_ici, 4)
    assert plan.ici_bytes_per_round(4) == full   # the interior rank
    assert tsh.ghost_wedge_elements(48, 48, 2, k_ici, 6, (3, 3)) \
        == jsh.ghost_wedge_elements(48, 48, 2, k_ici, 6, (3, 3)) \
        == plan.stats().elements_computed
    assert tsh.shard_working_set(16, 16, 2 * k_ici, 4, (5,)) \
        == jsh.shard_working_set(16, 16, 2 * k_ici, 4, (5,))


@pytest.mark.parametrize("args, kw", [
    (("box2d1r", 50, 48, 6, 1, (4, 2)), {}),
    (("box2d1r", 48, 48, 7, 2, (2, 2)), {}),
    (("box2d2r", 48, 48, 12, 6, (4, 1)), {}),
    (("box2d1r", 48, 48, 6, 1, (0, 2)), {}),
    (("box2d1r", 48, 48, 6, 1, (2, 2)), {"trailing": (2,)}),
    (("box2d1r", 48, 48, 6, 1, (2, 2)), {"c_dev": 1000}),
])
def test_infeasible_geometry_raises_jax_messages(args, kw):
    with pytest.raises(ValueError) as want:
        jsh.compile_sharded(*args, **kw)
    with pytest.raises(ValueError) as got:
        tsh.compile_sharded(*args, **kw)
    assert str(got.value) == str(want.value)


def test_unknown_stencil_raises_key_error():
    with pytest.raises(KeyError):
        tsh.compile_sharded("nope2d", 48, 48, 6, 1, (2, 2))


# ------------------------------------------------- the simulator


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", STENCILS)
def test_sim_matches_jax_sim_and_oracle_with_equal_counters(name, mesh):
    x = _domain()
    n, k = 6, 3
    tp = tsh.compile_sharded(name, 48, 48, n, k, mesh)
    jp = jsh.compile_sharded(name, 48, 48, n, k, mesh)
    ex, jx = _sim(), jex.ShardedSimExecutor()
    out, stats = ex.execute(tp, x)
    want, jstats = jx.execute(jp, x)
    assert np.abs(out - np.asarray(want)).max() < TOL
    ref = run_reference(torch.from_numpy(x), tst.get_stencil(name), n)
    assert np.abs(out - ref.numpy()).max() < TOL
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    es, js = ex.exec_stats, jx.exec_stats
    for field in ("executor", "kernel_impl", "op_counts", "kernel_calls",
                  "shape_buckets", "kernel_compiles", "kernel_cache_hits",
                  "stage_count", "faults_injected", "retries"):
        assert getattr(es, field) == getattr(js, field), field
    assert set(es.op_wall_s) == set(js.op_wall_s)


def test_dry_run_stats_equal_executed_stats():
    for name, mesh, k in (("box2d1r", (4, 2), 1), ("gradient2d", (3, 3), 2),
                          ("box2d2r", (1, 4), 3)):
        plan = tsh.compile_sharded(name, 48, 48, 6, k, mesh)
        _, dry = tex.DryRunExecutor().execute(plan)
        _, run = _sim().execute(plan, _domain(seed=k))
        assert dataclasses.asdict(dry) == dataclasses.asdict(run)


def test_halo_payloads_never_alias_a_band():
    """Each stage of the lowered program runs by hand: after every send
    phase, no mailbox payload shares storage with any rank's band, and
    the caller's input is never written."""
    x = _domain(seed=5)
    x0 = x.copy()
    plan = tsh.compile_sharded("box2d1r", 48, 48, 4, 2, (2, 2))
    compiled = lower_sharded(plan, device="cpu")
    from repro_torch.core.lower import _ShardRuntime, validate_domain

    rt = _ShardRuntime(validate_domain(plan, x), compiled.n_slots,
                       torch.device("cpu"))
    sends = 0
    for stage in compiled.stages:
        for _, fn, _, _ in stage.ops:
            fn(rt)
        if stage.label.endswith("send"):
            ptrs = {b.untyped_storage().data_ptr()
                    for b in rt.bands if b is not None}
            for payload in rt.mail.values():
                assert payload.untyped_storage().data_ptr() not in ptrs
                sends += 1
    rt.commit()
    assert sends == plan.stats().halo_ops // 2
    np.testing.assert_array_equal(x, x0)
    out, _ = _sim().execute(plan, x)
    np.testing.assert_array_equal(rt.host, out)


def test_masked_local_steps_matches_jax_and_keeps_its_input():
    rng = np.random.default_rng(2)
    ext = rng.standard_normal((20, 26)).astype(np.float32)
    for name in ("box2d2r", "gradient2d"):
        st = tst.get_stencil(name)
        band = torch.from_numpy(ext.copy())
        got = tdist.masked_local_steps(band, st, 3, -2, 9, 24, 40)
        want = jdist.masked_local_steps(jnp.asarray(ext),
                                        jst.get_stencil(name), 3, -2, 9,
                                        24, 40)
        assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
        np.testing.assert_array_equal(band.numpy(), ext)


def test_lowered_streams_share_one_kernel_signature():
    plan = tsh.compile_sharded("box2d1r", 48, 48, 8, 2, (2, 2))
    ex = _sim()
    ex.execute(plan, _domain())
    es = ex.exec_stats
    n_kernels = plan.n_ranks * plan.rounds
    assert (es.executor, es.shape_buckets, es.kernel_compiles) \
        == ("sharded_sim", 1, 1)
    assert es.kernel_calls == n_kernels
    assert es.kernel_cache_hits == n_kernels - 1
    assert es.stage_count == len(plan.barriers)
    ex.execute(plan, _domain(seed=1))
    assert ex.exec_stats.kernel_compiles == 0
    assert ex.exec_stats.kernel_cache_hits == n_kernels
    compiled = lower_sharded(plan, device="cpu")
    jdesc = jax_lower_sharded(jsh.compile_sharded(
        "box2d1r", 48, 48, 8, 2, (2, 2))).describe()
    assert compiled.describe() == jdesc
    assert compiled.n_slots == plan.n_ranks


def test_executor_registry_and_rejections():
    assert type(tex.get_executor("sharded_sim", device="cpu")) \
        is tex.ShardedSimExecutor
    assert type(tex.get_executor("shard_map", device="cpu")) \
        is tex.ShardMapExecutor
    # configuration these executors would silently drop is rejected
    for name in ("sharded_sim", "shard_map", "dry_run"):
        with pytest.raises(ValueError, match="fused_step/policy"):
            tex.get_executor(name, fused_step=lambda *a: None)
    plan = tsh.compile_sharded("box2d1r", 48, 48, 2, 1, (1, 1))
    with pytest.raises(ValueError, match="itemsize"):
        _sim().execute(plan, _domain().astype(np.float64))
    with pytest.raises(ValueError, match="dry-run-only"):
        _sim().execute(tsh.compile_sharded("box2d1r", 48, 48, 2, 1, (2, 2),
                                           trailing=(5,)), _domain())


def test_default_device_is_cuda_and_the_simulator_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    plan = tsh.compile_sharded("box2d1r", 48, 48, 2, 1, (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.ShardedSimExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower_sharded(plan)


# ------------------------------------------------- the sharded tuner


def _jax_hw(hw):
    return jan.Hardware(**dataclasses.asdict(hw))


def _rows(choices):
    return [dataclasses.asdict(c) for c in choices]


@pytest.mark.parametrize("hw", [TPU_V5E, H100_SXM], ids=lambda h: h.name)
def test_autotune_sharded_rankings_equal_jax(hw):
    st = tst.get_stencil("box2d2r")
    with pytest.warns(DeprecationWarning):
        got = autotune_sharded(st, 512, 64, hw, n_devices=8,
                                   codecs=("identity", "zrle"))
    with pytest.warns(DeprecationWarning):
        want = jax_autotune_sharded_alias(jst.get_stencil("box2d2r"), 512, 64,
                                    _jax_hw(hw), n_devices=8,
                                    codecs=("identity", "zrle"))
    assert _rows(got) == _rows(want) and len(got) > 8
    assert {c.mesh for c in got} == {(1, 8), (2, 4), (4, 2), (8, 1)}
    if hw is TPU_V5E:    # latency modeled: deeper k_ici wins
        assert got[0].k_ici > 1


def test_autotune_sharded_skips_infeasible_and_rejects_ici_less_hw():
    st = tst.get_stencil("box2d4r")
    got = _autotune_sharded(st, 128, 64, TPU_V5E, n_devices=8,
                                k_ici_grid=(1, 2, 4, 8))
    want = jax_autotune_sharded(jst.get_stencil("box2d4r"), 128, 64,
                                 jan.TPU_V5E, n_devices=8,
                                 k_ici_grid=(1, 2, 4, 8))
    assert _rows(got) == _rows(want) and got
    with pytest.raises(ValueError, match="ICI"):
        _autotune_sharded(st, 64, 8, RTX3080_PAPER)


def test_predicted_sharded_makespan_equals_jax():
    for codec in (None, "zrle"):
        tp = compile_hierarchical("star2d1r", 48, 48, 8, 2, (2, 2),
                                  inner_d=3, codec=codec)
        jplan = jhier.compile_hierarchical("star2d1r", 48, 48, 8, 2, (2, 2),
                                           inner_d=3, codec=codec)
        assert predicted_sharded_makespan(tp, TPU_V5E) \
            == jax_predicted_sharded_makespan(jplan, jan.TPU_V5E)
        flat = tsh.compile_sharded("box2d1r", 96, 96, 8, 4, (2, 2))
        assert predicted_sharded_makespan(flat, TPU_V5E) \
            == jax_predicted_sharded_makespan(
                jsh.compile_sharded("box2d1r", 96, 96, 8, 4, (2, 2)),
                jan.TPU_V5E)
    with pytest.raises(ValueError, match="ICI"):
        predicted_sharded_makespan(flat, RTX3080_PAPER)


@pytest.mark.parametrize("mesh", [8, (2, 4)])
def test_tune_sharded_mode_equals_jax(mesh):
    spec = TuneSpec("box2d2r", 512, 64, mesh=mesh)
    got = tune(spec, hw=TPU_V5E, budget=2, device="cpu")
    want = jax_tune(JaxTuneSpec("box2d2r", 512, 64, mesh=mesh),
                      hw=jan.TPU_V5E, budget=2)
    assert [(r.mode, r.engine, r.config, r.modeled_s, r.bottleneck,
             r.extras, r.measured_s) for r in got] \
        == [(r.mode, r.engine, r.config, r.modeled_s, r.bottleneck,
             r.extras, r.measured_s) for r in want]
    assert got and all(r.mode == "sharded" for r in got)
    if isinstance(mesh, tuple):
        assert {r.config["mesh"] for r in got} == {mesh}
    json.dumps(got[0].to_record())
