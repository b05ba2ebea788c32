"""The port's hierarchical plans vs the JAX package, on the CPU.

Mirrors ``tests/test_hierarchy.py`` (48 x 48 on a (2, 2) mesh, every
shard streamed through >= 3 inner chunks): the port's plans equal the
JAX package's (``repr``, fingerprint, two-level accounting, inner
chunks), the simulator's hierarchical output is bitwise equal to the
flat sharded plan's for every inner engine (a lossless halo codec
included) and within 1e-5 of the JAX simulator and the oracle, the lossy
``bf16`` halo codec stays within the JAX test's bound, and the knobs are
rejected with the JAX package's messages.  Inputs from a numpy seed,
``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.core import hierarchy as jhier
from repro.core import recovery as jre
from repro.core.lower import lower as jax_lower
from repro_torch.core import executor as tex
from repro_torch.core import recovery as tre
from repro_torch.core.compress import compress_plan, get_codec
from repro_torch.core.hierarchy import (
    INNER_ENGINES, HierarchicalPlan, compile_hierarchical,
)
from repro_torch.core.lower import lower
from repro_torch.core.plan import ShardedPlan
from repro_torch.core.reference import run_reference
from repro_torch.core.shard import compile_sharded, shard_working_set
from repro_torch.core.stencil import get_stencil

TOL = 1e-5
Y = X = 48
MESH = (2, 2)
N, K_ICI = 8, 2
INNER_D = 3


def _domain(seed=17):
    return np.random.default_rng(seed).standard_normal((Y, X)).astype(
        np.float32)


def _kw(engine, kw):
    kw = dict(kw)
    if engine == "box_tb":
        kw.setdefault("inner_tiles", (INNER_D, 2))
    else:
        kw.setdefault("inner_d", INNER_D)
    return kw


def _hier(stencil="star2d1r", engine="so2dr", codec=None, **kw):
    return compile_hierarchical(stencil, Y, X, N, K_ICI, MESH,
                                inner_engine=engine, codec=codec,
                                **_kw(engine, kw))


def _jax_hier(stencil="star2d1r", engine="so2dr", codec=None, **kw):
    return jhier.compile_hierarchical(stencil, Y, X, N, K_ICI, MESH,
                                      inner_engine=engine, codec=codec,
                                      **_kw(engine, kw))


def _sim():
    return tex.ShardedSimExecutor(device="cpu")


@pytest.mark.parametrize("codec", [None, "zrle"])
@pytest.mark.parametrize("engine", sorted(INNER_ENGINES))
@pytest.mark.parametrize("stencil", ["star2d1r", "box2d2r"])
def test_hier_bitwise_to_flat_and_matches_jax_and_oracle(stencil, engine,
                                                         codec):
    x = _domain(seed=3)
    plan = _hier(stencil, engine, codec)
    jplan = _jax_hier(stencil, engine, codec)
    assert isinstance(plan, HierarchicalPlan) and plan.inner_chunks >= 3
    assert repr(plan) == repr(jplan)
    assert tre.plan_fingerprint(plan) == jre.plan_fingerprint(jplan)
    assert plan.inner_chunks == jplan.inner_chunks
    assert len(plan) == len(jplan) and plan.op_counts() == jplan.op_counts()
    flat = compile_sharded(stencil, Y, X, N, K_ICI, MESH)
    ex = _sim()
    got, stats = ex.execute(plan, x)
    want, _ = _sim().execute(flat, x)
    np.testing.assert_array_equal(got, want)
    jx = jex.ShardedSimExecutor()
    jgot, jstats = jx.execute(jplan, x)
    assert np.abs(got - np.asarray(jgot)).max() < TOL
    ref = run_reference(torch.from_numpy(x), get_stencil(stencil), N).numpy()
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6) < TOL
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats) \
        == dataclasses.asdict(plan.stats())
    for field in ("kernel_impl", "op_counts", "kernel_calls", "shape_buckets",
                  "kernel_compiles", "kernel_cache_hits", "stage_count"):
        assert getattr(ex.exec_stats, field) \
            == getattr(jx.exec_stats, field), field


def test_hier_lossy_codec_stays_within_its_error_bound():
    x = _domain(seed=5)
    got, _ = _sim().execute(_hier(codec="bf16"), x)
    want, _ = _sim().execute(_hier(), x)
    scale = np.abs(want).max() + 1e-6
    err = np.abs(got - want).max() / scale
    assert 0 < err < 64 * get_codec("bf16").max_rel_error
    jgot, _ = jex.ShardedSimExecutor().execute(_jax_hier(codec="bf16"), x)
    assert np.abs(got - np.asarray(jgot)).max() / scale < TOL


def test_inner_codec_runs_and_equals_jax():
    x = _domain(seed=7)
    plan = _hier(inner_codec="zrle")
    assert repr(plan) == repr(_jax_hier(inner_codec="zrle"))
    got, _ = _sim().execute(plan, x)
    want, _ = _sim().execute(_hier(), x)
    np.testing.assert_array_equal(got, want)


def test_dry_run_stats_equal_executed_stats_at_both_levels():
    plan = _hier(codec="zrle")
    _, dry = tex.DryRunExecutor().execute(plan)
    _, executed = _sim().execute(plan, _domain())
    assert dataclasses.asdict(dry) == dataclasses.asdict(executed)
    outer = plan.outer.stats()
    assert (dry.ici_bytes, dry.ici_wire_bytes, dry.halo_ops) \
        == (outer.ici_bytes, outer.ici_wire_bytes, outer.halo_ops)
    for field in ("h2d_bytes", "d2h_bytes", "h2d_wire_bytes",
                  "d2h_wire_bytes", "buffer_bytes"):
        inner_total = sum(getattr(plan.inner_stats(r), field)
                          for r in range(plan.n_ranks)) * plan.rounds
        assert getattr(dry, field) == inner_total, field
    jplan = _jax_hier(codec="zrle")
    for r in range(plan.n_ranks):
        assert dataclasses.asdict(plan.per_rank_stats(r)) \
            == dataclasses.asdict(jplan.per_rank_stats(r))
    assert plan.breakdown() == jplan.breakdown()


def test_masked_inner_lowering_describes_like_jax():
    plan = _hier("box2d2r", "resreu")
    jplan = _jax_hier("box2d2r", "resreu")
    hk = K_ICI * 2
    for rank, sh in enumerate(plan.shards):
        origin = (sh.y0 - hk, sh.x0 - hk, Y, X)
        got = lower(plan.inner[rank], shard_origin=origin,
                    device="cpu").describe()
        assert got == jax_lower(jplan.inner[rank],
                                shard_origin=origin).describe()
        assert got["kernel_impl"] == "masked_hier"


def test_fitting_shard_compiles_bit_identical_flat_plan():
    plan = compile_hierarchical("star2d1r", Y, X, N, K_ICI, MESH,
                                c_dev=1 << 30)
    flat = compile_sharded("star2d1r", Y, X, N, K_ICI, MESH)
    assert isinstance(plan, ShardedPlan) and plan == flat
    z = compile_hierarchical("star2d1r", Y, X, N, K_ICI, MESH,
                             c_dev=1 << 30, codec="zrle")
    assert z == compress_plan(flat, "zrle")


def test_capacity_derives_inner_chunks_like_jax_and_stays_exact():
    x = _domain(seed=9)
    hk = K_ICI * get_stencil("star2d1r").radius
    ws = shard_working_set(Y // 2, X // 2, hk, 4)
    for engine in sorted(INNER_ENGINES):
        plan = compile_hierarchical("star2d1r", Y, X, N, K_ICI, MESH,
                                    c_dev=ws // 2, inner_engine=engine)
        jplan = jhier.compile_hierarchical("star2d1r", Y, X, N, K_ICI, MESH,
                                           c_dev=ws // 2,
                                           inner_engine=engine)
        assert repr(plan) == repr(jplan) and plan.c_dev == ws // 2
        assert plan.inner_chunks >= 2
    got, _ = _sim().execute(plan, x)
    want, _ = _sim().execute(compile_sharded("star2d1r", Y, X, N, K_ICI,
                                             MESH), x)
    np.testing.assert_array_equal(got, want)


def test_trailing_hierarchical_plans_are_dry_run_only():
    plan = _hier(trailing=(64,))
    assert repr(plan.stats()) == repr(_jax_hier(trailing=(64,)).stats())
    assert plan.stats().h2d_bytes > 0
    with pytest.raises(ValueError, match="dry-run-only"):
        _sim().execute(plan, _domain())


@pytest.mark.parametrize("kw", [
    dict(inner_engine="naive_tb", inner_d=2),
    dict(inner_engine="so2dr", inner_tiles=(2, 2)),
    dict(inner_engine="so2dr", inner_d=10**6),
    dict(inner_engine="box_tb", inner_tiles=(0, 2)),
    dict(inner_engine="so2dr", c_dev=64),
    dict(inner_engine="box_tb", c_dev=64),
    dict(inner_engine="so2dr", inner_d=2, inner_codec="zrle",
         trailing=(5,)),
])
def test_bad_knobs_raise_jax_messages(kw):
    with pytest.raises(ValueError) as want:
        jhier.compile_hierarchical("star2d1r", Y, X, N, K_ICI, MESH, **kw)
    with pytest.raises(ValueError) as got:
        compile_hierarchical("star2d1r", Y, X, N, K_ICI, MESH, **kw)
    assert str(got.value) == str(want.value)
