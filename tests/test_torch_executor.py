"""The port's lowering and executors vs the JAX package, on the CPU.

Same plan, same numpy domain: the port's eager and double-buffered
executors agree with the JAX executors to 1e-5 relative (the tolerance
of tests/test_kernel_exec.py), are bit-identical to each other and to
their op-at-a-time (``lowered=False``) paths, and report the JAX values
of ``stage_count``, ``shape_buckets`` and ``kernel_compiles``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import executor as jex
from repro.core import oocore as joo
from repro.core import stencil as jst
from repro.core.reference import run_reference as jax_run_reference
from repro.kernels.dispatch import DispatchPolicy as JaxPolicy
from repro_torch.core import executor as tex
from repro_torch.core import oocore as too
from repro_torch.core import stencil as tst
from repro_torch.core.lower import BucketRegistry, KernelCache, SlotPool, lower
from repro_torch.core.plan import BufferWrite
from repro_torch.kernels.dispatch import DispatchPolicy

RNG = np.random.default_rng(31)
TOL = 1e-5
ENGINES = ("incore", "naive_tb", "resreu", "so2dr", "box_tb")


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)


def _domain(r, rows, cols):
    return RNG.standard_normal((rows + 2 * r, cols + 2 * r)).astype(np.float32)


def _plans(engine, name, x, n=6, d=3, k_off=3, k_on=2, codec=None):
    """The same configuration compiled by both packages."""
    st_t, st_j = tst.get_stencil(name), jst.get_stencil(name)
    if engine == "box_tb":
        args = (x.shape, n, (2, 2), k_off)
        return (too.compile_box_plan(st_t, *args, k_on=k_on, codec=codec),
                joo.compile_box_plan(st_j, *args, k_on=k_on, codec=codec))
    args = (x.shape[0], x.shape[1], n, 1 if engine == "incore" else d,
            k_off, k_on)
    return (too.compile_plan(engine, st_t, *args, codec=codec),
            joo.compile_plan(engine, st_j, *args, codec=codec))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["box2d2r", "gradient2d"])
def test_executors_match_jax(engine, name):
    x = _domain(tst.get_stencil(name).radius, 36, 28)
    tplan, jplan = _plans(engine, name, x)
    for tcls, jcls in ((tex.EagerExecutor, jex.EagerExecutor),
                       (tex.DoubleBufferedExecutor,
                        jex.DoubleBufferedExecutor)):
        jexe, texe = jcls(), tcls(device="cpu")
        ref, jstats = jexe.execute(jplan, x)
        got, tstats = texe.execute(tplan, x)
        assert _rel_err(got, ref) <= TOL, tcls.name
        assert tstats == tplan.stats()
        je, te = jexe.exec_stats, texe.exec_stats
        for f in ("stage_count", "shape_buckets", "kernel_compiles",
                  "kernel_cache_hits", "kernel_calls", "op_counts"):
            assert getattr(te, f) == getattr(je, f), (tcls.name, f)
        assert te.executor == je.executor
    # a second run through the same executor is all cache hits
    texe.execute(tplan, x)
    assert texe.exec_stats.kernel_compiles == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_eager_pipelined_and_legacy_bitwise_equal(engine):
    x = _domain(2, 48, 40)
    plan, _ = _plans(engine, "box2d2r", x, n=8, d=4, k_off=4)
    base, _ = tex.EagerExecutor(device="cpu").execute(plan, x)
    for cls in (tex.EagerExecutor, tex.DoubleBufferedExecutor):
        lowered, s1 = cls(device="cpu").execute(plan, x)
        legacy, s2 = cls(lowered=False, device="cpu").execute(plan, x)
        np.testing.assert_array_equal(lowered, base)
        np.testing.assert_array_equal(legacy, base)
        assert s1 == s2


def test_so2dr_compiles_at_most_one_kernel_per_shape_bucket():
    """The d=8, 4-round SO2DR plan: at most one signature per bucket, and
    the same counters as the JAX package, bucketed or not."""
    x = _domain(1, 96, 48)
    tplan, jplan = _plans("so2dr", "box2d1r", x, n=16, d=8, k_off=4, k_on=2)
    te = tex.EagerExecutor(device="cpu")
    out, _ = te.execute(tplan, x)
    je = jex.EagerExecutor()
    je.execute(jplan, x)
    es = te.exec_stats
    assert es.stage_count == 8 * 4 == je.exec_stats.stage_count
    assert es.kernel_calls == 8 * 4 * 2
    assert es.kernel_compiles <= 3
    assert es.kernel_compiles == je.exec_stats.kernel_compiles
    assert es.shape_buckets == je.exec_stats.shape_buckets
    ten = tex.EagerExecutor(policy=DispatchPolicy(bucket=False), device="cpu")
    out_nb, _ = ten.execute(tplan, x)
    jen = jex.EagerExecutor(policy=JaxPolicy(bucket=False))
    jen.execute(jplan, x)
    assert ten.exec_stats.kernel_compiles == jen.exec_stats.kernel_compiles
    assert ten.exec_stats.shape_buckets == jen.exec_stats.shape_buckets
    np.testing.assert_array_equal(out, out_nb)     # padding is invisible


def test_slice_end_to_end_so2dr_gradient_vs_jax_oracle():
    """The slice's main path at a small size: SO2DR on gradient2d through
    both port executors, against the JAX oracle.

    Amplitude 10: where gradient2d's gradients fall below sqrt(eps) its
    update is an explicit diffusion step of 0.1/sqrt(1e-3) ~ 3.2, past the
    stable 0.25, so unit-scale noise amplifies the one-ulp differences
    between XLA's and PyTorch's CPU arithmetic (this comparison read
    1.4e-5 at unit scale); larger gradients keep it about the port."""
    x = (10 * RNG.standard_normal((130, 96))).astype(np.float32)
    st = tst.get_stencil("gradient2d")
    plan = too.compile_plan("so2dr", st, 130, 96, 16, 4, 8, 4)
    ref = np.asarray(jax_run_reference(jnp.asarray(x),
                                       jst.get_stencil("gradient2d"), 16))
    outs = []
    for cls in (tex.EagerExecutor, tex.DoubleBufferedExecutor):
        exe = cls(device="cpu")
        out, stats = exe.execute(plan, x)
        assert _rel_err(out, ref) <= TOL
        assert exe.exec_stats.kernel_impl == "reference"
        assert exe.exec_stats.kernel_calls == stats.kernel_calls == 4 * 2 * 2
        outs.append(out)
    np.testing.assert_array_equal(*outs)
    out, _ = too.SO2DR(4, 8, 4).run(x, st, 16, device="cpu")
    np.testing.assert_array_equal(out, outs[0])


@pytest.mark.parametrize("engine", ["naive_tb", "so2dr"])
def test_codec_plans(engine):
    x = _domain(1, 36, 28)
    tz, jz = _plans(engine, "box2d1r", x, codec="zrle")
    plain, _ = _plans(engine, "box2d1r", x)
    base, _ = tex.EagerExecutor(device="cpu").execute(plain, x)
    for cls in (tex.EagerExecutor, tex.DoubleBufferedExecutor):
        for lowered in (True, False):
            out, _ = cls(lowered=lowered, device="cpu").execute(tz, x)
            np.testing.assert_array_equal(out, base)     # lossless
    ref, _ = jex.EagerExecutor().execute(jz, x)
    assert _rel_err(base, ref) <= TOL
    tb, _ = _plans(engine, "box2d1r", x, codec="bf16")
    lossy, _ = tex.DoubleBufferedExecutor(device="cpu").execute(tb, x)
    # the codec's 2**-8 per-element bound per round trip; two rounds give
    # four round trips (H2D and D2H each), the kernels in between average
    assert _rel_err(lossy, base) <= 4 * 2.0 ** -8


def test_shared_rows_survive_the_producers_kernels():
    """BufferWrite keeps a view of the producing register; the register's
    kernels that follow must leave the shared rows untouched (no op
    writes a register in place)."""
    x = _domain(1, 60, 30)
    plan = too.compile_plan("so2dr", tst.get_stencil("box2d1r"), *x.shape,
                            8, 3, 8, 4)
    compiled = lower(plan, device="cpu")
    rt = compiled.runtime(x)
    snapshots = {}
    stage = compiled.stages[0]
    assert any(type(op).__name__ == "BufferWrite" for op in plan.ops[:6])
    for tag, fn, _, _ in stage.ops:
        fn(rt)
        for b, view in enumerate(rt.bufs):
            if view is not None and b not in snapshots:
                snapshots[b] = view.clone()
    assert snapshots
    for b, snap in snapshots.items():
        assert torch.equal(rt.bufs[b], snap)
    # and the shared rows are the pre-kernel rows of the host domain
    bw = next(op for op in plan.ops if isinstance(op, BufferWrite))
    rows = slice(bw.reg_box.lo[0], bw.reg_box.hi[0])
    np.testing.assert_array_equal(snapshots[0].numpy(), x[rows])


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    x = _domain(1, 20, 20)
    st = tst.get_stencil("box2d1r")
    plan = too.compile_plan("so2dr", st, *x.shape, 2, 2, 2, 2)
    for make in (tex.EagerExecutor, tex.DoubleBufferedExecutor,
                 lambda: tex.get_executor("eager"),
                 lambda: lower(plan),
                 lambda: too.SO2DR(2, 2, 2).run(x, st, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.EagerExecutor(device="cuda")


def test_fault_hooks_not_ported_yet_and_executor_registry():
    """(The name predates the port of the fault hooks.)  The legacy
    op-at-a-time path rejects the hooks as the JAX package does; the
    lowered path takes a no-op injector and leaves the output unchanged."""
    from repro_torch.core.faults import FaultPlan, RetryPolicy

    x = _domain(1, 20, 20)
    plan = too.compile_plan("so2dr", tst.get_stencil("box2d1r"), *x.shape,
                            2, 2, 2, 2)
    exe = tex.get_executor("double_buffered", device="cpu")
    assert isinstance(exe, tex.DoubleBufferedExecutor)
    ref, _ = exe.execute(plan, x)
    legacy = tex.DoubleBufferedExecutor(lowered=False, device="cpu")
    for kw in ({"injector": FaultPlan([]).injector()},
               {"retry": RetryPolicy()}, {"on_commit": print}):
        with pytest.raises(ValueError, match="lowered"):
            legacy.execute(plan, x, **kw)
    out, _ = exe.execute(plan, x, injector=FaultPlan([]).injector(),
                         retry=RetryPolicy(sleep=lambda s: None))
    np.testing.assert_array_equal(out, ref)
    assert exe.exec_stats.faults_injected == exe.exec_stats.retries == 0
    assert tex.get_executor("dry_run").execute(plan)[1] == plan.stats()
    with pytest.raises(ValueError):
        tex.get_executor("dry_run", policy=DispatchPolicy())
    assert type(tex.get_executor("shard_map", device="cpu")) \
        is tex.ShardMapExecutor
    with pytest.raises(ValueError, match="fused_step/policy"):
        tex.get_executor("shard_map", fused_step=lambda *a: None)
    with pytest.raises(KeyError):
        tex.get_executor("no_such_executor")


def test_bucket_registry_lets_a_smaller_plan_reuse_signatures():
    """A plan whose bands fit buckets another plan registered presents no
    new kernel signature, and the padding stays invisible."""
    st = tst.get_stencil("box2d1r")
    registry, cache = BucketRegistry(), KernelCache()
    big, small = _domain(1, 60, 30), _domain(1, 52, 30)
    for x in (big, small):
        plan = too.compile_plan("so2dr", st, *x.shape, 8, 3, 4, 2)
        compiled = lower(plan, kernel_cache=cache, bucket_registry=registry,
                         device="cpu")
        out, _, es = compiled.execute(x)
    assert es.kernel_compiles == 0 and es.kernel_cache_hits == es.kernel_calls
    alone, _ = tex.EagerExecutor(device="cpu").execute(plan, small)
    np.testing.assert_array_equal(out, alone)


def test_slot_pool_leases_are_reused_and_balanced():
    x = _domain(1, 40, 20)
    plan = too.compile_plan("so2dr", tst.get_stencil("box2d1r"), *x.shape,
                            4, 2, 2, 2)
    pool = SlotPool()
    exe = tex.EagerExecutor(device="cpu", slot_pool=pool)
    a, _ = exe.execute(plan, x)
    b, _ = exe.execute(plan, x)
    np.testing.assert_array_equal(a, b)
    assert pool.stats()["reuses"] == 1
    pool.assert_balanced()
