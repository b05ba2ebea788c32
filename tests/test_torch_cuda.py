"""The port's CUDA kernels and executors on the card (``cuda`` marker).

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

In fp32 the fused kernels (``cuda``, ``cuda_db``) compute the plain
version's operations in its order without FMA contraction, so the
comparison is bitwise; bf16 accumulates in fp32 and rounds once per step
(3e-2 relative, the reference's bf16 tolerance in tests/test_kernels.py).
The banded tensor-core kernel (``mxu``) sums in the tensor cores' order,
so it is held to the JAX test's 2e-5 (tests/test_kernels.py:80) in fp32
and 3e-2 in bf16, and to 1e-5 relative end to end against the oracle.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.executor import DoubleBufferedExecutor, EagerExecutor
from repro_torch.core.oocore import compile_plan
from repro_torch.core.reference import run_reference
from repro_torch.core.stencil import get_stencil
from repro_torch.kernels import CUDA_TILE
from repro_torch.kernels._build import call_band_kernel
from repro_torch.kernels.dispatch import DispatchPolicy
from repro_torch.kernels.stencil_multistep import (
    band_launch_shape, band_smem_bytes, band_uses_tma, fused_stencil_band,
    fused_stencil_band_plain)
from repro_torch.kernels.stencil_banded_mxu import (
    banded_fused_stencil, banded_fused_stencil_plain, banded_launch_shape,
    banded_smem_bytes)
from repro_torch.kernels.stencil_multistep_db import (
    db_launch_shape, db_smem_bytes, fused_stencil_band_db)

RNG = np.random.default_rng(17)
KERNELS = {"cuda": fused_stencil_band, "cuda_db": fused_stencil_band_db,
           "mxu": banded_fused_stencil}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-6))


@pytest.mark.parametrize("impl", ["cuda", "cuda_db"])
@pytest.mark.parametrize("name", ["box2d1r", "box2d4r", "star2d3r",
                                  "gradient2d"])
def test_kernel_matches_plain(dev, impl, name):
    kernel = KERNELS[impl]
    for H, X, steps, kt, kb in [(48, 160, 4, True, False),
                                (37, 131, 2, False, True),
                                (41, 97, 1, False, False),
                                (20, 40, 2, True, True)]:
        x = torch.from_numpy(RNG.standard_normal((H, X)).astype(
            np.float32)).to(dev)
        ref = fused_stencil_band_plain(x, name, steps, kt, kb)
        got = kernel(x, name, steps, kt, kb)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (name, H, X, steps, kt, kb)
        xb = x.to(torch.bfloat16)
        got = kernel(xb, name, steps, kt, kb)
        ref = fused_stencil_band_plain(xb, name, steps, kt, kb)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert _rel_err(got, ref) <= 3e-2


@pytest.mark.parametrize("name", ["box2d1r", "box2d2r", "box2d4r",
                                  "star2d3r"])
def test_banded_kernel_matches_plain(dev, name):
    for H, X, steps, kt, kb in [(48, 160, 4, True, False),
                                (37, 131, 2, False, True),
                                (41, 97, 1, False, False),
                                (48, 160, 2, True, True),
                                (300, 700, 4, False, False)]:
        x = torch.from_numpy(RNG.standard_normal((H, X)).astype(
            np.float32)).to(dev)
        ref = banded_fused_stencil_plain(x, name, steps, kt, kb)
        got = banded_fused_stencil(x, name, steps, kt, kb)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 2e-5, (name, H, X, steps)
        # deterministic: the same band gives the same bits
        assert torch.equal(banded_fused_stencil(x, name, steps, kt, kb), got)
        xb = x.to(torch.bfloat16)
        got = banded_fused_stencil(xb, name, steps, kt, kb)
        ref = banded_fused_stencil_plain(xb, name, steps, kt, kb)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert _rel_err(got, ref) <= 3e-2


@pytest.mark.parametrize("name", ["box2d1r", "box2d2r", "box2d3r",
                                  "box2d4r", "star2d1r", "star2d4r",
                                  "gradient2d"])
def test_redesigned_kernels_over_radii_depths_and_grids(dev, name):
    """B1 (``cuda``) and B2 (``cuda_db``) bitwise equal to their plain
    version in fp32 and B3 (``mxu``, linear stencils) within 2e-5, each
    with the same bits in two launches, at r = 1..4 and m in {1, 2, 4, 8},
    on ragged bands (one or two tiles: fewer than the persistent grid's
    CTAs), on a band whose tile count is not a multiple of the grid, and on
    one whose row pitch is a multiple of 16 bytes, with the keep flags.  B1
    launches one CTA per tile and loads by TMA exactly where
    ``band_uses_tma`` says (the last band), by ``cp.async`` on the others.
    bf16 up to m = 4 (the plain version rounds every operation to bf16,
    the kernels once per step, and gradient2d spreads that difference past
    the 3e-2 bound over 8 steps)."""
    st = get_stencil(name)
    for steps in (1, 2, 4, 8):
        mr = steps * st.radius
        for (H, X), kt, kb in [((37, 131), False, True),
                               ((41, 97), True, False),
                               ((41, 97), True, True),
                               ((2 * mr + 32 * 25, 128 * 10 + 5), False,
                                False),
                               ((2 * mr + 64 * 6 + 7, 120 * 5 + 8), True,
                                False)]:
            if H - 2 * mr + (kt + kb) * mr <= 0 or X <= 2 * mr:
                continue
            x = torch.from_numpy(RNG.standard_normal((H, X)).astype(
                np.float32)).to(dev)
            ref = fused_stencil_band_plain(x, name, steps, kt, kb)
            got = fused_stencil_band_db(x, name, steps, kt, kb)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (name, H, X, steps, kt, kb)
            shape = db_launch_shape(x, name, steps, kt, kb)
            assert shape["grid"] >= 1 and shape["ctas_per_sm"] >= 1
            got = fused_stencil_band(x, name, steps, kt, kb)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), ("cuda", name, H, X, steps, kt, kb)
            assert torch.equal(fused_stencil_band(x, name, steps, kt, kb),
                               got)
            shape = band_launch_shape(x, name, steps, kt, kb)
            ty, tx = shape["tile"]
            h_out = ref.shape[0]
            assert shape["grid"] == -(-h_out // ty) * -(-X // tx)
            assert shape["smem_bytes"] == band_smem_bytes(
                ty, tx, steps, st.radius, 4)
            tma = band_uses_tma(X, 4, x.data_ptr(),
                                (ty + 2 * mr, tx + 2 * mr))
            assert shape["load"] == ("tma" if tma else "cp.async")
            assert tma == (X % 4 == 0 and ty + 2 * mr <= 256
                           and tx + 2 * mr + 3 <= 256), (X, ty, tx, mr)
            if st.is_linear:
                ref = banded_fused_stencil_plain(x, name, steps, kt, kb)
                got = banded_fused_stencil(x, name, steps, kt, kb)
                torch.cuda.synchronize()
                assert float((got - ref).abs().max()) <= 2e-5, (
                    name, H, X, steps, kt, kb)
                assert torch.equal(banded_fused_stencil(x, name, steps, kt,
                                                        kb), got)
            if steps > 4:
                continue
            xb = x.to(torch.bfloat16)
            for fn, plain in ((fused_stencil_band,
                               fused_stencil_band_plain),
                              (fused_stencil_band_db,
                               fused_stencil_band_plain),
                              (banded_fused_stencil,
                               banded_fused_stencil_plain)):
                if fn is banded_fused_stencil and not st.is_linear:
                    continue
                got = fn(xb, name, steps, kt, kb)
                ref = plain(xb, name, steps, kt, kb)
                torch.cuda.synchronize()
                assert got.dtype == torch.bfloat16
                assert _rel_err(got, ref) <= 3e-2, (fn.__name__, name, steps)


def test_persistent_grid_against_the_tile_count(dev):
    """The persistent kernel's grid is the occupancy API's CTAs per SM
    times the SM count, cut to the tile count: a one-tile band gets one
    CTA, and a band of 1000 gradient2d tiles (not a multiple of the grid)
    is walked in whole and stays bitwise equal."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small = torch.zeros((40, 100), device=dev)
    shape = db_launch_shape(small, "gradient2d", 4, tile=CUDA_TILE)
    assert shape["grid"] == 1 and shape["tile"] == [32, 100]
    assert shape["smem_bytes"] == db_smem_bytes(32, 100, 4, 1, 4)
    x = torch.from_numpy(RNG.standard_normal((808, 5120)).astype(
        np.float32)).to(dev)
    shape = db_launch_shape(x, "gradient2d", 4, tile=CUDA_TILE)
    assert shape["grid"] == min(1000, shape["ctas_per_sm"] * sms)
    assert 1000 % shape["grid"] != 0
    got = fused_stencil_band_db(x, "gradient2d", 4, tile=CUDA_TILE)
    assert torch.equal(got, fused_stencil_band_plain(x, "gradient2d", 4))
    # the banded kernel is persistent too, its shared memory as mirrored
    shape = banded_launch_shape(x, "box2d4r", 4)
    assert shape["smem_bytes"] == banded_smem_bytes(64, 128, 4, 4)
    tiles = -(-(808 - 32) // 64) * 40
    assert shape["grid"] == min(tiles, shape["ctas_per_sm"] * sms)
    got = banded_fused_stencil(x, "box2d4r", 4)
    ref = banded_fused_stencil_plain(x, "box2d4r", 4)
    assert float((got - ref).abs().max()) <= 2e-5


def test_kernels_reject_what_they_do_not_take(dev):
    band = torch.zeros((16, 64), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        call_band_kernel("repro_fused_stencil_band", band, "box2d1r", 1,
                         False, False, CUDA_TILE, 2)
    strided = torch.zeros((16, 128), device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_stencil_band_db(strided, "box2d1r", 1)
    with pytest.raises(ValueError, match="2-D"):
        fused_stencil_band(torch.zeros((4, 16, 64), device=dev), "box2d1r", 1)
    with pytest.raises(ValueError, match="linear"):
        banded_fused_stencil(torch.zeros((16, 64), device=dev), "gradient2d",
                             1)


@pytest.mark.parametrize("impl,name", [("cuda_db", "gradient2d"),
                                       ("cuda", "box2d1r")])
def test_so2dr_on_the_card_matches_the_oracle_bitwise(dev, impl, name):
    x = RNG.standard_normal((130, 96)).astype(np.float32)
    st = get_stencil(name)
    plan = compile_plan("so2dr", st, 130, 96, 16, 4, 8, 4)
    policy = DispatchPolicy() if impl == "cuda_db" else DispatchPolicy(
        impl=impl)
    ref = run_reference(torch.from_numpy(x).to(dev), st, 16).cpu().numpy()
    outs = []
    for cls in (DoubleBufferedExecutor, EagerExecutor):
        KERNELS[impl].launches = 0
        exe = cls(policy=policy)
        out, stats = exe.execute(plan, x)
        assert exe.exec_stats.kernel_impl == impl
        assert KERNELS[impl].launches == stats.kernel_calls > 0
        np.testing.assert_array_equal(out, ref)
        outs.append(out)
    np.testing.assert_array_equal(*outs)


def test_so2dr_through_the_banded_kernel_matches_the_oracle(dev):
    """SO2DR box2d4r through ``mxu`` only: eager == double-buffered
    bitwise, both within 1e-5 relative of the oracle on the card."""
    x = RNG.standard_normal((200, 136)).astype(np.float32)
    st = get_stencil("box2d4r")
    plan = compile_plan("so2dr", st, 200, 136, 16, 4, 8, 4)
    ref = run_reference(torch.from_numpy(x).to(dev), st, 16).cpu().numpy()
    outs = []
    for cls in (DoubleBufferedExecutor, EagerExecutor):
        for k in KERNELS.values():
            k.launches = 0
        exe = cls(policy=DispatchPolicy(impl="mxu"))
        out, stats = exe.execute(plan, x)
        assert exe.exec_stats.kernel_impl == "mxu"
        assert banded_fused_stencil.launches == stats.kernel_calls > 0
        assert sum(k.launches for k in KERNELS.values()) \
            == stats.kernel_calls
        err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
        assert err <= 1e-5, err
        outs.append(out)
    np.testing.assert_array_equal(*outs)


# ------------------------------------------- faults, recovery and the service


def _svc_job(stencil, n=16, **kw):
    from repro_torch.serve import StencilJob

    return StencilJob(shape=(520, 264), stencil=stencil, steps=n, d=4,
                      s_tb=8, k_on=4, **kw)


def _interleave(svc, jobs_and_inputs):
    """ScheduledJobs for ``run_interleaved``, each recording the host
    array of the runtime it builds (the memory it page-locks)."""
    from repro_torch.serve import ScheduledJob

    hosts, sched = {}, []
    for i, (job, x) in enumerate(jobs_and_inputs):
        compiled = svc.compile_job(job)
        make = compiled.runtime

        def runtime(*a, _make=make, _i=i, **kw):
            rt = _make(*a, **kw)
            hosts[_i] = rt.host
            return rt

        compiled.runtime = runtime
        injector = job.faults.injector() if job.faults is not None else None
        sched.append(ScheduledJob(job_id=i, compiled=compiled, x=x,
                                  predicted_s=0.0, injector=injector))
    return sched, hosts


def test_two_jobs_interleaved_on_the_card_equal_their_solo_runs(dev):
    """Each job copies on its own stream under the other's kernels; the
    outputs are bitwise the solo double-buffered ``cuda_db`` runs."""
    from repro_torch.core.lower import host_register, host_unregister
    from repro_torch.serve import StencilService
    from repro_torch.serve.scheduler import run_interleaved

    svc = StencilService(policy=DispatchPolicy())
    pairs = [(_svc_job("gradient2d"),
              RNG.standard_normal((520, 264)).astype(np.float32)),
             (_svc_job("box2d1r", n=24),
              RNG.standard_normal((520, 264)).astype(np.float32))]
    solo = [svc.run_solo(job, x) for job, x in pairs]
    sched, hosts = _interleave(svc, pairs)
    fused_stencil_band_db.launches = 0
    out = run_interleaved(sched, slot_pool=svc.slot_pool,
                          domain_pool=svc.domain_pool)
    assert fused_stencil_band_db.launches == sum(
        s.kernel_calls for _, _, s, _, _ in out) > 0
    for (job, host, stats, _, fault), ref in zip(out, solo):
        assert fault is None and stats.kernel_impl == "cuda_db"
        np.testing.assert_array_equal(host, ref.out)
    svc.slot_pool.assert_balanced()
    assert svc.domain_pool.stats()["in_use"] == 0
    svc.domain_pool.close()
    for host in hosts.values():          # unregistered when the pool closes
        host_register(host)
        host_unregister(host)


def test_a_job_isolated_mid_flush_unregisters_its_memory(dev):
    from repro_torch.core.faults import KERNEL_FAULT, FaultPlan, FaultTrigger
    from repro_torch.core.lower import host_register, host_unregister
    from repro_torch.serve import StencilService
    from repro_torch.serve.scheduler import run_interleaved

    svc = StencilService(policy=DispatchPolicy())
    x = RNG.standard_normal((520, 264)).astype(np.float32)
    poison = FaultPlan([FaultTrigger(round=1, chunk=1, op_class="FusedKernel",
                                     kind=KERNEL_FAULT)])
    pairs = [(_svc_job("box2d1r"), x),
             (_svc_job("box2d1r", faults=poison), x),
             (_svc_job("gradient2d"), x)]
    sched, hosts = _interleave(svc, pairs)
    out = run_interleaved(sched, slot_pool=svc.slot_pool,
                          domain_pool=svc.domain_pool)
    (_, h0, _, _, f0), (_, h1, s1, _, f1), (_, h2, _, _, f2) = out
    assert f0 is None and f2 is None and h1 is None
    assert f1.last_committed_round == 0 and f1.fault.round == 1
    assert 0 < s1.kernel_calls
    svc.slot_pool.assert_balanced()
    np.testing.assert_array_equal(h0, svc.run_solo(pairs[0][0], x).out)
    np.testing.assert_array_equal(h2, svc.run_solo(pairs[2][0], x).out)
    assert svc.domain_pool.stats()["in_use"] == 0   # the isolated job's too
    svc.domain_pool.close()
    host_register(hosts[1])              # the isolated job's domain
    host_unregister(hosts[1])


def test_three_pipelined_solves_page_lock_one_domain_once(dev):
    """The executor's pool page-locks one domain, in the first solve only;
    every answer is bitwise the non-pipelined run's, and the first is
    unchanged after the third solve."""
    plan = compile_plan("so2dr", get_stencil("gradient2d"), 520, 264, 24, 4,
                        8, 4)
    x = RNG.standard_normal((520, 264)).astype(np.float32)
    ref, _ = EagerExecutor().execute(plan, x)
    ex = DoubleBufferedExecutor()
    answers = []
    for i in range(3):
        out, _ = ex.execute(plan, x)
        answers.append(out)
        if i == 0:
            kept = out.copy()
        assert ex.exec_stats.domain_reused == int(i > 0)
        pool = ex.domain_pool.stats()
        assert (pool["leases"], pool["reuses"], pool["in_use"],
                pool["idle"], pool["pinned_bytes"]) == (i + 1, i, 0, 1,
                                                        x.nbytes)
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(answers[0], kept)
    assert not np.shares_memory(answers[0], answers[2])


def test_service_jobs_reuse_their_page_locked_domains(dev):
    """Two jobs of one geometry lease two domains in the first flush and
    reuse both in the second; the answers are bitwise their solo runs."""
    from repro_torch.serve import StencilService

    svc = StencilService(policy=DispatchPolicy())
    job = _svc_job("gradient2d")
    xs = [RNG.standard_normal((520, 264)).astype(np.float32)
          for _ in range(2)]
    for flush in range(2):
        for x in xs:
            svc.submit(job, x)
        results = sorted(svc.flush(), key=lambda r: r.job_id)
        assert [r.exec_stats.domain_reused for r in results] == [flush] * 2
        assert not np.shares_memory(results[0].out, results[1].out)
        for r, x in zip(results, xs):
            np.testing.assert_array_equal(r.out, svc.run_solo(job, x).out)
    pool = svc.service_stats()["domain_pool"]
    assert (pool["in_use"], pool["peak_in_use"], pool["idle"]) == (0, 2, 2)
    assert pool["pinned_bytes"] == 2 * xs[0].nbytes
    svc.slot_pool.assert_balanced()


@pytest.mark.parametrize("impl", ["cuda_db", "mxu"])
def test_on_commit_sees_the_committed_rows_and_resume_is_bitwise(dev, impl,
                                                                 tmp_path):
    """The hook fires after the round's copies landed: the snapshot of
    round r equals the eager run of the plan cut after round r; a crash
    in the last round resumes bitwise from the checkpoint."""
    import dataclasses

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.faults import KERNEL_FAULT, FaultPlan, FaultTrigger
    from repro_torch.core.recovery import PlanCheckpointer, run_with_recovery

    name = "gradient2d" if impl == "cuda_db" else "box2d4r"
    x = RNG.standard_normal((520, 264)).astype(np.float32)
    plan = compile_plan("so2dr", get_stencil(name), 520, 264, 24, 4, 8, 4)
    policy = DispatchPolicy() if impl == "cuda_db" else DispatchPolicy(
        impl=impl)
    snaps = {}
    exe = DoubleBufferedExecutor(policy=policy)
    out, _ = exe.execute(plan, x, on_commit=lambda r, h: snaps.__setitem__(
        r, h.copy()))
    assert exe.exec_stats.kernel_impl == impl
    assert sorted(snaps) == [0, 1, 2]
    np.testing.assert_array_equal(snaps[2], out)
    for rnd in (0, 1):
        cut = dataclasses.replace(plan, ops=tuple(
            op for op in plan.ops if op.round <= rnd))
        ref, _ = EagerExecutor(policy=policy).execute(cut, x)
        np.testing.assert_array_equal(snaps[rnd], ref)
    faults = FaultPlan([FaultTrigger(round=2, chunk=None, op_class="*",
                                     kind=KERNEL_FAULT)])
    exe = DoubleBufferedExecutor(policy=policy)
    host, _ = run_with_recovery(
        plan, x, executor=exe, faults=faults,
        checkpoint=PlanCheckpointer(CheckpointManager(str(tmp_path)), plan))
    assert exe.exec_stats.resumes == 1
    np.testing.assert_array_equal(host, out)


@pytest.mark.parametrize("name,mesh", [("box2d1r", (4, 2)),
                                       ("gradient2d", (3, 3))])
def test_sharded_simulator_on_the_card_equals_the_cpu(dev, name, mesh):
    """The lockstep simulator on the card: within 1e-5 of its CPU run and
    of the oracle, the same counters, and none of the three kernels
    launched (the masked update is plain PyTorch)."""
    from repro_torch.core.executor import ShardedSimExecutor
    from repro_torch.core.shard import compile_sharded

    x = RNG.standard_normal((96, 96)).astype(np.float32)
    plan = compile_sharded(name, 96, 96, 8, 4, mesh)
    for k in KERNELS.values():
        k.launches = 0
    ex = ShardedSimExecutor(device=dev)
    got, stats = ex.execute(plan, x)
    want, _ = ShardedSimExecutor(device="cpu").execute(plan, x)
    assert all(k.launches == 0 for k in KERNELS.values())
    assert np.abs(got - want).max() < 1e-5
    ref = run_reference(torch.from_numpy(x).to(dev), get_stencil(name), 8)
    assert _rel_err(torch.from_numpy(got), ref.cpu()) < 1e-5
    assert stats == plan.stats()
    es = ex.exec_stats
    assert (es.shape_buckets, es.kernel_compiles, es.kernel_calls) \
        == (1, 1, plan.n_ranks * plan.rounds)


@pytest.mark.parametrize("codec", [None, "zrle"])
def test_run_sharded_hierarchical_on_the_card_equals_the_cpu(dev, codec):
    """A hierarchical plan through the service on the card: bitwise equal
    to its flat plan on the card, within 1e-5 of the CPU run, the pool
    balanced."""
    from repro_torch.core.executor import ShardedSimExecutor
    from repro_torch.core.hierarchy import compile_hierarchical
    from repro_torch.core.shard import compile_sharded
    from repro_torch.serve import StencilService

    x = RNG.standard_normal((64, 64)).astype(np.float32)
    plan = compile_hierarchical("box2d1r", 64, 64, 8, 2, (2, 2),
                                inner_d=3, codec=codec)
    svc = StencilService(device=dev)
    res = svc.run_sharded(plan, x)
    assert res.status == "ok" and res.exec_stats.kernel_impl \
        == "shard_sim+hier"
    svc.slot_pool.assert_balanced()
    flat, _ = ShardedSimExecutor(device=dev).execute(
        compile_sharded("box2d1r", 64, 64, 8, 2, (2, 2)), x)
    np.testing.assert_array_equal(res.out, flat)
    cpu = StencilService(device="cpu").run_sharded(plan, x)
    assert np.abs(res.out - cpu.out).max() < 1e-5


# ------------------------------------------ the multi-process backend


def _rank_processes():
    import multiprocessing

    return [p for p in multiprocessing.active_children()
            if p.name.startswith("repro_torch-rank")]


@pytest.mark.parametrize("name,mesh,transport", [
    ("box2d1r", (1, 1), "nccl"),
    ("gradient2d", (2, 2), "gloo+host-staging")])
def test_shard_map_on_the_card_equals_the_simulator(dev, name, mesh,
                                                    transport):
    """Rank processes on the card: NCCL at world size 1 (the only NCCL
    shape one card allows) and four ranks sharing the card over gloo
    with host-staged halos, both bitwise equal to the simulator on the
    card, none of the three kernels launched, no rank left alive."""
    from repro_torch.core.executor import ShardMapExecutor, \
        ShardedSimExecutor
    from repro_torch.core.shard import compile_sharded

    x = RNG.standard_normal((96, 96)).astype(np.float32)
    plan = compile_sharded(name, 96, 96, 8, 4, mesh)
    for k in KERNELS.values():
        k.launches = 0
    with ShardMapExecutor(device=dev, timeout=120) as ex:
        got, stats = ex.execute(plan, x)
        again, _ = ex.execute(plan, x)          # the group is reused
    assert ex.transport == transport
    assert all(k.launches == 0 for k in KERNELS.values())
    want, _ = ShardedSimExecutor(device=dev).execute(plan, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
    assert stats == plan.stats()
    assert ex.exec_stats.kernel_calls == plan.n_ranks * plan.rounds
    assert all(r["update_ms"] > 0 for r in ex.rank_stats)
    assert not _rank_processes()


def test_shard_map_runs_a_hierarchical_plan_on_its_outer_geometry(dev):
    """A hierarchical plan through the multi-process backend on the card:
    each rank holds its full band, so the result is bitwise equal to the
    simulator's hierarchical run and to the flat plan, with the plan's
    two-level stats."""
    from repro_torch.core.executor import ShardMapExecutor, \
        ShardedSimExecutor
    from repro_torch.core.hierarchy import compile_hierarchical

    x = RNG.standard_normal((64, 64)).astype(np.float32)
    plan = compile_hierarchical("box2d1r", 64, 64, 8, 2, (2, 2), inner_d=3,
                                codec="zrle")
    with ShardMapExecutor(device=dev, timeout=120) as ex:
        got, stats = ex.execute(plan, x)
    want, _ = ShardedSimExecutor(device=dev).execute(plan, x)
    np.testing.assert_array_equal(got, want)
    assert stats == plan.stats()
    assert not _rank_processes()


def test_a_rank_that_raises_on_the_card_fails_the_call_in_time(dev):
    """One rank raises while its peers wait on its halo: the parent
    raises with the rank's traceback well inside the deadline and no
    rank process is left."""
    import time

    from repro_torch.core.distributed import run_distributed
    from repro_torch.core.ranks import RankFailure, RankMesh

    x = RNG.standard_normal((64, 64)).astype(np.float32)
    mesh = RankMesh((2, 2), device=dev, timeout=120)
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="fault drill: rank 2"):
        mesh.run(x, "box2d1r", 2, 2, "data", "model", fail_rank=2)
    assert time.monotonic() - t0 < 60
    assert mesh.closed and not _rank_processes()
    with pytest.raises(RuntimeError, match="closed"):
        run_distributed(x, "box2d1r", 4, 2, mesh)


_LM_ARCHS = ("minitron-4b", "phi3-medium-14b", "h2o-danube-1.8b",
             "qwen3-0.6b", "llama-3.2-vision-90b", "zamba2-2.7b",
             "llama4-maverick-400b-a17b", "mixtral-8x7b", "whisper-tiny",
             "mamba2-130m")


def _lm_batch(cfg, B=2, S=32, device="cpu"):
    rng = np.random.default_rng(sum(map(ord, cfg.name)))
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    for key, n, fam in (("images", cfg.n_image_tokens, "vlm"),
                        ("frames", cfg.n_frames, "encdec")):
        if cfg.family == fam:
            batch[key] = torch.from_numpy(rng.standard_normal(
                (B, n, cfg.d_model)).astype(np.float32)).bfloat16()
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_smoke_model_on_the_card_equals_the_cpu(dev, arch):
    """One set of CPU-drawn port weights: forward, prefill and a decode
    step on the card within 5e-2 (relative to the max |logit|) of the
    CPU's, prefill within 1e-3 of the card's own forward, and
    ``greedy_generate`` on the card gives tokens in range."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve import greedy_generate

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    dev_p = tree_map(lambda t: t.to(dev), cpu_p)
    B, S = 2, 32
    cpu_b = _lm_batch(cfg, B, S)
    dev_b = {k: v.to(dev) for k, v in cpu_b.items()}
    out = {}
    for name, p, b, d in (("cpu", cpu_p, cpu_b, "cpu"),
                          ("card", dev_p, dev_b, dev)):
        logits, _ = model.forward(p, b)
        pre, cache = model.prefill(p, b, model.init_cache(B, S + 4, device=d))
        out[name] = (logits.cpu(), pre.cpu(), cache)
    nxt = out["cpu"][1][:, -1].argmax(-1)[:, None].int()
    dec_cpu, _ = model.decode_step(cpu_p, nxt, S, out["cpu"][2])
    dec_dev, _ = model.decode_step(dev_p, nxt.to(dev), S, out["card"][2])
    for got, ref in ((out["card"][0], out["cpu"][0]),
                     (out["card"][1], out["cpu"][1]),
                     (dec_dev.cpu(), dec_cpu)):
        assert torch.isfinite(got.float()).all()
        assert _rel_err(got, ref) < 5e-2, (arch, _rel_err(got, ref))
    e_pre = float((out["card"][1][:, 0].float()
                   - out["card"][0][:, -1].float()).abs().max())
    assert e_pre < 1e-3, (arch, e_pre)
    toks = greedy_generate(model, dev_p, dev_b, 4, S + 4)
    assert toks.shape == (B, 4) and toks.device.type == "cuda"
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())


def _train_data(cfg, B=2, S=32):
    from repro_torch.data import DataSpec, SyntheticLM
    from repro_torch.launch.train import StubData

    return StubData(SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=S,
                                         global_batch=B)), cfg)


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_smoke_model_trains_on_the_card_as_on_the_cpu(dev, arch):
    """Two Trainer steps (AdamW, remat, 2 microbatches) from one set of
    CPU-drawn weights: losses on the card within 5e-2 of the CPU's, and
    params within 5e-2 of each leaf's max |value| at init.  A leaf that
    starts at zero (mamba's ``A_log``, ``dt_bias``, ``conv_b``, the VLM's
    gates) holds only its two updates, and Adam's first two steps move
    an element by at most ``lr`` each (weight decay aside) whatever its
    grad's size, so where a near-zero grad's sign differs between the
    devices the two may differ by ``2 lr`` a step: such a leaf is held to
    ``4 lr`` (and 1 % for the decay) over the two steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    data = _train_data(cfg, B=4)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=2)
    out = {}
    for d in ("cpu", dev):
        tr = Trainer(model, opt, TrainConfig(steps=2, microbatches=2),
                     device=d)
        params = tree_map(lambda t: t.clone().to(d), cpu_p)
        st = opt.init(params)
        res = tree_map(lambda t: torch.zeros((), device=d), params)
        losses = []
        for step in range(2):
            batch = {k: torch.as_tensor(v).to(d)
                     for k, v in data.batch(step).items()}
            params, st, res, loss = tr.step(params, st, res, batch)
            losses.append(float(loss))
        assert tree_leaves(params)[0].device.type == torch.device(d).type
        out[str(d)] = (losses, [t.cpu() for t in tree_leaves(params)])
    (l_cpu, p_cpu), (l_dev, p_dev) = out["cpu"], out[str(dev)]
    assert np.isfinite(l_dev).all()
    for a, b in zip(l_dev, l_cpu):
        assert abs(a - b) <= 5e-2 * abs(b), (arch, l_dev, l_cpu)
    for a, b, p0 in zip(p_dev, p_cpu, tree_leaves(cpu_p)):
        scale = float(p0.abs().max())
        bound = 5e-2 * scale if scale > 0 else 4.04 * opt.lr
        err = float((a - b).abs().max())
        assert err <= bound, (arch, err, bound)


class _Fp32Stub:
    """An image or frame stub that the model's inline bf16 cast
    (``.to(torch.bfloat16)``) hands back in fp32."""

    def __init__(self, tensor):
        self.tensor = tensor

    def to(self, dtype):
        return self.tensor

    def __getattr__(self, name):
        return getattr(self.tensor, name)


def _leaf_err(got, ref):
    """max |got - ref| over max |ref| of one leaf (a grad)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_smoke_model_grads_on_the_card_match_the_cpu(dev, arch,
                                                         monkeypatch):
    """The loss's grads before any optimizer step, from one set of
    CPU-drawn weights.  In fp32 (the embedding's bf16 cast swapped out,
    the stubs kept in fp32) the card's within 1e-4 of the CPU's per leaf,
    relative to the leaf's max.  In bf16 within 5e-2 (the JAX package's
    bf16 tolerance), or, on a leaf where the CPU's own bf16 grad lies
    further than that from its fp32 grad, within twice that distance, as
    tests/test_torch_lm_grads.py holds the CPU against JAX."""
    import repro_torch.models.api as api
    import repro_torch.models.transformer as tr_mod
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke_config(arch)
    model = api.build_model(cfg)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = _train_data(cfg, B=4).batch(0)
    grads = {}
    for mode in ("bf16", "fp32"):
        if mode == "fp32":
            def fp32_embed(p, tokens):
                return p["embed"][tokens]

            monkeypatch.setattr(api, "_embed_tokens", fp32_embed)
            monkeypatch.setattr(tr_mod, "embed_tokens", fp32_embed)
        for d in ("cpu", dev):
            b = {k: torch.as_tensor(v).to(d) for k, v in batch.items()}
            if mode == "fp32":
                b = {k: (_Fp32Stub(v.float()) if k in ("images", "frames")
                         else v) for k, v in b.items()}
                assert model.forward(tree_map(lambda t: t.to(d), cpu_p),
                                     b)[0].dtype == torch.float32
            tr = Trainer(model, AdamW(), TrainConfig(), device=d)
            loss, g = tr.value_and_grad(
                tree_map(lambda t: t.clone().to(d), cpu_p), b)
            grads[mode, str(d)] = (float(loss), tree_leaves(g))
    card = str(dev)
    for mode, tol in (("fp32", 1e-4), ("bf16", 5e-2)):
        (l_cpu, g_cpu), (l_dev, g_dev) = grads[mode, "cpu"], grads[mode, card]
        assert abs(l_dev - l_cpu) <= tol * abs(l_cpu), (arch, mode, l_dev, l_cpu)
        assert g_dev[0].device.type == "cuda"
        worst = 0.0
        for i, (a, b) in enumerate(zip(g_dev, g_cpu)):
            bound = tol
            if mode == "bf16":
                bound = max(tol, 2 * _leaf_err(b, grads["fp32", "cpu"][1][i]))
            err = _leaf_err(a, b)
            assert err <= bound, (arch, mode, i, err, bound)
            worst = max(worst, err)
        print(arch, mode, f"grads card vs cpu, worst leaf {worst:.3e}")


_RESUME_ON_THE_CARD = r"""
import os, sys, tempfile
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataSpec, SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import AdamW
from repro_torch.train import TrainConfig, Trainer

torch.use_deterministic_algorithms(True)
cfg = get_smoke_config("qwen3-0.6b")
model = build_model(cfg)
data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=4))
opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=6,
            moment_dtype=torch.bfloat16)
tmp = tempfile.mkdtemp()

def train(ckpt_dir, steps, resume):
    tc = TrainConfig(steps=steps, ckpt_every=3, ckpt_dir=ckpt_dir,
                     log_every=100)
    return Trainer(model, opt, tc).run(
        torch.Generator(device="cuda").manual_seed(0), data, resume=resume)

p_full, s_full, l_full = train(os.path.join(tmp, "a"), 6, False)
train(os.path.join(tmp, "b"), 3, False)
p_res, s_res, l_res = train(os.path.join(tmp, "b"), 6, True)
a = tree_leaves({"p": p_full, "m": s_full.mu, "v": s_full.nu})
b = tree_leaves({"p": p_res, "m": s_res.mu, "v": s_res.nu})
assert a[0].device.type == "cuda" and s_res.mu["embed"].dtype == torch.bfloat16
assert l_res == l_full[3:], (l_full, l_res)
assert all(torch.equal(x, y) for x, y in zip(a, b))
print("resumed bitwise")

# the MoE backward (capacity dispatch's index_add_, the combine's gather)
# under deterministic algorithms: two runs give the same bits
cfg = get_smoke_config("mixtral-8x7b")
model = build_model(cfg)
data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=4))
runs = [Trainer(model, opt, TrainConfig(steps=2, microbatches=2)).run(
    torch.Generator(device="cuda").manual_seed(0), data) for _ in range(2)]
assert runs[0][2] == runs[1][2]
assert all(torch.equal(x, y) for x, y in zip(tree_leaves(runs[0][0]),
                                             tree_leaves(runs[1][0])))
print("moe deterministic")
"""


def test_lm_training_resumes_bitwise_on_the_card(dev):
    """qwen3's smoke model, bf16 moments: 6 steps against 3, a checkpoint,
    a restore and 3 more, on the card under deterministic algorithms (in
    a fresh process: cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` when CUDA
    starts); mixtral's smoke model trained twice there gives the same
    bits."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", _RESUME_ON_THE_CARD], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "resumed bitwise" in out.stdout, out.stderr[-3000:]
    assert "moe deterministic" in out.stdout, out.stderr[-3000:]


def test_train_cli_on_the_card(dev, capsys):
    from repro_torch.launch import train as train_cli

    losses = train_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                             "20"])
    out = capsys.readouterr().out
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert "first-10-mean" in out and "last-10-mean" in out
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


def test_lm_launch_on_a_one_rank_nccl_mesh_at_smoke_size(dev, tmp_path):
    """Phase lm_launch's (a)-(c) at qwen3's smoke size, in a process of its
    own (one NCCL group per process; ``CUBLAS_WORKSPACE_CONFIG`` set for
    deterministic algorithms): 3 Trainer steps on a (1, 1) DTensor mesh
    over NCCL bitwise to the plain Trainer's, the dry run's FLOPs equal
    to the real step's, and the checkpointed state resharded bitwise."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = ("import json, sys, chip_smoke; print(json.dumps("
            "chip_smoke.lm_launch_card(sys.argv[1], smoke=True), "
            "default=str))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["backend"] == "nccl" and rec["mesh"] == [1, 1]
    assert rec["losses"] == rec["plain_losses"]
    assert rec["leaves_not_bitwise"] == 0 and rec["reshard_not_bitwise"] == 0
    assert rec["flop_rel_diff"] == 0.0
    assert not os.path.exists(os.path.join(tmp_path, "lm_launch_ckpt"))
