"""The port's cost model, calibration and tuner vs the JAX package.

Given the same hardware constants and the same plans, the port's
Sec. III model (``analytic``), per-impl kernel terms (``dispatch``),
dry-run accounting, candidate filter, fits, profile schema and modeled
tuner rankings equal the JAX package's exactly, with the kernel impl
names mapped (``pallas -> cuda``, ``pallas_db -> cuda_db``, ``mxu ->
mxu``).  Calibration runs here on the CPU at quick size; its times are
the CPU's and nothing here bounds its fit residuals (a wall-clock bound
on a shared CPU fails on noise, not on the code).
"""
import dataclasses
import json

import numpy as np
import pytest

import repro_torch
from repro.core import analytic as jax_analytic
from repro.core import oocore as jax_oocore
from repro.core.accounting import predict_stats as jax_predict_stats
from repro.core.autotune import _autotune as jax_autotune
from repro.core.calibrate import (
    DeviceProfile as JaxProfile, fit_affine as jax_fit_affine,
    fit_two_term as jax_fit_two_term)
from repro.core.params import (
    CodeSpec as JaxCodeSpec, enumerate_candidates as jax_enumerate)
from repro.core.stencil import get_stencil as jax_get_stencil
from repro.kernels import dispatch as jax_dispatch
from repro_torch.core import analytic, oocore
from repro_torch.core.accounting import predict_stats
from repro_torch.core.analytic import H100_SXM, RTX3080_PAPER, TPU_V5E
from repro_torch.core.autotune import _autotune, autotune_sharded
from repro_torch.core.calibrate import (
    DeviceProfile, ProfileError, calibrate, fit_affine, fit_two_term,
    resolve_hardware)
from repro_torch.core.lower import ExecStats
from repro_torch.core.params import CodeSpec, enumerate_candidates
from repro_torch.core.stencil import PAPER_BENCHMARKS, get_stencil
from repro_torch.core.tune import TuneResult, TuneSpec, _refine, tune
from repro_torch.kernels import dispatch

from test_calibrate import synthetic_profile as jax_synthetic_profile
from test_tune import golden_geometries

ENGINES = ("incore", "naive_tb", "resreu", "so2dr")
IMPL_MAP = {"reference": "reference", "pallas": "cuda",
            "pallas_db": "cuda_db", "mxu": "mxu"}
PORT_IMPL = {v: k for k, v in IMPL_MAP.items()}


def _port_hw(jax_hw):
    return analytic.Hardware(**dataclasses.asdict(jax_hw))


def _plans(engine, name, Y=258, n=16, d=4, k_off=8, k_on=4, codec=None):
    jst, pst = jax_get_stencil(name), get_stencil(name)
    return (jax_oocore.compile_plan(engine, jst, Y, Y, n, d, k_off, k_on,
                                    codec=codec),
            oocore.compile_plan(engine, pst, Y, Y, n, d, k_off, k_on,
                                codec=codec))


def test_constants_are_the_jax_ones():
    assert dataclasses.asdict(TPU_V5E) == dataclasses.asdict(
        jax_analytic.TPU_V5E)
    assert dataclasses.asdict(RTX3080_PAPER) == dataclasses.asdict(
        jax_analytic.RTX3080_PAPER)
    assert H100_SXM.c_vmem == 232448 and H100_SXM.bw_dmem == 3.35e12
    assert H100_SXM.peak_mxu_flops == pytest.approx(1.649e14, rel=1e-3)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", PAPER_BENCHMARKS)
def test_model_times_equal_jax(engine, name):
    jplan, pplan = _plans(engine, name)
    hw = jax_analytic.TPU_V5E
    want = jax_analytic.times_from_plan(jplan, hw)
    got = analytic.times_from_plan(pplan, _port_hw(hw))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.total_overlapped(3) == want.total_overlapped(3)
    assert got.total_serial == want.total_serial
    assert analytic.model_times(pplan.stats(), _port_hw(hw)) == got


@pytest.mark.parametrize("name", ["box2d1r", "box2d4r", "gradient2d"])
@pytest.mark.parametrize("tile", [(32, 128), (16, 64)])
def test_kernel_terms_equal_jax_for_mapped_impls(name, tile):
    hw = jax_analytic.TPU_V5E
    for engine in ("so2dr", "resreu", "incore"):
        jplan, pplan = _plans(engine, name)
        for jimpl, pimpl in IMPL_MAP.items():
            want = jax_dispatch.modeled_kernel_time(jplan, hw, jimpl, tile)
            got = dispatch.modeled_kernel_time(pplan, _port_hw(hw), pimpl,
                                               tile)
            if pimpl == "mxu" and want is not None:
                # the same memory and compute terms; the port's banded
                # kernel is persistent and loads the next tile under the
                # current one's last step, so it overlaps them (max) where
                # the TPU kernel serialises them (sum)
                assert got[1:] == want[1:], (engine, tile)
                assert got[0] == max(want[1], want[2])
                continue
            assert got == want, (engine, jimpl, tile)
        for op_j, op_p in zip(jplan.ops, pplan.ops):
            if type(op_j).__name__ != "FusedKernel":
                continue
            for jimpl, pimpl in IMPL_MAP.items():
                args = (op_j.shape_in, op_j.steps, op_j.keep_lo,
                        op_j.keep_hi, 4)
                assert dispatch.kernel_op_features(
                    pimpl, get_stencil(name), *args, hw=_port_hw(hw),
                    tile=tile) == jax_dispatch.kernel_op_features(
                    jimpl, jax_get_stencil(name), *args, hw=hw, tile=tile)


def test_kernel_terms_take_profiled_rates():
    _, pplan = _plans("so2dr", "box2d4r")
    prof = synthetic_profile(kernel_terms={
        "mxu": {"bw_eff": 1e12, "flops_eff": 1e14},
        "cuda": {"bw_eff": 2e12, "flops_eff": 2e13}})
    base = dispatch.modeled_kernel_time(pplan, H100_SXM, "mxu")
    fitted = dispatch.modeled_kernel_time(pplan, H100_SXM, "mxu",
                                          profile=prof)
    assert fitted[1] == pytest.approx(base[1] * 3.35)
    assert fitted[2] == pytest.approx(base[2] * H100_SXM.peak_mxu_flops
                                      / 1e14)
    # a shared-memory budget rules out tiles whose buffers do not fit
    tiny = dataclasses.replace(H100_SXM, c_vmem=4096)
    assert dispatch.modeled_kernel_time(pplan, tiny, "cuda_db") is None
    assert dispatch.modeled_kernel_time(pplan, tiny, "reference") is not None
    assert dispatch.modeled_kernel_time(
        _plans("so2dr", "gradient2d")[1], H100_SXM, "mxu") is None


@pytest.mark.parametrize("name", PAPER_BENCHMARKS)
def test_predict_stats_and_candidates_equal_jax(name):
    for engine in ENGINES:
        for codec in (None, "zrle"):
            want = jax_predict_stats(engine, jax_get_stencil(name), 258, 258,
                                     16, 4, 8, 4, codec=codec)
            got = predict_stats(engine, get_stencil(name), 258, 258, 16, 4,
                                8, 4, codec=codec)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    r = get_stencil(name).radius
    for hw_name in ("TPU_V5E", "RTX3080_PAPER"):
        jhw = getattr(jax_analytic, hw_name)
        for sz in (12800, 38400):
            want = jax_enumerate(JaxCodeSpec(sz=sz, radius=r), jhw)
            got = enumerate_candidates(CodeSpec(sz=sz, radius=r),
                                       _port_hw(jhw))
            assert [dataclasses.astuple(c) for c in got] \
                == [dataclasses.astuple(c) for c in want]


def test_fits_equal_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        xs = rng.uniform(1e5, 1e8, size=5)
        ts = 3e-5 + xs / 7e9 + rng.normal(0, 1e-6, size=5)
        assert fit_affine(xs, ts) == jax_fit_affine(xs, ts)
        m1 = rng.uniform(1e6, 1e9, size=6)
        m2 = rng.uniform(1e6, 1e9, size=6)
        ts = m1 / 2e12 + m2 / 5e13 + rng.normal(0, 1e-6, size=6)
        assert fit_two_term(m1, m2, ts) == jax_fit_two_term(m1, m2, ts)
    # the fallbacks: a negative intercept and collinear features
    assert fit_affine([1.0, 2.0, 3.0], [0.9, 2.1, 3.3]) == jax_fit_affine(
        [1.0, 2.0, 3.0], [0.9, 2.1, 3.3])
    m = [1.0, 2.0, 3.0]
    assert fit_two_term(m, m, [2.0, 4.1, 5.9]) == jax_fit_two_term(
        m, m, [2.0, 4.1, 5.9])


def synthetic_profile(hw=RTX3080_PAPER, profile_id="rtx3080-synthetic",
                      **overrides):
    """The port's twin of ``tests/test_calibrate.py::synthetic_profile``."""
    fields = dict(
        profile_id=profile_id,
        fingerprint={"backend": "synthetic", "device_kind": hw.name},
        hardware=dataclasses.asdict(hw),
        kernel_terms={},
        codec_throughput={},
        residuals={"synthetic": 0.0},
        created_at="2026-01-01T00:00:00Z",
        base_hardware=hw.name,
    )
    fields.update(overrides)
    return DeviceProfile(**fields)


def test_profiles_round_trip_and_load_across_packages(tmp_path):
    prof = synthetic_profile(kernel_terms={"mxu": {
        "bw_eff": 1.234567890123e12, "flops_eff": 1 / 3, "residual": 0.1,
        "n_points": 12}})
    p = tmp_path / "port.json"
    prof.save(str(p))
    back = DeviceProfile.load(str(p))
    assert back == prof and back.to_json() == prof.to_json()
    assert back.as_hardware() == RTX3080_PAPER
    # the JAX package loads the port's file, and writes the same JSON
    jprof = JaxProfile.load(str(p))
    assert jprof.to_json() == prof.to_json()
    q = tmp_path / "jax.json"
    jax_synthetic_profile(profile_id="from-jax").save(str(q))
    ported = DeviceProfile.load(str(q))
    assert ported.profile_id == "from-jax"
    assert resolve_hardware(str(q)) == RTX3080_PAPER
    assert resolve_hardware(None) == H100_SXM
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(json.loads(p.read_text()),
                                   schema_version=99)))
    with pytest.raises(ProfileError, match="schema_version"):
        DeviceProfile.load(str(bad))


def _mapped(configs):
    return [dict(c, kernel_impl=IMPL_MAP[c["kernel_impl"]]) for c in configs]


def test_tune_rankings_equal_jax_on_golden_geometries(monkeypatch):
    """``tune(budget=0)`` under the synthetic paper-RTX3080 profile ranks
    like the JAX package's row sweep, config for config and time for
    time, on the golden geometries of tests/test_tune.py (at one tile both
    packages model: their default tiles differ).  The one modeled
    difference is carried into the JAX sweep: the port's banded kernel
    loads the next tile under the current one (max of the memory and
    compute terms), the TPU kernel serialises them (sum)."""
    jax_kernel_time = jax_dispatch.modeled_kernel_time

    def with_port_overlap(plan, hw, impl_name, *args, **kwargs):
        out = jax_kernel_time(plan, hw, impl_name, *args, **kwargs)
        if impl_name == "mxu" and out is not None:
            return max(out[1], out[2]), out[1], out[2]
        return out

    monkeypatch.setattr(jax_dispatch, "modeled_kernel_time",
                        with_port_overlap)
    prof = synthetic_profile()
    jst = jax_get_stencil("box2d1r")
    tile_grid = ((32, 128),)
    checked = 0
    for (Y, _X, n, d, ko, ki) in golden_geometries():
        for (Yc, nc, d_grid, s_grid) in [
                (Y, n, (d, d + 2), (ko, 2 * ko)),
                ((Y - 2) * 64 + 2, 640, (d, d + 2), (40, 80))]:
            spec = TuneSpec("box2d1r", Yc, nc, d_grid=d_grid,
                            s_tb_grid=s_grid, k_on_grid=(ki, 1),
                            codecs=("identity", "zrle", "bf16"),
                            kernel_impls=("reference", "cuda", "cuda_db",
                                          "mxu"),
                            tile_grid=tile_grid)
            got = tune(spec, profile=prof)
            want = jax_autotune(jst, Yc - 2, nc, jax_analytic.RTX3080_PAPER,
                                d_grid=d_grid, s_tb_grid=s_grid,
                                k_on_grid=(ki, 1),
                                codecs=("identity", "zrle", "bf16"),
                                kernel_impls=tuple(PORT_IMPL[i] for i in (
                                    "reference", "cuda", "cuda_db", "mxu")),
                                tile_grid=tile_grid)
            assert [r.config for r in got] == _mapped(
                [c.config for c in want])
            assert [r.modeled_s for r in got] == [c.time_s for c in want]
            assert all(r.profile_id == prof.profile_id for r in got)
            checked += len(got)
    assert checked > 0


def test_tune_box_mode_equals_jax():
    from repro.core.autotune import _autotune_box as jax_autotune_box

    spec = TuneSpec("heat3d1r", (34, 34, 34), 8, engines=("box_tb",),
                    box_tile_grid=((1, 1), (2, 2)), time_depth_grid=(1, 2),
                    k_on_grid=(1,), codecs=("identity",))
    got = tune(spec, hw=TPU_V5E)
    want = jax_autotune_box(jax_get_stencil("heat3d1r"), (34, 34, 34), 8,
                            jax_analytic.TPU_V5E, tile_grid=((1, 1), (2, 2)),
                            time_depth_grid=(1, 2))
    assert got and [r.config for r in got] == [c.config for c in want]
    assert [r.modeled_s for r in got] == [c.time_s for c in want]


def test_autotune_default_impls_are_the_ports():
    got = _autotune(get_stencil("box2d1r"), 256, 40, H100_SXM, d_grid=(4,),
                    s_tb_grid=(20,), k_on_grid=(1, 4), codecs=("identity",))
    assert {c.kernel_impl for c in got} == {"reference", "cuda", "cuda_db"}
    assert TuneSpec("box2d1r", 258, 8).kernel_impls \
        == ("reference", "cuda", "cuda_db")


def _results(n):
    return [TuneResult(mode="row", engine="so2dr",
                       config={"engine": "so2dr", "d": 4, "s_tb": 20,
                               "k_on": 1, "codec": "identity",
                               "kernel_impl": "reference", "tile": None,
                               "rank": i},
                       modeled_s=0.001 * (i + 1), bottleneck="kernel")
            for i in range(n)]


@pytest.mark.parametrize("seed", range(24))
def test_refinement_never_promotes_on_one_sided_evidence(seed):
    """A candidate outranks the modeled incumbent only when it measured
    no worse than the incumbent; an unmeasured incumbent keeps the
    modeled order."""
    rng = np.random.default_rng(seed)
    n, budget = int(rng.integers(1, 9)), int(rng.integers(1, 11))
    fail_some = bool(seed % 2)
    ranked = _results(n)
    measured_of = {}

    def measure(spec_, res):
        if fail_some and rng.random() < 0.3:
            return None
        t = float(rng.uniform(1e-4, 1e-2))
        measured_of[res.config["rank"]] = t
        return (t, t * float(rng.uniform(0.5, 2.0)), None)

    out = _refine(ranked, TuneSpec("box2d1r", 258, 40), budget, measure)
    assert {r.config["rank"] for r in out} == set(range(n))
    if 0 not in measured_of:
        assert [r.config["rank"] for r in out] == list(range(n))
        return
    for r in out:
        if r.config["rank"] == 0:
            break
        assert r.measured_s is not None and r.measured_s <= measured_of[0]
    head = [r.measured_s for r in out if r.measured_s is not None]
    assert head == sorted(head)


def test_refinement_attaches_error_and_exec_stats():
    spec = TuneSpec("box2d1r", 258, 40, d_grid=(4,), s_tb_grid=(20, 40),
                    k_on_grid=(1, 2), codecs=("identity",),
                    kernel_impls=("reference",))

    def measure(spec_, res):
        es = ExecStats(executor="test")
        es.wall_s = res.modeled_s * 2
        return (res.modeled_s * 2, res.modeled_s, es)

    out = tune(spec, hw=TPU_V5E, budget=2, measure=measure)
    top = out[0]
    assert top.model_error == pytest.approx(-0.5)
    assert top.exec_stats.modeled_s == pytest.approx(top.modeled_s)
    assert top.exec_stats.model_error == pytest.approx(-0.5)
    assert sum(r.measured_s is not None for r in out) == min(2, len(out))


def test_refinement_measures_real_runs_on_the_cpu():
    spec = TuneSpec("box2d1r", 296, 40, d_grid=(4,), s_tb_grid=(20, 40),
                    k_on_grid=(1, 2), codecs=("identity",),
                    kernel_impls=("reference", "cuda_db", "mxu"))
    out = tune(spec, profile=synthetic_profile(hw=TPU_V5E,
                                               profile_id="tpu-synthetic"),
               budget=6, device="cpu")
    measured = [r for r in out if r.measured_s is not None]
    assert {r.config["kernel_impl"] for r in measured} \
        == {"reference", "cuda_db", "mxu"}
    for r in measured:
        assert r.measured_s > 0 and r.model_error is not None
        assert r.exec_stats.kernel_impl == r.config["kernel_impl"]
        assert r.exec_stats.kernel_calls > 0
        assert r.exec_stats.model_error == pytest.approx(r.model_error)
    json.dumps(out[0].to_record())


def test_sharded_mode_is_not_ported_yet():
    """(The name predates the port of the sharded tuner.)  The sharded
    mode ranks mesh x k_ici like the JAX package's, and the deprecated
    alias warns and returns the same ranking."""
    from repro.core.tune import TuneSpec as JaxTuneSpec
    from repro.core.tune import tune as jax_tune

    got = tune(TuneSpec("box2d1r", 2050, 64, mesh=4), hw=TPU_V5E)
    want = jax_tune(JaxTuneSpec("box2d1r", 2050, 64, mesh=4),
                    hw=jax_analytic.TPU_V5E)
    assert [(r.config, r.modeled_s, r.extras) for r in got] \
        == [(r.config, r.modeled_s, r.extras) for r in want]
    assert got and {r.mode for r in got} == {"sharded"}
    with pytest.warns(DeprecationWarning):
        alias = autotune_sharded(get_stencil("box2d1r"), 2050, 64, TPU_V5E,
                                 n_devices=4)
    assert [(c.mesh, c.k_ici, c.time_s) for c in alias] \
        == [(r.config["mesh"], r.config["k_ici"], r.modeled_s)
            for r in got if r.config["codec"] == "identity"]


def test_top_level_exports():
    for name in ("tune", "TuneSpec", "TuneResult", "DeviceProfile",
                 "calibrate", "resolve_hardware", "Hardware"):
        assert name in repro_torch.__all__ and hasattr(repro_torch, name)


def test_quick_calibration_on_the_cpu_gives_a_loadable_profile(tmp_path):
    prof = calibrate(quick=True, device="cpu",
                     kernel_impls=("reference", "mxu"))
    assert prof.fingerprint["backend"] == "cpu"
    assert prof.base_hardware == "h100-sxm"
    assert set(prof.kernel_terms) == {"reference", "mxu"}
    for terms in prof.kernel_terms.values():
        assert terms["bw_eff"] > 0 and terms["flops_eff"] > 0
        assert terms["n_points"] > 0
    hw = prof.as_hardware()
    assert hw.bw_intc > 0 and hw.bw_dmem > 0 and hw.peak_vpu_flops > 0
    p = tmp_path / "cpu.json"
    prof.save(str(p))
    assert DeviceProfile.load(str(p)) == prof
    assert JaxProfile.load(str(p)).profile_id == prof.profile_id
    assert all(np.isfinite(v) and v >= 0 for v in prof.residuals.values())


def test_exec_stats_merge_sums_modeled_time_and_recomputes_error():
    a = ExecStats(executor="eager", kernel_impl="mxu", kernel_calls=3,
                  op_counts={"FusedKernel": 3}, wall_s=2.0, modeled_s=1.0)
    b = ExecStats(kernel_calls=2, op_counts={"FusedKernel": 2, "H2D": 1},
                  wall_s=2.0, modeled_s=5.0)
    a.merge(b)
    assert a.kernel_calls == 5 and a.wall_s == 4.0
    assert a.op_counts == {"FusedKernel": 5, "H2D": 1}
    assert a.modeled_s == 6.0
    assert a.model_error == pytest.approx((6.0 - 4.0) / 4.0)
    assert a.executor == "eager" and a.kernel_impl == "mxu"
    # the JAX package's arithmetic, field for field
    from repro.core.lower import ExecStats as JaxExecStats

    ja = JaxExecStats(wall_s=2.0, modeled_s=1.0)
    ja.merge(JaxExecStats(wall_s=2.0, modeled_s=5.0))
    assert (ja.modeled_s, ja.model_error) == (a.modeled_s, a.model_error)
    c = ExecStats(wall_s=1.0)
    c.merge(ExecStats(wall_s=1.0))
    assert c.modeled_s is None and c.model_error is None
