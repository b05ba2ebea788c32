"""The port's stencil registry and plain oracle vs the JAX package.

Same numpy inputs through both packages on the CPU: the coefficient
tables are bit-equal (same numpy arithmetic), and every oracle function
agrees to 1e-5 relative in fp32 — the tolerance of the reference's own
kernel tests (tests/test_kernels.py); the two frameworks may order or
fuse the elementwise float ops differently.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import reference as jref
from repro.core import stencil as jst
from repro_torch.core import reference as tref
from repro_torch.core import stencil as tst

RNG = np.random.default_rng(11)
TOL = 1e-5
NAMES_2D = sorted(n for n, s in jst.REGISTRY.items() if s.ndim == 2)
KEEPS = [(False, False), (True, False), (False, True), (True, True)]


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)


def test_registry_matches():
    assert sorted(tst.REGISTRY) == sorted(jst.REGISTRY)
    assert tst.PAPER_BENCHMARKS == jst.PAPER_BENCHMARKS
    for name, js in jst.REGISTRY.items():
        ts = tst.get_stencil(name)
        assert (ts.name, ts.radius, ts.kind, ts.flops_per_elem, ts.points,
                ts.ndim, ts.is_linear) == (
            js.name, js.radius, js.kind, js.flops_per_elem, js.points,
            js.ndim, js.is_linear), name


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_coefficients_bit_equal(radius):
    for port, ref in ((tst.box_coeffs, jst.box_coeffs),
                      (tst.star_coeffs, jst.star_coeffs)):
        a, b = port(radius), ref(radius)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    for kind in ("box", "star"):
        name = f"{kind}2d{radius}r"
        assert tst.REGISTRY[name].coeffs.tobytes() == \
            jst.REGISTRY[name].coeffs.tobytes()


def test_taps_follow_linear_step_order():
    st = tst.get_stencil("star2d2r")
    taps = st.taps()
    assert len(taps) == st.points
    assert [(dy, dx) for dy, dx, _ in taps] == sorted(
        (dy, dx) for dy, dx, _ in taps)
    assert all(c == st.coeffs[dy, dx] for dy, dx, c in taps)


@pytest.mark.parametrize("name", NAMES_2D)
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_multi_step_band_matches_jax(name, steps):
    # one keep pair per (stencil, steps), rotated so that every stencil
    # meets three of the four pairs and every pair meets every radius:
    # each JAX case is its own XLA compile, which dominates this file
    kt, kb = KEEPS[(NAMES_2D.index(name) + (1, 2, 4).index(steps)) % 4]
    x = RNG.standard_normal((48, 56)).astype(np.float32)
    ref = jref.multi_step_band(jnp.asarray(x), name, steps, kt, kb)
    got = tref.multi_step_band(torch.from_numpy(x), name, steps, kt, kb)
    assert _rel_err(got, ref) <= TOL, (name, steps, kt, kb)


@pytest.mark.parametrize("name", NAMES_2D)
def test_step_band_and_run_reference_match_jax(name):
    x = RNG.standard_normal((30, 34)).astype(np.float32)
    js, ts = jst.get_stencil(name), tst.get_stencil(name)
    for kt, kb in KEEPS[1:3]:
        ref = jref.step_band(jnp.asarray(x), js, kt, kb)
        got = tref.step_band(torch.from_numpy(x), ts, kt, kb)
        assert _rel_err(got, ref) <= TOL, (name, kt, kb)
    ref = jref.step_domain(jnp.asarray(x), js)
    assert _rel_err(tref.step_domain(torch.from_numpy(x), ts), ref) <= TOL
    ref = jref.run_reference(jnp.asarray(x), js, 3)
    got = tref.run_reference(torch.from_numpy(x), ts, 3)
    assert _rel_err(got, ref) <= TOL
    # the row-blocked oracle is the same elementwise arithmetic
    blocked = tref.run_reference(torch.from_numpy(x), ts, 3, block_rows=5)
    assert torch.equal(blocked, got)


def test_heat3d_reference_and_box_match_jax():
    x = RNG.standard_normal((10, 12, 14)).astype(np.float32)
    js, ts = jst.get_stencil("heat3d1r"), tst.get_stencil("heat3d1r")
    ref = jref.run_reference(jnp.asarray(x), js, 3)
    got = tref.run_reference(torch.from_numpy(x), ts, 3)
    assert _rel_err(got, ref) <= TOL
    assert torch.equal(
        tref.run_reference(torch.from_numpy(x), ts, 3, block_rows=3), got)
    for steps in (1, 2):
        for kl, kh in [((True, False, True), (False, True, True)),
                       ((False,) * 3, (False,) * 3), ((True,) * 3, (True,) * 3)]:
            ref = jref.multi_step_box(jnp.asarray(x), "heat3d1r", steps,
                                      keep_lo=kl, keep_hi=kh)
            got = tref.multi_step_box(torch.from_numpy(x), "heat3d1r", steps,
                                      keep_lo=kl, keep_hi=kh)
            assert _rel_err(got, ref) <= TOL, (steps, kl, kh)


@pytest.mark.parametrize("name", ["box2d2r", "gradient2d"])
def test_multi_step_box_2d_matches_jax(name):
    x = RNG.standard_normal((26, 30)).astype(np.float32)
    for kl, kh in [((True, False), (False, True)), ((False, True), (True, False))]:
        ref = jref.multi_step_box(jnp.asarray(x), name, 2, keep_lo=kl,
                                  keep_hi=kh)
        got = tref.multi_step_box(torch.from_numpy(x), name, 2, keep_lo=kl,
                                  keep_hi=kh)
        assert _rel_err(got, ref) <= TOL, (kl, kh)


def test_gradient2d_amplifies_one_ulp_differences():
    """Why the CUDA kernels repeat the plain arithmetic exactly (no FMA
    contraction): one step of gradient2d keeps a one-ulp perturbation of
    its input near 1e-7 relative, but 320 steps (the smoke's main path)
    grow it past 1e-4 — no 1e-5 bound survives a long run unless the two
    implementations do the same operations in the same order."""
    st = tst.get_stencil("gradient2d")
    x = np.random.default_rng(0).standard_normal((130, 130)).astype(
        np.float32)
    xp = np.nextafter(x, np.float32(np.inf))

    def rel(n):
        a = tref.run_reference(torch.from_numpy(x), st, n)
        b = tref.run_reference(torch.from_numpy(xp), st, n)
        return float((a - b).abs().max() / a.abs().max())

    assert rel(1) < 1e-6
    assert rel(320) > 1e-4


def test_oracle_never_writes_its_input():
    x = torch.from_numpy(RNG.standard_normal((20, 22)).astype(np.float32))
    before = x.clone()
    st = tst.get_stencil("box2d1r")
    tref.step_domain(x, st)
    tref.multi_step_band(x, "box2d1r", 2, True, True)
    tref.multi_step_box(x, "box2d1r", 2, (True, True), (True, True))
    tref.run_reference(x, st, 2, block_rows=4)
    assert torch.equal(x, before)
