"""The banded tensor-core kernel's module (B3) of the port vs the JAX package.

On the CPU the wrapper runs its plain version, so these tests hold that
plain version — banded matmuls over the JAX package's band matrices — to
the Pallas kernel itself in interpret mode, at the JAX test's 2e-5
(tests/test_kernels.py::test_banded_mxu_kernel), and pin the pieces the
CUDA kernel and the dispatcher rest on: the band matrices, the napkin
rule, the H100 auto choice, and the precision argument for the 3xTF32
split.  The CUDA kernel runs only on the card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.stencil import REGISTRY as JAX_REGISTRY
from repro.kernels.stencil_banded_mxu import (
    _band_matrices as jax_band_matrices, banded_fused_stencil as jax_banded,
    mxu_wins as jax_mxu_wins)
from repro_torch.core.analytic import H100_SXM
from repro_torch.core.reference import multi_step_band
from repro_torch.core.stencil import REGISTRY, get_stencil
from repro_torch.kernels import MXU_CUDA_TILE
from repro_torch.kernels._build import SMEM_LIMIT, fit_tile
from repro_torch.kernels.dispatch import DispatchPolicy, select_kernel
from repro_torch.kernels.stencil_banded_mxu import (
    _band_matrices, banded_fused_stencil, banded_fused_stencil_plain,
    banded_mma_count, banded_smem_bytes, banded_step_grids, mxu_wins)

RNG = np.random.default_rng(11)
LINEAR_2D = sorted(n for n, s in REGISTRY.items()
                   if s.is_linear and s.ndim == 2)


@pytest.mark.parametrize("name", ["box2d1r", "box2d4r"])
@pytest.mark.parametrize("steps", [1, 2])
def test_plain_matches_interpret_mode_pallas(name, steps):
    for kt, kb in [(False, False), (True, True)]:
        x = RNG.standard_normal((48, 160)).astype(np.float32)
        ref = np.asarray(jax_banded(jnp.asarray(x), name, steps, kt, kb,
                                    tile=(16, 32), interpret=True))
        got = banded_fused_stencil_plain(torch.from_numpy(x), name, steps,
                                         kt, kb).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-5, (name, steps, kt, kb)


@pytest.mark.parametrize("name", LINEAR_2D)
def test_plain_matches_the_band_oracle(name):
    """Every linear 2-D stencil, ragged bands and all keep flags, against
    the port's multi_step_band: fp32 within 2e-5, bf16 within 3e-2."""
    for (H, X), steps, kt, kb in [((48, 160), 4, True, False),
                                  ((41, 97), 2, False, True),
                                  ((37, 131), 1, False, False)]:
        x = torch.from_numpy(RNG.standard_normal((H, X)).astype(np.float32))
        ref = multi_step_band(x, name, steps, kt, kb)
        got = banded_fused_stencil(x, name, steps, kt, kb)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 2e-5
        xb = x.to(torch.bfloat16)
        ref = multi_step_band(xb, name, steps, kt, kb).float()
        got = banded_fused_stencil(xb, name, steps, kt, kb)
        assert got.dtype == torch.bfloat16
        err = float((got.float() - ref).abs().max() / ref.abs().max())
        assert err <= 3e-2


@pytest.mark.parametrize("name", LINEAR_2D)
def test_band_matrices_are_bitwise_the_jax_ones(name):
    for tx in (8, 32, 128):
        want = jax_band_matrices(JAX_REGISTRY[name], tx)
        got = _band_matrices(get_stencil(name), tx)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", sorted(n for n, s in REGISTRY.items()
                                        if s.ndim == 2))
def test_mxu_wins_agrees_with_jax_under_tpu_rates(name):
    for tx in (128, 512):
        assert mxu_wins(get_stencil(name), tx=tx) \
            == jax_mxu_wins(JAX_REGISTRY[name], tx=tx)


def test_h100_auto_choice_is_pinned():
    """With the H100's data-sheet rates (67 TFLOP/s fp32, 3xTF32 at a
    third of 494.7) the banded recast wins for no registry stencil: e.g.
    box2d4r costs 9*2*136 FLOP / 1.65e14 = 14.8 ps per cell update on the
    tensor cores against 161 / 67e12 = 2.4 ps on the CUDA cores."""
    want = {name: ("reference" if st.ndim == 3 else "cuda_db")
            for name, st in REGISTRY.items()}
    got = {name: select_kernel(name, 4, DispatchPolicy(backend="cuda"))[0]
           for name in REGISTRY}
    assert got == want
    st = get_stencil("box2d4r")
    assert not mxu_wins(st, 128, H100_SXM.peak_vpu_flops,
                        H100_SXM.peak_mxu_flops)
    # and on the TPU's rates the JAX rule still picks it
    assert mxu_wins(st)


def test_mxu_rejects_nonlinear_stencils():
    with pytest.raises(ValueError, match="mxu"):
        select_kernel("gradient2d", 1, DispatchPolicy(impl="mxu"),
                      device="cpu")
    assert select_kernel("box2d4r", 1, DispatchPolicy(impl="mxu"),
                         device="cpu")[0] == "mxu"
    x = torch.zeros((24, 40))
    for fn in (banded_fused_stencil, banded_fused_stencil_plain):
        with pytest.raises(ValueError, match="linear"):
            fn(x, "gradient2d", 1)
    with pytest.raises(ValueError, match="linear"):
        banded_fused_stencil(x[None], "heat3d1r", 1)


def test_wrapper_runs_plain_on_cpu_and_raises_elsewhere():
    banded_fused_stencil.launches = 0
    x = torch.from_numpy(RNG.standard_normal((24, 40)).astype(np.float32))
    assert torch.equal(banded_fused_stencil(x, "box2d1r", 2),
                       banded_fused_stencil_plain(x, "box2d1r", 2))
    with pytest.raises(ValueError, match="CUDA kernel"):
        banded_fused_stencil(torch.empty((24, 40), device="meta"),
                             "box2d1r", 1)
    assert banded_fused_stencil.launches == 0


@pytest.mark.parametrize("name", LINEAR_2D)
def test_tile_fits_shared_memory(name):
    """The Python mirror of the kernel's shared memory (``banded_layout``
    and ``banded_smem`` in the CUDA source): two fp32 tiles that hold
    every row and column some step's trapezoid grid reads, the row stride
    4 mod 32 words, plus the B table; fit_tile keeps it within 227 KB at
    m in {1, 2, 4, 8} (MXU_CUDA_TILE itself up to m = 4)."""
    r = get_stencil(name).radius
    for steps in (1, 2, 4, 8):
        ty, tx = fit_tile(MXU_CUDA_TILE, 10 ** 4, 10 ** 5, steps, r, 4, 2,
                          lambda a, b: banded_smem_bytes(a, b, steps, r))
        if steps <= 4:
            assert (ty, tx) == MXU_CUDA_TILE
        smem = banded_smem_bytes(ty, tx, steps, r)
        assert smem <= SMEM_LIMIT
        # the formula, restated: rows and columns the fragments read
        grids = banded_step_grids(ty, tx, steps, r)
        rows = max(r0 + 16 * mb + 2 * r for r0, _, mb, _ in grids)
        cols = max(c0 + 8 * (nb + 1) for _, c0, _, nb in grids)
        stride = cols + (4 - cols) % 32
        assert stride % 32 == 4 and stride >= cols
        assert smem == 2 * rows * stride * 4 + (2 * r + 1) * 1024
        # they cover the apron'd tile, and each step's grid covers the
        # cells within (steps-1-s)*r of the output tile, from 16-byte
        # aligned columns
        hc, wc = ty + 2 * (steps - 1) * r, tx + 2 * (steps - 1) * r
        assert rows >= hc + 2 * r and cols >= wc + 2 * r
        for s, (r0, c0, mb, nb) in enumerate(grids):
            assert r0 == s * r and c0 % 4 == 0 and c0 <= s * r
            assert r0 + 16 * mb >= hc - s * r and c0 + 8 * nb >= wc - s * r
    # deeper fusion halves the tile instead of failing
    ty, tx = fit_tile(MXU_CUDA_TILE, 10 ** 4, 10 ** 5, 16, r, 4, 2,
                      lambda a, b: banded_smem_bytes(a, b, 16, r))
    assert banded_smem_bytes(ty, tx, 16, r) <= SMEM_LIMIT


def test_mma_count_of_the_trapezoid():
    """box2d4r, m=4, 64 x 128 tile: the step grids are 6x19, 5x18, 5x17
    and 4x16 fragments (353, a fifth fewer than 4 x 6 x 19 = 456 over
    the whole centre), 54 MMAs each; shared memory 104 rows x 164 words
    x 2 buffers + the 9 KiB B table."""
    assert banded_step_grids(64, 128, 4, 4) == [
        (0, 0, 6, 19), (4, 4, 5, 18), (8, 8, 5, 17), (12, 12, 4, 16)]
    assert banded_mma_count(64, 128, 4, 4) == 353 * 9 * 6
    assert banded_smem_bytes(64, 128, 4, 4) == 2 * 104 * 164 * 4 + 9 * 1024


# ----------------------------------------------- the precision hazard


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), round to nearest
    with ties away from zero on the 13 dropped bits — what
    ``cvt.rna.tf32.f32`` does (the kernel's split of the coefficients)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32 (the 13 low bits dropped): the kernel's split of
    the tile's values, and what the tensor cores read of a low part."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulated_step(x: torch.Tensor, c: torch.Tensor, split: bool):
    """One valid step of a linear stencil as the kernel's products:
    plain TF32 (a*b) or the kernel's 3xTF32 split (a_lo*b_hi + a_hi*b_lo
    + a_hi*b_hi, with a cut and b rounded to TF32), each product exact
    and the sum in float64 (the tensor cores' fp32 accumulation is not
    the point here)."""
    n = c.shape[0]
    h, w = x.shape
    if split:
        a_hi = _tf32_cut(x)
        a_lo = _tf32_cut(x - a_hi)
    else:
        a_hi = _tf32(x)
    b_hi = _tf32(c)
    b_lo = _tf32(c - b_hi)
    acc = torch.zeros((h - n + 1, w - n + 1), dtype=torch.float64)
    for dy in range(n):
        for dx in range(n):
            win = (slice(dy, h - n + 1 + dy), slice(dx, w - n + 1 + dx))
            hi = a_hi[win].double()
            acc += hi * b_hi[dy, dx].double()
            if split:
                acc += a_lo[win].double() * b_hi[dy, dx].double()
                acc += hi * b_lo[dy, dx].double()
    return acc


def test_tf32_split_is_what_meets_the_tolerance():
    """One TF32 product per tap misses the reference's 2e-5 on box2d4r;
    the kernel's 3xTF32 split (the tile's values cut, the coefficients
    rounded) meets it with room to spare."""
    st = get_stencil("box2d4r")
    c = torch.from_numpy(st.coeffs.astype(np.float32))
    assert not torch.equal(_tf32(c), c)       # coefficients not TF32-exact
    x = torch.from_numpy(RNG.standard_normal((64, 96)).astype(np.float32))
    exact = st.step_valid(x.double())
    one = float((_emulated_step(x, c, split=False) - exact).abs().max())
    three = float((_emulated_step(x, c, split=True) - exact).abs().max())
    assert one > 2e-5, one
    assert three <= 2e-6, three
    # the emulated rounding is TF32: 10 explicit bits survive
    v = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12], dtype=torch.float32)
    assert _tf32(v).tolist() == [1.0 + 2.0 ** -10, 1.0]
    v = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -11], dtype=torch.float32)
    assert _tf32_cut(v).tolist() == [1.0 + 2.0 ** -10]
    # a cut part and its exact remainder give the value back
    assert torch.equal(_tf32_cut(x) + (x - _tf32_cut(x)), x)
