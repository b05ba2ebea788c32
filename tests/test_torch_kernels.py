"""The fused-stencil kernel modules of the port vs the JAX package.

On the CPU a kernel wrapper runs its plain version, so these tests hold
the plain versions of both kernels to the JAX oracle on the matrix of
tests/test_kernels.py (1e-5 relative in fp32, 3e-2 in bf16 — that file's
tolerances), and to the Pallas kernels themselves in interpret mode for a
few cases.  The CUDA kernels run only on the card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.stencil import REGISTRY
from repro.kernels.ref import multi_step_band as jax_multi_step_band
from repro_torch.kernels import CUDA_TILE, DB_CUDA_TILE
from repro_torch.kernels._build import SMEM_LIMIT, fit_tile
from repro_torch.kernels.dispatch import DispatchPolicy, select_kernel
from repro_torch.kernels.ops import fused_stencil
from repro_torch.kernels.stencil_multistep import (
    fused_stencil_band, fused_stencil_band_plain)
from repro_torch.kernels.stencil_multistep_db import (
    db_smem_bytes, fused_stencil_band_db, fused_stencil_band_db_plain)

RNG = np.random.default_rng(7)
KERNELS = [fused_stencil_band, fused_stencil_band_db]
NAMES_2D = sorted(n for n, s in REGISTRY.items() if s.ndim == 2)


def _rel_err(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)


def _check(name, H, X, steps, kt, kb, tol=1e-5):
    x = RNG.standard_normal((H, X)).astype(np.float32)
    ref = jax_multi_step_band(jnp.asarray(x), name, steps, kt, kb)
    for kernel in KERNELS:
        got = kernel(torch.from_numpy(x), name, steps, kt, kb)
        assert _rel_err(got, ref) < tol, (kernel.__name__, name, H, X, steps,
                                          kt, kb)


@pytest.mark.parametrize("name", ["box2d1r", "box2d2r", "box2d4r",
                                  "gradient2d", "star2d3r"])
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_plain_versions_match_jax_oracle(name, steps):
    # two of the three keep pairs per case, rotated over the steps so
    # every stencil meets all three (each JAX case is its own compile)
    keeps = [(False, False), (True, False), (True, True)]
    i = (1, 2, 4).index(steps)
    for kt, kb in (keeps[i], keeps[(i + 1) % 3]):
        _check(name, 48, 160, steps, kt, kb)


def test_plain_versions_non_divisible_and_tiny_bands():
    _check("box2d2r", 37, 131, 2, False, True)
    _check("box2d1r", 41, 97, 4, True, False)
    _check("box2d4r", 20, 40, 2, True, True)


def test_plain_versions_bf16():
    x = RNG.standard_normal((64, 256)).astype(np.float32)
    ref = jax_multi_step_band(jnp.asarray(x, jnp.bfloat16), "box2d1r", 4,
                              True, False)
    for kernel in KERNELS:
        got = kernel(torch.from_numpy(x).to(torch.bfloat16), "box2d1r", 4,
                     True, False)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy()
                     - np.asarray(ref, np.float32)).max()
        assert err < 3e-2


@pytest.mark.parametrize("name", ["box2d1r", "gradient2d"])
@pytest.mark.parametrize("steps", [1, 4])
def test_plain_versions_match_interpret_mode_pallas(name, steps):
    """The Pallas kernels themselves (interpret mode, as the JAX
    package's own tests run them on the CPU) against the port."""
    from repro.kernels.stencil_multistep import fused_stencil_band as pallas
    from repro.kernels.stencil_multistep_db import (
        fused_stencil_band_db as pallas_db)

    x = RNG.standard_normal((48, 160)).astype(np.float32)
    kt, kb = True, False
    for jax_kernel, port_plain in ((pallas, fused_stencil_band_plain),
                                   (pallas_db, fused_stencil_band_db_plain)):
        ref = jax_kernel(jnp.asarray(x), name, steps, kt, kb, tile=(16, 64),
                         interpret=True)
        got = port_plain(torch.from_numpy(x), name, steps, kt, kb)
        assert _rel_err(got, ref) < 1e-5, (jax_kernel.__name__, name, steps)


def test_launch_counters_stay_zero_on_cpu():
    for k in KERNELS:
        k.launches = 0
    x = torch.from_numpy(RNG.standard_normal((24, 40)).astype(np.float32))
    for kernel in KERNELS:
        kernel(x, "gradient2d", 2, True, True)
    fused_stencil(x, "box2d1r", 1)
    assert [k.launches for k in KERNELS] == [0, 0]


def test_wrappers_raise_off_cpu_without_a_card():
    """A band that is not on the CPU goes to the kernel or raises: the
    wrapper never falls back to the plain version."""
    band = torch.empty((24, 40), device="meta")
    for kernel in KERNELS:
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernel(band, "box2d1r", 1)
    assert [k.launches for k in KERNELS] == [0, 0]


@pytest.mark.parametrize("name", NAMES_2D)
def test_select_kernel(name):
    for steps in (1, 4):
        impl, fn = select_kernel(name, steps, device="cpu")
        assert impl == "reference"
        impl, fn = select_kernel(name, steps, DispatchPolicy(backend="cuda"))
        assert impl == "cuda_db"
        impl, _ = select_kernel(name, steps, DispatchPolicy(impl="cuda"),
                                device="cpu")
        assert impl == "cuda"
    # the same (impl, policy) resolves to the same callable object
    assert select_kernel(name, 1, device="cpu")[1] is \
        select_kernel(name, 2, device="cpu")[1]


def test_select_kernel_3d_and_unknown():
    assert select_kernel("heat3d1r", 1, DispatchPolicy(backend="cuda"))[0] \
        == "reference"
    with pytest.raises(ValueError):
        select_kernel("heat3d1r", 1, DispatchPolicy(impl="cuda_db"),
                      device="cpu")
    with pytest.raises(KeyError):
        select_kernel("box2d1r", 1, DispatchPolicy(impl="pallas"),
                      device="cpu")


@pytest.mark.parametrize("name", NAMES_2D)
def test_cuda_tile_fits_shared_memory(name):
    """The CUDA tile holds the fused kernel's two apron'd buffers and the
    persistent kernel's three in 227 KB for every 2-D stencil at m <= 4."""
    r = REGISTRY[name].radius
    for steps in (1, 2, 4):
        for buffers in (2, 3):
            assert fit_tile(CUDA_TILE, 10 ** 4, 10 ** 5, steps, r, 4,
                            buffers) == CUDA_TILE
            ty, tx = CUDA_TILE
            a = 2 * steps * r
            assert buffers * (ty + a) * (tx + a) * 4 <= SMEM_LIMIT
    # deeper fusion shrinks the tile instead of failing to launch
    ty, tx = fit_tile(CUDA_TILE, 10 ** 4, 10 ** 5, 16, 4, 4, 3)
    assert 3 * (ty + 128) * (tx + 128) * 4 <= SMEM_LIMIT
    # tiny bands cut the tile to the band
    assert fit_tile(CUDA_TILE, 5, 40, 2, r, 4, 2) == (5, 40)


@pytest.mark.parametrize("name", NAMES_2D)
def test_persistent_kernel_shared_memory(name):
    """The Python mirror of the persistent kernel's shared memory (three
    tiles whose rows start at the 16-byte-aligned column at or left of
    the apron'd tile): every shift of the origin fits a row, rows are
    whole 16-byte chunks, and DB_CUDA_TILE fits 227 KB at m <= 4 in fp32
    and bf16; deeper fusion halves the tile."""
    r = REGISTRY[name].radius
    for itemsize in (4, 2):
        vec = 16 // itemsize
        for steps in (1, 2, 4):
            ty, tx = DB_CUDA_TILE
            tw = tx + 2 * steps * r
            smem = db_smem_bytes(ty, tx, steps, r, itemsize)
            stride = smem // (3 * (ty + 2 * steps * r) * itemsize)
            assert smem == 3 * (ty + 2 * steps * r) * stride * itemsize
            assert stride % vec == 0 and stride >= tw + vec - 1
            assert stride < tw + 2 * vec - 1
            assert smem <= SMEM_LIMIT

            def fp(a, b):
                return db_smem_bytes(a, b, steps, r, itemsize)
            assert fit_tile(DB_CUDA_TILE, 10 ** 4, 10 ** 5, steps, r,
                            itemsize, 3, fp) == DB_CUDA_TILE
    ty, tx = fit_tile(DB_CUDA_TILE, 10 ** 4, 10 ** 5, 16, 4, 4, 3,
                      lambda a, b: db_smem_bytes(a, b, 16, 4, 4))
    assert db_smem_bytes(ty, tx, 16, 4, 4) <= SMEM_LIMIT
    # gradient2d at m = 4: 72 rows of 132 fp32 words (128 + 3 rounded up)
    assert db_smem_bytes(64, 120, 4, 1, 4) == 3 * 72 * 132 * 4
