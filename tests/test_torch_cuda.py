"""The port's CUDA kernels and executors on the card (``cuda`` marker).

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

In fp32 each kernel computes the plain version's operations in its order
without FMA contraction, so the comparison is bitwise; bf16 accumulates
in fp32 and rounds once per step (3e-2 relative, the reference's bf16
tolerance in tests/test_kernels.py).
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
    fused_stencil_band, fused_stencil_band_plain)
from repro_torch.kernels.stencil_multistep_db import fused_stencil_band_db

RNG = np.random.default_rng(17)
KERNELS = {"cuda": fused_stencil_band, "cuda_db": fused_stencil_band_db}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-6))


@pytest.mark.parametrize("impl", sorted(KERNELS))
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
