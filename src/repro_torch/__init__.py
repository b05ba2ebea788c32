"""repro_torch: SO2DR on PyTorch and CUDA — the port of ``repro``.

The planners, plan IR, lowering, executors and codecs of ``repro.core``
on PyTorch tensors, with the fused-stencil kernels written by hand for
Hopper (``repro_torch.kernels``).  It imports neither JAX nor ``repro``.
Importing it builds and loads no kernel: the CUDA library is built the
first time a kernel launches.  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
from .core import (  # noqa: F401
    Box,
    ExecutionPlan,
    TransferStats,
    Stencil,
    get_stencil,
    compile_plan,
    compile_plan_nd,
    compile_box_plan,
    get_engine,
    get_executor,
    get_codec,
    compress_plan,
    run_reference,
)

__all__ = [
    "Box",
    "ExecutionPlan",
    "TransferStats",
    "Stencil",
    "get_stencil",
    "compile_plan",
    "compile_plan_nd",
    "compile_box_plan",
    "get_engine",
    "get_executor",
    "get_codec",
    "compress_plan",
    "run_reference",
]
