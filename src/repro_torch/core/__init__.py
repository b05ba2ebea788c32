"""SO2DR core, ported to PyTorch.

Engine planners (oocore) compile to transfer/kernel op schedules (plan),
lowered to slot-bound stage programs with a shape-bucketed kernel cache
(lower), interpreted by executors (executor: eager / double-buffered /
dry-run) on a device (device: None means ``cuda``).  Oracle (reference),
stencil registry, chunk algebra (tiling), transfer codecs (compress).
"""
from .compress import CODECS, Codec, compress_plan, get_codec, register_codec  # noqa: F401
from .device import resolve_device  # noqa: F401
from .executor import DoubleBufferedExecutor, DryRunExecutor, EagerExecutor, get_executor  # noqa: F401
from .lower import CompiledPlan, ExecStats, KernelCache, lower  # noqa: F401
from .oocore import BoxTB, InCore, NaiveTB, ResReu, SO2DR, TransferStats, get_engine  # noqa: F401
from .oocore import compile_box_plan, compile_plan, compile_plan_nd  # noqa: F401
from .plan import Box, BufferRead, BufferWrite, Compress, D2H, Decompress, ExecutionPlan, FusedKernel, H2D, HostCommit  # noqa: F401
from .reference import multi_step_band, multi_step_box, run_reference, step_band, step_band_nd, step_domain  # noqa: F401
from .stencil import PAPER_BENCHMARKS, REGISTRY, Stencil, get_stencil  # noqa: F401
