"""SO2DR core, ported to PyTorch.

Engine planners (oocore) compile to transfer/kernel op schedules (plan),
lowered to slot-bound stage programs with a shape-bucketed kernel cache
(lower), interpreted by executors (executor: eager / double-buffered /
dry-run) on a device (device: None means ``cuda``).  The L2 sharded
planner (shard) compiles per-device op streams with halo-exchange ops,
run in lockstep on one device by the sharded simulator (the masked
update lives in distributed); when a shard's working set exceeds the
device budget, the hierarchical compiler (hierarchy) nests an L1
out-of-core streaming plan inside every shard.  The multi-process
backend (distributed, ShardMapExecutor) runs the same plans on a mesh of
rank processes (ranks) with ``torch.distributed`` halo exchanges.
Oracle (reference), stencil registry, chunk algebra (tiling), transfer codecs (compress).
The Sec. III/IV-C cost models (analytic/params/accounting), measured
calibration (calibrate) and the tuner (autotune, tune) choose among the
engines, configurations and kernels.  Fault injection (faults) and
checkpoint/resume (recovery) make every round a recovery point.
"""
from .analytic import EngineTimes, H100_SXM, Hardware, RTX3080_PAPER, TPU_V5E, model_times, times_from_plan  # noqa: F401
from .autotune import BoxChoice, Choice, ShardedChoice, autotune, autotune_box, autotune_sharded  # noqa: F401
from .autotune import optimization_target, predicted_sharded_makespan  # noqa: F401
from .autotune import predicted_makespan, stage_costs, trapezoid_redundant_elements  # noqa: F401
from .calibrate import DeviceProfile, ProfileError, calibrate, resolve_hardware  # noqa: F401
from .compress import CODECS, Codec, compress_plan, get_codec, register_codec  # noqa: F401
from .device import resolve_device  # noqa: F401
from .faults import FAULT_KINDS, FaultInjector, FaultPlan, FaultTrigger, InjectedFault, RetryPolicy  # noqa: F401
from .faults import KernelFault, RankLossFault, SlotExhaustedError, TransientTransferError  # noqa: F401
from .executor import DoubleBufferedExecutor, DryRunExecutor, EagerExecutor, ShardMapExecutor, ShardedSimExecutor, get_executor  # noqa: F401
from .hierarchy import HierarchicalPlan, compile_hierarchical  # noqa: F401
from .lower import CompiledPlan, CompiledShardedPlan, ExecStats, KernelCache, lower, lower_sharded  # noqa: F401
from .oocore import BoxTB, InCore, NaiveTB, ResReu, SO2DR, TransferStats, get_engine  # noqa: F401
from .oocore import compile_box_plan, compile_plan, compile_plan_nd  # noqa: F401
from .plan import Box, BufferRead, BufferWrite, Compress, D2H, Decompress, ExecutionPlan, FusedKernel, H2D, HostCommit  # noqa: F401
from .plan import DeviceShard, HaloRecv, HaloSend, ShardKernel, ShardLoad, ShardStore, ShardedPlan  # noqa: F401
from .ranks import RankFailure, RankMesh  # noqa: F401
from .recovery import PlanCheckpointer, PlanExecutionError, plan_fingerprint, resume_plan, run_with_recovery  # noqa: F401
from .reference import multi_step_band, multi_step_box, run_reference, step_band, step_band_nd, step_domain  # noqa: F401
from .shard import compile_sharded, ghost_wedge_elements  # noqa: F401
from .stencil import PAPER_BENCHMARKS, REGISTRY, Stencil, get_stencil  # noqa: F401
from .tune import TuneResult, TuneSpec, tune  # noqa: F401
