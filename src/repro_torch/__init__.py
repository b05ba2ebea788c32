"""repro_torch: SO2DR on PyTorch and CUDA — the port of ``repro``.

The planners, plan IR, lowering, executors, codecs, cost model,
calibration and tuner, fault injection and checkpoint/resume, and the
sharded and hierarchical plans (run in lockstep on one device, or on a
mesh of rank processes over ``torch.distributed``) of ``repro.core``,
the stencil service of ``repro.serve`` and the elastic re-planning of
``repro.launch.elastic``, on PyTorch tensors, with the fused-stencil
kernels written by hand for Hopper (``repro_torch.kernels``); and the
LM stack's serve path (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.serve.decode``) for all six model families, its
training path (``repro_torch.optim``, ``.train``, ``.data`` and
``.launch.train``: AdamW, the Trainer with layer remat, the synthetic
data pipeline and the train CLI), and its launch layer
(``repro_torch.launch``: production meshes, the sharding rules over
DTensor, elastic resharding, the op-level cost counter and the
fake-tensor dry run, with the models' sharded regions).  It imports
neither JAX nor ``repro``.  Importing it builds and loads no
kernel and starts no process: the CUDA library is built the first time
a kernel launches, and rank processes start with their mesh.  Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""
from .core import (  # noqa: F401
    Box,
    ExecutionPlan,
    ShardedPlan,
    TransferStats,
    Stencil,
    get_stencil,
    compile_plan,
    compile_plan_nd,
    compile_box_plan,
    compile_sharded,
    compile_hierarchical,
    HierarchicalPlan,
    get_engine,
    get_executor,
    get_codec,
    compress_plan,
    run_reference,
    Hardware,
    H100_SXM,
    RTX3080_PAPER,
    TPU_V5E,
    autotune,
    autotune_box,
    autotune_sharded,
    tune,
    TuneSpec,
    TuneResult,
    DeviceProfile,
    calibrate,
    resolve_hardware,
    FaultPlan,
    FaultTrigger,
    RetryPolicy,
    InjectedFault,
    PlanExecutionError,
    PlanCheckpointer,
    resume_plan,
    run_with_recovery,
)
from .checkpoint import CheckpointManager  # noqa: F401
from .serve import JobResult, StencilJob, StencilService  # noqa: F401
from .data import DataSpec, SyntheticLM  # noqa: F401
from .optim import AdamW, OptState  # noqa: F401
from .train import TrainConfig, Trainer, compress_grads  # noqa: F401

__all__ = [
    "Box",
    "ExecutionPlan",
    "ShardedPlan",
    "TransferStats",
    "Stencil",
    "get_stencil",
    "compile_plan",
    "compile_plan_nd",
    "compile_box_plan",
    "compile_sharded",
    "compile_hierarchical",
    "HierarchicalPlan",
    "get_engine",
    "get_executor",
    "get_codec",
    "compress_plan",
    "run_reference",
    "Hardware",
    "H100_SXM",
    "RTX3080_PAPER",
    "TPU_V5E",
    "autotune",
    "autotune_box",
    "autotune_sharded",
    "tune",
    "TuneSpec",
    "TuneResult",
    "DeviceProfile",
    "calibrate",
    "resolve_hardware",
    "FaultPlan",
    "FaultTrigger",
    "RetryPolicy",
    "InjectedFault",
    "PlanExecutionError",
    "PlanCheckpointer",
    "resume_plan",
    "run_with_recovery",
    "CheckpointManager",
    "StencilService",
    "StencilJob",
    "JobResult",
    "AdamW",
    "OptState",
    "DataSpec",
    "SyntheticLM",
    "TrainConfig",
    "Trainer",
    "compress_grads",
]
