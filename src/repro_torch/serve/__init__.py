"""Stencil-as-a-service: persistent plan server + cross-job scheduler
(the port of :mod:`repro.serve`, without its LM decode loop).

:class:`StencilService` keeps one warm kernel cache, shape-bucket
registry, and device slot pool alive across jobs; the scheduler
interleaves concurrent jobs' stage programs so one job's transfers
hide under another's kernels (see :mod:`repro_torch.serve.service`).
"""
from .scheduler import (  # noqa: F401
    ScheduledJob, admission_order, interleave_stages, modeled_makespan,
    run_interleaved,
)
from .service import JobResult, StencilJob, StencilService  # noqa: F401

__all__ = [
    "StencilService", "StencilJob", "JobResult",
    "ScheduledJob", "admission_order", "interleave_stages",
    "modeled_makespan", "run_interleaved",
]
