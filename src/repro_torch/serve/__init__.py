"""Stencil-as-a-service: persistent plan server + cross-job scheduler,
and the LM decode loop (the port of :mod:`repro.serve`).

:class:`StencilService` keeps one warm kernel cache, shape-bucket
registry, and device slot pool alive across jobs; the scheduler
interleaves concurrent jobs' stage programs so one job's transfers
hide under another's kernels (see :mod:`repro_torch.serve.service`).
:mod:`repro_torch.serve.decode` prefills and greedily decodes a batch of
LM requests.
"""
from .decode import greedy_generate, make_decode_step, make_prefill  # noqa: F401
from .scheduler import (  # noqa: F401
    ScheduledJob, admission_order, interleave_stages, modeled_makespan,
    run_interleaved,
)
from .service import JobResult, StencilJob, StencilService  # noqa: F401

__all__ = [
    "StencilService", "StencilJob", "JobResult",
    "ScheduledJob", "admission_order", "interleave_stages",
    "modeled_makespan", "run_interleaved",
    "make_prefill", "make_decode_step", "greedy_generate",
]
