"""Host spans inside the port's solve, there only while someone profiles.

:func:`span` wraps a stretch of the solve in
``torch.profiler.record_function("repro_torch." + name)`` when the autograd
profiler is on, and in one shared null context otherwise, so a span costs
one flag check when nobody profiles.  Under ``torch.profiler.profile`` the
ranges land in the trace as ``user_annotation`` events, on the clock of the
CUPTI kernel and memcpy events; under
``torch.autograd.profiler.emit_nvtx()`` they are NVTX ranges.

The spans of :meth:`repro_torch.core.lower.CompiledPlan.execute`:

* ``domain_copy`` — the mutable copy of the caller's host domain;
* ``pin`` / ``unpin`` — page-locking the host array for the copy stream
  and undoing it (pipelined CUDA runs only);
* ``stage.r<round>.c<chunk>`` — one chunk stage, with the next stage's
  prefetch issued inside it;
* ``commit.wait`` — a round's commit waiting for the copy stream and the
  compute stream;
* ``commit.drain`` — the copies of the staged boxes into the host array.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["PREFIX", "span"]

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager naming ``name`` in a profiler's trace, or a null
    context when no profiler is on."""
    if _enabled():
        return record_function(PREFIX + name)
    return _OFF
