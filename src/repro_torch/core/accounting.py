"""Geometry-only TransferStats prediction — a dry run of the plan (port
of :mod:`repro.core.accounting`).

Every engine compiles its schedule into an
:class:`repro_torch.core.plan.ExecutionPlan` whose accounting is derived
from the op stream itself, so "prediction" and "measurement" are the
same arithmetic: this module compiles the plan (no array allocation) and
walks it with the dry-run executor.
"""
from __future__ import annotations

from .executor import DryRunExecutor
from .oocore import TransferStats, compile_plan
from .stencil import Stencil

__all__ = ["predict_stats"]


def predict_stats(
    engine: str, st: Stencil, Y: int, X: int, n: int,
    d: int, k_off: int, k_on: int, itemsize: int = 4, codec=None,
) -> TransferStats:
    plan = compile_plan(engine, st, Y, X, n, d, k_off, k_on, itemsize,
                        codec=codec)
    _, stats = DryRunExecutor().execute(plan)
    return stats
