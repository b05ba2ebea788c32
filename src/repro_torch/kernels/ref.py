"""Plain PyTorch oracles for every kernel in this package.

The fused-stencil oracle is the band semantics from
:mod:`repro_torch.core.reference`; re-exported here so kernel tests depend
only on ``repro_torch.kernels``.
"""
from __future__ import annotations

from repro_torch.core.reference import multi_step_band, step_band  # noqa: F401

__all__ = ["multi_step_band", "step_band"]
