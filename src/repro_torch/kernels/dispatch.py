"""Kernel-dispatch registry: pick the fused-step implementation (port of
:mod:`repro.kernels.dispatch`).

=============  ====================================================
impl           what it is
=============  ====================================================
reference      plain PyTorch :func:`multi_step_band`; the numerics
               ground truth, and the only choice off CUDA
cuda           shared-memory-resident k_on-step CUDA kernel, one CTA
               per tile (:mod:`repro_torch.kernels.stencil_multistep`)
cuda_db        persistent CUDA kernel with a ``cp.async`` ring
               (:mod:`repro_torch.kernels.stencil_multistep_db`)
=============  ====================================================

:func:`select_kernel` resolves a :class:`DispatchPolicy` (``auto`` or an
explicit impl name) against ``(stencil, steps, backend)`` and returns a
``fused_step`` callable with the engine-facing signature
``fn(band, name, steps, keep_top=..., keep_bottom=...)``.  The backend is
``policy.backend`` when set, else the type of the device the bands live
on.  Implementation modules are imported lazily, and the kernels build
only at their first launch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.stencil import Stencil, get_stencil
from repro_torch.kernels import CUDA_TILE

__all__ = [
    "DispatchPolicy", "KernelImpl", "KERNEL_IMPLS",
    "register_kernel_impl", "select_kernel",
]

# engine-facing fused-step signature:
#   fn(band, stencil_name, steps, keep_top=..., keep_bottom=...) -> band
FusedStep = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """How the lowering layer resolves FusedKernel ops to device code.

    ``impl``    — registry name, or ``"auto"`` (backend-driven choice).
    ``tile``    — output-tile override for the CUDA kernels (None = the
                  implementation's default).
    ``backend`` — override backend detection (``"cuda"``/``"cpu"``);
                  None = the type of the device the bands live on.
    ``bucket``  — let the lowering pass pad band heights to per-plan
                  shape buckets (see :mod:`repro_torch.core.lower`).
    """

    impl: str = "auto"
    tile: Optional[Tuple[int, int]] = None
    backend: Optional[str] = None
    bucket: bool = True


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered fused-kernel implementation."""

    name: str
    description: str
    make: Callable[[DispatchPolicy], FusedStep]   # lazy-imports the module
    supports: Callable[[Stencil, int], bool]      # (stencil, steps) -> ok


def _make_reference(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.core.reference import multi_step_band

    return multi_step_band


def _make_cuda(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.kernels.stencil_multistep import fused_stencil_band

    tile = policy.tile or CUDA_TILE

    def step(band, name, steps, keep_top=False, keep_bottom=False):
        return fused_stencil_band(band, name, steps, keep_top=keep_top,
                                  keep_bottom=keep_bottom, tile=tile)

    return step


def _make_cuda_db(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.kernels.stencil_multistep_db import fused_stencil_band_db

    tile = policy.tile or CUDA_TILE

    def step(band, name, steps, keep_top=False, keep_bottom=False):
        return fused_stencil_band_db(band, name, steps, keep_top=keep_top,
                                     keep_bottom=keep_bottom, tile=tile)

    return step


KERNEL_IMPLS: Dict[str, KernelImpl] = {}


def register_kernel_impl(impl: KernelImpl) -> KernelImpl:
    if impl.name in KERNEL_IMPLS:
        raise ValueError(f"kernel impl {impl.name!r} already registered")
    KERNEL_IMPLS[impl.name] = impl
    return impl


def _is_2d(st: Stencil, steps: int) -> bool:
    return st.ndim == 2


register_kernel_impl(KernelImpl(
    name="reference",
    description="plain PyTorch multi_step_band (oracle; per-step streaming)",
    make=_make_reference,
    supports=lambda st, steps: True,
))
register_kernel_impl(KernelImpl(
    name="cuda",
    description="shared-memory-resident k_on-step CUDA kernel (on-chip reuse)",
    make=_make_cuda,
    supports=_is_2d,
))
register_kernel_impl(KernelImpl(
    name="cuda_db",
    description="persistent CUDA kernel with a two-slot cp.async ring",
    make=_make_cuda_db,
    supports=_is_2d,
))


def _auto_impl(st: Stencil, backend: str) -> str:
    if backend == "cuda" and st.ndim == 2:
        # Every 2-D stencil goes to the persistent kernel.  The TPU's auto
        # sends box stencils to its banded-matmul kernel (``mxu``), but
        # that kernel is not ported yet, and ``mxu_wins`` decides with TPU
        # rates, which say nothing about an H100.
        return "cuda_db"
    # off CUDA (and for 3-D stencils, which no kernel takes) the plain
    # PyTorch path is the only implementation
    return "reference"


@functools.lru_cache(maxsize=64)
def _resolved_impl(name: str, policy: DispatchPolicy) -> FusedStep:
    """Memoized ``impl.make(policy)``: the same (impl, policy) always
    resolves to the *same callable object*, so the lowering layer's
    signature cache (keyed on the callable's identity) keeps hitting
    across repeated ``lower()`` calls."""
    return KERNEL_IMPLS[name].make(policy)


def select_kernel(
    stencil, steps: int, policy: Optional[DispatchPolicy] = None,
    device=None,
) -> Tuple[str, FusedStep]:
    """Resolve ``(stencil, steps, policy)`` to ``(impl_name, fused_step)``.

    ``policy.impl == "auto"`` picks per backend: the persistent CUDA
    kernel for 2-D stencils on CUDA, the plain path everywhere else.  The
    backend is ``policy.backend``, else the type of ``device`` (None
    means ``cuda``, as everywhere in the port).  An explicit impl name is
    validated against the stencil at dispatch time, not inside the
    kernel."""
    st = get_stencil(stencil) if isinstance(stencil, str) else stencil
    policy = policy or DispatchPolicy()
    backend = policy.backend or torch.device(
        "cuda" if device is None else device).type
    name = policy.impl
    if name == "auto":
        name = _auto_impl(st, backend)
    try:
        impl = KERNEL_IMPLS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel impl {name!r}; known: {sorted(KERNEL_IMPLS)}")
    if not impl.supports(st, steps):
        raise ValueError(
            f"kernel impl {name!r} does not support stencil {st.name!r} "
            f"(steps={steps})")
    return name, _resolved_impl(name, policy)
