"""Kernel-dispatch registry: pick the fused-step implementation (port of
:mod:`repro.kernels.dispatch`).

=============  ====================================================
impl           what it is
=============  ====================================================
reference      plain PyTorch :func:`multi_step_band`; the numerics
               ground truth, and the only choice off CUDA
cuda           k_on-step CUDA kernel, one CTA per tile loaded by TMA
               (:mod:`repro_torch.kernels.stencil_multistep`)
cuda_db        persistent CUDA kernel with a ``cp.async`` ring
               (:mod:`repro_torch.kernels.stencil_multistep_db`)
mxu            linear stencils as banded products on the tensor cores
               (:mod:`repro_torch.kernels.stencil_banded_mxu`)
=============  ====================================================

:func:`select_kernel` resolves a :class:`DispatchPolicy` (``auto`` or an
explicit impl name) against ``(stencil, steps, backend)`` and returns a
``fused_step`` callable with the engine-facing signature
``fn(band, name, steps, keep_top=..., keep_bottom=...)``.  The backend is
``policy.backend`` when set, else the type of the device the bands live
on.  Implementation modules are imported lazily, and the kernels build
only at their first launch.

:func:`modeled_kernel_time` is the tuner's hook: the Sec. III kernel term
specialised per implementation (per-step device-memory streaming for the
reference path, tile-apron overhead and copy/compute (non-)overlap for the
CUDA kernels, the tensor-core FLOP of the banded recast for ``mxu``), fed
by a :class:`~repro_torch.core.analytic.Hardware` or by the rates a
:class:`~repro_torch.core.calibrate.DeviceProfile` measured.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.analytic import H100_SXM
from repro_torch.core.stencil import Stencil, get_stencil
from repro_torch.kernels import (
    BAND_CUDA_TILE, CUDA_TILE, DB_CUDA_TILE, MXU_CUDA_TILE, ceil_div)

__all__ = [
    "DispatchPolicy", "KernelImpl", "KERNEL_IMPLS",
    "register_kernel_impl", "select_kernel", "modeled_kernel_time",
    "kernel_op_features",
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
    default_tile: Tuple[int, int] = CUDA_TILE
    smem_buffers: int = 0    # apron'd tiles a block holds in shared memory


def _make_reference(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.core.reference import multi_step_band

    return multi_step_band


def _make_cuda(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.kernels.stencil_multistep import fused_stencil_band

    tile = policy.tile or BAND_CUDA_TILE

    def step(band, name, steps, keep_top=False, keep_bottom=False):
        return fused_stencil_band(band, name, steps, keep_top=keep_top,
                                  keep_bottom=keep_bottom, tile=tile)

    return step


def _make_cuda_db(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.kernels.stencil_multistep_db import fused_stencil_band_db

    tile = policy.tile or DB_CUDA_TILE

    def step(band, name, steps, keep_top=False, keep_bottom=False):
        return fused_stencil_band_db(band, name, steps, keep_top=keep_top,
                                     keep_bottom=keep_bottom, tile=tile)

    return step


def _make_mxu(policy: DispatchPolicy) -> FusedStep:
    from repro_torch.kernels.stencil_banded_mxu import banded_fused_stencil

    tile = policy.tile or MXU_CUDA_TILE

    def step(band, name, steps, keep_top=False, keep_bottom=False):
        return banded_fused_stencil(band, name, steps, keep_top=keep_top,
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
    description="k_on-step CUDA kernel, one CTA per tile loaded by TMA",
    make=_make_cuda,
    supports=_is_2d,
    default_tile=BAND_CUDA_TILE,
    smem_buffers=2,
))
register_kernel_impl(KernelImpl(
    name="cuda_db",
    description="persistent CUDA kernel with a two-slot cp.async ring",
    make=_make_cuda_db,
    supports=_is_2d,
    default_tile=DB_CUDA_TILE,
    smem_buffers=3,
))
register_kernel_impl(KernelImpl(
    name="mxu",
    description="banded products on the tensor cores, 3xTF32 (linear stencils)",
    make=_make_mxu,
    supports=lambda st, steps: st.is_linear and st.ndim == 2,
    default_tile=MXU_CUDA_TILE,
    smem_buffers=2,
))


def _auto_impl(st: Stencil, backend: str) -> str:
    if backend == "cuda" and st.ndim == 2:
        # the TPU's rule with the H100's data-sheet rates: the banded
        # tensor-core recast iff it wins the napkin count, else the
        # persistent kernel.  With these rates mxu wins for no registry
        # stencil; a calibrated profile prices both in tune().
        from repro_torch.kernels.stencil_banded_mxu import mxu_wins

        if st.is_linear and mxu_wins(st, tx=128, vpu=H100_SXM.peak_vpu_flops,
                                     mxu=H100_SXM.peak_mxu_flops):
            return "mxu"
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

    ``policy.impl == "auto"`` picks per backend: on CUDA the banded
    kernel when ``mxu_wins`` with the H100's rates, else the persistent
    kernel, for 2-D stencils; the plain path everywhere else.  The
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


# --------------------------------------------------------------- modeling


def _clamped_tile(impl: KernelImpl, tile, h_out: int, X: int) -> Tuple[int, int]:
    ty, tx = tile or impl.default_tile
    return min(ty, h_out), min(tx, X)


def kernel_op_features(impl_name: str, st, shape_in, steps: int,
                       keep_lo, keep_hi, itemsize: int,
                       hw=None, tile: Optional[Tuple[int, int]] = None):
    """Model features of ONE fused call under one implementation.

    Returns ``(mem_bytes, vpu_flops, mxu_flops)`` — the raw quantities
    the Sec. III kernel term divides by hardware rates — or ``None``
    when the implementation is infeasible for this geometry
    (unsupported stencil, a non-banded op on a tiled 2-D kernel, or an
    apron'd tile set exceeding ``hw.c_vmem``, read as the shared memory
    of one block, when ``hw`` is given).  The calibration harness
    (:mod:`repro_torch.core.calibrate`) fits measured times against the
    same features, so fitted rates mean exactly what the model charges.

    Per-impl memory terms:

    * ``reference`` — no on-chip reuse across fused steps: every step
      streams the band through device memory once (read + write);
    * ``cuda`` / ``cuda_db`` / ``mxu`` — one apron'd tile read per
      output tile plus one exact band write per fused call.
    """
    impl = KERNEL_IMPLS[impl_name]
    if not impl.supports(st, steps):
        return None
    r, m = st.radius, steps
    from repro_torch.core.plan import fused_box_geometry

    shape_out, _, flops, elements = fused_box_geometry(
        r, st.flops_per_elem, shape_in, m, keep_lo, keep_hi, itemsize)
    mem_bytes = 0.0
    mxu_flops = 0.0
    banded = len(shape_in) == 2 and keep_lo[1] and keep_hi[1]
    if impl_name == "reference":
        cur = list(shape_in)
        for _ in range(m):
            nxt = [c - 2 * r + (int(kl) + int(kh)) * r
                   for c, kl, kh in zip(cur, keep_lo, keep_hi)]
            mem_bytes += (math.prod(cur) + math.prod(nxt)) * itemsize
            cur = nxt
    elif not banded:
        # the tiled 2-D kernels only run classic row bands
        return None
    else:
        h_out, width = shape_out[0], shape_in[1]
        ty, tx = _clamped_tile(impl, tile, h_out, width)
        if ty <= 0 or tx <= 0:
            return None
        apron_bytes = (ty + 2 * m * r) * (tx + 2 * m * r) * itemsize
        c_vmem = getattr(hw, "c_vmem", 0) if hw is not None else 0
        if c_vmem and apron_bytes * impl.smem_buffers > c_vmem:
            return None
        n_tiles = ceil_div(h_out, ty) * ceil_div(width, tx)
        mem_bytes += n_tiles * apron_bytes + h_out * width * itemsize
        if impl_name == "mxu":
            n = 2 * r + 1
            mxu_flops += elements * n * 2 * (tx + 2 * r)
    return mem_bytes, float(flops), mxu_flops


def _profiled_rates(hw, impl_name: str, profile):
    """Hardware rates for one impl, overridden by a fitted
    :class:`~repro_torch.core.calibrate.DeviceProfile` when it carries
    terms for that impl (anything with ``kernel_terms``)."""
    bw, vpu, mxu = hw.bw_dmem, hw.peak_vpu_flops, hw.peak_mxu_flops
    terms = getattr(profile, "kernel_terms", None)
    if terms and impl_name in terms:
        t = terms[impl_name]
        bw = t.get("bw_eff", bw)
        if impl_name == "mxu":
            mxu = t.get("flops_eff", mxu)
        else:
            vpu = t.get("flops_eff", vpu)
    return bw, vpu, mxu


def modeled_kernel_time(plan, hw, impl_name: str,
                        tile: Optional[Tuple[int, int]] = None,
                        profile=None):
    """Sec. III kernel term specialised per implementation.

    Walks the plan's FusedKernel ops, sums their
    :func:`kernel_op_features`, and returns ``(kernel_s, mem_s,
    compute_s)`` — or ``None`` when the implementation is infeasible for
    this plan.  ``profile`` replaces the hardware's rates with this
    impl's measured ones when it carries a fit for it.

    Overlap per impl: ``reference``, ``cuda_db`` and ``mxu`` hide the
    copies under compute (``max``: the persistent kernels load the next
    tile while computing the current one); the one-CTA-per-tile ``cuda``
    serialises them (``sum``).
    """
    if impl_name not in KERNEL_IMPLS:
        raise KeyError(
            f"unknown kernel impl {impl_name!r}; known: {sorted(KERNEL_IMPLS)}")
    mem_bytes = 0.0
    vpu_flops = 0.0
    mxu_flops = 0.0
    itemsize = plan.itemsize
    for op in plan.ops:
        if type(op).__name__ != "FusedKernel":
            continue
        st = get_stencil(op.stencil)
        feats = kernel_op_features(impl_name, st, op.shape_in, op.steps,
                                   op.keep_lo, op.keep_hi, itemsize,
                                   hw=hw, tile=tile)
        if feats is None:
            return None
        mem_bytes += feats[0]
        vpu_flops += feats[1]
        mxu_flops += feats[2]
    bw_dmem, peak_vpu, peak_mxu = _profiled_rates(hw, impl_name, profile)
    if impl_name == "mxu":
        compute_s = mxu_flops / peak_mxu
    else:
        compute_s = vpu_flops / peak_vpu
    mem_s = mem_bytes / bw_dmem
    if impl_name in ("reference", "cuda_db", "mxu"):
        kernel_s = max(mem_s, compute_s)
    else:
        kernel_s = mem_s + compute_s
    return kernel_s, mem_s, compute_s
