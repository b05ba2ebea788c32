"""Analytic performance model (paper Sec. III) with hardware constants
(port of :mod:`repro.core.analytic`).

The paper's bottleneck model::

    T_tot ∝ max( D_chk / BW_intc,
                 (D_chk + W_halo * S_TB) / BW_dmem * S_TB )

generalizes per engine via the :class:`TransferStats` of a compiled plan.
The model's inputs are exact plan byte counts; its rates are hardware
constants — data-sheet values until :func:`repro_torch.core.calibrate.
calibrate` fits them on the card.

The compute term uses ``peak_vpu_flops`` (neighbour FMAs are vector ops
on the CUDA cores); ``peak_mxu_flops`` prices the banded tensor-core
kernel (``mxu``).
"""
from __future__ import annotations

import dataclasses

__all__ = ["Hardware", "TPU_V5E", "RTX3080_PAPER", "H100_SXM", "EngineTimes",
           "model_times", "times_from_plan"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    bw_intc: float        # host<->device interconnect, bytes/s
    bw_dmem: float        # off-chip (device/HBM) memory, bytes/s
    c_dmem: int           # off-chip capacity, bytes
    peak_vpu_flops: float  # vector unit peak (stencil FMAs), FLOP/s
    peak_mxu_flops: float  # matrix unit peak, FLOP/s
    bw_ici: float = 0.0   # per-link inter-chip interconnect, bytes/s
    n_streams: int = 3    # paper fixes N_strm = 3 (double buffering + compute)
    c_vmem: int = 0       # on-chip scratch (VMEM/shared mem), bytes; 0 = unmodeled
    t_ici_latency: float = 0.0  # per collective phase launch overhead, s
    c_dev: int = 0        # per-device working-set budget, bytes; 0 = c_dmem

    def __post_init__(self):
        if self.c_dev == 0:
            object.__setattr__(self, "c_dev", self.c_dmem)


# The paper's experimental machine (Table II) — used to sanity-check the
# model against the paper's own reported numbers.
RTX3080_PAPER = Hardware(
    name="rtx3080-pcie3",
    bw_intc=12.0e9,          # PCIe gen3 x16 effective
    bw_dmem=760.0e9,
    c_dmem=10 * 1024**3,
    peak_vpu_flops=29.8e12,  # fp32 CUDA-core peak
    peak_mxu_flops=119e12,   # TC fp16 (unused for stencils)
)

# The JAX package's TPU target; kept verbatim for the parity tests.
TPU_V5E = Hardware(
    name="tpu-v5e",
    bw_intc=25.0e9,
    bw_dmem=819.0e9,
    c_dmem=16 * 1024**3,
    peak_vpu_flops=3.9e12,
    peak_mxu_flops=197.0e12,
    bw_ici=50.0e9,
    c_vmem=128 * 1024**2,
    t_ici_latency=1e-5,
)

# The port's card, from NVIDIA's H100 SXM data sheet at the 700 W limit.
# Every value is unmeasured until calibrated: calibrate() fits bw_intc,
# bw_dmem, peak_vpu_flops and the per-kernel rates on the card itself.
H100_SXM = Hardware(
    name="h100-sxm",
    bw_intc=64.0e9,          # PCIe Gen5 x16, per direction (data sheet);
                             # page-locked copies measured 50-55 GB/s
    bw_dmem=3.35e12,         # HBM3
    c_dmem=80 * 10**9,       # 80 GB
    peak_vpu_flops=67e12,    # fp32 on the CUDA cores
    # the rate the banded kernel's fp32 path can reach: dense TF32 on the
    # tensor cores (494.7 TFLOP/s) over the three products of 3xTF32
    peak_mxu_flops=494.7e12 / 3,
    c_vmem=232448,           # shared memory one block can use (227 KB)
    # NVLink 4: 900 GB/s per GPU, both directions together (data sheet);
    # the sharded model charges one rank's sends per round against it.
    # No data-sheet latency: t_ici_latency stays 0 until calibrated.
    bw_ici=450e9,
)


@dataclasses.dataclass(frozen=True)
class EngineTimes:
    """Modeled phase times, seconds (paper Fig. 7 breakdown categories)."""

    h2d: float
    d2h: float
    odc: float      # on-device copies (region-sharing buffer traffic)
    kernel: float
    kernel_mem: float      # HBM-traffic component of the kernel phase
    kernel_compute: float  # vector-unit component of the kernel phase

    @property
    def total_serial(self) -> float:
        return self.h2d + self.d2h + self.odc + self.kernel

    def total_overlapped(self, n_streams: int = 3) -> float:
        """With >=3 streams, copies overlap kernels (paper Sec. II/V.D):
        the pipeline settles at max(transfer, kernel+odc)."""
        if n_streams >= 3:
            return max(self.h2d + self.d2h, self.kernel + self.odc)
        if n_streams == 2:
            return max(self.h2d, self.d2h + self.kernel + self.odc)
        return self.total_serial


def model_times(stats, hw: Hardware) -> EngineTimes:
    """Convert a plan's :class:`TransferStats` into modeled phase times.

    Kernel phase: ``kernel_mem = hbm_bytes / bw_dmem``, compute
    ``flops / peak_vpu``, ``kernel = max(mem, compute)`` (the roofline).
    Transfers are charged at *wire* bytes (after a codec); hand-built
    stats that never set the wire fields fall back to raw bytes."""
    h2d_wire = getattr(stats, "h2d_wire_bytes", 0) or stats.h2d_bytes
    d2h_wire = getattr(stats, "d2h_wire_bytes", 0) or stats.d2h_bytes
    k_mem = stats.kernel_hbm_bytes / hw.bw_dmem
    k_cmp = stats.flops / hw.peak_vpu_flops
    return EngineTimes(
        h2d=h2d_wire / hw.bw_intc,
        d2h=d2h_wire / hw.bw_intc,
        odc=stats.buffer_bytes / hw.bw_dmem,
        kernel=max(k_mem, k_cmp),
        kernel_mem=k_mem,
        kernel_compute=k_cmp,
    )


def times_from_plan(plan, hw: Hardware) -> EngineTimes:
    """Model phase times straight off a compiled
    :class:`~repro_torch.core.plan.ExecutionPlan`."""
    return model_times(plan.stats(), hw)
