"""Measured-cost calibration: fit the Sec. III model to this device (port
of :mod:`repro.core.calibrate`).

The analytic model (:mod:`repro_torch.core.analytic`) and the per-impl
kernel terms (:func:`repro_torch.kernels.dispatch.modeled_kernel_time`)
run on hand-entered :class:`~repro_torch.core.analytic.Hardware`
constants — for the H100, data-sheet values.  This module runs kernel,
transfer and codec microbenchmarks on a device, least-squares-fits the
model terms, and persists them as a versioned :class:`DeviceProfile`
that drops in anywhere a ``Hardware`` is accepted (the tuner,
:func:`repro_torch.core.tune.tune`).  The profile JSON has the JAX
package's schema: a profile written by either package loads in the other.

Fits, all on the device the caller names (``device=None`` means
``cuda``):

* **interconnect** — host->device and device->host copies from
  page-locked host memory over a size ladder fit ``t = t_lat + bytes /
  bw``;
* **off-chip memory** — ``a + 1`` on the device fits
  ``t = t0 + 2 * bytes / bw_dmem``;
* **kernel terms, per impl** — fused-step calls through
  :func:`~repro_torch.kernels.dispatch.select_kernel` over a band ladder
  fit ``t ~= mem_bytes / bw_eff + flops / flops_eff``;
* **codec throughput** — host-side encode/decode over a size ladder.

Every call is timed on the host clock between two
``torch.cuda.synchronize()`` calls (best of ``iters`` after a warm-up),
so a time is the device's work plus one launch.  Every fit records its
relative RMS residual.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .analytic import H100_SXM, Hardware
from .device import resolve_device

__all__ = [
    "DeviceProfile", "ProfileError", "backend_fingerprint",
    "fit_affine", "fit_two_term",
    "measure_interconnect", "measure_dmem", "measure_kernel_impl",
    "measure_codec", "calibrate", "resolve_hardware",
    "PROFILE_SCHEMA_VERSION",
]

PROFILE_SCHEMA_VERSION = 1

# floors applied after fitting: a degenerate microbenchmark (timer
# granularity, empty ladder) must still produce a *loadable* profile
_MIN_RATE = 1.0          # bytes/s or flop/s — strictly positive terms
_EPS_T = 1e-9            # seconds; guards zero-division on fast timers


class ProfileError(ValueError):
    """A persisted profile is unreadable or from an unknown schema."""


# --------------------------------------------------------------- fitting


def fit_affine(xs: Sequence[float], ts: Sequence[float],
               ) -> Tuple[float, float, float]:
    """Least-squares fit of ``t = t0 + x / rate``.

    Returns ``(t0, rate, residual)`` with ``t0 >= 0`` and ``rate > 0``:
    a non-positive slope (noise on a too-small ladder) falls back to the
    zero-intercept fit ``rate = sum(x*t) / sum(x*x)``; the residual is
    the relative RMS error of the clamped fit over the sample."""
    xs = np.asarray(xs, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    if xs.size == 0:
        raise ValueError("fit_affine needs at least one sample")
    A = np.stack([np.ones_like(xs), xs], axis=1)
    (t0, slope), *_ = np.linalg.lstsq(A, ts, rcond=None)
    if slope <= 0 or t0 < 0:
        slope = float(np.dot(xs, ts) / max(np.dot(xs, xs), _EPS_T))
        t0 = 0.0
    slope = max(slope, 1.0 / 1e18)          # rate ceiling 1e18 units/s
    rate = 1.0 / slope
    pred = t0 + xs * slope
    resid = _rel_rms(pred, ts)
    return float(t0), float(rate), resid


def fit_two_term(m1: Sequence[float], m2: Sequence[float],
                 ts: Sequence[float]) -> Tuple[float, float, float]:
    """Least-squares fit of ``t = m1 / rate1 + m2 / rate2``.

    The additive form is the fittable surrogate of the roofline
    ``max(mem, compute)``.  Negative coefficients — collinear features
    on a small ladder — fall back to the dominant single term, with the
    other rate pinned effectively infinite.  Returns
    ``(rate1, rate2, residual)``, both rates strictly positive."""
    m1 = np.asarray(m1, dtype=np.float64)
    m2 = np.asarray(m2, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    if m1.size == 0:
        raise ValueError("fit_two_term needs at least one sample")
    A = np.stack([m1, m2], axis=1)
    coef, *_ = np.linalg.lstsq(A, ts, rcond=None)
    if np.any(coef <= 0):
        c1 = float(np.dot(m1, ts) / max(np.dot(m1, m1), _EPS_T))
        c2 = float(np.dot(m2, ts) / max(np.dot(m2, m2), _EPS_T))
        e1 = _rel_rms(m1 * c1, ts)
        e2 = _rel_rms(m2 * c2, ts)
        coef = np.array([c1, 1e-18] if e1 <= e2 else [1e-18, c2])
    coef = np.maximum(coef, 1e-18)
    pred = A @ coef
    resid = _rel_rms(pred, ts)
    return float(1.0 / coef[0]), float(1.0 / coef[1]), resid


def _rel_rms(pred: np.ndarray, ts: np.ndarray) -> float:
    err = (pred - ts) / np.maximum(np.abs(ts), _EPS_T)
    return float(np.sqrt(np.mean(err * err)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn, iters: int, device: torch.device) -> float:
    """Minimum wall clock over ``iters`` calls (after one warm-up), each
    between two device synchronisations."""
    fn()
    best = math.inf
    for _ in range(max(iters, 1)):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return max(best, _EPS_T)


# --------------------------------------------------------- measurements


def backend_fingerprint(device=None) -> Dict[str, object]:
    """Identity of the device a profile was measured on — enough to
    refuse a stale profile on a different machine class."""
    import platform

    dev = resolve_device(device)
    fp: Dict[str, object] = {
        "backend": dev.type,
        "torch_version": torch.__version__,
        "numpy_version": np.__version__,
        "machine": platform.machine(),
        "python": platform.python_version(),
    }
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        fp.update(
            device_kind=torch.cuda.get_device_name(idx),
            capability=list(torch.cuda.get_device_capability(idx)),
            device_count=torch.cuda.device_count(),
            cuda_version=torch.version.cuda)
    else:
        fp.update(device_kind=platform.processor() or platform.machine(),
                  device_count=1)
    return fp


def measure_interconnect(sizes: Sequence[int], iters: int = 3,
                         seed: int = 0, device=None,
                         ) -> List[Tuple[int, float, float]]:
    """Host->device and device->host copies per payload size, from and
    into page-locked host memory on CUDA (a memcpy on the CPU).

    Returns ``(nbytes, t_h2d, t_d2h)`` per rung."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    out = []
    for nbytes in sizes:
        n = max(int(nbytes) // 4, 1)
        host = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        if pin:
            host = host.pin_memory()
        back = torch.empty_like(host, pin_memory=pin)
        t_h2d = _best_of(lambda: host.to(dev, non_blocking=pin, copy=True),
                         iters, dev)
        xd = host.to(dev, copy=True)
        t_d2h = _best_of(lambda: back.copy_(xd, non_blocking=pin), iters, dev)
        out.append((n * 4, t_h2d, t_d2h))
        del host, back, xd
    return out


def measure_dmem(sizes: Sequence[int], iters: int = 3, seed: int = 0,
                 device=None) -> List[Tuple[int, float]]:
    """Device-side streaming (one read + one write of ``nbytes``):
    ``a + 1`` on the device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = []
    for nbytes in sizes:
        n = max(int(nbytes) // 4, 1)
        xd = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
            dev)
        t = _best_of(lambda: xd + 1.0, iters, dev)
        out.append((n * 4, t))
        del xd
    return out


def measure_kernel_impl(impl: str, stencil: str,
                        bands: Sequence[Tuple[int, int]],
                        steps_grid: Sequence[int], iters: int = 2,
                        seed: int = 0, device=None,
                        ) -> List[Tuple[float, float, float]]:
    """Fused-step time per (band, steps) point for one registered kernel
    implementation, called through
    :func:`~repro_torch.kernels.dispatch.select_kernel` on the device.

    Returns ``(mem_bytes, flops, t)`` samples whose features come from
    :func:`~repro_torch.kernels.dispatch.kernel_op_features` — the
    quantities :func:`~repro_torch.kernels.dispatch.modeled_kernel_time`
    charges for this impl — so the fitted rates plug straight back into
    the model."""
    from repro_torch.core.stencil import get_stencil
    from repro_torch.kernels.dispatch import (
        DispatchPolicy, kernel_op_features, select_kernel,
    )

    dev = resolve_device(device)
    st = get_stencil(stencil)
    _, fused = select_kernel(st, max(steps_grid), DispatchPolicy(impl=impl),
                             device=dev)
    rng = np.random.default_rng(seed)
    out = []
    for h, w in bands:
        band = torch.from_numpy(
            rng.standard_normal((h, w)).astype(np.float32)).to(dev)
        for steps in steps_grid:
            if h <= 2 * st.radius * steps:
                continue
            feats = kernel_op_features(impl, st, (h, w), steps,
                                       (False, True), (False, True), 4)
            if feats is None:
                continue
            mem_bytes, vpu_flops, mxu_flops = feats
            flops = mxu_flops if impl == "mxu" else vpu_flops
            t = _best_of(lambda: fused(band, st.name, steps,
                                       keep_top=False, keep_bottom=False),
                         iters, dev)
            out.append((float(mem_bytes), float(flops), t))
        del band
    return out


def measure_codec(codec: str, sizes: Sequence[int], iters: int = 2,
                  seed: int = 0) -> List[Tuple[int, float, float]]:
    """Encode/decode wall clock per payload size for one registered
    transfer codec (host-side numpy).  Returns
    ``(nbytes, t_encode, t_decode)``."""
    from .compress import get_codec

    host = torch.device("cpu")
    c = get_codec(codec)
    rng = np.random.default_rng(seed)
    out = []
    for nbytes in sizes:
        rows = max(int(nbytes) // (4 * 256), 1)
        arr = rng.standard_normal((rows, 256)).astype(np.float32)
        # stencil payloads are smooth-ish; zrle's win depends on it
        arr = np.cumsum(arr, axis=1) * 1e-3
        t_enc = _best_of(lambda: c.encode(arr), iters, host)
        payload = c.encode(arr)
        t_dec = _best_of(
            lambda: c.decode(payload, arr.shape, arr.dtype), iters, host)
        out.append((arr.nbytes, t_enc, t_dec))
    return out


# ----------------------------------------------------------- the profile


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A versioned, persisted set of fitted model terms for one device.

    Everything is JSON-native so ``save``/``load`` round-trips
    bit-exactly.  ``hardware`` holds a complete
    :class:`~repro_torch.core.analytic.Hardware` field dict — measured
    terms fitted, unmeasured ones inherited from ``base_hardware`` — so
    :meth:`as_hardware` is a drop-in anywhere the model takes hardware
    constants.  ``kernel_terms`` and ``codec_throughput`` carry the
    per-impl / per-codec fits the tuner consumes on top."""

    profile_id: str
    fingerprint: Dict[str, object]
    hardware: Dict[str, object]
    kernel_terms: Dict[str, Dict[str, float]]
    codec_throughput: Dict[str, Dict[str, float]]
    residuals: Dict[str, float]
    created_at: str
    base_hardware: str
    schema_version: int = PROFILE_SCHEMA_VERSION

    def as_hardware(self) -> Hardware:
        return Hardware(**self.hardware)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True) + "\n"

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "DeviceProfile":
        version = d.get("schema_version")
        if version != PROFILE_SCHEMA_VERSION:
            raise ProfileError(
                f"unsupported profile schema_version {version!r} "
                f"(this build reads {PROFILE_SCHEMA_VERSION})")
        fields = {f.name for f in dataclasses.fields(cls)}
        missing = fields - set(d)
        if missing:
            raise ProfileError(f"profile missing fields: {sorted(missing)}")
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def load(cls, path: str) -> "DeviceProfile":
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ProfileError(f"cannot read profile {path!r}: {e}") from e
        if not isinstance(d, dict):
            raise ProfileError(f"profile {path!r} is not a JSON object")
        return cls.from_dict(d)


def resolve_hardware(hw: Union[Hardware, DeviceProfile, str, None],
                     default: Hardware = H100_SXM) -> Hardware:
    """Coerce anything a ``hw=``/``profile=`` argument accepts into a
    :class:`Hardware`: an existing ``Hardware`` passes through, a
    :class:`DeviceProfile` contributes its fitted constants, a string is
    a profile path, ``None`` yields ``default``."""
    if hw is None:
        return default
    if isinstance(hw, Hardware):
        return hw
    if isinstance(hw, DeviceProfile):
        return hw.as_hardware()
    if isinstance(hw, str):
        return DeviceProfile.load(hw).as_hardware()
    raise TypeError(
        f"expected Hardware, DeviceProfile, profile path, or None; "
        f"got {type(hw).__name__}")


# -------------------------------------------------------- the harness

# microbenchmark ladders: quick mode stays CPU-sized (seconds end to
# end); full mode is sized for the card — bands up to 4098 x 8194 fp32
# (134 MB, past the 50 MB L2) so the kernel fits see device-memory rates
# and not launch overhead alone
_QUICK = dict(
    transfer_sizes=(1 << 20, 4 << 20, 16 << 20),
    dmem_sizes=(4 << 20, 16 << 20, 64 << 20),
    kernel_bands=((130, 258), (258, 258), (258, 514)),
    kernel_steps=(1, 2, 4),
    kernel_impls=("reference",),
    codec_sizes=(1 << 18, 1 << 20),
    codecs=("identity", "bf16", "zrle"),
    iters=2,
)
_FULL = dict(
    transfer_sizes=(1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20),
    dmem_sizes=(4 << 20, 16 << 20, 64 << 20, 256 << 20),
    kernel_bands=((258, 1026), (1026, 2050), (2050, 4098), (4098, 8194)),
    kernel_steps=(1, 2, 4, 8),
    kernel_impls=("reference", "cuda", "cuda_db", "mxu"),
    codec_sizes=(1 << 18, 1 << 20, 4 << 20),
    codecs=("identity", "bf16", "zrle"),
    iters=3,
)


def _utc_stamp() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def calibrate(quick: bool = True,
              base_hw: Hardware = H100_SXM,
              stencil: str = "box2d1r",
              kernel_impls: Optional[Iterable[str]] = None,
              seed: int = 0,
              progress=None,
              device=None) -> DeviceProfile:
    """Run the microbenchmark suite on ``device`` (None means ``cuda``)
    and fit a :class:`DeviceProfile`.

    ``quick`` trims the size ladders to CPU scale.  ``base_hw`` donates
    the constants no microbenchmark here measures (memory capacities,
    the tensor-core peak, shared memory per block); everything the
    Sec. III model prices transfers and kernels with — ``bw_intc``,
    ``bw_dmem``, ``peak_vpu_flops``, ``t_ici_latency`` and the per-impl
    kernel rates — is fitted.  ``progress`` (callable taking one string)
    narrates long runs."""
    dev = resolve_device(device)
    cfg = dict(_QUICK if quick else _FULL)
    if kernel_impls is not None:
        cfg["kernel_impls"] = tuple(kernel_impls)
    say = progress or (lambda msg: None)
    residuals: Dict[str, float] = {}

    say("measuring interconnect")
    xfer = measure_interconnect(cfg["transfer_sizes"], cfg["iters"], seed,
                                device=dev)
    nbytes = [s[0] for s in xfer]
    lat_h2d, bw_h2d, r_h2d = fit_affine(nbytes, [s[1] for s in xfer])
    lat_d2h, bw_d2h, r_d2h = fit_affine(nbytes, [s[2] for s in xfer])
    bw_intc = max(min(bw_h2d, bw_d2h), _MIN_RATE)
    # the launch-latency intercept doubles as the collective-phase
    # latency proxy
    t_lat = max(lat_h2d, lat_d2h, 0.0)
    residuals["interconnect_h2d"] = r_h2d
    residuals["interconnect_d2h"] = r_d2h

    say("measuring off-chip memory")
    dmem = measure_dmem(cfg["dmem_sizes"], cfg["iters"], seed, device=dev)
    _, bw_stream, r_dmem = fit_affine(
        [2 * s[0] for s in dmem], [s[1] for s in dmem])
    bw_dmem = max(bw_stream, _MIN_RATE)
    residuals["dmem"] = r_dmem

    kernel_terms: Dict[str, Dict[str, float]] = {}
    peak_vpu = base_hw.peak_vpu_flops
    for impl in cfg["kernel_impls"]:
        say(f"measuring kernel impl {impl!r}")
        pts = measure_kernel_impl(impl, stencil, cfg["kernel_bands"],
                                  cfg["kernel_steps"], cfg["iters"], seed,
                                  device=dev)
        if not pts:
            continue
        bw_eff, flops_eff, resid = fit_two_term(
            [p[0] for p in pts], [p[1] for p in pts], [p[2] for p in pts])
        kernel_terms[impl] = {
            "bw_eff": max(bw_eff, _MIN_RATE),
            "flops_eff": max(flops_eff, _MIN_RATE),
            "residual": resid,
            "n_points": len(pts),
        }
        residuals[f"kernel_{impl}"] = resid
    if "reference" in kernel_terms:
        # the plain path's fitted FLOP rate is the backend-wide vector
        # estimate for the generic roofline terms (as in the JAX package)
        peak_vpu = kernel_terms["reference"]["flops_eff"]

    codec_tp: Dict[str, Dict[str, float]] = {}
    for codec in cfg["codecs"]:
        say(f"measuring codec {codec!r}")
        pts = measure_codec(codec, cfg["codec_sizes"], cfg["iters"], seed)
        nb = [p[0] for p in pts]
        _, enc_bps, r_enc = fit_affine(nb, [p[1] for p in pts])
        _, dec_bps, r_dec = fit_affine(nb, [p[2] for p in pts])
        resid = max(r_enc, r_dec)
        codec_tp[codec] = {
            "encode_bps": max(enc_bps, _MIN_RATE),
            "decode_bps": max(dec_bps, _MIN_RATE),
            "residual": resid,
        }
        residuals[f"codec_{codec}"] = resid

    fp = backend_fingerprint(dev)
    hw = dataclasses.replace(
        base_hw,
        name=f"calibrated-{fp['backend']}",
        bw_intc=bw_intc,
        bw_dmem=bw_dmem,
        peak_vpu_flops=max(peak_vpu, _MIN_RATE),
        t_ici_latency=t_lat,
    )
    digest = hashlib.sha256(
        json.dumps(fp, sort_keys=True).encode()).hexdigest()[:10]
    return DeviceProfile(
        profile_id=f"{fp['backend']}-{digest}",
        fingerprint=fp,
        hardware=dataclasses.asdict(hw),
        kernel_terms=kernel_terms,
        codec_throughput=codec_tp,
        residuals=residuals,
        created_at=_utc_stamp(),
        base_hardware=base_hw.name,
    )
