"""One tuner entry point: ``tune(spec, profile=..., budget=...)`` (port
of :mod:`repro.core.tune`).

* :class:`TuneSpec` — what to tune: framed domain shape, stencil, step
  count, optional mesh, and the candidate domains (engine/codec/impl
  grids).  The mode is inferred (``mesh`` set -> sharded, non-2-D shape
  or a ``box_tb`` engine -> box, else row).
* :class:`TuneResult` — one ranked candidate, spelled identically for
  every mode: a unified ``config`` dict, the modeled time, and — when
  measured refinement ran — the measured time, the model-vs-measured
  error, and the id of the :class:`~repro_torch.core.calibrate.
  DeviceProfile` that priced it.

``tune`` ranks the candidate set on dry-run plans, then optionally
*refines* the top ``budget`` candidates with short measured runs on
bucketed small domains on the caller's device: **model proposes,
hardware disposes**.  A candidate is only promoted over the modeled
incumbent when its measured time is no worse than the incumbent's
measured time.  The sharded mode ranks mesh x ``k_ici`` (x halo codec)
on sharded dry-run plans and stays modeled: its refinement would need a
real mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

from .analytic import EngineTimes, Hardware, model_times
from .autotune import (
    BoxChoice, Choice, ShardedChoice,
    _autotune, _autotune_box, _autotune_sharded,
)
from .calibrate import DeviceProfile, resolve_hardware
from .lower import ExecStats

__all__ = ["TuneSpec", "TuneResult", "tune"]


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """What to tune, in one spelling for every plan family.

    ``shape`` is always the *framed* domain — an int means a square.
    ``mesh`` switches to the sharded (L2) sweep: an int sweeps every
    ``(rows, cols)`` factorization of that many devices, a tuple pins
    the decomposition.  The grid fields are candidate *domains*; modes
    ignore the grids that do not apply to them (a box sweep reads
    ``box_tile_grid``/``time_depth_grid``, a sharded sweep reads
    ``k_ici_grid`` plus ``codecs`` for the halo wire, the row sweep
    reads the rest)."""

    stencil: str
    shape: Union[int, Tuple[int, ...]]
    steps: int
    mesh: Optional[Union[int, Tuple[int, int]]] = None
    engines: Tuple[str, ...] = ("so2dr", "resreu")
    d_grid: Tuple[int, ...] = (4, 8, 16)
    s_tb_grid: Tuple[int, ...] = (20, 40, 80, 160, 320, 640)
    k_on_grid: Tuple[int, ...] = (1, 2, 4, 8)
    codecs: Tuple[str, ...] = ("identity", "zrle")
    kernel_impls: Tuple[str, ...] = ("reference", "cuda", "cuda_db")
    tile_grid: Tuple[Optional[tuple], ...] = (None,)
    box_tile_grid: Tuple[Tuple[int, ...], ...] = ((1, 1), (2, 2), (4, 4))
    time_depth_grid: Tuple[int, ...] = (1, 2, 4)
    k_ici_grid: Tuple[int, ...] = (1, 2, 4, 8)
    b_elem: int = 4

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        shape = self.framed_shape
        if not shape or any(s < 1 for s in shape):
            raise ValueError(f"bad framed shape {shape}")
        if isinstance(self.mesh, tuple) and (
                len(self.mesh) != 2 or any(m < 1 for m in self.mesh)):
            raise ValueError(f"mesh must be (rows, cols), got {self.mesh}")

    @property
    def framed_shape(self) -> Tuple[int, ...]:
        if isinstance(self.shape, int):
            return (self.shape, self.shape)
        return tuple(int(s) for s in self.shape)

    @property
    def n_devices(self) -> Optional[int]:
        if self.mesh is None:
            return None
        return self.mesh if isinstance(self.mesh, int) else math.prod(self.mesh)

    @property
    def mode(self) -> str:
        if self.mesh is not None:
            return "sharded"
        if len(self.framed_shape) != 2 or "box_tb" in self.engines:
            return "box"
        return "row"


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One ranked candidate, spelled identically for every mode.

    ``config`` always carries ``engine`` plus that engine family's knobs
    (``d``/``s_tb``/``k_on``/``codec``/``kernel_impl``/``tile`` for row
    plans, ``tiles``/``time_depth`` for box plans, ``mesh``/``k_ici``
    for sharded plans).  ``measured_s``/``model_error``/``exec_stats``
    are populated only for candidates the refinement pass actually ran;
    ``model_error`` is ``(modeled - measured) / measured`` on the same
    small domain, also mirrored into ``exec_stats.model_error``."""

    mode: str
    engine: str
    config: Dict[str, object]
    modeled_s: float
    bottleneck: str
    times: Optional[EngineTimes] = None
    measured_s: Optional[float] = None
    model_error: Optional[float] = None
    profile_id: Optional[str] = None
    exec_stats: Optional[ExecStats] = None
    extras: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_record(self) -> Dict[str, object]:
        """JSON-safe benchmark row — the one spelling replacing the
        three per-mode row formats the old sweeps emitted."""
        config = {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in self.config.items()}
        rec: Dict[str, object] = {
            "mode": self.mode,
            "engine": self.engine,
            "config": config,
            "modeled_s": self.modeled_s,
            "bottleneck": self.bottleneck,
            "measured_s": self.measured_s,
            "model_error": self.model_error,
            "profile_id": self.profile_id,
        }
        rec.update(self.extras)
        return rec


def _from_choice(c: Choice, pid: Optional[str]) -> TuneResult:
    return TuneResult(
        mode="row", engine=c.engine,
        config=dict(engine=c.engine, d=c.d, s_tb=c.s_tb, k_on=c.k_on,
                    codec=c.codec, kernel_impl=c.kernel_impl, tile=c.tile),
        modeled_s=c.time_s, bottleneck=c.bottleneck, times=c.times,
        profile_id=pid)


def _from_box(c: BoxChoice, pid: Optional[str]) -> TuneResult:
    return TuneResult(
        mode="box", engine="box_tb",
        config=dict(engine="box_tb", tiles=c.tiles, time_depth=c.time_depth,
                    k_on=c.k_on, codec=c.codec),
        modeled_s=c.time_s, bottleneck=c.bottleneck, times=c.times,
        profile_id=pid,
        extras=dict(redundant_elements=c.redundant_elements,
                    redundancy=c.redundancy))


def _from_sharded(c: ShardedChoice, pid: Optional[str]) -> TuneResult:
    return TuneResult(
        mode="sharded", engine="sharded",
        config=dict(engine="sharded", mesh=c.mesh, k_ici=c.k_ici,
                    codec=c.codec),
        modeled_s=c.time_s, bottleneck=c.bottleneck, profile_id=pid,
        extras=dict(ici_s=c.ici_s, kernel_s=c.kernel_s,
                    ici_bytes=c.ici_bytes, ici_wire_bytes=c.ici_wire_bytes,
                    redundancy=c.redundancy))


# ------------------------------------------------------- measured runs

# interior-size buckets for refinement runs: candidates measure on the
# smallest bucket their geometry compiles at, so repeated (impl, shape)
# signatures share compiled kernels across candidates
_SMALL_INTERIORS = (64, 96, 128, 192, 256)
_SMALL_STEPS = 8


def _measure_row(spec: TuneSpec, res: TuneResult, hw: Hardware, profile,
                 device=None):
    """Short measured run of one row-plan candidate on a bucketed small
    domain on ``device`` (None means ``cuda``).  Returns ``(measured_s,
    modeled_small_s, exec_stats)`` or ``None`` when no bucket admits the
    candidate's geometry."""
    import numpy as np

    from repro_torch.core.executor import get_executor
    from repro_torch.core.oocore import compile_plan
    from repro_torch.core.stencil import get_stencil
    from repro_torch.kernels.dispatch import (
        DispatchPolicy, modeled_kernel_time)

    st = get_stencil(spec.stencil)
    cfg = res.config
    steps = min(spec.steps, _SMALL_STEPS)
    s_tb = min(cfg["s_tb"], steps)
    plan = None
    for sz in _SMALL_INTERIORS:
        Y = X = sz + 2 * st.radius
        try:
            plan = compile_plan(
                cfg["engine"], st, Y, X, steps, cfg["d"], s_tb,
                cfg["k_on"], itemsize=spec.b_elem,
                codec=None if cfg["codec"] == "identity" else cfg["codec"])
            break
        except ValueError:
            plan = None
    if plan is None:
        return None
    policy = DispatchPolicy(impl=cfg["kernel_impl"], tile=cfg["tile"])
    ex = get_executor("eager", policy=policy, device=device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(plan.shape).astype(np.float32)
    ex.execute(plan, x)                    # warmup: compile + trace
    _, stats = ex.execute(plan, x)
    exec_stats = ex.exec_stats
    t = model_times(stats, hw)
    kt = modeled_kernel_time(plan, hw, cfg["kernel_impl"], cfg["tile"],
                             profile=profile)
    if kt is not None:
        t = dataclasses.replace(t, kernel=kt[0], kernel_mem=kt[1],
                                kernel_compute=kt[2])
    return exec_stats.wall_s, t.total_overlapped(hw.n_streams), exec_stats


def _measure_box(spec: TuneSpec, res: TuneResult, hw: Hardware, profile,
                 device=None):
    """Short measured run of one BoxTB candidate on a scaled-down box on
    ``device`` (None means ``cuda``)."""
    import numpy as np

    from repro_torch.core.executor import get_executor
    from repro_torch.core.oocore import compile_box_plan
    from repro_torch.core.stencil import get_stencil

    st = get_stencil(spec.stencil)
    cfg = res.config
    steps = min(spec.steps, 2 * cfg["time_depth"])
    plan = None
    for interior in (64, 128):
        shape = tuple(min(s, interior + 2 * st.radius)
                      for s in spec.framed_shape)
        try:
            plan = compile_box_plan(st, shape, steps, cfg["tiles"],
                                    cfg["time_depth"], k_on=cfg["k_on"],
                                    itemsize=spec.b_elem,
                                    codec=None if cfg["codec"] == "identity"
                                    else cfg["codec"])
            break
        except ValueError:
            plan = None
    if plan is None:
        return None
    ex = get_executor("eager", device=device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(plan.shape).astype(np.float32)
    ex.execute(plan, x)
    _, stats = ex.execute(plan, x)
    exec_stats = ex.exec_stats
    t = model_times(stats, hw)
    return exec_stats.wall_s, t.total_overlapped(hw.n_streams), exec_stats


def _default_measure(hw: Hardware, profile, device=None) -> Callable:
    def measure(spec: TuneSpec, res: TuneResult):
        if res.mode == "row":
            return _measure_row(spec, res, hw, profile, device)
        if res.mode == "box":
            return _measure_box(spec, res, hw, profile, device)
        return None   # sharded refinement needs a real mesh; stay modeled
    return measure


def _attach(res: TuneResult, measured) -> TuneResult:
    if measured is None:
        return res
    measured_s, modeled_small, exec_stats = measured
    err = (modeled_small - measured_s) / max(measured_s, 1e-12)
    if exec_stats is not None:
        exec_stats.modeled_s = modeled_small
        exec_stats.model_error = err
    return dataclasses.replace(res, measured_s=measured_s, model_error=err,
                               exec_stats=exec_stats)


def _refine(ranked: List[TuneResult], spec: TuneSpec, budget: int,
            measure: Callable) -> List[TuneResult]:
    """Measure the top ``budget`` candidates and re-rank.

    Invariant (property-tested): a candidate outranks the modeled
    incumbent only when its measured time is <= the incumbent's measured
    time.  If the incumbent itself could not be measured, the modeled
    order stands — refinement refuses to promote on one-sided
    evidence."""
    k = min(budget, len(ranked))
    head = [_attach(r, measure(spec, r)) for r in ranked[:k]]
    tail = ranked[k:]
    if not head or head[0].measured_s is None:
        return head + tail
    measured = sorted((r for r in head if r.measured_s is not None),
                      key=lambda r: r.measured_s)
    unmeasured = [r for r in head if r.measured_s is None]
    return measured + unmeasured + tail


def tune(spec: TuneSpec,
         profile: Optional[Union[DeviceProfile, str]] = None,
         budget: int = 0,
         hw: Optional[Hardware] = None,
         measure: Optional[Callable] = None,
         device=None) -> List[TuneResult]:
    """Rank every feasible configuration of ``spec`` (best first).

    ``profile`` — a :class:`~repro_torch.core.calibrate.DeviceProfile` (or a
    path to one): its fitted constants replace the hand-entered
    ``Hardware`` everywhere the model prices this sweep, its per-impl
    kernel terms feed :func:`~repro_torch.kernels.dispatch.
    modeled_kernel_time`, and its id is stamped on every result.
    ``hw`` overrides the profile's generic constants when both are
    given (the profile still contributes kernel terms + id); with
    neither, the rates are the data-sheet ``H100_SXM``.

    ``budget`` — how many of the top modeled candidates to *measure*
    with short runs on bucketed small domains; the measured candidates
    re-rank by wall clock, with per-candidate model-vs-measured error
    in ``TuneResult.model_error`` / ``exec_stats.model_error``.  0
    keeps the ranking purely modeled.  The measured runs go through the
    eager executor on ``device`` (None means ``cuda``).  ``measure``
    injects a custom measurement callable (tests)."""
    from repro_torch.core.stencil import get_stencil

    if isinstance(profile, str):
        profile = DeviceProfile.load(profile)
    hw_res = hw if hw is not None else resolve_hardware(profile)
    pid = profile.profile_id if profile is not None else None
    st = get_stencil(spec.stencil)
    mode = spec.mode
    shape = spec.framed_shape

    if mode == "row":
        if shape[0] != shape[1]:
            raise ValueError(
                f"row-mode tuning needs a square framed domain, got "
                f"{shape}; pass engines=('box_tb',) for rectangles")
        sz = shape[0] - 2 * st.radius
        choices = _autotune(
            st, sz, spec.steps, hw_res, engines=spec.engines,
            d_grid=spec.d_grid, s_tb_grid=spec.s_tb_grid,
            k_on_grid=spec.k_on_grid, codecs=spec.codecs,
            kernel_impls=spec.kernel_impls, tile_grid=spec.tile_grid,
            b_elem=spec.b_elem, profile=profile)
        ranked = [_from_choice(c, pid) for c in choices]
    elif mode == "box":
        choices = _autotune_box(
            st, shape, spec.steps, hw_res, tile_grid=spec.box_tile_grid,
            time_depth_grid=spec.time_depth_grid,
            k_on_grid=spec.k_on_grid, codecs=spec.codecs,
            b_elem=spec.b_elem)
        ranked = [_from_box(c, pid) for c in choices]
    else:
        choices = _autotune_sharded(
            st, shape[0], spec.steps, hw_res, n_devices=spec.n_devices,
            k_ici_grid=spec.k_ici_grid, codecs=spec.codecs,
            b_elem=spec.b_elem)
        if isinstance(spec.mesh, tuple):
            choices = [c for c in choices if c.mesh == spec.mesh]
        ranked = [_from_sharded(c, pid) for c in choices]

    if budget > 0 and ranked:
        measure = measure or _default_measure(hw_res, profile, device)
        ranked = _refine(ranked, spec, budget, measure)
    return ranked
