"""Pluggable executors over :class:`repro_torch.core.plan.ExecutionPlan`
(the single-device half of :mod:`repro.core.executor`, ported).

Three interpreters of the same op schedule:

* :class:`EagerExecutor` — walks ops in plan order.
* :class:`DoubleBufferedExecutor` — software-pipelined: chunk ``i+1``'s
  H2D is issued before chunk ``i``'s kernels.  On CUDA the copies run on a
  separate copy stream from the page-locked host array, under the compute
  stream's kernels — the paper's multi-stream overlap (Sec. II,
  N_strm = 3) with real CUDA streams; nothing blocks until a
  ``HostCommit`` barrier drains the staged D2H boxes.
* :class:`DryRunExecutor` — walks no device work at all and returns the
  plan-derived :class:`TransferStats`.

The device executors run plans through the lowering layer by default
(:func:`repro_torch.core.lower.lower`); ``lowered=False`` falls back to the
op-at-a-time interpreter (:class:`_DeviceState`) — results are bitwise
identical.  Every device executor takes ``device=None``, and None means
``cuda``: with no GPU the default raises instead of running on the CPU.

All executors return ``(host_array | None, TransferStats)`` where the
stats always come from :meth:`ExecutionPlan.stats`.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .compress import get_codec
from .device import resolve_device
from .lower import ExecStats, KernelCache, lower, to_device, validate_domain
from .plan import (
    BufferRead, BufferWrite, Compress, D2H, Decompress, ExecutionPlan,
    FusedKernel, H2D, HostCommit, TransferStats,
)
from .reference import multi_step_band, multi_step_box

__all__ = [
    "EagerExecutor", "DoubleBufferedExecutor", "DryRunExecutor",
    "get_executor", "EXECUTORS",
]

# fused-step implementation signature:
#   fn(band, stencil_name, steps, keep_top, keep_bottom) -> band
FusedStep = Callable[..., torch.Tensor]


class _StagedWrite:
    """One staged D2H: ``rows`` stays a device tensor until the HostCommit
    barrier, also for compressed transfers (the codec round trip runs at
    commit time).  ``pending`` is True only between a d2h-side Compress
    and its Decompress."""

    __slots__ = ("box", "rows", "codec", "pending")

    def __init__(self, box, rows, codec=None, pending=False):
        self.box = box            # destination host Box
        self.rows = rows          # device tensor
        self.codec = codec        # codec name; round trip runs at commit
        self.pending = pending


class _DeviceState:
    """Register/buffer/staging state for the op-at-a-time path.

    Codec ops run for real: H2D encodes at the Compress op (the device
    hop carries the encoded bytes) and decodes at the Decompress op; the
    D2H round trip runs at the HostCommit barrier.  The ``identity``
    codec is fast-pathed."""

    def __init__(self, host: np.ndarray, fused_step: Optional[FusedStep],
                 device: torch.device):
        self.host = host
        self.fused_step = fused_step   # None = reference (banded path only)
        self.device = device
        self.regs: Dict[str, torch.Tensor] = {}
        self.bufs: Dict[str, torch.Tensor] = {}
        self.staged: List[_StagedWrite] = []
        self.h2d_wire: Dict[str, Tuple[torch.Tensor, tuple, np.dtype]] = {}
        self.d2h_codec: Dict[str, str] = {}

    def issue_h2d(self, op: H2D) -> None:
        if op.reg in self.h2d_wire:
            return   # wire hop already happened at Compress time
        self.regs[op.reg] = to_device(self.host[op.box.slices()], self.device)

    def _compress(self, op: Compress) -> None:
        if op.codec == "identity":
            return   # fast path: the transfer op itself is the pure copy
        if op.direction == "h2d":
            rows = self.host[op.box.slices()]
            payload = get_codec(op.codec).encode(rows)
            self.h2d_wire[op.reg] = (to_device(payload, self.device),
                                     rows.shape, rows.dtype)
        else:
            self.d2h_codec[op.reg] = op.codec   # encode happens at the D2H

    def _decompress(self, op: Decompress) -> None:
        if op.codec == "identity":
            return
        if op.direction == "h2d":
            payload, shape, dtype = self.h2d_wire.pop(op.reg)
            decoded = get_codec(op.codec).decode(payload.cpu().numpy(),
                                                 shape, dtype)
            self.regs[op.reg] = to_device(decoded, self.device)
        else:
            entry = self.staged[-1]
            assert entry.pending and entry.box == op.box, \
                "Decompress does not match the staged D2H"
            entry.pending = False   # round trip scheduled; runs at commit

    def issue(self, op) -> None:
        if isinstance(op, H2D):
            self.issue_h2d(op)
        elif isinstance(op, Compress):
            self._compress(op)
        elif isinstance(op, Decompress):
            self._decompress(op)
        elif isinstance(op, BufferWrite):
            self.bufs[op.buf] = self.regs[op.reg][op.reg_box.slices()]
        elif isinstance(op, BufferRead):
            shared = self.bufs.pop(op.buf)
            self.regs[op.reg] = torch.cat(
                [shared, self.regs.pop(op.src)], dim=op.axis)
        elif isinstance(op, FusedKernel):
            band = self.regs[op.reg]
            # banded = a classic 2-D row band (full width, frame columns
            # along): the registered fused-step kernels apply.  Anything
            # else (3-D tiles, column chunks) runs the N-D reference.
            if len(op.shape_in) == 2 and op.keep_lo[1] and op.keep_hi[1]:
                fn = self.fused_step or multi_step_band
                self.regs[op.reg] = fn(
                    band, op.stencil, op.steps,
                    keep_top=op.keep_lo[0], keep_bottom=op.keep_hi[0])
            else:
                self.regs[op.reg] = multi_step_box(
                    band, op.stencil, op.steps,
                    keep_lo=op.keep_lo, keep_hi=op.keep_hi)
        elif isinstance(op, D2H):
            band = self.regs.pop(op.reg)   # last use of the register
            codec = self.d2h_codec.pop(op.reg, None)
            self.staged.append(_StagedWrite(
                op.box, rows=band[op.reg_box.slices()],
                codec=codec, pending=codec is not None))
        elif isinstance(op, HostCommit):
            self.commit()
        else:  # pragma: no cover - planner/executor version skew
            raise TypeError(f"unknown op {op!r}")

    def commit(self) -> None:
        for entry in self.staged:
            assert not entry.pending, \
                "staged D2H committed before its Decompress"
        for entry in self.staged:
            sl = entry.box.slices()
            if entry.codec is None:
                torch.from_numpy(self.host[sl]).copy_(entry.rows)
                continue
            rows = entry.rows.cpu().numpy()
            # the wire round trip: device-side encode, host-side decode
            codec = get_codec(entry.codec)
            self.host[sl] = codec.decode(codec.encode(rows), rows.shape,
                                         rows.dtype)
        self.staged.clear()


class _LoweredExecutorBase:
    """Shared compile-then-run machinery for the device executors.

    Re-entrant: the lowering memo is a keyed, locked cache;
    ``exec_stats`` is thread-local on read with a cross-thread fallback to
    the most recent run."""

    name = "base"
    _pipeline = False
    _MEMO_CAP = 64   # FIFO bound on retained (plan -> CompiledPlan) entries

    def __init__(self, fused_step: Optional[FusedStep] = None,
                 policy=None, lowered: bool = True, slot_pool=None,
                 device=None):
        self.fused_step = fused_step
        self.policy = policy
        self.lowered = lowered
        self.device = resolve_device(device)
        # kernel-signature cache shared across execute() calls
        self.kernel_cache = KernelCache()
        self.slot_pool = slot_pool
        # keyed lowering memo: id(plan) -> (plan, fused_step, policy,
        # compiled); holding the plan keeps id()/`is` identity sound
        self._lowered_memo: Dict[int, tuple] = {}
        self._memo_lock = threading.Lock()
        self._tls = threading.local()
        self._last_stats: Optional[ExecStats] = None

    @property
    def exec_stats(self) -> Optional[ExecStats]:
        stats = getattr(self._tls, "stats", None)
        return stats if stats is not None else self._last_stats

    @exec_stats.setter
    def exec_stats(self, value: Optional[ExecStats]) -> None:
        self._tls.stats = value
        self._last_stats = value

    def _compiled(self, plan: ExecutionPlan):
        key = id(plan)
        fused_step, policy = self.fused_step, self.policy
        with self._memo_lock:
            memo = self._lowered_memo.get(key)
            if (memo is not None and memo[0] is plan
                    and memo[1] is fused_step and memo[2] == policy):
                return memo[3]
        compiled = lower(plan, policy=policy, fused_step=fused_step,
                         kernel_cache=self.kernel_cache, device=self.device)
        with self._memo_lock:
            if key not in self._lowered_memo and \
                    len(self._lowered_memo) >= self._MEMO_CAP:
                self._lowered_memo.pop(next(iter(self._lowered_memo)))
            self._lowered_memo[key] = (plan, fused_step, policy, compiled)
        return compiled

    def execute(self, plan: ExecutionPlan, x: np.ndarray,
                injector=None, retry=None, on_commit=None,
                ) -> Tuple[np.ndarray, TransferStats]:
        """Run a plan on the executor's device.  ``injector``/``retry``/
        ``on_commit`` are not ported yet and raise
        :class:`NotImplementedError`."""
        if injector is not None or retry is not None or on_commit is not None:
            raise NotImplementedError(
                "fault injection, retry and commit hooks are not ported yet")
        if self.lowered:
            host, stats, exec_stats = self._compiled(plan).execute(
                x, pipeline=self._pipeline, slot_pool=self.slot_pool)
            exec_stats.executor = self.name
            self.exec_stats = exec_stats
            return host, stats
        host, stats = self._execute_legacy(plan, x)
        self.exec_stats = None
        return host, stats

    def _state(self, plan, x) -> _DeviceState:
        return _DeviceState(validate_domain(plan, x), self.fused_step,
                            self.device)

    def _execute_legacy(self, plan, x):
        raise NotImplementedError


class EagerExecutor(_LoweredExecutorBase):
    """In-order interpreter: one stage program at a time, plan order."""

    name = "eager"
    _pipeline = False

    def _execute_legacy(self, plan, x):
        state = self._state(plan, x)
        for op in plan.ops:
            state.issue(op)
        state.commit()   # no-op unless a planner forgot the final barrier
        return state.host, plan.stats()


class DoubleBufferedExecutor(_LoweredExecutorBase):
    """Software-pipelined interpreter (the paper's multi-stream overlap).

    Walks the plan stage-by-stage (one stage per ``(round, chunk)``).
    Before executing stage ``i``'s kernels it issues every H2D of stage
    ``i+1`` — legal because H2D only reads committed host rows and
    commits are stage-group barriers.  On CUDA the lowered path puts
    those copies on a copy stream from page-locked host memory, so they
    run under stage ``i``'s kernels.
    """

    name = "double_buffered"
    _pipeline = True

    def _execute_legacy(self, plan, x):
        state = self._state(plan, x)
        stages = plan.stages()
        prefetched: set = set()
        for j, (key, ops) in enumerate(stages):
            if key is None:          # HostCommit barrier
                for op in ops:
                    state.issue(op)
                continue
            # prefetch the next chunk's H2D — and the host-side Compress
            # feeding it — before touching this chunk's kernels; stop at
            # barriers (host rows change there)
            if j + 1 < len(stages) and stages[j + 1][0] is not None:
                for nxt in stages[j + 1][1]:
                    if isinstance(nxt, H2D) or (
                            isinstance(nxt, Compress) and nxt.direction == "h2d"):
                        state.issue(nxt)
                        prefetched.add(id(nxt))
            for op in ops:
                if id(op) in prefetched:
                    continue
                state.issue(op)
        state.commit()
        return state.host, plan.stats()


class DryRunExecutor:
    """Zero-device-work interpreter: the plan *is* the result."""

    name = "dry_run"

    def execute(self, plan,
                x: Optional[np.ndarray] = None) -> Tuple[None, TransferStats]:
        return None, plan.stats()


EXECUTORS = {e.name: e for e in
             (EagerExecutor, DoubleBufferedExecutor, DryRunExecutor)}


def get_executor(name: str, fused_step: Optional[FusedStep] = None,
                 policy=None, device=None):
    try:
        cls = EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown executor {name!r}; known: {sorted(EXECUTORS)}")
    if cls is DryRunExecutor:
        if fused_step is not None or policy is not None:
            raise ValueError(
                f"executor {name!r} takes no fused_step/policy — it never "
                "dispatches single-device FusedKernel ops")
        return cls()
    return cls(fused_step, policy=policy, device=device)
