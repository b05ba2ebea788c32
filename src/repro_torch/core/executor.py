"""Pluggable executors over :class:`repro_torch.core.plan.ExecutionPlan`
and :class:`~repro_torch.core.plan.ShardedPlan` (the port of
:mod:`repro.core.executor`).

Interpreters of the same op schedule:

* :class:`EagerExecutor` — walks ops in plan order.
* :class:`DoubleBufferedExecutor` — software-pipelined: chunk ``i+1``'s
  H2D is issued before chunk ``i``'s kernels.  On CUDA the copies run on a
  separate copy stream from the page-locked host array, under the compute
  stream's kernels — the paper's multi-stream overlap (Sec. II,
  N_strm = 3) with real CUDA streams; nothing blocks until a
  ``HostCommit`` barrier drains the staged D2H boxes.  The page-locked
  host array is leased from the executor's
  :class:`~repro_torch.core.lower.DomainPool`, so solves of one geometry
  reuse it.
* :class:`DryRunExecutor` — walks no device work at all and returns the
  plan-derived :class:`TransferStats` (also of sharded plans).
* :class:`ShardedSimExecutor` — lowers a sharded or hierarchical plan's
  per-rank streams to lockstep stage programs
  (:func:`repro_torch.core.lower.lower_sharded`) and runs them on one
  device, halos moving through a mailbox.
* :class:`ShardMapExecutor` — runs a sharded plan on a mesh of rank
  processes (:class:`~repro_torch.core.ranks.RankMesh`), one band per
  process, halos crossing ``torch.distributed`` point to point (the JAX
  package's ``shard_map`` backend).

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
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .compress import get_codec
from .device import resolve_device
from .distributed import check_sharded_domain, execute_sharded_plan
from .lower import (
    DomainPool, ExecStats, KernelCache, lower, lower_sharded, to_device,
    validate_domain,
)
from .plan import (
    BufferRead, BufferWrite, Compress, D2H, Decompress, ExecutionPlan,
    FusedKernel, H2D, HostCommit, TransferStats,
)
from .ranks import DEFAULT_TIMEOUT_S, RankMesh
from .reference import multi_step_band, multi_step_box

__all__ = [
    "EagerExecutor", "DoubleBufferedExecutor", "DryRunExecutor",
    "ShardedSimExecutor", "ShardMapExecutor", "get_executor", "EXECUTORS",
    "PLAN_EXECUTORS",
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
    the most recent run.  ``domain_pool`` (pipelined executors on a card,
    None elsewhere) holds the page-locked host domains of the runs,
    across runs, until the executor goes."""

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
        self.domain_pool = DomainPool() if self._pipeline \
            and self.device.type == "cuda" else None
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

    supports_injection = True

    def execute(self, plan: ExecutionPlan, x: np.ndarray,
                injector=None, retry=None, on_commit=None,
                ) -> Tuple[np.ndarray, TransferStats]:
        """Run a plan on the executor's device.  ``injector``/``retry``/
        ``on_commit`` thread the fault-injection and checkpoint hooks
        through to :meth:`repro_torch.core.lower.CompiledPlan.execute`;
        they require the lowered path (the legacy op-at-a-time
        interpreter has no op sites to consult)."""
        if self.lowered:
            host, stats, exec_stats = self._compiled(plan).execute(
                x, pipeline=self._pipeline, slot_pool=self.slot_pool,
                injector=injector, retry=retry, on_commit=on_commit,
                domain_pool=self.domain_pool)
            exec_stats.executor = self.name
            self.exec_stats = exec_stats
            return host, stats
        if injector is not None or retry is not None or on_commit is not None:
            raise ValueError(
                "fault injection / commit hooks require the lowered "
                "executor path (lowered=True)")
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


class ShardedSimExecutor:
    """Single-device lockstep simulator for sharded plans.

    Lowers the per-rank op streams through
    :func:`repro_torch.core.lower.lower_sharded` (slot-bound closures,
    shared halo mailbox, one cached kernel signature for every rank x
    round) for ``device`` (None means ``cuda``) and walks the global
    phases in barrier order.  Every rank's band lives on that one
    device; the masked update is plain PyTorch.

    Hierarchical plans (:mod:`repro_torch.core.hierarchy`) run through
    the same entry point: the lowering layer expands each ShardKernel
    into its rank's nested stage program, and ``slot_pool`` (optional,
    shared with the serving layer) supplies the chunk-slot storage those
    inner programs lease per round."""

    name = "sharded_sim"
    supports_injection = True

    def __init__(self, slot_pool=None, kernel_cache=None, device=None):
        self.kernel_cache = kernel_cache if kernel_cache is not None \
            else KernelCache()
        self.slot_pool = slot_pool
        self.device = resolve_device(device)
        self.exec_stats: Optional[ExecStats] = None
        self._lowered_memo = None

    def _compiled(self, plan):
        memo = self._lowered_memo
        if memo is not None and memo[0] is plan:
            return memo[1]
        compiled = lower_sharded(plan, kernel_cache=self.kernel_cache,
                                 device=self.device)
        self._lowered_memo = (plan, compiled)
        return compiled

    def execute(self, plan, x: np.ndarray,
                injector=None, retry=None, on_commit=None,
                ) -> Tuple[np.ndarray, TransferStats]:
        host, stats, exec_stats = self._compiled(plan).execute(
            x, injector=injector, retry=retry, slot_pool=self.slot_pool)
        exec_stats.executor = self.name
        self.exec_stats = exec_stats
        if on_commit is not None:
            # a sharded plan stores host state once, at the end: its
            # whole run is one commit of the final round
            on_commit(plan.rounds - 1, host)
        return host, stats


class ShardMapExecutor:
    """Multi-process backend: run a sharded plan through
    :func:`repro_torch.core.distributed.execute_sharded_plan` on a mesh
    of rank processes.

    The plan carries the whole geometry (mesh shape, k_ici, stencil, n),
    so ``execute(plan, x)`` needs no configuration beyond an optional
    explicit :class:`~repro_torch.core.ranks.RankMesh` (which must match
    the plan's shape, and which the caller closes).  By default the
    executor starts its own ``plan.mesh_shape`` mesh on ``device`` (None
    means ``cuda``) at the first ``execute``, reuses it for every later
    plan of that shape, and replaces it when a plan of another shape
    comes; :meth:`close` (or ``with``) stops it.  Stats are the
    plan-derived accounting, same as every other executor.

    Transport, by the rule of :mod:`repro_torch.core.ranks` (recorded in
    :attr:`transport`): gloo on the CPU; NCCL when every rank has a card
    of its own; gloo with halos staged through page-locked host memory
    when ranks share a card (one H100 runs NCCL at mesh (1, 1) only).

    Hierarchical and halo-compressed plans dispatch on their *outer
    geometry*: each rank runs its rounds as fused masked updates, so the
    nested chunking and the codec round trip are sim-only refinements —
    each rank holds its full band (valid when its device fits it) and
    halos cross raw.  Stats still report the plan's own two-level/wire
    accounting.

    ``exec_stats.op_wall_s`` splits the wall: ``GroupStart`` (spawn and
    rendezvous, 0 when the mesh was reused), ``DomainIn`` / ``DomainOut``
    (the parent's domain file), and the slowest rank's ``ShardLoad``,
    ``Rounds``, ``HaloExchange``, ``MaskedUpdate`` and ``ShardStore``;
    :attr:`rank_stats` holds every rank's own numbers, ``update_ms`` its
    CUDA-event time of the masked updates."""

    name = "shard_map"
    supports_injection = False

    def __init__(self, mesh: Optional[RankMesh] = None,
                 row_axis: str = "data", col_axis: str = "model",
                 device=None, timeout: float = DEFAULT_TIMEOUT_S):
        self.mesh = mesh
        self.row_axis = row_axis
        self.col_axis = col_axis
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.timeout = timeout
        self.exec_stats: Optional[ExecStats] = None
        self.transport: Optional[str] = None
        self.rank_stats: List[dict] = []
        self._own = None

    def _mesh_for(self, plan):
        """The mesh to run ``plan`` on, and the seconds spent starting
        it (0 when reused)."""
        if self.mesh is not None:
            return self.mesh, 0.0
        shape = tuple(plan.mesh_shape)
        own = self._own
        if own is not None and (own.closed or own.sizes != shape):
            own.close()
            own = None
        if own is None:
            own = self._own = RankMesh(shape, (self.row_axis, self.col_axis),
                                       device=self.device,
                                       timeout=self.timeout)
            return own, own.start_s
        return own, 0.0

    def execute(self, plan,
                x: np.ndarray) -> Tuple[np.ndarray, TransferStats]:
        t0 = time.perf_counter()
        check_sharded_domain(plan, x)    # before any rank starts
        mesh, start_s = self._mesh_for(plan)
        out = execute_sharded_plan(plan, x, mesh=mesh,
                                   row_axis=self.row_axis,
                                   col_axis=self.col_axis)
        run = mesh.last_run
        ranks = run["ranks"]
        if any(r["update_calls"] != plan.rounds for r in ranks):
            raise RuntimeError(
                f"ranks ran {[r['update_calls'] for r in ranks]} masked "
                f"updates, the plan has {plan.rounds} rounds")

        def slowest(key):
            return max(r[key] for r in ranks)

        self.transport = mesh.transport
        self.rank_stats = ranks
        # the backend runs each rank's rounds as one program, not per-op
        # closures: no per-op counters or cache counters to report
        self.exec_stats = ExecStats(
            executor=self.name, kernel_impl="shard_map",
            kernel_calls=plan.n_ranks * plan.rounds,
            stage_count=len(plan.barriers),
            op_wall_s={"GroupStart": start_s,
                       "DomainIn": run["domain_in_s"],
                       "ShardLoad": slowest("load_s"),
                       "Rounds": slowest("rounds_s"),
                       "HaloExchange": slowest("halo_s"),
                       "MaskedUpdate": slowest("update_s"),
                       "ShardStore": slowest("store_s"),
                       "DomainOut": run["domain_out_s"]},
            wall_s=time.perf_counter() - t0)
        return out, plan.stats()

    def close(self) -> None:
        """Stop the mesh this executor started (an explicit mesh is the
        caller's to close)."""
        if self._own is not None:
            self._own.close()
            self._own = None

    def __enter__(self) -> "ShardMapExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


EXECUTORS = {e.name: e for e in
             (EagerExecutor, DoubleBufferedExecutor, DryRunExecutor,
              ShardedSimExecutor, ShardMapExecutor)}

# executors that interpret single-device ExecutionPlans (what
# benchmarks.run --exec sweeps); the sharded ones take a ShardedPlan
PLAN_EXECUTORS = ("eager", "double_buffered")


def get_executor(name: str, fused_step: Optional[FusedStep] = None,
                 policy=None, device=None):
    try:
        cls = EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown executor {name!r}; known: {sorted(EXECUTORS)}")
    if cls in (DryRunExecutor, ShardedSimExecutor, ShardMapExecutor):
        if fused_step is not None or policy is not None:
            raise ValueError(
                f"executor {name!r} takes no fused_step/policy — it never "
                "dispatches single-device FusedKernel ops")
        return cls() if cls is DryRunExecutor else cls(device=device)
    return cls(fused_step, policy=policy, device=device)
