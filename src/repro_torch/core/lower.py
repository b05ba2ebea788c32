"""Plan lowering: stage programs, slot-bound closures, shape-bucketed cache
(the single-device half of :mod:`repro.core.lower`, ported).

* **stage programs** — :func:`lower` groups ops into per-``(round,
  chunk)`` stages of *pre-bound closures*: register/buffer names are
  resolved to integer slots, slice bounds and codec objects are baked
  into each closure, and per-op type dispatch disappears from the
  execution loop (it runs ``for tag, fn, rnd, chunk in stage: fn(rt)``).
* **kernel dispatch** — FusedKernel ops are resolved through the
  registry in :mod:`repro_torch.kernels.dispatch` (plain PyTorch or the
  CUDA kernels) exactly once at lowering time, for the device the plan
  is lowered for.
* **shape bucketing** — band heights are padded up to per-plan buckets
  (one bucket per ``(stencil, steps, keep_top, keep_bottom)`` group, the
  group's max height) so all chunks and rounds share one kernel
  signature.  Padding is on the frame-free side and the output is sliced
  back to the true height, so results are bit-identical.  The CUDA
  kernels take runtime shapes and never retrace, so on the card the pad
  only costs a copy of the band; it stays so that ``shape_buckets`` and
  ``kernel_compiles`` keep the JAX package's values.
* **compilation cache** — a :class:`KernelCache` keyed by
  ``(impl, stencil, steps, keeps, bucket_height, width, itemsize)``
  counts distinct signatures; hits/misses surface in :class:`ExecStats`.

Device memory: a register is a tensor, and BufferWrite and the staged D2H
keep *views* of it.  That is safe because no op writes a register in
place — H2D, BufferRead's concatenation and every kernel produce fresh
tensors.  On CUDA the pipelined run issues its H2D copies on a separate
copy stream from the run's host array, page-locked for the run with
``cudaHostRegister`` so the copies are true DMA; the compute stream waits
on each copy's event just before the register's first use.  Staged D2H
boxes drain into the host array at HostCommit.

Accounting is untouched: :meth:`CompiledPlan.execute` returns the
plan-derived :class:`~repro_torch.core.plan.TransferStats`.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .compress import get_codec
from .device import resolve_device
from .plan import (
    BufferRead, BufferWrite, Compress, D2H, Decompress, ExecutionPlan,
    FusedKernel, H2D, HostCommit, TransferStats,
)

__all__ = [
    "ExecStats", "KernelCache", "BucketRegistry", "SlotPool",
    "CompiledPlan", "LoweredStage", "lower",
    "check_domain", "validate_domain", "to_device", "host_register",
    "host_unregister",
]

# op-class tags (indices into the per-class wall-clock accumulators)
OP_TAGS = ("H2D", "D2H", "BufferWrite", "BufferRead", "FusedKernel",
           "HostCommit", "Compress", "Decompress")
_TAG = {name: i for i, name in enumerate(OP_TAGS)}

# (tag, closure over the runtime, round, chunk)
BoundOp = Tuple[int, Callable, int, int]


@dataclasses.dataclass
class ExecStats:
    """Execution-side counters (wall clock + compilation cache), the
    companion of the plan-side :class:`~repro_torch.core.plan.TransferStats`.

    Wall-clock numbers are host-observed time per op class; on CUDA most
    ops return once their work is queued, so they measure dispatch, not
    device time.  The cache/op counters are the deterministic part.
    (The JAX package's fault, model-error and merge fields come with the
    slices that port faults, the cost model and the service.)"""

    executor: str = ""
    kernel_impl: str = ""
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: int = 0
    shape_buckets: int = 0         # distinct kernel signatures after bucketing
    kernel_compiles: int = 0       # cache misses this run (new signatures)
    kernel_cache_hits: int = 0
    stage_count: int = 0
    lower_s: float = 0.0
    wall_s: float = 0.0


class KernelCache:
    """Keyed cache of fused-kernel callables, one entry per kernel
    *signature* ``(impl, stencil, steps, keep_top, keep_bottom,
    bucket_height, width, itemsize)`` — the key set the JAX package's jit
    cache traces on, so ``misses`` counts what it would compile.
    Thread-safe: a signature is counted exactly once however many runs
    race to it."""

    def __init__(self):
        self._entries: Dict[tuple, Callable] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: tuple, make: Callable[[], Callable]) -> Callable:
        with self._lock:
            fn = self._entries.get(key)
            if fn is None:
                self.misses += 1
                fn = self._entries[key] = make()
            else:
                self.hits += 1
            return fn

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class BucketRegistry:
    """Cross-plan shape buckets: maps a kernel group ``(stencil, steps,
    keep_top, keep_bottom, width, itemsize)`` to the band heights already
    registered for it, so a plan whose bands fit an existing bucket
    presents no new signature.  Thread-safe."""

    def __init__(self):
        self._heights: Dict[tuple, List[int]] = {}
        self._lock = threading.Lock()

    def resolve(self, group: tuple, height: int) -> int:
        """Smallest registered bucket >= ``height`` for ``group``; when
        none fits, ``height`` is registered as a new bucket."""
        with self._lock:
            heights = self._heights.setdefault(group, [])
            i = bisect.bisect_left(heights, height)
            if i < len(heights):
                return heights[i]
            heights.insert(i, height)
            return height

    def __len__(self) -> int:
        """Total registered buckets (over all groups)."""
        with self._lock:
            return sum(len(v) for v in self._heights.values())


class SlotPool:
    """Register/buffer slot storage shared and reused across compiled
    plans: a run leases slot lists when its runtime is built and releases
    them (cleared, so no device tensor outlives its run) when it retires.
    Thread-safe."""

    def __init__(self):
        self._free: List[Tuple[List, List]] = []
        self._lock = threading.Lock()
        self.leases = 0
        self.reuses = 0
        self.in_use = 0
        self.peak_in_use = 0

    def acquire(self, n_regs: int, n_bufs: int) -> Tuple[List, List]:
        with self._lock:
            self.leases += 1
            if self._free:
                self.reuses += 1
                regs, bufs = self._free.pop()
            else:
                regs, bufs = [], []
            self.in_use += 1
            self.peak_in_use = max(self.peak_in_use, self.in_use)
        if len(regs) < n_regs:
            regs.extend([None] * (n_regs - len(regs)))
        if len(bufs) < n_bufs:
            bufs.extend([None] * (n_bufs - len(bufs)))
        return regs, bufs

    def release(self, regs: List, bufs: List) -> None:
        for i in range(len(regs)):
            regs[i] = None
        for i in range(len(bufs)):
            bufs[i] = None
        with self._lock:
            self._free.append((regs, bufs))
            self.in_use -= 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"leases": self.leases, "reuses": self.reuses,
                    "in_use": self.in_use, "peak_in_use": self.peak_in_use}

    def assert_balanced(self) -> None:
        """Raise if any lease is still outstanding."""
        with self._lock:
            if self.in_use != 0:
                raise AssertionError(
                    f"slot pool unbalanced: {self.in_use} lease(s) "
                    f"outstanding ({self.leases} acquired, "
                    f"{self.leases - self.in_use} released)")


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh device tensor holding ``arr`` (contiguous; never a view of
    the host array, also on the CPU)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return src.clone()
    return src.to(device, non_blocking=True)


class _Runtime:
    """Slot-indexed register/buffer/staging state the bound closures run
    against.  ``copy_stream`` (pipelined CUDA runs) carries the H2D copies;
    ``ready`` holds each such register's copy event until its first use."""

    __slots__ = ("host", "regs", "bufs", "staged", "wire", "device",
                 "copy_stream", "ready")

    def __init__(self, host: np.ndarray, n_regs: int, n_bufs: int,
                 device: torch.device, regs: Optional[List] = None,
                 bufs: Optional[List] = None, copy_stream=None):
        self.host = host
        self.regs: List = regs if regs is not None else [None] * n_regs
        self.bufs: List = bufs if bufs is not None else [None] * n_bufs
        # staged D2H boxes: (host slice tuple, device rows, codec|None)
        self.staged: List[tuple] = []
        # reg slot -> (payload, shape, dtype) between a non-identity
        # Compress(h2d) and its Decompress
        self.wire: Dict[int, tuple] = {}
        self.device = device
        self.copy_stream = copy_stream
        self.ready: Dict[int, object] = {}

    def load(self, slot: int, arr: np.ndarray) -> None:
        """H2D of a host box into register ``slot``."""
        if self.copy_stream is None:
            self.regs[slot] = to_device(arr, self.device)
            return
        src = torch.from_numpy(np.ascontiguousarray(arr))
        with torch.cuda.stream(self.copy_stream):
            self.regs[slot] = src.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self.ready[slot] = event

    def reg(self, slot: int) -> torch.Tensor:
        """Register ``slot``, its H2D ordered before the compute stream's
        next work on first use."""
        event = self.ready.pop(slot, None)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # the copy stream allocated it; keep the allocator from
            # recycling it while the compute stream still reads it
            self.regs[slot].record_stream(stream)
        return self.regs[slot]

    def commit(self) -> None:
        if self.copy_stream is not None:
            self.copy_stream.synchronize()   # no copy still reads the host
        for sl, rows, codec_name in self.staged:
            if codec_name is None:
                # waits for the rows' kernels, then copies into the host
                torch.from_numpy(self.host[sl]).copy_(rows)
                continue
            arr = rows.cpu().numpy()
            # the wire round trip: device-side encode, host-side decode
            codec = get_codec(codec_name)
            self.host[sl] = codec.decode(codec.encode(arr), arr.shape,
                                         arr.dtype)
        self.staged.clear()


@dataclasses.dataclass(frozen=True)
class LoweredStage:
    """One pipeline stage: all bound ops in plan order, pre-split into
    the prefetchable prefix (H2D + host-side Compress — ops that only
    read committed host rows and write fresh slots) and the rest."""

    key: Optional[Tuple[int, int]]      # (round, chunk); None = barrier
    ops: Tuple[BoundOp, ...]
    prefetch: Tuple[BoundOp, ...]
    rest: Tuple[BoundOp, ...]


def check_domain(plan, x: np.ndarray) -> None:
    """Raise if a host domain does not match the plan geometry."""
    if tuple(x.shape) != tuple(plan.shape):
        raise ValueError(f"domain {x.shape} does not match plan "
                         f"{tuple(plan.shape)}")
    if x.dtype.itemsize != plan.itemsize:
        raise ValueError(f"dtype itemsize {x.dtype.itemsize} does not match "
                         f"plan itemsize {plan.itemsize}")


def validate_domain(plan: ExecutionPlan, x: np.ndarray) -> np.ndarray:
    """Check a host domain against the plan geometry; return a mutable copy."""
    check_domain(plan, x)
    return np.asarray(x).copy()


def _noop(rt) -> None:
    return None


def host_register(arr: np.ndarray) -> None:
    """Page-lock a host array in place (``cudaHostRegister``), so copies
    from and into it run as DMA without a staging copy."""
    err = int(torch.cuda.cudart().cudaHostRegister(arr.ctypes.data,
                                                   arr.nbytes, 0))
    if err != 0:
        raise RuntimeError(f"cudaHostRegister of the host domain "
                           f"({arr.nbytes} bytes) failed: CUDA error {err}")


def host_unregister(arr: np.ndarray) -> None:
    """Undo :func:`host_register`."""
    err = int(torch.cuda.cudart().cudaHostUnregister(arr.ctypes.data))
    if err != 0:
        raise RuntimeError(f"cudaHostUnregister failed: CUDA error {err}")


@dataclasses.dataclass
class CompiledPlan:
    """A lowered :class:`ExecutionPlan`: stage programs of slot-bound
    closures plus the kernel-signature cache they dispatch through, for
    one device."""

    plan: ExecutionPlan
    stages: Tuple[LoweredStage, ...]
    n_reg_slots: int
    n_buf_slots: int
    kernel_impl: str
    shape_buckets: int
    cache: KernelCache
    lower_s: float
    device: torch.device

    def runtime(self, x: np.ndarray, slot_pool: Optional[SlotPool] = None,
                copy_stream=None) -> _Runtime:
        """Build the slot-indexed runtime for one run, leasing slot
        storage from ``slot_pool`` when given."""
        host = validate_domain(self.plan, x)
        regs = bufs = None
        if slot_pool is not None:
            regs, bufs = slot_pool.acquire(self.n_reg_slots, self.n_buf_slots)
        return _Runtime(host, self.n_reg_slots, self.n_buf_slots,
                        self.device, regs, bufs, copy_stream)

    @staticmethod
    def release_runtime(rt: _Runtime,
                        slot_pool: Optional[SlotPool]) -> None:
        if slot_pool is not None:
            slot_pool.release(rt.regs, rt.bufs)

    def execute(self, x: np.ndarray, pipeline: bool = False,
                slot_pool: Optional[SlotPool] = None,
                injector=None, retry=None, on_commit=None,
                ) -> Tuple[np.ndarray, TransferStats, ExecStats]:
        """Run the stage programs.

        ``pipeline=True`` issues the next stage's prefetchable ops (H2D
        and host-side Compress) before the current stage's kernels — the
        double-buffered schedule; on CUDA the copies ride a separate
        stream from the page-locked host array.  Results are bitwise
        identical either way: the same kernels run on the same bands in
        the same order.

        ``injector``/``retry``/``on_commit`` (fault injection and the
        checkpoint hook) are not ported yet and raise
        :class:`NotImplementedError`."""
        if injector is not None or retry is not None or on_commit is not None:
            raise NotImplementedError(
                "fault injection, retry and commit hooks are not ported yet")
        cuda_pipe = pipeline and self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda_pipe else None
        rt = self.runtime(x, slot_pool, copy_stream)
        wall = [0.0] * len(OP_TAGS)
        counts = [0] * len(OP_TAGS)
        hits0, miss0 = self.cache.hits, self.cache.misses
        perf = time.perf_counter
        t_run = perf()

        def run(ops: Tuple[BoundOp, ...]) -> None:
            for tag, fn, _, _ in ops:
                t0 = perf()
                fn(rt)
                wall[tag] += perf() - t0
                counts[tag] += 1

        stages = self.stages
        pinned = False
        try:
            if cuda_pipe and rt.host.nbytes > 0:
                host_register(rt.host)
                pinned = True
            if not pipeline:
                for stage in stages:
                    run(stage.ops)
            else:
                n = len(stages)
                prefetched = [False] * n
                for j, stage in enumerate(stages):
                    if stage.key is None:       # HostCommit barrier
                        run(stage.ops)
                        continue
                    # prefetch the next chunk's transfers under this
                    # chunk's kernels; never across a barrier (host rows
                    # change there)
                    if j + 1 < n and stages[j + 1].key is not None:
                        run(stages[j + 1].prefetch)
                        prefetched[j + 1] = True
                    run(stage.rest if prefetched[j] else stage.ops)
            rt.commit()   # no-op unless a planner forgot the final barrier
        finally:
            if pinned:
                copy_stream.synchronize()
                host_unregister(rt.host)
            self.release_runtime(rt, slot_pool)

        stats = ExecStats(
            kernel_impl=self.kernel_impl,
            op_counts={OP_TAGS[i]: c for i, c in enumerate(counts) if c},
            op_wall_s={OP_TAGS[i]: wall[i] for i, c in enumerate(counts) if c},
            kernel_calls=counts[_TAG["FusedKernel"]],
            shape_buckets=self.shape_buckets,
            kernel_compiles=self.cache.misses - miss0,
            kernel_cache_hits=self.cache.hits - hits0,
            stage_count=sum(1 for s in stages if s.key is not None),
            lower_s=self.lower_s,
            wall_s=perf() - t_run,
        )
        return rt.host, self.plan.stats(), stats


class _SlotAllocator:
    """Linear-scan name->slot assignment with *delayed* slot reuse.

    The pipelined executor issues stage ``k``'s prefetchable ops before
    stage ``k-1``'s ops run, so a slot freed in stage ``k-1`` is still
    being read when stage ``k``'s prefetch would write it.  Holding every
    freed slot out of the pool for two chunk stages guarantees a reused
    slot's last touch strictly precedes the earliest point the pipeline
    can write it again."""

    REUSE_DELAY = 2

    def __init__(self):
        self._live: Dict[str, int] = {}
        self._free: List[int] = []
        self._pending: List[Tuple[int, int]] = []   # (freed_at_stage, slot)
        self.n_slots = 0

    def new_stage(self, ordinal: int) -> None:
        """Called when lowering enters chunk stage ``ordinal``: slots
        freed at least ``REUSE_DELAY`` stages ago become reusable."""
        keep = []
        for freed_at, slot in self._pending:
            if freed_at <= ordinal - self.REUSE_DELAY:
                self._free.append(slot)
            else:
                keep.append((freed_at, slot))
        self._pending = keep

    def alloc(self, name: str) -> int:
        assert name not in self._live, f"slot name {name!r} already live"
        if self._free:
            slot = self._free.pop()
        else:
            slot = self.n_slots
            self.n_slots += 1
        self._live[name] = slot
        return slot

    def get(self, name: str) -> int:
        return self._live[name]

    def free(self, name: str, stage_ordinal: int) -> int:
        slot = self._live.pop(name)
        self._pending.append((stage_ordinal, slot))
        return slot


def _is_banded(op: FusedKernel) -> bool:
    """True for a classic 2-D row band (full width, frame columns along)
    — the shape the registered fused-step kernels and the bucketing pass
    understand.  Anything else (3-D tiles, column chunks) lowers through
    the N-D reference binder."""
    return len(op.shape_in) == 2 and op.keep_lo[1] and op.keep_hi[1]


def _bucket_heights(plan: ExecutionPlan, bucket: bool,
                    registry: Optional[BucketRegistry] = None,
                    ) -> Dict[tuple, int]:
    """Per-group padded band heights: one bucket per ``(stencil, steps,
    keep_top, keep_bottom)`` group (its max h_in).  Both-sides-framed
    bands and non-banded (N-D box) kernels are excluded."""
    buckets: Dict[tuple, int] = {}
    if not bucket:
        return buckets
    for op in plan.ops:
        if isinstance(op, FusedKernel) and _is_banded(op) \
                and not (op.keep_lo[0] and op.keep_hi[0]):
            key = (op.stencil, op.steps, op.keep_lo[0], op.keep_hi[0])
            buckets[key] = max(buckets.get(key, 0), op.shape_in[0])
    if registry is not None:
        for key, h in buckets.items():
            buckets[key] = registry.resolve(
                key + (plan.X, plan.itemsize), h)
    return buckets


def _bind_kernel(slot: int, op: FusedKernel, bucket_h: int, impl_name: str,
                 fn: Callable, cache: KernelCache, itemsize: int) -> Callable:
    h_in, width = op.shape_in
    pad = bucket_h - h_in
    kt, kb = op.keep_lo[0], op.keep_hi[0]
    # pad on the frame-free side; slice the true output back out
    pad_top = kb and not kt
    # id(fn) keeps the signature count honest when the same impl name
    # resolves to a different callable; the cache entry holds fn alive
    key = (impl_name, id(fn), op.stencil, op.steps, kt, kb,
           bucket_h, width, itemsize)
    name, steps = op.stencil, op.steps
    h_out = op.shape_out[0]

    def run(rt):
        cache.lookup(key, lambda: fn)
        band = rt.reg(slot)
        if pad:
            z = torch.zeros((pad, band.shape[1]), dtype=band.dtype,
                            device=band.device)
            band = torch.cat([z, band] if pad_top else [band, z], dim=0)
        out = fn(band, name, steps, keep_top=kt, keep_bottom=kb)
        if pad:
            out = out[out.shape[0] - h_out:] if pad_top else out[:h_out]
        rt.regs[slot] = out

    return run


def _bind_kernel_nd(slot: int, op: FusedKernel, cache: KernelCache,
                    itemsize: int) -> Callable:
    """Bind a non-banded (N-D box) FusedKernel to the reference kernel.
    No padding/bucketing: each distinct ``(shape_in, keeps)`` is its own
    signature, and the cache key mirrors that."""
    from .reference import multi_step_box

    key = ("reference_nd", op.stencil, op.steps, op.keep_lo, op.keep_hi,
           op.shape_in, itemsize)
    name, steps, kl, kh = op.stencil, op.steps, op.keep_lo, op.keep_hi

    def run(rt):
        cache.lookup(key, lambda: multi_step_box)
        rt.regs[slot] = multi_step_box(rt.reg(slot), name, steps,
                                       keep_lo=kl, keep_hi=kh)

    return run


def lower(plan: ExecutionPlan, policy=None, fused_step=None,
          kernel_cache: Optional[KernelCache] = None,
          bucket_registry: Optional[BucketRegistry] = None,
          device=None) -> CompiledPlan:
    """Compile a plan into stage programs of slot-bound closures for
    ``device`` (None means ``cuda``).

    ``fused_step`` (an explicit ``fn(band, name, steps, keep_top=...,
    keep_bottom=...)`` callable) overrides the dispatch registry;
    otherwise ``policy`` (a :class:`repro_torch.kernels.dispatch.DispatchPolicy`,
    default ``auto``) picks the implementation per stencil/steps and the
    device's backend.  ``kernel_cache`` lets an executor share one
    signature cache across plans and runs; ``bucket_registry`` routes
    this plan's band heights to already-registered cross-plan buckets."""
    from repro_torch.kernels.dispatch import DispatchPolicy, select_kernel

    t0 = time.perf_counter()
    device = resolve_device(device)
    policy = policy or DispatchPolicy()
    cache = kernel_cache if kernel_cache is not None else KernelCache()
    buckets = _bucket_heights(plan, policy.bucket, bucket_registry)

    regs = _SlotAllocator()
    bufs = _SlotAllocator()
    # (stencil, steps) -> (impl_name, callable); resolved once at lower time
    kernels: Dict[tuple, Tuple[str, Callable]] = {}
    nd_impls: set = set()               # "reference_nd" when box kernels bind
    # statically tracked codec context between a Compress and its transfer
    pending_h2d: Dict[str, str] = {}    # reg -> codec (non-identity, h2d)
    pending_d2h: Dict[str, str] = {}    # reg -> codec (non-identity, d2h)

    signatures = set()
    stages: List[List] = []             # [key, [BoundOp...]]
    chunk_ordinal = -1                  # index of the current chunk stage

    def emit(key, tag: str, fn: Callable, site=None) -> None:
        s = site if site is not None else key
        bound = (_TAG[tag], fn, s[0], s[1])
        if stages and stages[-1][0] == key and key is not None:
            stages[-1][1].append(bound)
        else:
            stages.append([key, [bound]])

    for op in plan.ops:
        if isinstance(op, HostCommit):
            emit(None, "HostCommit", lambda rt: rt.commit(),
                 site=(op.round, -1))
            continue
        key = (op.round, op.chunk)
        if not stages or stages[-1][0] != key:
            chunk_ordinal += 1
            regs.new_stage(chunk_ordinal)
            bufs.new_stage(chunk_ordinal)
        if isinstance(op, Compress):
            if op.direction == "h2d":
                codec = get_codec(op.codec)
                if codec.name == "identity":
                    # identity fast path: the H2D itself is the (pure)
                    # copy; wire-byte accounting stays plan-derived
                    emit(key, "Compress", _noop)
                else:
                    slot = regs.alloc(op.reg)   # H2D binds as the wire hop
                    pending_h2d[op.reg] = op.codec
                    sl = op.box.slices()

                    def run(rt, _s=slot, _sl=sl, _c=codec):
                        rows = rt.host[_sl]
                        rt.wire[_s] = (to_device(_c.encode(rows), rt.device),
                                       rows.shape, rows.dtype)

                    emit(key, "Compress", run)
            else:
                if op.codec != "identity":
                    pending_d2h[op.reg] = op.codec
                emit(key, "Compress", _noop)
        elif isinstance(op, Decompress):
            if op.direction == "h2d" and op.codec != "identity":
                slot = regs.get(op.reg)
                codec = get_codec(op.codec)

                def run(rt, _s=slot, _c=codec):
                    payload, shape, dtype = rt.wire.pop(_s)
                    rt.regs[_s] = to_device(
                        _c.decode(payload.cpu().numpy(), shape, dtype),
                        rt.device)

                emit(key, "Decompress", run)
            else:
                # d2h decode runs at the HostCommit barrier
                emit(key, "Decompress", _noop)
        elif isinstance(op, H2D):
            if op.reg in pending_h2d:
                # the wire hop already carried the encoded payload
                del pending_h2d[op.reg]
                emit(key, "H2D", _noop)
            else:
                slot = regs.alloc(op.reg)
                sl = op.box.slices()

                def run(rt, _s=slot, _sl=sl):
                    rt.load(_s, rt.host[_sl])

                emit(key, "H2D", run)
        elif isinstance(op, BufferWrite):
            rslot = regs.get(op.reg)
            bslot = bufs.alloc(op.buf)
            sl = op.reg_box.slices()

            def run(rt, _b=bslot, _r=rslot, _sl=sl):
                # a view: no op writes the register in place
                rt.bufs[_b] = rt.reg(_r)[_sl]

            emit(key, "BufferWrite", run)
        elif isinstance(op, BufferRead):
            bslot = bufs.free(op.buf, chunk_ordinal)    # consumed exactly once
            src_slot = regs.free(op.src, chunk_ordinal)  # src dies here
            dst_slot = regs.alloc(op.reg)

            def run(rt, _b=bslot, _src=src_slot, _dst=dst_slot, _ax=op.axis):
                shared = rt.bufs[_b]
                rt.bufs[_b] = None
                src = rt.reg(_src)
                if _src != _dst:
                    rt.regs[_src] = None
                rt.regs[_dst] = torch.cat([shared, src], dim=_ax)

            emit(key, "BufferRead", run)
        elif isinstance(op, FusedKernel):
            slot = regs.get(op.reg)
            if not _is_banded(op):
                # N-D box band: reference kernel, one signature per
                # distinct (shape, keeps)
                signatures.add((op.stencil, op.steps, op.keep_lo,
                                op.keep_hi, op.shape_in))
                nd_impls.add("reference_nd")
                emit(key, "FusedKernel",
                     _bind_kernel_nd(slot, op, cache, plan.itemsize))
                continue
            kkey = (op.stencil, op.steps)
            if kkey not in kernels:
                if fused_step is not None:
                    kernels[kkey] = ("explicit", fused_step)
                else:
                    kernels[kkey] = select_kernel(op.stencil, op.steps,
                                                  policy, device=device)
            impl_name, fn = kernels[kkey]
            gkey = (op.stencil, op.steps, op.keep_lo[0], op.keep_hi[0])
            bucket_h = buckets.get(gkey, op.shape_in[0])
            signatures.add(gkey + (bucket_h,))
            emit(key, "FusedKernel",
                 _bind_kernel(slot, op, bucket_h, impl_name, fn, cache,
                              plan.itemsize))
        elif isinstance(op, D2H):
            slot = regs.free(op.reg, chunk_ordinal)   # last use of the register
            codec_name = pending_d2h.pop(op.reg, None)
            rsl, hsl = op.reg_box.slices(), op.box.slices()

            def run(rt, _s=slot, _rsl=rsl, _hsl=hsl, _codec=codec_name):
                band = rt.reg(_s)
                rt.regs[_s] = None
                rt.staged.append((_hsl, band[_rsl], _codec))

            emit(key, "D2H", run)
        else:  # pragma: no cover - planner/lowering version skew
            raise TypeError(f"unknown op {op!r}")

    impl_names = sorted({name for name, _ in kernels.values()} | nd_impls)
    lowered_stages = []
    for key, ops in stages:
        ops = tuple(ops)
        prefetch = tuple(
            b for b in ops
            if b[0] == _TAG["H2D"] or b[0] == _TAG["Compress"])
        rest = tuple(b for b in ops if b not in prefetch)
        lowered_stages.append(LoweredStage(key=key, ops=ops,
                                           prefetch=prefetch, rest=rest))
    return CompiledPlan(
        plan=plan,
        stages=tuple(lowered_stages),
        n_reg_slots=regs.n_slots,
        n_buf_slots=bufs.n_slots,
        kernel_impl="+".join(impl_names) if impl_names else "none",
        shape_buckets=len(signatures),
        cache=cache,
        lower_s=time.perf_counter() - t0,
        device=device,
    )
