"""Plan lowering: stage programs, slot-bound closures, shape-bucketed cache
(the port of :mod:`repro.core.lower`).

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
copy stream, so the compute stream waits on each copy's event just before
the register's first use.  Staged D2H boxes drain into the host array at
HostCommit, synchronously, after one wait for the copy stream and the
compute stream, so the host array is the complete state of the run when a
round's commit hook (``on_commit``) fires.

Host memory: a run works on a mutable copy of the caller's domain, which
is never written.  A run that page-locks its host array for the copy
stream's DMA (a pipelined CUDA run) leases it from a :class:`DomainPool`:
the pool page-locks a domain once, when it makes one, and keeps it for
the next run of the same geometry, so the caller's input is copied into
warm page-locked memory and the answer copied out into a fresh array the
caller owns.  Every other run copies the input once, into fresh memory,
and that copy is its answer.

Tracing: under a profiler, :meth:`CompiledPlan.execute` names the copy in
and out, the pool's page-locking and unlocking, every chunk stage and
each commit's wait and drain (:mod:`repro_torch.core.trace`);
:class:`ExecStats` counts the bytes that the bucket pad's and region
sharing's concatenations write, and whether the run's domain came from
the pool.

Faults: an injector (:mod:`repro_torch.core.faults`) is consulted before
every bound op; a terminal fault surfaces as
:class:`~repro_torch.core.recovery.PlanExecutionError` carrying the last
committed round.  A faulted run drops its staged rows, and on CUDA its
copy stream drains before its host domain goes back to the pool.

Sharded plans: :func:`lower_sharded` compiles a
:class:`~repro_torch.core.plan.ShardedPlan`'s per-rank streams into
global phase-ordered stage programs that run in lockstep on one device
(the simulator behind :class:`~repro_torch.core.executor.ShardedSimExecutor`).
Each rank's band is one slot; halos move through a mailbox; every
``ShardKernel`` runs :func:`~repro_torch.core.distributed.masked_local_steps`
(plain PyTorch — no kernel of :mod:`repro_torch.kernels` is on this
path).  A halo payload is cloned as it leaves its band, and the masked
update returns a fresh tensor, so no payload aliases a band that a later
op replaces.  A :class:`~repro_torch.core.hierarchy.HierarchicalPlan`
binds each ``ShardKernel`` to its rank's inner plan, lowered by
:func:`lower` in the masked ``shard_origin`` mode: the band crosses to
the host, streams through the inner plan's H2D / kernel / D2H program,
and comes back.

Accounting is untouched: :meth:`CompiledPlan.execute` and
:meth:`CompiledShardedPlan.execute` return the plan-derived
:class:`~repro_torch.core.plan.TransferStats`.
"""
from __future__ import annotations

import bisect
import dataclasses
import mmap
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .compress import get_codec
from .device import resolve_device
from .faults import InjectedFault, consult
from .plan import (
    Box, BufferRead, BufferWrite, Compress, D2H, Decompress, ExecutionPlan,
    FusedKernel, H2D, HaloCompress, HaloDecompress, HaloRecv, HaloSend,
    HostCommit, ShardKernel, ShardLoad, ShardStore, ShardedPlan,
    TransferStats,
)
from .trace import span

__all__ = [
    "ExecStats", "KernelCache", "BucketRegistry", "SlotPool", "DomainPool",
    "CompiledPlan", "LoweredStage", "lower",
    "CompiledShardedPlan", "ShardStage", "lower_sharded",
    "check_domain", "validate_domain", "to_device", "host_register",
    "host_unregister",
]

# op-class tags (indices into the per-class wall-clock accumulators)
OP_TAGS = ("H2D", "D2H", "BufferWrite", "BufferRead", "FusedKernel",
           "HostCommit", "Compress", "Decompress",
           "ShardLoad", "ShardStore", "HaloSend", "HaloRecv", "ShardKernel",
           "HaloCompress", "HaloDecompress")
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
    ``modeled_s``/``model_error`` are set by the tuner's measured
    refinement (:func:`repro_torch.core.tune.tune`);
    ``faults_injected``/``retries`` count this run's injected faults and
    the transient ones absorbed by backoff, ``resumes`` the checkpoint
    resumes of :func:`repro_torch.core.recovery.run_with_recovery`.
    ``pad_bytes``/``share_bytes`` (the port's own, after the JAX
    package's fields) count the device bytes that the bucket pad's and
    region sharing's ``torch.cat`` results hold, summed over the run;
    ``domain_reused`` is 1 when the run's host domain came from a
    :class:`DomainPool` already made, 0 when the pool made it or the run
    copied the input into fresh memory (summed by :meth:`merge`)."""

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
    faults_injected: int = 0       # injected faults hit this run
    retries: int = 0               # transient faults absorbed by backoff
    resumes: int = 0               # checkpoint resumes (recovery loop)
    modeled_s: Optional[float] = None     # Sec. III prediction for this run
    model_error: Optional[float] = None   # (modeled_s - wall_s) / wall_s
    pad_bytes: int = 0       # bytes the bucket pad's concatenations wrote
    share_bytes: int = 0     # bytes region sharing's concatenations wrote
    domain_reused: int = 0   # host domain leased warm from a DomainPool

    def __post_init__(self):
        # plain attribute, not a dataclass field: asdict/== never see it
        self._lock = threading.Lock()

    def merge(self, other: "ExecStats") -> "ExecStats":
        """Accumulate another run's counters and timers into this one,
        thread-safely.  Counters and wall clocks sum; identity fields keep
        the first non-empty value; ``modeled_s`` sums and ``model_error``
        is recomputed against the summed wall clock."""
        with self._lock:
            for k, v in other.op_counts.items():
                self.op_counts[k] = self.op_counts.get(k, 0) + v
            for k, v in other.op_wall_s.items():
                self.op_wall_s[k] = self.op_wall_s.get(k, 0.0) + v
            self.kernel_calls += other.kernel_calls
            self.shape_buckets += other.shape_buckets
            self.kernel_compiles += other.kernel_compiles
            self.kernel_cache_hits += other.kernel_cache_hits
            self.stage_count += other.stage_count
            self.lower_s += other.lower_s
            self.wall_s += other.wall_s
            self.faults_injected += other.faults_injected
            self.retries += other.retries
            self.resumes += other.resumes
            self.pad_bytes += other.pad_bytes
            self.share_bytes += other.share_bytes
            self.domain_reused += other.domain_reused
            self.executor = self.executor or other.executor
            self.kernel_impl = self.kernel_impl or other.kernel_impl
            if other.modeled_s is not None:
                self.modeled_s = (self.modeled_s or 0.0) + other.modeled_s
            if self.modeled_s is not None and self.wall_s > 0:
                self.model_error = ((self.modeled_s - self.wall_s)
                                    / self.wall_s)
        return self


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

    def snapshot(self) -> Tuple[int, int]:
        """Atomic ``(hits, misses)`` read — per-job compile attribution
        in a shared-cache service needs both counters from one instant."""
        with self._lock:
            return self.hits, self.misses

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


class DomainPool:
    """Host work domains kept across runs, one leased per run that
    page-locks its host array (:meth:`CompiledPlan.execute`).

    :meth:`lease` hands out a domain of the input's shape and dtype
    holding a copy of the input: an idle one when the pool has one, else
    a new one, page-locked (``cudaHostRegister``) once the copy has
    faulted its pages in.  :meth:`release` takes it back when no
    copy reads it any more, still page-locked, for the next run of that
    geometry.  A lease that has to make a domain first frees the idle
    domains of other geometries, so the pool never holds more domains
    than were leased at once.  :meth:`close`, also when the pool's owner
    drops it, unlocks and frees the idle domains, and a domain leased
    then is freed when it comes back.  Thread-safe."""

    def __init__(self):
        self._idle: Dict[tuple, List[np.ndarray]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.leases = 0
        self.reuses = 0
        self.in_use = 0
        self.peak_in_use = 0
        self.pinned_bytes = 0

    @staticmethod
    def _key(arr: np.ndarray) -> tuple:
        return tuple(arr.shape), arr.dtype.str

    def lease(self, x: np.ndarray) -> Tuple[np.ndarray, bool]:
        """A domain holding a copy of ``x``, and whether it was reused."""
        key = self._key(x)
        stale: List[np.ndarray] = []
        with self._lock:
            self.leases += 1
            idle = self._idle.get(key)
            dom = idle.pop() if idle else None
            if dom is None:
                for k in [k for k in self._idle if k != key]:
                    stale.extend(self._idle.pop(k))
            else:
                self.reuses += 1
            self.in_use += 1
            self.peak_in_use = max(self.peak_in_use, self.in_use)
        reused = dom is not None
        try:
            for arr in stale:
                self._free(arr)
            if not reused:
                dom = np.empty(x.shape, x.dtype)
            with span("domain_copy"):
                _copy_host(dom, x)
            if not reused:
                with span("pin"):
                    host_register(dom)
                with self._lock:
                    self.pinned_bytes += dom.nbytes
        except BaseException:
            if reused:
                self.release(dom)
            else:
                with self._lock:
                    self.in_use -= 1
            raise
        return dom, reused

    def release(self, dom: np.ndarray) -> None:
        """Take a leased domain back (no copy may still read or write
        it)."""
        with self._lock:
            self.in_use -= 1
            if not self._closed:
                self._idle.setdefault(self._key(dom), []).append(dom)
                return
        self._free(dom)

    def _free(self, dom: np.ndarray) -> None:
        with span("unpin"):
            host_unregister(dom)
        with self._lock:
            self.pinned_bytes -= dom.nbytes

    def close(self) -> None:
        """Unlock and free the idle domains; later releases free theirs."""
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, {}
        for doms in idle.values():
            for dom in doms:
                self._free(dom)

    def __del__(self):
        # at interpreter exit the CUDA runtime may be gone; the process's
        # memory goes with it
        if not sys.is_finalizing():
            self.close()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"leases": self.leases, "reuses": self.reuses,
                    "in_use": self.in_use, "peak_in_use": self.peak_in_use,
                    "idle": sum(len(v) for v in self._idle.values()),
                    "pinned_bytes": self.pinned_bytes}


def _copy_host(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` between host arrays of one shape and dtype, in
    row blocks of at least 16 MiB on up to ``torch.get_num_threads()``
    threads (numpy releases the interpreter lock while it copies, and
    one thread copies at well under the host's memory bandwidth)."""
    blocks = min(torch.get_num_threads(), dst.nbytes >> 24,
                 dst.shape[0] if dst.ndim else 1)
    if blocks <= 1:
        np.copyto(dst, src)
        return
    edges = np.linspace(0, dst.shape[0], blocks + 1).astype(int)
    with ThreadPoolExecutor(blocks) as pool:
        for f in [pool.submit(np.copyto, dst[a:b], src[a:b])
                  for a, b in zip(edges[:-1], edges[1:])]:
            f.result()


def _fresh_like(arr: np.ndarray) -> Callable[[], np.ndarray]:
    """A fresh array of ``arr``'s shape and dtype, its pages faulted in
    by a background thread meanwhile (the first touch of fresh memory
    costs the kernel more than a copy into it); the result, called,
    waits for that thread and returns the array."""
    out = np.empty(arr.shape, arr.dtype)
    pages = out.reshape(-1)[::max(1, mmap.PAGESIZE // out.itemsize)]
    toucher = threading.Thread(target=pages.fill, args=(0,),
                               name="answer-prefault", daemon=True)
    toucher.start()

    def wait() -> np.ndarray:
        toucher.join()
        return out

    return wait


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
    ``ready`` holds each such register's copy event until its first use.
    ``committed_round`` is the newest round whose barrier fully drained
    (-1 = none) and ``on_commit`` the per-round checkpoint hook.
    ``domain_pool`` is the pool the host array was leased from (None for
    a fresh copy, which is the run's answer itself); ``fresh`` then gives
    the answer's own array, faulted in while the run works.
    ``pad_bytes``/``share_bytes`` sum the bytes of the bucket pad's and
    region sharing's concatenations (:class:`ExecStats`)."""

    __slots__ = ("host", "regs", "bufs", "staged", "wire", "device",
                 "copy_stream", "ready", "on_commit", "committed_round",
                 "domain_pool", "domain_reused", "fresh", "pad_bytes",
                 "share_bytes")

    def __init__(self, host: np.ndarray, n_regs: int, n_bufs: int,
                 device: torch.device, regs: Optional[List] = None,
                 bufs: Optional[List] = None, copy_stream=None,
                 domain_pool: Optional[DomainPool] = None,
                 domain_reused: bool = False):
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
        self.on_commit: Optional[Callable[[int, np.ndarray], None]] = None
        self.committed_round = -1
        self.domain_pool = domain_pool
        self.domain_reused = domain_reused
        # the answer's fresh array, made ready while the run works
        self.fresh = _fresh_like(host) if domain_pool is not None else None
        self.pad_bytes = 0
        self.share_bytes = 0

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
        """Drain the staged boxes into the host array (nothing to do when
        none is staged).  The wait for the copy stream and for the rows'
        kernels on the compute stream comes first, so the drain is copies
        alone."""
        if not self.staged:
            return
        with span("commit.wait"):
            if self.copy_stream is not None:
                self.copy_stream.synchronize()   # no copy still reads the host
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        with span("commit.drain"):
            for sl, rows, codec_name in self.staged:
                if codec_name is None:
                    torch.from_numpy(self.host[sl]).copy_(rows)
                    continue
                arr = rows.cpu().numpy()
                # the wire round trip: device-side encode, host-side decode
                codec = get_codec(codec_name)
                self.host[sl] = codec.decode(codec.encode(arr), arr.shape,
                                             arr.dtype)
            self.staged.clear()

    def commit_round(self, rnd: int) -> None:
        """A round's HostCommit barrier: drain staged writes (the copies
        into the host array are synchronous), record the round as the
        recovery point, fire the checkpoint hook — the host array is the
        complete state of the run here."""
        self.commit()
        self.committed_round = rnd
        if self.on_commit is not None:
            self.on_commit(rnd, self.host)

    def answer(self) -> np.ndarray:
        """The run's answer for the caller, after its last commit: the host
        array itself, or a fresh copy of a leased domain (which
        :meth:`retire` hands back)."""
        if self.domain_pool is None:
            return self.host
        with span("answer_copy"):
            out = self.fresh()
            self.fresh = None
            _copy_host(out, self.host)
        return out

    def retire(self) -> None:
        """Hand a leased domain back to its pool once no H2D still reads
        it: the copy stream drains first, on every exit path of a run
        (retired, faulted or failed).  The runtime keeps no handle on it,
        nor on the answer's fresh array when no answer was taken (a
        faulted run's error keeps the runtime alive)."""
        if self.domain_pool is not None:
            if self.copy_stream is not None:
                self.copy_stream.synchronize()
            self.domain_pool.release(self.host)
            self.domain_pool = self.host = self.fresh = None


@dataclasses.dataclass(frozen=True)
class LoweredStage:
    """One pipeline stage: all bound ops in plan order, pre-split into
    the prefetchable prefix (H2D + host-side Compress — ops that only
    read committed host rows and write fresh slots) and the rest.
    ``span`` names a chunk stage in a profiler's trace
    (:mod:`repro_torch.core.trace`)."""

    key: Optional[Tuple[int, int]]      # (round, chunk); None = barrier
    ops: Tuple[BoundOp, ...]
    prefetch: Tuple[BoundOp, ...]
    rest: Tuple[BoundOp, ...]
    span: str = ""


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

    def describe(self) -> dict:
        """Deterministic lowering metrics (no execution): what the bench
        gate records next to the plan's byte accounting."""
        chunk_stages = sum(1 for s in self.stages if s.key is not None)
        return {
            "stage_count": chunk_stages,
            "shape_buckets": self.shape_buckets,
            "kernel_impl": self.kernel_impl,
            "reg_slots": self.n_reg_slots,
            "buf_slots": self.n_buf_slots,
        }

    def runtime(self, x: np.ndarray, slot_pool: Optional[SlotPool] = None,
                copy_stream=None,
                domain_pool: Optional[DomainPool] = None) -> _Runtime:
        """Build the slot-indexed runtime for one run, leasing slot
        storage from ``slot_pool`` and the host domain from
        ``domain_pool`` when given (else the domain is a fresh copy of
        ``x``)."""
        reused = False
        if domain_pool is None:
            with span("domain_copy"):
                host = validate_domain(self.plan, x)
        else:
            check_domain(self.plan, x)
            host, reused = domain_pool.lease(np.asarray(x))
        regs = bufs = None
        if slot_pool is not None:
            regs, bufs = slot_pool.acquire(self.n_reg_slots, self.n_buf_slots)
        return _Runtime(host, self.n_reg_slots, self.n_buf_slots,
                        self.device, regs, bufs, copy_stream, domain_pool,
                        reused)

    @staticmethod
    def release_runtime(rt: _Runtime,
                        slot_pool: Optional[SlotPool]) -> None:
        if slot_pool is not None:
            slot_pool.release(rt.regs, rt.bufs)

    def execute(self, x: np.ndarray, pipeline: bool = False,
                slot_pool: Optional[SlotPool] = None,
                injector=None, retry=None, on_commit=None,
                domain_pool: Optional[DomainPool] = None,
                ) -> Tuple[np.ndarray, TransferStats, ExecStats]:
        """Run the stage programs.

        ``pipeline=True`` issues the next stage's prefetchable ops (H2D
        and host-side Compress) before the current stage's kernels — the
        double-buffered schedule; on CUDA the copies ride a separate
        stream.  The run works on a domain leased from ``domain_pool``
        when given (page-locked there, so the copies are true DMA), else
        on a fresh copy of ``x``.  Results are bitwise identical either
        way: the same kernels run on the same bands in the same order.

        ``injector`` (a :class:`repro_torch.core.faults.FaultInjector`) is
        consulted before every bound op; transient faults are retried in
        place under ``retry`` (a :class:`repro_torch.core.faults.RetryPolicy`),
        terminal faults surface as a typed
        :class:`repro_torch.core.recovery.PlanExecutionError` carrying the
        last committed round; the faulted run's staged rows are dropped.
        ``on_commit(round, host)`` fires after every round's barrier
        drains — the checkpoint hook.  On every exit path the copy stream
        drains before the host domain goes back to its pool, and leased
        slot storage returns to the pool."""
        cuda_pipe = pipeline and self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda_pipe else None
        rt = self.runtime(x, slot_pool, copy_stream, domain_pool)
        rt.on_commit = on_commit
        wall = [0.0] * len(OP_TAGS)
        counts = [0] * len(OP_TAGS)
        hits0, miss0 = self.cache.snapshot()
        f0 = injector.faults_injected if injector is not None else 0
        r0 = injector.retries if injector is not None else 0
        perf = time.perf_counter
        t_run = perf()

        def run(ops: Tuple[BoundOp, ...]) -> None:
            for tag, fn, rnd, chunk in ops:
                if injector is not None:
                    consult(injector, retry, rnd, chunk, OP_TAGS[tag])
                t0 = perf()
                fn(rt)
                wall[tag] += perf() - t0
                counts[tag] += 1

        stages = self.stages
        n = len(stages)
        prefetched = [False] * n
        try:
            for j, stage in enumerate(stages):
                if stage.key is None:       # HostCommit barrier
                    run(stage.ops)
                    continue
                with span(stage.span):
                    # pipelined: prefetch the next chunk's transfers under
                    # this chunk's kernels; never across a barrier (host
                    # rows change there)
                    if pipeline and j + 1 < n \
                            and stages[j + 1].key is not None:
                        run(stages[j + 1].prefetch)
                        prefetched[j + 1] = True
                    run(stage.rest if prefetched[j] else stage.ops)
            rt.commit()   # no-op unless a planner forgot the final barrier
            host = rt.answer()
        except InjectedFault as f:
            from .recovery import PlanExecutionError, plan_fingerprint
            # a faulted round commits nothing; the error's traceback keeps
            # ``rt`` alive, so free its staged device rows now
            rt.staged.clear()
            raise PlanExecutionError(
                f"plan execution failed at round={f.round} "
                f"chunk={f.chunk} op={f.op_class}: {f.kind} "
                f"(last committed round {rt.committed_round})",
                fault=f, last_committed_round=rt.committed_round,
                fingerprint=plan_fingerprint(self.plan)) from f
        finally:
            rt.retire()
            self.release_runtime(rt, slot_pool)

        hits1, miss1 = self.cache.snapshot()
        stats = ExecStats(
            kernel_impl=self.kernel_impl,
            op_counts={OP_TAGS[i]: c for i, c in enumerate(counts) if c},
            op_wall_s={OP_TAGS[i]: wall[i] for i, c in enumerate(counts) if c},
            kernel_calls=counts[_TAG["FusedKernel"]],
            shape_buckets=self.shape_buckets,
            kernel_compiles=miss1 - miss0,
            kernel_cache_hits=hits1 - hits0,
            stage_count=sum(1 for s in stages if s.key is not None),
            lower_s=self.lower_s,
            wall_s=perf() - t_run,
            faults_injected=(injector.faults_injected - f0)
            if injector is not None else 0,
            retries=(injector.retries - r0) if injector is not None else 0,
            pad_bytes=rt.pad_bytes,
            share_bytes=rt.share_bytes,
            domain_reused=int(rt.domain_reused),
        )
        return host, self.plan.stats(), stats


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
            rt.pad_bytes += band.nbytes
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


def _bind_kernel_masked(slot: int, op: FusedKernel, box: Box,
                        origin: Tuple[int, int, int, int],
                        cache: KernelCache, itemsize: int) -> Callable:
    """Bind a hierarchical inner FusedKernel to the globally-masked
    update (:func:`repro_torch.core.distributed.masked_local_steps`).

    ``box`` is the register's ext in band coordinates; ``origin`` maps
    the band into the global framed domain ``(gy0, gx0, Yg, Xg)``.  The
    per-chunk global offsets are call arguments, so every chunk of every
    rank with the same ext shape shares one signature — the JAX package's
    cache key, where they are traced.  No crop here: the masked step
    preserves the ext's frame, and the D2H that follows selects only the
    rows/cols at halo depth."""
    from .distributed import masked_local_steps
    from .stencil import get_stencil

    st = get_stencil(op.stencil)
    gy0, gx0, Yg, Xg = origin
    key = ("hier", op.stencil, op.steps, op.shape_in, Yg, Xg, itemsize)
    oy, ox = gy0 + box.lo[0], gx0 + box.lo[1]
    steps = op.steps

    def make() -> Callable:
        def f(ext, y0, x0):
            return masked_local_steps(ext, st, steps, y0, x0, Yg, Xg)
        return f

    def run(rt):
        fn = cache.lookup(key, make)
        rt.regs[slot] = fn(rt.reg(slot), oy, ox)

    return run


def lower(plan: ExecutionPlan, policy=None, fused_step=None,
          kernel_cache: Optional[KernelCache] = None,
          bucket_registry: Optional[BucketRegistry] = None,
          shard_origin: Optional[Tuple[int, int, int, int]] = None,
          device=None) -> CompiledPlan:
    """Compile a plan into stage programs of slot-bound closures for
    ``device`` (None means ``cuda``).

    ``fused_step`` (an explicit ``fn(band, name, steps, keep_top=...,
    keep_bottom=...)`` callable) overrides the dispatch registry;
    otherwise ``policy`` (a :class:`repro_torch.kernels.dispatch.DispatchPolicy`,
    default ``auto``) picks the implementation per stencil/steps and the
    device's backend.  ``kernel_cache`` lets an executor share one
    signature cache across plans and runs; ``bucket_registry`` routes
    this plan's band heights to already-registered cross-plan buckets.

    ``shard_origin`` switches the kernel binding to hierarchical inner
    semantics: the plan's domain is one shard's halo-extended band at
    global origin ``(gy0, gx0)`` inside a ``(Yg, Xg)`` framed domain,
    and every FusedKernel runs the globally-masked update instead of
    the frame-shrinking fused step (:func:`_bind_kernel_masked`)."""
    from repro_torch.kernels.dispatch import DispatchPolicy, select_kernel

    t0 = time.perf_counter()
    device = resolve_device(device)
    policy = policy or DispatchPolicy()
    cache = kernel_cache if kernel_cache is not None else KernelCache()
    buckets = _bucket_heights(plan, policy.bucket, bucket_registry)
    # band-coordinate ext of each live register, tracked only for the
    # masked (shard_origin) binding, which needs the global offset
    reg_boxes: Dict[str, Box] = {}

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
            def run_commit(rt, _r=op.round):
                rt.commit_round(_r)

            emit(None, "HostCommit", run_commit, site=(op.round, -1))
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
            if shard_origin is not None:
                reg_boxes[op.reg] = op.box
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
            if shard_origin is not None:
                # the buffer's extent slices prepend at the low side
                sbox = reg_boxes.pop(op.src)
                reg_boxes[op.reg] = sbox.with_axis(
                    op.axis, sbox.lo[op.axis] - op.extent, sbox.hi[op.axis])

            def run(rt, _b=bslot, _src=src_slot, _dst=dst_slot, _ax=op.axis):
                shared = rt.bufs[_b]
                rt.bufs[_b] = None
                src = rt.reg(_src)
                if _src != _dst:
                    rt.regs[_src] = None
                out = rt.regs[_dst] = torch.cat([shared, src], dim=_ax)
                rt.share_bytes += out.nbytes

            emit(key, "BufferRead", run)
        elif isinstance(op, FusedKernel):
            slot = regs.get(op.reg)
            if shard_origin is not None:
                # hierarchical inner kernel: globally-masked update, one
                # signature per ext shape (origins are call arguments)
                signatures.add(("hier", op.stencil, op.steps, op.shape_in))
                nd_impls.add("masked_hier")
                emit(key, "FusedKernel",
                     _bind_kernel_masked(slot, op, reg_boxes[op.reg],
                                         shard_origin, cache, plan.itemsize))
                continue
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
            if shard_origin is not None:
                reg_boxes.pop(op.reg, None)
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
        lowered_stages.append(LoweredStage(
            key=key, ops=ops, prefetch=prefetch, rest=rest,
            span=f"stage.r{key[0]}.c{key[1]}" if key is not None else ""))
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


# --------------------------------------------------------------------------
# Sharded-plan lowering: per-rank streams -> global phase-ordered stage
# programs, executed in lockstep on one device (the simulator behind
# repro_torch.core.executor.ShardedSimExecutor).  Reuses the slot binder
# for rank bands and the KernelCache for the masked shard kernel — shards
# are uniform, so every rank and round shares ONE signature (the
# per-rank global origin is a call argument, not part of the key).
# --------------------------------------------------------------------------


def _edge(band: torch.Tensor, axis: int, side: str, depth: int):
    """The ``depth`` edge rows (axis 0) or columns (axis 1) of a band on
    its ``side`` — a view."""
    if axis == 0:
        return band[-depth:] if side == "hi" else band[:depth]
    return band[:, -depth:] if side == "hi" else band[:, :depth]


class _ShardRuntime:
    """Slot-indexed per-rank band state + the halo mailbox the bound
    closures run against.  ``mail`` is keyed ``(src, dst, axis, round)``
    — unique per exchange because each ordered rank pair swaps at most
    one payload per axis per round; with a halo codec the value is the
    encoded ``(payload, shape, dtype)`` wire triple instead of the edge
    tensor.  ``slot_pool`` (optional) is the shared pool hierarchical
    inner plans lease their chunk-slot storage from."""

    __slots__ = ("host", "bands", "mail", "staged", "slot_pool", "device")

    def __init__(self, host: np.ndarray, n_slots: int, device: torch.device,
                 slot_pool=None):
        self.host = host
        self.bands: List = [None] * n_slots
        self.mail: Dict[tuple, object] = {}
        self.staged: List[tuple] = []   # (host slice tuple, device band)
        self.slot_pool = slot_pool
        self.device = device

    def commit(self) -> None:
        """One synchronize, then a copy of each staged band into its host
        slice (a strided slice when the mesh has more than one column)."""
        if self.staged and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for sl, rows in self.staged:
            torch.from_numpy(self.host[sl]).copy_(rows)
        self.staged.clear()


@dataclasses.dataclass(frozen=True)
class ShardStage:
    """One global phase: every rank's bound ops, rank order.  Phase
    boundaries are the plan's barrier structure — an executor must drain
    a stage before starting the next (sends and recvs never share one)."""

    label: str
    ops: Tuple[BoundOp, ...]


def _bind_hier_kernel(slot: int, hk: int, inner: CompiledPlan) -> Callable:
    """Bind a ShardKernel to its expanded inner plan (hierarchical
    execution): the rank's halo-extended band crosses to the host and
    becomes the inner plan's host domain, the nested stage programs
    stream it chunk-wise through the ordinary H2D/kernel/D2H path
    (leasing slot storage from the shared pool when one rides on the
    runtime, and releasing it on every exit path), and the updated owned
    region is cropped and copied back — exactly what the flat masked
    kernel's crop produces, because the inner kernels run the same
    globally-masked update on ext regions whose write-back depth equals
    the halo."""

    def run(rt):
        band = rt.bands[slot].cpu().numpy()
        host, _, _ = inner.execute(band, slot_pool=rt.slot_pool)
        rt.bands[slot] = to_device(host[hk:-hk, hk:-hk] if hk else host,
                                   rt.device)

    return run


def _bind_shard_kernel(slot: int, op: ShardKernel, plan: ShardedPlan,
                       cache: KernelCache) -> Callable:
    from .distributed import masked_local_steps
    from .stencil import get_stencil

    st = get_stencil(op.stencil)
    hk = op.steps * st.radius
    # one signature per (stencil, steps, band shape, domain): gy0/gx0 are
    # call arguments, so all ranks and rounds hit the same entry
    key = ("shard", op.stencil, op.steps, op.h, op.w, plan.Y, plan.X,
           plan.itemsize)
    gy0, gx0, steps, Y, X = op.gy0, op.gx0, op.steps, plan.Y, plan.X

    def make() -> Callable:
        def f(ext, y0, x0):
            out = masked_local_steps(ext, st, steps, y0, x0, Y, X)
            return out[hk:-hk, hk:-hk] if hk else out
        return f

    def run(rt):
        fn = cache.lookup(key, make)
        rt.bands[slot] = fn(rt.bands[slot], gy0, gx0)

    return run


@dataclasses.dataclass
class CompiledShardedPlan:
    """A lowered :class:`~repro_torch.core.plan.ShardedPlan` (or
    hierarchical plan): phase-ordered stage programs of slot-bound
    closures over a shared halo mailbox, for one device."""

    plan: object
    stages: Tuple[ShardStage, ...]
    n_slots: int
    shape_buckets: int
    cache: KernelCache
    lower_s: float
    device: torch.device
    kernel_impl: str = "shard_sim"

    def describe(self) -> dict:
        return {
            "stage_count": len(self.stages),
            "shape_buckets": self.shape_buckets,
            "kernel_impl": self.kernel_impl,
            "reg_slots": self.n_slots,
            "buf_slots": 0,
        }

    def execute(self, x: np.ndarray, injector=None, retry=None,
                slot_pool: Optional[SlotPool] = None,
                ) -> Tuple[np.ndarray, TransferStats, ExecStats]:
        """Run every phase in barrier order (all ranks lockstep) and
        return ``(host, plan stats, ExecStats)``.

        ``injector``/``retry`` mirror :meth:`CompiledPlan.execute`, with
        the op site's chunk field addressing the *rank* — a
        ``rank_loss`` trigger at ``(round, rank)`` fires mid-round, after
        that round's loads/halos already moved.  Sharded plans commit
        host state once at the end, so a terminal fault surfaces with
        ``last_committed_round = -1``; the elastic harness
        (:mod:`repro_torch.launch.elastic`) recovers round granularity by
        executing one-round continuation plans.

        ``slot_pool`` is only consulted by hierarchical plans: each
        expanded ShardKernel leases its inner chunk-slot storage from
        the pool and releases it when the nested run retires (also on
        fault paths), so :meth:`SlotPool.assert_balanced` holds after
        any exit."""
        rt = _ShardRuntime(validate_domain(self.plan, x), self.n_slots,
                           self.device, slot_pool=slot_pool)
        wall = [0.0] * len(OP_TAGS)
        counts = [0] * len(OP_TAGS)
        hits0, miss0 = self.cache.snapshot()
        f0 = injector.faults_injected if injector is not None else 0
        r0 = injector.retries if injector is not None else 0
        perf = time.perf_counter
        t_run = perf()
        try:
            for stage in self.stages:
                for tag, fn, rnd, rank in stage.ops:
                    if injector is not None:
                        consult(injector, retry, rnd, rank, OP_TAGS[tag])
                    t0 = perf()
                    fn(rt)
                    wall[tag] += perf() - t0
                    counts[tag] += 1
            rt.commit()
        except InjectedFault as f:
            from .recovery import PlanExecutionError, plan_fingerprint
            # nothing of a faulted sharded run is committed; the error's
            # traceback keeps ``rt`` alive, so free its device bands now
            rt.staged.clear()
            rt.mail.clear()
            rt.bands[:] = [None] * len(rt.bands)
            raise PlanExecutionError(
                f"sharded plan failed at round={f.round} rank={f.chunk} "
                f"op={f.op_class}: {f.kind}",
                fault=f, last_committed_round=-1,
                fingerprint=plan_fingerprint(self.plan)) from f
        hits1, miss1 = self.cache.snapshot()
        stats = ExecStats(
            kernel_impl=self.kernel_impl,
            op_counts={OP_TAGS[i]: c for i, c in enumerate(counts) if c},
            op_wall_s={OP_TAGS[i]: wall[i] for i, c in enumerate(counts) if c},
            kernel_calls=counts[_TAG["ShardKernel"]],
            shape_buckets=self.shape_buckets,
            kernel_compiles=miss1 - miss0,
            kernel_cache_hits=hits1 - hits0,
            stage_count=len(self.stages),
            lower_s=self.lower_s,
            wall_s=perf() - t_run,
            faults_injected=(injector.faults_injected - f0)
            if injector is not None else 0,
            retries=(injector.retries - r0) if injector is not None else 0,
        )
        return rt.host, self.plan.stats(), stats


def lower_sharded(plan, kernel_cache: Optional[KernelCache] = None,
                  device=None) -> CompiledShardedPlan:
    """Compile a sharded plan's per-rank streams into global stage
    programs for ``device`` (None means ``cuda``).

    Each rank's evolving band (own -> row-extended -> fully-extended ->
    cropped own) binds to one slot via the same :class:`_SlotAllocator`
    the single-device lowering uses; halo ops become mailbox closures;
    :class:`~repro_torch.core.plan.ShardKernel` ops dispatch through the
    keyed :class:`KernelCache` — uniform shards mean exactly one kernel
    signature for the whole plan (``shape_buckets == 1``).

    Accepts a :class:`~repro_torch.core.hierarchy.HierarchicalPlan` too:
    the outer streams lower exactly as above, except each ShardKernel
    binds to its rank's nested inner plan — itself lowered through
    :func:`lower` in masked ``shard_origin`` mode, sharing this plan's
    :class:`KernelCache` so inner signatures surface in the same
    counters.

    A non-identity halo codec (``plan.codec``) runs for real: the
    ``HaloCompress`` closure copies the edge payload to the host and
    encodes it — the mailbox then carries the encoded wire triple — and
    the paired ``HaloRecv`` decodes and copies it back to the device
    before attaching, so lossless codecs round-trip bit-exactly through
    actual encoded bytes while the accounting stays plan-derived.  The
    ``identity`` codec is fast-pathed (a clone of the edge is the
    copy)."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    hplan = None
    if not isinstance(plan, ShardedPlan) and hasattr(plan, "outer"):
        # HierarchicalPlan (duck-typed: hierarchy.py must stay importable
        # without this module)
        hplan = plan
        outer = plan.outer
    else:
        outer = plan
    if outer.trailing:
        raise ValueError(
            f"plan models trailing axes {outer.trailing}; trailing plans "
            "are dry-run-only (byte/flop accounting) and cannot execute")
    cache = kernel_cache if kernel_cache is not None else KernelCache()
    regs = _SlotAllocator()
    signatures = set()
    stages: List[ShardStage] = []
    hk = outer.k_ici * outer.radius

    halo_codec = None
    if outer.codec and outer.codec != "identity":
        halo_codec = get_codec(outer.codec)

    inner_compiled = {}
    if hplan is not None:
        for rank, sh in enumerate(outer.shards):
            origin = (sh.y0 - hk, sh.x0 - hk, outer.Y, outer.X)
            inner_compiled[rank] = lower(
                hplan.inner[rank], shard_origin=origin, kernel_cache=cache,
                device=device)
            # uniform shards -> every rank's inner plan presents the same
            # ext shapes, so the signature census dedupes across ranks
            for iop in hplan.inner[rank].ops:
                if isinstance(iop, FusedKernel):
                    signatures.add(("hier", iop.stencil, iop.steps,
                                    iop.shape_in))

    for ordinal, (label, ops) in enumerate(outer.phases()):
        regs.new_stage(ordinal)
        bound: List[BoundOp] = []
        for op in ops:
            if isinstance(op, ShardLoad):
                slot = regs.alloc(f"band:{op.rank}")
                sl = op.box.slices()

                def run(rt, _s=slot, _sl=sl):
                    rt.bands[_s] = to_device(rt.host[_sl], rt.device)

                bound.append((_TAG["ShardLoad"], run, op.round, op.rank))
            elif isinstance(op, HaloCompress):
                if halo_codec is None:
                    bound.append((_TAG["HaloCompress"], _noop,
                                  op.round, op.rank))
                else:
                    # the encode IS the send: the mailbox carries the
                    # encoded wire triple instead of the edge tensor
                    slot = regs.get(f"band:{op.rank}")
                    mkey = (op.rank, op.peer, op.axis, op.round)

                    def run(rt, _s=slot, _k=mkey, _a=op.axis, _e=op.side,
                            _d=hk, _c=halo_codec):
                        rows = np.ascontiguousarray(
                            _edge(rt.bands[_s], _a, _e, _d).cpu().numpy())
                        rt.mail[_k] = (_c.encode(rows), rows.shape,
                                       rows.dtype)

                    bound.append((_TAG["HaloCompress"], run,
                                  op.round, op.rank))
            elif isinstance(op, HaloSend):
                if halo_codec is not None:
                    # wire hop already happened at the HaloCompress
                    bound.append((_TAG["HaloSend"], _noop,
                                  op.round, op.rank))
                    continue
                slot = regs.get(f"band:{op.rank}")
                mkey = (op.rank, op.dst, op.axis, op.round)

                def run(rt, _s=slot, _k=mkey, _a=op.axis, _e=op.side,
                        _d=op.depth):
                    # a clone: the payload must not alias the band
                    rt.mail[_k] = _edge(rt.bands[_s], _a, _e, _d).clone()

                bound.append((_TAG["HaloSend"], run, op.round, op.rank))
            elif isinstance(op, HaloRecv):
                slot = regs.get(f"band:{op.rank}")
                mkey = (op.src, op.rank, op.axis, op.round)

                def run(rt, _s=slot, _k=mkey, _a=op.axis, _e=op.side,
                        _d=op.depth, _src=op.src, _c=halo_codec):
                    band = rt.bands[_s]
                    if _src < 0:
                        # mesh edge: zero fill, what ppermute leaves for
                        # non-receivers (masked, never read by valid cells)
                        shape = ((_d, band.shape[1]) if _a == 0
                                 else (band.shape[0], _d))
                        payload = torch.zeros(shape, dtype=band.dtype,
                                              device=band.device)
                    elif _c is not None:
                        wire, shape, dtype = rt.mail.pop(_k)
                        payload = to_device(_c.decode(wire, shape, dtype),
                                            rt.device)
                    else:
                        payload = rt.mail.pop(_k)
                    pair = [payload, band] if _e == "lo" else [band, payload]
                    rt.bands[_s] = torch.cat(pair, dim=_a)

                bound.append((_TAG["HaloRecv"], run, op.round, op.rank))
            elif isinstance(op, HaloDecompress):
                # decode runs at the paired HaloRecv (the payload must
                # materialize before it is concatenated anyway)
                bound.append((_TAG["HaloDecompress"], _noop,
                              op.round, op.rank))
            elif isinstance(op, ShardKernel):
                slot = regs.get(f"band:{op.rank}")
                if hplan is not None:
                    bound.append((_TAG["ShardKernel"],
                                  _bind_hier_kernel(
                                      slot, hk, inner_compiled[op.rank]),
                                  op.round, op.rank))
                    continue
                signatures.add((op.stencil, op.steps, op.h, op.w))
                bound.append((_TAG["ShardKernel"],
                              _bind_shard_kernel(slot, op, outer, cache),
                              op.round, op.rank))
            elif isinstance(op, ShardStore):
                slot = regs.free(f"band:{op.rank}", ordinal)
                sl = op.box.slices()

                def run(rt, _s=slot, _sl=sl):
                    band = rt.bands[_s]
                    rt.bands[_s] = None
                    rt.staged.append((_sl, band))

                bound.append((_TAG["ShardStore"], run, op.round, op.rank))
            else:  # pragma: no cover - planner/lowering version skew
                raise TypeError(f"unknown sharded op {op!r}")
        stages.append(ShardStage(label=label, ops=tuple(bound)))

    return CompiledShardedPlan(
        plan=plan,   # the hierarchical wrapper when given one: stats()
        stages=tuple(stages),     # must report both levels
        n_slots=regs.n_slots,
        shape_buckets=len(signatures),
        cache=cache,
        lower_s=time.perf_counter() - t0,
        device=device,
        kernel_impl="shard_sim+hier" if hplan is not None else "shard_sim",
    )
