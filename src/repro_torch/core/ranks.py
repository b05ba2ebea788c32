"""Rank processes for the multi-process sharded backend: a
:class:`RankMesh` is the port's counterpart of the JAX device mesh that
:mod:`repro.core.distributed` runs its ``shard_map`` program on.

The JAX backend is one controller driving many devices.  In PyTorch each
rank is a process, so a ``RankMesh`` of shape ``(n_0, n_1)`` owns
``n_0 * n_1`` worker processes joined into one ``torch.distributed``
process group.  Rank ``p`` sits at mesh coordinates ``divmod(p, n_1)``
(row-major, the JAX mesh's device order), so fault triggers,
:func:`~repro_torch.launch.elastic.shrink_mesh` and a sharded plan's
per-rank streams name the same process.

Lifetime.  The workers start with the ``spawn`` method (CUDA cannot be
forked) when the mesh is built, and meet through a ``file://``
rendezvous in a private temp directory (no TCP port to race for).
Importing this module starts nothing.  :meth:`RankMesh.close`, the
context manager, or a ``weakref.finalize`` fallback stops them; the
workers are daemonic, and one whose parent dies exits at its next read.

Transport (a rule, not a fallback).  On ``device="cpu"`` the group runs
gloo over CPU tensors.  On CUDA it runs NCCL when every rank has a card
of its own (world size <= ``torch.cuda.device_count()``; rank ``p`` on
``cuda:p``, or the requested card at world size 1); otherwise all ranks
share the requested card and the group runs gloo with host staging:
each band stays on the card and each halo crosses as D2H into a
page-locked buffer, gloo send/recv, then H2D.  A group that cannot
initialise its backend raises; nothing drops to another backend or to
the CPU.

Domain in and out.  The parent writes the caller's domain to a scratch
file in the mesh's temp directory (the caller's array is never
written); each rank reads its owned block with positioned reads, one
per block row (one in all when the block spans the width), into a host
block that is page-locked on CUDA so both of its copies are DMA, and at
the end writes the block back over the same bytes (blocks are
disjoint); the parent reads the file back and deletes it.  A 38400²
fp32 domain is 5.9 GB, more than a container's ``/dev/shm`` usually
holds.  Writes go through ``pwrite``, not a shared mapping, whose
page-by-page write faults made eight ranks' stores of that domain take
14 s on the H100 machine.

Deadlines.  Every wait has one: ``init_process_group(timeout=...)`` (so
a rank blocked in a halo exchange gives up), the parent's wait for each
rank's reply, and the join at close.  When a rank raises or dies, or a
deadline passes, the parent kills the whole group and raises
:class:`RankFailure` carrying the rank's traceback text.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import time
import traceback
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["RankMesh", "RankFailure"]

DEFAULT_TIMEOUT_S = 600.0
_CLOSE_GRACE_S = 30.0


class RankFailure(RuntimeError):
    """A rank of a :class:`RankMesh` raised, died, or missed its
    deadline; the message carries the rank's traceback text."""


# --------------------------------------------------------------------------
# Inside a rank process
# --------------------------------------------------------------------------


class _RankContext:
    """What a rank's program sees: its place in the mesh, its device, and
    whether halos cross through host staging.  ``sizes`` is the mesh
    shape in axis order; ``row_axis``/``col_axis`` are the mesh axes the
    domain's rows and columns are sharded over (indices into
    ``sizes``)."""

    def __init__(self, rank: int, sizes: Tuple[int, int],
                 device: torch.device, staged: bool):
        self.rank = rank
        self.sizes = sizes
        self.coords = divmod(rank, sizes[1])
        self.device = device
        self.staged = staged
        self.row_axis, self.col_axis = 0, 1
        self.halo_s = 0.0
        self.update_s = 0.0
        self.update_ms = 0.0          # CUDA events; 0 on the CPU
        self.update_calls = 0
        self._events: List[tuple] = []

    @property
    def row(self) -> int:
        return self.coords[self.row_axis]

    @property
    def col(self) -> int:
        return self.coords[self.col_axis]

    def neighbour(self, axis: int, delta: int) -> Optional[int]:
        """The rank ``delta`` steps along mesh axis ``axis``, or None past
        the mesh edge."""
        c = list(self.coords)
        c[axis] += delta
        if not 0 <= c[axis] < self.sizes[axis]:
            return None
        return c[0] * self.sizes[1] + c[1]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed_update(self, fn):
        """Run the masked update ``fn()``; its host wall (to the end of
        its device work) and, on CUDA, its event-timed device ms add up
        over the job."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self._events.append((start, end))
        else:
            out = fn()
        self.sync()
        self.update_s += time.perf_counter() - t0
        self.update_calls += 1
        return out

    def timed_halo(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self.halo_s += time.perf_counter() - t0
        return out

    def close_events(self) -> None:
        self.update_ms = sum(s.elapsed_time(e) for s, e in self._events)
        self._events.clear()


_IO_CHUNK = 1 << 30      # bytes per positioned read/write call


def _block_io(fd: int, block: np.ndarray, y0: int, x0: int, X: int,
              write: bool) -> None:
    """Move ``block`` (C-contiguous, ``(ly, lx)``) to or from rows
    ``y0:y0+ly``, columns ``x0:x0+lx`` of a row-major ``(*, X)`` array
    stored in the file ``fd``: one run of bytes per block row, or one
    for the whole block when it spans the width."""
    ly, lx = block.shape
    item = block.itemsize
    flat = block.reshape(-1).view(np.uint8)
    if lx == X:
        runs = [(y0 * X * item, flat)]
    else:
        row = lx * item
        runs = [((y0 + i) * X * item + x0 * item,
                 flat[i * row:(i + 1) * row]) for i in range(ly)]
    for offset, buf in runs:
        done = 0
        while done < buf.nbytes:
            part = buf[done:done + _IO_CHUNK]
            n = (os.pwrite(fd, part, offset + done) if write
                 else os.preadv(fd, [part], offset + done))
            if n <= 0:
                raise OSError(f"short {'write' if write else 'read'} at "
                              f"byte {offset + done} of the domain file")
            done += n


def _run_job(ctx: _RankContext, job: dict) -> dict:
    """One call of the rank program: load the owned block from the
    domain file, run the rounds, write the block back."""
    from .distributed import _local_rounds
    from .lower import host_register, host_unregister
    from .stencil import get_stencil

    t0 = time.perf_counter()
    ctx.row_axis, ctx.col_axis = job["axes"]
    n_row, n_col = ctx.sizes[ctx.row_axis], ctx.sizes[ctx.col_axis]
    Y, X = job["shape"]
    ly, lx = Y // n_row, X // n_col
    rows = slice(ctx.row * ly, (ctx.row + 1) * ly)
    cols = slice(ctx.col * lx, (ctx.col + 1) * lx)
    # one host block per job: read from the file, page-locked on CUDA so
    # both copies are DMA, and written back from
    block = np.empty((ly, lx), dtype=np.dtype(job["dtype"]))
    fd = os.open(job["path"], os.O_RDWR)
    locked = False
    try:
        _block_io(fd, block, rows.start, cols.start, X, write=False)
        if ctx.device.type == "cuda":
            host_register(block)
            locked = True
        own = torch.from_numpy(block).to(ctx.device)
        ctx.sync()
        t_load = time.perf_counter()
        if job.get("fail_rank") == ctx.rank:
            raise RuntimeError(f"fault drill: rank {ctx.rank} raises "
                               "before its first halo exchange")
        own = _local_rounds(own, get_stencil(job["stencil"]), job["k"],
                            job["rounds"], ctx, Y, X)
        ctx.sync()
        t_rounds = time.perf_counter()
        torch.from_numpy(block).copy_(own)
        _block_io(fd, block, rows.start, cols.start, X, write=True)
        t_store = time.perf_counter()
    finally:
        os.close(fd)
        if locked:
            host_unregister(block)
    ctx.close_events()
    out = dict(rank=ctx.rank, load_s=t_load - t0,
               rounds_s=t_rounds - t_load, store_s=t_store - t_rounds,
               halo_s=ctx.halo_s, update_s=ctx.update_s,
               update_ms=ctx.update_ms, update_calls=ctx.update_calls)
    del own
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _rank_main(rank: int, sizes: Tuple[int, int], init_file: str,
               backend: str, device: str, staged: bool, timeout_s: float,
               conn) -> None:
    """Entry point of a rank process: join the group, then serve jobs
    from the parent until told to stop (or the parent is gone)."""
    import torch.distributed as dist

    world = sizes[0] * sizes[1]
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        # a first collective every rank joins (NCCL wants the group's
        # first call to be a whole-group one)
        probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        if int(probe.item()) != world:
            raise RuntimeError(f"group handshake summed {probe.item()}, "
                               f"expected {world}")
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        conn.send(("ready", dict(rank=rank, device=str(dev), name=name)))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):      # the parent is gone
                break
            if msg[0] == "stop":
                break
            ctx = _RankContext(rank, tuple(sizes), dev, staged)
            try:
                conn.send(("done", _run_job(ctx, msg[1])))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# In the parent
# --------------------------------------------------------------------------


def _shutdown(procs, conns, tmpdir: str, kill: bool) -> None:
    """Stop a group: ask each rank to stop (unless ``kill``), join them
    within the grace period, kill what is left, remove the temp dir."""
    if not kill:
        for p, c in zip(procs, conns):
            if p.is_alive():
                try:
                    c.send(("stop",))
                except OSError:     # a dead rank's pipe
                    pass
    deadline = time.monotonic() + (0.0 if kill else _CLOSE_GRACE_S)
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)
    for c in conns:
        c.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


class RankMesh:
    """A ``shape`` grid of rank processes in one ``torch.distributed``
    group, with named axes (``shape`` maps each axis name to its size,
    as a JAX mesh's does).

    ``device`` (None means ``cuda``) picks the transport by the rule in
    the module docstring; ``timeout`` (seconds) bounds the group's
    start, every job and every collective.  The group starts here;
    close it with :meth:`close` or ``with``."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"),
                 device=None, timeout: float = DEFAULT_TIMEOUT_S):
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != 2 or min(sizes) < 1 or len(axis_names) != 2:
            raise ValueError(f"bad mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.sizes: Tuple[int, int] = sizes
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = sizes[0] * sizes[1]
        self.device = resolve_device(device)
        self.timeout = float(timeout)
        if self.device.type == "cpu":
            backend, staged, self.transport = "gloo", False, "gloo"
            devices = ["cpu"] * self.size
        elif self.size <= torch.cuda.device_count():
            backend, staged, self.transport = "nccl", False, "nccl"
            devices = [f"cuda:{p}" for p in range(self.size)] \
                if self.size > 1 else [str(self._card())]
        else:
            backend, staged, self.transport = "gloo", True, \
                "gloo+host-staging"
            devices = [str(self._card())] * self.size
        self.last_run: Optional[dict] = None
        t0 = time.perf_counter()
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        self._finalizer = weakref.finalize(
            self, _shutdown, self._procs, self._conns, self._tmp, False)
        try:
            for rank in range(self.size):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(
                    target=_rank_main, daemon=True,
                    name=f"repro_torch-rank{rank}",
                    args=(rank, sizes, os.path.join(self._tmp, "rendezvous"),
                          backend, devices[rank], staged, self.timeout,
                          theirs))
                p.start()
                theirs.close()
                self._procs.append(p)
                self._conns.append(mine)
            self.rank_devices = self._collect("ready")
        except BaseException:
            self._abort()
            raise
        self.start_s = time.perf_counter() - t0

    def _card(self) -> torch.device:
        """The requested card with its index (a rank process calls
        ``torch.cuda.set_device`` on it)."""
        index = self.device.index
        return torch.device("cuda", torch.cuda.current_device()
                            if index is None else index)

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    @property
    def processes(self) -> Tuple[mp.process.BaseProcess, ...]:
        return tuple(self._procs)

    def close(self) -> None:
        """Stop every rank (idempotent)."""
        self._finalizer()

    def __enter__(self) -> "RankMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self.closed else self.transport
        return f"RankMesh({self.shape}, device={self.device}, {state})"

    def _abort(self) -> None:
        if self._finalizer.detach() is not None:
            _shutdown(self._procs, self._conns, self._tmp, kill=True)

    def _fail(self, msg: str):
        self._abort()
        raise RankFailure(msg)

    def _collect(self, kind: str) -> List[dict]:
        """Each rank's reply of ``kind``, in rank order, within the
        deadline; any error, death or timeout kills the group."""
        deadline = time.monotonic() + self.timeout
        replies: Dict[int, dict] = {}
        while len(replies) < self.size:
            pending = [r for r in range(self.size) if r not in replies]
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"ranks {pending} of {self!r} sent no "
                           f"{kind!r} reply within {self.timeout:g} s")
            waitables = [self._conns[r] for r in pending] + \
                [self._procs[r].sentinel for r in pending]
            ready = mpc.wait(waitables, timeout=left)
            for r in pending:
                conn, proc = self._conns[r], self._procs[r]
                if conn in ready or conn.poll():
                    try:
                        tag, body = conn.recv()
                    except (EOFError, OSError):
                        proc.join(1.0)
                        self._fail(f"rank {r} of {self!r} closed its pipe "
                                   f"(exit code {proc.exitcode})")
                    if tag == "error":
                        self._fail(f"rank {r} of {self!r} raised:\n{body}")
                    if tag != kind:
                        self._fail(f"rank {r} replied {tag!r}, expected "
                                   f"{kind!r}")
                    replies[r] = body
                elif proc.sentinel in ready:
                    proc.join(1.0)
                    self._fail(f"rank {r} of {self!r} died (exit code "
                               f"{proc.exitcode})")
        return [replies[r] for r in range(self.size)]

    def run(self, x: np.ndarray, stencil: str, k: int, rounds: int,
            row_axis: str, col_axis: str,
            fail_rank: Optional[int] = None) -> np.ndarray:
        """``rounds`` rounds of (halo exchange + ``k`` masked steps) of
        ``stencil`` on the framed host domain ``x``, rows sharded over
        ``row_axis`` and columns over ``col_axis``; returns the new
        domain (a fresh array; ``x`` is not written).  ``fail_rank`` is a
        fault drill: that rank raises before its first exchange while
        its peers wait on it.  Timings land in :attr:`last_run`."""
        if self.closed:
            raise RuntimeError(f"{self!r} is closed")
        x = np.asarray(x)
        axes = (self.axis_names.index(row_axis),
                self.axis_names.index(col_axis))
        if x.ndim != 2 or sorted(axes) != [0, 1]:
            raise ValueError(f"need a 2-D domain sharded over both mesh "
                             f"axes, got {x.shape} over {row_axis!r}, "
                             f"{col_axis!r}")
        n_row, n_col = self.sizes[axes[0]], self.sizes[axes[1]]
        Y, X = x.shape
        if Y % n_row or X % n_col:
            raise ValueError(f"domain {x.shape} does not divide evenly "
                             f"over mesh ({n_row}, {n_col})")
        path = os.path.join(self._tmp, "domain.bin")
        t0 = time.perf_counter()
        x.tofile(path)
        t_in = time.perf_counter()
        job = dict(path=path, shape=(Y, X), dtype=x.dtype.str,
                   stencil=stencil, k=int(k), rounds=int(rounds), axes=axes,
                   fail_rank=fail_rank)
        for r, c in enumerate(self._conns):
            try:
                c.send(("run", job))
            except OSError:
                self._fail(f"rank {r} of {self!r} is gone (exit code "
                           f"{self._procs[r].exitcode})")
        ranks = self._collect("done")
        t_run = time.perf_counter()
        out = np.fromfile(path, dtype=x.dtype).reshape(Y, X)
        os.remove(path)
        t_out = time.perf_counter()
        self.last_run = dict(domain_in_s=t_in - t0, ranks_s=t_run - t_in,
                             domain_out_s=t_out - t_run, ranks=ranks)
        return out
