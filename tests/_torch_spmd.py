"""SPMD rank processes for the port's launch-layer tests (not a test
module): ``run_spmd(fn, world, *args)`` starts ``world`` processes
joined by gloo over CPU tensors, runs ``fn(rank, world, *args)`` in each
and returns the ranks' results in rank order.

Every wait has a deadline: the group's own timeout (a rank blocked in a
collective gives up), the wait for each rank's reply, and the join.  A
rank that raises or dies, or a deadline that passes, kills every rank
and raises with the rank's traceback.  No rank process outlives the
call.  ``fn`` must be importable by name (a module-level function of a
module without JAX), because the ranks start with ``spawn``.
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

RANK_PREFIX = "repro_torch-spmd"


def _rank_main(fn, rank: int, world: int, init: str, timeout: float,
               args: tuple, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            conn.send(("ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the call
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def spmd_processes() -> list:
    return [p for p in mp.active_children() if p.name.startswith(RANK_PREFIX)]


def run_spmd(fn, world: int, *args, timeout: float = 120.0) -> list:
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_spmd")
    init = "file://" + os.path.join(tmp, "init")
    procs, conns = [], []
    done = False
    try:
        for r in range(world):
            parent, child = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, name=f"{RANK_PREFIX}{r}",
                            args=(fn, r, world, init, timeout, args, child),
                            daemon=True)
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        deadline = time.monotonic() + timeout
        out = [None] * world
        pending = dict(enumerate(conns))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(pending)} missed the "
                                   f"{timeout:.0f} s deadline")
            for c in mpc.wait(list(pending.values()), timeout=left):
                r = next(k for k, v in pending.items() if v is c)
                try:
                    kind, val = c.recv()
                except EOFError:
                    raise RuntimeError(f"rank {r} died "
                                       f"(exit code {procs[r].exitcode})")
                if kind == "error":
                    raise RuntimeError(f"rank {r} raised:\n{val}")
                out[r] = val
                del pending[r]
        done = True
        return out
    finally:
        for p in procs:
            if not done:
                p.kill()
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        for c in conns:
            c.close()
        shutil.rmtree(tmp, ignore_errors=True)
