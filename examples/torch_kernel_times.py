#!/usr/bin/env python3
"""Time the port's CUDA band kernels at the main paths' bands on one GPU.

    python3 examples/torch_kernel_times.py                      # default cases
    python3 examples/torch_kernel_times.py --case mxu:box2d4r --tile 64x128 --tile 64x64
    python3 examples/torch_kernel_times.py --size 4096 --label parent

Each case is ``impl:stencil`` (impl ``cuda``, ``cuda_db`` or ``mxu``), run
on the band the SO2DR main path hands its kernel most (the first
middle-chunk call of ``compile_plan("so2dr", stencil, size, size, ...)``,
``k_on = 4``), fp32, from a seeded ``torch.randn``.  Every case first
holds the kernel to its plain version on that band (``cuda``/``cuda_db``
bitwise, ``mxu`` within 2e-5 absolute), then reports CUDA-event times
(mean of ``--reps`` launches after one warm-up) and, where the checkout
has them, the launch shape (``cuda``: ``band_launch_shape``, ``cuda_db``:
``db_launch_shape``).  One JSON line per case;
the last line names the card and its power limit.  It needs only the
port's public kernel wrappers, so the same script times an older checkout
of the port (run it from that checkout's root).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core.oocore import compile_plan  # noqa: E402
from repro_torch.core.plan import FusedKernel  # noqa: E402
from repro_torch.core.stencil import get_stencil  # noqa: E402

# the main paths' SO2DR configurations: (d, k_off, n) per stencil
CONFIGS = {"box2d4r": (4, 40, 80)}
DEFAULT = (4, 160, 160)
DEFAULT_CASES = ("cuda_db:gradient2d", "cuda_db:box2d4r", "mxu:box2d4r",
                 "cuda:box2d1r", "cuda:box2d4r")


def launch_shape(impl: str):
    """The kernel's launch-shape mirror, or None in a checkout without it."""
    from repro_torch.kernels import stencil_multistep, stencil_multistep_db
    return {"cuda": getattr(stencil_multistep, "band_launch_shape", None),
            "cuda_db": getattr(stencil_multistep_db, "db_launch_shape",
                               None)}.get(impl)


def kernels():
    from repro_torch.kernels.stencil_banded_mxu import (
        banded_fused_stencil, banded_fused_stencil_plain)
    from repro_torch.kernels.stencil_multistep import (
        fused_stencil_band, fused_stencil_band_plain)
    from repro_torch.kernels.stencil_multistep_db import (
        fused_stencil_band_db, fused_stencil_band_db_plain)
    return {"cuda": (fused_stencil_band, fused_stencil_band_plain),
            "cuda_db": (fused_stencil_band_db, fused_stencil_band_db_plain),
            "mxu": (banded_fused_stencil, banded_fused_stencil_plain)}


def main_band(name: str, size: int):
    d, k_off, n = CONFIGS.get(name, DEFAULT)
    plan = compile_plan("so2dr", get_stencil(name), size, size, n, d,
                        k_off, 4)
    for op in plan.ops:
        if isinstance(op, FusedKernel) and not op.keep_lo[0] \
                and not op.keep_hi[0]:
            return op.shape_in, op.steps
    raise AssertionError("plan has no middle-chunk kernel")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=38400)
    ap.add_argument("--case", action="append", default=None,
                    help="impl:stencil (repeatable)")
    ap.add_argument("--tile", action="append", default=None,
                    help="ROWSxCOLS output tile (repeatable; default: the "
                         "kernel's own)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    table = kernels()
    tiles = [tuple(int(v) for v in t.split("x")) for t in args.tile or []]
    for case in args.case or DEFAULT_CASES:
        impl, name = case.split(":")
        fn, plain = table[impl]
        (H, X), m = main_band(name, args.size)
        band = torch.randn((H, X), generator=torch.Generator(
            device=dev).manual_seed(3), device=dev)
        ref = plain(band, name, m)
        for tile in tiles or [None]:
            kw = {} if tile is None else {"tile": tile}
            got = fn(band, name, m, **kw)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = err <= 2e-5 if impl == "mxu" else torch.equal(got, ref)
            del got
            rec = dict(label=args.label, impl=impl, stencil=name,
                       band=[H, X], steps=m, tile=tile, max_abs_err=err,
                       ok=bool(ok))
            if ok:
                rec["ms"] = cuda_ms(lambda: fn(band, name, m, **kw),
                                    args.reps)
                shape = launch_shape(impl)
                if shape is not None:
                    rec["launch_shape"] = shape(band, name, m, **kw)
            print(json.dumps(rec), flush=True)
            if not ok:
                return 1
        del band, ref
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
