#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, one card
    python3 chip_smoke.py --size N   # the same phases on an N x N domain

Phases, none of them caught — any failure exits non-zero:

1. build and device: build both CUDA kernels from ``src/repro_torch/
   kernels/csrc`` with nvcc for sm_90a; print the card and its power limit.
2. kernels vs plain: both kernels against their plain PyTorch versions on
   the card, over stencils x steps x keep flags x band shapes, fp32
   (<= 1e-5 relative) and bf16 (<= 3e-2 relative); then CUDA-event times of
   each kernel, its plain version, the library yardstick, the bucketing
   pad and the host<->device copies at the main path's band shape.
3. main path: SO2DR gradient2d on a 38400 x 38400 fp32 domain (the
   paper's out-of-core size), d=4, k_off=160, k_on=4, n=320, default
   dispatch (auto -> cuda_db), through the double-buffered and the eager
   executor: launch count == kernel calls, the two outputs bitwise equal,
   both within 1e-5 relative of the plain oracle run on the card.
4. the fused kernel on the path: SO2DR box2d1r, same size, n=160, with
   DispatchPolicy(impl="cuda"), checked the same way.

The line before the last is the card's name and power limit; before it,
a ``{"kernels": [...]}`` JSON line.  The last line is
``{"ok": true, "device": {...}}``.  The full record goes to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.executor import (  # noqa: E402
    DoubleBufferedExecutor, EagerExecutor)
from repro_torch.core.lower import host_register, host_unregister  # noqa: E402
from repro_torch.core.oocore import compile_plan  # noqa: E402
from repro_torch.core.plan import FusedKernel, fused_box_geometry  # noqa: E402
from repro_torch.core.reference import run_reference  # noqa: E402
from repro_torch.core.stencil import get_stencil  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dispatch import DispatchPolicy  # noqa: E402
from repro_torch.kernels.stencil_multistep import (  # noqa: E402
    fused_stencil_band, fused_stencil_band_plain)
from repro_torch.kernels.stencil_multistep_db import (  # noqa: E402
    fused_stencil_band_db, fused_stencil_band_db_plain)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_TOL, BF16_TOL = 1e-5, 3e-2
ORACLE_BLOCK_ROWS = 2048
KERNELS = {
    "cuda": dict(
        fn=fused_stencil_band, plain=fused_stencil_band_plain,
        name="fused_stencil_band",
        source="src/repro_torch/kernels/csrc/fused_stencil_band.cu",
        replaces="src/repro/kernels/stencil_multistep.py:96"),
    "cuda_db": dict(
        fn=fused_stencil_band_db, plain=fused_stencil_band_db_plain,
        name="fused_stencil_band_db",
        source="src/repro_torch/kernels/csrc/fused_stencil_band_db.cu",
        replaces="src/repro/kernels/stencil_multistep_db.py:90"),
}
RESULT = {"phases": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Record a phase's wall time (a phase that raises ends the run)."""
    class _Timer:
        def __enter__(self):
            log(f"== phase {name}")
            self.t0 = time.perf_counter()

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                s = time.perf_counter() - self.t0
                RESULT["phases"][name] = s
                log(f"== phase {name}: {s:.1f} s")
    return _Timer()


def check(ok: bool, *what) -> None:
    """Fail the run (unlike ``assert``, also under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-6))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
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


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def counts() -> dict:
    return {impl: k["fn"].launches for impl, k in KERNELS.items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    with phase("build"):
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        RESULT["build_s"] = time.perf_counter() - t0
        log(f"built {os.path.relpath(lib, ROOT)} in {RESULT['build_s']:.1f} s")
        ptxas = [ln.strip() for ln in _build.build_log().splitlines()
                 if "registers" in ln or "spill" in ln]
        RESULT["ptxas"] = ptxas
        for ln in ptxas:
            log("  " + ln)
        RESULT["card"] = card_line()
        RESULT["torch"] = torch.__version__
        RESULT["cuda"] = torch.version.cuda
        log(f"card: {RESULT['card']}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


def phase_kernels_vs_plain() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    dtypes = {"fp32": (torch.float32, FP32_TOL),
              "bf16": (torch.bfloat16, BF16_TOL)}
    worst = {impl: dict.fromkeys(dtypes, 0.0) for impl in KERNELS}
    cases = bitwise = 0
    with phase("kernels_vs_plain"):
        for name, steps, (H, X), kt, kb in itertools.product(
                ("box2d1r", "box2d4r", "star2d3r", "gradient2d"), (1, 2, 4),
                ((48, 160), (37, 131), (41, 97), (20, 40)), (False, True),
                (False, True)):
            mr = steps * get_stencil(name).radius
            if H - 2 * mr + (kt + kb) * mr <= 0 or X <= 2 * mr:
                continue
            x = torch.from_numpy(rng.standard_normal((H, X)).astype(
                np.float32)).to(dev)
            for key, (dtype, tol) in dtypes.items():
                xb = x.to(dtype)
                for impl, k in KERNELS.items():
                    ref = k["plain"](xb, name, steps, kt, kb)
                    got = k["fn"](xb, name, steps, kt, kb)
                    torch.cuda.synchronize()
                    err = rel_err(got, ref)
                    check(got.shape == ref.shape, impl, name, got.shape)
                    check(err <= tol, impl, name, steps, H, X, kt, kb, key,
                          err)
                    worst[impl][key] = max(worst[impl][key], err)
                    cases += 1
                    if key == "fp32":
                        bitwise += int(torch.equal(got, ref))
        RESULT["kernels_vs_plain"] = dict(cases=cases, fp32_bitwise=bitwise,
                                          worst_rel_err=worst)
        log(f"{cases} kernel-vs-plain cases pass; fp32 bitwise equal in "
            f"{bitwise} of {cases // 2}; worst rel err {worst}")


def main_band_shape(plan) -> tuple:
    """The (H, X) of the first fused call on a middle chunk: the band
    shape the main path hands its kernel most."""
    for op in plan.ops:
        if isinstance(op, FusedKernel) and not op.keep_lo[0] \
                and not op.keep_hi[0]:
            return op.shape_in, op.steps
    raise AssertionError("plan has no middle-chunk kernel")


def bound(name: str, shape, steps: int, itemsize: int = 4):
    st = get_stencil(name)
    shape_out, _, flops, _ = fused_box_geometry(
        st.radius, st.flops_per_elem, shape, steps, (False, True),
        (False, True), itemsize)
    nbytes = (shape[0] * shape[1] + shape_out[0] * shape_out[1]) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_times(size: int) -> None:
    dev = torch.device("cuda")
    timings = {}
    with phase("kernel_times"):
        for impl, name in (("cuda_db", "gradient2d"), ("cuda", "box2d1r")):
            plan = compile_plan("so2dr", get_stencil(name), size, size, 160,
                                4, 160, 4)
            (H, X), m = main_band_shape(plan)
            band = torch.randn((H, X), generator=torch.Generator(
                device=dev).manual_seed(3), device=dev)
            k = KERNELS[impl]
            got = k["fn"](band, name, m)
            ref = k["plain"](band, name, m)
            torch.cuda.synchronize()
            rec = dict(stencil=name, band=[H, X], steps=m,
                       max_abs_err=float((got - ref).abs().max()),
                       bitwise=bool(torch.equal(got, ref)))
            del got, ref
            rec["ms"] = cuda_ms(lambda: k["fn"](band, name, m), reps=10)
            rec["plain_ms"] = cuda_ms(lambda: k["plain"](band, name, m),
                                      reps=3)
            rec.update(bound(name, (H, X), m))
            rec["library_ms"] = None
            if name == "box2d1r":
                # yardstick only, never called by the port: one step of
                # box2d1r as a convolution, in full fp32 (TF32 off)
                w = torch.from_numpy(get_stencil(name).coeffs.astype(
                    np.float32)).to(dev)[None, None]
                allow = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                try:
                    rec["library_ms"] = cuda_ms(
                        lambda: torch.nn.functional.conv2d(band[None, None],
                                                           w), reps=3)
                    rec["library_call"] = "F.conv2d, one step, TF32 off"
                finally:
                    torch.backends.cudnn.allow_tf32 = allow
            # the lowering's bucketing pad: a fresh zero block concatenated
            # to the band before a shorter call of the same group
            z = torch.zeros((2 * m, X), device=dev)
            rec["bucket_pad_ms"] = cuda_ms(lambda: torch.cat([band, z]),
                                           reps=3)
            timings[impl] = rec
            log(f"{impl} on {name} {H}x{X} m={m}: kernel {rec['ms']:.3f} ms, "
                f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} "
                f"ms ({rec['bound_by']}), library {rec['library_ms']}, "
                f"pad {rec['bucket_pad_ms']:.3f} ms, max|err| "
                f"{rec['max_abs_err']}")
            del band
        # host<->device copy rates at the band's size
        H, X = timings["cuda_db"]["band"]
        # touched pages (np.ones): the executors copy from and into host
        # arrays that are already resident, not freshly mapped
        host = np.ones((H, X), np.float32)
        nbytes = host.nbytes
        src = torch.from_numpy(host)
        copies = {}
        t = time.perf_counter()
        dst = src.to(dev)
        torch.cuda.synchronize()
        copies["h2d_pageable_GBps"] = nbytes / (time.perf_counter() - t) / 1e9
        host_register(host)
        try:
            t = time.perf_counter()
            dst = src.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            copies["h2d_registered_GBps"] = nbytes / (time.perf_counter()
                                                      - t) / 1e9
            t = time.perf_counter()
            src.copy_(dst)
            copies["d2h_registered_GBps"] = nbytes / (time.perf_counter()
                                                      - t) / 1e9
        finally:
            host_unregister(host)
        other = np.ones_like(host)
        t = time.perf_counter()
        torch.from_numpy(other).copy_(dst)
        copies["d2h_pageable_GBps"] = nbytes / (time.perf_counter() - t) / 1e9
        # the executors' per-run host set-up, at the full domain's size:
        # validate_domain's copy, and page-locking it for the copy stream
        dom = np.ones((size, size), np.float32)
        t = time.perf_counter()
        dom = dom.copy()
        copies["domain_copy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host_register(dom)
        copies["host_register_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host_unregister(dom)
        copies["host_unregister_s"] = time.perf_counter() - t
        del dom
        RESULT["kernel_times"] = timings
        RESULT["copies"] = copies
        log("copies (GB/s): " + json.dumps(
            {k: round(v, 2) for k, v in copies.items()}))


def oracle_check(x: np.ndarray, name: str, n: int, outs: dict) -> dict:
    """Run the plain oracle on the card and hold each output to it."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ref = run_reference(torch.from_numpy(x).to(dev), get_stencil(name), n,
                        block_rows=ORACLE_BLOCK_ROWS)
    torch.cuda.synchronize()
    rec = {"oracle_s": time.perf_counter() - t0}
    scale = float(ref.abs().max())
    for label, out in outs.items():
        diff, mismatched = 0.0, 0
        for lo in range(0, out.shape[0], ORACLE_BLOCK_ROWS):
            got = torch.from_numpy(out[lo:lo + ORACLE_BLOCK_ROWS]).to(dev)
            d = (got - ref[lo:lo + ORACLE_BLOCK_ROWS]).abs()
            diff = max(diff, float(d.max()))
            mismatched += int((d != 0).sum())
        rec[label] = dict(max_abs_err=diff, rel_err=diff / (scale + 1e-6),
                          mismatched=mismatched)
        check(diff / (scale + 1e-6) <= FP32_TOL, label, rec[label])
    del ref
    torch.cuda.empty_cache()
    return rec


def phase_main_path(key: str, name: str, size: int, n: int, impl: str,
                    policy: DispatchPolicy) -> None:
    with phase(key):
        rng = np.random.default_rng(20231108)
        t0 = time.perf_counter()
        x = rng.standard_normal((size, size), dtype=np.float32)
        plan = compile_plan("so2dr", get_stencil(name), size, size, n, 4,
                            160, 4)
        rec = {"stencil": name, "shape": [size, size], "n": n, "d": 4,
               "k_off": 160, "k_on": 4, "setup_s": time.perf_counter() - t0,
               "plan_kernel_calls": plan.stats().kernel_calls}
        outs = {}
        for cls in (DoubleBufferedExecutor, EagerExecutor):
            exe = cls(policy=policy)
            reset_counts()
            t = time.perf_counter()
            out, stats = exe.execute(plan, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launched = counts()
            es = exe.exec_stats
            check(es.kernel_impl == impl, es.kernel_impl)
            check(launched[impl] == es.kernel_calls == stats.kernel_calls > 0,
                  launched, es.kernel_calls)
            check(sum(launched.values()) == launched[impl], launched)
            check(out.shape == x.shape and bool(np.isfinite(out).all()),
                  "output shape or finiteness")
            rec[cls.name] = dict(
                wall_s=wall, launches=launched[impl],
                kernel_calls=es.kernel_calls,
                shape_buckets=es.shape_buckets,
                kernel_compiles=es.kernel_compiles,
                op_wall_s=es.op_wall_s)
            log(f"{name} {cls.name}: {wall:.2f} s, {launched[impl]} {impl} "
                f"launches, op wall {json.dumps({k: round(v, 3) for k, v in es.op_wall_s.items()})}")
            outs[cls.name] = out
            del exe
        check(np.array_equal(outs["double_buffered"], outs["eager"]),
              "eager and double-buffered outputs differ")
        rec["eager_equals_double_buffered"] = True
        rec["oracle"] = oracle_check(x, name, n, outs)
        log(f"{name}: eager == double_buffered bitwise; vs oracle "
            f"{json.dumps(rec['oracle'])}")
        RESULT[key] = rec


def kernels_line() -> dict:
    out = []
    for impl, key in (("cuda", "main_path_box2d1r"),
                      ("cuda_db", "main_path_gradient2d")):
        k, t = KERNELS[impl], RESULT["kernel_times"][impl]
        out.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": RESULT[key]["double_buffered"]["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=38400,
                    help="domain rows = columns (default: 38400)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    phase_build()
    phase_kernels_vs_plain()
    phase_kernel_times(args.size)
    phase_main_path("main_path_gradient2d", "gradient2d", args.size, 320,
                    "cuda_db", DispatchPolicy())
    phase_main_path("main_path_box2d1r", "box2d1r", args.size, 160, "cuda",
                    DispatchPolicy(impl="cuda"))
    RESULT["total_s"] = time.perf_counter() - t_all
    line = kernels_line()
    RESULT.update(line)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RESULT, f, indent=1, default=str)
    log(f"total {RESULT['total_s']:.1f} s")
    print(json.dumps(line))
    print(RESULT["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
