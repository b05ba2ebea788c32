"""Build, load and call the CUDA kernels in ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` (Hopper) into one shared
library with a plain C interface, loaded with :mod:`ctypes` — no PyTorch
headers, so a build takes seconds, not minutes.  Each ``.cu`` compiles in
its own ``nvcc`` process, all started together, then one link makes the
library.  The library lands in ``_build/<hash of the sources and
flags>/`` next to this module (listed in ``.gitignore``); a later process
with the same sources loads it without building.

Nothing here runs at import time: the first kernel launch builds and loads
the library (:func:`library`).  Each C entry point returns the
``cudaGetLastError()`` code of its launch, and :func:`call_band_kernel`
raises if it is not 0 — a refused launch never runs, and a later
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stencil import get_stencil

__all__ = ["build", "library", "build_log", "call_band_kernel", "SMEM_LIMIT",
           "fit_tile"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory one block may opt into on Hopper (227 KB)
SMEM_LIMIT = 232448

# kernel entry points: (in, out, dtype, kind, H, X, h_out, r, m, keep_top,
# keep_bottom, ty, tx, ntaps, tap_dy, tap_dx, tap_c, stream) -> cudaError_t
ENTRY_POINTS = ("repro_fused_stencil_band", "repro_fused_stencil_band_db")
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12
             + [ctypes.c_void_p] * 4)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"box": 0, "star": 0, "gradient": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source
    hash) and return its path.  Raises with the compiler's output when a
    source does not compile."""
    out_dir = BUILD_ROOT / _source_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", *(str(o) for _, o, _ in procs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "build.log").write_text("\n".join(log))
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """The compiler's output of the current build (``-Xptxas -v``:
    registers, shared memory and spills per kernel), or "" if the
    library was built by another process without one."""
    p = BUILD_ROOT / _source_key() / "build.log"
    return p.read_text() if p.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _taps(name: str) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """``(kind, dy, dx, c)`` for the kernel: the linear taps in the plain
    version's order as offsets from the centre, empty for gradient2d."""
    st = get_stencil(name)
    if st.ndim != 2 or st.kind not in _KINDS:
        raise ValueError(f"the fused band kernels take 2-D stencils, "
                         f"not {name!r}")
    taps = st.taps() if st.is_linear else []
    r = st.radius
    dy = np.array([t[0] - r for t in taps] or [0], np.int32)
    dx = np.array([t[1] - r for t in taps] or [0], np.int32)
    c = np.array([t[2] for t in taps] or [0.0], np.float32)
    return _KINDS[st.kind], dy, dx, c


def fit_tile(tile: Tuple[int, int], h_out: int, X: int, steps: int,
             radius: int, itemsize: int, buffers: int) -> Tuple[int, int]:
    """The output tile a kernel launches with: ``tile`` cut to the band,
    then halved (rows first) until ``buffers`` apron'd tiles fit the
    shared memory of one block."""
    ty, tx = min(tile[0], h_out), min(tile[1], X)
    apron = 2 * steps * radius
    while buffers * (ty + apron) * (tx + apron) * itemsize > SMEM_LIMIT:
        if ty > 1:
            ty = (ty + 1) // 2
        elif tx > 1:
            tx = (tx + 1) // 2
        else:
            raise ValueError(f"{steps} fused steps of radius {radius} do not "
                             f"fit shared memory")
    return ty, tx


def call_band_kernel(entry: str, band: torch.Tensor, name: str, steps: int,
                     keep_top: bool, keep_bottom: bool,
                     tile: Tuple[int, int], buffers: int) -> torch.Tensor:
    """Check a CUDA band, allocate the output and launch ``entry`` on the
    current stream.  Raises on what the kernels do not take and when the
    launch fails."""
    if band.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a {band.device.type} tensor")
    if band.dim() != 2:
        raise ValueError(f"band must be 2-D (H, X), got {tuple(band.shape)}")
    if band.dtype not in _DTYPES:
        raise TypeError(f"band dtype {band.dtype} not supported "
                        f"(float32, bfloat16)")
    if not band.is_contiguous():
        raise ValueError("band must be contiguous")
    kind, dy, dx, c = _taps(name)
    r, m = get_stencil(name).radius, steps
    H, X = band.shape
    h_out = H - 2 * m * r + (int(keep_top) + int(keep_bottom)) * m * r
    if m <= 0 or h_out <= 0:
        raise ValueError(f"band of {H} rows too small for {m} fused steps")
    ty, tx = fit_tile(tile, h_out, X, m, r, band.element_size(), buffers)
    out = torch.empty((h_out, X), dtype=band.dtype, device=band.device)
    fn = getattr(library(), entry)
    ntaps = len(dy) if kind == 0 else 0
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream(band.device).cuda_stream
        err = fn(band.data_ptr(), out.data_ptr(), _DTYPES[band.dtype], kind,
                 H, X, h_out, r, m, int(keep_top), int(keep_bottom), ty, tx,
                 ntaps, dy.ctypes.data, dx.ctypes.data, c.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"(band {H}x{X}, {name}, steps={m}, tile={ty}x{tx})")
    return out
