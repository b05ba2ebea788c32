"""The kernel bound: the least time an H100 could take for the fused
stencil work of a plan, counted here from each fused-kernel op's band
geometry and the configuration's published FLOPs per element, never from
the program's own counts, its kernel choice or its bucket padding.

Per op of ``m`` fused steps on a band of ``h_in`` rows and ``X`` columns:

* bytes: the input band read once and the output band written once,
  ``(h_in + h_out) * X * itemsize``;
* operations: ``flops_per_elem`` times the elements each step updates.
  A step drops ``r`` rows on each side that is not the domain frame and
  updates every row it keeps but the frame's, across ``X - 2r`` columns.

The bound is the larger of bytes over the HBM rate and operations over
the configuration's peak (``peaks.json``): dense TF32 tensor cores for a
linear stencil, whose products any kernel may run there, and the fp32
CUDA cores for a nonlinear one.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, NamedTuple

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


class OpWork(NamedTuple):
    bytes: int
    flops: int


class Bound(NamedTuple):
    seconds: float
    bytes_s: float
    flops_s: float

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_s >= self.flops_s else "operations"


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def band_work(h_in: int, width: int, steps: int, keep_top: bool,
              keep_bottom: bool, radius: int, flops_per_elem: int,
              itemsize: int = 4) -> OpWork:
    """Bytes and operations of ``steps`` fused steps on one full-width
    band; ``keep_*`` say which sides are the domain frame."""
    r, kept = radius, int(keep_top) + int(keep_bottom)
    h, updated = h_in, 0
    for _ in range(steps):
        h = h - 2 * r + kept * r
        updated += (h - kept * r) * (width - 2 * r)
    return OpWork(bytes=(h_in + h) * width * itemsize,
                  flops=flops_per_elem * updated)


def plan_work(ops: Iterable, config: dict, itemsize: int = 4) -> OpWork:
    """Summed :func:`band_work` over a plan's fused-kernel ops (objects
    with ``steps``, ``shape_in``, ``shape_out``, ``keep_lo``,
    ``keep_hi``); an op whose output height disagrees with this count
    raises."""
    total_b = total_f = 0
    for op in ops:
        h_in, width = op.shape_in
        w = band_work(h_in, width, op.steps, op.keep_lo[0], op.keep_hi[0],
                      config["radius"], config["flops_per_elem"], itemsize)
        h_out = w.bytes // (width * itemsize) - h_in
        if (h_out, width) != tuple(op.shape_out):
            raise ValueError(f"fused op {op.shape_in} -> {op.shape_out} "
                             f"does not shrink as counted ({h_out} rows)")
        total_b += w.bytes
        total_f += w.flops
    return OpWork(total_b, total_f)


def bound(work: OpWork, config: dict) -> Bound:
    p = peaks()
    bytes_s = work.bytes / p["hbm_bytes_per_s"]
    flops_s = work.flops / p["flops_per_s"][config["peak"]]
    return Bound(max(bytes_s, flops_s), bytes_s, flops_s)


def fused_ops(plan) -> list:
    """The plan's fused-kernel ops (full-width 2-D bands), by op name."""
    return [op for op in plan.ops if type(op).__name__ == "FusedKernel"]
