"""The correctness check: the plain reference over a seeded sample of
output rows, and the comparison that decides ``correct``.

A row of the solved domain depends on the rows within ``n * r`` of it in
the input, so the reference for a block of rows advances that cone
alone: full width, ``n`` steps, the band shrinking by ``r`` a step on
each side that is not the domain's frame (a frame row never changes).
The blocks are drawn from the seed: one across each seam between the
traffic's ``d`` chunks (where the off-chip region sharing hands rows
from one chunk to the next), at a seeded offset, and ``random_blocks``
more anywhere.  A traffic without ``check_rows`` checks every row.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple

import numpy as np
import torch

Block = Tuple[int, int]


def reference_module(config: dict):
    return importlib.import_module(
        f"so2dr_bench.references.{config['reference']}")


def sample_blocks(traffic: dict, size: int, seed: int) -> List[Block]:
    """Disjoint, sorted row blocks ``[lo, hi)`` of a ``size``-row domain."""
    rows = traffic.get("check_rows")
    if not rows or rows >= size:
        return [(0, size)]
    rng = np.random.default_rng(seed)
    d = traffic["d"]
    los = []
    for j in range(1, d):
        seam = j * size // d
        jitter = int(rng.integers(-(rows // 4), rows // 4 + 1))
        los.append(seam - rows // 2 + jitter)
    for _ in range(traffic.get("random_blocks", 0)):
        los.append(int(rng.integers(0, size - rows + 1)))
    blocks: List[Block] = []
    for lo in sorted(min(max(lo, 0), size - rows) for lo in los):
        if blocks and lo <= blocks[-1][1]:
            blocks[-1] = (blocks[-1][0], max(blocks[-1][1], lo + rows))
        else:
            blocks.append((lo, lo + rows))
    return blocks


def cone(block: Block, size: int, reach: int) -> Block:
    """The input rows that ``block`` depends on ``reach`` rows away."""
    return max(block[0] - reach, 0), min(block[1] + reach, size)


def advance(band: torch.Tensor, step, radius: int, steps: int,
            keep_top: bool, keep_bottom: bool) -> torch.Tensor:
    """``steps`` reference steps on a full-width band of rows; a side that
    is the domain frame keeps its ``r`` frame rows, any other side loses
    ``r`` rows a step."""
    r = radius
    for _ in range(steps):
        h = band.shape[0]
        nxt = band[(0 if keep_top else r):(h if keep_bottom else h - r)].clone()
        top = r if keep_top else 0
        nxt[top:top + h - 2 * r, r:-r] = step(band)
        band = nxt
    return band


def reference_rows(x: np.ndarray, config: dict, blocks: List[Block],
                   precision: str = "fp32", device=None) -> List[torch.Tensor]:
    """The reference's rows of each block after ``n_steps`` steps of the
    host domain ``x``, computed on ``device`` one block at a time and
    returned on the host."""
    ref = reference_module(config)
    step = ref.make_step(config, precision, device)
    dtype = ref.DTYPES[precision]
    r, n = config["radius"], config["n_steps"]
    size = x.shape[0]
    out = []
    for block in blocks:
        lo, hi = cone(block, size, n * r)
        band = torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(
            device=device, dtype=dtype)
        band = advance(band, step, r, n, lo == 0, hi == size)
        # rows the band still holds start at `lo` where the top is the
        # frame, at `block[0]` otherwise
        start = block[0] - (lo if lo == 0 else block[0])
        out.append(band[start:start + block[1] - block[0]]
                   .to(torch.float32).cpu())
        del band
    return out


def packed(blocks: List[Block]) -> List[Block]:
    """The blocks' row ranges once their rows are stacked end to end (as
    a control's rows are)."""
    out, at = [], 0
    for lo, hi in blocks:
        out.append((at, at + hi - lo))
        at += hi - lo
    return out


def errors(got: np.ndarray, blocks: List[Block],
           ref_rows: List[torch.Tensor]) -> dict:
    """``max_abs_err`` and ``mean_abs_err`` of ``|got - ref|`` over the
    blocks' elements; a NaN or an infinity on either side reads as
    infinite."""
    worst, total, count = 0.0, 0.0, 0
    for (lo, hi), ref in zip(blocks, ref_rows):
        diff = (torch.from_numpy(np.asarray(got[lo:hi])) - ref).abs()
        diff = torch.nan_to_num(diff, nan=float("inf"))
        worst = max(worst, float(diff.max()))
        total += float(diff.sum(dtype=torch.float64))
        count += diff.numel()
    return {"max_abs_err": worst, "mean_abs_err": total / max(count, 1)}
