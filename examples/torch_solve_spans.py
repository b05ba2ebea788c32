#!/usr/bin/env python3
"""Read the port's own spans and copy counters over whole solves of a
benchmark cell on one GPU.

    python3 examples/torch_solve_spans.py --workload gradient2d.oocore \\
        --seed 7 --seconds 30 [--workload box2d4r.incore ...] [--out FILE]

Each cell is set up as ``so2dr_bench/run.py`` sets it up (the input drawn
on the card from ``--seed``, the plan, one warm-up solve), then runs two
windows of whole solves through the benchmark's own window: one
untraced, then one under ``torch.profiler`` with the benchmark's spans
(``so2dr_bench.window``, ``.solve``, ``.round.<k>``) around the
program's (``repro_torch.*``, :mod:`repro_torch.core.trace`).  One JSON
line a cell on standard output (and appended to ``--out``), per solve of
the traced window unless named:

* ``domain_copy_s``, ``pin_s`` (pin + unpin), ``commit_wait_s``,
  ``commit_drain_s``: the program's spans;
* ``pad_gb``, ``share_gb``: ``ExecStats.pad_bytes`` / ``share_bytes``;
* ``host_setup_s``, ``device_idle_pct``: the benchmark's readers;
* ``dtoh_s``: the DtoH memcpys' device time; ``cat_s`` the
  ``CatArrayBatchedCopy`` kernels' and ``cat_write_gbps`` the bytes the
  two concatenations write over it;
* ``solve_s`` traced and untraced, and whether the first answers of the
  two windows are bitwise equal;
* ``idle_gaps``: the longest idle gaps, each named by the benchmark span,
  the program span and the host event that overlap it (:func:`label`).

It needs the card and reads a checkout whose program has the spans.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

PREFIX = "repro_torch."   # repro_torch.core.trace.PREFIX
Span = Tuple[float, float, str]


def program_spans(events: list) -> List[Span]:
    """The program's ranges of Chrome trace events, in seconds, with the
    prefix stripped."""
    out = []
    for ev in events:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and "dur" in ev \
                and str(ev.get("cat", "")).lower() == "user_annotation" \
                and name.startswith(PREFIX):
            s = float(ev["ts"]) / 1e6
            out.append((s, s + float(ev["dur"]) / 1e6, name[len(PREFIX):]))
    return out


def label(gap: Tuple[float, float], trace, program: List[Span]) -> str:
    """The benchmark's gap label (``so2dr_bench.trace._label``) with the
    program span that overlaps the gap the longest between its benchmark
    span and its host event; unchanged where no program span does."""
    from so2dr_bench.trace import _label

    base = _label(gap, trace)
    best, best_overlap = None, 0.0
    for s, e, name in program:
        overlap = min(e, gap[1]) - max(s, gap[0])
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    if best is None:
        return base
    bench, sep, host = base.partition(": ")
    return f"{bench}: {best}: {host}" if sep else f"{bench}: {best}"


def span_s(trace, program: List[Span], *names: str) -> float:
    """Seconds of the program's spans named ``names`` inside the window."""
    return sum(min(e, trace.end) - max(s, trace.start)
               for s, e, name in program
               if name in names and e > trace.start and s < trace.end)


def readings(trace, program: List[Span], solves: int,
             pad_bytes: int, share_bytes: int, top: int = 10) -> Dict:
    """A traced window's per-solve readings (see the module docstring)."""
    from so2dr_bench.trace import gaps

    dtoh = sum(e - s for s, e, name, _ in trace.copies if "DtoH" in name)
    cat = sum(e - s for s, e, name in trace.kernels
              if "CatArrayBatchedCopy" in name)
    longest = sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {
        "domain_copy_s": span_s(trace, program, "domain_copy") / solves,
        "pin_s": span_s(trace, program, "pin", "unpin") / solves,
        "commit_wait_s": span_s(trace, program, "commit.wait") / solves,
        "commit_drain_s": span_s(trace, program, "commit.drain") / solves,
        "stage_spans": sum(1 for s, e, name in program
                           if name.startswith("stage.")
                           and trace.start <= s < trace.end) / solves,
        "pad_gb": pad_bytes / 1e9,
        "share_gb": share_bytes / 1e9,
        "dtoh_s": dtoh / solves,
        "cat_s": cat / solves,
        "cat_write_gbps": ((pad_bytes + share_bytes) * solves / cat / 1e9
                           if cat > 0 else None),
        "idle_gaps": [[label(g, trace, program)[:160], g[1] - g[0]]
                      for g in longest],
    }


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return doc.get("traceEvents", doc) if isinstance(doc, dict) else doc


class _First:
    """Keeps the first answer of a window (the harness's ``Kept`` shape)."""

    first = None

    def add(self, out) -> None:
        if self.first is None:
            self.first = out


def run_cell(name: str, seed: int, seconds: float, device: str = "cuda",
             cell=None) -> Dict:
    """One cell's record; ``device`` and ``cell`` (a
    ``so2dr_bench.harness.Cell``) as in ``so2dr_bench.harness.run_cell``."""
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.oocore import compile_plan
    from repro_torch.core.stencil import get_stencil
    from so2dr_bench.harness import (Context, load_cell, make_domain,
                                     make_executor, read_metric, window)
    from so2dr_bench.trace import Profiler, parse

    cell = cell or load_cell(name)
    config, traffic = cell.config, cell.traffic
    size = traffic["interior"] + 2 * config["radius"]
    x = make_domain(size, seed, device)
    plan = compile_plan(traffic["engine"], get_stencil(config["stencil"]),
                        size, size, config["n_steps"], traffic["d"],
                        config["k_off"], config["k_on"])
    ex = make_executor(device)
    t = time.perf_counter()
    ex.execute(plan, x)
    warm_s = time.perf_counter() - t

    plain, plain_first = Context(cell=cell, config=config), _First()
    window(ex, plan, x, seconds, warm_s, plain_first, plain)
    ctx, first = Context(cell=cell, config=config), _First()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window(ex, plan, x, seconds, warm_s, first, ctx, Profiler())
    events = _events(prof)
    ctx.trace = parse(events)
    solves = len(ctx.solve_walls)
    es = ex.exec_stats
    rec = {"workload": name, "seed": seed,
           **readings(ctx.trace, program_spans(events), solves,
                      es.pad_bytes, es.share_bytes)}
    rec.update(
        host_setup_s=read_metric("host_setup_s", ctx),
        device_idle_pct=read_metric("device_idle_pct", ctx),
        busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s,
        solves=solves, solve_s=ctx.solve_walls,
        untraced_solve_s=plain.solve_walls,
        traced_equals_untraced=bool(np.array_equal(first.first,
                                                   plain_first.first)),
        warm_s=warm_s)
    del x, ex, first, plain_first
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the spans are read on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for name in args.workload:
        rec = run_cell(name, args.seed, args.seconds)
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
