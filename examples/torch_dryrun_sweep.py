"""Dry-run sweep: one cell a process, several at a time, and the records
side by side.

Runs ``python -m repro_torch.launch.dryrun`` once per cell, ``--jobs``
processes at a time, the costliest cells first, each cell's JSON record
written under ``--out`` and a ``summary.json`` beside them: per cell its
status, trace seconds, per-device TFLOP, arguments and temp GB,
collective GB per kind, wire GB (their sum, an all-reduce counted
twice: the ring factors of the dry run's roofline) and the largest
all-gather result (port records only).  Cells are compared on wire GB:
one kind of collective alone (an all-gather) says little, as XLA and
DTensor spend collectives of different kinds on the same program.
``--src`` runs the code of another checkout (its ``src/``), so a parent
commit and this one can be traced in one call.  ``--table``
prints the summaries of dry-run directories side by side as a markdown
table, with no tracing; a directory of records without a summary (the
JAX package's ``python -m repro.launch.dryrun --all --both-meshes``)
gets one made from its records.

``--device`` is the fake tensors' device (``cuda``, the default, or
``cpu`` on a machine with no card).

Usage (``S`` = ``python examples/torch_dryrun_sweep.py``):
    S --out artifacts/dry_after
    S --device cpu --out artifacts/dry_cpu
    S --src <parent checkout> --out artifacts/dry_before
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun \
        --all --both-meshes --out artifacts/dry_jax
    S --table artifacts/dry_jax artifacts/dry_before artifacts/dry_after

The default cells are the ones whose partitioning the port follows the
reference's on: ``train_4k`` on both production meshes for nine archs,
``decode_32k`` on (16, 16) for six, ``prefill_32k`` on (16, 16) for the
two Mamba-2 archs.  ``--cells arch:shape:pod1,...`` picks others; a
cell's fourth field names a flag of the dry-run CLI (e.g.
``mixtral-8x7b:train_4k:pod1:moe-block-dispatch``), its record kept
under ``--out``'s folder of that name.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN = ["qwen3-0.6b", "minitron-4b", "phi3-medium-14b",
         "llama4-maverick-400b-a17b", "h2o-danube-1.8b", "mixtral-8x7b",
         "zamba2-2.7b", "mamba2-130m", "llama-3.2-vision-90b"]
DECODE = ["qwen3-0.6b", "minitron-4b", "phi3-medium-14b",
          "llama4-maverick-400b-a17b", "llama-3.2-vision-90b",
          "mixtral-8x7b"]
PREFILL = ["mamba2-130m", "zamba2-2.7b"]
# trace cost, heaviest first (a cell's order in the queue, not a gate)
_WEIGHT = {"llama-3.2-vision-90b": 6, "llama4-maverick-400b-a17b": 5,
           "phi3-medium-14b": 4, "mixtral-8x7b": 4, "minitron-4b": 3,
           "zamba2-2.7b": 3, "h2o-danube-1.8b": 2, "qwen3-0.6b": 2,
           "mamba2-130m": 1}


def default_cells() -> list:
    cells = [(a, "train_4k", m) for a in TRAIN for m in ("pod1", "pod2")]
    cells += [(a, "decode_32k", "pod1") for a in DECODE]
    cells += [(a, "prefill_32k", "pod1") for a in PREFILL]
    return cells


def _parse_cells(text: str) -> list:
    return [tuple(c.split(":")) for c in text.split(",") if c]


def _cost(cell) -> float:
    arch, shape, mesh = cell[:3]
    k = {"train_4k": 10, "prefill_32k": 12, "decode_32k": 1}.get(shape, 1)
    return _WEIGHT.get(arch, 1) * k * (2 if mesh == "pod2" else 1)


def _tag(cell) -> str:
    return "__".join(cell)


def _record(out: str, tag: str) -> str:
    """The record of cell ``tag`` under ``out`` (a flagged cell's in the
    flag's folder, as the dry-run CLI names it)."""
    parts = tag.split("__")
    return os.path.join(out, *parts[3:], "__".join(parts[:3]) + ".json")


def _command(cell, out: str, device: str = "cuda") -> list:
    arch, shape, mesh, *flag = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", os.path.join(out, *flag),
           "--device", device]
    if mesh == "pod2":
        cmd.append("--multi-pod")
    return cmd + [f"--{f}" for f in flag]


def sweep(cells, out: str, src: str, jobs: int, deadline: float,
          device: str = "cuda") -> dict:
    """Trace ``cells``, ``jobs`` processes at a time, until ``deadline``
    seconds have passed (a cell still running then is killed and marked
    CUT, a cell not started NOT RUN).  Returns {tag: status}."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(src, "src"),
               TORCH_SHOW_CPP_STACKTRACES="1")
    queue = sorted(cells, key=_cost, reverse=True)
    running, status, logs = {}, {}, {}
    t0 = time.monotonic()
    try:
        while queue or running:
            while queue and len(running) < jobs:
                cell = queue.pop(0)
                log = open(os.path.join(out, _tag(cell) + ".log"), "w")
                running[cell] = (subprocess.Popen(
                    _command(cell, os.path.abspath(out), device), cwd=src,
                    env=env, stdout=log, stderr=subprocess.STDOUT),
                    time.monotonic())
                logs[cell] = log
            for cell, (proc, t) in list(running.items()):
                if proc.poll() is not None:
                    status[_tag(cell)] = {"rc": proc.returncode,
                                          "wall_s": time.monotonic() - t}
                    logs.pop(cell).close()
                    del running[cell]
            if time.monotonic() - t0 > deadline:
                break
            time.sleep(0.5)
    finally:
        for cell, (proc, t) in running.items():
            proc.kill()
            proc.wait()
            logs.pop(cell).close()
            status[_tag(cell)] = {"rc": "CUT", "wall_s": time.monotonic() - t}
        for cell in queue:
            status[_tag(cell)] = {"rc": "NOT RUN"}
    return status


def summarize(out: str, status: dict) -> dict:
    rows = {}
    for tag, st in sorted(status.items()):
        path = _record(out, tag)
        row = dict(st)
        if os.path.exists(path):
            rec = json.load(open(path))
            if rec.get("error"):
                row["error"] = rec["error"][:300]
            elif rec.get("skipped"):
                row["skipped"] = rec.get("reason")
            else:
                mem = rec["memory"]
                row.update(
                    trace_s=rec["compile_s"],
                    tflop=rec["cost"]["flops"] / 1e12,
                    arguments_gb=mem["argument_size_in_bytes"] / 1e9,
                    temp_gb=mem["temp_size_in_bytes"] / 1e9,
                    collectives_gb={k: v / 1e9 for k, v in
                                    rec["collectives"].items() if v},
                    wire_gb=wire_bytes(rec["collectives"]) / 1e9)
                gathers = [c for c in rec.get("largest_collectives", ())
                           if c["kind"] == "all-gather"]
                if gathers:
                    big = max(gathers, key=lambda c: c["numel"])
                    row["largest_all_gather"] = {
                        k: big[k] for k in ("shape", "dtype", "count")}
        rows[tag] = row
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


# bytes on the wire per result byte, per kind (the dry run's roofline's)
RING = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
        "all-to-all": 1.0, "collective-permute": 1.0}


def wire_bytes(colls: dict) -> float:
    """A record's collective result bytes weighted by :data:`RING`."""
    return sum(v * RING.get(k, 1.0) for k, v in colls.items())


def _fmt(row, key) -> str:
    if row is None:
        return "—"
    if "error" in row:
        return "FAIL"
    if "skipped" in row:
        return "skip"
    if key not in row:
        return str(row.get("rc", "—"))
    return f"{row[key]:.1f}"


def load_summary(out: str) -> dict:
    """``out``'s summary.json, or one made from its records (a sweep of
    the dry-run CLI's own, e.g. ``--all --both-meshes``)."""
    path = os.path.join(out, "summary.json")
    if os.path.exists(path):
        return json.load(open(path))
    tags = [f[:-5] for f in os.listdir(out)
            if f.endswith(".json") and f.count("__") == 2]
    return summarize(out, {t: {"rc": 0} for t in tags})


def table(dirs) -> str:
    sums = [load_summary(d) for d in dirs]
    tags = sorted(set().union(*sums), key=lambda t: (t.split("__")[1],
                                                     t.split("__")[2], t))
    head = "| cell | " + " | ".join(
        f"{k} {os.path.basename(os.path.normpath(d))}"
        for k in ("temp GB", "TFLOP", "wire GB", "all-gather GB")
        for d in dirs) + " |"
    lines = [head, "|" + "---|" * (1 + 4 * len(dirs))]
    for tag in tags:
        cells = [_fmt(s.get(tag), "temp_gb") for s in sums]
        cells += [_fmt(s.get(tag), "tflop") for s in sums]
        cells += [(f"{wire_bytes(s[tag]['collectives_gb']):.1f}"
                   if tag in s and "collectives_gb" in s[tag]
                   else _fmt(s.get(tag), "-")) for s in sums]
        cells += [(f"{s[tag]['collectives_gb'].get('all-gather', 0.0):.1f}"
                   if tag in s and "collectives_gb" in s[tag]
                   else _fmt(s.get(tag), "-")) for s in sums]
        lines.append(f"| {tag.replace('__', ' ')} | " + " | ".join(cells)
                     + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="artifacts/dryrun_sweep")
    ap.add_argument("--src", default=ROOT,
                    help="root of the checkout whose code is traced")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--deadline", type=float, default=1800.0,
                    help="seconds before running cells are cut")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda, or cpu)")
    ap.add_argument("--cells", default=None,
                    help="arch:shape:pod1|pod2,... (default: the sweep's)")
    ap.add_argument("--table", nargs="+", default=None,
                    help="print these sweeps' summaries side by side")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table))
        return 0
    cells = _parse_cells(args.cells) if args.cells else default_cells()
    t0 = time.monotonic()
    status = sweep(cells, args.out, os.path.abspath(args.src), args.jobs,
                   args.deadline, args.device)
    rows = summarize(args.out, status)
    for tag, row in rows.items():
        print(tag, json.dumps(row), flush=True)
    bad = [t for t, r in rows.items() if r.get("rc") != 0 or "error" in r]
    print(f"done: {len(rows) - len(bad)}/{len(rows)} cells OK in "
          f"{time.monotonic() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
