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
commit and this one can be traced in one call.  ``--table`` prints the
summaries of dry-run directories side by side as a markdown table, with
no tracing: the first the reference's (the JAX package's ``python -m
repro.launch.dryrun --all --both-meshes``; a directory of records
without a summary gets one made from its records), each other held to
it cell by cell (:func:`verdict`: FLOPs and wire within 1.25x, temp
within the reference's plus a serving cell's new cache) and the last
two to each other (:func:`agree`: 2 %, 2 %, 5 %).

``--device`` is the fake tensors' device (``cuda``, the default, or
``cpu`` on a machine with no card).

Usage (``S`` = ``python examples/torch_dryrun_sweep.py``):
    S --out artifacts/dry_after
    S --device cpu --out artifacts/dry_cpu
    S --src <parent checkout> --out artifacts/dry_before
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun \
        --all --both-meshes --out artifacts/dry_jax
    S --table artifacts/dry_jax artifacts/dry_before artifacts/dry_after

The default cells are every cell the reference's dry run
(``python -m repro.launch.dryrun --all --both-meshes``) traces: each
arch × shape × production mesh that ``cell_supported`` admits, 68 of
80 (``long_500k`` is skipped for the full-attention and enc-dec
archs).  ``--cells arch:shape:pod1,...`` picks others; a
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

ROOT_SRC = os.path.join(ROOT, "src")
# trace cost, heaviest first (a cell's order in the queue, not a gate)
_WEIGHT = {"llama-3.2-vision-90b": 6, "llama4-maverick-400b-a17b": 5,
           "phi3-medium-14b": 4, "mixtral-8x7b": 4, "minitron-4b": 3,
           "zamba2-2.7b": 3, "h2o-danube-1.8b": 2, "qwen3-0.6b": 2,
           "whisper-tiny": 1, "mamba2-130m": 1}
# per shape: a fake-tensor prefill of 32k tokens walks every attention
# chunk pair of every layer, the costliest trace of all
_SHAPE_COST = {"prefill_32k": 40, "train_4k": 10, "long_500k": 1,
               "decode_32k": 1}


def default_cells() -> list:
    """Every (arch, shape, mesh) cell that ``cell_supported`` admits."""
    if ROOT_SRC not in sys.path:
        sys.path.insert(0, ROOT_SRC)
    from repro_torch.configs import (ARCH_NAMES, SHAPES, cell_supported,
                                     get_config)

    return [(a, s, m) for a in ARCH_NAMES for s in SHAPES
            for m in ("pod1", "pod2")
            if cell_supported(get_config(a), SHAPES[s])[0]]


def _parse_cells(text: str) -> list:
    return [tuple(c.split(":")) for c in text.split(",") if c]


def _cost(cell) -> float:
    arch, shape, mesh = cell[:3]
    k = _SHAPE_COST.get(shape, 1)
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
                    alias_gb=mem["alias_size_in_bytes"] / 1e9,
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


def load_summary(out: str) -> dict:
    """``out``'s summary.json, or one made from its records (a sweep of
    the dry-run CLI's own, e.g. ``--all --both-meshes``)."""
    path = os.path.join(out, "summary.json")
    if os.path.exists(path):
        return json.load(open(path))
    tags = [f[:-5] for f in os.listdir(out)
            if f.endswith(".json") and f.count("__") == 2]
    return summarize(out, {t: {"rc": 0} for t in tags})


# the gates a port cell is held to against the reference's record of it,
# per device: FLOPs and wire within 1.25x; temp within the reference's
# plus, in a serving cell, the one new cache the port keeps by design
# (the record's alias bytes; the reference writes into its donated
# cache); and two port sweeps (torch versions) within these fractions
GATE_X = {"tflop": 1.25, "wire_gb": 1.25}
AGREE = {"temp_gb": 0.02, "tflop": 0.02, "wire_gb": 0.05}


def verdict(row, ref, tag: str) -> str:
    """``ok``, or the gates the port cell ``row`` misses against the
    reference's ``ref`` (``FAIL`` where it did not trace)."""
    if row is None or ref is None or "temp_gb" not in ref:
        return "—"
    if "error" in row or "temp_gb" not in row:
        return "FAIL"
    bad = [k for k, x in GATE_X.items() if row[k] > x * ref[k]]
    new_cache = row.get("alias_gb", 0.0) if "train" not in tag else 0.0
    if row["temp_gb"] > ref["temp_gb"] + new_cache:
        bad.append("temp")
    return "ok" if not bad else "+".join(bad)


def agree(a, b) -> str:
    """``ok``, or the metrics on which two port sweeps' rows differ by
    more than :data:`AGREE`."""
    if not a or not b or "temp_gb" not in a or "temp_gb" not in b:
        return "—"
    bad = [k for k, tol in AGREE.items()
           if abs(a[k] - b[k]) > tol * max(abs(a[k]), abs(b[k]), 1e-30)]
    return "ok" if not bad else "+".join(bad)


def table(ref: str, dirs) -> str:
    """A markdown table of every cell of ``dirs`` (port sweeps) beside
    the reference sweep ``ref``: temp, TFLOP and wire GB per device, the
    new cache, each sweep's :func:`verdict` and whether the last two
    agree (:func:`agree`)."""
    r = load_summary(ref)
    sums = [load_summary(d) for d in dirs]
    tags = sorted(set().union(*sums), key=lambda t: (t.split("__")[1],
                                                     t.split("__")[2], t))

    def num(row, key):
        if row is None:
            return "—"
        if "error" in row:
            return "FAIL"
        return f"{row[key]:.4g}" if key in row else str(row.get("rc", "—"))

    names = [os.path.basename(os.path.normpath(d)) for d in dirs]
    head = ("| cell | " + " | ".join(
        f"{k} ref / {' / '.join(names)}"
        for k in ("temp GB", "TFLOP", "wire GB"))
        + " | new cache GB | gates | agree |")
    lines = [head, "|" + "---|" * 7]
    for tag in tags:
        rows = [s.get(tag) for s in sums]
        cols = [" / ".join([num(r.get(tag), k)] + [num(x, k) for x in rows])
                for k in ("temp_gb", "tflop", "wire_gb")]
        cache = next((x["alias_gb"] for x in rows[::-1]
                      if x and "alias_gb" in x and "train" not in tag), None)
        lines.append(
            f"| {tag.replace('__', ' ')} | " + " | ".join(cols)
            + f" | {'—' if cache is None else f'{cache:.4g}'} | "
            + " ".join(verdict(x, r.get(tag), tag) for x in rows)
            + f" | {agree(*rows[-2:]) if len(rows) > 1 else '—'} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="artifacts/dryrun_sweep")
    ap.add_argument("--src", default=ROOT,
                    help="root of the checkout whose code is traced")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--deadline", type=float, default=3300.0,
                    help="seconds before running cells are cut (the 68 "
                         "cells take most of an hour on 8 cores; a "
                         "32k-token prefill trace alone up to ~1 h)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda, or cpu)")
    ap.add_argument("--cells", default=None,
                    help="arch:shape:pod1|pod2,... (default: the sweep's)")
    ap.add_argument("--table", nargs="+", default=None,
                    help="the reference's sweep, then port sweeps: their "
                         "cells side by side against the gates, the last "
                         "two compared")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table[0], args.table[1:]))
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
