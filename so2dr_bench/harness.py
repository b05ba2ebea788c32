"""One run of one cell: set-up, the measured window of whole solves, the
traced reading, the correctness check and the result line.

The program under test is ``repro_torch``: ``compile_plan`` builds the
cell's plan in set-up, ``DoubleBufferedExecutor().execute(plan, x)``
(default dispatch policy) solves it, and every solve of the window
executes that one plan on the same host input, which the program never
writes.  The set-up ends with one warm-up solve, which builds and loads
the kernels (only the first run in a checkout compiles them) and lowers
the plan.  The window then runs whole solves back to back, starting
another only while one more is expected to end inside ``seconds``
(judged from the solves so far, the warm-up's for the first), and always
at least one.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def log(msg: str) -> None:
    print(f"[so2dr_bench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A ``BENCHMARK.json`` workload with its configuration, traffic,
    limits and metric entries, each read from its own file by name."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    spec = spec or load_json(ROOT, "BENCHMARK.json")
    matches = [w for w in spec["workloads"] if w["name"] == name]
    if not matches:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = matches[0]
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=wl["chips"],
        config=load_json(ROOT, conf["file"]),
        traffic=load_json(BENCH, "traffic", wl["traffic"] + ".json"),
        limits=load_json(BENCH, "limits", name + ".json"),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)])


@dataclass
class Context:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: Cell
    config: dict
    setup_s: float = 0.0
    plan_stats: object = None        # the plan's TransferStats
    work: object = None                  # counts.OpWork of one solve
    interior: int = 0
    solve_walls: List[float] = field(default_factory=list)
    op_wall_sums: List[float] = field(default_factory=list)
    window_s: float = 0.0
    window_peak_bytes: int = 0
    trace: object = None                 # trace.Trace of a traced run


def make_domain(size: int, seed: int, device) -> np.ndarray:
    """The cell's input: standard normal fp32 drawn on ``device`` from
    ``seed``, handed to the program (and the reference) as one host
    array."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((size, size), generator=gen, device=device,
                    dtype=torch.float32)
    host = x.cpu().numpy()
    del x
    return host


def make_executor(device):
    """The executor the window drives: the program's double-buffered
    executor under its default dispatch policy."""
    from repro_torch.core.executor import DoubleBufferedExecutor

    return DoubleBufferedExecutor(device=device)


class Kept:
    """The solves whose answers are checked: the first, the last, and one
    between them drawn from the seed (a reservoir of one), so at most
    three answers stay in host memory however many solves run."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.first = self.last = self.middle = None
        self.n_middle = 0

    def add(self, out: np.ndarray) -> None:
        if self.first is None:
            self.first = out
            return
        if self.last is not None:
            self.n_middle += 1
            if self.rng.integers(self.n_middle) == 0:
                self.middle = self.last
        self.last = out

    def answers(self) -> List[np.ndarray]:
        return [a for a in (self.first, self.middle, self.last)
                if a is not None]


def window(ex, plan, x: np.ndarray, seconds: float, first_estimate: float,
           kept: Kept, ctx: Context, prof=None) -> None:
    """The measured window of whole solves (see the module docstring)."""
    import torch

    span = prof.span if prof is not None else None
    n_rounds = sum(type(op).__name__ == "HostCommit" for op in plan.ops)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    w_ctx = span("window") if span else None
    if w_ctx:
        w_ctx.__enter__()
    t0 = time.perf_counter()
    estimate = first_estimate
    while not ctx.solve_walls or \
            (time.perf_counter() - t0) + estimate <= seconds:
        on_commit = None
        if span:
            rounds = [span("round.0")]
            s_ctx = span("solve")
            s_ctx.__enter__()
            rounds[0].__enter__()

            def on_commit(rnd, host, rounds=rounds):
                rounds[-1].__exit__(None, None, None)
                if rnd + 1 < n_rounds:
                    rounds.append(span(f"round.{rnd + 1}"))
                    rounds[-1].__enter__()
        t = time.perf_counter()
        out, _ = ex.execute(plan, x, on_commit=on_commit)
        wall = time.perf_counter() - t
        if span:
            s_ctx.__exit__(None, None, None)
        ctx.solve_walls.append(wall)
        ctx.op_wall_sums.append(sum(ex.exec_stats.op_wall_s.values()))
        kept.add(out)
        del out
        estimate = sum(ctx.solve_walls) / len(ctx.solve_walls)
    ctx.window_s = time.perf_counter() - t0
    if w_ctx:
        w_ctx.__exit__(None, None, None)
    if torch.cuda.is_available():
        ctx.window_peak_bytes = torch.cuda.max_memory_allocated()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def read_metric(name: str, ctx: Context):
    mod = importlib.import_module(f"so2dr_bench.metrics.{name}")
    return mod.read(ctx)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             require_chip: bool = True, cell: Optional[Cell] = None) -> dict:
    """Run one cell once; returns the result line's object.  With
    ``require_chip`` (every real run) a host without the cell's cards
    raises :class:`SystemExit` before any work."""
    import torch

    cell = cell or load_cell(name)
    if require_chip:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{name} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} visible")
    from repro_torch.core.oocore import compile_plan
    from repro_torch.core.stencil import get_stencil

    from so2dr_bench import check, counts
    from so2dr_bench.trace import Profiler, breakdown

    log(f"{name}: imports done {time.perf_counter() - t_start:.3f} s after "
        f"the start")
    config, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    r = config["radius"]
    size = traffic["interior"] + 2 * r
    ctx = Context(cell=cell, config=config, interior=traffic["interior"])

    # -- set-up: input, plan, warm-up solve --------------------------------
    t_in = time.perf_counter()
    x = make_domain(size, seed, device)
    t_in = time.perf_counter() - t_in
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    plan = compile_plan(traffic["engine"], get_stencil(config["stencil"]),
                        size, size, config["n_steps"], traffic["d"],
                        config["k_off"], config["k_on"])
    ctx.plan_stats = plan.stats()
    ctx.work = counts.plan_work(counts.fused_ops(plan), config)
    b = counts.bound(ctx.work, config)
    log(f"{name}: kernel bound {b.seconds:.6g} s a solve, set by {b.by} "
        f"(bytes {b.bytes_s:.6g} s, operations {b.flops_s:.6g} s)")
    ex = make_executor(device)
    t = time.perf_counter()
    warm, _ = ex.execute(plan, x)
    warm_s = time.perf_counter() - t
    del warm
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx.setup_s = time.perf_counter() - t_start
    log(f"{name}: set-up {ctx.setup_s:.3f} s (input {t_in:.3f} s, warm-up "
        f"solve {warm_s:.3f} s, kernel impl {ex.exec_stats.kernel_impl})")

    # -- the measured window ------------------------------------------------
    kept = Kept(seed)
    if trace:
        with Profiler() as prof:
            window(ex, plan, x, seconds, warm_s, kept, ctx, prof)
        ctx.trace = prof.trace
    else:
        window(ex, plan, x, seconds, warm_s, kept, ctx)
    solves = len(ctx.solve_walls)
    log(f"{name}: {solves} solves in {ctx.window_s:.3f} s: "
        + " ".join(f"{w:.3f}" for w in ctx.solve_walls))
    memory_peak = max(setup_peak, ctx.window_peak_bytes)

    specs = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in specs:
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the program's state goes, then the reference runs ----------------
    del ex
    if on_card:
        torch.cuda.empty_cache()
    blocks = check.sample_blocks(traffic, size, seed)
    t = time.perf_counter()
    ref = check.reference_rows(x, config, blocks, device=device)
    errs = [check.errors(a, blocks, ref) for a in kept.answers()]
    compared = {key: {"value": max(e[key] for e in errs), "limit": limit}
                for key, limit in cell.limits.items()}
    failed = sum(any(e[key] > limit for key, limit in cell.limits.items())
                 for e in errs)
    log(f"{name}: reference over {sum(b - a for a, b in blocks)} of {size} "
        f"rows in {time.perf_counter() - t:.3f} s; errors "
        + " ".join(json.dumps(e) for e in errs))

    result = {
        "correct": failed == 0,
        "attempted": len(errs),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device,
            "kind": torch.cuda.get_device_name(0) if on_card else device,
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = breakdown(ctx.trace)
    result["solves"] = solves
    result["check"] = compared
    return result
