"""The two readings each correctness limit is set from, at a cell's own
size, many seeds in one process (the plan is built and the kernels warmed
once):

* the program's: one solve of the timed plan through the timed entry
  (``--impl`` picks another of the program's kernels), its errors to
  the float32 reference over the seed's row sample, as a run of
  ``run.py`` reads them;
* the control's: the reference in the precision one step below the
  configuration's (its module's ``CONTROL``), put in the program's place
  over the same rows.

    python3 so2dr_bench/readings.py --workload box2d4r.incore \\
        --seeds 11,12,13 --control-seeds 11,12,13 [--out FILE]

One JSON line per seed and side on standard output (and appended to
``--out``).  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--impl", default="auto",
                    help="the program's kernel impl (DispatchPolicy.impl)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.oocore import compile_plan
    from repro_torch.core.stencil import get_stencil
    from so2dr_bench import check
    from repro_torch.core.executor import DoubleBufferedExecutor
    from repro_torch.kernels.dispatch import DispatchPolicy
    from so2dr_bench.harness import load_cell, log, make_domain

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the readings are taken on the card")
    cell = load_cell(args.workload)
    config, traffic = cell.config, cell.traffic
    size = traffic["interior"] + 2 * config["radius"]
    plan = compile_plan(traffic["engine"], get_stencil(config["stencil"]),
                        size, size, config["n_steps"], traffic["d"],
                        config["k_off"], config["k_on"])
    ex = DoubleBufferedExecutor(policy=DispatchPolicy(impl=args.impl),
                                device="cuda")
    control = check.reference_module(config).CONTROL

    def emit(rec: dict) -> None:
        rec.update(workload=cell.name, card=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        x = make_domain(size, seed, "cuda")
        blocks = check.sample_blocks(traffic, size, seed)
        t = time.perf_counter()
        ref = check.reference_rows(x, config, blocks, device="cuda")
        ref_s = time.perf_counter() - t
        if seed in args.seeds:
            t = time.perf_counter()
            out, _ = ex.execute(plan, x)
            solve_s = time.perf_counter() - t
            emit({"side": "program", "impl": ex.exec_stats.kernel_impl,
                  "seed": seed,
                  **check.errors(out, blocks, ref),
                  "solve_s": solve_s, "reference_s": ref_s,
                  "rows": sum(b - a for a, b in blocks)})
            del out
        if seed in args.control_seeds:
            t = time.perf_counter()
            low = check.reference_rows(x, config, blocks, control, "cuda")
            emit({"side": "control", "precision": control, "seed": seed,
                  **check.errors(torch.cat(low).numpy(), check.packed(blocks),
                                 ref),
                  "control_s": time.perf_counter() - t})
        log(f"{cell.name} seed {seed} done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
