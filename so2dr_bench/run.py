"""Run one cell of ``BENCHMARK.json`` once on one H100 and print its result.

    python3 so2dr_bench/run.py --workload gradient2d.oocore --seed 7 \\
        --seconds 45 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from a profiled window (with the device's busy and window
seconds and the breakdown).  The last line on standard output is one
JSON object; the compared numbers and their limits close standard error
and the object.  A host without the cell's cards, a program that cannot
be imported, or a run that has loaded JAX or the JAX package exits with
a code other than 0 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from so2dr_bench.harness import forbidden_modules, log, run_cell

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures repro_torch alone")
        return 4
    for key, c in result["check"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
