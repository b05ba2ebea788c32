"""The tensors alive at a dry-run cell's memory peak.

Traces one cell as ``python -m repro_torch.launch.dryrun`` does (fake
tensors, this process playing rank 0 of a fake group), under a
:class:`~repro_torch.launch.op_analysis.CostMode` that also notes, for
each storage the run allocates, the op that made it, its shape and its
dtype.  At every new peak it keeps the list of storages alive; at the
end it prints the cell's temp and that list at the last (highest) peak,
largest first, with the bytes grouped by (op, shape, dtype).  It is
what to read before changing a model's code to cut a cell's temp: the
record's temp is a live-storage peak, not XLA's buffer assignment.

Usage:
    PYTHONPATH=src python examples/torch_peak_live_set.py \\
        --arch zamba2-2.7b --shape prefill_32k --device cpu [--layers 6]
    ... --mesh 2x2 --smoke       # a smoke config on a small fake group
    ... --src <checkout>          # another checkout's code (a parent)

``--layers`` replaces the config's ``n_layers`` (zamba2: 6 is one group
of five Mamba-2 layers and the shared attention block).  ``--json``
writes the record and the live set there.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys


def live_set_mode(cost_mode):
    """A subclass of ``cost_mode`` (the ``CostMode`` class) that keeps
    the live set at each new peak: ``at_peak``, a list of (bytes, op,
    shape, dtype), one entry per storage (storages that share a live
    entry, a waited collective and its result, listed once)."""

    class LiveSetMode(cost_mode):
        def __init__(self, fake_mode=None):
            super().__init__(fake_mode)
            self._op = None
            self._what = {}
            self.at_peak = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._op = func
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _note(self, outs):
            op = str(self._op.overloadpacket.__name__)
            for t in outs:
                key = t.untyped_storage()._cdata
                if key not in self._live:
                    self._what[key] = (op, tuple(t.shape), str(t.dtype))

        def _share(self, src, outs):
            self._note(outs)
            super()._share(src, outs)

        def _track(self, outs):
            self._note(outs)
            before = self.peak_bytes
            super()._track(outs)
            if self.peak_bytes > before:
                self._snapshot()

        def _snapshot(self):
            seen, rows = set(), []
            for key, entry in self._live.items():
                if id(entry) in seen:
                    continue
                seen.add(id(entry))
                op, shape, dtype = self._what.get(key, ("?", (), "?"))
                # an older CostMode keeps the bytes alone, and no sharing
                nbytes = entry if isinstance(entry, int) else entry[0]
                rows.append((nbytes, op, shape, dtype))
            self.at_peak = sorted(rows, reverse=True)

    return LiveSetMode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 (default: the "
                    "production mesh)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--src", default=None,
                    help="a checkout whose src/ to trace (default: this one)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    root = args.src or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.launch import dryrun

    mode_cls = live_set_mode(dryrun.CostMode)
    modes = []

    def make(fake_mode=None):
        modes.append(mode_cls(fake_mode))
        return modes[-1]

    dryrun.CostMode = make
    mesh = (tuple(int(x) for x in args.mesh.split("x")) if args.mesh
            else None)
    overrides = {} if args.layers is None else {"n_layers": args.layers}
    rec = dryrun.lower_cell(args.arch, args.shape, args.multi_pod,
                            mesh_shape=mesh, device=args.device,
                            smoke=args.smoke, overrides=overrides)
    if rec.get("skipped"):
        print("skipped:", rec["reason"])
        return 1
    mode = modes[-1]
    temp = rec["memory"]["temp_size_in_bytes"]
    print(f"{args.arch} {args.shape} mesh {rec['mesh']}: temp "
          f"{temp / 1e9:.4f} GB, {rec['cost']['flops'] / 1e12:.4f} TFLOP, "
          f"{len(mode.at_peak)} storages alive at the peak")
    for nbytes, op, shape, dtype in mode.at_peak[:args.top]:
        print(f"  {nbytes / 1e9:9.4f} GB  {op:28s} {list(shape)} {dtype}")
    groups = collections.Counter()
    for nbytes, op, shape, dtype in mode.at_peak:
        groups[(op, shape, dtype)] += nbytes
    print("by (op, shape, dtype):")
    for (op, shape, dtype), nbytes in groups.most_common(args.top):
        print(f"  {nbytes / 1e9:9.4f} GB  {op:28s} {list(shape)} {dtype}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"record": rec, "at_peak": [
                {"bytes": b, "op": o, "shape": list(s), "dtype": d}
                for b, o, s, d in mode.at_peak]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
