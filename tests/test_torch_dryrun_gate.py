"""The bench gate, fed by the port: the dry-run records of
``benchmarks/run.py --dry-run --codec all`` rebuilt with the port's
planners, lowering and ``DryRunExecutor`` pass
``benchmarks/check_regression.py::check`` against the committed
``benchmarks/baselines.json`` with zero tolerance and zero errors.

The records mirror ``benchmarks/run.py:114-287`` field for field: the
five paper stencils x five engines x three codecs on the 38400² domain
(byte accounting plus ``lower(...).describe()``'s stage count and shape
buckets), the 1024³ heat3d1r box temporal-blocking plans, the 4 x 2
sharded plans and the hierarchical heat3d1r plans.  Geometry only: no
domain is allocated.  Both benchmark files are read, never written.
"""
import json
import os

from benchmarks import common as bcommon
from benchmarks import run as brun
from benchmarks.check_regression import check
from repro_torch.core.compress import compress_plan
from repro_torch.core.executor import DryRunExecutor
from repro_torch.core.hierarchy import compile_hierarchical
from repro_torch.core.lower import lower
from repro_torch.core.oocore import compile_box_plan, compile_plan
from repro_torch.core.shard import compile_sharded
from repro_torch.core.stencil import PAPER_BENCHMARKS, get_stencil

BASELINES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "baselines.json")
ENGINES = ("box_tb", "incore", "naive_tb", "resreu", "so2dr")
CODECS = ("bf16", "identity", "zrle")
EX = DryRunExecutor()


def _paper_plan(engine, name, sz, d, s_tb):
    """``benchmarks/common.py::paper_plan`` on the port's planner."""
    st = get_stencil(name)
    Y = X = sz + 2 * st.radius
    k_on = 1 if engine == "resreu" else bcommon.K_ON
    return compile_plan(engine, st, Y, X, bcommon.N_STEPS,
                        1 if engine == "incore" else d, s_tb, k_on)


def _geometry(plan):
    return {"shape": list(plan.shape), "chunk_axis": plan.chunk_axis,
            "tiles": list(plan.tiles) if plan.tiles else [plan.d],
            "time_depth": plan.k_off}


def _lowered_record(plan):
    _, s = EX.execute(plan)
    desc = lower(plan, device="cpu").describe()
    return {
        "plan_ops": len(plan), "raw_bytes": s.transfer_bytes,
        "wire_bytes": s.wire_bytes, "h2d_wire_bytes": s.h2d_wire_bytes,
        "d2h_wire_bytes": s.d2h_wire_bytes, "buffer_bytes": s.buffer_bytes,
        "kernel_calls": s.kernel_calls, "stage_count": desc["stage_count"],
        "shape_buckets": desc["shape_buckets"], "box": _geometry(plan),
    }


def _row_records():
    records = {}
    for name in PAPER_BENCHMARKS:
        d, s_tb = bcommon.PAPER_CONFIG[name]
        for engine in ENGINES:
            base = _paper_plan(engine, name, bcommon.OOC_SZ, d, s_tb)
            for codec in CODECS:
                records[f"{name}/{engine}/{codec}"] = _lowered_record(
                    compress_plan(base, codec))
    return records


def _box_records():
    records = {}
    st = get_stencil(brun.BOX_STENCIL)
    for tiles in brun.BOX_TILES:
        for t in brun.BOX_DEPTHS:
            base = compile_box_plan(st, brun.BOX_SHAPE, brun.BOX_STEPS,
                                    tiles, t)
            tag = "x".join(str(x) for x in tiles)
            for codec in CODECS:
                plan = compress_plan(base, codec)
                rec = _lowered_record(plan)
                rec["redundant_elements"] = EX.execute(
                    plan)[1].redundant_elements
                records[f"{brun.BOX_STENCIL}/box_tb/tiles{tag}/t{t}/"
                        f"{codec}"] = rec
    return records


def _sharded_records():
    records = {}
    mesh = brun.SHARD_MESH
    for name in PAPER_BENCHMARKS:
        for k_ici in brun.SHARD_K_ICI:
            plan = compile_sharded(name, bcommon.OOC_SZ, bcommon.OOC_SZ,
                                   bcommon.N_STEPS, k_ici, mesh)
            _, s = EX.execute(plan)
            records[f"sharded/{name}/mesh{mesh[0]}x{mesh[1]}/k{k_ici}"] = {
                "plan_ops": len(plan), "raw_bytes": s.transfer_bytes,
                "ici_bytes": s.ici_bytes,
                "collective_bytes_per_round":
                    plan.collective_bytes_per_round,
                "halo_ops": s.halo_ops, "kernel_calls": s.kernel_calls,
                "redundant_elements": s.redundant_elements,
                "stage_count": len(plan.barriers),
            }
    return records


def _hierarchy_records():
    records = {}
    mesh = brun.HIER_MESH
    for codec in brun.HIER_CODECS:
        plan = compile_hierarchical(
            brun.HIER_STENCIL, brun.HIER_SIDE, brun.HIER_SIDE,
            brun.HIER_STEPS, brun.HIER_K_ICI, mesh, c_dev=brun.HIER_C_DEV,
            inner_engine="box_tb",
            codec=None if codec == "identity" else codec,
            trailing=brun.HIER_TRAILING)
        _, s = EX.execute(plan)
        records[f"hier/{brun.HIER_STENCIL}/mesh{mesh[0]}x{mesh[1]}"
                f"/k{brun.HIER_K_ICI}/{codec}"] = {
            "plan_ops": len(plan), "raw_bytes": s.transfer_bytes,
            "wire_bytes": s.wire_bytes, "buffer_bytes": s.buffer_bytes,
            "ici_bytes": s.ici_bytes, "ici_wire_bytes": s.ici_wire_bytes,
            "collective_bytes_per_round": plan.collective_bytes_per_round,
            "collective_wire_bytes_per_round":
                plan.collective_wire_bytes_per_round,
            "halo_ops": s.halo_ops, "codec_ops": s.codec_ops,
            "kernel_calls": s.kernel_calls,
            "inner_chunks": plan.inner_chunks,
            "redundant_elements": s.redundant_elements,
            "stage_count": len(plan.barriers),
        }
    return records


def _baselines():
    with open(BASELINES) as f:
        return json.load(f)


def test_port_dry_run_records_pass_the_bench_gate():
    records = {**_row_records(), **_box_records(), **_sharded_records(),
               **_hierarchy_records()}
    baseline = _baselines()
    assert len(records) == len(baseline) == 105
    errors, notes = check(records, baseline, 0.0)
    assert errors == [] and notes == []
