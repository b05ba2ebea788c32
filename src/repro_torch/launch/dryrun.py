"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake
tensors (the port of ``repro.launch.dryrun``).

The JAX package lowers each cell's jitted program against
``ShapeDtypeStruct`` stand-ins on 512 placeholder devices and compiles
it.  PyTorch has no compiler to ask, so here each cell runs once, for
real, on stand-ins that hold no data: a fake process group of the mesh's
size (:func:`~repro_torch.launch.mesh.start_fake_group`, collectives move
nothing), a ``DeviceMesh`` over it, and params, optimizer moments,
inputs and caches built as DTensors of fake tensors (``FakeTensorMode``:
shapes, dtypes and devices, no allocation), placed by the sharding
rules.  This process plays rank 0.  The cell is one ``Trainer.step``
(AdamW with bf16 moments, optionally microbatched), a ``prefill`` or a
``decode_step``, run under :class:`~repro_torch.launch.op_analysis.
CostMode`, which records per device:

* ``memory`` — the JAX record's keys: arguments are the local bytes of
  params, optimizer state, inputs and cache; temp is the peak of the
  bytes the step allocates on top of them; alias is the donated bytes
  (params and moments of a train step, the cache of a serve step);
  generated code is 0 (nothing is compiled);
* ``cost`` — FLOPs and bytes by the op-level rules of
  :mod:`~repro_torch.launch.op_analysis` (``cost_xla_raw`` is None: no
  XLA);
* collective bytes per JAX op kind;
* a three-term roofline against one H100's data-sheet rates, and the
  analytic MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE) for the
  useful-compute ratio.

``compile_s`` is the trace's wall seconds.  ``device="cuda"`` (the
default) fakes CUDA tensors; ``device="cpu"`` fakes CPU ones, for a
machine without a card.  ``mesh_shape`` replaces the production mesh
(``--mesh 2x2``).  Sequence-sharded attention (``attn_seq_shard``)
sets the q-chunk alignment and the batched q-chunk path on every rank;
on DTensors attention splits its heads over "model" where they divide
it and its query rows where they do not, with or without the flag.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke --mesh 2x2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --stencil

Artifacts: one JSON per cell under --out (default artifacts/dryrun_torch/);
``DRYRUN_ART=<out> python -m benchmarks.roofline`` reads them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional, Sequence

import torch

from ..configs import (
    ARCH_NAMES, SHAPES, ShapeSpec, cell_supported, get_config,
    get_smoke_config, input_specs,
)
from ..core.analytic import H100_SXM
from ..models.api import build_model
from ..models.layers import set_activation_sharding, set_attention_sharding
from ..models.moe import set_moe_block_dispatch, set_moe_shard_map
from ..optim import AdamW, OptState
from ..train import TrainConfig, Trainer
from .collectives import RING_FACTORS
from .mesh import (
    data_axes, make_mesh, mesh_sizes, production_shape, start_fake_group,
    stop_group,
)
from .op_analysis import CostMode
from .sharding import (
    NamedSharding, PartitionSpec as P, batch_specs, cache_specs, local_shape,
    map_with_path, opt_specs, param_specs, to_placements,
)

__all__ = ["lower_cell", "lower_stencil", "main", "register_hooks",
           "clear_hooks", "largest_collectives", "BF16_PEAK", "FP32_PEAK",
           "HBM_BW", "LINK_BW"]

# One H100 SXM at 700 W, NVIDIA's data sheet (dense, no sparsity); no
# constant here was measured.
BF16_PEAK = 989e12                 # bf16 tensor-core FLOP/s (data sheet)
FP32_PEAK = H100_SXM.peak_vpu_flops  # 67 TFLOP/s fp32, CUDA cores (data sheet)
HBM_BW = H100_SXM.bw_dmem          # 3.35 TB/s HBM3 (data sheet)
LINK_BW = 450e9                    # NVLink 4, bytes/s per direction (data sheet)

def _roofline(cost, colls, n_chips, model_flops):
    """Three roofline terms (seconds, per step) + dominant bottleneck."""
    t_compute = cost["flops"] / BF16_PEAK           # per-device flops already
    t_memory = cost["bytes_accessed"] / HBM_BW
    t_coll = sum(colls[k] * f for k, f in RING_FACTORS.items()) / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)
    useful = model_flops / n_chips
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dom,
        "model_flops_per_chip": useful,
        "useful_ratio": (useful / cost["flops"]) if cost["flops"] else 0.0,
        "roofline_fraction": (useful / BF16_PEAK) / max(
            max(terms.values()), 1e-30
        ),
    }


def _mesh_axes(mesh_shape: Sequence[int]) -> tuple:
    return (("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))


def _leaves(tree) -> list:
    out = []
    map_with_path(lambda _, t: out.append(t), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()
    return total


def _stand_ins(shape_tree, mesh, specs, device):
    """DTensors of empty local tensors (fake under the caller's
    ``FakeTensorMode``), of each leaf's dtype and its shard's shape."""
    from torch.distributed.tensor import DTensor

    flat = {}
    map_with_path(lambda p, s: flat.__setitem__(p, s), specs)

    def mk(path, t):
        spec = flat[path]
        loc = torch.empty(local_shape(mesh, spec, t.shape), dtype=t.dtype,
                          device=device)
        return DTensor.from_local(loc, mesh, to_placements(mesh, spec),
                                  run_check=False)

    return map_with_path(mk, shape_tree)


def register_hooks(mesh, shape, constrain_acts=True, attn_seq_shard=False,
                   seq_shard_acts=False, moe_block_dispatch=False,
                   moe_shard_map=False):
    """The launch layer's hooks into the models for a ``shape`` cell on
    ``mesh``, as JAX's lower_cell sets them (:func:`clear_hooks` undoes
    them)."""
    dp = data_axes(mesh)
    sizes = mesh_sizes(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    div = shape.global_batch % n_dp == 0

    def placed(spec):
        return NamedSharding(mesh, to_placements(mesh, spec))

    if constrain_acts and div:
        # Megatron-SP style with seq_shard_acts: the residual stream
        # sequence-sharded over "model" between blocks
        set_activation_sharding(placed(P(dp, "model", None) if seq_shard_acts
                                       else P(dp, None, None)))
    else:
        set_activation_sharding(None)
    if attn_seq_shard and div:
        set_attention_sharding(
            placed(P("model", dp, None, None, None, None)), sizes["model"])
    else:
        set_attention_sharding(None, None)
    if moe_shard_map and div:
        set_moe_shard_map(mesh, dp if len(dp) > 1 else dp[0])
    else:
        set_moe_shard_map(None, None)
    if moe_block_dispatch and div:
        # per-data-shard MoE dispatch (shard-local capacity)
        set_moe_block_dispatch(n_dp, placed(P(dp, None, None)))
    else:
        set_moe_block_dispatch(None, None)


def clear_hooks():
    set_activation_sharding(None)
    set_attention_sharding(None, None)
    set_moe_block_dispatch(None, None)
    set_moe_shard_map(None, None)


def _traced(fn, fake_mode):
    """Run ``fn`` under a :class:`CostMode`: (output, mode, seconds)."""
    mode = CostMode(fake_mode)
    t0 = time.perf_counter()
    with fake_mode, mode:
        out = fn()
    return out, mode, time.perf_counter() - t0


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               constrain_acts: bool = True, attn_seq_shard: bool = False,
               seq_shard_acts: bool = False, moe_block_dispatch: bool = False,
               moe_shard_map: bool = False, microbatches: int = 1,
               mesh_shape: Optional[Sequence[int]] = None, device="cuda",
               smoke: bool = False, shape: Optional[ShapeSpec] = None,
               overrides: Optional[dict] = None):
    """Trace one (arch x shape x mesh) cell on fake tensors; returns its
    record.  ``smoke`` takes the arch's smoke config; ``shape`` replaces
    ``SHAPES[shape_name]``; ``overrides`` replaces config fields.  Starts
    (and stops) a fake process group of the mesh's size unless one of
    that size is running."""
    import dataclasses

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace((get_smoke_config if smoke else get_config)(
        arch), **(overrides or {}))
    shape = shape or SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True, "reason": why}

    if mesh_shape is None:
        mesh_shape, axes = production_shape(multi_pod)
    else:
        mesh_shape, axes = tuple(mesh_shape), _mesh_axes(mesh_shape)
    started = not dist.is_initialized()
    if started:
        start_fake_group(math.prod(mesh_shape))
    try:
        mesh = make_mesh(mesh_shape, axes, device_type=torch.device(device).type)
        return _lower(cfg, arch, shape_name, shape, multi_pod, mesh, device,
                      microbatches, FakeTensorMode(),
                      (constrain_acts, attn_seq_shard, seq_shard_acts,
                       moe_block_dispatch, moe_shard_map))
    finally:
        clear_hooks()
        if started:
            stop_group()


def _lower(cfg, arch, shape_name, shape, multi_pod, mesh, device,
           microbatches, fake, flags):
    model = build_model(cfg)
    params_shape = model.init_params(None, device="meta")
    pspecs = param_specs(cfg, params_shape, mesh)
    specs_in = input_specs(cfg, shape)
    register_hooks(mesh, shape, *flags)
    with fake:
        params = _stand_ins(params_shape, mesh, pspecs, device)
        batch = _stand_ins(specs_in, mesh,
                           batch_specs(cfg, shape, specs_in, mesh), device)

    if shape.kind == "train":
        opt = AdamW(moment_dtype=torch.bfloat16)
        ospecs = opt_specs(pspecs)
        opt_shape = OptState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            mu=map_with_path(lambda _, t: torch.empty(
                t.shape, dtype=torch.bfloat16, device="meta"), params_shape),
            nu=map_with_path(lambda _, t: torch.empty(
                t.shape, dtype=torch.bfloat16, device="meta"), params_shape))
        with fake:
            opt_state = _stand_ins(opt_shape, mesh, ospecs, device)
        trainer = Trainer(model, opt, TrainConfig(microbatches=microbatches),
                          donate=True, device=device)
        args = (params, opt_state, batch)
        out, mode, secs = _traced(
            lambda: trainer.step(params, opt_state, None, batch), fake)
        outputs = (out[0], out[1], out[3])
        alias = _local_bytes(params) + _local_bytes(opt_state)
        step_tokens = shape.global_batch * list(specs_in.values())[0].shape[1]
        flops_mult = 3  # fwd + bwd ~= 3x forward matmul flops
    else:
        cache_shape = model.init_cache(shape.global_batch, shape.seq_len,
                                       device="meta")
        with fake:
            cache = _stand_ins(cache_shape, mesh,
                               cache_specs(cfg, shape, cache_shape, mesh),
                               device)
        args = (params, batch, cache)
        if shape.kind == "prefill":
            outputs, mode, secs = _traced(
                lambda: model.prefill(params, batch, cache), fake)
            step_tokens = shape.global_batch * specs_in["tokens"].shape[1]
        else:
            with fake:
                pos = torch.zeros((), dtype=torch.int32, device=device)
            outputs, mode, secs = _traced(
                lambda: model.decode_step(params, batch["token"], pos, cache),
                fake)
            step_tokens = shape.global_batch  # one token per sequence
        alias = _local_bytes(cache)
        flops_mult = 1

    n_chips = mesh.size()
    cost = {"flops": mode.cost.flops, "bytes_accessed": mode.cost.bytes}
    colls = {k: int(v) for k, v in mode.cost.collectives.items()}
    mem = {
        "argument_size_in_bytes": sum(_local_bytes(a) for a in args),
        "output_size_in_bytes": _local_bytes(outputs),
        "temp_size_in_bytes": int(mode.peak_bytes),
        "alias_size_in_bytes": alias,
        "generated_code_size_in_bytes": 0,
    }
    model_flops = flops_mult * 2 * cfg.active_param_count() * step_tokens
    roof = _roofline(cost, colls, n_chips, model_flops)
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "skipped": False, "n_chips": n_chips,
        "mesh": dict(mesh_sizes(mesh)),
        "compile_s": round(secs, 1),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "step_tokens": step_tokens,
        "memory": mem, "cost": cost, "cost_xla_raw": None,
        "collectives": colls, "ops": mode.ops,
        "largest_collectives": largest_collectives(mode),
        "roofline": roof,
    }


def largest_collectives(mode, top: int = 8) -> list:
    """The ``top`` largest collective results of a traced cell, by the
    bytes of one result: kind, shape, dtype, count, element count of one
    result and bytes of all; an all-gather's result is the gathered
    tensor (stacked on dim 0)."""
    out = []
    for (kind, shape, dtype), n in mode.collective_shapes.items():
        numel = math.prod(shape)
        size = torch.empty((), dtype=getattr(torch, dtype.split(".")[-1]))
        out.append({"kind": kind, "shape": list(shape), "dtype": dtype,
                    "count": n, "numel": numel,
                    "bytes": n * numel * size.element_size()})
    return sorted(out, key=lambda r: -r["bytes"] / r["count"])[:top]


def lower_stencil(multi_pod: bool, name: str = "box2d1r", k_ici: int = 8,
                  Y: int = 65536, X: int = 32768, device="cuda",
                  mesh_shape: Optional[Sequence[int]] = None):
    """Dry-run the L2 distributed stencil on the production mesh: rank
    0's program of :mod:`repro_torch.core.distributed` (one round: a
    halo exchange and ``k_ici`` masked steps) on a fake block, its halo
    sends counted as ``collective-permute``.  The pod axis folds into
    the rows."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..core.distributed import _local_rounds
    from ..core.ranks import _RankContext
    from ..core.stencil import get_stencil

    if mesh_shape is None:
        mesh_shape = production_shape(multi_pod)[0]
    mesh_shape = tuple(mesh_shape)
    rows = math.prod(mesh_shape[:-1])
    cols = mesh_shape[-1]
    Yl = Y * 2 if multi_pod else Y
    if Yl % rows or X % cols:
        raise ValueError(f"a {Yl}x{X} domain does not divide over "
                         f"{rows}x{cols} ranks")
    st = get_stencil(name)
    started = not dist.is_initialized()
    if started:
        start_fake_group(rows * cols)
    try:
        ctx = _RankContext(0, (rows, cols), torch.device("cpu"), staged=False)
        fake = FakeTensorMode()
        with fake:
            own = torch.empty((Yl // rows, X // cols), dtype=torch.float32,
                              device=device)
        _, mode, secs = _traced(
            lambda: _local_rounds(own, st, k_ici, 1, ctx, Yl, X), fake)
    finally:
        if started:
            stop_group()
    cost = {"flops": mode.cost.flops, "bytes_accessed": mode.cost.bytes}
    colls = {k: int(v) for k, v in mode.cost.collectives.items()}
    mem = {
        "argument_size_in_bytes": own.numel() * own.element_size(),
        "output_size_in_bytes": own.numel() * own.element_size(),
        "temp_size_in_bytes": int(mode.peak_bytes),
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
    }
    t_comp = cost["flops"] / FP32_PEAK  # stencils are fp32 CUDA-core work
    t_mem = cost["bytes_accessed"] / HBM_BW
    t_coll = colls["collective-permute"] / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return {
        "arch": f"stencil-{name}-k{k_ici}", "shape": f"{Yl}x{X}",
        "multi_pod": multi_pod, "skipped": False,
        "n_chips": rows * cols,
        "compile_s": round(secs, 1),
        "memory": mem, "cost": cost, "collectives": colls,
        "roofline": {
            **{f"t_{k}": v for k, v in terms.items()},
            "dominant": max(terms, key=terms.get),
        },
    }


def _parse_mesh(text: Optional[str]):
    if not text:
        return None
    return tuple(int(n) for n in text.lower().split("x"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--stencil", action="store_true")
    ap.add_argument("--k-ici", type=int, default=8)
    ap.add_argument("--no-act-constraint", action="store_true",
                    help="pure-propagation baseline (perf iter0)")
    ap.add_argument("--attn-seq-shard", action="store_true",
                    help="sequence-sharded attention (perf iteration)")
    ap.add_argument("--seq-shard-acts", action="store_true",
                    help="sequence-sharded residual stream (Megatron-SP)")
    ap.add_argument("--moe-block-dispatch", action="store_true",
                    help="per-data-shard MoE dispatch (perf iteration)")
    ap.add_argument("--moe-shard-map", action="store_true",
                    help="explicit-collective shard_map MoE (perf iteration)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="grad-accumulation microbatches for train cells")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda, or cpu)")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape in place of the production one, e.g. 2x2")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs (for tests)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    mesh_shape = _parse_mesh(args.mesh)

    jobs = []
    if args.stencil:
        for mp in meshes:
            jobs.append(("stencil", None, mp))
    else:
        archs = [args.arch] if args.arch else list(ARCH_NAMES)
        shapes = [args.shape] if args.shape else list(SHAPES)
        for a in archs:
            for s in shapes:
                for mp in meshes:
                    jobs.append((a, s, mp))

    failures = 0
    for a, s, mp in jobs:
        tag = f"{a}__{s}__{'pod2' if mp else 'pod1'}"
        try:
            if a == "stencil":
                rec = lower_stencil(mp, k_ici=args.k_ici, device=args.device,
                                    mesh_shape=mesh_shape)
                tag = f"{rec['arch']}__{'pod2' if mp else 'pod1'}"
            else:
                rec = lower_cell(a, s, mp,
                                 constrain_acts=not args.no_act_constraint,
                                 attn_seq_shard=args.attn_seq_shard,
                                 seq_shard_acts=args.seq_shard_acts,
                                 moe_block_dispatch=args.moe_block_dispatch,
                                 moe_shard_map=args.moe_shard_map,
                                 microbatches=args.microbatches,
                                 mesh_shape=mesh_shape, device=args.device,
                                 smoke=args.smoke)
            status = "SKIP" if rec.get("skipped") else "OK"
            extra = rec.get("reason", "") if rec.get("skipped") else (
                f"compile={rec['compile_s']}s dom={rec['roofline']['dominant']}"
            )
            print(f"{status:4s} {tag}  {extra}", flush=True)
        except Exception as e:  # a failure here is a bug in the system
            failures += 1
            rec = {"arch": a, "shape": s, "multi_pod": mp, "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"FAIL {tag}  {e}", flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"done: {len(jobs) - failures}/{len(jobs)} cells OK")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
