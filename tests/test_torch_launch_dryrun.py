"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

``lower_cell`` traces smoke configs over a fake (2, 2) process group
with ``device="cpu"``, for the train, prefill and decode kinds and the
MoE flags.  Its records carry the JAX record's keys; a skipped cell
carries JAX's ``cell_supported`` reason; ``model_flops_per_chip``
follows JAX's formula; the per-device argument bytes are the sum of the
local shard shapes the rules imply.  The CLI writes its JSON, and
``python -m benchmarks.roofline`` reads it (``DRYRUN_ART``) and exits 0.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import cell_supported as jax_cell_supported
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import SHAPES as JAX_SHAPES
from repro_torch.configs import ShapeSpec, get_smoke_config, input_specs
from repro_torch.launch import sharding as tsh
from repro_torch.launch.dryrun import lower_cell, lower_stencil
from repro_torch.models.api import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX package's record (repro/launch/dryrun.py:261-272)
JAX_KEYS = {"arch", "shape", "multi_pod", "skipped", "n_chips", "compile_s",
            "params", "active_params", "step_tokens", "memory", "cost",
            "cost_xla_raw", "collectives", "roofline"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes"}
ROOF_KEYS = {"t_compute", "t_memory", "t_collective", "dominant",
             "model_flops_per_chip", "useful_ratio", "roofline_fraction"}
KINDS = {"train": ShapeSpec("train_s", 64, 8, "train"),
         "prefill": ShapeSpec("prefill_s", 64, 4, "prefill"),
         "decode": ShapeSpec("decode_s", 64, 4, "decode")}
MESH = (2, 2)


def _cell(arch, kind, **flags):
    return lower_cell(arch, KINDS[kind].name, False, mesh_shape=MESH,
                      device="cpu", smoke=True, shape=KINDS[kind], **flags)


def _local_bytes(mesh_like, tree, specs):
    flat = dict(_paths(specs))
    return sum(math.prod(tsh.local_shape(mesh_like, flat[p], t.shape))
               * t.element_size() for p, t in _paths(tree))


def _paths(tree):
    out = []
    tsh.map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


class _Mesh:
    shape = {"data": 2, "model": 2}
    axis_names = ("data", "model")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m",
                                  "mixtral-8x7b", "whisper-tiny"])
def test_cell_record(arch, kind):
    rec = _cell(arch, kind)
    assert JAX_KEYS <= set(rec) and not rec["skipped"]
    assert set(rec["memory"]) == MEM_KEYS and set(rec["roofline"]) == ROOF_KEYS
    assert rec["n_chips"] == 4 and rec["cost_xla_raw"] is None
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert sum(rec["collectives"].values()) > 0
    cfg = get_smoke_config(arch)
    shape = KINDS[kind]
    mult = 3 if kind == "train" else 1
    assert rec["step_tokens"] == (shape.global_batch if kind == "decode" else
                                  shape.global_batch * input_specs(
                                      cfg, shape)["tokens"].shape[1])
    assert rec["roofline"]["model_flops_per_chip"] == (
        mult * 2 * cfg.active_param_count() * rec["step_tokens"] / 4)
    # arguments: the local shards of params (and moments), inputs, cache
    model = build_model(cfg)
    params = model.init_params(None, device="meta")
    pspecs = tsh.param_specs(cfg, params, _Mesh)
    ins = input_specs(cfg, shape)
    want = _local_bytes(_Mesh, params, pspecs) + _local_bytes(
        _Mesh, ins, tsh.batch_specs(cfg, shape, ins, _Mesh))
    if kind == "train":
        mom = tsh.map_with_path(lambda _, t: torch.empty(
            t.shape, dtype=torch.bfloat16, device="meta"), params)
        want += 2 * _local_bytes(_Mesh, mom, pspecs) + 4   # mu, nu, step
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 device="meta")
        want += _local_bytes(_Mesh, cache, tsh.cache_specs(
            cfg, shape, cache, _Mesh))
    assert rec["memory"]["argument_size_in_bytes"] == want


@pytest.mark.parametrize("flags", [
    {"moe_block_dispatch": True}, {"moe_shard_map": True},
    {"microbatches": 2}, {"seq_shard_acts": True, "attn_seq_shard": True},
    {"constrain_acts": False}])
def test_cell_flags(flags):
    rec = _cell("mixtral-8x7b", "train", **flags)
    assert not rec["skipped"] and rec["cost"]["flops"] > 0


def test_heads_that_do_not_divide_the_model_axis():
    """4 query heads over a "model" axis of 8: attention replicates over
    it, and the backward's gradient of the output projection (sharded
    over "model") must reach the head reshape as replicated (minitron's
    24 heads on the production mesh failed there)."""
    rec = lower_cell("minitron-4b", "train_s", False, mesh_shape=(2, 8),
                     device="cpu", smoke=True, shape=KINDS["train"])
    assert not rec["skipped"] and rec["n_chips"] == 16


def test_block_dispatch_changes_the_moe_work():
    one = lower_cell("llama4-maverick-400b-a17b", KINDS["train"].name, False,
                     mesh_shape=(1, 1), device="cpu", smoke=True,
                     shape=KINDS["train"])
    base = _cell("llama4-maverick-400b-a17b", "train")
    blocks = _cell("llama4-maverick-400b-a17b", "train",
                   moe_block_dispatch=True)
    # per-data-shard dispatch changes each rank's MoE work from the
    # one-rank mesh's to half of it: each rank routes half the tokens,
    # with a capacity of its own.  The default dispatch now routes each
    # data shard's rows too (under the whole batch's capacity), so it
    # does the same work as the blocks
    assert blocks["cost"]["flops"] < 0.55 * one["cost"]["flops"]
    assert abs(blocks["cost"]["flops"] - base["cost"]["flops"]) <= (
        0.01 * base["cost"]["flops"])


def test_skipped_cell_carries_the_jax_reason():
    for arch in ("qwen3-0.6b", "whisper-tiny"):
        rec = lower_cell(arch, "long_500k", False, mesh_shape=MESH,
                         device="cpu", smoke=True)
        ok, why = jax_cell_supported(jax_smoke_config(arch),
                                     JAX_SHAPES["long_500k"])
        assert rec["skipped"] and not ok and rec["reason"] == why


def test_stencil_cell():
    rec = lower_stencil(False, device="cpu", mesh_shape=(4, 4), Y=512,
                        X=256, k_ici=2)
    assert rec["n_chips"] == 16 and not rec["skipped"]
    # rank 0 sits at the mesh's corner: it sends one row halo and one
    # column halo of k*r = 2 rows/cols (box2d1r), fp32
    ly, lx, hk = 512 // 4, 256 // 4, 2
    assert rec["collectives"]["collective-permute"] == (
        hk * lx + hk * (ly + 2 * hk)) * 4


def test_cli_writes_records_that_roofline_reads(tmp_path):
    out = str(tmp_path / "art")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "decode_32k", "--smoke", "--mesh", "2x2",
         "--device", "cpu", "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "done: 1/1 cells OK" in run.stdout
    rec = json.load(open(os.path.join(out, "qwen3-0.6b__decode_32k__pod1.json")))
    assert JAX_KEYS <= set(rec)
    roof = subprocess.run(
        [sys.executable, "-m", "benchmarks.roofline"], cwd=ROOT,
        env=dict(env, DRYRUN_ART=out), capture_output=True, text=True,
        timeout=300)
    assert roof.returncode == 0, roof.stderr[-3000:]
    assert "roofline/qwen3-0.6b/decode_32k" in roof.stdout
