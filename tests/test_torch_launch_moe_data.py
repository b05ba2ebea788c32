"""The port's default MoE dispatch on DTensors splits its work over the
data axes while it keeps the plain layer's global capacity, on the
CPU.

Each data shard routes its own rows; each expert's queue positions are
offset by the earlier shards' counts (an all-gather of E integers), so
the same assignments are kept as in the plain layer, and the expert
GEMMs run over data x model on each rank's share of the capacity slots.
That share is filled from a local expert buffer reduce-scattered along
its slots where the buffer has fewer rows than the block has tokens,
else from the block's all-gathered tokens; the cases below take both.

* The per-rank FLOPs of mixtral's and llama4's smoke train cells fall
  with the data axis: at most 0.55 of the (1, 1) count on (2, 1) and
  0.3 on (4, 1) (before, every rank routed the whole batch: 0.77 and
  0.65 for mixtral).
* One MoE layer on DTensors over (2, 2) and (4, 1) gloo meshes equals
  the plain layer in fp32: outputs and aux within 1e-5, grads within
  1e-4 of a leaf's max, with capacity factors 0.5 and 0.75 (where the
  capacity drops assignments: mixtral's buffer, then its tokens) and
  1.25; the experts split over "model" as the rules place them (over
  (2, 2) by expert, EP).
* mixtral's smoke train cell on a fake (2, 1) group all-gathers its
  block's tokens and no tensor as large as its expert buffer (before,
  the buffer's outputs were gathered back: 4x the tokens here, 2.5x at
  the full config's capacity factor 1.25 and top-2).
"""
import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.models.moe import moe_capacity

TIMEOUT = 240.0
MOE = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]


SHAPE = ShapeSpec("train_s", 128, 8, "train")


def _record(arch, mesh):
    return lower_cell(arch, SHAPE.name, False, device="cpu", smoke=True,
                      mesh_shape=mesh, shape=SHAPE)


def _flops(arch, mesh):
    return _record(arch, mesh)["cost"]["flops"]


@pytest.mark.parametrize("arch", MOE)
def test_moe_work_falls_with_the_data_axis(arch):
    one, two, four = (_flops(arch, (n, 1)) for n in (1, 2, 4))
    assert two <= 0.55 * one and four <= 0.3 * one, (two / one, four / one)


def test_moe_gathers_tokens_not_the_expert_buffer():
    # mixtral's smoke block (all 1024 tokens of the step) has fewer
    # tokens than its (4, 1024, 64) expert buffer has rows: the ranks
    # gather the tokens, never the buffer or its outputs
    cfg = get_smoke_config("mixtral-8x7b")
    T = SHAPE.global_batch * SHAPE.seq_len
    rows = cfg.n_experts * moe_capacity(cfg, T)
    assert T < rows
    rec = _record("mixtral-8x7b", (2, 1))
    gathers = [c["numel"] for c in rec["largest_collectives"]
               if c["kind"] == "all-gather"]
    assert T * cfg.d_model in gathers, rec["largest_collectives"]
    assert max(gathers) < rows * cfg.d_model, rec["largest_collectives"]


@pytest.fixture(scope="module")
def layers():
    # top-1 routing's gate weight is 1 (p / p): its gradient is rounding
    # noise, so llama4's router grad is held at the default capacity only
    cases = {"mixtral-8x7b": (0.5, 0.75, 1.25), "llama4-maverick-400b-a17b": (1.25,)}
    out = {mesh: run_spmd(ranks.moe_vs_plain, 4, mesh, cases,
                          timeout=TIMEOUT)[0] for mesh in ((2, 2), (4, 1))}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", MOE)
def test_data_parallel_moe_layer_equals_plain(arch, mesh, layers):
    res = layers[mesh][arch]
    for cf, r in res.items():
        assert r["y_err"] <= 1e-5 * max(r["y_scale"], 1.0), (cf, r)
        assert r["aux_err"] <= 1e-5, (cf, r)
        assert r["grad_err"] <= 1e-4, (cf, r)
    if arch == "mixtral-8x7b":
        # the capacity binds
        assert res[0.5]["dropped"] > 0 and res[0.75]["dropped"] > 0
