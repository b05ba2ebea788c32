"""The port's MoE layer moves a few tokens to the expert weights, not the
weights to the tokens, on the CPU.

The rules split each expert weight's ``D`` side over "data" (FSDP).
Where a block has fewer tokens than the rank's share of the gathered
weights (a decode step), every rank gathers the block's tokens, runs the
expert GEMMs on its slice of ``D`` with the weights where they lie, and
reduces the partial sums over "data"; the outputs' columns go back to
their rows by an all-to-all (or, where the tokens are not split over
"data", as a partial sum).  A training block keeps the ZeRO-3 gather of
the weights at use.

* mixtral's and llama4's smoke ``decode_32k`` cells on a fake (2, 2)
  group gather no expert weight (before: every MoE layer gathered its
  three over "data"; at full size 5.94 and 49.15 GB a step at (16, 16)).
* Prefill and greedy decode steps of both on a (2, 2) gloo mesh (the
  tokens split over "data") and on (8, 1) (4 sequences: the tokens
  whole on every rank, ``D`` over 8) equal the plain ones within 1e-5
  in fp32.  The training path of the same layer is held by the smoke
  models' loss and grads on (2, 2) in ``test_torch_launch_hooks.py``.
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import lower_cell

TIMEOUT = 240.0
MOE = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_gathers_no_expert_weight(arch):
    cfg = get_smoke_config(arch)
    rec = lower_cell(arch, "decode_32k", False, device="cpu", smoke=True,
                     mesh_shape=(2, 2))
    # a gathered (E, D, F) or (E, F, D) weight, its D side whole or a
    # rank's half (the gather stacks the ranks' shards along dim 0), its
    # F side whole (EP) or split over "model" (TP)
    D, F = cfg.d_model, cfg.d_ff
    weights = {s for d in (D, D // 2) for f in (F, F // 2)
               for s in ((d, f), (f, d))}
    gathers = [c for c in rec["largest_collectives"]
               if c["kind"] == "all-gather"]
    assert gathers and not [c for c in gathers if len(c["shape"]) >= 3
                            and tuple(c["shape"][-2:]) in weights], gathers


MESHES = {(2, 2): 3, (8, 1): 3}


@pytest.fixture(scope="module")
def decodes():
    out = {m: run_spmd(ranks.decode_vs_plain, math.prod(m), MOE, m, steps,
                       timeout=TIMEOUT)[0] for m, steps in MESHES.items()}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_equals_plain(arch, mesh, decodes):
    r = decodes[mesh][arch]
    assert len(r["errs"]) == MESHES[mesh] + 1, r
    assert max(r["errs"]) <= 1e-5 * max(r["scale"], 1.0), r
