"""A decode step's few rows meet the weights' FSDP split by explicit
all-to-alls, so a dry run's record does not depend on the fake tensors'
device, on the CPU.

DTensor moves a shard between tensor dims by a collective it picks by
device type: an all-to-all on a CUDA mesh, an all-gather and a chunk on
a CPU one.  In a decode step it moved each dense layer's rows to the
weight's split of the hidden dim and back, so every decode cell's wire
bytes differed between the two (qwen3 ``decode_32k`` 0.1405 GB on a CPU
mesh, 0.0921 on a CUDA one).  ``layers.dense`` now makes both moves
explicit all-to-alls where the rows are few beside the gathered weight.
The smoke decode cells of qwen3 and phi3, widened to a 256-wide hidden
dim so their rows are few beside the weights, all-gather no rows of the
residual stream on a fake (2, 2) CPU group (before: each layer gathered
them over "data"; an MoE layer gathers its block's tokens by design).
"""
import pytest

from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import lower_cell

WIDE = {"d_model": 256, "d_ff": 512}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3-medium-14b"])
def test_decode_rows_move_by_all_to_all(arch):
    rec = lower_cell(arch, "decode_32k", False, device="cpu", smoke=True,
                     mesh_shape=(2, 2), overrides=WIDE)
    B = SHAPES["decode_32k"].global_batch
    rows = [c for c in rec["largest_collectives"] if c["kind"] == "all-gather"
            and c["shape"][0] == B and c["shape"][-1] == WIDE["d_model"]]
    assert rec["collectives"]["all-to-all"] > 0, rec["collectives"]
    assert not rows, rec["largest_collectives"]
