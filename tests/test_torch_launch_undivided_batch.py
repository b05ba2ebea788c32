"""A batch that the data axes do not divide stays replicated over them
in the port's sharded LM programs, as in the reference's, on the CPU.

The rules replicate such a batch (``batch_specs``: B = 3 over a data
axis of 2).  Its products with the FSDP-split weights then come out
split along their columns over "data" (DTensor's cheapest strategy for
a replicated input and a column-split weight), and the residual stream
with them.  Two ops could not take that layout: the backward of a
norm put the rows of the gradient over "model" (3 rows over 2 ranks),
which the reshape after a few rows' product (``layers.dense``) could not
flatten, so every arch's loss failed in its backward; and whisper's
layernorm centred a column-split row into a partial mean with its rows
over "model", so its encoder failed in a prefill.  ``dense`` now hands
its output's gradient back in the output's own placements, and a
layernorm gathers a row split along its columns over a data axis first.

On a gloo (2, 2) group at B = 3, in fp32: every smoke arch's loss
within 1e-5 and its grads within 1e-4 of each leaf's max of the plain
ones; whisper's prefill and 3 greedy decode steps within 1e-5 of the
logits' scale.  Each failed before the change.
"""
import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import ARCH_NAMES

TIMEOUT = 240.0
MESH, BATCH, STEPS = (2, 2), 3, 3


@pytest.fixture(scope="module")
def runs():
    loss, dec = run_spmd(ranks.in_turn, 4, [
        ("loss_and_grads", (list(ARCH_NAMES), MESH, True, None, BATCH)),
        ("decode_vs_plain", (["whisper-tiny"], MESH, STEPS, BATCH)),
    ], timeout=TIMEOUT)[0]
    assert not spmd_processes()
    return {"loss": loss, "decode": dec}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_undivided_batch_loss_and_grads_equal_plain(arch, runs):
    r = runs["loss"][arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r


def test_undivided_batch_encdec_prefill_and_decode_equal_plain(runs):
    r = runs["decode"]["whisper-tiny"]
    assert len(r["errs"]) == STEPS + 1, r
    assert max(r["errs"]) <= 1e-5 * r["scale"], r
    # no cache leaf splits its batch of 3 (dim 1 of the layers' stack)
    # over "data"
    assert not [p for p in r["placements"]
                if p.startswith("(Shard(dim=1)")], r
