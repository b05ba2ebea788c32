"""Tied embeddings with a vocab that does not divide "model" train on a
data x model mesh, on the CPU.

mamba2-130m's ``train_4k`` failed on both production meshes under torch
2.11: the tied table's lookup gradient (partial over "data") and head
gradient (sharded) met in one ``aten.add``, and 2.11's DTensor could not
turn the shard into a partial sum.  Its smallest
failing cell is mamba2's smoke train step with a 250-entry vocab on
(2, 4) (the full config failed so on (2, 16)); 2.13 takes both.  The
table now takes its gradients in its own placements, and the loss takes
the logits' uneven vocab split (250 over 4) as it is.

* That cell traces on a fake (2, 4) group and gathers no logits.
* On a (2, 4) gloo mesh, mamba2's and qwen3's smoke models with that
  vocab give the plain loss and grads (loss 1e-5, grads 1e-4 of a
  leaf's max, fp32).
"""
import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import ShapeSpec

TIMEOUT = 240.0
RAGGED = [(f"{a}/V=250", a, {"vocab": 250})
          for a in ("mamba2-130m", "qwen3-0.6b")]


def test_tied_ragged_vocab_trains_on_a_data_and_model_mesh():
    shape = ShapeSpec("train_s", 64, 8, "train")
    rec = dryrun.lower_cell("mamba2-130m", shape.name, False, device="cpu",
                            smoke=True, mesh_shape=(2, 4), shape=shape,
                            overrides={"vocab": 250})
    assert rec["cost"]["flops"] > 0
    gathers = [c["numel"] for c in rec["largest_collectives"]
               if c["kind"] == "all-gather"]
    # none as large as a rank's rows of logits over the whole vocab
    assert max(gathers) < 8 // 2 * 64 * 250, rec["largest_collectives"]


@pytest.fixture(scope="module")
def losses():
    out = run_spmd(ranks.loss_and_grads, 8, RAGGED, (2, 4), True,
                   timeout=TIMEOUT)[0]
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("arch", [c[0] for c in RAGGED])
def test_tied_ragged_vocab_loss_equals_plain(arch, losses):
    r = losses[arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r
