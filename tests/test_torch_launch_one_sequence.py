"""A batch of one sequence runs the port's sharded LM programs as the
plain path runs it, on meshes whose data axes have size 1, on the CPU.

The rules split a batch over the data axes wherever its size divides
them (``batch_specs``, as the reference's do), so a batch of one is
split over a data axis of size 1: a ``Shard`` of a tensor dim of size 1
over one rank.  That is the layout ``Replicate`` is, but DTensor's view
rules refuse to flatten such a dim, so every arch's first product after
the embedding failed (``layers.dense``'s ``x @ w``) in a prefill, a
forward and a loss, on (1, 1), the one DTensor mesh the card runs, and
on the tensor-parallel (1, n) meshes.  A split over a mesh dim of size 1
is now written ``Replicate()`` where placements arise
(``sharding.to_placements``, ``layers.local_region``).

All ten smoke archs at B = 1 on gloo (1, 1) and (1, 4) groups, one group
per mesh, in fp32: a prefill and 3 greedy decode steps equal the plain
ones within 1e-5 of the logits' scale (the Mamba family's steps, as in
``test_torch_launch_zamba2_decode.py``, from the plain prefill's cache,
whose bf16 conv state otherwise carries the prefills' fp32 roundoff);
the loss within 1e-5 and the grads within 1e-4 of each leaf's max.
Each failed before the change.
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import ARCH_NAMES

TIMEOUT = 240.0
MESHES = [(1, 1), (1, 4)]
STEPS = 3
SSM = ("zamba2-2.7b", "mamba2-130m")


@pytest.fixture(scope="module")
def runs():
    attn = [a for a in ARCH_NAMES if a not in SSM]
    out = {}
    for mesh in MESHES:
        dec, dec_ssm, loss = run_spmd(ranks.in_turn, math.prod(mesh), [
            ("decode_vs_plain", (attn, mesh, STEPS, 1)),
            ("decode_vs_plain", (list(SSM), mesh, STEPS, 1, True)),
            ("loss_and_grads", (list(ARCH_NAMES), mesh, True, None, 1)),
        ], timeout=TIMEOUT)[0]
        out[mesh] = {"decode": {**dec, **dec_ssm}, "loss": loss}
    assert not spmd_processes()
    return out


CASES = [pytest.param(m, a, id=f"{m[0]}x{m[1]}-{a}")
         for m in MESHES for a in ARCH_NAMES]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_one_sequence_prefill_and_decode_equal_plain(mesh, arch, runs):
    r = runs[mesh]["decode"][arch]
    assert len(r["errs"]) == STEPS + 1, r
    assert max(r["errs"]) <= 1e-5 * r["scale"], r
    if mesh == (1, 1):
        # every leaf of the cache is whole on the one rank
        assert set(r["placements"]) == {"(Replicate(), Replicate())"}, r


@pytest.mark.parametrize("mesh,arch", CASES)
def test_one_sequence_loss_and_grads_equal_plain(mesh, arch, runs):
    r = runs[mesh]["loss"][arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r
