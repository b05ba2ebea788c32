"""The port's sharded programs partition the same way whatever DTensor
would pick, on the CPU.

DTensor chooses each op's placements from its own cost model, which
differs between torch versions, and moves a shard from one tensor dim
to another by a collective it picks by device type (an all-to-all on a
CUDA mesh, an all-gather and a slice on a CPU mesh).  So the models
anchor what they can and move shards themselves:

* A row-parallel product's partial sum is reduced in ``dense`` itself,
  its gradient passed back replicated (Megatron's row-parallel layer).
  Left partial, it was reduced wherever DTensor next met it: the
  attention's sum stayed partial through the MoE layer into the head,
  whose logits the loss then reduced over the whole vocab (the mixtral
  and llama4 smoke train cells on a fake (1, 2) group all-reduced a
  (256, 4096, 256) logits slab, a rank's over the whole vocab), the
  VLM's gated cross-attention block split its batch over "model", and
  the two torch versions reduced llama4's sums a different number of
  times (its full ``train_4k`` cell 8.5 % more bytes on the wire under
  torch 2.13 than under 2.11).  qwen3, a dense model, is the control.
* Where the Mamba-2 mixer, the SSD scan or sequence-parallel attention
  changes which dim "model" splits, it does so in a region with an
  explicit all-to-all; the gated norm is a region; the dt projection,
  too narrow to split, keeps its columns whole; and the trainer hands
  each grad back in its param's placements.  Before, the mamba2 and
  zamba2 smoke train cells on (1, 2) left 20 and 40 shard moves to
  DTensor (on a CPU mesh, all-gathers of activations, 6.2 and 12.4 GB),
  the VLM's 9, and a data split (2, 1) moved the grads of stacked
  weights in the optimizer.

Each cell is traced on fake tensors (``lower_cell``) at a short smoke
shape; DTensor's own shard moves are counted where it makes them.
"""
import contextlib
import math

import pytest

from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import lower_cell

SHAPE = ShapeSpec("train_s", 256, 8, "train")


@contextlib.contextmanager
def dtensor_shard_moves():
    """The input shapes of every move of a shard between tensor dims
    that DTensor makes itself (its ``shard_dim_alltoall``) meanwhile."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt

    moves, mods = [], [m for m in (pt, cu) if hasattr(m, "shard_dim_alltoall")]
    orig = cu.shard_dim_alltoall

    def counted(input, *args, **kwargs):
        moves.append(tuple(input.shape))
        return orig(input, *args, **kwargs)

    for m in mods:
        m.shard_dim_alltoall = counted
    try:
        yield moves
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig


def _trace(arch, mesh):
    with dtensor_shard_moves() as moves:
        rec = lower_cell(arch, SHAPE.name, False, device="cpu", smoke=True,
                         mesh_shape=mesh, shape=SHAPE)
    return rec, moves


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b",
                                  "qwen3-0.6b"])
def test_no_collective_moves_a_ranks_full_vocab_logits(arch):
    rec, _ = _trace(arch, (1, 2))
    cfg = get_smoke_config(arch)
    logits = SHAPE.global_batch * SHAPE.seq_len * cfg.vocab
    big = [c for c in rec["largest_collectives"]
           if c["kind"] in ("all-reduce", "all-gather")
           and c["numel"] >= logits]
    assert rec["cost"]["flops"] > 0 and not big, big


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_mamba_leaves_no_shard_move_to_dtensor(arch, mesh):
    rec, moves = _trace(arch, mesh)
    assert rec["cost"]["flops"] > 0 and not moves, moves


def test_vlm_moves_no_activation_shard():
    # one weight's grad (the cross kv projection, whose input is split
    # along D over "model") is still moved; no activation is
    cfg = get_smoke_config("llama-3.2-vision-90b")
    rec, moves = _trace("llama-3.2-vision-90b", (1, 2))
    slab = SHAPE.global_batch * SHAPE.seq_len * cfg.d_model // 2
    big = [m for m in moves if math.prod(m) >= slab]
    assert rec["cost"]["flops"] > 0 and not big, moves


def test_dense_reduces_a_row_parallel_product_itself():
    # its partial sum comes out reduced, and the gradient passes back
    # replicated, whatever op meets the product next (before, the sum
    # stayed partial and each version reduced it where it chose)
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh, start_fake_group, stop_group
    from repro_torch.models.layers import dense, sharded_scope

    start_fake_group(2)
    try:
        mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
        x = distribute_tensor(torch.randn(2, 4, 8), mesh,
                              [Replicate(), Shard(2)]).requires_grad_()
        w = distribute_tensor(torch.randn(8, 6), mesh,
                              [Replicate(), Shard(0)]).requires_grad_()
        with sharded_scope(w):
            y = dense(w, x)
            g, = torch.autograd.grad(y.to_local().sum(), [x])
        assert tuple(y.placements) == (Replicate(), Replicate()), y.placements
        assert tuple(g.placements) == (Replicate(), Shard(2)), g.placements
    finally:
        stop_group()

