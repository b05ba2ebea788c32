"""The port's Mamba-2 decode step keeps its state where the rules place
it, and a decode step reads a vocab that does not divide "model" where
it lies, on the CPU.

* The rules split the SSM state's heads over "model", or its head_dim
  where the heads do not divide it, and the conv state's channels.  The
  decode step is one region from the in-projection to the
  out-projection in those placements: each rank steps its conv
  channels and its heads, and only the few rows' activations move.
  mamba2's and zamba2's smoke ``decode_32k`` cells on a fake (2, 2)
  group (8 heads over "model") and mamba2's with 2 heads of 64 on a
  fake (2, 4) one (head_dim over "model") all-gather no state.  Before,
  every layer gathered its SSM state over "model" and stepped every
  head on every rank.
* Where the vocab does not divide "model" the rules split the table's
  ``D`` side over "data" only.  At inference a few tokens go to the
  table: the lookup takes each rank's slice of ``D``, and the head
  (tied or not) is a vocab-parallel product over uneven vocab chunks.
  mamba2's (tied) and whisper's (untied) smoke ``decode_32k`` with a
  250-entry vocab on a fake (2, 4) group gather no table.  Before, each
  step gathered the whole table in fp32.  Which read a step takes
  follows autograd, not grad mode: under grad mode a read no autograd
  records moves the tokens, one it records takes the ZeRO-3 gather.
* Prefill and seven greedy decode steps of mamba2 on gloo meshes equal
  the plain ones within 1e-5 in fp32: heads over "model" on (2, 2) with
  four sequences (split over "data") and with one, head_dim over
  "model" on (2, 4), and the 250-entry vocab, tied (mamba2, qwen3) and
  untied (whisper), on (2, 4).
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import lower_cell

TIMEOUT = 240.0
WIDE = {"ssm_head_dim": 64}          # 2 heads: head_dim over "model" on 4
RAGGED = {"vocab": 250}
STATE_CELLS = [("mamba2-130m", (2, 2), None), ("zamba2-2.7b", (2, 2), None),
               ("mamba2-130m", (2, 4), WIDE)]


def _gathers(rec) -> list:
    return [c for c in rec["largest_collectives"] if c["kind"] == "all-gather"]


@pytest.mark.parametrize("arch,mesh,ov", STATE_CELLS,
                         ids=["mamba2-2x2", "zamba2-2x2", "mamba2-wide-2x4"])
def test_ssm_decode_gathers_no_state(arch, mesh, ov):
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch), **(ov or {}))
    rec = lower_cell(arch, "decode_32k", False, device="cpu", smoke=True,
                     mesh_shape=mesh, overrides=ov)
    n = mesh[1]
    P, N, C = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner + 2 * cfg.ssm_state
    # an SSM state's (head_dim, state) or a conv state's (width - 1,
    # channels), whole or a rank's share
    states = {(P, N), (P // n, N), (cfg.conv_width - 1, C),
              (cfg.conv_width - 1, C // n)}
    assert rec["cost"]["flops"] > 0, rec
    assert not [c for c in _gathers(rec) if len(c["shape"]) >= 3
                and tuple(c["shape"][-2:]) in states], (
        rec["largest_collectives"])


@pytest.mark.parametrize("arch,ov", [("mamba2-130m", RAGGED),
                                     ("whisper-tiny", {**RAGGED,
                                                       "n_frames": 20})],
                         ids=["mamba2-tied", "whisper-untied"])
def test_decode_gathers_no_table_of_a_ragged_vocab(arch, ov):
    rec = lower_cell(arch, "decode_32k", False, device="cpu", smoke=True,
                     mesh_shape=(2, 4), overrides=ov)
    V = ov["vocab"]
    assert rec["cost"]["flops"] > 0, rec
    # a gathered (V, D) table: its vocab rows stacked over the ranks
    assert not [c for c in _gathers(rec) if len(c["shape"]) == 2
                and c["shape"][0] % V == 0], rec["largest_collectives"]


@pytest.mark.parametrize("tracked", [False, True],
                         ids=["serving", "autograd-records"])
def test_table_path_follows_autograd_not_grad_mode(tracked):
    """Under grad mode a few tokens read a table split on ``D`` only where
    no autograd records the read (a server's params track no gradient):
    there they move to the table; a read that autograd records (training)
    takes the ZeRO-3 gather, whose tied gradients C6 holds."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh, start_fake_group
    from repro_torch.models.transformer import _moves_tokens

    start_fake_group(8)
    try:
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        with FakeTensorMode(), torch.enable_grad():
            table = DTensor.from_local(torch.empty(250, 32), mesh,
                                       (Shard(1), Replicate()),
                                       run_check=False)
            tokens = DTensor.from_local(torch.zeros(4, 1, dtype=torch.int32),
                                        mesh, (Shard(0), Replicate()),
                                        run_check=False)
            table.requires_grad_(tracked)
            moves = _moves_tokens(table, tokens, 1, False, tokens.placements)
    finally:
        dist.destroy_process_group()
    assert moves is not tracked


# (mesh, sequences): entries
DECODES = {
    ((2, 2), 4): ["mamba2-130m"],
    ((2, 2), 1): ["mamba2-130m"],
    ((2, 4), 4): [("mamba2-130m/wide", "mamba2-130m", WIDE),
                  ("mamba2-130m/V=250", "mamba2-130m", RAGGED),
                  ("qwen3-0.6b/V=250", "qwen3-0.6b", RAGGED),
                  ("whisper-tiny/V=250", "whisper-tiny",
                   {**RAGGED, "n_frames": 20})],
}


@pytest.fixture(scope="module")
def decodes():
    out = {key: run_spmd(ranks.decode_vs_plain, math.prod(key[0]), want,
                         key[0], 7, key[1], timeout=TIMEOUT)[0]
           for key, want in DECODES.items()}
    assert not spmd_processes()
    return out


def _label(entry) -> str:
    return entry if isinstance(entry, str) else entry[0]


@pytest.mark.parametrize("key,arch", [
    pytest.param(key, _label(e), id=f"{_label(e)}-{key[0][0]}x{key[0][1]}"
                 f"-B{key[1]}")
    for key, want in DECODES.items() for e in want])
def test_decode_equals_plain(key, arch, decodes):
    r = decodes[key][arch]
    assert len(r["errs"]) == 8, r
    assert max(r["errs"]) <= 1e-5 * max(r["scale"], 1.0), r
