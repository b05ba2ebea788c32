"""The port's enc-dec family keeps its caches and its attention work
split as the reference does, on the CPU.

whisper's 6 heads (the smoke config's 4) and 1500 frames (here 20) do
not divide "model" (8 here).

* A prefill writes the prompt into a cache whose length is split over
  "model" in the cache's own placements, each rank the entries of its
  slice.  whisper's smoke ``prefill_32k`` on a fake (1, 8) group
  gathers nothing as large as one layer's slice of that cache (before:
  each layer gathered its cache's whole length on every rank).
* A decode step attends the cross-attention cache, whose head_dim is
  split over "model", by partial dot products summed over "model"; the
  smoke ``decode_32k`` gathers no cross-attention KV.
* The encoder's attention, whose heads and frames both do not divide
  "model", splits the query rows into uneven chunks (the last one
  empty at 20 frames over 8), each rank attending its own.  Loss and
  grads on a (1, 8) gloo mesh equal the plain ones (loss 1e-5, grads
  1e-4 of a leaf's max, fp32) at 20 and 22 frames, and a prefill and
  seven greedy decode steps equal the plain ones within 1e-5.
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch.dryrun import lower_cell

TIMEOUT = 240.0
MESH = (1, 8)
FRAMES = {"n_frames": 20}


def _gathers(rec) -> list:
    return [c for c in rec["largest_collectives"] if c["kind"] == "all-gather"]


def test_prefill_gathers_no_cache_slice():
    rec = lower_cell("whisper-tiny", "prefill_32k", False, device="cpu",
                     smoke=True, mesh_shape=MESH, overrides=FRAMES)
    cfg, shape = get_smoke_config("whisper-tiny"), SHAPES["prefill_32k"]
    # one layer's self-attention cache on a rank: its length over "model"
    slice_ = (shape.global_batch * shape.seq_len * cfg.n_kv_heads
              * cfg.d_head // MESH[1])
    assert 0 < max(c["numel"] for c in _gathers(rec)) < slice_, (
        rec["largest_collectives"])


def test_decode_gathers_no_cross_attention_kv():
    rec = lower_cell("whisper-tiny", "decode_32k", False, device="cpu",
                     smoke=True, mesh_shape=MESH, overrides=FRAMES)
    cfg = get_smoke_config("whisper-tiny")
    # a gathered (..., frames, kv heads, head_dim) cross-attention KV, its
    # head_dim whole or a rank's share
    G, hd = cfg.n_kv_heads, cfg.d_head
    kv = {(FRAMES["n_frames"], G, d) for d in (hd, hd // MESH[1])}
    assert rec["cost"]["flops"] > 0, rec
    assert not [c for c in _gathers(rec) if len(c["shape"]) >= 4
                and tuple(c["shape"][-3:]) in kv], rec["largest_collectives"]


ENTRIES = [(f"whisper-tiny/F={f}", "whisper-tiny", {"n_frames": f})
           for f in (20, 22)]


@pytest.fixture(scope="module")
def runs():
    out = {"loss": run_spmd(ranks.loss_and_grads, math.prod(MESH), ENTRIES,
                            MESH, True, timeout=TIMEOUT)[0],
           "decode": run_spmd(ranks.decode_vs_plain, math.prod(MESH),
                              ENTRIES, MESH, 7, timeout=TIMEOUT)[0]}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("arch", [e[0] for e in ENTRIES])
def test_uneven_encoder_rows_loss_equals_plain(arch, runs):
    r = runs["loss"][arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r


@pytest.mark.parametrize("arch", [e[0] for e in ENTRIES])
def test_prefill_and_decode_equal_plain(arch, runs):
    r = runs["decode"][arch]
    assert len(r["errs"]) == 8, r
    assert max(r["errs"]) <= 1e-5 * max(r["scale"], 1.0), r
