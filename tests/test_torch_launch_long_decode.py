"""The port's decode step takes a length-split cache in its own
placements at one sequence (``long_500k``), on the CPU.

The rules split a ``long_500k`` cache (B = 1) by its length over the
data axes, and its kv heads over "model" where they divide it, else its
head_dim.  The split-KV decode region takes those placements as they
are: q, k and v enter split as the cache's heads are, each rank takes
its slice of head_dim, writes the new token where its slice of the
length holds the slot, and the partial attentions merge over the
length's mesh dims, the scores over head_dim's where it is split (a
partial dot product).

* The smoke ``long_500k`` cells of h2o-danube, mixtral and zamba2 trace
  on a fake (2, 2) group (kv heads over "model") and h2o's and
  mixtral's on a fake (2, 4) one (2 kv heads do not divide 4: head_dim
  over "model"), and gather no cache.  Before, the region failed: it
  took q, k and v with batch-only placements and wrote them into a
  cache slice split on heads or head_dim.
* A prefill of one sequence and seven greedy decode steps on a (2, 2)
  and a (2, 4) gloo mesh equal the plain ones within 1e-5 in fp32,
  through a full cache of 24 entries and past the end of an 8-entry
  sliding-window ring (the new token's slot wrapping from rank to rank).
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import lower_cell

TIMEOUT = 240.0
CELLS = [("h2o-danube-1.8b", (2, 2)), ("mixtral-8x7b", (2, 2)),
         ("zamba2-2.7b", (2, 2)), ("h2o-danube-1.8b", (2, 4)),
         ("mixtral-8x7b", (2, 4))]


def _cache_gathers(rec, cfg, n_model: int) -> list:
    """The record's all-gathers shaped like a cache slice: trailing dims
    (kv heads, head_dim), either of them a rank's share or whole."""
    G, hd = cfg.n_kv_heads, cfg.d_head
    kv = {(G, hd), (G // n_model, hd), (G, hd // n_model)}
    return [c for c in rec["largest_collectives"]
            if c["kind"] == "all-gather" and len(c["shape"]) >= 4
            and tuple(c["shape"][-2:]) in kv]


@pytest.mark.parametrize("arch,mesh", CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in CELLS])
def test_long_decode_traces_and_gathers_no_cache(arch, mesh):
    rec = lower_cell(arch, "long_500k", False, device="cpu", smoke=True,
                     mesh_shape=mesh)
    assert rec["cost"]["flops"] > 0, rec
    assert not _cache_gathers(rec, get_smoke_config(arch), mesh[1]), (
        rec["largest_collectives"])


RING = ("h2o-danube-1.8b/ring8", "h2o-danube-1.8b", {"sliding_window": 8})
ENTRIES = ["h2o-danube-1.8b", "mixtral-8x7b", RING]
# the stacked cache (layers, B, length, kv heads, head_dim): length over
# "data", kv heads (2 over 2) or head_dim (2 kv heads over 4) over "model"
MESHES = {(2, 2): "(Shard(dim=2), Shard(dim=3))",
          (2, 4): "(Shard(dim=2), Shard(dim=4))"}


@pytest.fixture(scope="module")
def decodes():
    out = {m: run_spmd(ranks.decode_vs_plain, math.prod(m), ENTRIES, m, 7, 1,
                       timeout=TIMEOUT)[0] for m in MESHES}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("mesh", list(MESHES),
                         ids=[f"{m[0]}x{m[1]}" for m in MESHES])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mixtral-8x7b",
                                  RING[0]])
def test_one_sequence_decode_equals_plain(arch, mesh, decodes):
    r = decodes[mesh][arch]
    assert r["placements"][0] == MESHES[mesh], r
    assert len(r["errs"]) == 8, r
    assert max(r["errs"]) <= 1e-5 * max(r["scale"], 1.0), r
