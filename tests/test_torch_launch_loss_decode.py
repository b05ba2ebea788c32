"""The port's sharded loss and decode step are partitioned as the
reference's are, on the CPU.

* The cross entropy on vocab-sharded logits is a vocab-parallel
  region.  The smoke cell ``lower_cell("qwen3-0.6b", "train_4k", ...,
  smoke=True, mesh_shape=(2, 2))`` all-gathers no tensor as large as a
  rank's logits over the whole vocab (before, ``torch.logsumexp`` on the
  DTensor gathered 536.9 MB of them), and the loss and grads on a (2, 2)
  and a (1, 4) gloo mesh equal the plain ones (loss 1e-5, grads 1e-4 of
  a leaf's max, fp32).
* A decode step against a length-sharded cache (the rules' split-KV
  fallback, where the kv heads do not divide "model") is a split-KV
  region.  qwen3's smoke ``decode_32k`` on a fake (1, 4) group gathers
  no cache (before, 1073.8 MB: the whole cache), and prefill plus
  greedy decode steps on a gloo mesh equal the plain ones within 1e-5
  in fp32, seven steps each: on (1, 4) for a full cache of 24 entries
  (a sliding-window model and an MoE model among them), and past the
  end of an 8-entry sliding-window ring (the window cut to 8 below the
  prompt's 16 tokens), so the new token's slot wraps from rank to rank;
  on (1, 8), where the 4 query heads do not divide "model" either, the
  prefill runs sequence-parallel before the split-KV steps, through a
  full cache of 24 entries and through the 8-entry ring (one slot a
  rank).
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch.dryrun import lower_cell

TIMEOUT = 240.0


def _largest_gather(rec) -> int:
    return max((c["numel"] for c in rec["largest_collectives"]
                if c["kind"] == "all-gather"), default=0)


def test_loss_gathers_no_vocab():
    rec = lower_cell("qwen3-0.6b", "train_4k", False, device="cpu",
                     smoke=True, mesh_shape=(2, 2))
    cfg, shape = get_smoke_config("qwen3-0.6b"), SHAPES["train_4k"]
    logits = shape.global_batch // 2 * shape.seq_len * cfg.vocab
    assert 0 < _largest_gather(rec) < logits / 2, rec["largest_collectives"]


CASES = {(2, 2): ["qwen3-0.6b"], (1, 4): ["qwen3-0.6b"]}


@pytest.fixture(scope="module")
def losses():
    out = {m: run_spmd(ranks.loss_and_grads, math.prod(m), archs, m, True,
                       timeout=TIMEOUT)[0] for m, archs in CASES.items()}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("mesh,arch", [
    (m, a) for m, archs in CASES.items() for a in archs])
def test_vocab_parallel_loss_equals_plain(arch, mesh, losses):
    r = losses[mesh][arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r


def test_decode_gathers_no_cache():
    rec = lower_cell("qwen3-0.6b", "decode_32k", False, device="cpu",
                     smoke=True, mesh_shape=(1, 4))
    cfg, shape = get_smoke_config("qwen3-0.6b"), SHAPES["decode_32k"]
    layer_cache = (shape.global_batch * shape.seq_len * cfg.n_kv_heads
                   * cfg.d_head)
    assert 0 < _largest_gather(rec) < layer_cache / 4, (
        rec["largest_collectives"])


RING = {"sliding_window": 8}
WRAP = [(f"{a}/ring8", a, RING) for a in ("h2o-danube-1.8b", "mixtral-8x7b")]
# (mesh, steps): decode entries and the cache length each must have
DECODES = {
    ((1, 4), 7): {"qwen3-0.6b": 24, "h2o-danube-1.8b": 24,
                  "mixtral-8x7b": 24, **{label: 8 for label, _, _ in WRAP}},
    ((1, 8), 7): {"qwen3-0.6b": 24, "h2o-danube-1.8b/ring8": 8},
}


def _entries(names):
    return [next((w for w in WRAP if w[0] == n), n) for n in names]


@pytest.fixture(scope="module")
def decodes():
    out = {key: run_spmd(ranks.decode_vs_plain, math.prod(key[0]),
                         _entries(want), key[0], key[1],
                         timeout=TIMEOUT)[0]
           for key, want in DECODES.items()}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("key,arch", [
    pytest.param(key, a, id=a if key[0] == (1, 4) else f"{a}-1x8")
    for key, want in DECODES.items() for a in want])
def test_split_kv_decode_equals_plain(key, arch, decodes):
    r = decodes[key][arch]
    # the cache's length (dim 2 of the stacked (L, B, len, G, hd)) is
    # split over "model": 2 kv heads do not divide 4 or 8; its batch,
    # split over a data axis of size 1, is whole there
    assert r["placements"][0] == "(Replicate(), Shard(dim=2))", r
    assert r["cache_len"] == DECODES[key][arch], r
    assert max(r["errs"]) <= 1e-5 * max(r["scale"], 1.0), r
