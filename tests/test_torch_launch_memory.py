"""The dry run's memory: what its live-storage peak counts, and the
models' scans holding one new cache.

``CostMode`` counts every storage an op of the run allocates until it is
freed.  A collective's ``wait_tensor`` returns its input's storage on
real tensors, but its meta kernel allocates another on fake ones, so
the dry run used to count every waited collective twice (zamba2
``prefill_32k`` on (16, 16): 0.25 GB of its temp).  A scan over layers
with a cache used to keep each layer's new cache in a list and stack
the list at the end, holding two new caches (every ``decode_32k``
cell's temp was twice its cache).  Now the waited result shares its
input's entry, and the scan writes each layer's cache into one stacked
tree as it comes (``transformer.CacheStack``), keeping a DTensor
cache's placements.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import op_analysis
from repro_torch.launch.op_analysis import CostMode
from repro_torch.models.api import build_model
from repro_torch.models.transformer import tree_leaves, tree_map

from _torch_launch_ranks import functional_storages
from _torch_spmd import run_spmd, spmd_processes


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_fake_group, stop_group

    start_fake_group(4)
    try:
        yield dist.group.WORLD.group_name
    finally:
        stop_group()


# ---------------------------------------------------------------- C9

def test_a_waited_result_shares_its_inputs_storage_on_a_real_group():
    """The fact the count relies on, on a one-rank gloo group: a
    collective makes a new storage (an in-place one writes its input),
    and ``wait_tensor`` hands that storage back; the ops that
    ``CostMode`` takes as returning their input are those."""
    out = run_spmd(functional_storages, 1, timeout=60.0)[0]
    assert not spmd_processes()
    assert out.pop("wait_tensor") == [True] * 6
    assert out == {"all_reduce": False, "all_gather_into_tensor": False,
                   "reduce_scatter_tensor": False,
                   "all_to_all_single": False, "broadcast": False,
                   "all_reduce_": True}
    assert op_analysis._RETURNS_INPUT == {("_c10d_functional",
                                           "wait_tensor")}


def test_a_waited_all_reduce_counts_its_result_once(fake_group):
    ops = torch.ops._c10d_functional
    fake = _fake()
    with fake:
        x = torch.empty(256, 1024)
    mode = CostMode(fake)
    with fake, mode:
        r = ops.all_reduce(x, "sum", fake_group)
        w = ops.wait_tensor(r)
        kept = (r, w)
    n = 256 * 1024 * 4
    assert mode.peak_bytes == n
    assert mode.cost.collectives["all-reduce"] == n
    del kept, r, w
    assert mode.live_bytes == 0


def test_an_in_place_all_reduce_allocates_nothing(fake_group):
    """A row-parallel product reduced in place (``layers._Reduced``):
    counted as the same all-reduce, with no new storage."""
    ops = torch.ops._c10d_functional
    fake = _fake()
    with fake:
        x = torch.empty(256, 1024)
    mode = CostMode(fake)
    with fake, mode:
        w = ops.wait_tensor(ops.all_reduce_(x, "sum", fake_group))
    assert mode.peak_bytes == 0
    assert mode.cost.collectives["all-reduce"] == 256 * 1024 * 4
    assert w.shape == x.shape


# --------------------------------------------------------------- C10

def _fake_model(arch, overrides, fake):
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    model = build_model(cfg)
    shapes = model.init_params(None, device="meta")
    with fake:
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                          shapes)
    return cfg, model, params


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


# (arch, config fields, batch, prompt, cache length): caches that
# dominate the step's other tensors; several layers (qwen3) or groups
# (zamba2: 24 layers = 4 groups of 5 Mamba-2 layers and the shared block)
SCANS = [
    ("qwen3-0.6b", {"n_layers": 6}, 2, 1, 4096),
    ("zamba2-2.7b", {"n_layers": 24}, 2, 16, 8192),
]


@pytest.mark.parametrize("arch,over,B,S,L", SCANS,
                         ids=[s[0] for s in SCANS])
def test_a_scan_with_a_cache_holds_one_new_cache(arch, over, B, S, L):
    """One step peaks at its stacked new cache plus one layer's (the
    layer's own, then copied into its slice), with the step's other
    tensors under one more layer's bytes; a list of the layers' caches
    beside their stack would hold two new caches."""
    fake = _fake()
    cfg, model, params = _fake_model(arch, over, fake)
    with fake:
        cache = model.init_cache(B, L, device="cpu")
        tokens = torch.zeros((B, S), dtype=torch.int32)
    n = len(tree_leaves(cache)[0])
    size = _nbytes(cache)
    layer = size / n
    mode = CostMode(fake)
    with fake, mode:
        if S == 1:
            _, new = model.decode_step(params, tokens, 7, cache)
        else:
            _, new = model.prefill(params, {"tokens": tokens}, cache)
    assert _nbytes(new) == size
    assert size <= mode.peak_bytes <= size + 2 * layer, (
        mode.peak_bytes / layer, n)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_a_dtensor_cache_keeps_its_placements(fake_group, mesh):
    """qwen3's smoke decode on a fake group: the new cache has the
    sharding rules' placements, the kv heads split over "model" on (2,
    2) and the cache length on (1, 4) (split-KV)."""
    from repro_torch.configs import input_specs
    from repro_torch.launch.dryrun import _stand_ins, clear_hooks, register_hooks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import cache_specs, param_specs

    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    shape = ShapeSpec("decode_s", 64, 4, "decode")
    dmesh = make_mesh(mesh, ("data", "model"), device_type="cpu")
    fake = _fake()
    register_hooks(dmesh, shape)
    try:
        pshapes = model.init_params(None, device="meta")
        cshapes = model.init_cache(shape.global_batch, shape.seq_len,
                                   device="meta")
        with fake:
            params = _stand_ins(pshapes, dmesh,
                                param_specs(cfg, pshapes, dmesh), "cpu")
            cache = _stand_ins(cshapes, dmesh,
                               cache_specs(cfg, shape, cshapes, dmesh), "cpu")
            token = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
            _, new = model.decode_step(params, token, 3, cache)
    finally:
        clear_hooks()
    old, got = tree_leaves(cache), tree_leaves(new)
    assert [tuple(t.placements) for t in got] == [tuple(t.placements)
                                                 for t in old]
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in old]
    split = {"k": 3 if mesh == (2, 2) else 2}
    assert any(q.is_shard(split["k"]) for q in got[0].placements)
