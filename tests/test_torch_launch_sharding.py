"""The port's launch-layer specs vs the JAX package's, on the CPU.

``repro_torch.configs.input_specs`` against ``repro.configs.input_specs``
(names, shapes, dtypes) for every config x ``SHAPES`` entry; the port's
``param_specs`` / ``opt_specs`` / ``batch_specs`` / ``cache_specs``
against JAX's, entry for entry, for all ten *full* configs on the
(16, 16) and (2, 16, 16) production meshes — shape trees only
(``jax.eval_shape`` on the JAX side, meta tensors on the port's), both
given the same stand-in mesh with ``.shape``/``.axis_names``; and
``to_placements`` on a fake process group of 256 ranks: DTensor's shard
shape of every qwen3-0.6b leaf is what JAX's spec arithmetic gives
(``NamedSharding(AbstractMesh, spec).shard_shape``).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from repro.configs import ARCH_NAMES, SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.launch import sharding as jsh
from repro.models.api import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch import sharding as tsh
from repro_torch.models.api import build_model

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {torch.int32: np.int32, torch.bfloat16: jax.numpy.bfloat16,
           torch.float32: np.float32}


class StandInMesh:
    """A mesh with only ``.shape`` (axis -> size) and ``.axis_names``, as
    both packages' rules read it."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


def _jax_flat(tree):
    """JAX spec leaves in ``jax.tree.leaves`` order (sorted dict keys)."""
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, JaxP))]


def _port_flat(tree):
    """The port's spec leaves in the same order (sorted paths)."""
    out = []
    tsh.map_with_path(lambda p, s: out.append((p, tuple(s))), tree)
    return [s for _, s in sorted(out)]


@pytest.fixture(scope="module")
def shape_trees():
    """(JAX eval_shape params, port meta params) per full config."""
    out = {}
    for a in ARCH_NAMES:
        jm = jax_build_model(jax_get_config(a))
        out[a] = (jm, jax.eval_shape(lambda: jm.init_params(
                      jax.random.PRNGKey(0))),
                  build_model(get_config(a)),
                  build_model(get_config(a)).init_params(None, device="meta"))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_jax(arch):
    for name, shape in SHAPES.items():
        j = jax_input_specs(jax_get_config(arch), JAX_SHAPES[name])
        t = input_specs(get_config(arch), shape)
        assert list(j) == list(t), (arch, name)
        for k in j:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == j[k].shape, (arch, name, k)
            assert np.dtype(_DTYPES[t[k].dtype]) == np.dtype(j[k].dtype)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_jax_on_production_meshes(arch, mesh_name, shape_trees):
    mesh = StandInMesh(*MESHES[mesh_name])
    jm, jps, tm, tps = shape_trees[arch]
    jcfg, tcfg = jax_get_config(arch), get_config(arch)

    jp = jsh.param_specs(jcfg, jps, mesh)
    tp = tsh.param_specs(tcfg, tps, mesh)
    assert _port_flat(tp) == _jax_flat(jp)
    # leaf for leaf in JAX's order, with the shapes the rules saw
    assert [tuple(x.shape) for x in jax.tree.leaves(jps)] == [
        tuple(x.shape) for _, x in sorted(
            (p, x) for p, x in _paths(tps))]

    jo = jsh.opt_specs(jp)
    to = tsh.opt_specs(tp)
    assert tuple(to.step) == tuple(jo.step) == ()
    assert _port_flat(to.mu) == _jax_flat(jo.mu)
    assert _port_flat(to.nu) == _jax_flat(jo.nu)
    # the state the specs describe: JAX's AdamW state shapes
    jst = jax.eval_shape(JaxAdamW().init, jps)
    assert len(jax.tree.leaves(jst.mu)) == len(_port_flat(to.mu))

    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        jb = jsh.batch_specs(jcfg, jshape, jax_input_specs(jcfg, jshape), mesh)
        tb = tsh.batch_specs(tcfg, shape, input_specs(tcfg, shape), mesh)
        assert _port_flat(tb) == _jax_flat(jb), (arch, name)
        if shape.kind == "train":
            continue
        jc = jsh.cache_specs(jcfg, jshape, jax.eval_shape(
            lambda: jm.init_cache(shape.global_batch, shape.seq_len)), mesh)
        tc = tsh.cache_specs(tcfg, shape, tm.init_cache(
            shape.global_batch, shape.seq_len, device="meta"), mesh)
        assert _port_flat(tc) == _jax_flat(jc), (arch, name)


def _paths(tree):
    out = []
    tsh.map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def test_partition_spec_entries_compare_equal_to_jax():
    assert tsh.PartitionSpec(("data",), None) == JaxP(("data",), None)
    assert tuple(tsh.PartitionSpec(("pod", "data"), "model")) == tuple(
        JaxP(("pod", "data"), "model"))
    assert tsh.PartitionSpec() == ()


def test_to_placements_shard_shapes_match_jax_on_a_fake_group():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import (
        make_production_mesh, start_fake_group, stop_group)

    start_fake_group(256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        assert mesh.shape == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
        jmesh = AbstractMesh((16, 16), ("data", "model"))
        cfg = get_config("qwen3-0.6b")
        params = build_model(cfg).init_params(None, device="meta")
        specs = tsh.param_specs(cfg, params, mesh)
        flat = dict(_paths(specs))
        checked = 0
        for path, leaf in _paths(params):
            spec = flat[path]
            pl = tsh.to_placements(mesh, spec)
            want = JaxNamedSharding(jmesh, JaxP(*spec)).shard_shape(
                tuple(leaf.shape))
            assert tsh.local_shape(mesh, spec, leaf.shape) == want, path
            d = DTensor.from_local(torch.empty(want, device="meta"), mesh,
                                   pl, run_check=False)
            assert tuple(d.shape) == tuple(leaf.shape), path
            assert tuple(d.to_local().shape) == want
            checked += 1
        assert checked == len(_paths(params))
        # a tuple entry shards its dim over both mesh dims, in mesh order
        assert tsh.to_placements(mesh, tsh.PartitionSpec(
            ("data", "model"), None)) == (Shard(0), Shard(0))
        assert tsh.to_placements(mesh, tsh.PartitionSpec()) == (
            Replicate(), Replicate())
        with pytest.raises(ValueError):
            tsh.to_placements(mesh, tsh.PartitionSpec(("model", "data")))
    finally:
        stop_group()


def test_production_mesh_needs_its_world_size():
    from repro_torch.launch.mesh import (
        make_production_mesh, start_fake_group, stop_group)

    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh(device_type="cpu")
    start_fake_group(4)
    try:
        with pytest.raises(RuntimeError, match="world size 256"):
            make_production_mesh(device_type="cpu")
    finally:
        stop_group()
