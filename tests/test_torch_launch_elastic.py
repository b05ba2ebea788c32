"""Elastic restart of the LM stack's state, on the CPU: the port of
``tests/test_elastic.py``.

qwen3's smoke params are placed by ``replan`` on a (4, 2) mesh of eight
gloo CPU rank processes, gathered and saved with the port's
``CheckpointManager``; a fresh (2, 1) group of two ranks restores them,
``reshard_restored`` places them on a ``replan`` of the new mesh, and
every leaf is bitwise equal to the saved one.  The resharded forward is
within the JAX test's 5e-2 (bf16 compute, other reduction orders) of
the unsharded forward and of the JAX package's logits from the same
weights carried across.

The shard_map MoE (``_moe_shard_map_apply``: tokens over "data", d_ff
over "model", one sum over "model", the aux loss averaged) runs on a
(2, 2) gloo mesh and is held against the JAX package's ``shard_map``
in a 4-device JAX subprocess (``tests/_subproc.py``), within 1e-5 of
the output's max (observed 1.4e-7): both cast the expert weights to
bf16 and compute in the tokens' fp32.  Every wait has a deadline, and no rank
process outlives its call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subproc import run_fake_device_subprocess
from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro_torch.models.convert import params_to_numpy
from repro_torch.models.transformer import tree_leaves

TIMEOUT = 180.0
TOL = 5e-2        # tests/test_elastic.py


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic_ckpt"))
    saved = run_spmd(ranks.elastic_save, 8, d, timeout=TIMEOUT)[0]
    assert not spmd_processes()
    tokens = np.random.default_rng(7).integers(
        0, 256, (2, 8)).astype(np.int32)
    restored = run_spmd(ranks.elastic_restore, 2, d, tokens,
                        timeout=TIMEOUT)[0]
    assert not spmd_processes()
    return saved, restored, tokens


def test_restore_onto_a_smaller_mesh_is_bitwise(elastic):
    saved, restored, _ = elastic
    model, params, _ = ranks.smoke_case("qwen3-0.6b")
    want = [t.numpy() for t in tree_leaves(params)]
    assert restored["mesh"] == [4, 2]
    assert len(saved) == len(restored["leaves"]) == len(want)
    for a, b, c in zip(want, saved, restored["leaves"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # the (2, 1) plan shards the batch-free params over "data" alone
    assert any("Shard" in p for p in restored["placements"])


def test_resharded_forward_matches_unsharded_and_jax(elastic):
    _, restored, tokens = elastic
    model, params, _ = ranks.smoke_case("qwen3-0.6b")
    with torch.no_grad():
        ref, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    ref = ref.float().numpy()
    got = restored["logits"]
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale

    jm = jax_build_model(jax_smoke_config("qwen3-0.6b"))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    jl = np.asarray(jl, np.float32)
    assert np.abs(got - jl).max() <= TOL * np.abs(jl).max()


_JAX_MOE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.configs import get_smoke_config
from repro.models import moe
cfg = get_smoke_config("mixtral-8x7b")
d = np.load(PATH)
p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
moe.set_moe_shard_map(mesh, "data")
with mesh:
    y, aux = jax.jit(lambda p, x: moe._moe_shard_map_apply(p, cfg, x))(
        p, jnp.asarray(d["x"]))
np.savez(OUT, y=np.asarray(y, np.float32), aux=np.asarray(aux, np.float32))
print("MOE_OK")
"""


def test_moe_shard_map_matches_jax_shard_map(tmp_path):
    cfg = jax_smoke_config("mixtral-8x7b")
    from repro.models import moe as jmoe

    jp = jmoe.moe_init(jax.random.PRNGKey(3), cfg)
    p = {k: np.array(v, np.float32) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    path, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(path, x=x, **p)
    run_fake_device_subprocess(
        _JAX_MOE.replace("PATH", repr(path)).replace("OUT", repr(out)),
        "MOE_OK", n_devices=4, timeout=600)
    ref = np.load(out)
    y, aux = run_spmd(ranks.moe_shard_map, 4, p, x, timeout=TIMEOUT)[0]
    assert not spmd_processes()
    err = np.abs(y - ref["y"]).max() / np.abs(ref["y"]).max()
    print(f"shard_map MoE vs JAX: y {err:.3e} of max, aux {aux} vs "
          f"{float(ref['aux'])}")
    assert y.shape == x.shape and err <= 1e-5
    assert abs(aux - float(ref["aux"])) <= 1e-5 * abs(float(ref["aux"]))
