"""The models' sharding hooks, and the models on DTensor params, on the
CPU.

* ``moe_apply`` with block dispatch (``set_moe_block_dispatch(2, ...)``)
  and ``chunked_attention`` with the q-chunk alignment
  (``set_attention_sharding(None, nq)``) against the JAX package's with
  the same registrations, in fp32 within 1e-5; the batched q-chunk path
  (a registered placement) against JAX's vmapped one.
* ``constrain_acts`` is the identity without a registration.
* Every smoke model's loss and grads on DTensor params over a (2, 2)
  mesh equal the plain ones in fp32 (loss within 1e-5, grads within
  1e-4 of each leaf's max), and three Trainer steps on a (1, 1) mesh
  are bitwise equal to the plain Trainer's.  The meshes are gloo groups
  of CPU rank processes (a fake group moves no data, so a value check
  needs real collectives); before the models ran under
  ``sharded_scope`` with JAX's masked label sum and the head-parallel
  regions, this failed for every model (DTensor refused the fresh
  tensors beside the params, the vocab-sharded label gather and the
  MoE's in-place ``index_add_``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro.compat import AxisType, make_mesh as jax_make_mesh
from repro.configs import ARCH_NAMES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

TIMEOUT = 240.0


@pytest.fixture
def no_hooks():
    yield
    for mod in (jlayers, tlayers):
        mod.set_activation_sharding(None)
        mod.set_attention_sharding(None, None)
    for mod in (jmoe, tmoe):
        mod.set_moe_block_dispatch(None, None)
        mod.set_moe_shard_map(None, None)


def _moe_case(seed=0, B=4, S=8):
    cfg = jax_smoke_config("mixtral-8x7b")
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("nb", [2, 4])
def test_moe_block_dispatch_matches_jax(nb, no_hooks):
    cfg, jp, x = _moe_case()
    jmoe.set_moe_block_dispatch(nb, None)
    tmoe.set_moe_block_dispatch(nb, None)
    jy, jaux = jmoe.moe_apply(jp, cfg, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ty, taux = tmoe.moe_apply(tp, get_smoke_config("mixtral-8x7b"),
                              torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-5


def _attn_case(B=2, S=96, H=4, G=2, Dh=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, G, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, G, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("nq,window", [(4, None), (3, None), (4, 40), (6, None)])
def test_chunked_attention_alignment_matches_jax(nq, window, no_hooks):
    q, k, v = _attn_case()
    jlayers.set_attention_sharding(None, nq)
    tlayers.set_attention_sharding(None, nq)
    kw = dict(causal=True, window=window, q_chunk=32, kv_chunk=32)
    jo = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    to = tlayers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    # the alignment changed the chunking: Sq / nq rows per q chunk
    tlayers.set_attention_sharding(None, None)
    ref = tlayers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw)
    np.testing.assert_allclose(to.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_batched_q_chunks_match_jax_vmap(no_hooks):
    """The batched q-chunk path (a registered q-chunk placement) against
    JAX's vmapped one on a one-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    q, k, v = _attn_case()
    jmesh = jax_make_mesh((1,), ("model",), axis_types=(AxisType.Auto,))
    jlayers.set_attention_sharding(NamedSharding(jmesh, P()), 4)
    tlayers.set_attention_sharding(("any mesh", ()), 4)
    kw = dict(causal=True, q_chunk=32, kv_chunk=32)
    with jmesh:
        jo = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw)
    to = tlayers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)


def test_constrain_acts_is_the_identity_without_a_registration(no_hooks):
    x = torch.randn(2, 3, 4)
    assert tlayers.constrain_acts(x) is x
    tlayers.set_activation_sharding(("mesh", ()))
    assert tlayers.constrain_acts(x) is x          # a plain tensor


def test_constrain_acts_on_a_dtensor(no_hooks):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh, start_fake_group, stop_group

    start_fake_group(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        x = distribute_tensor(torch.randn(2, 3, 4), mesh,
                              [Replicate(), Replicate()])
        assert tlayers.constrain_acts(x) is x
        tlayers.set_activation_sharding((mesh, (Shard(0), Replicate())))
        y = tlayers.constrain_acts(x)
        assert y.placements == (Shard(0), Replicate())
        assert torch.equal(y.full_tensor(), x.full_tensor())
    finally:
        stop_group()


@pytest.fixture(scope="module")
def sharded_22():
    out = run_spmd(ranks.loss_and_grads, 4, list(ARCH_NAMES), (2, 2), True,
                   timeout=TIMEOUT)[0]
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_model_loss_on_dtensor_params_equals_plain(arch, sharded_22):
    r = sharded_22[arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r


@pytest.fixture(scope="module")
def steps_11():
    out = run_spmd(ranks.trainer_steps_one_rank, 1, list(ARCH_NAMES),
                   timeout=TIMEOUT)[0]
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_trainer_steps_on_a_one_rank_mesh_are_bitwise(arch, steps_11):
    r = steps_11[arch]
    assert all(a == b for a, b in r["losses"]), r["losses"]
    assert r["leaves"] > 0 and r["differ"] == 0, r
