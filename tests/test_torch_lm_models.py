"""The port's LM stack against the JAX package: configs, the dense and
MoE families end to end, the params' layout and conversion, and caches.

Each smoke model starts from JAX ``init_params(PRNGKey(0))`` carried
across by ``params_from_numpy``; forward, prefill and one decode step
are held to 5e-2 relative to the max |logit| (``tests/test_models.py:73``,
the JAX package's own bf16 tolerance).  The SSM, hybrid, VLM and
enc-dec families are in ``tests/test_torch_lm_families.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from _torch_lm_case import (check_fp32_forward, check_smoke_model,
                            make_batches, models)
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy


@pytest.mark.parametrize("arch", ["minitron-4b", "phi3-medium-14b",
                                  "h2o-danube-1.8b", "qwen3-0.6b",
                                  "mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_dense_and_moe_smoke_models_match_jax(arch):
    check_smoke_model(arch)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_moe_stack_in_fp32_matches_jax(arch, monkeypatch):
    check_fp32_forward(arch, monkeypatch)


def test_configs_are_the_jax_configs():
    assert tcfgs.ARCH_NAMES == jcfgs.ARCH_NAMES
    for name in jcfgs.ARCH_NAMES:
        for get_t, get_j in ((tcfgs.get_config, jcfgs.get_config),
                             (tcfgs.get_smoke_config, jcfgs.get_smoke_config)):
            t, j = get_t(name), get_j(name)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert (t.d_inner, t.ssm_heads, t.attention_free, t.sub_quadratic) \
                == (j.d_inner, j.ssm_heads, j.attention_free, j.sub_quadratic)
            for shape in jcfgs.SHAPES:
                assert tcfgs.cell_supported(t, tcfgs.SHAPES[shape]) \
                    == jcfgs.cell_supported(j, jcfgs.SHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}
    with pytest.raises(KeyError) as te:
        tcfgs.get_config("gpt-5")
    with pytest.raises(KeyError) as je:
        jcfgs.get_config("gpt-5")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_param_counts_equal_for_full_configs(name):
    t, j = tcfgs.get_config(name), jcfgs.get_config(name)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_port_init_has_the_jax_layout():
    """Every family's own ``init_params`` gives JAX's keys, shapes and
    fp32, on the device asked for."""
    from repro.models.api import build_model as jax_build_model

    for name in jcfgs.ARCH_NAMES:
        jshapes = jax.eval_shape(jax_build_model(jcfgs.get_smoke_config(name))
                                 .init_params, jax.random.PRNGKey(0))
        tp = build_model(tcfgs.get_smoke_config(name)).init_params(
            torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.structure(tp) == jax.tree.structure(jshapes), name
        for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jshapes)):
            assert tuple(t.shape) == j.shape and t.dtype == torch.float32
            assert t.device.type == "cpu" and torch.isfinite(t).all()


@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_params_round_trip_through_numpy(name):
    model = build_model(tcfgs.get_smoke_config(name))
    p = model.init_params(torch.Generator().manual_seed(3), device="cpu")
    tree = params_to_numpy(p)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in jax.tree.leaves(tree))
    back = params_from_numpy(tree, device="cpu")
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()


def test_init_params_is_seeded_and_device_independent():
    model = build_model(tcfgs.get_smoke_config("qwen3-0.6b"))
    a = model.init_params(torch.Generator().manual_seed(5), device="cpu")
    b = model.init_params(torch.Generator().manual_seed(5), "cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", jcfgs.ARCH_NAMES)
def test_prefill_and_decode_never_write_the_callers_cache(name):
    """Caches are values, as in JAX: the cache a caller passes to
    ``prefill`` or ``decode_step`` is left as it was."""
    _, _, model, params = models(name)
    _, batch = make_batches(model.cfg, B=2, S=12)
    cache0 = model.init_cache(2, 16, device="cpu")
    snap0 = jax.tree.map(torch.clone, cache0)
    _, cache1 = model.prefill(params, batch, cache0)
    snap1 = jax.tree.map(torch.clone, cache1)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    _, cache2 = model.decode_step(params, tok, 12, cache1)
    _, cache2b = model.decode_step(params, tok, 12, cache1)
    for before, after in ((snap0, cache0), (snap1, cache1)):
        for x, y in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
            assert torch.equal(x, y)
    for x, y in zip(jax.tree.leaves(cache2), jax.tree.leaves(cache2b)):
        assert torch.equal(x, y)   # a reused cache gives the same step


def test_sliding_window_prefill_writes_a_ring():
    """h2o-danube's window (32): a 40-token prefill into a 32-slot cache
    keeps position p at slot p % 32, as the JAX ring does."""
    jm, jp, tm, tp = models("h2o-danube-1.8b")
    jb, tb = make_batches(jm.cfg, B=1, S=40)
    _, jc = jm.prefill(jp, jb, jm.init_cache(1, 48))
    _, tc = tm.prefill(tp, tb, tm.init_cache(1, 48, device="cpu"))
    assert tc["k"].shape[2] == 32
    jk = np.asarray(jc["k"].astype(np.float32))
    tk = tc["k"].float().numpy()
    assert np.abs(tk - jk).max() <= 5e-2 * np.abs(jk).max()
    # slots 0..7 hold positions 32..39, slots 8..31 positions 8..31
    _, tc_short = tm.prefill(tp, {"tokens": tb["tokens"][:, :32]},
                             tm.init_cache(1, 48, device="cpu"))
    # layer 0's keys depend on their own token and position only
    assert torch.equal(tc["k"][0, :, 8:], tc_short["k"][0, :, 8:])
    assert int(tc["len"][0]) == 40
