"""The port's LM layers, MoE and Mamba-2 blocks against the JAX package.

Every function of ``repro_torch.models.layers``, ``.moe`` and ``.mamba2``
gets the same numpy-seeded fp32 inputs (and the same params, carried
across) as its JAX original, and must agree within 1e-5 relative to the
output's max |value|.  ``jnp`` functions take any dtype, so fp32 isolates
translation faults from bf16 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jl
from repro.models import mamba2 as jmb
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tmb
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy, params_to_numpy

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))
    assert err <= tol, err
    return err


def _jax_params(init, *args):
    return jax.tree.map(np.asarray, init(*args))


# ------------------------------------------------------------------- layers

def test_dense_norms_and_mlps():
    rng = _rng(1)
    x = _normal(rng, 2, 5, 24)
    w = _normal(rng, 24, 40)
    _close(tl.dense(_t(w), _t(x)), jl.dense(jnp.asarray(w), jnp.asarray(x)))
    g = _normal(rng, 24) + 1.0
    _close(tl.rmsnorm(_t(g), _t(x)), jl.rmsnorm(jnp.asarray(g), jnp.asarray(x)))
    ln = {"g": g, "b": _normal(rng, 24)}
    _close(tl.layernorm(params_from_numpy(ln, "cpu"), _t(x + 3.0)),
           jl.layernorm(jax.tree.map(jnp.asarray, ln), jnp.asarray(x + 3.0)))
    sw = _jax_params(jl.swiglu_init, jax.random.PRNGKey(3), 24, 40)
    _close(tl.swiglu(params_from_numpy(sw, "cpu"), _t(x)),
           jl.swiglu(jax.tree.map(jnp.asarray, sw), jnp.asarray(x)))
    ge = _jax_params(jl.gelu_mlp_init, jax.random.PRNGKey(4), 24, 40)
    _close(tl.gelu_mlp(params_from_numpy(ge, "cpu"), _t(x)),
           jl.gelu_mlp(jax.tree.map(jnp.asarray, ge), jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_half_split(theta):
    rng = _rng(2)
    x = _normal(rng, 2, 37, 3, 16)
    pos = np.arange(100, 137)
    _close(tl.rope(_t(x), _t(pos), theta),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (37, 37, True, None, 0),     # ragged tails on both sides
    (37, 37, False, None, 0),
    (45, 45, True, 9, 0),        # a sliding window
    (21, 50, True, None, 29),    # chunked prefill: q starts at 29
    (19, 33, False, None, 0),    # cross attention, Sq != Sk
    (40, 40, True, 16, 5),       # window and offset together
])
def test_chunked_attention(Sq, Sk, causal, window, q_offset):
    rng = _rng(Sq * 100 + Sk)
    q = _normal(rng, 2, Sq, 4, 16)
    k = _normal(rng, 2, Sk, 2, 16)
    v = _normal(rng, 2, Sk, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=8,
              kv_chunk=16)
    _close(tl.chunked_attention(_t(q), _t(k), _t(v), **kw),
           jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw))


def test_chunked_attention_default_chunks():
    rng = _rng(5)
    q = _normal(rng, 1, 600, 4, 8)
    k = _normal(rng, 1, 600, 1, 8)
    v = _normal(rng, 1, 600, 1, 8)
    _close(tl.chunked_attention(_t(q), _t(k), _t(v)),
           jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("cache_len", [1, 13, 24])
def test_decode_attention(cache_len):
    rng = _rng(6 + cache_len)
    q = _normal(rng, 2, 1, 4, 16)
    kc = _normal(rng, 2, 24, 2, 16)
    vc = _normal(rng, 2, 24, 2, 16)
    _close(tl.decode_attention(_t(q), _t(kc), _t(vc), torch.tensor(cache_len)),
           jl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.int32(cache_len)))


# ---------------------------------------------------------------------- MoE

@pytest.mark.parametrize("arch,capacity_factor", [
    ("mixtral-8x7b", 0.5),            # tokens dropped
    ("mixtral-8x7b", None),           # the smoke config's ample capacity
    ("llama4-maverick-400b-a17b", 0.5),
])
def test_moe_apply(arch, capacity_factor):
    jcfg = jax_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    p = _jax_params(jmoe.moe_init, jax.random.PRNGKey(7), jcfg)
    x = _normal(_rng(8), 2, 32, jcfg.d_model)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(params_from_numpy(p, "cpu"), tcfg, _t(x))
    _close(ty, jy)
    _close(taux, jaux)
    T = 64
    cap = tmoe.moe_capacity(tcfg, T)
    assert cap == min(max(int(tcfg.capacity_factor * T * tcfg.top_k
                              / tcfg.n_experts), 1), T)
    if capacity_factor == 0.5:
        # capacity below the mean load: some assignment is dropped
        assert cap * tcfg.n_experts < T * tcfg.top_k


def test_moe_top_k_ties_go_to_the_lower_expert():
    """A zero router ties every expert: lax.top_k takes the lowest
    indices, and so must the port (bf16 router logits tie often)."""
    jcfg = jax_smoke_config("mixtral-8x7b")
    tcfg = get_smoke_config("mixtral-8x7b")
    p = _jax_params(jmoe.moe_init, jax.random.PRNGKey(9), jcfg)
    p["router"] = np.zeros_like(p["router"])
    x = _normal(_rng(10), 2, 8, jcfg.d_model)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(params_from_numpy(p, "cpu"), tcfg, _t(x))
    _close(ty, jy)
    _close(taux, jaux)


# ------------------------------------------------------------------- Mamba2

def test_segsum_split_and_causal_conv():
    rng = _rng(9)
    a = _normal(rng, 2, 3, 11)
    got = tmb._segsum(_t(a)).numpy()
    ref = np.asarray(jmb._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    _close(got[fin], ref[fin])
    cfg = get_smoke_config("mamba2-130m")
    jcfg = jax_smoke_config("mamba2-130m")
    z = _normal(rng, 2, 7, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    for got, ref in zip(tmb._split_proj(cfg, _t(z)),
                        jmb._split_proj(jcfg, jnp.asarray(z))):
        _close(got, ref, tol=0.0)
    p = _jax_params(jmb.mamba_init, jax.random.PRNGKey(10), jcfg)
    p["conv_b"] = _normal(rng, *p["conv_b"].shape)
    xbc = _normal(rng, 2, 7, cfg.d_inner + 2 * cfg.ssm_state)
    _close(tmb._causal_conv(params_from_numpy(p, "cpu"), _t(xbc), cfg.conv_width),
           jmb._causal_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(xbc),
                            cfg.conv_width))


@pytest.mark.parametrize("S,chunk,with_state", [
    (40, 16, False),   # S not a multiple of the chunk
    (40, 16, True),    # with an incoming state
    (16, 16, False),
    (9, 16, True),     # one short chunk
])
def test_ssd_chunked(S, chunk, with_state):
    rng = _rng(S * 10 + chunk + with_state)
    B, H, P, N = 2, 3, 8, 5
    x = _normal(rng, B, S, H, P)
    dt = np.log1p(np.exp(_normal(rng, B, S, H))).astype(np.float32)
    A = -np.exp(_normal(rng, H, scale=0.5)).astype(np.float32)
    Bm = _normal(rng, B, S, N)
    Cm = _normal(rng, B, S, N)
    h0 = _normal(rng, B, H, P, N) if with_state else None
    ty, th = tmb._ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                              None if h0 is None else _t(h0))
    jy, jh = jmb._ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                              jnp.asarray(Bm), jnp.asarray(Cm), chunk,
                              None if h0 is None else jnp.asarray(h0))
    _close(ty, jy)
    _close(th, jh)


def _mamba_params(rng, jcfg):
    p = _jax_params(jmb.mamba_init, jax.random.PRNGKey(11), jcfg)
    # away from init's constants, so dt_bias, A_log, D and conv_b matter
    for name in ("conv_b", "dt_bias", "A_log"):
        p[name] = _normal(rng, *p[name].shape, scale=0.5)
    p["D"] = p["D"] + _normal(rng, *p["D"].shape, scale=0.5)
    return p


@pytest.mark.parametrize("S", [40, 2])
def test_mamba_apply_with_state(S):
    rng = _rng(12 + S)
    jcfg = jax_smoke_config("mamba2-130m")
    cfg = get_smoke_config("mamba2-130m")
    p = _mamba_params(rng, jcfg)
    u = _normal(rng, 2, S, cfg.d_model)
    h0 = _normal(rng, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    ty, ts = tmb.mamba_apply(params_from_numpy(p, "cpu"), cfg, _t(u),
                             init_state=_t(h0), return_state=True)
    jy, js = jmb.mamba_apply(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(u),
                             init_state=jnp.asarray(h0), return_state=True)
    _close(ty, jy)
    _close(ts["ssm"], js["ssm"])
    # the conv tail is stored in bf16: equal to the last bf16 ulp
    assert ts["conv"].dtype == torch.bfloat16
    _close(ts["conv"], np.asarray(js["conv"].astype(jnp.float32)), tol=2 ** -8)
    ty0, none = tmb.mamba_apply(params_from_numpy(p, "cpu"), cfg, _t(u))
    assert none is None
    _close(ty0, jmb.mamba_apply(jax.tree.map(jnp.asarray, p), jcfg,
                                jnp.asarray(u))[0])


def test_mamba_decode_step():
    rng = _rng(13)
    jcfg = jax_smoke_config("mamba2-130m")
    cfg = get_smoke_config("mamba2-130m")
    p = _mamba_params(rng, jcfg)
    u = _normal(rng, 2, 1, cfg.d_model)
    state = {
        "ssm": _normal(rng, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": np.asarray(jnp.asarray(
            _normal(rng, 2, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state),
            jnp.bfloat16).astype(jnp.float32)),
    }
    tstate = {"ssm": _t(state["ssm"]), "conv": _t(state["conv"]).bfloat16()}
    ty, ts = tmb.mamba_decode_step(params_from_numpy(p, "cpu"), cfg, _t(u), tstate)
    jy, js = jmb.mamba_decode_step(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(u),
        {"ssm": jnp.asarray(state["ssm"]),
         "conv": jnp.asarray(state["conv"], jnp.bfloat16)})
    _close(ty, jy)
    _close(ts["ssm"], js["ssm"])
    got = params_to_numpy({"c": ts["conv"].float()})["c"]
    assert np.array_equal(got[:, :-1], state["conv"][:, 1:])
    _close(got, np.asarray(js["conv"].astype(jnp.float32)), tol=2 ** -8)


def test_mamba_init_state_shapes():
    jcfg = jax_smoke_config("zamba2-2.7b")
    cfg = get_smoke_config("zamba2-2.7b")
    ts = tmb.mamba_init_state(cfg, 3, device="cpu")
    js = jmb.mamba_init_state(jcfg, 3)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype)
        assert not ts[k].any()
