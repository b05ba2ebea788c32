"""The port's LM gradients in fp32 against the JAX package's, and remat.

Per function (``jax.vjp`` against ``torch.autograd.grad`` with the same
numpy-seeded cotangents): ``block_apply``, the VLM's gated cross block,
``chunked_attention`` (ragged chunks, a window, an offset), ``moe_apply``
with dropped tokens and the SSD scan with a state, within 1e-4 of each
input's max |grad|.  The MoE, SSM, hybrid and VLM smoke models' loss
grads in fp32 (the embedding's bf16 cast swapped out, as
``check_fp32_forward`` does; the VLM's images kept in fp32 and its gates
non-zero), within 1e-4 per leaf.  Remat changes no bit: grads with and without it are equal, and
under ``torch.no_grad`` (or with no param requiring grad, as on the
serve path) no checkpoint runs and the logits equal ``remat=False``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from _torch_lm_case import leaf_err, make_batches, models, port_value_and_grad
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jl
from repro.models import mamba2 as jmb
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tmb
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.api import build_model
from repro_torch.models.transformer import tree_leaves, tree_map

FP32_TOL = 1e-4


def _normal(rng, *shape, scale=1.0):
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


# ------------------------------------------------------------ whole models

class _Fp32Images:
    """The VLM's image stub kept in fp32: both packages cast
    ``batch["images"]`` to bf16 inline (``astype`` in JAX, ``to`` in the
    port), and this stand-in hands back the fp32 array to either."""

    def __init__(self, array):
        self.array = array

    def astype(self, dtype):
        return self.array

    to = astype


def _vlm_in_fp32(jp, tp, jb, tb):
    """fp32 images, and the cross blocks' tanh gates at seeded non-zero
    values in both packages (at init they are zero, which leaves the
    cross attention and its MLP without a grad)."""
    jb["images"] = _Fp32Images(jb["images"].astype(jnp.float32))
    tb["images"] = _Fp32Images(tb["images"].float())
    rng = np.random.default_rng(5)
    for gate in ("gate_attn", "gate_mlp"):
        g = rng.uniform(0.3, 1.0, jp["cross"][gate].shape).astype(np.float32)
        jp["cross"][gate] = jnp.asarray(g)
        tp["cross"][gate] = torch.from_numpy(g)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "mamba2-130m", "zamba2-2.7b",
                                  "llama-3.2-vision-90b"])
def test_moe_ssm_hybrid_grads_match_jax_in_fp32(arch, monkeypatch):
    import repro.models.api as jax_api
    import repro_torch.models.api as torch_api

    def fp32_embed(p, tokens):
        return p["embed"][tokens]

    monkeypatch.setattr(jax_api, "_embed_tokens", fp32_embed)
    monkeypatch.setattr(torch_api, "_embed_tokens", fp32_embed)
    jm, jp, tm, tp = models(arch)
    jb, tb = make_batches(jm.cfg)
    if jm.cfg.family == "vlm":
        _vlm_in_fp32(jp, tp, jb, tb)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)))(jp)
    tloss, tg = port_value_and_grad(tm, tp, tb)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    errs = [leaf_err(t, j) for t, j in zip(tree_leaves(tg),
                                           jax.tree.leaves(jg))]
    assert len(errs) == len(jax.tree.leaves(jg))
    assert all(float(np.abs(np.asarray(j)).max()) > 0
               for j in jax.tree.leaves(jg)), "a leaf without a grad"
    print(arch, f"fp32 worst leaf {max(errs):.3e}")
    assert max(errs) <= FP32_TOL, errs


# ------------------------------------------------------------ per function

def _check_vjp(jfn, tfn, np_args, seed):
    """grads of <out, cotangent> w.r.t. every arg (a tree of arrays), JAX
    and the port, with the same seeded cotangent per output."""
    targs = tuple(tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(), a)
        for a in np_args)
    jout, vjp = jax.vjp(jfn, *(jax.tree.map(jnp.asarray, a) for a in np_args))
    jouts = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.default_rng(seed)
    cts = [_normal(rng, *np.shape(o)) for o in jouts]
    jg = vjp(tuple(map(jnp.asarray, cts)) if isinstance(jout, tuple)
             else jnp.asarray(cts[0]))
    tout = tfn(*targs)
    touts = tout if isinstance(tout, tuple) else (tout,)
    # the args as one dict tree with positional keys: its leaves are in
    # jax.tree.leaves' order of the tuple of grads
    inputs = tree_leaves({f"{i:02d}": a for i, a in enumerate(targs)})
    tg = torch.autograd.grad(touts, inputs, [torch.from_numpy(c) for c in cts])
    jleaves = [x for j in jg for x in jax.tree.leaves(j)]
    assert len(tg) == len(jleaves)
    errs = [leaf_err(t, j) for t, j in zip(tg, jleaves)]
    assert max(errs) <= FP32_TOL, errs


def test_block_apply_vjp():
    jcfg = jax_smoke_config("qwen3-0.6b")   # GQA, qk-norm
    cfg = get_smoke_config("qwen3-0.6b")
    p = jax.tree.map(np.asarray, jtr.block_init(jax.random.PRNGKey(3), jcfg))
    x = _normal(np.random.default_rng(31), 2, 37, jcfg.d_model)
    _check_vjp(lambda p, x: jtr.block_apply(p, jcfg, x)[0],
               lambda p, x: ttr.block_apply(p, cfg, x)[0], (p, x), 32)


def test_cross_block_apply_vjp():
    """The VLM's gated cross-attention block with its images as kv, the
    gates at non-zero values."""
    import repro.models.api as jax_api
    import repro_torch.models.api as torch_api

    jcfg = jax_smoke_config("llama-3.2-vision-90b")
    cfg = get_smoke_config("llama-3.2-vision-90b")
    p = jax.tree.map(np.asarray,
                     jax_api._cross_block_init(jax.random.PRNGKey(4), jcfg))
    p["gate_attn"], p["gate_mlp"] = np.float32(0.6), np.float32(-0.8)
    rng = np.random.default_rng(44)
    x = _normal(rng, 2, 21, jcfg.d_model)
    img = _normal(rng, 2, 9, jcfg.d_model)
    _check_vjp(lambda p, x, i: jax_api._cross_block_apply(p, jcfg, x, kv_x=i)[0],
               lambda p, x, i: torch_api._cross_block_apply(p, cfg, x, kv_x=i)[0],
               (p, x, img), 45)


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (37, 37, True, None, 0),     # ragged tails on both sides
    (45, 45, True, 9, 0),        # a sliding window
    (21, 50, True, None, 29),    # chunked prefill: q starts at 29
    (19, 33, False, None, 0),    # cross attention
])
def test_chunked_attention_vjp(Sq, Sk, causal, window, q_offset):
    rng = np.random.default_rng(Sq * 100 + Sk)
    q = _normal(rng, 2, Sq, 4, 16)
    k = _normal(rng, 2, Sk, 2, 16)
    v = _normal(rng, 2, Sk, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=8,
              kv_chunk=16)
    _check_vjp(lambda q, k, v: jl.chunked_attention(q, k, v, **kw),
               lambda q, k, v: tl.chunked_attention(q, k, v, **kw),
               (q, k, v), Sq + Sk)


def test_moe_apply_vjp_with_dropped_tokens():
    jcfg = dataclasses.replace(jax_smoke_config("mixtral-8x7b"),
                               capacity_factor=0.5)
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              capacity_factor=0.5)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(7), jcfg))
    x = _normal(np.random.default_rng(8), 2, 32, jcfg.d_model)
    assert tmoe.moe_capacity(cfg, 64) * cfg.n_experts < 64 * cfg.top_k
    _check_vjp(lambda p, x: jmoe.moe_apply(p, jcfg, x),
               lambda p, x: tmoe.moe_apply(p, cfg, x), (p, x), 9)


def test_ssd_scan_vjp_with_a_state():
    rng = np.random.default_rng(41)
    B, S, H, P, N, chunk = 2, 40, 3, 8, 5, 16
    x = _normal(rng, B, S, H, P)
    dt = np.log1p(np.exp(_normal(rng, B, S, H))).astype(np.float32)
    A = -np.exp(_normal(rng, H, scale=0.5)).astype(np.float32)
    Bm = _normal(rng, B, S, N)
    Cm = _normal(rng, B, S, N)
    h0 = _normal(rng, B, H, P, N)
    _check_vjp(lambda *a: jmb._ssd_chunked(*a[:5], chunk, a[5]),
               lambda *a: tmb._ssd_chunked(*a[:5], chunk, a[5]),
               (x, dt, A, Bm, Cm, h0), 42)


# ------------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_remat_changes_no_bit_of_the_grads(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    tm = build_model(cfg)
    tp = tm.init_params(torch.Generator().manual_seed(1), device="cpu")
    tb = make_batches(cfg)[1]
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    l_on, g_on = port_value_and_grad(tm, tp, tb)
    assert calls, "no layer ran under remat"
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    l_off, g_off = port_value_and_grad(tm, tp, tb)
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_inference_runs_no_remat_and_the_same_logits(monkeypatch):
    """forward, prefill and decode_step under ``torch.no_grad`` and with
    plain (serve-path) params: no checkpoint runs, and the logits equal
    ``dense_forward(..., remat=False)``'s bit for bit."""
    cfg = get_smoke_config("qwen3-0.6b")
    tm = build_model(cfg)
    tp = tm.init_params(torch.Generator().manual_seed(2), device="cpu")
    tb = make_batches(cfg)[1]
    B, S = tb["tokens"].shape
    off = ttr.dense_forward(tp, cfg, tb["tokens"], remat=False)

    def refuse(*a, **kw):
        raise AssertionError("remat ran at inference")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    decoded = []
    for ctx in (torch.no_grad, torch.enable_grad):
        with ctx():
            assert torch.equal(ttr.dense_forward(tp, cfg, tb["tokens"]), off)
            assert torch.equal(tm.forward(tp, tb)[0], off)
            pre, cache = tm.prefill(tp, tb, tm.init_cache(B, S + 2, "cpu"))
            assert torch.equal(pre[:, 0], off[:, -1])
            nxt = pre[:, -1].argmax(-1)[:, None].int()
            decoded.append(tm.decode_step(tp, nxt, S, cache)[0])
    assert torch.equal(decoded[0], decoded[1])
    full = ttr.dense_forward(tp, cfg, torch.cat([tb["tokens"], nxt], 1),
                             remat=False)
    ref = full[:, S].float()
    assert float((decoded[0][:, 0].float() - ref).abs().max()) \
        <= 5e-2 * float(ref.abs().max())
