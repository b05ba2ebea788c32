"""Shared neural-net layers (the port of ``repro.models.layers``).

Conventions:
* params are nested dicts of tensors; init fns take a ``torch.Generator``,
  the sizes and a device, and return the dict; apply fns take
  (params, inputs).  Draws are made on the generator's device and then
  moved to ``device`` (None means ``cuda``), so one CPU generator gives
  the same weights on every device.
* compute dtype is bf16 (cast at embedding), params are stored fp32
  ("master"); ``dense`` casts the weight to the activation's dtype.
* attention is *chunked* (online softmax, FlashAttention-style): a Python
  loop over q chunks, an inner loop over kv chunks — what the JAX
  package's ``lax.map``/``lax.scan`` do — so a long prefill never holds
  an (S, S) score matrix, and under autograd each q chunk's kv loop is
  recomputed in the backward (:func:`remat_call`, ``jax.checkpoint``
  in the JAX code) instead of keeping its score tiles.

The JAX numerics are the spec: the rmsnorm's cast order, the
population variance of ``layernorm``, the tanh-approximate gelu, the
half-split rope, and the attention accumulator kept in q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core.device import resolve_device

__all__ = [
    "dense_init", "dense",
    "rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm",
    "rope", "chunked_attention", "decode_attention",
    "swiglu_init", "swiglu", "gelu_mlp_init", "gelu_mlp",
    "embed_init", "randn", "remat_call",
]

NEG_INF = -1e30   # the JAX package's mask value (and the running max's floor)


def randn(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard normal fp32 draw from ``gen`` (on its own device), on ``device``."""
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return t.to(resolve_device(device))


def _tracks_grad(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    if isinstance(obj, dict):
        return any(_tracks_grad(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return any(_tracks_grad(v) for v in obj)
    return False


def remat_call(fn, *args, remat: bool = True):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``remat`` and autograd records the call — grad mode on and a tensor
    of ``args`` requiring grad — so its activations are recomputed in
    the backward.  Otherwise a plain call: inference runs exactly the
    kernels it would without remat."""
    if remat and torch.is_grad_enabled() and _tracks_grad(args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def dense_init(gen, d_in: int, d_out: int, scale: Optional[float] = None,
               device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return randn(gen, (d_in, d_out), device) * scale


def dense(w, x):
    return x @ w.to(x.dtype)


def rmsnorm_init(d: int, device=None):
    return torch.ones((d,), dtype=torch.float32, device=resolve_device(device))


def rmsnorm(g, x, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g.to(x.dtype)


def layernorm_init(d: int, device=None):
    dev = resolve_device(device)
    return {"g": torch.ones((d,), dtype=torch.float32, device=dev),
            "b": torch.zeros((d,), dtype=torch.float32, device=dev)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half split.  x: (B, S, H, Dh), positions: (S,).

    cos/sin are computed in fp32 at (S, half), then cast to x's dtype.
    """
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None].to(device=x.device, dtype=torch.float32) * freq
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)       # (1, S, 1, half)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, bias):
    """Grouped attention block.

    q: (B,G,R,Tq,Dh), k/v: (B,G,Tk,Dh), bias: (Tq,Tk) additive (fp32).
    R = query heads per kv head (GQA) — kv is never materialized per-head.
    """
    s = torch.einsum("bgrqd,bgkd->bgrqk", q, k).float()
    s = s * (1.0 / math.sqrt(q.shape[-1])) + bias
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)  # fully masked rows
    p = torch.exp(s - m)
    lse = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype), v)
    return o, m[..., 0], lse[..., 0]


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad dim 1 of a (B, S, G, Dh) tensor with ``n`` zero rows at the end."""
    return F.pad(x, (0, 0, 0, 0, 0, n)) if n else x


def chunked_attention(
    q: torch.Tensor,          # (B, Sq, H, Dh)
    k: torch.Tensor,          # (B, Sk, G, Dh)   G = kv heads
    v: torch.Tensor,          # (B, Sk, G, Dh)
    causal: bool = True,
    window: Optional[int] = None,   # sliding-window width (tokens), None = full
    q_offset: int = 0,        # absolute position of q[0] (chunked prefill)
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax (FlashAttention-style) GQA attention, O(S·chunk) memory.

    The tails are padded to whole chunks and masked with -1e30; the
    accumulator stays in q's dtype, the running max and sum in fp32.
    """
    B, Sq, H, Dh = q.shape
    _, Sk, G, _ = k.shape
    if H % G:
        raise ValueError(f"{H} query heads do not group over {G} kv heads")
    rep = H // G

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    qp = _pad_seq(q, nq * q_chunk - Sq)
    kp = _pad_seq(k, nk * kv_chunk - Sk)
    vp = _pad_seq(v, nk * kv_chunk - Sk)

    # grouped layout: (B, G, R, S, Dh) for q, (B, G, S, Dh) for kv
    qp = qp.movedim(2, 1).reshape(B, G, rep, nq * q_chunk, Dh)
    kp = kp.movedim(2, 1)
    vp = vp.movedim(2, 1)

    dev = q.device
    qpos_base = torch.arange(q_chunk, device=dev) + q_offset
    kpos_all = torch.arange(nk * kv_chunk, device=dev)

    def one_q_chunk(qc, kp, vp, qi: int):
        qpos = qpos_base + qi * q_chunk
        acc = torch.zeros((B, G, rep, q_chunk, Dh), dtype=q.dtype, device=dev)
        m = torch.full((B, G, rep, q_chunk), -math.inf, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((B, G, rep, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kpos = kpos_all[ks]
            valid = (kpos < Sk)[None, :] & (qpos < Sq + q_offset)[:, None]
            if causal:
                valid &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                valid &= kpos[None, :] > (qpos[:, None] - window)
            bias = torch.where(valid, 0.0, NEG_INF)
            o, mb, lb = _attend_block(qc, kp[:, :, ks], vp[:, :, ks], bias)
            m_new = torch.maximum(m, mb)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(mb - m_new)
            acc = (acc * alpha[..., None].to(acc.dtype)
                   + o * beta[..., None].to(o.dtype))
            lse = lse * alpha + lb * beta
            m = m_new
        return acc / lse.clamp_min(1e-30)[..., None].to(acc.dtype)

    outs = [remat_call(one_q_chunk, qp[:, :, :, qi * q_chunk:(qi + 1) * q_chunk],
                       kp, vp, qi)
            for qi in range(nq)]
    # nq x (B, G, rep, q_chunk, Dh) -> (B, Sq, H, Dh)
    out = torch.cat(outs, dim=3).reshape(B, H, nq * q_chunk, Dh)
    return out.movedim(1, 2)[:, :Sq]


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, L, G, Dh)  L = cache length
    v_cache: torch.Tensor,
    cache_len,              # number of valid entries (int or 0-d tensor)
) -> torch.Tensor:
    """Single-token attention against a KV cache (full or ring)."""
    B, L, G, Dh = k_cache.shape
    H = q.shape[2]
    rep = H // G
    kq = k_cache.movedim(2, 1)  # (B,G,L,Dh)
    vq = v_cache.movedim(2, 1)
    qh = q.movedim(2, 1).reshape(B, G, rep, 1, Dh)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qh, kq).float()
    s = s / math.sqrt(Dh)
    pos = torch.arange(L, device=q.device)
    mask = pos < cache_len
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vq.dtype)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, vq)
    return o.reshape(B, H, 1, Dh).movedim(1, 2)  # (B, 1, H, Dh)


def swiglu_init(gen, d: int, f: int, device=None):
    return {
        "w_gate": dense_init(gen, d, f, device=device),
        "w_up": dense_init(gen, d, f, device=device),
        "w_down": dense_init(gen, f, d, device=device),
    }


def swiglu(p, x):
    g = dense(p["w_gate"], x)
    u = dense(p["w_up"], x)
    return dense(p["w_down"], F.silu(g) * u)


def gelu_mlp_init(gen, d: int, f: int, device=None):
    return {"w_in": dense_init(gen, d, f, device=device),
            "w_out": dense_init(gen, f, d, device=device)}


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p["w_out"], F.gelu(dense(p["w_in"], x), approximate="tanh"))


def embed_init(gen, vocab: int, d: int, device=None):
    return randn(gen, (vocab, d), device) * 0.02
