"""Unified model API: build(config) -> Model with init/forward/serve closures
(the port of ``repro.models.api``).

One entry point for all 10 assigned architectures:

* ``dense``   minitron-4b, phi3-medium-14b, h2o-danube-1.8b (SWA), qwen3-0.6b
* ``moe``     mixtral-8x7b (every layer), llama4-maverick (alternating)
* ``ssm``     mamba2-130m
* ``hybrid``  zamba2-2.7b (Mamba2 backbone + ONE shared attention block)
* ``vlm``     llama-3.2-vision-90b (groups of 4 self + 1 gated cross-attn)
* ``encdec``  whisper-tiny (bidirectional encoder + cross-attending decoder)

Every family exposes the same surface:
    init_params(generator, device=None)     -> params tree
    forward(params, batch)                  -> (logits, aux_loss)
    loss(params, batch)                     -> scalar
    init_cache(batch_size, max_len, device=None) -> cache tree
    prefill(params, batch, cache)           -> (last logits, cache)
    decode_step(params, token, pos, cache)  -> (logits, cache)

``device=None`` means ``cuda``; pass ``device="cpu"`` for the CPU.
``loss`` is differentiable: under autograd every family's outer layer
loop runs each layer under ``torch.utils.checkpoint`` where the JAX
package wraps its scan body in ``jax.checkpoint``; inference runs no
remat.
Params are nested dicts of fp32 tensors with the JAX package's keys and
shapes (``repro_torch.models.convert`` carries them across).  Modality
frontends (vision patches, audio frames) are stubs per the assignment:
``batch["images"]`` / ``batch["frames"]`` carry precomputed embeddings.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from .layers import (
    all_reduce, chunked_attention, dense, dense_init, embed_init, is_dtensor,
    local_region, remat_call, shard_offset, sharded_scope, split_heads,
)
from .mamba2 import mamba_apply, mamba_decode_step, mamba_init, mamba_init_state
from .moe import moe_apply, moe_init
from .transformer import (
    attn_apply, attn_init, block_apply, block_init, mlp_fn, mlp_init,
    norm_apply, norm_init, stack_init, scan_layers, tree_index, tree_map,
    tree_stack, tree_unbind, CacheStack,
    kv_cache_init, positions_at,
    dense_params_init, dense_forward, dense_init_cache, dense_prefill,
    dense_decode_step,
)
from .transformer import embed_tokens as _embed_tokens  # noqa: F401
from .transformer import head_logits as _head

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init_params: Callable  # (generator, device=None) -> params
    forward: Callable      # (params, batch) -> (logits, aux)
    init_cache: Callable   # (batch, max_len, device=None) -> cache
    prefill: Callable      # (params, batch, cache) -> (logits, cache)
    decode_step: Callable  # (params, token, pos, cache) -> (logits, cache)

    def loss(self, params, batch):
        """Mean next-token cross entropy + 0.01 · aux.  The label's logit
        is a ``gather`` where JAX takes a one-hot masked sum: the same
        value and gradient, without a (B, S, V) mask.  On DTensor logits
        it is a vocab-parallel region (:func:`_sharded_nll`), which keeps
        a vocab-sharded dim sharded, as JAX's masked sum does."""
        with sharded_scope(params, batch):
            logits, aux = self.forward(params, batch)
            labels = batch["labels"]
            if is_dtensor(logits):
                nll = _sharded_nll(logits, labels)
            else:
                nll = _nll(logits, labels)
            return nll.mean() + 0.01 * aux


def _nll(logits, labels):
    """Per-token ``logsumexp - label logit`` in fp32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    return lse - lf.gather(-1, labels[..., None].long())[..., 0]


def _sharded_nll(logits, labels):
    """:func:`_nll` on DTensor logits as one region (Megatron's
    vocab-parallel cross entropy): the logits keep their batch and vocab
    shards, and each rank takes its local max, sum of exps and label
    logit, reduced over the vocab's mesh dims (:class:`_VocabNLL`); an
    uneven split (a vocab that does not divide) is taken as it is.
    Where no mesh dim of size > 1 splits the vocab, the region runs
    :func:`_nll` on the local tensor, the plain path's ops."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    d = logits.ndim - 1
    pl = tuple(Replicate() if q.is_partial() else q
               for q in logits.placements)
    vdims = [i for i, q in enumerate(pl)
             if q.is_shard(d) and mesh.size(i) > 1]
    v0 = shard_offset(logits.shape[d], mesh, vdims)
    lab_pl = tuple(Replicate() if q.is_shard(d) else q for q in pl)
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)

    def local(lg, lab):
        if not vdims:
            return _nll(lg, lab)
        return _VocabNLL.apply(lg, lab, v0, mesh, vdims)

    return local_region(local, (logits, labels), (pl, lab_pl), (lab_pl,),
                        mesh)


class _VocabNLL(torch.autograd.Function):
    """Per-token ``logsumexp - label logit`` of one rank's vocab slice
    ``lg`` (its first column is vocab entry ``v0``): max and sums reduced
    over the vocab's mesh ``dims``.  The backward is local, ``(softmax -
    onehot) · g`` on the slice, and recomputes the softmax from the
    saved logits instead of keeping it."""

    @staticmethod
    def forward(ctx, lg, labels, v0, mesh, dims):
        lf = lg.float()
        m = all_reduce(lf.amax(dim=-1), "max", mesh, dims)
        s = torch.exp(lf - m[..., None]).sum(dim=-1)
        idx = labels.long() - v0
        own = (idx >= 0) & (idx < lf.shape[-1])
        idx = idx.clamp(0, lf.shape[-1] - 1)
        ll = torch.where(own, lf.gather(-1, idx[..., None])[..., 0], 0.0)
        s, ll = all_reduce(torch.stack([s, ll]), "sum", mesh, dims).unbind(0)
        lse = m + torch.log(s)
        ctx.save_for_backward(lg, lse, idx, own)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        lg, lse, idx, own = ctx.saved_tensors
        p = torch.exp(lg.float() - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -own[..., None].to(p.dtype))
        p.mul_(g[..., None])
        return p.to(lg.dtype), None, None, None, None


def _sinusoid(S: int, D: int, device, dtype=torch.bfloat16):
    pos = torch.arange(S, device=device)[:, None]
    i = torch.arange(D // 2, device=device)[None, :]
    ang = pos / (10000 ** (2 * i / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid_at(pos, D: int, device, dtype=torch.bfloat16):
    i = torch.arange(D // 2, device=device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device)
    ang = pos / (10000 ** (2 * i / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _arange(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)


def _broadcast_state(one, lead):
    return tree_map(lambda a: a.expand(tuple(lead) + a.shape).clone(), one)


# =============================================================== dense family

def _build_dense(cfg: ArchConfig) -> Model:
    def forward(p, batch):
        return dense_forward(p, cfg, batch["tokens"]), 0.0

    def init_cache(batch, max_len, device=None):
        return dense_init_cache(cfg, batch, max_len, device)

    def prefill(p, batch, cache):
        return dense_prefill(p, cfg, batch["tokens"], cache)

    def decode_step(p, token, pos, cache):
        return dense_decode_step(p, cfg, token, pos, cache)

    def init_params(gen, device=None):
        return dense_params_init(gen, cfg, device)

    return Model(cfg, init_params, forward, init_cache, prefill, decode_step)


# ================================================================= MoE family

def _moe_super_init(gen, cfg: ArchConfig, device=None):
    """One super-block: (moe_every - 1) dense blocks + 1 MoE block."""
    p: Dict[str, Any] = {
        "moe_ln1": norm_init(cfg, device=device),
        "moe_attn": attn_init(gen, cfg, device),
        "moe_ln2": norm_init(cfg, device=device),
        "moe": moe_init(gen, cfg, device),
    }
    if cfg.moe_every > 1:
        p["dense_blocks"] = stack_init(gen, cfg, cfg.moe_every - 1, device=device)
    return p


def _moe_super_apply(p, cfg: ArchConfig, x, positions, caches=None):
    """caches: dict with 'dense' (stacked) and 'moe' entries or None."""
    new_caches = {}
    if cfg.moe_every > 1:
        def body(x, bp, bc):
            return block_apply(bp, cfg, x, positions=positions, cache=bc,
                               window=cfg.sliding_window)

        dc = caches["dense"] if caches is not None else None
        x, ndc = scan_layers(body, x, p["dense_blocks"], dc, remat=False)
        if dc is not None:
            new_caches["dense"] = ndc
    h, nc = attn_apply(p["moe_attn"], cfg, norm_apply(cfg, p["moe_ln1"], x),
                       positions=positions,
                       cache=None if caches is None else caches["moe"],
                       window=cfg.sliding_window)
    x = x + h
    y, aux = moe_apply(p["moe"], cfg, norm_apply(cfg, p["moe_ln2"], x))
    x = x + y
    if caches is not None:
        new_caches["moe"] = nc
        return x, aux, new_caches
    return x, aux, None


def _build_moe(cfg: ArchConfig) -> Model:
    n_super = cfg.n_layers // cfg.moe_every

    def init_params(gen, device=None):
        device = resolve_device(device)
        p = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
            "supers": stack_init(gen, cfg, n_super, init_fn=_moe_super_init,
                                 device=device),
            "ln_f": norm_init(cfg, device=device),
        }
        if not cfg.tie_embeddings:
            p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                                   device=device)
        return p

    def _run(p, x, positions, cache=None):
        aux = 0.0
        new = None if cache is None else CacheStack(n_super)
        supers = tree_unbind(p["supers"], n_super)
        caches = [None] * n_super if cache is None else tree_unbind(cache, n_super)
        for i, (sp, sc) in enumerate(zip(supers, caches)):
            x, a, nc = remat_call(
                lambda x, sp, sc: _moe_super_apply(sp, cfg, x, positions, sc),
                x, sp, sc)
            aux = aux + a
            if new is not None:
                new.put(i, nc)
            del nc
        x = norm_apply(cfg, p["ln_f"], x)
        return x, aux, (None if new is None else new.value())

    def forward(p, batch):
        x = _embed_tokens(p, batch["tokens"])
        x, aux, _ = _run(p, x, _arange(x))
        return _head(p, cfg, x), aux

    def init_cache(batch, max_len, device=None):
        L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        c: Dict[str, Any] = {"moe": kv_cache_init((n_super,), batch, L, cfg, device)}
        if cfg.moe_every > 1:
            c["dense"] = kv_cache_init((n_super, cfg.moe_every - 1), batch, L,
                                       cfg, device)
        return c

    def prefill(p, batch, cache):
        x = _embed_tokens(p, batch["tokens"])
        x, _, ncache = _run(p, x, _arange(x), cache)
        return _head(p, cfg, x[:, -1:]), ncache

    def decode_step(p, token, pos, cache):
        x = _embed_tokens(p, token)
        x, _, ncache = _run(p, x, positions_at(pos, x.device), cache)
        return _head(p, cfg, x), ncache

    return Model(cfg, init_params, forward, init_cache, prefill, decode_step)


# ================================================================= SSM family

def _build_ssm(cfg: ArchConfig) -> Model:
    def init_params(gen, device=None):
        device = resolve_device(device)
        p = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
            "layers": stack_init(gen, cfg, cfg.n_layers, init_fn=mamba_init,
                                 device=device),
            "ln_f": norm_init(cfg, device=device),
        }
        if not cfg.tie_embeddings:
            p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                                   device=device)
        return p

    def forward(p, batch):
        x = _embed_tokens(p, batch["tokens"])
        x, _ = scan_layers(lambda x, lp, _: mamba_apply(lp, cfg, x), x,
                           p["layers"])
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), 0.0

    def init_cache(batch, max_len, device=None):
        return _broadcast_state(mamba_init_state(cfg, batch, device),
                                (cfg.n_layers,))

    def prefill(p, batch, cache):
        # the incoming state is not read: a prompt starts from zero state
        x = _embed_tokens(p, batch["tokens"])
        x, ncache = scan_layers(
            lambda x, lp, lc: mamba_apply(lp, cfg, x, return_state=True),
            x, p["layers"], cache)
        x = norm_apply(cfg, p["ln_f"], x[:, -1:])
        return _head(p, cfg, x), ncache

    def decode_step(p, token, pos, cache):
        x = _embed_tokens(p, token)
        x, ncache = scan_layers(
            lambda x, lp, lc: mamba_decode_step(lp, cfg, x, lc),
            x, p["layers"], cache)
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), ncache

    return Model(cfg, init_params, forward, init_cache, prefill, decode_step)


# ============================================================== hybrid family

def _build_hybrid(cfg: ArchConfig) -> Model:
    """zamba2: groups of (attn_every - 1) Mamba2 layers + ONE shared
    attention block (weights shared across all groups)."""
    per = cfg.attn_every - 1
    n_groups = cfg.n_layers // cfg.attn_every

    def init_params(gen, device=None):
        device = resolve_device(device)
        p = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
            "mamba": tree_stack([
                stack_init(gen, cfg, per, init_fn=mamba_init, device=device)
                for _ in range(n_groups)]),
            "shared": block_init(gen, cfg, device),   # the ONE shared attn block
            "ln_f": norm_init(cfg, device=device),
        }
        if not cfg.tie_embeddings:
            p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                                   device=device)
        return p

    def _group(p_shared, gp, x, positions, gcache):
        """one group: per mamba layers + shared attn application."""
        if gcache is None:
            x, _ = scan_layers(lambda x, lp, _: mamba_apply(lp, cfg, x), x, gp,
                               remat=False)
            x, _ = block_apply(p_shared, cfg, x, positions=positions)
            return x, None

        def mbody(x, lp, lc):
            if x.shape[1] == 1:
                return mamba_decode_step(lp, cfg, x, lc)
            return mamba_apply(lp, cfg, x, return_state=True)

        x, mc = scan_layers(mbody, x, gp, gcache["mamba"], remat=False)
        x, nac = block_apply(p_shared, cfg, x, positions=positions,
                             cache=gcache["attn"])
        return x, {"mamba": mc, "attn": nac}

    def _run(p, x, positions, cache=None):
        return scan_layers(
            lambda x, gp, gc: _group(p["shared"], gp, x, positions, gc),
            x, p["mamba"], cache)

    def forward(p, batch):
        x = _embed_tokens(p, batch["tokens"])
        x, _ = _run(p, x, _arange(x))
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), 0.0

    def init_cache(batch, max_len, device=None):
        mamba = _broadcast_state(mamba_init_state(cfg, batch, device),
                                 (n_groups, per))
        attn = kv_cache_init((n_groups,), batch, max_len, cfg, device)
        return {"mamba": mamba, "attn": attn}

    def prefill(p, batch, cache):
        x = _embed_tokens(p, batch["tokens"])
        x, nc = _run(p, x, _arange(x), cache)
        x = norm_apply(cfg, p["ln_f"], x[:, -1:])
        return _head(p, cfg, x), nc

    def decode_step(p, token, pos, cache):
        x = _embed_tokens(p, token)
        x, nc = _run(p, x, positions_at(pos, x.device), cache)
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), nc

    return Model(cfg, init_params, forward, init_cache, prefill, decode_step)


# ================================================================= VLM family

def _cross_block_init(gen, cfg: ArchConfig, device=None):
    dev = resolve_device(device)
    return {
        "ln1": norm_init(cfg, device=dev),
        "attn": attn_init(gen, cfg, dev),
        "ln2": norm_init(cfg, device=dev),
        "mlp": mlp_init(gen, cfg, dev),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=dev),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=dev),
    }


def _cross_block_apply(p, cfg, x, kv_x=None, kv_cache=None):
    """Gated cross-attention block (llama-3.2-vision style).

    kv_x: image embeddings (prefill/train); kv_cache: precomputed (k, v),
    which wins when given.
    """
    h = norm_apply(cfg, p["ln1"], x)
    B, S, D = x.shape
    hd = cfg.d_head
    q = split_heads(dense(p["attn"]["wq"], h), cfg.n_heads)
    if kv_cache is None:
        k = split_heads(dense(p["attn"]["wk"], kv_x), cfg.n_kv_heads)
        v = split_heads(dense(p["attn"]["wv"], kv_x), cfg.n_kv_heads)
    else:
        k, v = kv_cache["k"], kv_cache["v"]
    o = chunked_attention(q, k, v, causal=False)
    y = dense(p["attn"]["wo"], o.reshape(B, S, cfg.n_heads * hd))
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * y
    y = mlp_fn(cfg)(p["mlp"], norm_apply(cfg, p["ln2"], x))
    x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * y
    return x, {"k": k, "v": v}


def _build_vlm(cfg: ArchConfig) -> Model:
    per = cfg.cross_attn_every - 1   # self layers per group
    n_groups = cfg.n_layers // cfg.cross_attn_every

    def init_params(gen, device=None):
        device = resolve_device(device)
        return {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
            "self": tree_stack([stack_init(gen, cfg, per, device=device)
                                for _ in range(n_groups)]),
            "cross": stack_init(gen, cfg, n_groups, init_fn=_cross_block_init,
                                device=device),
            "ln_f": norm_init(cfg, device=device),
            "head": dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                               device=device),
        }

    def _group(gp, x, positions, images, gcache):
        def body(x, bp, bc):
            return block_apply(bp, cfg, x, positions=positions, cache=bc)

        if gcache is None:
            x, _ = scan_layers(body, x, gp["self"], remat=False)
            x, _ = _cross_block_apply(gp["cross"], cfg, x, kv_x=images)
            return x, None
        # with a cache, the cross KV comes from it (prefill included)
        x, sc = scan_layers(body, x, gp["self"], gcache["self"], remat=False)
        x, kv = _cross_block_apply(gp["cross"], cfg, x, kv_x=images,
                                   kv_cache=gcache["cross"])
        return x, {"self": sc, "cross": kv}

    def _run(p, x, positions, images, cache=None):
        return scan_layers(
            lambda x, gp, gc: _group(gp, x, positions, images, gc),
            x, {"self": p["self"], "cross": p["cross"]}, cache)

    def forward(p, batch):
        x = _embed_tokens(p, batch["tokens"])
        images = batch["images"].to(torch.bfloat16)  # (B, n_img, D) stub
        x, _ = _run(p, x, _arange(x), images)
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), 0.0

    def init_cache(batch, max_len, device=None):
        kv = kv_cache_init((n_groups, per), batch, max_len, cfg, device)
        cross = kv_cache_init((n_groups,), batch, cfg.n_image_tokens, cfg,
                              device)
        del cross["len"]
        return {"self": kv, "cross": cross}

    def prefill(p, batch, cache):
        x = _embed_tokens(p, batch["tokens"])
        images = batch["images"].to(torch.bfloat16)
        x, nc = _run(p, x, _arange(x), images, cache)
        x = norm_apply(cfg, p["ln_f"], x[:, -1:])
        return _head(p, cfg, x), nc

    def decode_step(p, token, pos, cache):
        x = _embed_tokens(p, token)
        # no images: the cross KV is read from the cache
        x, nc = _run(p, x, positions_at(pos, x.device), None, cache)
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), nc

    return Model(cfg, init_params, forward, init_cache, prefill, decode_step)


# ============================================================== encdec family

def _build_encdec(cfg: ArchConfig) -> Model:
    """whisper-style: bidirectional encoder over stub frame embeddings,
    causal decoder with per-layer cross attention."""

    def _dec_block_init(gen, cfg, device=None):
        return {
            "ln1": norm_init(cfg, device=device),
            "self": attn_init(gen, cfg, device),
            "ln_x": norm_init(cfg, device=device),
            "cross": attn_init(gen, cfg, device),
            "ln2": norm_init(cfg, device=device),
            "mlp": mlp_init(gen, cfg, device),
        }

    def init_params(gen, device=None):
        device = resolve_device(device)
        return {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
            "enc": stack_init(gen, cfg, cfg.n_enc_layers, device=device),
            "ln_enc": norm_init(cfg, device=device),
            "dec": stack_init(gen, cfg, cfg.n_layers, init_fn=_dec_block_init,
                              device=device),
            "ln_f": norm_init(cfg, device=device),
            "head": dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                               device=device),
        }

    def encode(p, frames):
        x = frames.to(torch.bfloat16) + _sinusoid(frames.shape[1], cfg.d_model,
                                                  frames.device)
        x, _ = scan_layers(
            lambda x, bp, _: block_apply(bp, cfg, x, causal=False,
                                         use_rope=False),
            x, p["enc"])
        return norm_apply(cfg, p["ln_enc"], x)

    def _cross_from_kv(ap, x, kv):
        B, S, D = x.shape
        q = split_heads(dense(ap["wq"], x), cfg.n_heads)
        o = chunked_attention(q, kv["k"], kv["v"], causal=False)
        return dense(ap["wo"], o.reshape(B, S, cfg.n_heads * cfg.d_head))

    def _dec_block(bp, x, mem, positions, self_cache=None, cross_kv=None):
        h, sc = attn_apply(bp["self"], cfg, norm_apply(cfg, bp["ln1"], x),
                           positions=positions, use_rope=False,
                           cache=self_cache)
        x = x + h
        if cross_kv is not None:
            x2 = _cross_from_kv(bp["cross"], norm_apply(cfg, bp["ln_x"], x),
                                cross_kv)
        else:
            x2, _ = attn_apply(bp["cross"], cfg, norm_apply(cfg, bp["ln_x"], x),
                               kv_x=mem, causal=False, use_rope=False)
        x = x + x2
        x = x + mlp_fn(cfg)(bp["mlp"], norm_apply(cfg, bp["ln2"], x))
        return x, sc

    def _embed_dec(p, tokens):
        return _embed_tokens(p, tokens) + _sinusoid(tokens.shape[1],
                                                    cfg.d_model, tokens.device)

    def forward(p, batch):
        mem = encode(p, batch["frames"])
        x = _embed_dec(p, batch["tokens"])
        x, _ = scan_layers(
            lambda x, bp, _: _dec_block(bp, x, mem, _arange(x)), x, p["dec"])
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), 0.0

    def init_cache(batch, max_len, device=None):
        cross = kv_cache_init((cfg.n_layers,), batch, cfg.n_frames, cfg, device)
        del cross["len"]
        return {"self": kv_cache_init((cfg.n_layers,), batch, max_len, cfg,
                                      device),
                "cross": cross}

    def _run_cached(p, x, positions, self_cache, cross):
        def body(x, layer, sc):
            return _dec_block(layer["bp"], x, None, positions, self_cache=sc,
                              cross_kv=layer["kv"])

        return scan_layers(body, x, {"bp": p["dec"], "kv": cross}, self_cache)

    def prefill(p, batch, cache):
        mem = encode(p, batch["frames"])
        # precompute per-layer cross KV once (decode reuses it)
        stack = CacheStack(cfg.n_layers)
        for i in range(cfg.n_layers):
            ap = tree_index(p["dec"]["cross"], i)
            stack.put(i, {
                "k": split_heads(dense(ap["wk"], mem), cfg.n_kv_heads),
                "v": split_heads(dense(ap["wv"], mem), cfg.n_kv_heads)})
        cross = stack.value()
        x = _embed_dec(p, batch["tokens"])
        x, sc = _run_cached(p, x, _arange(x), cache["self"], cross)
        x = norm_apply(cfg, p["ln_f"], x[:, -1:])
        return _head(p, cfg, x), {"self": sc, "cross": cross}

    def decode_step(p, token, pos, cache):
        x = _embed_tokens(p, token) + _sinusoid_at(pos, cfg.d_model, token.device)
        x, sc = _run_cached(p, x, positions_at(pos, x.device), cache["self"],
                            cache["cross"])
        x = norm_apply(cfg, p["ln_f"], x)
        return _head(p, cfg, x), {"self": sc, "cross": cache["cross"]}

    return Model(cfg, init_params, forward, init_cache, prefill, decode_step)


# ==================================================================== builder

_BUILDERS = {
    "dense": _build_dense,
    "moe": _build_moe,
    "ssm": _build_ssm,
    "hybrid": _build_hybrid,
    "vlm": _build_vlm,
    "encdec": _build_encdec,
}


def _scoped(fn):
    """``fn`` under :func:`sharded_scope` of its arguments."""
    @functools.wraps(fn)
    def call(*args):
        with sharded_scope(*args):
            return fn(*args)
    return call


def build_model(cfg: ArchConfig) -> Model:
    try:
        build = _BUILDERS[cfg.family]
    except KeyError:
        raise KeyError(f"unknown family {cfg.family!r}")
    m = build(cfg)
    return dataclasses.replace(m, forward=_scoped(m.forward),
                               prefill=_scoped(m.prefill),
                               decode_step=_scoped(m.decode_step))
