"""Dense decoder transformer family (minitron / phi3 / h2o-danube / qwen3)
plus the attention/FFN block primitives reused by the MoE, hybrid, VLM and
enc-dec families (the port of ``repro.models.transformer``).

Stacked layer params keep their leading ``(n_layers, ...)`` axis, and a
Python loop over the layers (:func:`scan_layers`) takes the place of
``jax.lax.scan``: each layer gets views of the stacked tensors, taken by
one ``unbind(0)`` per stack, whose backward stacks the layers' grads
once (a ``t[i]`` per layer would write a zero tensor of the whole stack
per layer).  Under autograd each layer body runs under
``torch.utils.checkpoint`` (``jax.checkpoint`` around the JAX scan
body): the backward recomputes a layer instead of keeping its
activations.  Caches keep the same stacked layout; a scan writes each
layer's new cache into one stacked tree as the layer returns it
(:class:`CacheStack`), as ``lax.scan`` writes its stacked output, so it
holds one new cache, not a list of them beside their stack.

Caches are values, as in JAX: ``prefill`` and ``decode_step`` return a
new cache and never write a tensor of the cache they were given, so a
caller may keep and reuse it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from .layers import (
    _GradPlaced, _head_placements, _tracks_grad, all_gather, all_to_all,
    chunked_attention, column_chunk, constrain_acts, decode_attention, dense,
    dense_init, embed_init, gather_chunks, gelu_mlp, gelu_mlp_init,
    is_dtensor, kv_groups, layernorm, layernorm_init, length_dims,
    local_region, model_dim, move_shard, remat_call, rmsnorm, rmsnorm_init,
    rope, rows_times_split_weight, shard_index, shard_offset,
    split_kv_attend, swiglu, swiglu_init,
)

__all__ = [
    "attn_init", "attn_apply", "block_init", "block_apply",
    "norm_init", "norm_apply", "mlp_init", "mlp_apply",
    "stack_init", "dense_params_init", "dense_forward", "dense_init_cache",
    "dense_decode_step", "dense_prefill", "kv_cache_init", "positions_at",
    "tree_map", "tree_leaves", "tree_index", "tree_unbind", "tree_stack",
    "CacheStack", "scan_layers", "embed_lookup",
]


# ------------------------------------------------------------- param trees

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (all of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in ``jax.tree.leaves`` order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, not copies."""
    return tree_map(lambda t: t[i], tree)


def tree_unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree: views, one ``unbind(0)`` per
    stacked leaf."""
    if isinstance(tree, dict):
        kids = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: kids[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def tree_stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


class _StackedLeaf:
    """``n`` layers' tensors like ``t`` in one stacked tensor, allocated
    once; :meth:`put` copies a layer's into its slice.  Where ``t`` is a
    DTensor the stack keeps its placements (the stack dim whole): the
    layers' local tensors are written into one local buffer."""

    def __init__(self, t, n: int):
        self.dt = None
        if is_dtensor(t):
            self.dt = (t.device_mesh, tuple(t.placements), (n, *t.shape))
            t = t.to_local()
        self.buf = t.new_empty((n, *t.shape))

    def put(self, i: int, t) -> None:
        if self.dt is not None:
            mesh, pl, _ = self.dt
            if tuple(t.placements) != pl:
                t = t.redistribute(mesh, pl)
            t = t.to_local()
        self.buf[i].copy_(t)

    def value(self):
        if self.dt is None:
            return self.buf
        from torch.distributed.tensor import DTensor, Shard

        mesh, pl, shape = self.dt
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * max(shape[d + 1], 1)
        return DTensor.from_local(
            self.buf, mesh, [Shard(q.dim + 1) if q.is_shard() else q
                             for q in pl],
            run_check=False, shape=torch.Size(shape), stride=tuple(stride))


class CacheStack:
    """The new caches of ``n`` layers as one stacked tree, each layer's
    written into its slice as it comes (``torch.stack`` of a list would
    hold every layer's beside the stack: two new caches at the end)."""

    def __init__(self, n: int):
        self.n = n
        self.leaves = None

    def put(self, i: int, tree) -> None:
        if self.leaves is None:
            self.leaves = tree_map(lambda t: _StackedLeaf(t, self.n), tree)
        tree_map(lambda s, t: s.put(i, t), self.leaves, tree)

    def value(self):
        return tree_map(lambda s: s.value(), self.leaves)


def scan_layers(body, x, params, cache=None, remat: bool = True):
    """``x`` through ``body(x, layer_params, layer_cache)`` for every layer
    of the stacked ``params``; returns ``(x, stacked new caches)``, the
    second None when ``cache`` is None.  With ``remat``, each layer runs
    under :func:`remat_call`.  Each layer's new cache goes into a
    :class:`CacheStack` at once; ``cache`` is never written."""
    n = _n_stacked(params)
    layers = tree_unbind(params, n)
    caches = [None] * n if cache is None else tree_unbind(cache, n)
    new = None if cache is None else CacheStack(n)
    for i, (lp, lc) in enumerate(zip(layers, caches)):
        x, c = remat_call(body, x, lp, lc, remat=remat)
        if new is not None:
            new.put(i, c)
        del c
    return x, (None if new is None else new.value())


def positions_at(pos, device) -> torch.Tensor:
    """The (1,) position tensor of one decode step at ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device).reshape(-1)
    return torch.full((1,), pos, device=device)   # no host-to-device copy


# ---------------------------------------------------------------- primitives

def norm_init(cfg: ArchConfig, d: Optional[int] = None, device=None):
    d = d or cfg.d_model
    return (rmsnorm_init(d, device) if cfg.norm == "rmsnorm"
            else layernorm_init(d, device))


def norm_apply(cfg: ArchConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def mlp_init(gen, cfg: ArchConfig, device=None):
    if cfg.mlp == "swiglu":
        return swiglu_init(gen, cfg.d_model, cfg.d_ff, device)
    return gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device)


def mlp_fn(cfg: ArchConfig):
    """The MLP function of ``cfg``: ``mlp_fn(cfg)(p, x)`` hands ``x`` to
    it alone, which lets it go once projected."""
    return swiglu if cfg.mlp == "swiglu" else gelu_mlp


def mlp_apply(cfg: ArchConfig, p, x):
    return mlp_fn(cfg)(p, x)


def attn_init(gen, cfg: ArchConfig, device=None):
    d, hd = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, device=device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, device=device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, device=device),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd, device)
        p["knorm"] = rmsnorm_init(hd, device)
    return p


def attn_apply(
    p,
    cfg: ArchConfig,
    x: torch.Tensor,                   # (B, S, D) queries source
    kv_x: Optional[torch.Tensor] = None,  # cross-attn memory (B, Sk, D) or None
    positions: Optional[torch.Tensor] = None,  # (S,) absolute positions of x
    causal: bool = True,
    use_rope: bool = True,
    cache=None,                        # dict(k, v, len) or None
    window: Optional[int] = None,
):
    """Self- or cross-attention.  Returns (y, new_cache).

    Cache modes:
    * cache None, kv from x           -> training / one-shot forward
    * cache given, S > 1              -> prefill (cache is filled)
    * cache given, S == 1             -> decode (ring-buffer write + attend)

    The new cache is a new tensor; ``cache`` is never written.
    """
    B, S, D = x.shape
    hd = cfg.d_head
    self_kv = kv_x is None
    src = x if self_kv else kv_x
    q = dense(p["wq"], x)
    k = dense(p["wk"], src)
    v = dense(p["wv"], src)
    del x, src, kv_x   # read: a caller's norm output need not outlive them
    norms = (p["qnorm"], p["knorm"]) if cfg.qk_norm else None
    core = functools.partial(_attn_core, hd=hd, theta=cfg.rope_theta,
                             causal=causal, use_rope=use_rope, window=window,
                             self_kv=self_kv)
    if is_dtensor(q) and cache is not None and S == 1 and length_dims(
            cache["k"]):
        o, new_cache = _split_kv_decode(core, cfg, q, k, v, norms, positions,
                                        cache, window)
    elif is_dtensor(q):
        o, new_cache = _sharded_attn_core(core, cfg, q, k, v, norms,
                                          positions, cache)
    else:
        o, new_cache = core(q, k, v, norms, positions, cache)
    y = dense(p["wo"], o.reshape(B, S, cfg.n_heads * hd))
    return y, new_cache


def _qkv_heads(q, k, v, norms, positions, *, hd: int, theta: float,
               use_rope: bool, self_kv: bool, q_offset: int = 0):
    """q (B, S, H·hd), k/v (B, Skv, G·hd) -> (B, S, H, hd), (B, Skv, G,
    hd) x 2 and the positions, after the qk norms and the rotary
    embedding; q's rows are those at ``positions[q_offset:]``."""
    B, S = q.shape[:2]
    Skv = k.shape[1]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, Skv, -1, hd)
    v = v.reshape(B, Skv, -1, hd)
    if norms is not None:
        q = rmsnorm(norms[0], q)
        k = rmsnorm(norms[1], k)
    if positions is None:
        positions = torch.arange(q_offset + S, device=q.device)
    if use_rope:
        q = rope(q, positions[q_offset:q_offset + S], theta)
        if self_kv:
            k = rope(k, positions[:Skv], theta)
    return q, k, v, positions


def _ring_slot(pos, L: int, window):
    """The cache slot of position ``pos`` (a ring where ``window``)."""
    return pos % L if window is not None else torch.clamp(pos, max=L - 1)


def _write_rows(c, idx, x, off=None):
    """``c`` (B, L, ...) with rows ``x`` written at entries ``idx``; with
    ``off``, ``c`` is the slice from entry ``off`` of a longer cache, and
    rows that fall outside it are dropped (written to a spare row that
    is cut off)."""
    if off is None:
        return c.index_copy(1, idx, x)
    Ll = c.shape[1]
    j = idx - off
    j = torch.where((j >= 0) & (j < Ll), j, Ll)
    return torch.cat([c, c[:, :1]], dim=1).index_copy(1, j, x)[:, :Ll]


def _attn_core(q, k, v, norms, positions, cache, *, hd: int, theta: float,
               causal: bool, use_rope: bool, window, self_kv: bool,
               groups=None, q_offset: int = 0, cache_slice=None):
    """Attention after the projections: q (B, S, H·hd), k/v (B, Skv,
    G·hd) -> (o (B, S, H, hd), new cache).  ``groups=(g0, g1)``: attend
    with kv groups g0..g1-1 only (this rank's query heads'), after the
    cache took every group.  ``q_offset``: q holds the rows from there
    on (this rank's of a sequence split), k/v and ``positions`` all.
    ``cache_slice=(off, L)``: a prefill's cache is this rank's slice,
    from entry ``off``, of a cache of ``L`` entries (a length split)."""
    S = q.shape[1]
    q, k, v, positions = _qkv_heads(q, k, v, norms, positions, hd=hd,
                                    theta=theta, use_rope=use_rope,
                                    self_kv=self_kv, q_offset=q_offset)

    def attend_groups(k, v):
        return (k, v) if groups is None else (k[:, :, groups[0]:groups[1]],
                                              v[:, :, groups[0]:groups[1]])

    new_cache = cache
    if cache is not None and S == 1:
        # decode: ring-buffer write at pos % cache_size
        L = cache["k"].shape[1]
        pos = cache["len"]
        idx = _ring_slot(pos, L, window).reshape(1).long()
        ck = cache["k"].index_copy(1, idx, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy(1, idx, v.to(cache["v"].dtype))
        o = decode_attention(q, *attend_groups(ck, cv),
                             torch.clamp(pos + 1, max=L))
        new_cache = {"k": ck, "v": cv, "len": pos + 1}
    else:
        if cache is not None:
            # prefill: write the (possibly windowed) KV tail into the cache
            Ll = cache["k"].shape[1]
            off, L = cache_slice or (0, Ll)
            kt = k[:, -L:].to(cache["k"].dtype)
            vt = v[:, -L:].to(cache["v"].dtype)
            nt = kt.shape[1]
            if window is not None:
                # ring layout: entry for absolute position p lives at p % L
                idx = (positions[-nt:] % L).long()
                at = None if cache_slice is None else off
                ck = _write_rows(cache["k"], idx, kt, at)
                cv = _write_rows(cache["v"], idx, vt, at)
            elif nt == L:   # the tail is the whole cache
                ck, cv = kt, vt
                if cache_slice is not None:   # this rank's slice of it
                    ck = kt[:, off:off + Ll].clone()
                    cv = vt[:, off:off + Ll].clone()
            else:
                ck = cache["k"].clone()
                cv = cache["v"].clone()
                hi = min(off + Ll, nt)
                if hi > off:
                    ck[:, :hi - off] = kt[:, off:hi]
                    cv[:, :hi - off] = vt[:, off:hi]
            new_cache = {"k": ck, "v": cv,
                         "len": cache["len"] + positions.shape[0]}
        o = chunked_attention(q, *attend_groups(k, v), causal=causal,
                              window=window, q_offset=q_offset)
    return o, new_cache


def _sharded_attn_core(core, cfg: ArchConfig, q, k, v, norms, positions,
                       cache):
    """:func:`_attn_core` on DTensor projections as one head-parallel
    region: each rank takes its batch rows and query heads (with every kv
    group where the kv heads do not split over "model", so the cache
    stays whole on each rank), the cache with its full length, or, in a
    prefill, with the length as the cache splits it (each rank writes the
    prompt's entries that fall in its slice); the new cache goes back to
    the cache's own placements.  Where the query heads do not split over
    "model", its ranks take query rows instead (sequence-parallel
    attention, the reference's q-chunk sharding)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    H, G = cfg.n_heads, cfg.n_kv_heads
    q_pl, kv_pl, t, kv_rep = _head_placements(mesh, q.shape[0], H, G)
    rep = (Replicate(),) * mesh.ndim
    leaves = [] if cache is None else [cache["k"], cache["v"], cache["len"]]
    back = [c.placements for c in leaves]
    S, n_t = q.shape[1], 1 if t is None else mesh.size(t)
    ldims = length_dims(cache["k"]) if cache is not None and S > 1 else []
    c_pl = tuple(Shard(1) if i in ldims else p_ for i, p_ in enumerate(kv_pl))
    seq = n_t > 1 and H % n_t != 0 and S > 1 and S % n_t == 0
    # neither the heads nor the rows split evenly (no cache): each rank
    # of "model" takes its uneven chunk of the query rows (``torch.chunk``'s,
    # the last ones shorter or empty) and gathers the output's
    rows = (n_t > 1 and H % n_t != 0 and S > 1 and S % n_t != 0
            and cache is None)
    if seq:
        # the heads do not split over "model": its ranks split the query
        # rows instead, each with the whole kv (gathered once a layer)
        q_pl = tuple(Shard(1) if i == t else p_ for i, p_ in enumerate(kv_pl))
        if q.placements[t].is_shard(2):
            q = move_shard(q, t, 2, 1)

    def local(ql, kl, vl, nq, nk, pos, *cl):
        groups = None
        if kv_rep and not seq:
            groups = kv_groups(mesh, t, ql.shape[-1] // cfg.d_head, H // G)
        lc = None if not cl else {"k": cl[0], "v": cl[1], "len": cl[2]}
        part = None
        if ldims:
            j, n = shard_index(mesh, ldims)
            part = (j * cl[0].shape[1], n * cl[0].shape[1])
        off = mesh.get_local_rank(t) * ql.shape[1] if seq else 0
        if rows:
            r0, r1, _ = column_chunk(S, mesh, t)
            # an empty chunk attends the last row, its output cut: every
            # rank's kv gets a gradient, if only a zero one
            off = min(r0, S - 1)
            ql = ql[:, off:off + max(r1 - r0, 1)]
        o, nc = core(ql, kl, vl, None if nq is None else (nq, nk), pos, lc,
                     groups=groups, q_offset=off, cache_slice=part)
        if seq:   # (B, S/n, H·hd), to leave split along H·hd (all-to-all)
            o = o.reshape(*o.shape[:2], -1)
        if rows:
            o = gather_chunks(o[:, :r1 - r0], 1, S, mesh, t)
        return (o,) if nc is None else (o, nc["k"], nc["v"], nc["len"])

    def pl_of(x, pl):
        return pl if is_dtensor(x) else None

    args = (q, k, v, *(norms or (None, None)), positions, *leaves)
    in_pl = (q_pl, kv_pl, kv_pl, *(pl_of(n, rep) for n in (norms or (None, None))),
             pl_of(positions, rep), *((c_pl, c_pl, rep) if leaves else ()))
    out = local_region(local, args, in_pl,
                       (q_pl,) + ((c_pl, c_pl, rep) if leaves else ()), mesh,
                       partial_grads=(t,) if rows else ())
    o = out[0]
    if seq and o.shape[-1] % n_t == 0:
        o = move_shard(o, t, 1, 2)
    if not leaves:
        return o, None
    nc = {key: x.redistribute(mesh, pl)
          for key, x, pl in zip(("k", "v", "len"), out[1:], back)}
    return o, nc


def _split_kv_decode(core, cfg: ArchConfig, q, k, v, norms, positions,
                     cache, window):
    """A decode step against a cache whose length is sharded (the rules'
    split-KV fallback: length over "model" where the kv heads do not
    divide it, or over the data axes where the batch does not) as one
    region that takes the cache's placements as they are: its batch,
    length, kv heads or head_dim each split where the cache splits
    them.  q, k and v enter split as the cache's batch and heads are;
    each rank takes its slice of head_dim, writes the new token's k/v
    only where its slice of the length holds the slot, and attends over
    its slice; the partials merge over the length's mesh dims, and over
    head_dim's, a partial dot product, where head_dim is split
    (:func:`split_kv_attend`).  The cache keeps its placements."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    kw = core.keywords
    ldims = length_dims(cache["k"])
    hdims = length_dims(cache["k"], 3)
    c_pl = cache["k"].placements
    # batch and kv heads as the cache splits them (the heads of q follow
    # their kv groups'), head_dim whole: each rank slices its own
    b_pl = tuple(Shard(0) if q_.is_shard(0) else
                 Shard(2) if q_.is_shard(2) else Replicate() for q_ in c_pl)
    rep = (Replicate(),) * mesh.ndim

    def local(ql, kl, vl, nq, nk, pos, ck, cv, n):
        ql, kl, vl, _ = _qkv_heads(
            ql, kl, vl, None if nq is None else (nq, nk), pos, hd=kw["hd"],
            theta=kw["theta"], use_rope=kw["use_rope"],
            self_kv=kw["self_kv"])
        if hdims:
            h0 = shard_offset(ql.shape[-1], mesh, hdims)
            hl = ck.shape[-1]
            ql, kl, vl = (x[..., h0:h0 + hl] for x in (ql, kl, vl))
        Ll = ck.shape[1]
        j, nl = shard_index(mesh, ldims)
        local_pos = torch.arange(Ll, device=ck.device) + j * Ll
        idx = (_ring_slot(n, Ll * nl, window) - j * Ll).reshape(1).long()
        mine = (idx >= 0) & (idx < Ll)
        idx = idx.clamp(0, Ll - 1)

        def write(c, x):
            x = torch.where(mine[:, None, None], x.to(c.dtype),
                            c.index_select(1, idx))
            return c.index_copy(1, idx, x)

        ck, cv = write(ck, kl), write(cv, vl)
        valid = local_pos < torch.clamp(n + 1, max=Ll * nl)
        o = split_kv_attend(ql, ck, cv, valid, mesh, ldims, hdims)
        return o, ck, cv, n + 1

    def pl_of(x, pl):
        return pl if is_dtensor(x) else None

    args = (q, k, v, *(norms or (None, None)), positions, cache["k"],
            cache["v"], cache["len"])
    in_pl = (b_pl, b_pl, b_pl,
             *(pl_of(x, rep) for x in (norms or (None, None))),
             pl_of(positions, rep), c_pl, c_pl, pl_of(cache["len"], rep))
    o, ck, cv, n = local_region(local, args, in_pl, (b_pl, c_pl, c_pl, rep),
                                mesh)
    return o, {"k": ck, "v": cv, "len": n}


def block_init(gen, cfg: ArchConfig, device=None):
    return {
        "ln1": norm_init(cfg, device=device),
        "attn": attn_init(gen, cfg, device),
        "ln2": norm_init(cfg, device=device),
        "mlp": mlp_init(gen, cfg, device),
    }


def block_apply(p, cfg: ArchConfig, x, positions=None, cache=None,
                causal=True, window=None, kv_x=None, use_rope=True):
    # each norm output goes straight into the call that reads it, and
    # the attention output goes once added: none outlives its readers
    h, new_cache = attn_apply(
        p["attn"], cfg, norm_apply(cfg, p["ln1"], x), kv_x=kv_x,
        positions=positions, causal=causal, cache=cache, window=window,
        use_rope=use_rope,
    )
    x = constrain_acts(x + h)
    del h
    x = constrain_acts(x + mlp_fn(cfg)(p["mlp"], norm_apply(cfg, p["ln2"], x)))
    return x, new_cache


# ------------------------------------------------------------- dense stacks

def stack_init(gen, cfg: ArchConfig, n: int, init_fn=block_init, device=None):
    return tree_stack([init_fn(gen, cfg, device) for _ in range(n)])


def dense_params_init(gen, cfg: ArchConfig, device=None):
    device = resolve_device(device)
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device),
        "blocks": stack_init(gen, cfg, cfg.n_layers, device=device),
        "ln_f": norm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                               device=device)
    return p


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; on a DTensor table, a vocab-parallel region."""
    if is_dtensor(embed):
        return _sharded_embed(_table(embed), tokens)
    return embed[tokens]


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return constrain_acts(embed_lookup(p["embed"], tokens).to(torch.bfloat16))


def _sharded_embed(embed, tokens):
    """The embedding lookup on a DTensor (V, D) table as a vocab-parallel
    region (Megatron's): each rank looks its tokens up in the vocab rows
    it holds over "model" (zeros for the others, summed over "model");
    the tokens' batch rows stay where they are.  The table is gathered
    over the data axes, which split its ``D`` side (FSDP), unless a few
    tokens at inference go to the table instead (:func:`_moves_tokens`):
    then every rank looks the tokens up in its slice of ``D`` and the
    rows' slices come back by an all-to-all (tokens split over "data")
    or an all-gather.  DTensor's own gather and its backward
    (``index_put``) fail on a sharded table."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = embed.device_mesh
    names = list(mesh.mesh_dim_names or ())
    V = embed.shape[0]
    e_pl = [Replicate()] * mesh.ndim
    o_pl = [Replicate()] * mesh.ndim
    t_pl = None
    t = names.index("model") if "model" in names else None
    split = t is not None and mesh.size(t) > 1 and V % mesh.size(t) == 0
    if split:
        e_pl[t], o_pl[t] = Shard(0), Partial()
    if is_dtensor(tokens):
        t_pl = [Replicate()] * mesh.ndim
        dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
        if dp and tokens.shape[0] % math.prod(mesh.size(i) for i in dp) == 0:
            for i in dp:
                t_pl[i] = o_pl[i] = Shard(0)
    f = None
    if _moves_tokens(embed, tokens, 1, split, t_pl):
        f = next(iter(length_dims(embed, 1)), None)
        if f is not None:
            e_pl[f] = Shard(1)
    rows_split = f is not None and t_pl is not None and t_pl[f].is_shard(0)

    def lookup(e, tok):
        if not split:
            return e[tok]
        v0 = mesh.get_local_rank(t) * e.shape[0]
        idx = tok.long() - v0
        own = (idx >= 0) & (idx < e.shape[0])
        rows = e[idx.clamp(0, e.shape[0] - 1)]
        return rows * own[..., None].to(rows.dtype)

    def local(e, tok):
        if f is None:
            return lookup(e, tok)
        if rows_split:
            rows = lookup(e, all_gather(tok, 0, mesh, [f]))
            return all_to_all(rows, 0, rows.ndim - 1, mesh, f)
        rows = lookup(e, tok)
        return all_gather(rows, rows.ndim - 1, mesh, [f])

    out = local_region(local, (embed, tokens),
                       (tuple(e_pl), None if t_pl is None else tuple(t_pl)),
                       (tuple(o_pl),), mesh)
    return out.redistribute(mesh, [Replicate() if q.is_partial() else q
                                   for q in out.placements])


def _moves_tokens(w, x, d_dim: int, vocab_split: bool, x_pl) -> bool:
    """Does an inference read of the DTensor table or head ``w`` by
    ``x`` (tokens, or the head's rows) move ``x`` to ``w``'s ``D`` split
    (dim ``d_dim``) rather than gather ``w``?  Where ``x`` has fewer rows
    than the vocab and no autograd records the read, and where the
    gather would bring each rank the whole of ``w`` (the vocab not split
    over "model") or the same slice for the same rows on every data rank
    (``x`` not split over the data axes)."""
    if torch.is_grad_enabled() and _tracks_grad((w, x)):
        return False
    if (not length_dims(w, d_dim)
            or math.prod(x.shape[:2]) >= w.shape[1 - d_dim]):
        return False
    rows_split = x_pl is not None and any(q.is_shard(0) for q in x_pl)
    return not vocab_split or not rows_split


def head_logits(p, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return _head_product(p["embed"], x, 0)
    return _head_product(p["head"], x, 1)


def _head_product(w, x, v_dim: int):
    """The logits ``x @ w`` (the head, (D, V): ``v_dim`` 1) or ``x @
    w.T`` (a tied table, (V, D): ``v_dim`` 0).  On DTensors where the
    vocab does not split over "model" and a few rows at inference read
    ``w`` (:func:`_moves_tokens`), one vocab-parallel region: each rank
    of "model" takes its uneven chunk of the vocab (``torch.chunk``'s),
    the rows go to ``w``'s ``D`` split
    (:func:`rows_times_split_weight`), and the logits' chunks are
    gathered over "model"; ``w`` is never gathered.  Else :func:`dense`."""
    from torch.distributed.tensor import Replicate, Shard

    w_t = _table(w).T if v_dim == 0 else w
    if not (is_dtensor(x) and is_dtensor(w)):
        return dense(w_t, x)
    mesh = w.device_mesh
    t = model_dim(mesh)
    V = w.shape[v_dim]
    split = t is not None and mesh.size(t) > 1 and V % mesh.size(t) == 0
    names = list(mesh.mesh_dim_names or ())
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    rows = bool(dp) and x.shape[0] % math.prod(mesh.size(i) for i in dp) == 0
    x_pl = tuple(Shard(0) if rows and i in dp else Replicate()
                 for i in range(mesh.ndim))
    if split or not _moves_tokens(w, x, 1 - v_dim, False, x_pl):
        return dense(w_t, x)
    f = length_dims(w, 1 - v_dim)[0]
    if t is not None and mesh.size(t) == 1:
        t = None

    def local(xl, wl):
        wl = wl.T if v_dim == 0 else wl
        if t is not None:
            v0, v1, _ = column_chunk(V, mesh, t)
            wl = wl[:, v0:v1]
        y = rows_times_split_weight(xl, wl, mesh, f, x_pl[f].is_shard(0))
        return y if t is None else gather_chunks(y, y.ndim - 1, V, mesh, t)

    return local_region(local, (x, w), (x_pl, w.placements), (x_pl,), mesh)


def _table(embed):
    """A DTensor embedding table whose gradient comes back in the table's
    own placements.  A tied table's two gradients (the lookup's, partial
    over the data axes, and the head's) then add in one placement:
    torch 2.11's DTensor would turn the head's shard into a partial sum,
    which it cannot, where the vocab does not divide "model"."""
    return _GradPlaced.apply(embed) if is_dtensor(embed) else embed


def dense_forward(p, cfg: ArchConfig, tokens: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """(B, S) int tokens -> (B, S, V) logits.  Loop over layers + remat."""
    x = embed_tokens(p, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def body(x, layer_p, _):
        return block_apply(layer_p, cfg, x, positions=positions,
                           window=cfg.sliding_window)

    x, _ = scan_layers(body, x, p["blocks"], remat=remat)
    x = norm_apply(cfg, p["ln_f"], x)
    return head_logits(p, cfg, x)


def kv_cache_init(lead, batch: int, L: int, cfg: ArchConfig, device=None,
                  dtype=torch.bfloat16):
    """Zero KV cache with leading (stack) dims ``lead``."""
    dev = resolve_device(device)
    shape = tuple(lead) + (batch, L, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": torch.zeros(tuple(lead), dtype=torch.int32, device=dev),
    }


def dense_init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None,
                     dtype=torch.bfloat16):
    L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return kv_cache_init((cfg.n_layers,), batch, L, cfg, device, dtype)


def dense_prefill(p, cfg: ArchConfig, tokens: torch.Tensor, cache):
    """Prefill: run the full prompt, fill caches, return last-token logits."""
    x = embed_tokens(p, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def body(x, layer_p, layer_c):
        return block_apply(layer_p, cfg, x, positions=positions,
                           cache=layer_c, window=cfg.sliding_window)

    x, new_cache = scan_layers(body, x, p["blocks"], cache)
    x = norm_apply(cfg, p["ln_f"], x[:, -1:])
    return head_logits(p, cfg, x), new_cache


def dense_decode_step(p, cfg: ArchConfig, token: torch.Tensor, pos, cache):
    """One decode step.  token: (B, 1) -> logits (B, 1, V), updated cache."""
    x = embed_tokens(p, token)
    positions = positions_at(pos, x.device)

    def body(x, layer_p, layer_c):
        return block_apply(layer_p, cfg, x, positions=positions,
                           cache=layer_c, window=cfg.sliding_window)

    x, new_cache = scan_layers(body, x, p["blocks"], cache)
    x = norm_apply(cfg, p["ln_f"], x)
    return head_logits(p, cfg, x), new_cache
