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

Sharded runs.  The params may be DTensors (the launch layer places them
on a ``DeviceMesh``).  The models build fresh tensors beside them
(masks, positions, zeros), which DTensor refuses to mix with its own, so
every entry point runs under :func:`sharded_scope`: DTensor's implicit
replication of plain tensors, entered only when a leaf is a DTensor,
and only once however deeply the entry points nest.  The launch layer
registers sharding hooks here (:func:`set_activation_sharding`,
:func:`set_attention_sharding`) as the JAX package does; with nothing
registered, or on plain tensors, they do nothing.
"""
from __future__ import annotations

import contextlib
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
    "set_activation_sharding", "set_attention_sharding", "constrain_acts",
    "is_dtensor", "sharded_scope",
]

NEG_INF = -1e30   # the JAX package's mask value (and the running max's floor)


# --------------------------------------------------------------------------
# Sharded runs: DTensor params, and the launch layer's sharding hooks.

def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``?  (Never imports
    the distributed package for a plain tensor's sake.)"""
    return type(x).__name__ == "DTensor" and isinstance(x, torch.Tensor)


def _has_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_has_dtensor(v) for v in tree)
    return is_dtensor(tree)


_SCOPE = {"active": False}


@contextlib.contextmanager
def sharded_scope(*trees):
    """DTensor's ``implicit_replication`` (a plain tensor meeting a DTensor
    is taken as replicated on its mesh) while a leaf of ``trees`` is a
    DTensor, entered by the outermost caller only: the context is a
    switch, and an inner exit would turn it off under the outer one.
    On plain trees it does nothing."""
    if _SCOPE["active"] or not _has_dtensor(trees):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _SCOPE["active"] = True
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPE["active"] = False


# Activation-sharding hook: the launch layer can register placements that
# model code applies to (B, S, D) activations at layer boundaries (keeps
# models mesh-agnostic while anchoring activation shardings instead of
# leaving them to DTensor's propagation).  Registered as (mesh, placements).
_ACT_SHARDING = {"val": None}

# Attention q-chunk sharding: when kv heads don't divide the model axis,
# head-parallel attention replicates compute; sharding the *q-chunk* axis
# of chunked attention over "model" restores full parallelism.  Registered
# as ((mesh, placements) for the (nq, B, G, R, qc, Dh) stack, target nq).
_ATTN_SHARDING = {"val": None, "nq": None}


def set_activation_sharding(sharding) -> None:
    """Register ``(mesh, placements)`` for (B, S, D) activations (None to
    clear)."""
    _ACT_SHARDING["val"] = sharding


def set_attention_sharding(sharding, nq: Optional[int]) -> None:
    """Register q-chunk-axis ``(mesh, placements)`` for chunked attention
    and the q-chunk count to align to (None, None to clear)."""
    _ATTN_SHARDING["val"] = sharding
    _ATTN_SHARDING["nq"] = nq


def _redistribute(x, sharding):
    mesh, placements = sharding
    return x.redistribute(mesh, placements)


def constrain_acts(x: torch.Tensor) -> torch.Tensor:
    """A 3-D DTensor redistributed to the registered activation placements;
    anything else (no registration, a plain tensor) unchanged."""
    s = _ACT_SHARDING["val"]
    if s is not None and x.ndim == 3 and is_dtensor(x):
        return _redistribute(x, s)
    return x


def local_region(fn, args, in_placements, out_placements, mesh,
                 partial_grads=()):
    """``fn`` on each rank's local tensors (DTensor's ``local_map``): the
    DTensor ``args`` are redistributed to ``in_placements`` (None for a
    non-DTensor arg), the outputs are DTensors placed by
    ``out_placements`` (a tuple with one placements tuple per output).
    An input replicated over a mesh dim that another input is sharded on
    (or that ``partial_grads`` names: ``fn`` splits the work there
    itself) takes its gradient as a ``Partial`` sum there: each rank's
    local gradient is its share of the whole."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    in_placements = tuple(
        None if pl is None else one_rank_replicated(mesh.shape, pl)
        for pl in in_placements)
    out_placements = tuple(one_rank_replicated(mesh.shape, pl)
                           for pl in out_placements)
    split = {i for pl in in_placements if pl is not None
             for i, q in enumerate(pl) if q.is_shard()} | set(partial_grads)
    grads = tuple(
        None if pl is None else tuple(
            q if q.is_shard() else (Partial() if i in split else Replicate())
            for i, q in enumerate(pl))
        for pl in in_placements)
    # an input that is a partial mean (or max) and takes a partial-sum
    # gradient is reduced first, its gradient too: DTensor cannot turn a
    # partial sum into another partial kind
    args = tuple(
        _reduced(x) if is_dtensor(x) and g is not None and any(
            q.is_partial() and getattr(q, "reduce_op", "sum") != "sum"
            and gq.is_partial() for q, gq in zip(x.placements, g)) else x
        for x, g in zip(args, grads))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def one_rank_replicated(sizes, placements) -> tuple:
    """``placements``, one per mesh dim of ``sizes``, with a shard or a
    partial sum over a mesh dim of size 1 written ``Replicate()``: the
    same layout, in the one form DTensor's view rules take (they refuse
    to flatten a dim of size 1 split over one rank, such as a batch of
    one on a data axis of size 1)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if n == 1 else q
                 for n, q in zip(sizes, placements))


def model_dim(mesh):
    """The mesh dim named "model", or None."""
    names = list(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


# Collectives inside a region, on each rank's local tensors.  They are
# ``_c10d_functional`` ops, so the launch layer's op counter sees them as
# it sees DTensor's own redistributions.

def _waited(t):
    return t.wait() if hasattr(t, "wait") else t


def all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``t`` reduced by ``op`` ("sum", "max") over the mesh ``dims``, in
    turn.  Under autograd a sum's backward is the same all-reduce of the
    gradient (each rank's result feeds that rank's own outputs); a max
    has none (its callers' own backward needs none)."""
    if op == "sum" and dims:
        return _Sum.apply(t, mesh, tuple(dims))
    return _reduce(t, op, mesh, dims)


def _reduce(t, op, mesh, dims):
    import torch.distributed._functional_collectives as funcol

    for d in dims:
        t = _waited(funcol.all_reduce(t, op, mesh.get_group(d)))
    return t


def _reduce_(t, op: str, mesh, d):
    """``t``, written in place with its reduction by ``op`` over mesh dim
    ``d``."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce_(t, op,
                                           mesh.get_group(d).group_name))


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.args = (mesh, dims)
        return _reduce(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", *ctx.args), None, None


def all_gather(t: torch.Tensor, dim: int, mesh, dims) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` over the mesh ``dims``
    (the last of them fastest, as DTensor splits a dim); under autograd its
    backward is the matching reduce-scatter.  No ``dims``: ``t``."""
    return _Gather.apply(t, dim, mesh, tuple(dims)) if dims else t


def reduce_scatter(t: torch.Tensor, dim: int, mesh, dims) -> torch.Tensor:
    """``t`` summed over the mesh ``dims`` and split along ``dim``, each
    rank keeping its piece (the inverse layout of :func:`all_gather`);
    under autograd its backward is that all-gather.  No ``dims``: ``t``."""
    return _Scatter.apply(t, dim, mesh, tuple(dims)) if dims else t


def all_to_all(t: torch.Tensor, split_dim: int, cat_dim: int, mesh,
               dim) -> torch.Tensor:
    """``t`` cut into n even pieces along ``split_dim``, piece i sent to
    rank i of mesh dim ``dim`` (n ranks), the pieces received joined
    along ``cat_dim`` in rank order: a shard of ``cat_dim`` becomes a
    shard of ``split_dim``.  Under autograd its backward is the inverse
    all-to-all.  ``dim`` None, or of size 1: ``t``."""
    if dim is None or mesh.size(dim) == 1:
        return t
    return _AllToAll.apply(t, split_dim, cat_dim, mesh, dim)


def _a2a(t, split_dim, cat_dim, mesh, dim):
    import torch.distributed._functional_collectives as funcol

    n = mesh.size(dim)
    if t.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                         f"split in {n} even pieces")
    pieces = t.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    out = _waited(funcol.all_to_all_single(pieces.contiguous(), None, None,
                                           mesh.get_group(dim)))
    return torch.cat(out.unbind(0), dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, cat_dim, mesh, dim):
        ctx.args = (cat_dim, split_dim, mesh, dim)
        return _a2a(t, split_dim, cat_dim, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return (_a2a(g, *ctx.args),) + (None,) * 4


def move_shard(x, mesh_dim: int, src: int, dst: int):
    """The DTensor ``x``, split along tensor dim ``src`` over mesh dim
    ``mesh_dim``, split along ``dst`` there instead, by an explicit
    :func:`all_to_all` in a region (DTensor's own redistribution picks
    its collective by device type: an all-gather on CPU meshes); its
    other mesh dims as they are (a partial one reduced)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    pl = [Replicate() if q.is_partial() else q for q in x.placements]
    in_pl = tuple(Shard(src) if i == mesh_dim else q for i, q in enumerate(pl))
    out_pl = tuple(Shard(dst) if i == mesh_dim else q
                   for i, q in enumerate(pl))
    return local_region(lambda t: all_to_all(t, dst, src, mesh, mesh_dim),
                        (x,), (in_pl,), (out_pl,), mesh)


def _gather(t, dim, mesh, dims):
    import torch.distributed._functional_collectives as funcol

    for d in reversed(dims):
        t = _waited(funcol.all_gather_tensor(t.contiguous(), dim,
                                             mesh.get_group(d)))
    return t


def _scatter(t, dim, mesh, dims):
    import torch.distributed._functional_collectives as funcol

    for d in dims:
        t = _waited(funcol.reduce_scatter_tensor(t.contiguous(), "sum", dim,
                                                 mesh.get_group(d)))
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, dims):
        ctx.args = (dim, mesh, dims)
        return _gather(t, dim, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return (_scatter(g, *ctx.args),) + (None,) * 3


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, dims):
        ctx.args = (dim, mesh, dims)
        return _scatter(t, dim, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, *ctx.args),) + (None,) * 3


def shard_offset(size: int, mesh, dims) -> int:
    """The first index of this rank's piece of a dim of ``size`` split
    over the mesh ``dims`` in mesh order, DTensor's way (``torch.chunk``:
    pieces of ceil(len / n), the last ones shorter or empty)."""
    off = 0
    for d in dims:
        n, r = mesh.size(d), mesh.get_local_rank(d)
        c = -(-size // n)
        start = min(r * c, size)
        off, size = off + start, min(size, start + c) - start
    return off


def shard_index(mesh, dims) -> tuple:
    """(this rank's piece, number of pieces) of a dim split over the mesh
    ``dims`` in mesh order (DTensor's layout)."""
    k, n = 0, 1
    for d in dims:
        k = k * mesh.size(d) + mesh.get_local_rank(d)
        n *= mesh.size(d)
    return k, n


def rows_times_split_weight(xl, wl, mesh, f, rows_split: bool):
    """Inside a region: ``x @ w`` for this rank's rows ``xl`` (R, ..., K),
    where the weight's ``K`` side is split over the mesh dim ``f`` (FSDP;
    ``wl`` its local (K/n, N) rows; ``f`` None: whole): the rows go to
    the weight, not the weight to the rows.  Where the rows are split
    over ``f`` too, each rank's slice of ``K`` of every rank's rows comes
    by an all-to-all and the partial products go back by a
    reduce-scatter; else each rank takes its slice of ``K`` and the
    partial products are summed over ``f``.  Returns (R, ..., N)."""
    if f is None:
        return xl @ wl.to(xl.dtype)
    if rows_split:
        xm = all_to_all(xl, xl.ndim - 1, 0, mesh, f)
        return reduce_scatter(xm @ wl.to(xm.dtype), 0, mesh, [f])
    k0 = shard_offset(xl.shape[-1], mesh, [f])
    xm = xl[..., k0:k0 + wl.shape[0]]
    return all_reduce(xm @ wl.to(xm.dtype), "sum", mesh, [f])


def column_chunk(n: int, mesh, t, r=None) -> tuple:
    """Rank ``r``'s (None: this rank's) chunk ``(c0, c1)`` of ``n``
    entries split over mesh dim ``t`` DTensor's way (``torch.chunk``,
    the last ones shorter or empty) and the chunk length ``c`` every
    rank pads to; ``t`` None: all ``n``."""
    if t is None:
        return 0, n, n
    c = -(-n // mesh.size(t))
    c0 = min((mesh.get_local_rank(t) if r is None else r) * c, n)
    return c0, min(n, c0 + c), c


def gather_chunks(y, dim: int, n: int, mesh, t):
    """Inside a region: the chunks ``y`` of :func:`column_chunk` (this
    rank's entries of a dim of ``n``, along ``dim``) all-gathered over
    mesh dim ``t``, padded to one length for the gather and cut back:
    every rank holds all ``n``.  Under autograd its backward takes the
    rank's own chunk of the gradient, the output being replicated (each
    rank holds the whole gradient)."""
    return _GatherChunks.apply(y, dim, n, mesh, t)


class _GatherChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, n, mesh, t):
        c0, c1, c = column_chunk(n, mesh, t)
        ctx.args = (dim, c0, c1)
        pad = [0, 0] * (y.ndim - 1 - dim) + [0, c - y.shape[dim]]
        return _gather(F.pad(y, pad), dim, mesh, [t]).narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        dim, c0, c1 = ctx.args
        return (g.narrow(dim, c0, c1 - c0),) + (None,) * 4


def exchange_ranges(t, dim: int, have, wants, mesh, md):
    """Inside a region: ``t`` holds entries ``have(r)`` = (lo, hi) of a
    dim's global index on rank ``r`` of mesh dim ``md`` (contiguous,
    increasing with ``r``), and rank ``r`` wants the sorted, disjoint
    ranges ``wants(r)``.  Returns this rank's wanted entries in index
    order, moved by one all-to-all with uneven splits (a rank sends each
    other rank only what it wants of its own)."""
    import torch.distributed._functional_collectives as funcol

    n, me = mesh.size(md), mesh.get_local_rank(md)

    def cut(a, b, lo, hi):
        return max(a, lo), min(b, hi)

    lo, hi = have(me)
    send, in_sizes = [], []
    for k in range(n):
        pieces = [t.narrow(dim, a - lo, b - a) for a, b in
                  (cut(a, b, lo, hi) for a, b in wants(k)) if b > a]
        in_sizes.append(sum(p.shape[dim] for p in pieces))
        send += pieces
    out_sizes = [sum(max(0, b - a) for a, b in
                     (cut(a, b, *have(k)) for a, b in wants(me)))
                 for k in range(n)]
    x = (torch.cat(send, dim) if send else t.narrow(dim, 0, 0))
    x = x.movedim(dim, 0).contiguous()
    y = _waited(funcol.all_to_all_single(x, out_sizes, in_sizes,
                                         mesh.get_group(md)))
    return y.movedim(0, dim)


def _reduced(x):
    """``x`` with its partial placements reduced (replicated), and its
    gradient redistributed to those replicated placements."""
    from torch.distributed.tensor import Replicate

    return _GradPlaced.apply(x.redistribute(
        x.device_mesh, [Replicate() if q.is_partial() else q
                        for q in x.placements]))


def _head_placements(mesh, B: int, n_heads: int, n_kv: int):
    """The placements of a head-parallel region over ``mesh``: the batch
    (dim 0) over the data axes where it divides them, the heads (dim 2)
    over "model" where both head counts divide it.  Returns (q's, kv's,
    model mesh dim or None, kv replicated while q is split)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names or ())
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    n_dp = math.prod(mesh.size(i) for i in dp)
    q_pl = [Replicate()] * mesh.ndim
    if dp and B % n_dp == 0:
        for i in dp:
            q_pl[i] = Shard(0)
    kv_pl = list(q_pl)
    t = names.index("model") if "model" in names else None
    kv_rep = False
    if t is not None and n_heads % mesh.size(t) == 0:
        q_pl[t] = Shard(2)
        if n_kv % mesh.size(t) == 0:
            kv_pl[t] = Shard(2)
        else:
            kv_rep = True
    return tuple(q_pl), tuple(kv_pl), t, kv_rep


def kv_groups(mesh, t, n_heads_local: int, rep: int):
    """The kv groups ``(g0, g1)`` that this rank's ``n_heads_local`` query
    heads (a slice of mesh dim ``t``'s split) attend with, ``rep`` query
    heads a group; raises when the slice cuts a group unevenly."""
    if n_heads_local % rep and rep % n_heads_local:
        raise ValueError(f"{n_heads_local} query heads a rank cannot share "
                         f"kv groups of {rep}")
    h0 = mesh.get_local_rank(t) * n_heads_local
    return h0 // rep, (h0 + n_heads_local - 1) // rep + 1


def split_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n·hd) -> (..., n, hd).  On a DTensor whose last dim is sharded
    over mesh dims that do not split whole heads, those dims are
    replicated first (a reshape would cut heads across ranks)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate

        d = t.ndim - 1
        dims = [i for i, q in enumerate(t.placements) if q.is_shard(d)]
        if dims and n % math.prod(t.device_mesh.size(i) for i in dims):
            pl = [Replicate() if i in dims else q
                  for i, q in enumerate(t.placements)]
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)


def _constrain_qchunks(x: torch.Tensor) -> torch.Tensor:
    s = _ATTN_SHARDING["val"]
    if s is not None and x.ndim == 6 and is_dtensor(x):
        return _redistribute(x, s)
    return x


def randn(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard normal fp32 draw from ``gen`` (on its own device), on
    ``device``.  On ``meta`` no draw is made (``gen`` may be None): the
    dry run's shape trees come from ``init_params(None, device="meta")``."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return t.to(dev)


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
    if is_dtensor(x) and x.ndim > 2:
        # both sides pinned: the matmul's gradients reach the ops around
        # it (views that cannot split a gradient sharded otherwise) as
        # their forward values were placed, and a partial sum (a
        # row-parallel product) is reduced here, once, as Megatron's
        # row-parallel layer does, not wherever DTensor meets it next
        x = _GradPlaced.apply(_one_leading_shard(x))
        if not _few_rows(x, w):
            return _Reduced.apply(x @ w.to(x.dtype))
        # few rows (a decode step) go to the weight, as rows of one
        # matrix (a batched product expands the weight along the batch),
        # and come back split as the residual stream is, by explicit
        # all-to-alls where DTensor would move the shards itself by a
        # collective it picks by device type (an all-gather on a CPU
        # mesh, an all-to-all on a CUDA one)
        lead = x.shape[:-1]
        x = _rows_to_weight(x.reshape(-1, x.shape[-1]), w)
        y = _Reduced.apply(x @ w.to(x.dtype))
        return _rows_split(_GradPlaced.apply(y.reshape(*lead, y.shape[-1])))
    return x @ w.to(x.dtype)


def _few_rows(x, w) -> bool:
    """Are the DTensor ``x``'s rows few beside the DTensor weight ``w``
    split over data axes (FSDP): one rank's columns of the product's
    rows smaller than ``w`` gathered over them (a decode step, where
    DTensor moves the rows to the weight, not the weight to the rows)?"""
    if not is_dtensor(w):
        return False
    mesh = w.device_mesh
    names = list(mesh.mesh_dim_names or ())
    n = math.prod(mesh.size(i) for i, q in enumerate(w.placements)
                  if q.is_shard() and names[i] in ("pod", "data"))
    wl = w.to_local()
    return n > 1 and math.prod(x.shape[:-1]) * wl.shape[-1] < wl.numel() * n


def _rows_to_weight(x, w):
    """The DTensor ``x`` with its rows' shard moved to its last dim on
    each mesh dim that splits both its rows and ``w``'s rows (FSDP), by
    :func:`move_shard`."""
    for i, q in enumerate(x.placements):
        if (q.is_shard(0) and w.placements[i].is_shard(0)
                and x.device_mesh.size(i) > 1):
            x = move_shard(x, i, 0, x.ndim - 1)
    return x


def _rows_split(y):
    """The DTensor ``y`` with a shard of its last dim over a data axis
    moved to its rows (by :func:`move_shard`) where the rows divide it:
    a product whose few rows met a weight's column split over "data"
    (DTensor gathers the rows, not the weight)."""
    mesh = y.device_mesh
    names = list(mesh.mesh_dim_names or ())
    for i, q in enumerate(y.placements):
        if (q.is_shard(y.ndim - 1) and names[i] in ("pod", "data")
                and mesh.size(i) > 1 and y.shape[0] % mesh.size(i) == 0):
            y = move_shard(y, i, y.ndim - 1, 0)
    return y


class _Reduced(torch.autograd.Function):
    """A DTensor with its partial sums reduced (replicated there), its
    gradient passed back in the reduced placements: reduced only if it
    arrives partial (DTensor's own backward of the reduction may hand
    one on partial, to be reduced again further down)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import DTensor, Replicate

        ctx.mesh = y.device_mesh
        ctx.placements = [Replicate() if q.is_partial() else q
                          for q in y.placements]
        if ctx.placements == list(y.placements):
            return y.view_as(y)
        # reduced in place, as XLA reduces such a buffer: the partial
        # product is not kept beside its reduction
        t = y.to_local()
        for d, q in enumerate(y.placements):
            if q.is_partial():
                t = _reduce_(t, q.reduce_op, ctx.mesh, d)
        return DTensor.from_local(t, ctx.mesh, ctx.placements,
                                  run_check=False, shape=y.shape,
                                  stride=y.stride())

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


class _GradPlaced(torch.autograd.Function):
    """Identity on a DTensor whose gradient is redistributed to the
    DTensor's own placements (not left as the next op's backward placed
    it)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate

        # a partial sum's gradient is the same on every rank: replicated
        ctx.mesh = y.device_mesh
        ctx.placements = [Replicate() if q.is_partial() else q
                          for q in y.placements]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def _one_leading_shard(x):
    """A DTensor whose leading dims (all but the last, which a matmul
    flattens into one) are sharded on dim 0 at most: a shard of any other
    leading dim is gathered first (e.g. a sequence-sharded activation
    before a tensor-parallel projection, as Megatron's sequence
    parallelism gathers it), since flattening it would split the
    flattened dim in strides."""
    from torch.distributed.tensor import Replicate

    if not any(q.is_shard() and 0 < q.dim < x.ndim - 1 for q in x.placements):
        return x
    pl = [Replicate() if q.is_shard() and 0 < q.dim < x.ndim - 1 else q
          for q in x.placements]
    return x.redistribute(x.device_mesh, pl)


def rmsnorm_init(d: int, device=None):
    return torch.ones((d,), dtype=torch.float32, device=resolve_device(device))


# the fp32 bytes of the rows a norm upcasts at once: over a long
# sequence a norm holds this, not an fp32 copy of its whole input (XLA
# fuses the upcast into the row reduction)
_NORM_BLOCK_BYTES = 64 << 20


def _by_row_blocks(fn, x, *params):
    """``fn(x, *params)`` for a row-wise ``fn`` (each row of x's last dim
    mapped on its own, with its own output row) over blocks of x's rows
    whose fp32 copy takes at most :data:`_NORM_BLOCK_BYTES`, joined: the
    same values, rows being independent.  A DTensor is cut along its
    longest leading dim that no mesh dim splits, by DTensor ops, so its
    placements and its gradients' are ``fn``'s own; a partial one, or
    one with no such dim, goes to ``fn`` whole."""
    D = max(x.shape[-1], 1)
    rows = max(1, _NORM_BLOCK_BYTES // (4 * D))
    if not is_dtensor(x):
        n = x.numel() // D
        if n <= rows:
            return fn(x, *params)
        out = [fn(b, *params) for b in x.reshape(n, D).split(rows)]
        return torch.cat(out).reshape(*x.shape[:-1], -1)
    split = {q.dim for q in x.placements if q.is_shard()}
    free = [d for d in range(x.ndim - 1) if d not in split]
    if not free or any(q.is_partial() for q in x.placements):
        return fn(x, *params)
    d = max(free, key=lambda i: x.shape[i])
    per = x.to_local().numel() // D // max(x.shape[d], 1)  # local rows an index
    k = max(1, rows // max(per, 1))
    if k >= x.shape[d]:
        return fn(x, *params)
    return torch.cat([fn(b, *params) for b in x.split(k, dim=d)], dim=d)


def _mean_square(x):
    return x.float().square().mean(dim=-1, keepdim=True)


def rmsnorm(g, x, eps: float = 1e-6):
    var = _by_row_blocks(_mean_square, x)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g.to(x.dtype)


def layernorm_init(d: int, device=None):
    dev = resolve_device(device)
    return {"g": torch.ones((d,), dtype=torch.float32, device=dev),
            "b": torch.zeros((d,), dtype=torch.float32, device=dev)}


def _layernorm_rows(x, g, b, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def layernorm(p, x, eps: float = 1e-5):
    if is_dtensor(x):
        # a row split along its columns over a data axis (the products of
        # a batch that the data axes do not divide come out so) is
        # gathered there first: left to DTensor, its centring comes out a
        # partial mean with the batch rows split over "model", which the
        # next product cannot flatten where the rows do not divide it
        from torch.distributed.tensor import Replicate

        names = x.device_mesh.mesh_dim_names or ()
        pl = [Replicate() if q.is_shard(x.ndim - 1)
              and names[i] in ("pod", "data") else q
              for i, q in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return _by_row_blocks(lambda x, g, b: _layernorm_rows(x, g, b, eps), x,
                         p["g"], p["b"])


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
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal, window, q_offset,
                                  q_chunk, kv_chunk)
    B, Sq, H, Dh = q.shape
    _, Sk, G, _ = k.shape
    if H % G:
        raise ValueError(f"{H} query heads do not group over {G} kv heads")
    rep = H // G

    nq_target = _ATTN_SHARDING["nq"]
    if nq_target and Sq % nq_target == 0 and Sq // nq_target >= 16:
        q_chunk = Sq // nq_target  # align the q-chunk axis with "model"
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

    def one_q_chunk(qc, kp, vp, qi: int, base=None):
        """q rows ``qc`` (B, G, rep, rows, Dh) at positions ``base`` (the
        q chunk's by default) + ``qi`` chunks against every kv chunk."""
        qpos = (qpos_base if base is None else base) + qi * q_chunk
        rows = qc.shape[3]
        acc = torch.zeros((B, G, rep, rows, Dh), dtype=q.dtype, device=dev)
        m = torch.full((B, G, rep, rows), -math.inf, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((B, G, rep, rows), dtype=torch.float32, device=dev)
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

    if _ATTN_SHARDING["val"] is not None:
        # sequence-sharded attention: the q chunks as one batched axis
        # (JAX vmaps them) that the registered placements shard over
        # "model": every q row in one pass over the kv chunks, the
        # (nq, B, G, rep, q_chunk, Dh) stack constrained in and out
        def stack(x):
            return x.reshape(B, G, rep, nq, q_chunk, Dh).movedim(3, 0)

        def unstack(x):
            return x.movedim(0, 3).reshape(B, G, rep, nq * q_chunk, Dh)

        qs = unstack(_constrain_qchunks(stack(qp)))
        base = torch.arange(nq * q_chunk, device=dev) + q_offset
        out = remat_call(one_q_chunk, qs, kp, vp, 0, base)
        out = unstack(_constrain_qchunks(stack(out))).reshape(
            B, H, nq * q_chunk, Dh)
        return out.movedim(1, 2)[:, :Sq]
    outs = [remat_call(one_q_chunk, qp[:, :, :, qi * q_chunk:(qi + 1) * q_chunk],
                       kp, vp, qi)
            for qi in range(nq)]
    # nq x (B, G, rep, q_chunk, Dh) -> (B, Sq, H, Dh)
    out = torch.cat(outs, dim=3).reshape(B, H, nq * q_chunk, Dh)
    return out.movedim(1, 2)[:, :Sq]


def _sharded_attention(q, k, v, causal, window, q_offset, q_chunk,
                       kv_chunk):
    """``chunked_attention`` on DTensors as a head-parallel region: each
    rank attends its batch rows with its query heads (and their kv
    groups).  A few query rows against a kv whose head_dim is split
    (whisper's cross-attention cache in a decode step) take the kv as it
    lies: partial dot products summed over head_dim's mesh dims
    (:func:`_partial_dot_attention`), no gather of the kv."""
    mesh = q.device_mesh
    H, G = q.shape[2], k.shape[2]
    hdims = length_dims(k, 3)
    if (hdims and not causal and window is None
            and 2 * H * q.shape[1] < G * k.shape[3]):
        return _partial_dot_attention(q, k, v, hdims)
    q_pl, kv_pl, t, kv_rep = _head_placements(mesh, q.shape[0], H, G)

    def local(ql, kl, vl):
        if kv_rep:
            g0, g1 = kv_groups(mesh, t, ql.shape[2], H // G)
            kl, vl = kl[:, :, g0:g1], vl[:, :, g0:g1]
        return chunked_attention(ql, kl, vl, causal, window, q_offset,
                                 q_chunk, kv_chunk)

    return local_region(local, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl,), mesh)


def _partial_dot_attention(q, k, v, hdims):
    """Full (unmasked) attention of q (B, Sq, H, Dh) over k/v (B, Sk, G,
    Dh) whose head_dim is split over the mesh dims ``hdims``, as one
    region in k's placements: each rank scores its slice of head_dim,
    the scores are summed over ``hdims`` (fewer bytes than the kv where
    the query rows are few), and the output's slices are gathered."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    q_pl = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in k.placements)
    Dh = q.shape[-1]

    def local(ql, kl, vl):
        B, Sq, H, _ = ql.shape
        G, dl = kl.shape[2], kl.shape[3]
        h0 = shard_offset(Dh, mesh, hdims)
        qh = ql[..., h0:h0 + dl].reshape(B, Sq, G, H // G, dl)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qh, kl).float()
        s = all_reduce(s, "sum", mesh, hdims) / math.sqrt(Dh)
        p = torch.softmax(s, dim=-1).to(vl.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vl).reshape(B, Sq, H, dl)
        return all_gather(o, 3, mesh, hdims)

    return local_region(local, (q, k, v), (q_pl, k.placements, v.placements),
                        (q_pl,), mesh)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, L, G, Dh)  L = cache length
    v_cache: torch.Tensor,
    cache_len,              # number of valid entries (int or 0-d tensor)
) -> torch.Tensor:
    """Single-token attention against a KV cache (full or ring)."""
    if is_dtensor(q):
        return _sharded_decode_attention(q, k_cache, v_cache, cache_len)
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


def _sharded_decode_attention(q, k_cache, v_cache, cache_len):
    """``decode_attention`` on DTensors as a head-parallel region (the
    cache's length gathered on every rank)."""
    mesh = q.device_mesh
    H, G = q.shape[2], k_cache.shape[2]
    q_pl, kv_pl, t, kv_rep = _head_placements(mesh, q.shape[0], H, G)
    n_pl = None

    def local(ql, kl, vl, n):
        if kv_rep:
            g0, g1 = kv_groups(mesh, t, ql.shape[2], H // G)
            kl, vl = kl[:, :, g0:g1], vl[:, :, g0:g1]
        return decode_attention(ql, kl, vl, n)

    if is_dtensor(cache_len):
        from torch.distributed.tensor import Replicate

        n_pl = (Replicate(),) * mesh.ndim
    return local_region(local, (q, k_cache, v_cache, cache_len),
                        (q_pl, kv_pl, kv_pl, n_pl), (q_pl,), mesh)


def length_dims(kv, dim: int = 1) -> list:
    """The mesh dims of size > 1 that split ``dim`` (by default 1, a
    cache's length) of the DTensor ``kv`` (empty for a plain tensor)."""
    if not is_dtensor(kv):
        return []
    mesh = kv.device_mesh
    return [i for i, q in enumerate(kv.placements)
            if q.is_shard(dim) and mesh.size(i) > 1]


def split_kv_attend(q, k, v, valid, mesh, dims, hd_dims=()):
    """One query token against one rank's slice of a length-sharded kv
    (split-KV, FlashDecoding's merge): q (B, 1, H, Dh), k/v (B, Ll, G, Dh)
    local, ``valid`` (Ll,) which of the slice's entries count.  Each rank
    attends over its slice and the (output, max, sum) partials merge by a
    log-sum-exp over the mesh ``dims``; returns (B, 1, H, Dh) in q's
    dtype, on every rank.  Where ``hd_dims`` split head_dim, q, k and v
    are the rank's slice of it: the scores are partial dot products,
    summed over ``hd_dims`` before the softmax, and the output's slices
    are gathered over them."""
    B, Ll, G, Dh = k.shape
    H = q.shape[2]
    n_hd = math.prod(mesh.size(i) for i in hd_dims)
    kq, vq = k.movedim(2, 1), v.movedim(2, 1)                  # (B,G,Ll,Dh)
    qh = q.movedim(2, 1).reshape(B, G, H // G, 1, Dh)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qh, kq).float()
    s = all_reduce(s, "sum", mesh, hd_dims) / math.sqrt(Dh * n_hd)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(vq.dtype), vq).float()
    mg = all_reduce(m, "max", mesh, dims)
    a = torch.exp(m - mg)
    lo = torch.cat([o * a, p.sum(dim=-1, keepdim=True) * a], dim=-1)
    lo = all_reduce(lo, "sum", mesh, dims)
    o = (lo[..., :Dh] / lo[..., Dh:]).to(q.dtype)
    o = all_gather(o, o.ndim - 1, mesh, hd_dims)
    return o.reshape(B, H, 1, Dh * n_hd).movedim(1, 2)


def swiglu_init(gen, d: int, f: int, device=None):
    return {
        "w_gate": dense_init(gen, d, f, device=device),
        "w_up": dense_init(gen, d, f, device=device),
        "w_down": dense_init(gen, f, d, device=device),
    }


def swiglu(p, x):
    # each input let go once read: a caller that hands over its only
    # reference (``mlp_fn``) frees it before the down projection
    g = dense(p["w_gate"], x)
    u = dense(p["w_up"], x)
    del x
    return dense(p["w_down"], F.silu(g) * u)


def gelu_mlp_init(gen, d: int, f: int, device=None):
    return {"w_in": dense_init(gen, d, f, device=device),
            "w_out": dense_init(gen, f, d, device=device)}


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = dense(p["w_in"], x)
    del x
    return dense(p["w_out"], F.gelu(h, approximate="tanh"))


def embed_init(gen, vocab: int, d: int, device=None):
    return randn(gen, (vocab, d), device) * 0.02
