"""Token-choice top-k Mixture-of-Experts FFN, GShard-style with capacity
(the port of ``repro.models.moe``, one dispatch block).

Covers mixtral-8x7b (8 experts, top-2, MoE every layer) and
llama4-maverick (128 experts, top-1, MoE on alternating layers).

Dispatch is scatter-based: per-assignment position-in-expert ranks come
from a cumsum over a one-hot (T·k, E) matrix in token-major order;
assignments beyond the capacity ``C = min(max(floor(cf · T · k / E), 1),
T)`` are dropped (their zero contribution lands in slot 0).  The expert
GEMMs are batched matmuls over stacked expert weights (E, D, F).

The launch layer's hooks, as in the JAX package: ``set_moe_block_dispatch``
dispatches tokens in ``n`` independent blocks, each with its own capacity
(production MoE stacks' per-device semantics); ``set_moe_shard_map``
runs the layer as an explicit-collective region over a mesh.  On DTensor
activations the layer always runs as such a region
(:func:`_moe_region`, a ``local_map``): each rank routes the tokens it
holds (by default under the whole batch's capacity, its queue offsets
taken from the other data shards' counts), runs the expert GEMMs on its
slice of the experts (EP) or of ``d_ff`` (TP), and the partial outputs
are summed over "model".  The weights are gathered over "data" (their
FSDP split) at use, unless the block has fewer tokens than a rank's
share of them (a decode step): then the tokens go to the weights, every
rank computing on its slice of ``D`` (:func:`_to_weights_local`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import (
    all_gather, all_reduce, all_to_all, dense_init, is_dtensor, local_region,
    randn, reduce_scatter, shard_index, shard_offset,
)

__all__ = ["moe_init", "moe_apply", "moe_capacity", "set_moe_block_dispatch",
           "set_moe_shard_map"]

# Hook: dispatch tokens in ``n_blocks`` independent blocks whose leading
# axis is sharded over the data axes, with per-block routing capacity, so
# the dispatch stays shard-local.  ``sharding`` (mesh, placements) is the
# (nb, T/nb, D) block stack's: on DTensors the region realizes it, one
# block per data shard; ``w_in``/``w_out`` (mesh, placements) are the
# expert weights' at use.
_MOE_BLOCKS = {"n": None, "sharding": None, "w_in": None, "w_out": None}

# Hook: the MoE layer as an explicit-collective region over ``mesh``:
# per-shard local dispatch (local capacity) over the ``dp`` axes, TP
# expert GEMMs over ``tp``, one sum over ``tp`` for the output and one
# mean over all axes for the aux loss.
_MOE_SHARD_MAP = {"mesh": None, "dp": None, "tp": None}


def set_moe_block_dispatch(n_blocks, sharding, w_in=None, w_out=None) -> None:
    _MOE_BLOCKS["n"] = n_blocks
    _MOE_BLOCKS["sharding"] = sharding
    _MOE_BLOCKS["w_in"] = w_in
    _MOE_BLOCKS["w_out"] = w_out


def set_moe_shard_map(mesh, dp, tp="model") -> None:
    _MOE_SHARD_MAP["mesh"] = mesh
    _MOE_SHARD_MAP["dp"] = dp
    _MOE_SHARD_MAP["tp"] = tp


def moe_init(gen, cfg: ArchConfig, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, d, e, scale=0.02, device=device),
        "w_gate": randn(gen, (e, d, f), device) * (d ** -0.5),
        "w_up": randn(gen, (e, d, f), device) * (d ** -0.5),
        "w_down": randn(gen, (e, f, d), device) * (f ** -0.5),
    }


def moe_capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for ``T`` tokens (``int()`` floors, as in JAX)."""
    cap = max(int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts), 1)
    return min(cap, T)


def _dispatch_block(xt, p, cfg: ArchConfig, cap: int, experts=None,
                    shard=None, cols=None):
    """Token-choice top-k dispatch + expert GEMMs for one token block.

    xt: (Tb, D) -> (y: (Tb, D), aux: scalar).  ``experts=(e0, n)``: the
    expert weights in ``p`` are experts ``e0 .. e0+n-1`` only (EP), and
    ``y`` sums only their outputs.  ``shard=(mesh, dims)``: ``xt`` is
    this rank's piece of a block split over the mesh ``dims`` (token
    order: the pieces in DTensor's order), routed as that whole block
    is, under the whole block's capacity ``cap``: each expert's queue
    positions are offset by the earlier pieces' counts (an all-gather of
    E counts), and each rank runs the expert GEMMs on its share of the
    capacity slots (:func:`_expert_rows`); the aux loss is this piece's
    share of the whole block's.  ``cols=(d0, mesh, dims)``: the expert
    weights in ``p`` hold rows ``d0 ..`` of their ``D`` side only, the
    rest on the other ranks of the mesh ``dims`` (FSDP): the GEMMs run
    on those columns of the tokens, the partial sums of the first two
    reduced over ``dims``, and ``y`` holds those columns, (Tb, D_local).
    """
    E, K = cfg.n_experts, cfg.top_k
    Tb, D = xt.shape

    logits = (xt @ p["router"].to(xt.dtype)).float()        # (Tb, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index, as lax.top_k (torch.topk leaves
    # the order of equal values open, and bf16 router logits tie often)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :K], gate_i[:, :K]            # (Tb, K)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # position of each assignment within its expert queue
    eflat = gate_i.reshape(-1)                               # (Tb*K,)
    onehot = F.one_hot(eflat, E).to(torch.int32)             # (Tb*K, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = pos.gather(1, eflat[:, None])[:, 0]

    # load-balancing aux loss (Switch/GShard)
    mesh, dims = shard if shard is not None else (None, ())
    k, n = shard_index(mesh, dims)
    if shard is None:
        me = probs.mean(dim=0)                               # (E,)
        ce = F.one_hot(gate_i, E).float().sum(dim=1).mean(dim=0)
        aux = E * (me * ce).sum()
    else:
        counts = all_gather(onehot.sum(dim=0)[None], 0, mesh, dims)
        pos = pos + counts[:k].sum(dim=0)[eflat]
        ce = counts.sum(dim=0).float() / (Tb * n)
        aux = E * (probs.sum(dim=0) / (Tb * n) * ce).sum()
    keep = pos < cap
    slot = torch.where(keep, pos, torch.zeros_like(pos)).long()
    slots = -(-cap // n) * n           # a whole share of slots per rank

    # each kept assignment of the experts held here (all, or EP's e0..)
    # at its row of the block's (n_exp, slots, D) expert buffer
    n_exp, wmask = E, keep
    if experts is not None:
        e0, n_exp = experts
        local = (eflat >= e0) & (eflat < e0 + n_exp)
        wmask = keep & local
        eflat = torch.where(local, eflat - e0, torch.zeros_like(eflat))
    flat = eflat * slots + slot
    gate = gate_w.reshape(-1) * wmask                        # (Tb*K,)
    red = ()
    if cols is not None:
        d0, cmesh, red = cols
        xt = xt[:, d0:d0 + p["w_gate"].shape[1]]
        mesh = cmesh
    return _expert_rows(xt, p, flat, wmask, gate, n_exp, slots, K, mesh,
                        dims, red), aux


def _expert_ffn(p, buf, mesh=None, red=()):
    """The grouped expert GEMMs (weights cast to the activation dtype at
    use): (n, rows, D) -> (n, rows, D).  ``red``: the mesh dims whose
    ranks hold the other rows of the weights' ``D`` side (and of
    ``buf``'s columns), over which the first two GEMMs' partial sums are
    reduced."""
    g = torch.bmm(buf, p["w_gate"].to(buf.dtype))
    u = torch.bmm(buf, p["w_up"].to(buf.dtype))
    if red:
        g, u = all_reduce(torch.stack([g, u]), "sum", mesh, red).unbind(0)
    return torch.bmm(F.silu(g) * u, p["w_down"].to(buf.dtype))


def _expert_rows(xt, p, flat, wmask, gate, n_exp: int, slots: int, K: int,
                 mesh, dims, red=()):
    """Dispatch, expert GEMMs and combine of the (Tb·K,) assignments at
    rows ``flat`` of an (n_exp, slots, D) expert buffer (kept where
    ``wmask``, weighted by ``gate``) -> y (Tb, D).  Over the mesh
    ``dims`` (the block split in n pieces, one a rank) each rank runs the
    GEMMs on its share of the slots, filled by whichever is smaller: the
    buffer itself, built from this piece's rows and reduce-scattered
    along its slots (its outputs all-gathered back), or the block's
    tokens, all-gathered with the assignments' rows and gates (its
    outputs summed into the block's tokens and reduce-scattered back).
    No ``dims``: the plain layer's buffer.  ``red``: see
    :func:`_expert_ffn` (no ``dims`` then)."""
    Tb, D = xt.shape
    k, n = shard_index(mesh, dims)
    if not dims or n * Tb >= n_exp * slots:
        contrib = torch.repeat_interleave(xt, K, dim=0) * wmask[:, None].to(
            xt.dtype)
        buf = xt.new_zeros((n_exp * slots, D)).index_add(0, flat, contrib)
        out = _expert_ffn(p, reduce_scatter(buf.view(n_exp, slots, D), 1,
                                            mesh, dims), mesh, red)
        y = all_gather(out, 1, mesh, dims).reshape(-1, D)[flat]
        return (y * gate[:, None].to(xt.dtype)).reshape(Tb, K, D).sum(dim=1)

    # the block's tokens and assignment table; this rank's rows are slots
    # k·s .. (k+1)·s - 1 of each expert, row ``dump`` takes the others
    T, s = n * Tb, slots // n
    table = all_gather(torch.stack([flat, wmask.long()]), 1, mesh, dims)
    gates = all_gather(gate, 0, mesh, dims)
    xg = all_gather(xt, 0, mesh, dims)
    e, sl = table[0] // slots, table[0] % slots - k * s
    mine = table[1].bool() & (sl >= 0) & (sl < s)
    dump = n_exp * s
    row = torch.where(mine, e * s + sl, torch.full_like(sl, dump))
    tok = torch.arange(T * K, device=xt.device) // K
    # the token of each row (T, a zero row, where no kept assignment is)
    src = torch.full((dump + 1,), T, dtype=torch.long,
                     device=xt.device).scatter(
        0, row, torch.where(mine, tok, torch.full_like(tok, T)))[:dump]
    w = gates.new_zeros(dump + 1).index_add(0, row, gates * mine)[:dump]
    buf = torch.cat([xg, xg.new_zeros((1, D))])[src].view(n_exp, s, D)
    out = _expert_ffn(p, buf).reshape(-1, D) * w[:, None].to(xt.dtype)
    yg = xg.new_zeros((T + 1, D)).index_add(0, src, out)[:T]
    return reduce_scatter(yg, 0, mesh, dims)


def _mesh_dims(mesh, axes) -> list:
    names = list(mesh.mesh_dim_names)
    return [names.index(a) for a in ((axes,) if isinstance(axes, str) else axes)]


def _moe_region(p, cfg: ArchConfig, x, mesh, dp, tp: str, cap: int,
                wdtype: torch.dtype, allow_ep: bool = True,
                whole: bool = False):
    """The MoE layer on DTensor activations as one ``local_map`` region
    over ``mesh``.  Tokens: sharded over the ``dp`` axes, each shard
    routing its own with capacity ``cap`` (a dispatch block per shard),
    or with ``whole`` as pieces of one block under its capacity ``cap``
    (the plain layer's routing, :func:`_dispatch_block`'s ``shard``),
    or, with ``dp`` None, replicated (every rank routes all of them).
    Experts: split over ``tp`` by expert (EP, when they divide it as the
    sharding rules place them) or by ``d_ff`` (TP; always with
    ``allow_ep`` False), else replicated.  The partial outputs are summed
    over ``tp`` (DTensor's all-reduce of a ``Partial``); the aux loss is
    averaged over the axes the work is split on (JAX's ``pmean`` over
    every axis of its shard_map: the same value), or with ``whole``
    summed over the pieces and averaged over ``tp``.  The weights enter
    in ``wdtype``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    B, S, D = x.shape
    E, Fd = cfg.n_experts, cfg.d_ff
    nd = mesh.ndim
    t = _mesh_dims(mesh, tp)[0]
    n_tp = mesh.size(t)
    ep = allow_ep and E >= n_tp and E % n_tp == 0
    split = ep or Fd % n_tp == 0
    rep = [Replicate()] * nd

    def on_tp(dim):
        pl = list(rep)
        if split:
            pl[t] = Shard(dim)
        return tuple(pl)

    x_pl, y_pl = list(rep), list(rep)
    dp_dims = [] if dp is None else _mesh_dims(mesh, dp)
    for i in dp_dims:
        x_pl[i] = y_pl[i] = Shard(0)
    if split:
        y_pl[t] = Partial()
    # the aux loss: averaged over the mesh dims the work is split on, as a
    # sum of each rank's aux / n (so each rank's gradient through it is
    # its 1/n share, as the inputs' gradients are shares)
    split_dims = ({i for i, q in enumerate(x_pl) if q.is_shard()}
                  | ({t} if split else set()))
    n_split = math.prod(mesh.size(i) for i in split_dims)
    n_aux = (n_tp if split else 1) if whole else n_split
    aux_pl = tuple(Partial() if i in split_dims else Replicate()
                   for i in range(nd))
    w_in = on_tp(0 if ep else 2)     # (E, D, F)
    w_out = on_tp(0 if ep else 1)    # (E, F, D)
    n_local = E // n_tp if ep else E

    def local(xl, router, wg, wu, wd):
        Bl, Sl, _ = xl.shape
        experts = None
        if ep:
            e0 = mesh.get_local_rank(t) * n_local
            experts = (e0, n_local)
        pl = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        y, aux = _dispatch_block(xl.reshape(Bl * Sl, D), pl, cfg, cap,
                                 experts, (mesh, dp_dims) if whole else None)
        return y.reshape(Bl, Sl, D), aux / n_aux

    ws = [p["w_gate"], p["w_up"], p["w_down"]]
    for i, key in ((0, "w_in"), (1, "w_in"), (2, "w_out")):
        if _MOE_BLOCKS[key] is not None:
            ws[i] = ws[i].redistribute(*_MOE_BLOCKS[key])
    f = _fsdp_dim(ws, mesh)
    f_local = Fd // n_tp if split and not ep else Fd
    if (f is not None and (dp is None or (whole and f == dp_dims[-1]))
            and B * S < 3 * n_local * f_local):
        # fewer tokens than the rank's share of the gathered weights (a
        # decode step): the tokens go to the weights, which keep their
        # FSDP split of D over mesh dim f
        w_in, w_out = (tuple(Shard(d) if i == f else q
                             for i, q in enumerate(pl))
                       for pl, d in ((w_in, 1), (w_out, 2)))
        split_dims = ((set(dp_dims) if whole else set()) | {f}
                      | ({t} if split else set()))
        aux_pl = tuple(Partial() if i in split_dims else Replicate()
                       for i in range(nd))
        local = functools.partial(
            _to_weights_local, cfg=cfg, cap=cap, mesh=mesh, f=f,
            t=t if ep else None, n_local=n_local,
            dp_dims=dp_dims if whole else [],
            n_aux=math.prod(mesh.size(i) for i in split_dims))
        if not whole:
            y_pl[f] = Partial()
    y, aux = local_region(
        local, (x, *(w.to(wdtype) for w in [p["router"]] + ws)),
        (tuple(x_pl), tuple(rep), w_in, w_in, w_out),
        (tuple(y_pl), aux_pl), mesh)
    return (y.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in y_pl]),
            aux.redistribute(mesh, rep))


def _fsdp_dim(ws, mesh):
    """The one mesh dim of size > 1 that splits the ``D`` side of all
    three expert weights (dim 1 of w_gate/w_up, dim 2 of w_down: FSDP),
    or None."""
    dims = [{i for i, q in enumerate(w.placements)
             if q.is_shard(d) and mesh.size(i) > 1}
            for w, d in zip(ws, (1, 1, 2))]
    both = dims[0] & dims[1] & dims[2]
    return next(iter(both)) if len(both) == 1 else None


def _to_weights_local(xl, router, wg, wu, wd, *, cfg, cap, mesh, f, t,
                      n_local, dp_dims, n_aux):
    """One rank of the MoE layer where the tokens go to the weights: the
    block's tokens all-gathered over ``dp_dims`` (none: every rank holds
    them all) and routed as the plain layer routes them, the expert
    GEMMs run on this rank's slice of ``D`` (the weights' FSDP split over
    mesh dim ``f``), their partial sums reduced over ``f``.  The outputs'
    columns go back to their rows by an all-to-all over ``f`` (tokens
    split over ``dp_dims``), else each rank's columns are a partial sum
    over ``f``; EP's experts over mesh dim ``t``."""
    Bl, Sl, D = xl.shape
    xg = all_gather(xl.reshape(Bl * Sl, D), 0, mesh, dp_dims)
    experts = None if t is None else (mesh.get_local_rank(t) * n_local,
                                      n_local)
    d0 = shard_offset(D, mesh, [f])
    pl = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
    y, aux = _dispatch_block(xg, pl, cfg, cap, experts, cols=(d0, mesh, [f]))
    if dp_dims:
        k, n = shard_index(mesh, [i for i in dp_dims if i != f])
        y = all_to_all(y.view(n, -1, y.shape[-1])[k], 0, 1, mesh, f)
    else:
        y = F.pad(y, (d0, D - d0 - y.shape[-1]))
    return y.reshape(Bl, Sl, D), aux / n_aux


def _moe_shard_map_apply(p, cfg: ArchConfig, x):
    """Explicit-collective MoE (mixtral-class, experts replicated, TP on
    d_ff): each (dp, tp) shard dispatches its own tokens locally and the
    row-parallel w_down contraction sums once over the tp axis."""
    mesh, dp, tp = (_MOE_SHARD_MAP[k] for k in ("mesh", "dp", "tp"))
    B, S, D = x.shape
    n_dp = math.prod(mesh.size(i) for i in _mesh_dims(mesh, dp))
    # the weights enter in bf16, as JAX casts them for its shard_map
    return _moe_region(p, cfg, x, mesh, dp, tp,
                       moe_capacity(cfg, (B // n_dp) * S), torch.bfloat16,
                       allow_ep=False)


def moe_apply(p, cfg: ArchConfig, x: torch.Tensor):
    """x: (B, S, D) -> (y: (B, S, D), aux_loss: scalar)."""
    B, S, D = x.shape
    T = B * S

    mesh = _MOE_SHARD_MAP["mesh"]
    if mesh is not None and cfg.n_experts < mesh.size(
            _mesh_dims(mesh, _MOE_SHARD_MAP["tp"])[0]):
        return _moe_shard_map_apply(p, cfg, x)

    nb = _MOE_BLOCKS["n"] or 1
    if T % nb or (nb > 1 and B % nb):
        nb = 1
    cap = moe_capacity(cfg, T // nb)

    if is_dtensor(x):
        mesh = x.device_mesh
        dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
        n_dp = math.prod(mesh.size(i) for i in _mesh_dims(mesh, dp))
        if nb > 1:
            # block-local dispatch: one block per data shard of the batch
            if nb != n_dp:
                raise ValueError(f"{nb} dispatch blocks on DTensors need one "
                                 f"per data shard ({n_dp})")
            return _moe_region(p, cfg, x, mesh, dp, "model", cap, x.dtype)
        # one block: each data shard routes its rows under its capacity
        whole = n_dp > 1 and B % n_dp == 0
        return _moe_region(p, cfg, x, mesh, dp if whole else None, "model",
                           cap, x.dtype, whole=whole)

    if nb == 1:
        y, aux = _dispatch_block(x.reshape(T, D), p, cfg, cap)
        return y.reshape(B, S, D), aux

    # block-local dispatch (JAX vmaps the blocks): each with its own capacity
    xb = x.reshape(nb, T // nb, D)
    outs = [_dispatch_block(xb[i], p, cfg, cap) for i in range(nb)]
    y = torch.stack([o[0] for o in outs])
    aux = torch.stack([o[1] for o in outs]).mean()
    return y.reshape(B, S, D), aux
