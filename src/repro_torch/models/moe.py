"""Token-choice top-k Mixture-of-Experts FFN, GShard-style with capacity
(the port of ``repro.models.moe``, one dispatch block).

Covers mixtral-8x7b (8 experts, top-2, MoE every layer) and
llama4-maverick (128 experts, top-1, MoE on alternating layers).

Dispatch is scatter-based: per-assignment position-in-expert ranks come
from a cumsum over a one-hot (T·k, E) matrix in token-major order;
assignments beyond the capacity ``C = min(max(floor(cf · T · k / E), 1),
T)`` are dropped (their zero contribution lands in slot 0).  The expert
GEMMs are batched matmuls over stacked expert weights (E, D, F).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import dense_init, randn

__all__ = ["moe_init", "moe_apply", "moe_capacity"]


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


def _dispatch_block(xt, p, cfg: ArchConfig, cap: int):
    """Token-choice top-k dispatch + expert GEMMs for one token block.

    xt: (Tb, D) -> (y: (Tb, D), aux: scalar).
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

    # load-balancing aux loss (Switch/GShard)
    me = probs.mean(dim=0)                                   # (E,)
    ce = F.one_hot(gate_i, E).float().sum(dim=1).mean(dim=0)
    aux = E * (me * ce).sum()

    # position of each assignment within its expert queue
    eflat = gate_i.reshape(-1)                               # (Tb*K,)
    onehot = F.one_hot(eflat, E).to(torch.int32)             # (Tb*K, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = pos.gather(1, eflat[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, pos, torch.zeros_like(pos)).long()

    # dispatch: (E, C, D) expert buffers, filled through a flat (E·C, D) view
    xt_rep = torch.repeat_interleave(xt, K, dim=0)           # (Tb*K, D)
    contrib = xt_rep * keep[:, None].to(xt.dtype)
    flat = eflat * cap + slot
    buf = torch.zeros((E * cap, D), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, flat, contrib)
    buf = buf.view(E, cap, D)

    # grouped expert GEMMs (weights cast to the activation dtype at use)
    g = torch.bmm(buf, p["w_gate"].to(xt.dtype))
    u = torch.bmm(buf, p["w_up"].to(xt.dtype))
    h = F.silu(g) * u
    out = torch.bmm(h, p["w_down"].to(xt.dtype))

    # combine
    y = out.reshape(E * cap, D)[flat] * (
        gate_w.reshape(-1)[:, None] * keep[:, None]).to(xt.dtype)
    y = y.reshape(Tb, K, D).sum(dim=1)
    return y, aux


def moe_apply(p, cfg: ArchConfig, x: torch.Tensor):
    """x: (B, S, D) -> (y: (B, S, D), aux_loss: scalar)."""
    B, S, D = x.shape
    T = B * S
    y, aux = _dispatch_block(x.reshape(T, D), p, cfg, moe_capacity(cfg, T))
    return y.reshape(B, S, D), aux
