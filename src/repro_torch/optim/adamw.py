"""AdamW with global-norm clipping, warmup-cosine schedule and a
moment-dtype knob (bf16 moments halve optimizer memory) — the port of
``repro.optim.adamw``.

A function of trees of tensors, not a ``torch.optim.Optimizer``: the
state is an :class:`OptState` whose ``mu``/``nu`` mirror the params tree
and whose ``step`` is a 0-d int32 tensor, so a checkpoint of
``(params, opt_state, residual)`` has the JAX package's leaves and keys.
The update is the JAX code's fp32 arithmetic, op for op; each op rounds
once (no FMA contraction), so it agrees with JAX to fp32 roundoff.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from ..models.transformer import tree_leaves, tree_map

__all__ = ["AdamW", "OptState"]


class OptState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # tree like params
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory

    def init(self, params) -> OptState:
        def z(p):
            return torch.zeros_like(p, dtype=self.moment_dtype)

        device = tree_leaves(params)[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(z, params),
            nu=tree_map(z, params),
        )

    def schedule(self, step):
        """The learning rate at ``step`` (an int or an integer tensor), an
        fp32 tensor."""
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (0.1 + 0.9 * cos)

    def update(self, grads, state: OptState, params, inplace: bool = False):
        """``(new params, new state)``.  With ``inplace`` the results are
        written into ``params`` and ``state``'s tensors (the counterpart of
        buffer donation; the same values), leaf by leaf, and the clipped
        grads into ``grads``', so no second copy of the params, moments
        or grads is ever alive."""
        step = state.step + 1
        if self.clip_norm is not None:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                for g in tree_leaves(grads)))
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            if inplace:
                tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads)
            else:
                grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

        lr = self.schedule(step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(self.b1, stepf)
        b2c = 1 - torch.pow(self.b2, stepf)

        def upd(p, g, m, v):
            gf = g.float()
            m32 = m.float() * self.b1 + gf * (1 - self.b1)
            v32 = v.float() * self.b2 + torch.square(gf) * (1 - self.b2)
            mhat = m32 / b1c
            vhat = v32 / b2c
            pf = p.float()
            pnew = pf - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                              + self.weight_decay * pf)
            out = (pnew.to(p.dtype), m32.to(self.moment_dtype),
                   v32.to(self.moment_dtype))
            if not inplace:
                return out
            for dst, src in zip((p, m, v), out):
                dst.copy_(src)
            return p, m, v

        out = tree_map(upd, params, grads, state.mu, state.nu)
        new_p = tree_map(lambda t: t[0], out)   # dicts are the only nodes
        new_m = tree_map(lambda t: t[1], out)
        new_v = tree_map(lambda t: t[2], out)
        if inplace:
            state.step.copy_(step)
            step = state.step
        return new_p, OptState(step=step, mu=new_m, nu=new_v)
