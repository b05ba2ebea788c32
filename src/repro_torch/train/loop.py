"""Training loop: microbatched grad accumulation, gradient compression
with error feedback, straggler watchdog, checkpoint/restart (the port of
``repro.train.loop``).

* **the step** — ``torch.autograd.grad`` of ``model.loss`` over the fp32
  master leaves (the model remats each layer under autograd), then the
  compression and the AdamW update.
* **grad accumulation** — ``microbatches`` splits the batch along its
  first axis; the microbatches' grads are summed in order into fp32
  zeros, then loss and grads are divided by their count.
* **gradient compression** — optional bf16 (or int8 with a per-tensor
  scale) round trip with error-feedback residuals.
* **sharded state** — params, moments and batch may be DTensors placed
  by the launch layer's rules; the step (backward and remat included)
  then runs under :func:`~repro_torch.models.layers.sharded_scope`, and
  a microbatch is the same slice of every rank's local batch rows.
* **donation** — ``donate=True`` writes the new params, optimizer state
  and residuals into the old tensors (what ``donate_argnums`` lets XLA
  do); ``donate=False`` leaves the caller's tensors alone.  Both give
  the same bits.
* **straggler watchdog** — per-step wall-time EWMA; steps slower than
  ``watchdog_factor``× the EWMA are logged as straggler events.
* **checkpoint/restart** — atomic ``CheckpointManager``; the data
  pipeline is stateless-by-step, so a resume is bitwise-identical.

``device=None`` means ``cuda``; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core.device import resolve_device
from ..models.layers import is_dtensor, sharded_scope
from ..models.transformer import tree_map
from ..optim import AdamW, OptState

__all__ = ["TrainConfig", "Trainer", "compress_grads"]


def compress_grads(grads, residual, mode: str = "bf16"):
    """Lossy-compress gradients with error feedback.

    Returns (compressed-then-decompressed grads, new residual).  The
    quantize→dequantize round trip models what crosses the interconnect;
    error feedback keeps the *accumulated* quantization error bounded.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    if mode == "none":
        return grads, residual

    def comp(g, r):
        g = g.float() + r
        if mode == "bf16":
            q = g.to(torch.bfloat16).float()
        elif mode == "int8":
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            q = torch.round(g / scale).clamp(-127, 127) * scale
        else:
            raise ValueError(mode)
        return q, g - q

    out = tree_map(comp, grads, residual)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    grad_compression: str = "none"   # none | bf16 | int8
    watchdog_factor: float = 3.0


def _map_state(fn, tree):
    """``fn`` over the leaves of a state tree: dicts, tuples (NamedTuples
    kept) and lists."""
    if isinstance(tree, dict):
        return {k: _map_state(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = [_map_state(fn, v) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    if isinstance(tree, list):
        return [_map_state(fn, v) for v in tree]
    return fn(tree)


def _microbatch(v, i: int, M: int):
    """Microbatch ``i`` of ``M``: rows ``i·B/M .. (i+1)·B/M`` of a plain
    batch leaf; of a DTensor leaf, that slice of every rank's local rows
    (so no rank gathers the batch)."""
    if not is_dtensor(v):
        n = v.shape[0] // M
        return v[i * n:(i + 1) * n]
    from torch.distributed.tensor import DTensor

    loc = v.to_local()
    n = loc.shape[0] // M
    return DTensor.from_local(loc[i * n:(i + 1) * n], v.device_mesh,
                              v.placements, run_check=False)


def _placed_like(g, p):
    """``g`` redistributed to ``p``'s placements where it is a DTensor
    placed otherwise."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


class Trainer:
    def __init__(self, model, optimizer: AdamW, tc: TrainConfig,
                 donate: bool = True, device=None):
        self.model = model
        self.opt = optimizer
        self.tc = tc
        self.donate = donate
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tc.ckpt_dir, tc.ckpt_keep) if tc.ckpt_dir else None
        self.straggler_events: list = []

    def value_and_grad(self, params, batch):
        """(loss, grads tree) of ``model.loss`` at ``params``; on DTensor
        params each grad comes back in its param's placements (a partial
        sum reduce-scattered or reduced, as the reference's grads come
        out placed as its params), not where its last op left it, for
        the optimizer to meet in DTensor's choice of redistribution."""
        with torch.enable_grad(), sharded_scope(params, batch):
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            leaves = []
            tree_map(leaves.append, live)
            loss = self.model.loss(live, batch)
            grads = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda p: _placed_like(next(grads), p), live)
        return loss.detach(), grads

    def grads(self, params, batch):
        """(loss, grads) that one step applies, before compression: with
        ``microbatches > 1`` the microbatches' grads summed in order into
        fp32 zeros, then loss and grads divided by their count."""
        M = self.tc.microbatches
        if M == 1:
            return self.value_and_grad(params, batch)
        g = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        loss = 0.0
        for i in range(M):
            mb = {k: _microbatch(v, i, M) for k, v in batch.items()}
            li, gi = self.value_and_grad(params, mb)
            tree_map(torch.Tensor.add_, g, gi)
            loss = loss + li
            del gi    # freed before the next microbatch's backward
        return loss / M, tree_map(lambda x: x / M, g)

    def step(self, params, opt_state: OptState, residual, batch):
        """One training step: ``(params, opt_state, residual, loss)``."""
        with sharded_scope(params, opt_state, batch):
            return self._step(params, opt_state, residual, batch)

    def _step(self, params, opt_state: OptState, residual, batch):
        tc = self.tc
        loss, g = self.grads(params, batch)
        g, new_res = compress_grads(g, residual, tc.grad_compression)
        if self.donate and tc.grad_compression != "none":
            tree_map(torch.Tensor.copy_, residual, new_res)
        else:
            residual = new_res
        params, opt_state = self.opt.update(g, opt_state, params,
                                            inplace=self.donate)
        return params, opt_state, residual, loss

    def init_state(self, generator):
        """(params, optimizer state, residual) on the trainer's device;
        the residual is 0-d fp32 zeros per leaf without compression."""
        params = self.model.init_params(generator, device=self.device)
        opt_state = self.opt.init(params)
        if self.tc.grad_compression != "none":
            residual = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        else:
            residual = tree_map(lambda p: torch.zeros(
                (), dtype=torch.float32, device=p.device), params)
        return params, opt_state, residual

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(self.device)

    def run(self, generator, data, start_step: int = 0, resume: bool = False):
        params, opt_state, residual = self.init_state(generator)
        step0 = start_step
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            state, meta = self.ckpt.restore((params, opt_state, residual))
            params, opt_state, residual = _map_state(self._to_device, state)
            step0 = meta["step"] + 1

        losses = []
        ewma = None
        for step in range(step0, self.tc.steps):
            t0 = time.perf_counter()
            batch = {k: self._to_device(v) for k, v in data.batch(step).items()}
            params, opt_state, residual, loss = self.step(
                params, opt_state, residual, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.tc.watchdog_factor * ewma and step > step0 + 3:
                self.straggler_events.append((step, dt, ewma))
            losses.append(loss)
            if self.ckpt and (step + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(step, (params, opt_state, residual))
            if (step + 1) % self.tc.log_every == 0:
                print(f"step {step + 1:5d}  loss {loss:.4f}  {dt * 1e3:.0f} ms")
        return params, opt_state, losses
