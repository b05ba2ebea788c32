"""Rank programs of the port's launch-layer tests (not a test module; no
JAX here, because every rank process imports it).

Each function runs in every rank of a gloo group of CPU processes
started by ``_torch_spmd.run_spmd`` and returns plain Python or numpy
values.  Inputs come from numpy seeds and ``torch.Generator`` seeds, so
every rank builds the same ones.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api, transformer
from repro_torch.models.api import build_model
from repro_torch.models.transformer import tree_leaves, tree_map

B, S = 4, 16


class Fp32Stub:
    """An image or frame stub that the model's inline bf16 cast
    (``.to(torch.bfloat16)``) hands back in fp32."""

    def __init__(self, tensor):
        self.tensor = tensor

    def to(self, dtype):
        return self.tensor

    def __getattr__(self, name):
        return getattr(self.tensor, name)


def _fp32_embed(p, tokens):
    return transformer.embed_lookup(p["embed"], tokens)


def set_fp32(on: bool) -> None:
    """The embedding's bf16 cast swapped out (fp32 activations) or back."""
    if not hasattr(set_fp32, "orig"):
        set_fp32.orig = (api._embed_tokens, transformer.embed_tokens)
    if on:
        api._embed_tokens = transformer.embed_tokens = _fp32_embed
    else:
        api._embed_tokens, transformer.embed_tokens = set_fp32.orig


def smoke_case(arch: str, seed: int = 0):
    """(model, CPU params from a seeded generator, batch) of a smoke
    config; the batch from a numpy seed."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device="cpu")
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
             "labels": torch.from_numpy(
                 rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    for key, n, fam in (("images", cfg.n_image_tokens, "vlm"),
                        ("frames", cfg.n_frames, "encdec")):
        if cfg.family == fam:
            batch[key] = torch.from_numpy(
                rng.standard_normal((B, n, cfg.d_model)).astype(np.float32))
    return model, params, batch


def place(cfg, params, batch, mesh):
    """Params and batch as DTensors placed by the port's rules."""
    dp = tsh.distribute(params, mesh, tsh.param_specs(cfg, params, mesh))
    db = tsh.distribute(batch, mesh, tsh.batch_specs(
        cfg, ShapeSpec("case", S, B, "train"), batch, mesh))
    return dp, db


def _stubbed(batch, fp32: bool):
    if not fp32:
        return {k: v.bfloat16() if k in ("images", "frames") else v
                for k, v in batch.items()}
    return {k: Fp32Stub(v) if k in ("images", "frames") else v
            for k, v in batch.items()}


def loss_and_grads(rank: int, world: int, archs, mesh_shape, fp32=True):
    """Per arch: the plain loss and grads, and the loss and grads on
    DTensor params over a ``mesh_shape`` mesh (gathered), in fp32 when
    ``fp32`` (the embedding's cast swapped out, the stubs kept fp32)."""
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer

    mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    out = {}
    set_fp32(fp32)
    try:
        for arch in archs:
            model, params, batch = smoke_case(arch)
            tr = Trainer(model, AdamW(), TrainConfig(), device="cpu")
            l0, g0 = tr.value_and_grad(params, _stubbed(batch, fp32))
            dp, db = place(model.cfg, params, batch, mesh)
            l1, g1 = tr.value_and_grad(dp, _stubbed(db, fp32))
            g1 = [g.full_tensor() for g in tree_leaves(g1)]
            out[arch] = dict(
                plain=float(l0), sharded=float(l1.full_tensor()),
                grad_err=max(float((a - b).abs().max()
                                   / (b.abs().max() + 1e-30))
                             for a, b in zip(g1, tree_leaves(g0))))
    finally:
        set_fp32(False)
    return out


def trainer_steps_one_rank(rank: int, world: int, archs, steps: int = 3):
    """Per arch: ``steps`` Trainer steps (bf16 compute, bf16 moments) on
    plain tensors and on DTensors over a (1, 1) mesh from the same
    weights; the losses of both and the count of param and moment
    leaves that differ in any bit."""
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer

    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    out = {}
    for arch in archs:
        model, params, batch = smoke_case(arch)
        batch = _stubbed(batch, False)
        opt = AdamW(lr=1e-3, warmup_steps=1, moment_dtype=torch.bfloat16)
        tr = Trainer(model, opt, TrainConfig(), donate=True, device="cpu")
        p0 = tree_map(torch.clone, params)
        s0 = opt.init(p0)
        specs = tsh.param_specs(model.cfg, params, mesh)
        p1 = tsh.distribute(tree_map(torch.clone, params), mesh, specs)
        s1 = tsh.distribute(opt.init(params), mesh, tsh.opt_specs(specs))
        b1 = tsh.distribute(batch, mesh, tsh.batch_specs(
            model.cfg, ShapeSpec("case", S, B, "train"), batch, mesh))
        losses = []
        for _ in range(steps):
            p0, s0, _, l0 = tr.step(p0, s0, None, batch)
            p1, s1, _, l1 = tr.step(p1, s1, None, b1)
            losses.append((float(l0), float(l1.full_tensor())))
        plain = tree_leaves({"p": p0, "mu": s0.mu, "nu": s0.nu})
        dist = tree_leaves({"p": p1, "mu": s1.mu, "nu": s1.nu})
        out[arch] = dict(losses=losses, leaves=len(plain), differ=sum(
            not torch.equal(a.full_tensor(), b) for a, b in zip(dist, plain)))
    return out


def elastic_save(rank: int, world: int, ckpt_dir: str):
    """(4, 2): qwen3's smoke params placed by ``replan``, gathered and
    saved by rank 0; returns rank 0's saved leaves."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.elastic import gather_full, replan, reshard_restored

    mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
    model, params, _ = smoke_case("qwen3-0.6b")
    sh = replan(model.cfg, model.init_params(None, device="meta"), mesh)
    p4 = reshard_restored(params, sh)       # jax.device_put's counterpart
    assert [t.placements for _, t in _flat(p4)] == [
        s.placements for _, s in _flat(sh)]
    full = gather_full(p4)
    if rank == 0:
        CheckpointManager(ckpt_dir).save(1, full, extra_meta={"mesh": [4, 2]})
    dist.barrier()
    return [t.numpy() for t in tree_leaves(full)] if rank == 0 else None


def elastic_restore(rank: int, world: int, ckpt_dir: str, tokens):
    """(2, 1): the checkpoint restored, resharded by ``reshard_restored``
    onto a ``replan`` of the new mesh; returns the leaves (gathered) and
    the forward's logits on ``tokens``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.elastic import gather_full, replan, reshard_restored

    mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
    model, params, _ = smoke_case("qwen3-0.6b")
    shapes = model.init_params(None, device="meta")
    restored, meta = CheckpointManager(ckpt_dir).restore(params)
    p2 = reshard_restored(restored, replan(model.cfg, shapes, mesh))
    full = gather_full(p2)
    tok = torch.from_numpy(tokens)
    db = tsh.distribute({"tokens": tok}, mesh, tsh.batch_specs(
        model.cfg, ShapeSpec("case", tok.shape[1], tok.shape[0], "prefill"),
        {"tokens": tok}, mesh))
    logits, _ = model.forward(p2, db)
    return dict(mesh=meta["mesh"],
                leaves=[t.numpy() for t in tree_leaves(full)],
                placements=[str(t.placements) for t in tree_leaves(p2)],
                logits=logits.full_tensor().float().numpy())


def moe_shard_map(rank: int, world: int, params_np, x_np):
    """The shard_map MoE on a (2, 2) mesh: tokens over "data", d_ff over
    "model"; returns (y, aux) gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    cfg = get_smoke_config("mixtral-8x7b")
    p = {k: distribute_tensor(torch.from_numpy(v), mesh,
                              [Replicate(), Replicate()])
         for k, v in params_np.items()}
    x = distribute_tensor(torch.from_numpy(x_np), mesh, [Shard(0), Replicate()])
    moe.set_moe_shard_map(mesh, "data")
    try:
        from repro_torch.models.layers import sharded_scope

        with sharded_scope(p):
            y, aux = moe._moe_shard_map_apply(p, cfg, x)
    finally:
        moe.set_moe_shard_map(None, None)
    return y.full_tensor().numpy(), float(aux.full_tensor())


def _flat(tree):
    out = []
    tsh.map_with_path(lambda p, x: out.append((p, x)), tree)
    return sorted(out, key=lambda kv: kv[0])
