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


def smoke_case(arch: str, seed: int = 0, overrides=None):
    """(model, CPU params from a seeded generator, batch) of a smoke
    config (its fields replaced by ``overrides``, a dict); the batch
    from a numpy seed."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch), **(overrides or {}))
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
        cfg, ShapeSpec("case", S, batch["tokens"].shape[0], "train"), batch,
        mesh))
    return dp, db


def _stubbed(batch, fp32: bool):
    if not fp32:
        return {k: v.bfloat16() if k in ("images", "frames") else v
                for k, v in batch.items()}
    return {k: Fp32Stub(v) if k in ("images", "frames") else v
            for k, v in batch.items()}


def loss_and_grads(rank: int, world: int, archs, mesh_shape, fp32=True,
                   overrides=None, batch: int = B):
    """Per arch: the plain loss and grads, and the loss and grads on
    DTensor params over a ``mesh_shape`` mesh (gathered), in fp32 when
    ``fp32`` (the embedding's cast swapped out, the stubs kept fp32), on
    the smoke batch's first ``batch`` sequences; ``overrides`` replaces
    smoke-config fields of every arch.  An entry of ``archs`` may be
    ``(label, arch, overrides)``: that arch with its own overrides,
    reported under ``label``."""
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer

    mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    out = {}
    set_fp32(fp32)
    try:
        for entry in archs:
            label, arch, ov = ((entry, entry, overrides)
                               if isinstance(entry, str) else entry)
            model, params, full = smoke_case(arch, overrides=ov)
            data = {k: v[:batch] for k, v in full.items()}
            tr = Trainer(model, AdamW(), TrainConfig(), device="cpu")
            l0, g0 = tr.value_and_grad(params, _stubbed(data, fp32))
            dp, db = place(model.cfg, params, data, mesh)
            l1, g1 = tr.value_and_grad(dp, _stubbed(db, fp32))
            g1 = [g.full_tensor() for g in tree_leaves(g1)]
            out[label] = dict(
                plain=float(l0), sharded=float(l1.full_tensor()),
                grad_err=max(float((a - b).abs().max()
                                   / (b.abs().max() + 1e-30))
                             for a, b in zip(g1, tree_leaves(g0))))
    finally:
        set_fp32(False)
    return out


def in_turn(rank: int, world: int, calls):
    """The rank programs of ``calls`` (pairs of a function name of this
    module and its arguments after ``rank, world``) in turn, in one
    group: one group per mesh for several programs.  Their results, in
    order."""
    return [globals()[name](rank, world, *args) for name, args in calls]


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


def _fp32_cache(cache):
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    cache)


def decode_vs_plain(rank: int, world: int, archs, mesh_shape, steps: int = 3,
                    batch: int = B, one_cache: bool = False):
    """Per arch, in fp32: a prefill of the smoke batch's first ``batch``
    sequences (with their image or frame stubs) and ``steps`` greedy
    decode steps, on plain tensors and on DTensors over a ``mesh_shape``
    mesh (params, tokens, stubs and the cache placed by the port's
    rules); the worst absolute logit difference of each step and the
    cache's placements and length.  An entry of ``archs`` may be
    ``(label, arch, overrides)``: that arch with its smoke config's
    fields replaced, reported under ``label``.  ``one_cache``: both
    decodes start from the plain prefill's cache (placed by the rules),
    so no roundoff of the prefill enters them."""
    from repro_torch.models.layers import sharded_scope

    mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    out = {}
    set_fp32(True)
    try:
        for entry in archs:
            label, arch, ov = ((entry, entry, None) if isinstance(entry, str)
                               else entry)
            model, params, full = smoke_case(arch, overrides=ov)
            L = S + steps + 1
            pb = {k: v[:batch] for k, v in full.items()
                  if k in ("tokens", "images", "frames")}
            cache = _fp32_cache(model.init_cache(batch, L, device="cpu"))
            shape = ShapeSpec("case", L, batch, "decode")
            dp = tsh.distribute(params, mesh,
                                tsh.param_specs(model.cfg, params, mesh))
            dc = tsh.distribute(cache, mesh,
                                tsh.cache_specs(model.cfg, shape, cache, mesh))
            db = tsh.distribute(pb, mesh, tsh.batch_specs(
                model.cfg, shape, pb, mesh))
            with sharded_scope(dp):
                l0, c0 = model.prefill(params, _stubbed(pb, True), cache)
                l1, c1 = model.prefill(dp, _stubbed(db, True), dc)
                # a Mamba-2 prefill hands its conv state on in bf16: held
                # in fp32 from here, as the initial cache is
                c0, c1 = _fp32_cache(c0), _fp32_cache(c1)
                if one_cache:
                    c1 = tsh.distribute(
                        tree_map(lambda t: t.clone(), c0), mesh,
                        tsh.cache_specs(model.cfg, shape, c0, mesh))
                errs = [float((l1.full_tensor() - l0).abs().max())]
                for i in range(steps):
                    nxt = l0[:, -1:].argmax(-1).to(torch.int32)
                    dn = tsh.distribute({"token": nxt}, mesh, tsh.batch_specs(
                        model.cfg, shape, {"token": nxt}, mesh))["token"]
                    l0, c0 = model.decode_step(params, nxt, S + i, c0)
                    l1, c1 = model.decode_step(dp, dn, S + i, c1)
                    errs.append(float((l1.full_tensor() - l0).abs().max()))
            out[label] = dict(errs=errs, scale=float(l0.abs().max()),
                              cache_len=int(tree_leaves(c0)[0].shape[2]),
                              placements=[str(t.placements)
                                          for t in tree_leaves(c1)])
    finally:
        set_fp32(False)
    return out


def moe_vs_plain(rank: int, world: int, mesh_shape, cases, seed: int = 0):
    """Per arch and capacity factor of ``cases`` ({arch: factors}): one
    MoE layer of the arch's smoke config in fp32 on plain tensors and on
    DTensors over a ``mesh_shape`` mesh (tokens split over "data",
    experts or d_ff over "model" as the rules place them), the default
    dispatch (one block, the global capacity); the outputs', aux losses'
    and grads' worst differences, the scales, and how many assignments
    the capacity dropped."""
    mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    return {arch: {cf: _moe_case(mesh, arch, cf, seed) for cf in cfs}
            for arch, cfs in cases.items()}


def _moe_case(mesh, arch: str, cf: float, seed: int) -> dict:
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe
    from repro_torch.models.layers import sharded_scope

    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=cf)
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg,
                     device="cpu")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))

    def run(p, x, w):
        y, aux = moe.moe_apply(p, cfg, x)
        loss = (y * w).sum() + aux
        g = torch.autograd.grad(loss, [x] + [p[k] for k in sorted(p)])
        return y, aux, g

    pl = {k: v.clone().requires_grad_() for k, v in p.items()}
    x0 = x.clone().requires_grad_()
    y0, a0, g0 = run(pl, x0, w)
    n_tp = mesh.size(1)
    ep = cfg.n_experts >= n_tp and cfg.n_experts % n_tp == 0
    place = {"router": [Replicate(), Replicate()],
             "w_gate": [Replicate(), Shard(0 if ep else 2)],
             "w_up": [Replicate(), Shard(0 if ep else 2)],
             "w_down": [Replicate(), Shard(0 if ep else 1)]}
    dp = {k: distribute_tensor(v.clone(), mesh, place[k]).requires_grad_()
          for k, v in p.items()}
    dx = distribute_tensor(x.clone(), mesh, [Shard(0), Replicate()])
    dx.requires_grad_()
    dw = distribute_tensor(w, mesh, [Shard(0), Replicate()])
    with sharded_scope(dp):
        y1, a1, g1 = run(dp, dx, dw)
    kept = _kept_assignments(p, cfg, x)
    return dict(
        y_err=float((y1.full_tensor() - y0).abs().max()),
        y_scale=float(y0.abs().max()),
        aux_err=abs(float(a1.full_tensor()) - float(a0)),
        grad_err=max(float((a.full_tensor() - b).abs().max()
                           / (b.abs().max() + 1e-30))
                     for a, b in zip(g1, g0)),
        dropped=B * S * cfg.top_k - kept)


def _kept_assignments(p, cfg, x) -> int:
    """How many of the top-k assignments of ``x``'s tokens the plain
    layer's capacity keeps."""
    from repro_torch.models import moe

    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ p["router"], dim=-1)
    gate_i = torch.sort(probs, dim=-1, descending=True,
                        stable=True)[1][:, :cfg.top_k].reshape(-1)
    cap = moe.moe_capacity(cfg, xt.shape[0])
    counts = torch.bincount(gate_i, minlength=cfg.n_experts)
    return int(torch.clamp(counts, max=cap).sum())


def functional_storages(rank: int, world: int) -> dict:
    """For each ``_c10d_functional`` op of the models' paths, run on the
    group's real tensors: does its result share its input's storage?"""
    import torch.distributed as dist

    ops = torch.ops._c10d_functional
    name = dist.group.WORLD.group_name
    x = torch.arange(8, dtype=torch.float32)

    def shares(out, inp) -> bool:
        return out.untyped_storage()._cdata == inp.untyped_storage()._cdata

    out = {}
    for op, make in {
        "all_reduce": lambda t: ops.all_reduce(t, "sum", name),
        "all_gather_into_tensor": lambda t: ops.all_gather_into_tensor(
            t, world, name),
        "reduce_scatter_tensor": lambda t: ops.reduce_scatter_tensor(
            t, "sum", world, name),
        "all_to_all_single": lambda t: ops.all_to_all_single(
            t, [8 // world] * world, [8 // world] * world, name),
        "broadcast": lambda t: ops.broadcast(t, 0, name),
        "all_reduce_": lambda t: ops.all_reduce_(t, "sum", name),
    }.items():
        t = x.clone()
        r = make(t)
        w = ops.wait_tensor(r)
        out[op] = shares(r, t)
        out.setdefault("wait_tensor", []).append(shares(w, r))
    return out
