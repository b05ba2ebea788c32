"""End-to-end training driver (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 20 --batch 8 --seq 256

Runs on the GPU (``--device cuda``, the default) or the CPU
(``--device cpu``); ``--smoke`` takes the reduced config.  Prints the
first and last tenth's mean losses.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..data import DataSpec, SyntheticLM
from ..models.api import build_model
from ..optim import AdamW
from ..train import TrainConfig, Trainer

__all__ = ["add_modality_stub", "StubData", "main"]


def add_modality_stub(batch, cfg, rng_seed=0):
    """Stub modality inputs, seeded: bf16 image embeddings for the VLM
    family, bf16 audio-frame embeddings for the enc-dec family (CPU
    tensors; the trainer moves them)."""
    rng = np.random.default_rng(rng_seed)
    B = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["images"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))).to(torch.bfloat16)
    return batch


class StubData:
    """Wraps SyntheticLM adding the per-family modality stubs."""

    def __init__(self, inner: SyntheticLM, cfg):
        self.inner = inner
        self.cfg = cfg

    def batch(self, step: int):
        return add_modality_stub(self.inner.batch(step), self.cfg, step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "bf16", "int8"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' generator")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    data = StubData(
        SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch)),
        cfg,
    )
    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                total_steps=args.steps)
    tc = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, grad_compression=args.grad_compression,
    )
    trainer = Trainer(model, opt, tc, device=args.device)
    gen = torch.Generator(device=trainer.device).manual_seed(args.seed)
    params, opt_state, losses = trainer.run(gen, data, resume=args.resume)
    n = max(len(losses) // 10, 1)
    print(f"first-10-mean {sum(losses[:n]) / n:.4f}  "
          f"last-10-mean {sum(losses[-n:]) / n:.4f}")
    if trainer.straggler_events:
        print(f"straggler events: {len(trainer.straggler_events)}")
    return losses


if __name__ == "__main__":
    main()
