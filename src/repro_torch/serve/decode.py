"""LM serving steps: batched prefill + single-token decode (the port of
``repro.serve.decode``).

``greedy_generate`` is the end-to-end LM decode driver; the serving
layer proper is the stencil service in :mod:`repro_torch.serve.service`.
"""
from __future__ import annotations

import torch

__all__ = ["make_prefill", "make_decode_step", "greedy_generate"]


def make_prefill(model):
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill


def make_decode_step(model):
    def step(params, token, pos, cache):
        return model.decode_step(params, token, pos, cache)
    return step


def _argmax_last(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)


def greedy_generate(model, params, batch, max_new: int, max_len: int):
    """Batched greedy decoding on the device of ``batch["tokens"]``:
    prefill the prompts, then ``max_new - 1`` decode steps; returns the
    (B, max_new) int32 tokens."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = model.init_cache(B, max_len, device=tokens.device)
    logits, cache = model.prefill(params, batch, cache)
    tok = _argmax_last(logits)
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = model.decode_step(params, tok, S + i, cache)
        tok = _argmax_last(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
