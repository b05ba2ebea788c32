"""Device resolution for the port's entry points.

Every entry point that touches tensors (the executors, ``engine.run``, the
kernel wrappers) takes ``device=None``, and None means ``cuda``.  A run
that asked for the card never carries on quietly on the CPU: with no GPU
the default raises, and a caller that wants the plain CPU path says
``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; None means ``cuda``.

    Raises :class:`RuntimeError` when a CUDA device is asked for (by
    default or by name) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run the plain PyTorch path")
    return dev
