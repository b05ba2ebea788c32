"""Params carried between the JAX package and the port.

The port's params have the JAX pytree's layout — the same nested dict
keys, the same shapes (stacked layers keep their leading axes), fp32 —
so a conversion is a map over the leaves.  The JAX side's tree of numpy
arrays is ``jax.tree.map(np.asarray, params)``; this module imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .transformer import tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device=None):
    """A nested dict of numpy arrays -> the same tree of fp32 tensors on
    ``device`` (None means ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev),
        tree)


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`: a tree of tensors (params
    or a cache) -> the same tree of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
