"""Collective accounting for the roofline's third term (the port of
``repro.launch.collectives``).

The JAX package parses the compiled HLO module and sums the *result*
size of every ``all-gather`` / ``all-reduce`` / ``reduce-scatter`` /
``all-to-all`` / ``collective-permute``.  PyTorch has no HLO: a DTensor
redistribution issues ``_c10d_functional`` ops, and a halo exchange
``c10d`` sends.  :func:`collective_kind` names each under JAX's op
kinds; :class:`~repro_torch.launch.op_analysis.CostMode` sums their
result bytes per kind (a send's payload for ``collective-permute``), and
:func:`collective_bytes` is that sum for one function.  (Result size is
the standard proxy: for all-gather it's the gathered bytes each device
receives; for all-reduce the reduced tensor crosses links ~2x in a ring
— the roofline multiplies by the per-op ring factor.)
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["collective_bytes", "collective_kind", "RING_FACTORS",
           "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# bytes-on-wire multiplier for ring algorithms, relative to result bytes
RING_FACTORS = {
    "all-gather": 1.0,        # each device receives ~result bytes
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# aten-level collective ops (the overload packet's name) -> JAX's kind
_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    # DTensor's move of a shard from one dim to another on a CUDA mesh
    # (on a CPU mesh it falls back to an all-gather, counted as one)
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}


def collective_kind(func) -> Optional[str]:
    """JAX's collective kind of an aten op overload, or None."""
    return _KINDS.get((func.namespace, func.overloadpacket.__name__))


def collective_bytes(fn, *args, **kwargs) -> Dict[str, float]:
    """Result bytes of every collective ``fn`` issues, per kind."""
    from .op_analysis import analyze

    return analyze(fn, *args, **kwargs)[1].collectives
