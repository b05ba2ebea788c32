"""Transfer codecs + the compression rewrite pass over the plan IR
(port of :mod:`repro.core.compress`; host-side numpy, logic verbatim).

On-the-fly CPU-GPU transfer compression for out-of-core stencils
(Shen et al., arXiv 2109.05410 / 2204.11315): the remaining H2D/D2H
traffic after SO2DR's region sharing is itself compressible, and hiding
the codec work behind kernel execution turns the saved wire bytes into
wall-clock time.  This module keeps the two halves of that idea apart:

* **exact encode/decode pairs** — every codec round-trips real bytes.
  Lossless codecs (``identity``, ``zrle``) reproduce the input bit for
  bit, including negative zeros, infinities, and NaN payloads; the lossy
  ``bf16`` codec guarantees a per-element relative error bound
  (:attr:`Codec.max_rel_error`).
* **an analytic ratio model** — :meth:`Codec.wire_nbytes` maps a raw
  byte count to the modeled on-the-wire byte count *deterministically at
  plan time*, so compressed schedules are costed by the same dry-run
  executor as uncompressed ones and accounting stays a property of the
  plan.  For shape-driven codecs (``identity``, ``bf16``) the model is
  exact; for the data-dependent ``zrle`` it is the tuned halo-band
  estimate documented on the class (the measured payload of a concrete
  array is ``codec.encode(arr).nbytes``).

:func:`compress_plan` is the rewrite pass: it wraps every ``H2D``/``D2H``
of a compiled :class:`~repro_torch.core.plan.ExecutionPlan` in a
``Compress``/``Decompress`` pair carrying the codec id and the raw/wire
byte counts — no planner changes, any engine's schedule compresses.  On
a :class:`~repro_torch.core.plan.ShardedPlan` it wraps the halo
exchange instead (``HaloCompress``/``HaloDecompress``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .plan import (
    D2H, H2D, Compress, Decompress, ExecutionPlan, HaloCompress,
    HaloDecompress, HaloRecv, HaloSend, Op, ShardOp, ShardedPlan,
)

__all__ = [
    "Codec",
    "IdentityCodec",
    "Bf16Codec",
    "ZrleCodec",
    "CODECS",
    "register_codec",
    "get_codec",
    "compress_plan",
]


class Codec:
    """One transfer codec: an exact encode/decode pair + a ratio model."""

    name: str = "base"
    lossless: bool = True
    # per-element relative error bound of one encode/decode round trip
    # (0.0 for lossless codecs)
    max_rel_error: float = 0.0
    # element sizes the encode/decode pair can handle (None = any);
    # compress_plan rejects incompatible plans at rewrite time so the
    # dry-run/autotune path can never cost a codec that would crash at
    # execution time
    itemsizes: Optional[Tuple[int, ...]] = None

    def encode(self, arr: np.ndarray) -> np.ndarray:
        """Encode an array into a 1-D ``uint8`` wire payload."""
        raise NotImplementedError

    def decode(self, payload: np.ndarray, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """Decode a wire payload back into an array of ``shape``/``dtype``."""
        raise NotImplementedError

    def wire_nbytes(self, raw_nbytes: int, itemsize: int) -> int:
        """Modeled wire bytes for a ``raw_nbytes`` transfer (plan-time
        deterministic — must not depend on array values)."""
        raise NotImplementedError


class IdentityCodec(Codec):
    """No-op codec: wire bytes equal raw bytes (the uncompressed baseline,
    kept in the registry so sweeps and CI gates treat "no compression" as
    just another codec choice)."""

    name = "identity"
    lossless = True

    def encode(self, arr: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)

    def decode(self, payload: np.ndarray, shape: Tuple[int, ...], dtype) -> np.ndarray:
        return payload.view(dtype).reshape(shape).copy()

    def wire_nbytes(self, raw_nbytes: int, itemsize: int) -> int:
        return raw_nbytes


class Bf16Codec(Codec):
    """fp32 -> bf16 truncation with round-to-nearest-even.

    Keeps the sign, the full 8-bit exponent, and the top 7 mantissa bits
    of every fp32 word: exactly half the wire bytes, with a relative
    error bound of 2**-8 per round trip (one ulp of the 8-bit effective
    mantissa, nearest rounding).  The bound holds for normal values whose
    rounded magnitude stays finite — exactly like standard bf16
    conversion, magnitudes above the bf16 max (~3.39e38) round to inf
    and fp32 denormals (< 2**-126) flush toward zero.  NaN payloads
    survive (the rounding bias never clears an exponent); the decode
    zero-fills the dropped mantissa bits, so re-encoding a decoded array
    is lossless (idempotent across NaiveTB's repeated halo round
    trips)."""

    name = "bf16"
    lossless = False
    itemsizes = (4,)
    max_rel_error = 2.0**-8  # for normal, in-bf16-range values (see docstring)

    def encode(self, arr: np.ndarray) -> np.ndarray:
        if arr.dtype != np.float32:
            raise TypeError(f"bf16 codec expects float32, got {arr.dtype}")
        u = np.ascontiguousarray(arr).view(np.uint32)
        # round to nearest even on the dropped 16 bits; keep NaNs quiet
        bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
        nan = np.isnan(arr)
        hi = np.where(nan, u >> np.uint32(16), (u + bias) >> np.uint32(16))
        return hi.astype(np.uint16).view(np.uint8).reshape(-1)

    def decode(self, payload: np.ndarray, shape: Tuple[int, ...], dtype) -> np.ndarray:
        if np.dtype(dtype) != np.float32:
            raise TypeError(f"bf16 codec expects float32, got {dtype}")
        hi = payload.view(np.uint16).astype(np.uint32)
        return (hi << np.uint32(16)).view(np.float32).reshape(shape).copy()

    def wire_nbytes(self, raw_nbytes: int, itemsize: int) -> int:
        return raw_nbytes // 2


class ZrleCodec(Codec):
    """Row-delta + zero-word run suppression, tuned for stencil halo bands.

    Encode = XOR every row with its predecessor (halo bands are smooth
    along the streaming axis, so consecutive rows share sign/exponent/
    high-mantissa bits and the deltas are full of zero words), then pack
    the flattened delta words as 8-word groups with a presence bitmask:
    one mask byte plus only the nonzero words of each group.  Pure bit
    arithmetic on the ``uint32`` views — exact for every fp32 bit
    pattern, -0.0 and NaN payloads included.

    Wire model: one mask byte per 8 words plus a ``ZERO_WORD_FRACTION``
    of the words suppressed — the plan-time estimate for halo-band
    traffic (the measured payload of a concrete array is
    ``encode(arr).nbytes``), clamped to the raw size so degenerate few-
    word transfers never model as expansion."""

    name = "zrle"
    lossless = True
    itemsizes = (4,)
    # modeled fraction of delta words that are exactly zero on halo bands
    ZERO_WORD_FRACTION = 3.0 / 8.0

    def encode(self, arr: np.ndarray) -> np.ndarray:
        if arr.dtype.itemsize != 4:
            raise TypeError(f"zrle codec expects 4-byte elements, got {arr.dtype}")
        words = np.ascontiguousarray(arr).view(np.uint32)
        if words.ndim >= 2:
            delta = words.copy()
            delta[1:] ^= words[:-1]
        else:
            delta = words
        flat = delta.reshape(-1)
        pad = (-flat.size) % 8
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.uint32)])
        groups = flat.reshape(-1, 8)
        nonzero = groups != 0
        masks = np.packbits(nonzero, axis=1, bitorder="little").reshape(-1)
        literals = groups[nonzero].view(np.uint8)
        return np.concatenate([masks.view(np.uint8), literals.reshape(-1)])

    def decode(self, payload: np.ndarray, shape: Tuple[int, ...], dtype) -> np.ndarray:
        nwords = int(np.prod(shape, dtype=np.int64))
        ngroups = -(-nwords // 8)
        masks = payload[:ngroups]
        nonzero = np.unpackbits(masks, bitorder="little").astype(bool)
        literal_bytes = payload[ngroups:]
        flat = np.zeros(ngroups * 8, np.uint32)
        flat[nonzero] = literal_bytes.view(np.uint32)
        delta = flat[:nwords].reshape(shape)
        if delta.ndim >= 2:
            words = np.bitwise_xor.accumulate(delta, axis=0, dtype=np.uint32)
        else:
            words = delta
        return words.view(dtype).reshape(shape).copy()

    def wire_nbytes(self, raw_nbytes: int, itemsize: int) -> int:
        nwords = raw_nbytes // 4
        masks = -(-nwords // 8)
        literals = nwords - int(nwords * self.ZERO_WORD_FRACTION)
        return min(raw_nbytes, masks + 4 * literals)


CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Add a codec instance to the registry (name collisions are bugs)."""
    if codec.name in CODECS:
        raise ValueError(f"codec {codec.name!r} already registered")
    CODECS[codec.name] = codec
    return codec


for _codec in (IdentityCodec(), Bf16Codec(), ZrleCodec()):
    register_codec(_codec)


def get_codec(codec: Union[str, Codec]) -> Codec:
    if isinstance(codec, Codec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise KeyError(f"unknown codec {codec!r}; known: {sorted(CODECS)}")


def compress_plan(plan, codec: Union[str, Codec]):
    """Rewrite a compiled plan so every transfer goes through ``codec``.

    For an :class:`~repro_torch.core.plan.ExecutionPlan` each
    ``H2D``/``D2H`` is wrapped in a ``Compress``/``Decompress`` pair that
    carries the codec id, the raw byte count, and the modeled wire byte
    count; the wrapped transfer op itself is untouched (its row
    provenance and raw ``nbytes`` stay authoritative).  Everything else —
    kernels, buffer traffic, commit barriers, op order — is preserved, so
    executors that ignore the codec ops would still compute the same
    result.

    For a :class:`~repro_torch.core.plan.ShardedPlan` the pass wraps the
    collective vocabulary instead: every ``HaloSend`` gains a
    ``HaloCompress`` before it, every real ``HaloRecv`` a
    ``HaloDecompress`` after it (mesh-edge zero fills are never
    wrapped), so ``ici_wire_bytes`` diverges from ``ici_bytes`` exactly
    like the H2D wire accounting does.  A
    :class:`~repro_torch.core.hierarchy.HierarchicalPlan` compresses its
    outer sharded plan (inner streams take their own codec at
    :func:`~repro_torch.core.hierarchy.compile_hierarchical` time).
    Anything else raises :class:`TypeError`."""
    if isinstance(plan, ShardedPlan):
        return _compress_sharded(plan, codec)
    if not isinstance(plan, ExecutionPlan):
        if isinstance(getattr(plan, "outer", None), ShardedPlan):
            # HierarchicalPlan (duck-typed: avoids a hierarchy import cycle)
            return dataclasses.replace(
                plan, outer=_compress_sharded(plan.outer, codec))
        raise TypeError(f"compress_plan takes an ExecutionPlan, a "
                        f"ShardedPlan or a HierarchicalPlan, got "
                        f"{type(plan).__name__}")
    if plan.codec:
        raise ValueError(
            f"plan is already compressed with {plan.codec!r}; nesting "
            f"codecs would double-count wire bytes (rewrite the base plan)")
    c = get_codec(codec)
    if c.itemsizes is not None and plan.itemsize not in c.itemsizes:
        raise ValueError(
            f"codec {c.name!r} supports itemsize(s) {c.itemsizes}, but the "
            f"plan has itemsize {plan.itemsize}")
    ops: list[Op] = []
    for op in plan.ops:
        if isinstance(op, (H2D, D2H)):
            direction = "h2d" if isinstance(op, H2D) else "d2h"
            meta = dict(
                codec=c.name,
                reg=op.reg,
                direction=direction,
                raw_nbytes=op.nbytes,
                wire_nbytes=c.wire_nbytes(op.nbytes, plan.itemsize),
                box=op.box,
                round=op.round,
                chunk=op.chunk,
            )
            ops.extend([Compress(**meta), op, Decompress(**meta)])
        else:
            ops.append(op)
    return dataclasses.replace(plan, ops=tuple(ops), codec=c.name)


def _compress_sharded(plan: ShardedPlan,
                      codec: Union[str, Codec]) -> ShardedPlan:
    """The :func:`compress_plan` rewrite over a sharded plan's streams."""
    if plan.codec:
        raise ValueError(
            f"plan is already compressed with {plan.codec!r}; nesting "
            f"codecs would double-count wire bytes (rewrite the base plan)")
    c = get_codec(codec)
    if c.itemsizes is not None and plan.itemsize not in c.itemsizes:
        raise ValueError(
            f"codec {c.name!r} supports itemsize(s) {c.itemsizes}, but the "
            f"plan has itemsize {plan.itemsize}")
    streams: list[Tuple[ShardOp, ...]] = []
    for stream in plan.streams:
        ops: list[ShardOp] = []
        for op in stream:
            if isinstance(op, HaloSend):
                meta = dict(
                    codec=c.name, rank=op.rank, peer=op.dst, axis=op.axis,
                    side=op.side, direction="send", raw_nbytes=op.nbytes,
                    wire_nbytes=c.wire_nbytes(op.nbytes, plan.itemsize),
                    round=op.round, phase=op.phase,
                )
                ops.extend([HaloCompress(**meta), op])
            elif isinstance(op, HaloRecv) and op.src >= 0:
                meta = dict(
                    codec=c.name, rank=op.rank, peer=op.src, axis=op.axis,
                    side=op.side, direction="recv", raw_nbytes=op.nbytes,
                    wire_nbytes=c.wire_nbytes(op.nbytes, plan.itemsize),
                    round=op.round, phase=op.phase,
                )
                ops.extend([op, HaloDecompress(**meta)])
            else:
                ops.append(op)
        streams.append(tuple(ops))
    return dataclasses.replace(plan, streams=tuple(streams), codec=c.name)
