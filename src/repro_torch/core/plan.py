"""Typed op IR for out-of-core stencil schedules (plan/execute split);
the port of :mod:`repro.core.plan`: the single-device ops and
:class:`ExecutionPlan`, and the sharded ops and :class:`ShardedPlan`.

Every engine in :mod:`repro_torch.core.oocore` is a *planner*: it compiles
``(domain shape, stencil, d, k_off, k_on, n)`` into an
:class:`ExecutionPlan` — a flat sequence of ops over named device
*registers* (working bands) and named device *buffers* (region-sharing
carries).  The executors in :mod:`repro_torch.core.executor` then interpret the
same plan eagerly, software-pipelined, or as a zero-device dry run.

Coordinates are **boxes**: every transfer/kernel op carries an N-D
:class:`Box` (per-axis ``[lo, hi)`` intervals over the framed domain), so
the same IR expresses classic row-range streaming (a 1-axis box over a
2-D domain), column chunking (``chunk_axis=1``), and 3-D tile plans with
temporal blocking.  Byte and element accounting derive from box volumes,
so the old row plans compile to bit-identical schedules as the
degenerate 1-axis case.

Op vocabulary (the paper's Fig. 7 cost categories map 1:1 onto op types):

=============  =============================================  ===========
op             semantics                                      Fig. 7 bar
=============  =============================================  ===========
H2D            ``reg = host[box]``                            HtoD
BufferWrite    ``buffer[buf] = reg[reg_box]``                 O/D copy
BufferRead     ``reg = concat(buffer[buf], reg[src], axis)``  O/D copy
FusedKernel    ``reg = fused_step(reg, steps, keeps)``        Kernel
D2H            stage ``reg[reg_box] -> host[box]``            DtoH
HostCommit     flush staged D2H boxes into the host array     (barrier)
Compress       encode the wrapped transfer's payload          HtoD/DtoH
Decompress     decode it on the other side of the wire        HtoD/DtoH
=============  =============================================  ===========

``Compress``/``Decompress`` are transfer *transformations*
(arXiv 2204.11315): the rewrite pass in :mod:`repro_torch.core.compress` wraps
every ``H2D``/``D2H`` in an encode/decode pair carrying the codec id,
the raw byte count, and the modeled wire byte count, so the dry-run
executor costs compressed schedules exactly like uncompressed ones.

Each op carries its exact byte count and ``(round, chunk)`` provenance, so
:meth:`ExecutionPlan.stats` derives the full :class:`TransferStats` —
h2d/d2h/buffer/kernel bytes, FLOPs, redundancy — from the plan alone,
with zero device work.  That is what lets the autotuner cost the whole
``(d, k_off, k_on)`` (and tile box x time depth) sweep analytically and
what keeps the measured and predicted accounting equal *by construction*.

``HostCommit`` is the only ordering barrier an executor must respect:
ops between two commits may be reordered/overlapped as long as
register/buffer data dependencies hold (the double-buffered executor
exploits exactly this to prefetch chunk ``i+1``'s H2D under chunk ``i``'s
kernels).

The JAX package's deprecated row-range accessors of the single-device
ops (``host_lo``, ``keep_top``, ...) are not ported: the port has no
pre-box callers.  Every op's ``repr`` equals the JAX package's for the
same plan, so :func:`~repro_torch.core.recovery.plan_fingerprint` does too.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Box", "TransferStats",
    "H2D", "D2H", "BufferWrite", "BufferRead", "FusedKernel", "HostCommit",
    "Compress", "Decompress",
    "Op", "ExecutionPlan", "PlanBuilder",
    "fused_kernel_geometry", "fused_box_geometry",
    "DeviceShard", "HaloSend", "HaloRecv", "ShardLoad", "ShardStore",
    "ShardKernel", "HaloCompress", "HaloDecompress", "ShardOp",
    "ShardedPlan",
]


@dataclasses.dataclass(frozen=True)
class Box:
    """An N-D half-open interval product: ``[lo[a], hi[a])`` per axis.

    The coordinate type of the plan IR.  Immutable and hashable; all
    helpers return new boxes.  A classic row range ``[lo, hi)`` over a
    framed ``(Y, X)`` domain is the degenerate 1-axis box
    ``Box((lo, 0), (hi, X))``."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    def __post_init__(self):
        lo, hi = tuple(self.lo), tuple(self.hi)
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)
        if len(lo) != len(hi):
            raise ValueError(f"rank mismatch: lo={lo} hi={hi}")
        if any(a > b for a, b in zip(lo, hi)):
            raise ValueError(f"empty/negative box: lo={lo} hi={hi}")

    @classmethod
    def from_shape(cls, shape: Sequence[int]) -> "Box":
        """The full-domain box ``[0, shape[a])`` per axis."""
        return cls(tuple(0 for _ in shape), tuple(shape))

    @classmethod
    def span(cls, shape: Sequence[int], axis: int, lo: int, hi: int) -> "Box":
        """A box covering ``[lo, hi)`` along ``axis`` and the full extent
        of ``shape`` elsewhere — the degenerate 1-axis chunk."""
        los = [0] * len(shape)
        his = list(shape)
        los[axis], his[axis] = lo, hi
        return cls(tuple(los), tuple(his))

    @property
    def ndim(self) -> int:
        return len(self.lo)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.lo, self.hi))

    @property
    def volume(self) -> int:
        return math.prod(self.shape)

    def extent(self, axis: int) -> int:
        return self.hi[axis] - self.lo[axis]

    def slices(self) -> Tuple[slice, ...]:
        """Index tuple selecting this box out of a domain-shaped array."""
        return tuple(slice(a, b) for a, b in zip(self.lo, self.hi))

    def with_axis(self, axis: int, lo: int, hi: int) -> "Box":
        los, his = list(self.lo), list(self.hi)
        los[axis], his[axis] = lo, hi
        return Box(tuple(los), tuple(his))

    def shrink(self, lo_by: Sequence[int], hi_by: Sequence[int]) -> "Box":
        """Shrink per axis by ``lo_by[a]`` at the low side and
        ``hi_by[a]`` at the high side (negative values grow)."""
        return Box(tuple(a + d for a, d in zip(self.lo, lo_by)),
                   tuple(b - d for b, d in zip(self.hi, hi_by)))

    def translate(self, offset: Sequence[int]) -> "Box":
        return Box(tuple(a + o for a, o in zip(self.lo, offset)),
                   tuple(b + o for b, o in zip(self.hi, offset)))

    def contains(self, other: "Box") -> bool:
        return all(a <= oa and ob <= b for a, oa, ob, b in
                   zip(self.lo, other.lo, other.hi, self.hi))


@dataclasses.dataclass
class TransferStats:
    """Byte/FLOP accounting for one engine run (paper Fig. 7 categories).

    ``*_bytes`` are the *raw* (uncompressed) transfer payloads — the box
    geometry the planner scheduled.  ``*_wire_bytes`` are what actually
    crosses the interconnect: equal to raw on uncompressed plans, and the
    codec-encoded sizes on plans rewritten by
    :func:`repro_torch.core.compress.compress_plan` (arXiv 2204.11315-style
    on-the-fly transfer compression)."""

    h2d_bytes: int = 0
    d2h_bytes: int = 0
    h2d_wire_bytes: int = 0     # interconnect bytes after codec encoding
    d2h_wire_bytes: int = 0
    codec_ops: int = 0          # Compress + Decompress op count
    buffer_bytes: int = 0       # on-device region-sharing copies ("O/D")
    ici_bytes: int = 0          # inter-chip halo payload (send side)
    ici_wire_bytes: int = 0     # ICI bytes after halo codec encoding
    halo_ops: int = 0           # HaloSend + paired HaloRecv op count
    kernel_calls: int = 0
    kernel_hbm_bytes: int = 0   # per-call band read + output write traffic
    flops: int = 0
    elements_computed: int = 0  # element-updates incl. redundant ones
    exact_elements: int = 0     # n * interior elements (the useful work)

    @property
    def redundant_elements(self) -> int:
        return self.elements_computed - self.exact_elements

    @property
    def redundancy(self) -> float:
        return self.redundant_elements / max(self.exact_elements, 1)

    @property
    def transfer_bytes(self) -> int:
        """Raw H2D + D2H payload (codec-independent box geometry)."""
        return self.h2d_bytes + self.d2h_bytes

    @property
    def wire_bytes(self) -> int:
        """H2D + D2H bytes that actually cross the interconnect."""
        return self.h2d_wire_bytes + self.d2h_wire_bytes

    @property
    def compression_ratio(self) -> float:
        """wire / raw — 1.0 for uncompressed plans, < 1.0 when a codec
        shrinks the transfers."""
        return self.wire_bytes / max(self.transfer_bytes, 1)

    def breakdown(self) -> Dict[str, int]:
        """Per-category byte totals (the paper's Fig. 7 bars plus the
        L2 ``ici`` category) — one key set for every plan type."""
        return {
            "h2d": self.h2d_bytes,
            "d2h": self.d2h_bytes,
            "h2d_wire": self.h2d_wire_bytes,
            "d2h_wire": self.d2h_wire_bytes,
            "odc": self.buffer_bytes,
            "ici": self.ici_bytes,   # 0 for single-device plans
            "ici_wire": self.ici_wire_bytes,
            "kernel_hbm": self.kernel_hbm_bytes,
        }


@dataclasses.dataclass(frozen=True)
class H2D:
    """Load host box ``box`` into register ``reg``."""

    reg: str
    box: Box
    nbytes: int
    round: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class D2H:
    """Stage register box ``reg_box`` (register-relative coordinates) for
    host box ``box``; visible on host after the next HostCommit.  The
    register is dead afterwards (planners emit D2H as its last use)."""

    reg: str
    reg_box: Box     # relative to the register's current band
    box: Box         # absolute host coordinates
    nbytes: int
    round: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class BufferWrite:
    """On-device copy of register box ``reg_box`` (register-relative)
    into the named region-sharing buffer ``buf`` (paper: the O/D traffic
    of Alg. 1 l. 6 / Fig. 2b's shared regions)."""

    buf: str
    reg: str
    reg_box: Box     # relative to the register's current band
    nbytes: int
    round: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class BufferRead:
    """``reg = concat(buffer[buf], reg[src], axis)`` — consume a shared
    region (each buffer is written once and read exactly once, by the
    next chunk).  The buffer's ``extent`` slices are prepended at the low
    side of ``axis``."""

    reg: str
    buf: str
    src: str
    nbytes: int      # bytes of the buffer slices read
    axis: int        # concatenation axis
    extent: int      # buffer extent along ``axis``
    round: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class FusedKernel:
    """``steps`` fused stencil steps on register ``reg`` (in place).

    Carries the full kernel-phase accounting, precomputed at plan time:
    the compute volume shrinks by ``r`` per step on every non-frame side
    (``keep_lo``/``keep_hi`` per axis), HBM traffic is one input-band
    read + one output-band write."""

    reg: str
    stencil: str
    steps: int
    keep_lo: Tuple[bool, ...]    # per axis: low-side frame kept
    keep_hi: Tuple[bool, ...]    # per axis: high-side frame kept
    shape_in: Tuple[int, ...]
    shape_out: Tuple[int, ...]
    hbm_bytes: int
    flops: int
    elements: int    # element-updates incl. redundant ones
    round: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class _CodecOp:
    """Shared shape of the encode/decode halves of a wrapped transfer.

    Both halves carry the same provenance — the codec id, the raw and
    modeled-wire byte counts, and the wrapped ``H2D``/``D2H``'s register
    and host box — so :func:`repro_torch.core.compress.compress_plan` builds
    one metadata dict and instantiates the pair from it.
    ``wire_nbytes`` is the codec's analytic ratio model — deterministic
    at plan time, so accounting stays a property of the plan."""

    codec: str
    reg: str
    direction: str   # "h2d" | "d2h"
    raw_nbytes: int
    wire_nbytes: int
    box: Box         # wrapped transfer's host-box provenance
    round: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class Compress(_CodecOp):
    """Encode the payload of the adjacent wrapped transfer.

    Emitted by :func:`repro_torch.core.compress.compress_plan` immediately
    *before* the ``H2D``/``D2H`` it wraps.  For ``direction == "h2d"``
    the encode runs host-side (the wire then carries ``wire_nbytes``);
    for ``"d2h"`` it runs device-side before the staging copy."""


@dataclasses.dataclass(frozen=True)
class Decompress(_CodecOp):
    """Decode the wrapped transfer's payload on the far side of the wire.

    Emitted immediately *after* the wrapped ``H2D``/``D2H``: device-side
    for ``"h2d"`` (the register materializes here), host-side for
    ``"d2h"`` (the staged box is decoded at the ``HostCommit``
    barrier)."""


@dataclasses.dataclass(frozen=True)
class HostCommit:
    """Flush all staged D2H writes to the host array.

    A scheduling barrier: ops must not be moved across it (temporal
    blocking's ping-pong host state relies on round ``t+1`` reading
    pre-commit boxes of round ``t``)."""

    nbytes: int      # staged bytes flushed by this commit
    round: int


Op = Union[H2D, D2H, BufferWrite, BufferRead, FusedKernel, HostCommit,
           Compress, Decompress]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A compiled transfer/kernel schedule for one engine configuration.

    ``shape`` is the framed N-D host domain; ``chunk_axis`` is the
    streaming axis of 1-axis plans; ``tiles`` (per-axis tile counts) is
    non-empty for multi-axis box plans (``d == prod(tiles)``).  ``k_off``
    doubles as the temporal-blocking time depth ``t`` — the number of
    time steps advanced per H2D round trip."""

    engine: str
    stencil: str
    shape: Tuple[int, ...]
    itemsize: int
    n: int
    d: int
    k_off: int
    k_on: int
    exact_elements: int
    ops: Tuple[Op, ...]
    codec: str = ""     # "" = uncompressed; else the wrapping codec's name
    chunk_axis: int = 0
    tiles: Tuple[int, ...] = ()

    @property
    def Y(self) -> int:
        """First-axis extent (rows of a 2-D domain)."""
        return self.shape[0]

    @property
    def X(self) -> int:
        """Last-axis extent (columns of a 2-D domain)."""
        return self.shape[-1]

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __len__(self) -> int:
        return len(self.ops)

    def stats(self) -> TransferStats:
        """Derive the complete :class:`TransferStats` from the op stream.

        This is the single source of truth for accounting: the dry-run
        executor returns it untouched, and the eager/double-buffered
        executors return it alongside the computed domain."""
        s = TransferStats(exact_elements=self.exact_elements)
        for op in self.ops:
            if isinstance(op, H2D):
                s.h2d_bytes += op.nbytes
                s.h2d_wire_bytes += op.nbytes
            elif isinstance(op, D2H):
                s.d2h_bytes += op.nbytes
                s.d2h_wire_bytes += op.nbytes
            elif isinstance(op, (BufferWrite, BufferRead)):
                s.buffer_bytes += op.nbytes
            elif isinstance(op, FusedKernel):
                s.kernel_calls += 1
                s.kernel_hbm_bytes += op.hbm_bytes
                s.flops += op.flops
                s.elements_computed += op.elements
            elif isinstance(op, Compress):
                # the wrapped transfer contributed raw bytes to the wire
                # accumulator above; the codec swaps them for wire bytes
                s.codec_ops += 1
                if op.direction == "h2d":
                    s.h2d_wire_bytes += op.wire_nbytes - op.raw_nbytes
                else:
                    s.d2h_wire_bytes += op.wire_nbytes - op.raw_nbytes
            elif isinstance(op, Decompress):
                s.codec_ops += 1
        return s

    def breakdown(self) -> Dict[str, int]:
        """Per-category byte totals (the paper's Fig. 7 bars) read
        directly off the op stream."""
        return self.stats().breakdown()

    def op_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            k = type(op).__name__
            out[k] = out.get(k, 0) + 1
        return out

    def stages(self) -> List[Tuple[Optional[Tuple[int, int]], List[Op]]]:
        """Group ops into pipeline stages.

        Returns ``[(key, ops), ...]`` where ``key`` is ``(round, chunk)``
        for chunk work and ``None`` for a HostCommit barrier.  Stage order
        equals plan order; the double-buffered executor prefetches the
        next stage's H2D ops while the current stage's kernels are in
        flight, never crossing a barrier."""
        out: List[Tuple[Optional[Tuple[int, int]], List[Op]]] = []
        for op in self.ops:
            if isinstance(op, HostCommit):
                out.append((None, [op]))
                continue
            key = (op.round, op.chunk)
            if out and out[-1][0] == key:
                out[-1][1].append(op)
            else:
                out.append((key, [op]))
        return out


# --------------------------------------------------------------------------
# Sharded plans (L2 / inter-chip): per-device op streams + halo exchange.
#
# The L2 engine (the JAX package's :mod:`repro.core.distributed`) trades
# redundant ghost-wedge computation for k_ici-step communication-avoiding
# halo exchange — the paper's core trade one memory level up.  The IR below
# makes that schedule a first-class plan: a :class:`ShardedPlan` holds one
# op stream per :class:`DeviceShard` plus a global barrier structure
# (``barriers``), and its accounting — ICI bytes, ghost-wedge redundancy,
# collective bytes per round — is derived from the op streams exactly
# like :class:`TransferStats` is derived from an :class:`ExecutionPlan`.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceShard:
    """Provenance of one device's sub-domain in a sharded plan.

    ``(row, col)`` are mesh coordinates; ``[y0, y1) x [x0, x1)`` is the
    owned region of the global framed domain (uniform across ranks — the
    shard_map backend requires even divisibility)."""

    rank: int
    row: int
    col: int
    y0: int
    y1: int
    x0: int
    x1: int

    @property
    def box(self) -> Box:
        """The owned region as a :class:`Box` (the plan IR's coordinate
        type — ShardLoad/ShardStore carry the same box)."""
        return Box((self.y0, self.x0), (self.y1, self.x1))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.y1 - self.y0, self.x1 - self.x0)


def _deprecated(name: str, instead: str):
    warnings.warn(
        f"{name} is deprecated; read the op's {instead} instead",
        DeprecationWarning, stacklevel=3)


class _ShardRegionOp:
    """Deprecated scalar accessors shared by ShardLoad/ShardStore."""

    @property
    def y0(self) -> int:
        _deprecated(f"{type(self).__name__}.y0", "box.lo")
        return self.box.lo[0]

    @property
    def y1(self) -> int:
        _deprecated(f"{type(self).__name__}.y1", "box.hi")
        return self.box.hi[0]

    @property
    def x0(self) -> int:
        _deprecated(f"{type(self).__name__}.x0", "box.lo")
        return self.box.lo[1]

    @property
    def x1(self) -> int:
        _deprecated(f"{type(self).__name__}.x1", "box.hi")
        return self.box.hi[1]


@dataclasses.dataclass(frozen=True)
class ShardLoad(_ShardRegionOp):
    """Place the shard's owned region on its device (the once-per-run
    H2D of the L2 schedule — the domain then stays resident)."""

    rank: int
    box: Box
    nbytes: int
    round: int
    phase: int


@dataclasses.dataclass(frozen=True)
class ShardStore(_ShardRegionOp):
    """Stage the shard's owned region back to the host (committed at the
    final barrier)."""

    rank: int
    box: Box
    nbytes: int
    round: int
    phase: int


@dataclasses.dataclass(frozen=True)
class HaloSend:
    """Send ``depth`` edge rows/columns of this rank's band to ``dst``.

    ``axis`` 0 exchanges rows of the owned band; ``axis`` 1 exchanges
    columns of the *row-extended* band (corners ride along — the
    ppermute ordering of :mod:`repro.core.distributed`).  ``side`` names
    the edge of the sender's band: ``"hi"`` (bottom/right) payloads
    attach at the receiver's ``"lo"`` (top/left) edge and vice versa.
    ``nbytes`` is the send-side ICI payload."""

    rank: int        # src shard
    dst: int         # dst shard
    axis: int        # 0 = rows, 1 = columns
    side: str        # "lo" | "hi" — sender's edge
    depth: int       # k_ici * r rows/cols
    nbytes: int
    round: int
    phase: int


@dataclasses.dataclass(frozen=True)
class HaloRecv:
    """Attach a neighbour's halo payload at this rank's ``side`` edge.

    ``src == -1`` marks a mesh edge: the band is zero-padded instead
    (exactly what ``ppermute`` leaves for non-receivers) and no ICI
    traffic occurs (``nbytes == 0``).  Every real recv (``src >= 0``)
    pairs 1:1 with a :class:`HaloSend` in the source rank's stream."""

    rank: int        # dst shard (owner of this stream)
    src: int         # src shard; -1 = mesh edge (zero fill)
    axis: int
    side: str        # "lo" | "hi" — receiver's edge
    depth: int
    nbytes: int      # 0 when src == -1
    round: int
    phase: int


@dataclasses.dataclass(frozen=True)
class ShardKernel:
    """``steps`` fused, globally-masked stencil steps on the extended
    band, cropped back to the owned region.

    The band covers ``[gy0, gy0+h) x [gx0, gx0+w)`` in global
    coordinates (origin = owned region minus the ``k_ici*r`` halo).
    ``elements`` counts every updated element per round — the owned
    interior *plus* the redundant ghost wedges; ``hbm_bytes`` is one
    band read + one band write per fused call, mirroring
    :func:`fused_box_geometry`'s model."""

    rank: int
    stencil: str
    steps: int
    gy0: int
    gx0: int
    h: int
    w: int
    hbm_bytes: int
    flops: int
    elements: int
    round: int
    phase: int


@dataclasses.dataclass(frozen=True)
class _HaloCodecOp:
    """Shared shape of the encode/decode halves of a compressed halo.

    The collective analogue of :class:`_CodecOp`: both halves carry the
    codec id, the raw and modeled-wire byte counts, and the wrapped
    ``HaloSend``/``HaloRecv``'s edge provenance, so
    :func:`repro_torch.core.compress.compress_plan` builds one metadata dict
    per exchange and instantiates the pair from it.  ``wire_nbytes`` is
    the codec's deterministic analytic model — ICI accounting stays a
    property of the plan."""

    codec: str
    rank: int        # owner of the stream this op lives in
    peer: int        # the other end of the exchange (dst for send side)
    axis: int
    side: str        # the wrapped op's edge
    direction: str   # "send" | "recv"
    raw_nbytes: int
    wire_nbytes: int
    round: int
    phase: int


@dataclasses.dataclass(frozen=True)
class HaloCompress(_HaloCodecOp):
    """Encode a halo payload before it crosses the ICI link.

    Emitted immediately *before* the ``HaloSend`` it wraps; the wire
    then carries ``wire_nbytes`` instead of ``raw_nbytes``."""


@dataclasses.dataclass(frozen=True)
class HaloDecompress(_HaloCodecOp):
    """Decode a received halo payload on the far side of the ICI link.

    Emitted immediately *after* the real ``HaloRecv`` it wraps (edge
    recvs — ``src == -1`` zero fills — are never wrapped)."""


ShardOp = Union[ShardLoad, ShardStore, HaloSend, HaloRecv, ShardKernel,
                HaloCompress, HaloDecompress]


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """A compiled multi-device schedule: one op stream per shard.

    ``barriers`` is the global barrier structure: a tuple of phase
    labels; every op's ``phase`` indexes into it, and an executor must
    run phase ``p`` of *every* stream before any op of phase ``p+1``
    (within a phase, rank order is free — sends and recvs live in
    separate phases, so the lockstep is deadlock-free by construction).
    """

    stencil: str
    Y: int
    X: int
    itemsize: int
    n: int
    k_ici: int
    mesh_shape: Tuple[int, int]
    radius: int
    shards: Tuple[DeviceShard, ...]
    streams: Tuple[Tuple[ShardOp, ...], ...]
    barriers: Tuple[str, ...]
    exact_elements: int
    codec: str = ""     # "" = uncompressed halos; else the halo codec name
    trailing: Tuple[int, ...] = ()  # unsharded trailing axes (modeled only)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.Y, self.X)

    @property
    def n_ranks(self) -> int:
        return len(self.shards)

    @property
    def rounds(self) -> int:
        return self.n // self.k_ici

    def __len__(self) -> int:
        return sum(len(s) for s in self.streams)

    def _accumulate(self, s: "TransferStats", ops) -> "TransferStats":
        for op in ops:
            if isinstance(op, ShardLoad):
                s.h2d_bytes += op.nbytes
                s.h2d_wire_bytes += op.nbytes
            elif isinstance(op, ShardStore):
                s.d2h_bytes += op.nbytes
                s.d2h_wire_bytes += op.nbytes
            elif isinstance(op, HaloSend):
                s.ici_bytes += op.nbytes
                s.ici_wire_bytes += op.nbytes
                s.halo_ops += 1
            elif isinstance(op, HaloRecv):
                if op.src >= 0:
                    s.halo_ops += 1
            elif isinstance(op, HaloCompress):
                # the wrapped send contributed raw bytes to the wire
                # accumulator above; the codec swaps them for wire bytes
                s.codec_ops += 1
                s.ici_wire_bytes += op.wire_nbytes - op.raw_nbytes
            elif isinstance(op, HaloDecompress):
                s.codec_ops += 1
            elif isinstance(op, ShardKernel):
                s.kernel_calls += 1
                s.kernel_hbm_bytes += op.hbm_bytes
                s.flops += op.flops
                s.elements_computed += op.elements
            else:  # pragma: no cover - planner/IR version skew
                raise TypeError(f"unknown sharded op {op!r}")
        return s

    def stats(self) -> TransferStats:
        """Aggregate :class:`TransferStats` over every rank's stream —
        the single source of truth for the sharded accounting, derived
        from the plan with zero device work (the dry-run executor
        returns it untouched)."""
        s = TransferStats(exact_elements=self.exact_elements)
        for stream in self.streams:
            self._accumulate(s, stream)
        return s

    def per_rank_stats(self, rank: int) -> TransferStats:
        """One rank's accounting; ``exact_elements`` is the rank's share
        (``n x`` its owned-interior elements)."""
        sh = self.shards[rank]
        r = self.radius
        rows = max(0, min(sh.y1, self.Y - r) - max(sh.y0, r))
        cols = max(0, min(sh.x1, self.X - r) - max(sh.x0, r))
        s = TransferStats(exact_elements=self.n * rows * cols)
        return self._accumulate(s, self.streams[rank])

    def ici_bytes_per_round(self, rank: int) -> int:
        """Plan-derived send-side ICI bytes one rank pushes per round
        (uniform across rounds — round 0 is read off the stream)."""
        return sum(op.nbytes for op in self.streams[rank]
                   if isinstance(op, HaloSend) and op.round == 0)

    @property
    def collective_bytes_per_round(self) -> int:
        """Per-rank ICI bytes per round, derived from the op streams
        (max over ranks).  For a rank with neighbours on both sides of
        both mesh axes this equals the analytic formula in
        :func:`repro_torch.core.distributed.collective_bytes_per_round`; edge
        ranks push less (no payload crosses a mesh boundary)."""
        return max((self.ici_bytes_per_round(r) for r in range(self.n_ranks)),
                   default=0)

    def ici_wire_bytes_per_round(self, rank: int) -> int:
        """Round-0 *wire* bytes one rank pushes: raw send payloads plus
        any halo-codec wire-vs-raw adjustments (equal to
        :meth:`ici_bytes_per_round` on uncompressed plans)."""
        total = 0
        for op in self.streams[rank]:
            if op.round != 0:
                continue
            if isinstance(op, HaloSend):
                total += op.nbytes
            elif isinstance(op, HaloCompress):
                total += op.wire_nbytes - op.raw_nbytes
        return total

    @property
    def collective_wire_bytes_per_round(self) -> int:
        """Wire-byte counterpart of :attr:`collective_bytes_per_round` —
        what the autotuner charges against ``bw_ici`` once halos are
        routed through a codec."""
        return max((self.ici_wire_bytes_per_round(r)
                    for r in range(self.n_ranks)), default=0)

    def breakdown(self) -> Dict[str, int]:
        """Per-category byte totals — the Fig. 7 bars plus the L2 ICI
        category (same keys as :meth:`ExecutionPlan.breakdown`)."""
        return self.stats().breakdown()

    def op_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for stream in self.streams:
            for op in stream:
                k = type(op).__name__
                out[k] = out.get(k, 0) + 1
        return out

    def phases(self) -> List[Tuple[str, List[ShardOp]]]:
        """Ops grouped by global phase, in barrier order (rank order
        within a phase) — the structure executors walk."""
        out: List[Tuple[str, List[ShardOp]]] = [
            (label, []) for label in self.barriers]
        for stream in self.streams:
            for op in stream:
                out[op.phase][1].append(op)
        return out


def fused_box_geometry(
    radius: int, flops_per_elem: int, shape: Sequence[int], steps: int,
    keep_lo: Sequence[bool], keep_hi: Sequence[bool], itemsize: int,
) -> Tuple[Tuple[int, ...], int, int, int]:
    """Accounting for one fused kernel call on an N-D band.

    Returns ``(shape_out, hbm_bytes, flops, elements)``: per step the
    compute volume is the band interior (every axis loses ``r`` per
    side), and each axis whose side is a domain frame (``keep_*``) gets
    its ``r`` frame slices passed through, so kept axes hold their
    extent while free sides shrink by ``r`` per step.  HBM traffic is
    one read of the input band plus one write of the output band."""
    r = radius
    cur = list(shape)
    vol_in = math.prod(cur)
    flops = 0
    elements = 0
    for _ in range(steps):
        interior = [c - 2 * r for c in cur]
        e = math.prod(interior)
        elements += e
        flops += e * flops_per_elem
        cur = [c - 2 * r + (int(kl) + int(kh)) * r
               for c, kl, kh in zip(cur, keep_lo, keep_hi)]
    hbm_bytes = (vol_in + math.prod(cur)) * itemsize
    return tuple(cur), hbm_bytes, flops, elements


def fused_kernel_geometry(
    radius: int, flops_per_elem: int, h: int, X: int, steps: int,
    keep_top: bool, keep_bottom: bool, itemsize: int,
) -> Tuple[int, int, int, int]:
    """Row-band special case of :func:`fused_box_geometry` (kept for the
    pre-box callers): returns ``(h_out, hbm_bytes, flops, elements)``."""
    shape_out, hbm, flops, elems = fused_box_geometry(
        radius, flops_per_elem, (h, X), steps,
        (keep_top, True), (keep_bottom, True), itemsize)
    return shape_out[0], hbm, flops, elems


class PlanBuilder:
    """Validating builder the engine planners drive.

    Tracks every live register/buffer's *global* box (absolute framed-
    domain coordinates) so emitted byte counts and geometry are
    consistent; catches planner bugs (reading an unwritten buffer,
    double-reading a carry, kernel on a dead register, non-adjacent
    concatenation, D2H of rows the register does not hold) at compile
    time instead of at execution time.

    The scalar methods (:meth:`h2d`, :meth:`buffer_write`, ...) address
    ``[lo, hi)`` intervals along ``chunk_axis`` with full extent on every
    other axis — the 1-axis streaming idiom of the classic engines, valid
    for any ``chunk_axis`` of any N-D domain.  The ``*_box`` variants
    take explicit boxes (the multi-axis temporal-blocking planner)."""

    def __init__(self, engine: str, stencil, shape: Sequence[int], n: int,
                 d: int, k_off: int, k_on: int, itemsize: int,
                 chunk_axis: int = 0, tiles: Sequence[int] = ()):
        self.engine = engine
        self.st = stencil
        self.shape = tuple(shape)
        if not 0 <= chunk_axis < len(self.shape):
            raise ValueError(
                f"chunk_axis {chunk_axis} out of range for shape {self.shape}")
        self.axis = chunk_axis
        self.tiles = tuple(tiles)
        self.n, self.d, self.k_off, self.k_on = n, d, k_off, k_on
        self.itemsize = itemsize
        self.domain = Box.from_shape(self.shape)
        self.ops: List[Op] = []
        self._reg_box: Dict[str, Box] = {}    # live register -> global box
        self._buf_box: Dict[str, Box] = {}    # unread buffer -> global box
        self._staged_bytes = 0
        self._codec = None                    # set by with_compression()

    def with_compression(self, codec) -> "PlanBuilder":
        """Attach a transfer codec (name or :class:`~repro_torch.core.compress.Codec`).

        Chainable; :meth:`build` then rewrites the finished schedule with
        :func:`repro_torch.core.compress.compress_plan`, wrapping every
        ``H2D``/``D2H`` in a ``Compress``/``Decompress`` pair.  Planners
        stay codec-oblivious: the same engine code emits compressed and
        uncompressed schedules."""
        self._codec = codec
        return self

    def _bytes(self, box: Box) -> int:
        return box.volume * self.itemsize

    def _span(self, lo: int, hi: int) -> Box:
        return Box.span(self.shape, self.axis, lo, hi)

    def height(self, reg: str) -> int:
        """Current extent of a live register along the chunk axis
        (planners use it to address slices relative to the evolving
        band)."""
        return self._reg_box[reg].extent(self.axis)

    # -- box-native ops ------------------------------------------------

    def h2d_box(self, reg: str, box: Box, rnd: int, chunk: int) -> None:
        assert self.domain.contains(box), (box, self.shape)
        assert box.volume > 0, f"empty H2D box {box}"
        assert reg not in self._reg_box, f"register {reg!r} already live"
        self._reg_box[reg] = box
        self.ops.append(H2D(reg, box, self._bytes(box), rnd, chunk))

    def fused_kernel_box(self, reg: str, steps: int,
                         keep_lo: Sequence[bool], keep_hi: Sequence[bool],
                         rnd: int, chunk: int) -> None:
        box = self._reg_box[reg]
        shape_out, hbm, flops, elems = fused_box_geometry(
            self.st.radius, self.st.flops_per_elem, box.shape, steps,
            keep_lo, keep_hi, self.itemsize)
        assert all(s > 0 for s in shape_out), \
            f"register {reg!r} shrinks to {shape_out} after {steps} steps"
        shrink = steps * self.st.radius
        self._reg_box[reg] = box.shrink(
            [0 if kl else shrink for kl in keep_lo],
            [0 if kh else shrink for kh in keep_hi])
        self.ops.append(FusedKernel(
            reg, self.st.name, steps, tuple(bool(k) for k in keep_lo),
            tuple(bool(k) for k in keep_hi), box.shape, shape_out,
            hbm, flops, elems, rnd, chunk))

    def d2h_box(self, reg: str, host_box: Box, rnd: int, chunk: int) -> None:
        """Stage the register slices covering ``host_box`` (absolute
        coordinates) back to the host."""
        box = self._reg_box.pop(reg)      # last use: the register dies here
        assert box.contains(host_box), (box, host_box)
        reg_box = host_box.translate([-l for l in box.lo])
        nbytes = self._bytes(host_box)
        self._staged_bytes += nbytes
        self.ops.append(D2H(reg, reg_box, host_box, nbytes, rnd, chunk))

    # -- 1-axis convenience ops (the classic engine idiom) -------------

    def h2d(self, reg: str, lo: int, hi: int, rnd: int, chunk: int) -> None:
        L = self.shape[self.axis]
        assert 0 <= lo < hi <= L, (lo, hi)
        self.h2d_box(reg, self._span(lo, hi), rnd, chunk)

    def buffer_write(self, buf: str, reg: str, reg_lo: int, reg_hi: int,
                     rnd: int, chunk: int) -> None:
        box = self._reg_box[reg]
        h = box.extent(self.axis)
        assert 0 <= reg_lo < reg_hi <= h, (reg_lo, reg_hi, h)
        assert buf not in self._buf_box, f"buffer {buf!r} written twice"
        base = box.lo[self.axis]
        self._buf_box[buf] = box.with_axis(
            self.axis, base + reg_lo, base + reg_hi)
        rel = Box.span(box.shape, self.axis, reg_lo, reg_hi)
        self.ops.append(BufferWrite(buf, reg, rel, self._bytes(rel),
                                    rnd, chunk))

    def buffer_read(self, reg: str, buf: str, src: str, rnd: int,
                    chunk: int) -> None:
        bbox = self._buf_box.pop(buf)   # each shared region is consumed once
        sbox = self._reg_box.pop(src)
        assert bbox.hi[self.axis] == sbox.lo[self.axis], \
            f"buffer {buf!r} {bbox} not adjacent to register {src!r} {sbox}"
        self._reg_box[reg] = sbox.with_axis(
            self.axis, bbox.lo[self.axis], sbox.hi[self.axis])
        self.ops.append(BufferRead(reg, buf, src, self._bytes(bbox),
                                   self.axis, bbox.extent(self.axis),
                                   rnd, chunk))

    def fused_kernel(self, reg: str, steps: int, keep_top: bool,
                     keep_bottom: bool, rnd: int, chunk: int) -> None:
        nd = len(self.shape)
        keep_lo = [True] * nd
        keep_hi = [True] * nd
        keep_lo[self.axis] = bool(keep_top)
        keep_hi[self.axis] = bool(keep_bottom)
        self.fused_kernel_box(reg, steps, keep_lo, keep_hi, rnd, chunk)

    def d2h(self, reg: str, reg_lo: int, reg_hi: int, host_lo: int,
            host_hi: int, rnd: int, chunk: int) -> None:
        box = self._reg_box[reg]
        h = box.extent(self.axis)
        assert 0 <= reg_lo < reg_hi <= h, (reg_lo, reg_hi, h)
        assert reg_hi - reg_lo == host_hi - host_lo
        assert box.lo[self.axis] + reg_lo == host_lo, \
            f"register {reg!r} {box} does not hold host rows " \
            f"[{host_lo}, {host_hi}) at [{reg_lo}, {reg_hi})"
        self.d2h_box(reg, self._span(host_lo, host_hi), rnd, chunk)

    def commit(self, rnd: int) -> None:
        self.ops.append(HostCommit(self._staged_bytes, rnd))
        self._staged_bytes = 0

    def build(self) -> ExecutionPlan:
        assert not self._reg_box, f"leaked registers: {sorted(self._reg_box)}"
        assert not self._buf_box, f"unread buffers: {sorted(self._buf_box)}"
        assert self._staged_bytes == 0, "uncommitted D2H boxes at end of plan"
        r = self.st.radius
        exact = self.n * math.prod(s - 2 * r for s in self.shape)
        plan = ExecutionPlan(
            engine=self.engine, stencil=self.st.name, shape=self.shape,
            itemsize=self.itemsize, n=self.n, d=self.d, k_off=self.k_off,
            k_on=self.k_on, exact_elements=exact, ops=tuple(self.ops),
            chunk_axis=self.axis, tiles=self.tiles,
        )
        if self._codec is not None:
            from .compress import compress_plan   # local: avoids import cycle
            plan = compress_plan(plan, self._codec)
        return plan
