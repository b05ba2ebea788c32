"""Out-of-core stencil engines (the paper's Sec. II/IV, Alg. 1) as planners
(port of :mod:`repro.core.oocore`).

Five engines, all verified equivalent to the oracle
(:func:`repro_torch.core.reference.run_reference`):

* :class:`InCore`   — whole domain resident on device, ``k_on``-step fused
  kernels (the paper's in-core comparison code, Sec. V-D).
* :class:`NaiveTB`  — temporal blocking with *redundant transfer*: every
  round each chunk re-transfers its ``k_off*r`` halos (paper Fig. 1b).
* :class:`ResReu`   — region sharing with intermediate-result reuse (Jin et
  al. [15]): zero redundant transfer, zero redundant compute, but kernels
  are forced to single time steps interleaved with buffer reads/writes
  (paper Fig. 2b).  Implemented as parallelogram band streaming: chunk ``i``'s
  working band at step ``s`` covers rows ``[a_i+(k-s)r, b_i+(k-s)r)``; a
  per-step carry conveys rows ``[b_i-r, b_i+(k-s)r)`` to chunk ``i+1``.
* :class:`SO2DR`    — the paper's contribution: region sharing happens once
  per chunk-round at step 0 (rows ``[b_i-kr, b_i)``), redundant computation
  is deliberately admitted in the overlap wedges, and kernels run
  ``k_on`` fused steps uninterrupted (Alg. 1 lines 7-14).
* :class:`BoxTB`    — multi-axis temporal blocking on the box IR
  ("Beyond 16GB", arXiv 1709.02125): the domain splits into an N-D grid
  of tiles (``tiles[a]`` per axis), and each tile's H2D box grows a
  trapezoidal apron of ``t*r`` cells on every non-frame side so the tile
  advances ``t = k_off`` time steps per round trip — the off-chip analog
  of ``k_on``, generalizing :class:`NaiveTB` to 3-D workloads.

The classic streaming engines chunk along any single axis
(``chunk_axis``) of an N-D domain; their row arithmetic is unchanged —
it simply addresses ``shape[chunk_axis]`` instead of ``Y``.

Plan/execute split: each engine is a *planner* — :meth:`_EngineBase.compile`
turns ``(domain shape, stencil, n)`` into an
:class:`repro_torch.core.plan.ExecutionPlan` (a typed transfer/kernel op
schedule), and any executor from :mod:`repro_torch.core.executor` interprets it:
eagerly, software-pipelined (double-buffered), or as a zero-device dry run.
All :class:`TransferStats` accounting is derived from the plan itself.
``run()`` is the compile-then-eager-execute convenience that preserves the
historical engine API.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import numpy as np

from .plan import Box, ExecutionPlan, PlanBuilder, TransferStats
from .stencil import Stencil
from .tiling import ChunkPlan, make_chunk_plan, split_steps

__all__ = [
    "TransferStats", "InCore", "NaiveTB", "ResReu", "SO2DR", "BoxTB",
    "get_engine", "compile_plan", "compile_plan_nd", "compile_box_plan",
]


class _EngineBase:
    name: str = "base"

    def __init__(self, d: int, k_off: int, k_on: int,
                 fused_step=None, codec=None, policy=None,
                 chunk_axis: int = 0):
        self.d = d
        self.k_off = k_off
        self.k_on = k_on
        self.fused_step = fused_step
        # transfer codec (name or repro_torch.core.compress.Codec); None keeps
        # the schedule uncompressed.  Applied by the builder at build()
        # time, so planner subclasses stay codec-oblivious.
        self.codec = codec
        # kernel-dispatch policy (repro_torch.kernels.dispatch.DispatchPolicy);
        # None = auto.  Only consulted when fused_step is not given.
        self.policy = policy
        # streaming axis: the classic engines decompose the domain into
        # d chunks along this axis (full extent on all others)
        self.chunk_axis = chunk_axis

    def _chunks(self, shape: Sequence[int], st: Stencil) -> ChunkPlan:
        L = shape[self.chunk_axis]
        cross = math.prod(shape) // max(L, 1)
        plan = make_chunk_plan(L, cross, st.radius, self.d)
        if self.k_off > plan.max_k_off():
            raise ValueError(
                f"k_off={self.k_off} violates region-sharing feasibility "
                f"(k_off*r must fit in the smallest chunk; max {plan.max_k_off()})"
            )
        return plan

    def _builder(self, shape: Sequence[int], st: Stencil, n: int,
                 itemsize: int) -> PlanBuilder:
        b = PlanBuilder(self.name, st, shape, n, self.d, self.k_off,
                        self.k_on, itemsize, chunk_axis=self.chunk_axis)
        if self.codec is not None:
            b.with_compression(self.codec)
        return b

    def compile_nd(self, shape: Sequence[int], st: Stencil, n: int,
                   itemsize: int = 4) -> ExecutionPlan:
        """Compile the engine's schedule for an N-D framed domain —
        geometry only, no arrays touched."""
        raise NotImplementedError

    def compile(self, Y: int, X: int, st: Stencil, n: int,
                itemsize: int = 4) -> ExecutionPlan:
        """2-D convenience wrapper around :meth:`compile_nd`."""
        return self.compile_nd((Y, X), st, n, itemsize=itemsize)

    def run(self, x: np.ndarray, st: Stencil, n: int,
            device=None) -> Tuple[np.ndarray, TransferStats]:
        """Compile + eager execution (the historical engine API).

        ``device`` is where the bands live; None means ``cuda``."""
        # imported here so the planner loads without a device runtime
        from .executor import EagerExecutor

        plan = self.compile_nd(x.shape, st, n, itemsize=x.dtype.itemsize)
        return EagerExecutor(self.fused_step, policy=self.policy,
                             device=device).execute(plan, x)


class InCore(_EngineBase):
    """Whole domain on device; the paper's in-core code with k_on-step kernels."""

    name = "incore"

    def compile_nd(self, shape, st, n, itemsize=4):
        L = shape[self.chunk_axis]
        b = self._builder(shape, st, n, itemsize)
        b.h2d("band", 0, L, rnd=0, chunk=0)
        for m in split_steps(n, self.k_on):
            b.fused_kernel("band", m, keep_top=True, keep_bottom=True,
                           rnd=0, chunk=0)
        b.d2h("band", 0, L, 0, L, rnd=0, chunk=0)
        b.commit(rnd=0)
        return b.build()


class NaiveTB(_EngineBase):
    """Temporal blocking with redundant halo transfer (paper Fig. 1b).

    The per-round :class:`HostCommit` barrier realises the ping-pong host
    buffer: within a round every chunk's H2D reads pre-round halo rows."""

    name = "naive_tb"

    def compile_nd(self, shape, st, n, itemsize=4):
        r = st.radius
        L = shape[self.chunk_axis]
        chunks = self._chunks(shape, st)
        b = self._builder(shape, st, n, itemsize)
        for rnd, k in enumerate(split_steps(n, self.k_off)):
            for i, cb in enumerate(chunks.chunks):
                first, last = i == 0, i == chunks.d - 1
                reg = f"band:r{rnd}c{i}"
                lo = 0 if first else cb.a - k * r
                hi = L if last else cb.b + k * r
                b.h2d(reg, lo, hi, rnd, i)
                for m in split_steps(k, self.k_on):
                    b.fused_kernel(reg, m, first, last, rnd, i)
                out_lo = 0 if first else cb.a
                b.d2h(reg, cb.a - out_lo, cb.b - out_lo, cb.a, cb.b, rnd, i)
            b.commit(rnd)
        return b.build()


class ResReu(_EngineBase):
    """Region sharing with intermediate-result reuse (Jin et al. [15]).

    Zero redundant transfer and zero redundant compute, at the price of
    single-step kernels interleaved with per-step buffer reads/writes —
    exactly the constraint the paper's Fig. 2b describes (k_on is ignored).

    Sliding-parallelogram formulation: chunk ``i``'s working band at step
    ``s`` covers rows ``[a_i+(k-s)r, b_i+(k-s)r)`` (constant height).  Before
    each step the chunk writes two shared regions (2r rows at step ``s``)
    into per-step carry buffers for its successor and reads the
    predecessor's pair — matching the paper's Fig. 2b description verbatim.
    """

    name = "resreu"

    def compile_nd(self, shape, st, n, itemsize=4):
        r = st.radius
        L = shape[self.chunk_axis]
        chunks = self._chunks(shape, st)
        if min(c.rows for c in chunks.chunks) < 2 * r and chunks.d > 1:
            raise ValueError("ResReu region sharing needs chunks of >= 2r rows")
        b = self._builder(shape, st, n, itemsize)
        for rnd, k in enumerate(split_steps(n, self.k_off)):
            for i, cb in enumerate(chunks.chunks):
                first, last = i == 0, i == chunks.d - 1
                reg = f"band:r{rnd}c{i}"
                lo = 0 if first else cb.a + k * r
                hi = L if last else cb.b + k * r
                b.h2d(reg, lo, hi, rnd, i)
                for s in range(k):
                    if not last:
                        # write the shared-region pair for chunk i+1
                        h = b.height(reg)
                        b.buffer_write(f"carry:r{rnd}c{i}s{s}", reg,
                                       h - 2 * r, h, rnd, i)
                    if not first:
                        # read the predecessor's pair
                        b.buffer_read(reg, f"carry:r{rnd}c{i - 1}s{s}", reg,
                                      rnd, i)
                    b.fused_kernel(reg, 1, first, last, rnd, i)
                # band covers [0, b0) / [a_i, b_i) / [a_i, L)
                off = cb.a if first else 0
                b.d2h(reg, off, off + cb.rows, cb.a, cb.b, rnd, i)
            b.commit(rnd)
        return b.build()


class SO2DR(_EngineBase):
    """The paper's method (Alg. 1): off-chip region sharing at step 0 +
    deliberate redundant computation + uninterrupted k_on-step fused kernels.
    """

    name = "so2dr"

    def compile_nd(self, shape, st, n, itemsize=4):
        r = st.radius
        L = shape[self.chunk_axis]
        chunks = self._chunks(shape, st)
        b = self._builder(shape, st, n, itemsize)
        for rnd, k in enumerate(split_steps(n, self.k_off)):
            for i, cb in enumerate(chunks.chunks):
                first, last = i == 0, i == chunks.d - 1
                reg = f"band:r{rnd}c{i}"
                # transfer: everything the sharing buffer doesn't provide
                lo = 0 if first else cb.a + k * r
                hi = L if last else cb.b + k * r
                b.h2d(reg, lo, hi, rnd, i)
                if first:
                    full_start = 0
                else:
                    b.buffer_read(reg, f"share:r{rnd}c{i - 1}", reg, rnd, i)
                    full_start = cb.a - k * r
                if not last:
                    # line 6 of Alg. 1: rows [b_i - kr, b_i + kr) for chunk i+1
                    sl = (cb.b - k * r) - full_start
                    b.buffer_write(f"share:r{rnd}c{i}", reg, sl,
                                   sl + 2 * k * r, rnd, i)
                # lines 7-14: uninterrupted fused kernels, shrinking area
                for m in split_steps(k, self.k_on):
                    b.fused_kernel(reg, m, first, last, rnd, i)
                # band covers [0, b0) / [a_i, b_i) / [a_i, L)
                off = cb.a if first else 0
                b.d2h(reg, off, off + cb.rows, cb.a, cb.b, rnd, i)
            b.commit(rnd)
        return b.build()


class BoxTB(_EngineBase):
    """Multi-axis temporal blocking on the box IR (arXiv 1709.02125).

    The domain splits into an N-D tile grid: ``tiles[a]`` near-even tiles
    of the interior along axis ``a`` (axes beyond ``len(tiles)`` stay
    whole).  Each round advances ``t = k_off`` time steps: a tile's H2D
    box is its owned interior grown by a ``t*r``-cell apron on every side
    that is not a domain frame — the trapezoid whose redundant apron
    compute is the price of ``t`` steps per host round trip.  On-chip,
    the ``t`` steps run as ``k_on``-step fused kernels (the paper's
    synergy, now per tile); D2H writes back only the owned interior box.

    A 1-tile-per-axis grid degenerates to :class:`InCore`-style whole-
    domain rounds; ``tiles=(d,)`` on a 2-D domain is :class:`NaiveTB`
    chunking with box d2h.  ``plan.d`` is the total tile count and
    ``plan.k_off`` the time depth ``t``."""

    name = "box_tb"

    def __init__(self, d: int = 0, k_off: int = 1, k_on: int = 1,
                 fused_step=None, codec=None, policy=None,
                 chunk_axis: int = 0, tiles: Sequence[int] = ()):
        tiles = tuple(int(t) for t in tiles) or ((d,) if d else (1,))
        if any(t < 1 for t in tiles):
            raise ValueError(f"tile counts must be >= 1, got {tiles}")
        super().__init__(math.prod(tiles), k_off, k_on, fused_step,
                         codec, policy, chunk_axis)
        self.tiles = tiles

    def _builder(self, shape, st, n, itemsize):
        b = super()._builder(shape, st, n, itemsize)
        b.tiles = self.tiles
        return b

    def compile_nd(self, shape, st, n, itemsize=4):
        r = st.radius
        nd = len(shape)
        tiles = self.tiles + (1,) * (nd - len(self.tiles))
        if len(tiles) != nd:
            raise ValueError(
                f"tiles {self.tiles} over-ranks domain shape {tuple(shape)}")
        # per-axis interior splits (same near-even arithmetic as the
        # 1-axis chunk plan), plus the NaiveTB feasibility rule per axis:
        # the t*r apron must fit inside the smallest neighbouring tile
        splits = []
        for a in range(nd):
            cp = make_chunk_plan(shape[a], math.prod(shape) // shape[a],
                                 r, tiles[a])
            if tiles[a] > 1 and self.k_off > cp.max_k_off():
                raise ValueError(
                    f"time depth t={self.k_off} infeasible along axis {a}: "
                    f"t*r must fit in the smallest tile (max {cp.max_k_off()})")
            splits.append(cp.chunks)
        b = self._builder(shape, st, n, itemsize)
        for rnd, k in enumerate(split_steps(n, self.k_off)):
            for idx, multi in enumerate(itertools.product(
                    *(range(t) for t in tiles))):
                own = [splits[a][multi[a]] for a in range(nd)]
                keep_lo = tuple(multi[a] == 0 for a in range(nd))
                keep_hi = tuple(multi[a] == tiles[a] - 1 for a in range(nd))
                in_box = Box(
                    tuple(0 if keep_lo[a] else own[a].a - k * r
                          for a in range(nd)),
                    tuple(shape[a] if keep_hi[a] else own[a].b + k * r
                          for a in range(nd)))
                reg = f"band:r{rnd}t{idx}"
                b.h2d_box(reg, in_box, rnd, idx)
                for m in split_steps(k, self.k_on):
                    b.fused_kernel_box(reg, m, keep_lo, keep_hi, rnd, idx)
                b.d2h_box(reg, Box(tuple(c.a for c in own),
                                   tuple(c.b for c in own)), rnd, idx)
            b.commit(rnd)
        return b.build()


ENGINES = {e.name: e for e in (InCore, NaiveTB, ResReu, SO2DR, BoxTB)}


def get_engine(name: str, d: int, k_off: int, k_on: int, fused_step=None,
               codec=None, policy=None, chunk_axis: int = 0,
               tiles: Sequence[int] = ()) -> _EngineBase:
    try:
        cls = ENGINES[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; known: {sorted(ENGINES)}")
    kwargs = dict(d=d, k_off=k_off, k_on=k_on, fused_step=fused_step,
                  codec=codec, policy=policy, chunk_axis=chunk_axis)
    if cls is BoxTB:
        kwargs["tiles"] = tiles
    elif tiles:
        raise ValueError(f"engine {name!r} does not take a tile grid; "
                         f"tiles= is box_tb-only")
    return cls(**kwargs)


def compile_plan_nd(engine: str, st: Stencil, shape: Sequence[int], n: int,
                    d: int, k_off: int, k_on: int, itemsize: int = 4,
                    codec=None, chunk_axis: int = 0,
                    tiles: Sequence[int] = ()) -> ExecutionPlan:
    """Compile one engine configuration for an N-D framed domain — the
    geometry-only entry point used by accounting and the autotuner.
    ``codec`` (a name from :data:`repro_torch.core.compress.CODECS` or a codec
    instance) wraps every transfer in Compress/Decompress ops."""
    return get_engine(engine, d=d, k_off=k_off, k_on=k_on, codec=codec,
                      chunk_axis=chunk_axis, tiles=tiles).compile_nd(
        shape, st, n, itemsize=itemsize)


def compile_plan(engine: str, st: Stencil, Y: int, X: int, n: int,
                 d: int, k_off: int, k_on: int, itemsize: int = 4,
                 codec=None, chunk_axis: int = 0) -> ExecutionPlan:
    """2-D convenience wrapper around :func:`compile_plan_nd`."""
    return compile_plan_nd(engine, st, (Y, X), n, d, k_off, k_on,
                           itemsize=itemsize, codec=codec,
                           chunk_axis=chunk_axis)


def compile_box_plan(st: Stencil, shape: Sequence[int], n: int,
                     tiles: Sequence[int], time_depth: int, k_on: int = 1,
                     itemsize: int = 4, codec=None) -> ExecutionPlan:
    """Compile a :class:`BoxTB` temporal-blocking plan: ``tiles[a]`` tiles
    per axis, ``time_depth`` steps per H2D round trip, ``k_on``-step fused
    kernels on chip."""
    return get_engine("box_tb", d=0, k_off=time_depth, k_on=k_on,
                      codec=codec, tiles=tiles).compile_nd(
        shape, st, n, itemsize=itemsize)
