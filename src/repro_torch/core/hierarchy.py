"""Hierarchical plans: nested out-of-core streaming *inside* shards (the
port of :mod:`repro.core.hierarchy`; pure Python).

SO2DR's core trade — share overlap regions off-chip, tolerate redundant
compute to unlock reuse — applies recursively at every level of the
memory hierarchy.  :mod:`repro_torch.core.shard` compiles the L2 (inter-chip)
schedule but assumes each shard's halo-extended band pair fits in device
memory (:func:`~repro_torch.core.shard.shard_working_set` vs ``c_dev``).  This
module removes that assumption:

:func:`compile_hierarchical` compiles the outer :class:`ShardedPlan` as
usual, and when a shard's working set exceeds the device budget it
expands every :class:`~repro_torch.core.plan.ShardKernel` into a nested L1
:class:`~repro_torch.core.plan.ExecutionPlan` — any engine flavour:

* ``resreu``  — independent row chunks, full halo-extended ext per H2D
  (the result-reuse layout: redundant transfer, no carry);
* ``so2dr``   — row chunks sharing the ``2*k_ici*r`` overlap region
  through an on-device carry buffer (each band row crosses PCIe once);
* ``box_tb``  — a ``(ty, tx)`` tile grid over the owned region, each
  tile's ext extended by the halo depth on all four sides.

The inner plan streams the shard's band chunk-wise through the ordinary
H2D/D2H + FusedKernel vocabulary, so the existing lowering layer, slot
pool, codecs and executors all apply unchanged one level down.  Inner
kernels are *masked*: they run the same
:func:`repro_torch.core.distributed.masked_local_steps` update as the outer
``ShardKernel`` (global-coordinate interior mask, band frame preserved),
so chunked execution is bit-identical to the flat band pass — only rows
and columns at halo depth from each ext edge are written back.

The result is a :class:`HierarchicalPlan`: the outer plan keeps its ICI
accounting (halo bytes, ghost wedges, optional halo codec from
:func:`repro_torch.core.compress.compress_plan`) while the inner plans supply
the per-round H2D/D2H/buffer/kernel accounting, rolled up per shard x
round into one :class:`~repro_torch.core.plan.TransferStats` —
``DryRunExecutor`` costs both levels with zero devices, and the
simulator returns the identical numbers by construction.

When every shard fits the budget (and no explicit ``inner_d``/
``inner_tiles`` forces a split), :func:`compile_hierarchical` returns
the flat :class:`ShardedPlan` untouched — expansion is a strict no-op,
pinned by ``tests/data/golden_sharded_plans.json``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from .compress import compress_plan
from .plan import (
    Box, ExecutionPlan, FusedKernel, HaloCompress, HaloDecompress, HaloRecv,
    HaloSend, PlanBuilder, ShardedPlan, TransferStats,
)
from .shard import _overlap, compile_sharded, shard_working_set
from .stencil import get_stencil

__all__ = ["HierarchicalPlan", "compile_hierarchical"]

INNER_ENGINES = ("so2dr", "resreu", "box_tb")


@dataclasses.dataclass(frozen=True)
class HierarchicalPlan:
    """A two-level schedule: an outer :class:`ShardedPlan` whose compute
    phases are realized by nested per-rank inner plans.

    ``inner[rank]`` is ONE round of rank ``rank``'s band update — the
    executors run it once per outer round (``outer.rounds`` times), with
    the rank's halo-extended band standing in as the inner plan's host
    domain.  Inner plans are per-rank because the masked element counts
    differ at the global domain edges even though the geometry is
    uniform.

    Accounting: ICI fields come from the outer streams (halo sends,
    recvs and any halo-codec ops); H2D/D2H/buffer/kernel fields come
    from the inner plans times ``outer.rounds``.  The outer
    ``ShardLoad``/``ShardStore`` ops are *excluded* — in the
    hierarchical regime the shard band is host-resident and the inner
    chunk H2D/D2H ops are the real interconnect traffic."""

    outer: ShardedPlan
    inner: Tuple[ExecutionPlan, ...]
    inner_engine: str
    c_dev: int = 0

    # -- geometry delegation (the outer plan carries it all) -----------

    @property
    def stencil(self) -> str:
        return self.outer.stencil

    @property
    def Y(self) -> int:
        return self.outer.Y

    @property
    def X(self) -> int:
        return self.outer.X

    @property
    def shape(self) -> Tuple[int, int]:
        return self.outer.shape

    @property
    def itemsize(self) -> int:
        return self.outer.itemsize

    @property
    def n(self) -> int:
        return self.outer.n

    @property
    def k_ici(self) -> int:
        return self.outer.k_ici

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return self.outer.mesh_shape

    @property
    def radius(self) -> int:
        return self.outer.radius

    @property
    def shards(self):
        return self.outer.shards

    @property
    def barriers(self):
        return self.outer.barriers

    @property
    def n_ranks(self) -> int:
        return self.outer.n_ranks

    @property
    def rounds(self) -> int:
        return self.outer.rounds

    @property
    def exact_elements(self) -> int:
        return self.outer.exact_elements

    @property
    def codec(self) -> str:
        """The outer halo codec ("" = uncompressed halos)."""
        return self.outer.codec

    @property
    def trailing(self) -> Tuple[int, ...]:
        return self.outer.trailing

    @property
    def inner_chunks(self) -> int:
        """Chunks per inner round (``d`` of the nested plans)."""
        return self.inner[0].d if self.inner else 0

    def __len__(self) -> int:
        return len(self.outer) + self.rounds * sum(
            len(p) for p in self.inner)

    # -- accounting ----------------------------------------------------

    def _accumulate_outer(self, s: TransferStats, stream) -> None:
        """The outer stream's ICI share: halo sends/recvs plus halo-codec
        wire adjustments.  ShardLoad/ShardStore and ShardKernel are
        skipped — the inner plans account for the band traffic and the
        (chunked, masked) compute."""
        for op in stream:
            if isinstance(op, HaloSend):
                s.ici_bytes += op.nbytes
                s.ici_wire_bytes += op.nbytes
                s.halo_ops += 1
            elif isinstance(op, HaloRecv):
                if op.src >= 0:
                    s.halo_ops += 1
            elif isinstance(op, HaloCompress):
                s.codec_ops += 1
                s.ici_wire_bytes += op.wire_nbytes - op.raw_nbytes
            elif isinstance(op, HaloDecompress):
                s.codec_ops += 1

    def _accumulate_inner(self, s: TransferStats, rank: int) -> None:
        ist = self.inner[rank].stats()
        R = self.rounds
        s.h2d_bytes += R * ist.h2d_bytes
        s.h2d_wire_bytes += R * ist.h2d_wire_bytes
        s.d2h_bytes += R * ist.d2h_bytes
        s.d2h_wire_bytes += R * ist.d2h_wire_bytes
        s.codec_ops += R * ist.codec_ops
        s.buffer_bytes += R * ist.buffer_bytes
        s.kernel_calls += R * ist.kernel_calls
        s.kernel_hbm_bytes += R * ist.kernel_hbm_bytes
        s.flops += R * ist.flops
        s.elements_computed += R * ist.elements_computed

    def stats(self) -> TransferStats:
        """Both levels rolled into one :class:`TransferStats` — the
        single source of truth, derived from the plans with zero device
        work (``DryRunExecutor`` returns it untouched, the simulator
        returns it alongside the computed domain)."""
        s = TransferStats(exact_elements=self.exact_elements)
        for rank in range(self.n_ranks):
            self._accumulate_outer(s, self.outer.streams[rank])
            self._accumulate_inner(s, rank)
        return s

    def per_rank_stats(self, rank: int) -> TransferStats:
        """One shard's roll-up: its outer ICI share plus its inner plan
        times ``rounds``; ``exact_elements`` is the rank's owned-interior
        share."""
        sh = self.shards[rank]
        r = self.radius
        rows = max(0, min(sh.y1, self.Y - r) - max(sh.y0, r))
        cols = max(0, min(sh.x1, self.X - r) - max(sh.x0, r))
        s = TransferStats(exact_elements=self.n * rows * cols)
        self._accumulate_outer(s, self.outer.streams[rank])
        self._accumulate_inner(s, rank)
        return s

    def inner_stats(self, rank: int) -> TransferStats:
        """One round of one rank's nested plan, un-multiplied — the L1
        accounting a per-chunk property test reads."""
        return self.inner[rank].stats()

    def ici_bytes_per_round(self, rank: int) -> int:
        return self.outer.ici_bytes_per_round(rank)

    def ici_wire_bytes_per_round(self, rank: int) -> int:
        return self.outer.ici_wire_bytes_per_round(rank)

    @property
    def collective_bytes_per_round(self) -> int:
        return self.outer.collective_bytes_per_round

    @property
    def collective_wire_bytes_per_round(self) -> int:
        return self.outer.collective_wire_bytes_per_round

    def breakdown(self) -> Dict[str, int]:
        return self.stats().breakdown()

    def op_counts(self) -> Dict[str, int]:
        """Outer op counts plus inner op counts times ``rounds`` (the
        ops an executor actually issues)."""
        out = self.outer.op_counts()
        for p in self.inner:
            for k, v in p.op_counts().items():
                out[k] = out.get(k, 0) + self.rounds * v
        return out


def _chunk_bounds(extent: int, parts: int, base: int) -> Tuple[Tuple[int, int], ...]:
    """Partition ``[base, base + extent)`` into ``parts`` near-equal
    spans (earlier spans take the remainder, every span non-empty)."""
    size, rem = divmod(extent, parts)
    bounds = []
    a = base
    for i in range(parts):
        b = a + size + (1 if i < rem else 0)
        bounds.append((a, b))
        a = b
    return tuple(bounds)


def _masked_kernel(b: PlanBuilder, reg: str, chunk: int, st, steps: int,
                   gy0: int, gx0: int, Y: int, X: int,
                   t_interior: int) -> None:
    """Append a *masked* FusedKernel on ``reg``'s current ext box.

    Masked semantics (the ShardKernel update, one level down): every
    step writes the ext centre wherever the global-coordinate interior
    mask holds, and the band frame is preserved — so the ext box does
    not shrink (all keeps set) and the element count is the global
    interior overlap of the inset ext, per step.  The builder's
    geometry helper cannot express that, hence the manual append; the
    ext box is untouched because every side is kept."""
    r = st.radius
    ext = b._reg_box[reg]
    rows = _overlap(gy0 + ext.lo[0] + r, gy0 + ext.hi[0] - r, r, Y - r)
    cols = _overlap(gx0 + ext.lo[1] + r, gx0 + ext.hi[1] - r, r, X - r)
    elements = steps * rows * cols * t_interior
    b.ops.append(FusedKernel(
        reg, st.name, steps, (True, True), (True, True),
        ext.shape, ext.shape, 2 * ext.volume * b.itemsize,
        elements * st.flops_per_elem, elements, 0, chunk))


def _build_row_inner(engine: str, st, h: int, w: int, ly: int, hk: int,
                     d: int, k: int, gy0: int, gx0: int, Y: int, X: int,
                     itemsize_eff: int, t_interior: int,
                     inner_codec) -> ExecutionPlan:
    """One round of one rank's band update as a row-chunked inner plan.

    ``resreu`` loads each chunk's full halo-extended ext (aprons cross
    the wire twice per interior boundary); ``so2dr`` carries the
    ``2*hk`` overlap rows on-device in a shared buffer, so each band row
    is loaded exactly once per round."""
    b = PlanBuilder(f"hier-{engine}", st, (h, w), n=k, d=d,
                    k_off=k, k_on=k, itemsize=itemsize_eff)
    if inner_codec is not None:
        b.with_compression(inner_codec)
    chunks = _chunk_bounds(ly, d, hk)   # owned rows, band coordinates
    prev_b = 0
    for i, (a, bb) in enumerate(chunks):
        if engine == "resreu" or i == 0:
            reg = f"band:r0c{i}"
            b.h2d(reg, a - hk, bb + hk, 0, i)
        else:
            # so2dr: only the fresh rows cross the wire; the 2*hk apron
            # arrives through the carry buffer written by chunk i-1
            src = f"src:r0c{i}"
            b.h2d(src, prev_b + hk, bb + hk, 0, i)
            reg = f"band:r0c{i}"
            b.buffer_read(reg, f"carry:c{i - 1}", src, 0, i)
        if engine == "so2dr" and i < d - 1:
            # bottom 2*hk INPUT rows, captured before the kernel runs
            ext_h = b.height(reg)
            b.buffer_write(f"carry:c{i}", reg, ext_h - 2 * hk, ext_h, 0, i)
        _masked_kernel(b, reg, i, st, k, gy0, gx0, Y, X, t_interior)
        b.d2h_box(reg, Box((a, hk), (bb, w - hk)), 0, i)
        prev_b = bb
    b.commit(0)
    # n*(shape-2r) is meaningless for one masked round of a band slice;
    # exact/redundant accounting lives on the HierarchicalPlan
    return dataclasses.replace(b.build(), exact_elements=0)


def _build_box_inner(st, h: int, w: int, ly: int, lx: int, hk: int,
                     tiles: Tuple[int, int], k: int, gy0: int, gx0: int,
                     Y: int, X: int, itemsize_eff: int, t_interior: int,
                     inner_codec) -> ExecutionPlan:
    """One round of one rank's band update as a ``(ty, tx)`` tile grid:
    each tile's ext extends ``hk`` on all four sides (never clipped —
    the band frame is exactly the halo depth)."""
    ty, tx = tiles
    b = PlanBuilder("hier-box_tb", st, (h, w), n=k, d=ty * tx,
                    k_off=k, k_on=k, itemsize=itemsize_eff, tiles=tiles)
    if inner_codec is not None:
        b.with_compression(inner_codec)
    ci = 0
    for a, bb in _chunk_bounds(ly, ty, hk):
        for cc, ee in _chunk_bounds(lx, tx, hk):
            reg = f"tile:r0c{ci}"
            b.h2d_box(reg, Box((a - hk, cc - hk), (bb + hk, ee + hk)), 0, ci)
            _masked_kernel(b, reg, ci, st, k, gy0, gx0, Y, X, t_interior)
            b.d2h_box(reg, Box((a, cc), (bb, ee)), 0, ci)
            ci += 1
    b.commit(0)
    return dataclasses.replace(b.build(), exact_elements=0)


def _derive_row_chunks(ly: int, w: int, hk: int, itemsize_eff: int,
                       c_dev: int) -> int:
    """Smallest chunk count whose in/out ext pair fits ``c_dev``."""
    cap = c_dev // (2 * w * itemsize_eff) - 2 * hk
    if cap < 1:
        raise ValueError(
            f"c_dev={c_dev} cannot hold even a one-row chunk "
            f"(2*({1 + 2 * hk})*{w}*{itemsize_eff} bytes); no row-chunked "
            "inner schedule exists — shrink the halo depth k_ici or the "
            "shard width")
    return min(ly, -(-ly // cap))


def _derive_tiles(ly: int, lx: int, hk: int, itemsize_eff: int,
                  c_dev: int) -> Tuple[int, int]:
    """Smallest square-ish tile grid whose largest ext pair fits
    ``c_dev``."""
    for t in range(1, max(ly, lx) + 1):
        ty, tx = min(t, ly), min(t, lx)
        tile_y, tile_x = -(-ly // ty), -(-lx // tx)
        if 2 * (tile_y + 2 * hk) * (tile_x + 2 * hk) * itemsize_eff <= c_dev:
            return ty, tx
    raise ValueError(
        f"c_dev={c_dev} cannot hold even a one-point tile "
        f"(2*({1 + 2 * hk})^2*{itemsize_eff} bytes); no tiled inner "
        "schedule exists — shrink the halo depth k_ici")


def compile_hierarchical(stencil, Y: int, X: int, n: int, k_ici: int,
                         mesh_shape: Tuple[int, int],
                         itemsize: int = 4,
                         c_dev: Optional[int] = None,
                         hw=None,
                         inner_engine: str = "so2dr",
                         inner_d: Optional[int] = None,
                         inner_tiles: Optional[Tuple[int, int]] = None,
                         codec=None,
                         inner_codec=None,
                         trailing: Tuple[int, ...] = ()):
    """Compile the two-level schedule for ``(shape, stencil, budget)``.

    The outer :class:`ShardedPlan` is compiled exactly as
    :func:`repro_torch.core.shard.compile_sharded` would (same streams, same
    barriers, same accounting).  Then:

    * if every shard's working-set pair fits ``c_dev`` (taken from
      ``hw.c_dev`` when only ``hw`` is given; ``None`` = unbounded) and
      no explicit ``inner_d``/``inner_tiles`` forces a split, the flat
      plan is returned **unchanged** — expansion is a strict no-op;
    * otherwise each rank's ``ShardKernel`` expands into a nested
      ``inner_engine`` plan (``so2dr`` | ``resreu`` | ``box_tb``) that
      streams the shard's band chunk-wise, and a
      :class:`HierarchicalPlan` is returned.

    ``codec`` routes the outer halo exchange through the codec registry
    (:func:`repro_torch.core.compress.compress_plan` on the ShardedPlan);
    ``inner_codec`` compresses the nested H2D/D2H streams.  ``trailing``
    models unsharded trailing axes (dry-run only): the trailing volume
    folds into the inner plans' itemsize so byte accounting scales,
    while element counts scale by the trailing interior."""
    if inner_engine not in INNER_ENGINES:
        raise ValueError(
            f"unknown inner engine {inner_engine!r}; known: {INNER_ENGINES}")
    st = get_stencil(stencil) if isinstance(stencil, str) else stencil
    r = st.radius
    if c_dev is None and hw is not None:
        c_dev = hw.c_dev
    outer = compile_sharded(st, Y, X, n, k_ici, mesh_shape,
                            itemsize=itemsize, trailing=trailing)
    n_row, n_col = outer.mesh_shape
    ly, lx = Y // n_row, X // n_col
    hk = k_ici * r
    h, w = ly + 2 * hk, lx + 2 * hk

    ws = shard_working_set(ly, lx, hk, itemsize, trailing)
    explicit = inner_d is not None or inner_tiles is not None
    if (c_dev is None or ws <= c_dev) and not explicit:
        # fits: the expansion pass is a strict no-op (golden-pinned)
        return compress_plan(outer, codec) if codec is not None else outer

    if codec is not None:
        outer = compress_plan(outer, codec)
    if inner_codec is not None and trailing:
        raise ValueError(
            "inner_codec cannot combine with trailing axes: the trailing "
            "volume folds into the inner plans' itemsize, which the codec "
            "registry's itemsize constraints reject")

    t_mult = math.prod(trailing) if trailing else 1
    t_interior = math.prod(t - 2 * r for t in trailing) if trailing else 1
    itemsize_eff = itemsize * t_mult

    if inner_engine == "box_tb":
        if inner_tiles is not None:
            ty, tx = inner_tiles
            if not (1 <= ty <= ly and 1 <= tx <= lx):
                raise ValueError(
                    f"inner_tiles {inner_tiles} out of range for a "
                    f"({ly}, {lx}) shard")
            tiles = (ty, tx)
        else:
            tiles = _derive_tiles(ly, lx, hk, itemsize_eff, c_dev)
        build = lambda gy0, gx0: _build_box_inner(     # noqa: E731
            st, h, w, ly, lx, hk, tiles, k_ici, gy0, gx0, Y, X,
            itemsize_eff, t_interior, inner_codec)
    else:
        if inner_tiles is not None:
            raise ValueError(
                f"inner_tiles only applies to box_tb, not {inner_engine!r}")
        if inner_d is not None:
            if not 1 <= inner_d <= ly:
                raise ValueError(
                    f"inner_d={inner_d} out of range for {ly} owned rows")
            d = inner_d
        else:
            d = _derive_row_chunks(ly, w, hk, itemsize_eff, c_dev)
        build = lambda gy0, gx0: _build_row_inner(     # noqa: E731
            inner_engine, st, h, w, ly, hk, d, k_ici, gy0, gx0, Y, X,
            itemsize_eff, t_interior, inner_codec)

    inner = tuple(build(sh.y0 - hk, sh.x0 - hk) for sh in outer.shards)
    return HierarchicalPlan(outer=outer, inner=inner,
                            inner_engine=inner_engine, c_dev=c_dev or 0)
