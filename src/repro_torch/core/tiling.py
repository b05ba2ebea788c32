"""Chunk / halo / parallelogram algebra for out-of-core streaming
(port of :mod:`repro.core.tiling`, logic verbatim).

Row-wise decomposition of a framed (Y, X) domain.  Interior rows are
``[r, Y-r)``; chunks partition them.  All coordinates are absolute array
rows.  The algebra here is shared by every engine in
:mod:`repro_torch.core.oocore`.
"""
from __future__ import annotations

import dataclasses
from typing import List


__all__ = ["ChunkPlan", "make_chunk_plan", "split_steps"]


@dataclasses.dataclass(frozen=True)
class ChunkBounds:
    a: int  # first owned row (absolute, inclusive)
    b: int  # one-past-last owned row

    @property
    def rows(self) -> int:
        return self.b - self.a


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Row decomposition of a framed domain into ``d`` chunks."""

    Y: int
    X: int
    radius: int
    chunks: tuple  # tuple[ChunkBounds, ...]

    @property
    def d(self) -> int:
        return len(self.chunks)

    @property
    def interior_rows(self) -> int:
        return self.Y - 2 * self.radius

    def max_k_off(self) -> int:
        """Largest temporal-blocking depth supported by region sharing.

        The paper's constraint (Sec. IV-C): the halo working space
        ``W_halo * S_TB`` may not exceed a chunk, i.e. ``k*r <= min chunk
        rows`` — otherwise the sharing buffer would need rows the previous
        chunk never held.
        """
        return min(c.rows for c in self.chunks) // self.radius


def make_chunk_plan(Y: int, X: int, radius: int, d: int) -> ChunkPlan:
    interior = Y - 2 * radius
    if interior < d:
        raise ValueError(f"cannot split {interior} interior rows into {d} chunks")
    sizes = [interior // d + (1 if i < interior % d else 0) for i in range(d)]
    bounds: List[ChunkBounds] = []
    a = radius
    for s in sizes:
        bounds.append(ChunkBounds(a, a + s))
        a += s
    assert a == Y - radius
    return ChunkPlan(Y=Y, X=X, radius=radius, chunks=tuple(bounds))


def split_steps(total: int, block: int) -> List[int]:
    """Split ``total`` time steps into blocks of ``block`` (+ residual).

    Mirrors Alg. 1 lines 1–3 / 7–14: ``n`` steps become ``ceil(n/k)`` rounds
    whose last round runs the residual ``n % k`` steps.
    """
    if total <= 0:
        return []
    if block <= 0:
        raise ValueError("block must be positive")
    out = [block] * (total // block)
    if total % block:
        out.append(total % block)
    return out
