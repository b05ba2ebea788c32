"""Run-time parameter selection heuristic (paper Sec. IV-C); port of
:mod:`repro.core.params`.

Given the stencil code (radius, element size, arrays, domain) and the
hardware, enumerate feasible ``(d, S_TB)`` combinations that

* keep the kernel phase dominant over transfer (the paper's "satisfy"
  inequality) so that on-chip reuse — not the interconnect — decides
  performance,
* fit ``N_strm`` in-flight working sets in device memory,
* keep the halo working space within one chunk (region-sharing feasibility),
* keep more chunks than streams (no idle streams).

The heuristic reduces the search space; like the paper, callers then sweep
the survivors (:func:`repro_torch.core.tune.tune`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List

from .analytic import Hardware

__all__ = ["CodeSpec", "Candidate", "feasible", "enumerate_candidates"]


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Run-time configuration variables (paper Table I)."""

    sz: int                # size along each dimension
    radius: int            # stencil radius r
    dim: int = 2
    n_arrays: int = 1      # N_a
    b_elem: int = 4        # bytes per element
    total_steps: int = 640  # S_tot

    @property
    def row_elems(self) -> int:
        """Elements per row incl. the 2r frame: (sz + 2r)^(dim-1)."""
        return (self.sz + 2 * self.radius) ** (self.dim - 1)

    def d_chk(self, d: int) -> float:
        """Chunk size in elements: sz * (sz+2r)^(dim-1) / d."""
        return self.sz * self.row_elems / d

    @property
    def w_halo(self) -> float:
        """Halo working-space per TB step: 2r * (sz+2r)^(dim-1) elements."""
        return 2 * self.radius * self.row_elems


@dataclasses.dataclass(frozen=True)
class Candidate:
    d: int
    s_tb: int
    working_set_bytes: int
    halo_fraction: float   # halo working space / chunk (paper: keep < ~20%)


def feasible(code: CodeSpec, hw: Hardware, d: int, s_tb: int) -> bool:
    d_chk = code.d_chk(d)
    w_tb = code.w_halo * s_tb
    b = code.b_elem
    # satisfy: kernel time (off-chip bound, n_a arrays) > transfer time
    satisfy = (d_chk + w_tb) * code.n_arrays * b / hw.bw_dmem * s_tb > (
        d_chk * max(code.n_arrays - 1, 1) * b / hw.bw_intc
    )
    fits = (d_chk + w_tb) * hw.n_streams * b <= hw.c_dmem
    halo_ok = w_tb <= d_chk
    streams_ok = d > hw.n_streams
    return bool(satisfy and fits and halo_ok and streams_ok)


def enumerate_candidates(
    code: CodeSpec,
    hw: Hardware,
    d_grid: Iterable[int] = (4, 8, 16, 32),
    s_tb_grid: Iterable[int] = (40, 80, 160, 320, 640),
) -> List[Candidate]:
    out: List[Candidate] = []
    for d in d_grid:
        for s_tb in s_tb_grid:
            if s_tb > code.total_steps:
                continue
            if feasible(code, hw, d, s_tb):
                d_chk = code.d_chk(d)
                w_tb = code.w_halo * s_tb
                out.append(
                    Candidate(
                        d=d,
                        s_tb=s_tb,
                        working_set_bytes=int((d_chk + w_tb) * code.b_elem),
                        halo_fraction=w_tb / d_chk,
                    )
                )
    return out
