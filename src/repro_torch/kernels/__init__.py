"""Hand-written Hopper kernels for the paper's compute hot-spot.

* stencil_multistep     — k_on-step fused kernel, one CTA per tile loaded
                          by TMA, CUDA C++ in ``csrc/fused_stencil_band.cu``
* stencil_multistep_db  — persistent variant with a two-slot ``cp.async``
                          ring, ``csrc/fused_stencil_band_db.cu``
* stencil_banded_mxu    — linear stencils as banded products on the
                          tensor cores (3xTF32 ``mma.sync``),
                          ``csrc/banded_fused_stencil.cu``
* dispatch              — registry selecting the implementation per
                          (stencil, steps, backend), and the per-impl
                          kernel cost model
* ops                   — public wrappers;  ref — plain PyTorch oracles
* _build                — builds ``csrc/*.cu`` with ``nvcc`` at first use

Importing this package (or any module in it) builds and loads nothing;
the CUDA library is built the first time a kernel launches.
"""
from __future__ import annotations

__all__ = ["DEFAULT_TILE", "MXU_TILE", "CUDA_TILE", "BAND_CUDA_TILE",
           "DB_CUDA_TILE", "MXU_CUDA_TILE", "ceil_div", "walk_row_stride"]

# the JAX package's VMEM tile (rows, lanes); kept for planner parity.  At
# fp32 it is 512 KiB before the apron — more than the 227 KB of shared
# memory a Hopper block can use — so the CUDA kernels use CUDA_TILE.
DEFAULT_TILE = (256, 512)
# the JAX package's banded-matmul tile: lane dim 128 matches the TPU's
# systolic array; kept for parity of the cost model
MXU_TILE = (DEFAULT_TILE[0], 128)
# the first CUDA kernels' output tile (rows, columns), now the registry's
# default for an impl without a tile of its own: with the worst 2-D apron
# (box2d4r, 4 fused steps: 2*m*r = 32) one fp32 buffer is
# (32+32) x (128+32) x 4 B = 40 KiB, so two or three fit a block's 227 KB.
CUDA_TILE = (32, 128)
# output tile of the one-CTA-per-tile kernel: TMA loads the apron'd tile
# as one box of at most 256 x 256, so the tile plus its apron stays
# inside that; at box2d1r and gradient2d, m=4 its two fp32 buffers take
# 74 KiB, three CTAs per SM
BAND_CUDA_TILE = (64, 120)
# output tile of the persistent kernel: its warps walk 32-column groups of
# each step's region, and at gradient2d, m=4 a 120-column tile makes the
# first step's region 126 columns wide (4 groups) where 128 would make it
# 134 (5 groups, the last nearly idle); with the worst 2-D apron
# (box2d4r, m=4) its three fp32 tiles take 175 KiB, one CTA per SM
DB_CUDA_TILE = (64, 120)
# output tile of the banded tensor-core kernel: the centre is covered by
# 16-row x 8-column mma fragments, so rows are a multiple of 16; at
# box2d4r, m=4 its two padded fp32 buffers and the B table take 142 KiB
MXU_CUDA_TILE = (64, 128)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def walk_row_stride(tw: int, itemsize: int) -> int:
    """Elements per shared row of the column-walk kernels (``db_stride``
    in ``csrc/stencil_walk.cuh``): an apron'd row of ``tw`` cells from the
    16-byte-aligned column at or left of it, in whole 16-byte chunks."""
    vec = 16 // itemsize
    return ceil_div(tw + vec - 1, vec) * vec
