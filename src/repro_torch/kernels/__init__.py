"""Hand-written Hopper kernels for the paper's compute hot-spot.

* stencil_multistep     — k_on-step fused kernel (shared-memory-resident
                          steps), CUDA C++ in ``csrc/fused_stencil_band.cu``
* stencil_multistep_db  — persistent variant with a two-slot ``cp.async``
                          ring, ``csrc/fused_stencil_band_db.cu``
* dispatch              — registry selecting the implementation per
                          (stencil, steps, backend)
* ops                   — public wrappers;  ref — plain PyTorch oracles
* _build                — builds ``csrc/*.cu`` with ``nvcc`` at first use

Importing this package (or any module in it) builds and loads nothing;
the CUDA library is built the first time a kernel launches.
"""
from __future__ import annotations

__all__ = ["DEFAULT_TILE", "CUDA_TILE"]

# the JAX package's VMEM tile (rows, lanes); kept for planner parity.  At
# fp32 it is 512 KiB before the apron — more than the 227 KB of shared
# memory a Hopper block can use — so the CUDA kernels use CUDA_TILE.
DEFAULT_TILE = (256, 512)
# output tile (rows, columns) of the CUDA kernels: 128 columns give each
# warp four coalesced 128-byte row segments; with the worst 2-D apron
# (box2d4r, 4 fused steps: 2*m*r = 32) one fp32 buffer is
# (32+32) x (128+32) x 4 B = 40 KiB, so the fused kernel's two buffers
# and the persistent kernel's three fit a block's 227 KB.
CUDA_TILE = (32, 128)
