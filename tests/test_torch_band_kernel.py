"""Launch arithmetic of the one-CTA-per-tile kernel (``cuda``, B1) on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); these tests hold its Python mirrors to the CUDA
source's layout (``launch`` and ``uses_tma`` in
``src/repro_torch/kernels/csrc/fused_stencil_band.cu``): the shared bytes
per CTA, the default tile against 227 KB and TMA's box limits, and the
rule that chooses between the TMA and the ``cp.async`` load.
"""
import pytest

from repro_torch.core.stencil import REGISTRY
from repro_torch.kernels import BAND_CUDA_TILE, ceil_div
from repro_torch.kernels._build import SMEM_LIMIT, fit_tile
from repro_torch.kernels.dispatch import KERNEL_IMPLS
from repro_torch.kernels.stencil_multistep import (
    TMA_BOX_MAX, band_smem_bytes, band_uses_tma)

NAMES_2D = sorted(n for n, s in REGISTRY.items() if s.ndim == 2)
# shared memory of one H100 SM, and what the hardware reserves per CTA
SM_SMEM, CTA_RESERVED = 233472, 1024


def _cuda_layout(ty, tx, steps, r, itemsize):
    """``launch``'s arithmetic, written as the CUDA source writes it."""
    V = 16 // itemsize
    th, tw = ty + 2 * steps * r, tx + 2 * steps * r
    db_stride = (tw + 2 * (V - 1)) // V * V
    buf_bytes = (th * db_stride * itemsize + 127) // 128 * 128
    return 2 * buf_bytes + 8


@pytest.mark.parametrize("itemsize", [4, 2])
def test_band_smem_bytes_is_the_cuda_layout(itemsize):
    for ty, tx in ((64, 120), (32, 120), (64, 248), (1, 1), (37, 131)):
        for steps in (1, 2, 4, 8):
            for r in (1, 2, 3, 4):
                assert band_smem_bytes(ty, tx, steps, r, itemsize) \
                    == _cuda_layout(ty, tx, steps, r, itemsize)
    # box2d1r at m = 4, 64 x 120: 72 rows of 132 fp32 words (128 + 3
    # rounded up to 16 bytes), 38016 bytes, already a multiple of 128
    assert band_smem_bytes(64, 120, 4, 1, 4) == 2 * 72 * 132 * 4 + 8
    for ty, tx, steps, r in ((64, 120, 4, 1), (3, 5, 1, 1), (64, 248, 4, 4)):
        smem = band_smem_bytes(ty, tx, steps, r, itemsize)
        assert (smem - 8) % 256 == 0   # two 128-byte-aligned buffers


@pytest.mark.parametrize("name", NAMES_2D)
def test_default_tile_fits_shared_memory_and_tma_boxes(name):
    """BAND_CUDA_TILE holds B1's two buffers in 227 KB, and its apron'd
    tile is one TMA box (at most 256 x 256, rows of whole 16-byte chunks),
    for every 2-D stencil at m <= 4 in fp32 and bf16."""
    r = REGISTRY[name].radius
    ty, tx = BAND_CUDA_TILE
    for itemsize in (4, 2):
        vec = 16 // itemsize
        for steps in (1, 2, 4):
            def fp(a, b):
                return band_smem_bytes(a, b, steps, r, itemsize)
            assert fit_tile(BAND_CUDA_TILE, 10 ** 4, 10 ** 5, steps, r,
                            itemsize, 2, fp) == BAND_CUDA_TILE
            assert fp(ty, tx) <= SMEM_LIMIT
            th, tw = ty + 2 * steps * r, tx + 2 * steps * r
            assert th <= TMA_BOX_MAX
            assert ceil_div(tw + vec - 1, vec) * vec <= TMA_BOX_MAX
            assert band_uses_tma(38400, itemsize, 0, (th, tw))


@pytest.mark.parametrize("name", ["box2d1r", "gradient2d"])
def test_default_tile_leaves_room_for_three_ctas(name):
    """At m = 4 three CTAs' shared memory (with the 1 KB the hardware
    reserves for each) fits one SM, as the redesign sizes the launch; the
    card's occupancy API confirms it in ``chip_smoke.py``."""
    r = REGISTRY[name].radius
    smem = band_smem_bytes(*BAND_CUDA_TILE, 4, r, 4)
    assert 3 * (smem + CTA_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("name", NAMES_2D)
def test_deeper_fusion_cuts_the_tile(name):
    """Past the default tile's depth the tile shrinks instead of failing
    to launch, and the cut tile still fits."""
    r = REGISTRY[name].radius
    for steps in (8, 16):
        def fp(a, b):
            return band_smem_bytes(a, b, steps, r, 4)
        ty, tx = fit_tile(BAND_CUDA_TILE, 10 ** 4, 10 ** 5, steps, r, 4, 2,
                          fp)
        assert fp(ty, tx) <= SMEM_LIMIT
        assert ty <= BAND_CUDA_TILE[0] and tx <= BAND_CUDA_TILE[1]
    # at r = 4, 16 steps the 64-row tile no longer fits
    ty, _ = fit_tile(BAND_CUDA_TILE, 10 ** 4, 10 ** 5, 16, 4, 4, 2,
                     lambda a, b: band_smem_bytes(a, b, 16, 4, 4))
    assert ty < BAND_CUDA_TILE[0]


def test_band_uses_tma_rule():
    tile = (72, 128)
    # the main band: 38400 fp32 columns at an aligned address
    assert band_uses_tma(38400, 4, 1 << 20, tile)
    # rows whose pitch is not a multiple of 16 bytes
    for X in (131, 97, 1285, 38401, 38402):
        assert not band_uses_tma(X, 4, 1 << 20, tile)
    assert band_uses_tma(38404, 4, 1 << 20, tile)
    # bf16: eight columns per 16 bytes
    assert band_uses_tma(38400, 2, 1 << 20, tile)
    assert not band_uses_tma(38404, 2, 1 << 20, tile)
    # an address off 16 bytes (a band that is a view starting mid-row)
    for ptr in (4, 8, 12, (1 << 20) + 4):
        assert not band_uses_tma(38400, 4, ptr, tile)
    assert band_uses_tma(38400, 4, 16, tile)
    # a box side over 256: rows, or columns once the row has room for the
    # shift to its 16-byte-aligned column, in whole 16-byte chunks
    assert band_uses_tma(38400, 4, 0, (256, 128))
    assert not band_uses_tma(38400, 4, 0, (257, 128))
    assert band_uses_tma(38400, 4, 0, (72, 253))   # 253 + 3 -> 256 fp32
    assert not band_uses_tma(38400, 4, 0, (72, 254))   # -> 260
    assert band_uses_tma(38400, 2, 0, (72, 249))   # 249 + 7 -> 256 bf16
    assert not band_uses_tma(38400, 2, 0, (72, 250))   # -> 264


def test_registry_gives_b1_its_own_tile():
    assert KERNEL_IMPLS["cuda"].default_tile == BAND_CUDA_TILE
    assert KERNEL_IMPLS["cuda"].smem_buffers == 2
