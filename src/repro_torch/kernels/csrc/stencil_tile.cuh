// Shared device code of the band kernels: band geometry, the taps, the
// tile origin, gradient2d's update and the host-side argument checks (the
// column walk that steps a tile is in stencil_walk.cuh).
//
// Semantics (those of repro_torch.core.reference.multi_step_band): m fused
// steps of a 2-D stencil on an (H, X) row band; the column frames [0, r)
// and [X-r, X) never change, nor do the row frames when keep_top /
// keep_bottom is set; the output has h_out = H - 2mr + (kt + kb)mr rows,
// output row o being input row o + (keep_top ? 0 : mr).
//
// A tile is the (ty, tx) output tile plus an mr apron on every side.  Tile
// cells outside the band load as zero.  A cell updates iff it lies in the
// tile's [r, th-r) x [r, tw-r) and globally in [r, H-r) x [r, X-r): the
// second rule is the frame mask, and on a band edge without a frame it
// touches only rows the output never reads.  An updatable cell reads only
// in-band cells, so the zeros never reach it, and after s steps every
// cell at least s*r from the tile edge holds the reference value; the
// output tile is exactly mr from it.  So no clamped start, no padded copy
// of the band and no fallback for bands smaller than a tile are needed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kMaxTaps = 81;  // (2*4+1)^2 taps of box2d4r
constexpr int kKindLinear = 0;
constexpr int kKindGradient = 1;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

// nonzero taps of a linear stencil in the plain version's order;
// dy/dx are offsets from the centre
struct Taps {
  int n;
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
  float c[kMaxTaps];
};

struct BandGeom {
  int H, X;                   // input band
  int h_out;                  // output rows
  int r, m;                   // radius, fused steps
  int keep_top, keep_bottom;  // row frames kept
  int ty, tx;                 // output tile
  int th, tw;                 // apron'd tile (ty + 2mr, tx + 2mr)
  int ny, nx;                 // output tiles along rows / columns
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// first input row / column of tile (i, j)'s apron'd region
__device__ __forceinline__ void tile_origin(const BandGeom& g, int i, int j, int& sy, int& sx) {
  const int mr = g.m * g.r;
  sy = i * g.ty + (g.keep_top ? 0 : mr) - mr;
  sx = j * g.tx - mr;
}

// gradient2d on a cell c and its north/south/west/east neighbours:
// c + dt * (gn+gs+gw+ge) * rsqrt(gn^2+gs^2+gw^2+ge^2 + eps).  Every
// operation is the plain version's, in its order, through the _rn
// intrinsics, which the compiler never contracts into FMAs: in fp32 the
// kernel then computes what the PyTorch ops compute, bit for bit (rsqrtf
// is what torch.rsqrt runs on CUDA).  That matters beyond taste:
// gradient2d amplifies one-ulp differences by orders of magnitude over a
// few hundred steps, so only equal arithmetic holds a long run to its oracle.
__device__ __forceinline__ float gradient_update(float c, float n, float s, float w, float e) {
  const float gn = __fsub_rn(n, c);
  const float gs = __fsub_rn(s, c);
  const float gw = __fsub_rn(w, c);
  const float ge = __fsub_rn(e, c);
  const float num = __fadd_rn(__fadd_rn(__fadd_rn(gn, gs), gw), ge);
  const float den = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(gn, gn), __fmul_rn(gs, gs)), __fmul_rn(gw, gw)),
      __fmul_rn(ge, ge));
  const float step = __fmul_rn(__fmul_rn(0.1f, num), rsqrtf(__fadd_rn(den, 1e-3f)));
  return __fadd_rn(c, step);
}

// how each step's work is cut among a CTA's warps (two numbers per step),
// planned on the host once per launch
constexpr int kMaxSteps = 64;
struct StepSplit {
  short a[kMaxSteps], b[kMaxSteps];
};

// geometry and taps from the C entry points' arguments; false on bad input
inline bool make_args(int H, int X, int h_out, int r, int m, int keep_top, int keep_bottom,
                      int ty, int tx, int ntaps, const int* tap_dy, const int* tap_dx,
                      const float* tap_c, BandGeom* g, Taps* taps) {
  if (H <= 0 || X <= 0 || h_out <= 0 || r <= 0 || m <= 0 || ty <= 0 || tx <= 0 ||
      ntaps < 0 || ntaps > kMaxTaps) {
    return false;
  }
  g->H = H;
  g->X = X;
  g->h_out = h_out;
  g->r = r;
  g->m = m;
  g->keep_top = keep_top;
  g->keep_bottom = keep_bottom;
  g->ty = ty;
  g->tx = tx;
  g->th = ty + 2 * m * r;
  g->tw = tx + 2 * m * r;
  g->ny = (h_out + ty - 1) / ty;
  g->nx = (X + tx - 1) / tx;
  taps->n = ntaps;
  for (int k = 0; k < ntaps; ++k) {
    taps->dy[k] = (signed char)tap_dy[k];
    taps->dx[k] = (signed char)tap_dx[k];
    taps->c[k] = tap_c[k];
  }
  return true;
}

// dynamic shared memory above 48 KB needs the opt-in attribute
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro
