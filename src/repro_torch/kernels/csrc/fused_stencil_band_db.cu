// Persistent fused k_on-step 2-D stencil with a two-slot cp.async ring.
//
// Replaces the Pallas TPU kernel fused_stencil_band_db
// (src/repro/kernels/stencil_multistep_db.py, pallas_call at line 121).
// The TPU kernel prefetches tile g+1 during tile g because Pallas-TPU grid
// steps run in order on one core.  CTAs run concurrently, so here the
// order lives inside the CTA: a persistent grid walks tiles
// g = blockIdx.x, blockIdx.x + gridDim.x, ... and each CTA issues the
// cp.async copy of its next tile into the other ring slot before it
// computes the current one, so the copy runs under the m steps.  Same band
// function and mask as fused_stencil_band.cu (stencil_tile.cuh).  Shared
// memory: two ring slots plus one scratch buffer that the steps ping-pong
// with.
//
// Bounded on an H100 by device-memory bytes (one band read, one band
// written) for gradient2d and the narrow stencils, by fp32 issue for the
// wide boxes (box2d4r: 81 multiplies and 80 adds per cell update, never
// contracted into FMAs).  What the design does about it:
//
// * Occupancy.  The grid is the occupancy API's CTAs per SM times the SM
//   count (256 threads a CTA, or 512 when only one CTA fits), so at
//   gradient2d three CTAs share an SM and one CTA's barriers, copies and
//   stores hide under the others' steps.
// * Copies.  The shared tile starts at the 16-byte-aligned column at or
//   left of the apron'd tile, and each row moves in 16-byte cp.async.cg
//   chunks; only chunks that straddle a band edge fall back to per-element
//   copies (zero-filled outside the band).
// * Step loop.  Each thread walks one column of the step's region down
//   rows, holding the (2r+1) x (2r+1) window in registers (the taps unrolled
//   at compile time over R, in the plain version's order): an update loads
//   the 2r+1 cells of one new row instead of every tap.  Step s updates
//   only the cells within (m-1-s)*r of the output tile (the trapezoid), the
//   frame mask is applied only in tiles that touch a band edge, and the
//   last step writes the output tile straight to device memory.
//
// In fp32 every cell is computed with the same _rn operations in the same
// order as the plain version (gradient_update / the linear taps), so the
// kernel is bitwise equal to it; bf16 accumulates in fp32 and rounds once
// per step.  cp.async moves at least 4 bytes, so bf16 cells at a band edge
// are stored by ordinary loads.

#include "stencil_walk.cuh"

namespace repro {

template <typename T, int SHAPE, int R>
__global__ void __launch_bounds__(512)
fused_band_db_kernel(const T* __restrict__ in, T* __restrict__ out,
                     const __grid_constant__ BandGeom g, const int stride, const int vec_ok,
                     const __grid_constant__ Taps taps,
                     const __grid_constant__ StepSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kVec<T>;
  const int tile_elems = g.th * stride;
  T* slot0 = reinterpret_cast<T*>(smem);
  T* slot1 = slot0 + tile_elems;
  T* scratch = slot1 + tile_elems;
  const int nt = g.ny * g.nx;
  int t = blockIdx.x;
  if (t >= nt) return;
  int sy, sx;
  tile_origin(g, t / g.nx, t % g.nx, sy, sx);
  issue_tile_load(in, slot0, g, stride, vec_ok, sy, sx);  // prologue: the first tile
  for (int k = 0; t < nt; ++k, t += gridDim.x) {
    const int i = t / g.nx, j = t % g.nx;
    tile_origin(g, i, j, sy, sx);
    const int next = t + gridDim.x;
    if (next < nt) {
      // prefetch the next tile into the other slot, then wait for this one
      int nsy, nsx;
      tile_origin(g, next / g.nx, next % g.nx, nsy, nsx);
      issue_tile_load(in, (k & 1) ? slot0 : slot1, g, stride, vec_ok, nsy, nsx);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the tile's column 0 sits at offset sx - (sx & -V) of its slot; the
    // scratch buffer uses the same layout
    const int off = sx - (sx & -V);
    T* cur = ((k & 1) ? slot1 : slot0) + off;
    // tiles whose every updated cell passes the frame mask skip it
    if (sy >= 0 && sy + g.th <= g.H && sx >= 0 && sx + g.tw <= g.X) {
      db_steps<T, SHAPE, R, false>(cur, scratch + off, out, g, stride, sy, sx, i, taps, split);
    } else {
      db_steps<T, SHAPE, R, true>(cur, scratch + off, out, g, stride, sy, sx, i, taps, split);
    }
    // the slot just computed in receives the prefetch of the next iteration
    __syncthreads();
  }
}

// launch shape: threads per CTA, shared bytes per CTA, CTAs per SM, grid
struct DbShape {
  int threads, smem, per_sm, grid;
};

template <typename T, int SHAPE, int R>
static cudaError_t launch(const void* in, void* out, const BandGeom& g, const Taps& taps,
                          cudaStream_t stream, int* shape_out) {
  auto kernel = fused_band_db_kernel<T, SHAPE, R>;
  const int stride = db_stride<T>(g.tw);
  const size_t smem = 3ull * g.th * stride * sizeof(T);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  DbShape sh;
  sh.smem = (int)smem;
  sh.threads = 256;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sh.per_sm, kernel, sh.threads, smem);
  if (err != cudaSuccess) return err;
  if (sh.per_sm < 2) {
    // one CTA per SM: give it 16 warps
    sh.threads = 512;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sh.per_sm, kernel, sh.threads, smem);
    if (err != cudaSuccess) return err;
  }
  if (sh.per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nt = g.ny * g.nx;
  sh.grid = nt < sh.per_sm * sms ? nt : sh.per_sm * sms;
  if (shape_out) {
    shape_out[0] = sh.threads;
    shape_out[1] = sh.smem;
    shape_out[2] = sh.per_sm;
    shape_out[3] = sh.grid;
    return cudaSuccess;
  }
  StepSplit split;
  if (!db_split(g, sh.threads / 32, SHAPE == kShapeGradient ? 1 : R, &split)) {
    return cudaErrorInvalidValue;
  }
  const int vec_ok = g.X % kVec<T> == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  kernel<<<sh.grid, sh.threads, smem, stream>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                                g, stride, vec_ok, taps, split);
  return cudaGetLastError();
}

template <typename T, int SHAPE>
static cudaError_t launch_r(const void* in, void* out, const BandGeom& g, const Taps& taps,
                            cudaStream_t s, int* shape_out) {
  switch (g.r) {
    case 1: return launch<T, SHAPE, 1>(in, out, g, taps, s, shape_out);
    case 2: return launch<T, SHAPE, 2>(in, out, g, taps, s, shape_out);
    case 3: return launch<T, SHAPE, 3>(in, out, g, taps, s, shape_out);
    case 4: return launch<T, SHAPE, 4>(in, out, g, taps, s, shape_out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t launch_t(const void* in, void* out, int kind, const BandGeom& g,
                            const Taps& taps, cudaStream_t s, int* shape_out) {
  if (kind == kKindGradient) {
    if (g.r != 1) return cudaErrorInvalidValue;
    return launch<T, kShapeGradient, 1>(in, out, g, taps, s, shape_out);
  }
  switch (tap_shape(taps, g.r)) {
    case kShapeBox: return launch_r<T, kShapeBox>(in, out, g, taps, s, shape_out);
    case kShapeStar: return launch_r<T, kShapeStar>(in, out, g, taps, s, shape_out);
    default: return cudaErrorInvalidValue;
  }
}

static int db_entry(const void* in, void* out, int dtype, int kind, int H, int X, int h_out,
                    int r, int m, int keep_top, int keep_bottom, int ty, int tx, int ntaps,
                    const int* tap_dy, const int* tap_dx, const float* tap_c, void* stream,
                    int* shape_out) {
  BandGeom g;
  Taps taps;
  if (!make_args(H, X, h_out, r, m, keep_top, keep_bottom, ty, tx, ntaps, tap_dy, tap_dx,
                 tap_c, &g, &taps)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) return (int)launch_t<float>(in, out, kind, g, taps, s, shape_out);
  if (dtype == kDtypeBF16) {
    return (int)launch_t<__nv_bfloat16>(in, out, kind, g, taps, s, shape_out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// Returns the CUDA error code of the launch (0 on success).  Linear taps
// must be a box or a star in the plain version's order.
extern "C" int repro_fused_stencil_band_db(const void* in, void* out, int dtype, int kind, int H,
                                           int X, int h_out, int r, int m, int keep_top,
                                           int keep_bottom, int ty, int tx, int ntaps,
                                           const int* tap_dy, const int* tap_dx,
                                           const float* tap_c, void* stream) {
  return repro::db_entry(in, out, dtype, kind, H, X, h_out, r, m, keep_top, keep_bottom, ty, tx,
                         ntaps, tap_dy, tap_dx, tap_c, stream, nullptr);
}

// The launch the same arguments would make, without launching:
// shape[0..3] = threads per CTA, shared bytes per CTA, CTAs per SM (the
// occupancy API's), CTAs in the grid.
extern "C" int repro_fused_stencil_band_db_shape(const void* in, void* out, int dtype, int kind,
                                                 int H, int X, int h_out, int r, int m,
                                                 int keep_top, int keep_bottom, int ty, int tx,
                                                 int ntaps, const int* tap_dy,
                                                 const int* tap_dx, const float* tap_c,
                                                 void* stream, int* shape) {
  return repro::db_entry(in, out, dtype, kind, H, X, h_out, r, m, keep_top, keep_bottom, ty, tx,
                         ntaps, tap_dy, tap_dx, tap_c, stream, shape);
}
