// Persistent fused k_on-step 2-D stencil with a two-slot cp.async ring.
//
// Replaces the Pallas TPU kernel fused_stencil_band_db
// (src/repro/kernels/stencil_multistep_db.py, pallas_call at line 121).
// The TPU kernel prefetches tile g+1 during tile g because Pallas-TPU grid
// steps run in order on one core.  CTAs run concurrently, so here the
// order lives inside the CTA: a persistent grid of at most one CTA per SM
// walks tiles g = blockIdx.x, blockIdx.x + gridDim.x, ... and issues the
// cp.async copy of its next tile into the other ring slot before it
// computes the current one, so the copy runs under the m steps.  Same band
// function and mask as fused_stencil_band.cu (stencil_tile.cuh); bounded
// by device-memory bytes like it.  Shared memory: two ring slots plus one
// scratch buffer that the steps ping-pong with.
//
// cp.async moves 4, 8 or 16 bytes, so only 4-byte elements ride it; a
// bf16 tile is filled by ordinary loads into the ring slot (same order of
// work, no overlap of the copy).

#include "stencil_tile.cuh"

namespace repro {

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start the copy of an apron'd tile into a ring slot (one commit group)
template <typename T>
__device__ void issue_tile_load(const T* __restrict__ in, T* tile, const BandGeom& g, int sy,
                                int sx) {
  if constexpr (sizeof(T) == 4) {
    for (int ly = threadIdx.y; ly < g.th; ly += blockDim.y) {
      const int gy = sy + ly;
      const bool row_in = gy >= 0 && gy < g.H;
      for (int lx = threadIdx.x; lx < g.tw; lx += blockDim.x) {
        const int gx = sx + lx;
        const bool ok = row_in && gx >= 0 && gx < g.X;
        // src-size 0 zero-fills the cell outside the band
        const T* src = ok ? in + (int64_t)gy * g.X + gx : in;
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(tile + ly * g.tw + lx));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                     "r"(ok ? 4 : 0));
      }
    }
  } else {
    load_tile(in, tile, g, sy, sx);
  }
  cp_async_commit();
}

template <typename T, int KIND>
__global__ void __launch_bounds__(512)
fused_band_db_kernel(const T* __restrict__ in, T* __restrict__ out, const BandGeom g,
                     const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = g.th * g.tw;
  T* slot0 = reinterpret_cast<T*>(smem);
  T* slot1 = slot0 + tile_elems;
  T* scratch = slot1 + tile_elems;
  const int nt = g.ny * g.nx;
  const int stride = gridDim.x;
  int t = blockIdx.x;
  if (t >= nt) return;
  int sy, sx;
  tile_origin(g, t / g.nx, t % g.nx, sy, sx);
  issue_tile_load(in, slot0, g, sy, sx);  // prologue: the first tile
  for (int k = 0; t < nt; ++k, t += stride) {
    const int i = t / g.nx, j = t % g.nx;
    tile_origin(g, i, j, sy, sx);
    const int next = t + stride;
    if (next < nt) {
      // prefetch the next tile into the other slot, then wait for this one
      int nsy, nsx;
      tile_origin(g, next / g.nx, next % g.nx, nsy, nsx);
      issue_tile_load(in, (k & 1) ? slot0 : slot1, g, nsy, nsx);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* res = run_steps<T, KIND>((k & 1) ? slot1 : slot0, scratch, g, sy, sx, taps);
    store_tile(res, out, g, i, j);
    // the slot just computed in receives the prefetch of the next iteration
    __syncthreads();
  }
}

template <typename T, int KIND>
static cudaError_t launch(const void* in, void* out, const BandGeom& g, const Taps& taps,
                          cudaStream_t stream) {
  const size_t smem = 3ull * g.th * g.tw * sizeof(T);
  cudaError_t err = allow_smem(fused_band_db_kernel<T, KIND>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nt = g.ny * g.nx;
  const dim3 block(32, 16);
  const dim3 grid(nt < sms ? nt : sms);
  fused_band_db_kernel<T, KIND><<<grid, block, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), g, taps);
  return cudaGetLastError();
}

}  // namespace repro

// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_fused_stencil_band_db(const void* in, void* out, int dtype, int kind, int H,
                                           int X, int h_out, int r, int m, int keep_top,
                                           int keep_bottom, int ty, int tx, int ntaps,
                                           const int* tap_dy, const int* tap_dx,
                                           const float* tap_c, void* stream) {
  using namespace repro;
  BandGeom g;
  Taps taps;
  if (!make_args(H, X, h_out, r, m, keep_top, keep_bottom, ty, tx, ntaps, tap_dy, tap_dx,
                 tap_c, &g, &taps)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    return (int)(kind == kKindLinear ? launch<float, kKindLinear>(in, out, g, taps, s)
                                     : launch<float, kKindGradient>(in, out, g, taps, s));
  }
  if (dtype == kDtypeBF16) {
    return (int)(kind == kKindLinear
                     ? launch<__nv_bfloat16, kKindLinear>(in, out, g, taps, s)
                     : launch<__nv_bfloat16, kKindGradient>(in, out, g, taps, s));
  }
  return (int)cudaErrorInvalidValue;
}
