// Fused k_on-step 2-D stencil on a row band: one CTA per output tile.
//
// Replaces the Pallas TPU kernel fused_stencil_band
// (src/repro/kernels/stencil_multistep.py, pallas_call at line 147).
// The CTA loads its apron'd tile into shared memory with coalesced loads,
// runs the m steps there (two buffers, ping-ponged, because each step
// reads the whole old tile) and writes its output tile once: one trip to
// device memory for m steps, the apron recomputed by the neighbours.
// Bounded on an H100 by device-memory bytes (one band read, one band
// written) for every registry stencil at m <= 4; the redundant apron work
// is the price of keeping the m steps on chip.  See stencil_tile.cuh for
// the masking rule.

#include "stencil_tile.cuh"

namespace repro {

template <typename T, int KIND>
__global__ void __launch_bounds__(256)
fused_band_kernel(const T* __restrict__ in, T* __restrict__ out, const BandGeom g,
                  const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + g.th * g.tw;
  const int i = blockIdx.y, j = blockIdx.x;
  int sy, sx;
  tile_origin(g, i, j, sy, sx);
  load_tile(in, buf0, g, sy, sx);
  __syncthreads();
  const T* res = run_steps<T, KIND>(buf0, buf1, g, sy, sx, taps);
  store_tile(res, out, g, i, j);
}

template <typename T, int KIND>
static cudaError_t launch(const void* in, void* out, const BandGeom& g, const Taps& taps,
                          cudaStream_t stream) {
  const size_t smem = 2ull * g.th * g.tw * sizeof(T);
  cudaError_t err = allow_smem(fused_band_kernel<T, KIND>, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(32, 8);
  const dim3 grid(g.nx, g.ny);
  fused_band_kernel<T, KIND><<<grid, block, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), g, taps);
  return cudaGetLastError();
}

}  // namespace repro

// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_fused_stencil_band(const void* in, void* out, int dtype, int kind, int H,
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
