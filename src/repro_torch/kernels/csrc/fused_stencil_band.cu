// Fused k_on-step 2-D stencil on a row band: one CTA per output tile, the
// apron'd tile loaded by the Tensor Memory Accelerator (TMA).
//
// Replaces the Pallas TPU kernel fused_stencil_band
// (src/repro/kernels/stencil_multistep.py:96, pallas_call at line 147).
// The TPU kernel's grid is independent tiles: one DMA per tile and no
// state carried from one grid step to the next.  On Hopper that is one
// CTA per output tile, grid (nx, ny), nothing carried between CTAs; the
// latency of one CTA's load hides behind the other CTAs resident on its
// SM, not behind a persistent ring (fused_stencil_band_db.cu is the ring,
// and shares this kernel's step code).
//
// Bounded on an H100 by device-memory bytes (one band read, one band
// written) for box2d1r, gradient2d and the narrow stencils at m <= 4, by
// fp32 issue for the wide boxes (box2d4r: 81 multiplies and 80 adds per
// cell update, never contracted into FMAs).  What the design does about it:
//
// * Load.  One thread arms an mbarrier with the tile's bytes and issues
//   one cp.async.bulk.tensor.2d for the whole apron'd tile, from row sy and
//   the 16-byte-aligned column at or left of sx (a box whose inner
//   coordinate is off 16 bytes faults), which may lie before the band's
//   start or past its end.  The tensor map fills out-of-bounds cells with
//   zeros, which is exactly the rule of stencil_tile.cuh (cells outside the
//   band load as zero), so the load has no per-element edge code; no thread
//   spends registers or instructions on the copy.  Where TMA's limits do
//   not hold (the band's address or row pitch not a multiple of 16 bytes, a
//   box side over 256) the same kernel loads through issue_tile_load's
//   16-byte cp.async into the same layout: the host chooses, at run time,
//   in the load only, so the step code is instantiated once.
// * Steps.  The column walk of stencil_walk.cuh: the window in registers,
//   the taps unrolled at compile time over R and the box / star / gradient
//   shape, step s updating only the cells within (m-1-s)*r of the output
//   tile, the frame mask only in tiles that touch a band edge, and the last
//   step writing straight to the output.
// * Occupancy.  Two shared buffers (the loaded tile and one scratch the
//   steps ping-pong with) against the ring's three, so at box2d1r and
//   gradient2d, m=4, three CTAs of 256 threads share an SM and one CTA's
//   load and barriers hide under the others' steps.
//
// In fp32 every cell is computed with the same _rn operations in the same
// order as the plain version, so the kernel is bitwise equal to it; bf16
// accumulates in fp32 and rounds once per step.

#include <cuda.h>
#include <string.h>

#include "stencil_walk.cuh"

namespace repro {

// threads per CTA and the CTAs per SM the registers are budgeted for: the
// narrow stencils' tiles fit three to an SM; from r = 3 one tile takes
// most of the SM's shared memory, so one CTA of 16 warps runs it
template <int R>
constexpr int kThreads = R <= 2 ? 256 : 512;
template <int R>
constexpr int kMinCtas = R <= 2 ? 3 : 1;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// load the apron'd tile at (sy, sx) into buf by TMA: thread 0 arms the
// mbarrier with the box's bytes and issues the copy, every thread waits
// for the barrier's first phase to complete
__device__ __forceinline__ void tma_load_tile(const CUtensorMap* map, void* buf, uint64_t* bar,
                                              unsigned bytes, int sy, int sx) {
  const unsigned b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(buf)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(sx), "r"(sy), "r"(b)
        : "memory");
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
}

template <typename T, int SHAPE, int R>
__global__ void __launch_bounds__(kThreads<R>, kMinCtas<R>)
fused_band_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const __grid_constant__ CUtensorMap map, const __grid_constant__ BandGeom g,
                  const int stride, const int buf_bytes, const int tma, const int vec_ok,
                  const __grid_constant__ Taps taps, const __grid_constant__ StepSplit split) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  T* scratch = reinterpret_cast<T*>(smem + buf_bytes);
  const int i = blockIdx.y, j = blockIdx.x;
  int sy, sx;
  tile_origin(g, i, j, sy, sx);
  // both loads put input column sx & -V (16-byte aligned, as TMA's box
  // origin must be) at the buffer's column 0, so the tile's column 0 sits
  // at offset off; the scratch buffer uses the same layout
  const int sxa = sx & -kVec<T>;
  if (tma) {
    tma_load_tile(&map, tile, reinterpret_cast<uint64_t*>(smem + 2 * buf_bytes),
                  (unsigned)(g.th * stride * sizeof(T)), sy, sxa);
  } else {
    issue_tile_load(in, tile, g, stride, vec_ok, sy, sx);
    cp_async_wait<0>();
    __syncthreads();
  }
  const int off = sx - sxa;
  // tiles whose every updated cell passes the frame mask skip it
  if (sy >= 0 && sy + g.th <= g.H && sx >= 0 && sx + g.tw <= g.X) {
    db_steps<T, SHAPE, R, false>(tile + off, scratch + off, out, g, stride, sy, sx, i, taps, split);
  } else {
    db_steps<T, SHAPE, R, true>(tile + off, scratch + off, out, g, stride, sy, sx, i, taps, split);
  }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime's
// entry-point query, so the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                    : nullptr;
  }();
  return fn;
}

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// TMA's limits (band_uses_tma in stencil_multistep.py states the same
// rule): a 16-byte-aligned band whose row pitch is a multiple of 16 bytes,
// and a box of at most 256 x 256 (the box is a buffer's rows: the apron'd
// tile from its 16-byte-aligned column, db_stride wide)
template <typename T>
static bool uses_tma(const void* in, const BandGeom& g) {
  return reinterpret_cast<uintptr_t>(in) % 16 == 0 && g.X * sizeof(T) % 16 == 0 &&
         db_stride<T>(g.tw) <= 256 && g.th <= 256;
}

// the band as a 2-D tensor map whose box is a buffer's rows, box_w
// columns wide; cells out of the band fill with zeros
template <typename T>
static bool make_map(CUtensorMap* map, const void* in, const BandGeom& g, int box_w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)g.X, (cuuint64_t)g.H};
  const cuuint64_t pitch[1] = {(cuuint64_t)g.X * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_w, (cuuint32_t)g.th};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(in), dims, pitch, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int SHAPE, int R>
static cudaError_t launch(const void* in, void* out, const BandGeom& g, const Taps& taps,
                          cudaStream_t stream, int* shape_out) {
  auto kernel = fused_band_kernel<T, SHAPE, R>;
  // two buffers whose rows have room for the shift to the aligned origin,
  // each 128-byte aligned as TMA's destination must be, then the mbarrier
  const int stride = db_stride<T>(g.tw);
  const int buf_bytes = round_up(g.th * stride * (int)sizeof(T), 128);
  const size_t smem = 2ull * buf_bytes + sizeof(uint64_t);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int threads = kThreads<R>;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || g.ny > 65535) return cudaErrorInvalidConfiguration;
  const bool tma = uses_tma<T>(in, g);
  if (shape_out) {
    shape_out[0] = threads;
    shape_out[1] = (int)smem;
    shape_out[2] = per_sm;
    shape_out[3] = g.nx * g.ny;
    shape_out[4] = tma;
    return cudaSuccess;
  }
  StepSplit split;
  if (!db_split(g, threads / 32, SHAPE == kShapeGradient ? 1 : R, &split)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma && !make_map<T>(&map, in, g, stride)) return cudaErrorInvalidValue;
  const int vec_ok = g.X % kVec<T> == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  kernel<<<dim3(g.nx, g.ny), threads, smem, stream>>>(static_cast<const T*>(in),
                                                      static_cast<T*>(out), map, g, stride,
                                                      buf_bytes, tma, vec_ok, taps, split);
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

static int band_entry(const void* in, void* out, int dtype, int kind, int H, int X, int h_out,
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

// Returns the CUDA error code of the launch (0 on success), or
// cudaErrorInvalidValue when the arguments or the tensor map's encoding
// are refused.  Linear taps must be a box or a star in the plain
// version's order.
extern "C" int repro_fused_stencil_band(const void* in, void* out, int dtype, int kind, int H,
                                        int X, int h_out, int r, int m, int keep_top,
                                        int keep_bottom, int ty, int tx, int ntaps,
                                        const int* tap_dy, const int* tap_dx,
                                        const float* tap_c, void* stream) {
  return repro::band_entry(in, out, dtype, kind, H, X, h_out, r, m, keep_top, keep_bottom, ty,
                           tx, ntaps, tap_dy, tap_dx, tap_c, stream, nullptr);
}

// The launch the same arguments would make, without launching:
// shape[0..4] = threads per CTA, shared bytes per CTA, CTAs per SM (the
// occupancy API's), CTAs in the grid (one per tile), 1 if the tile loads
// by TMA and 0 if by cp.async.
extern "C" int repro_fused_stencil_band_shape(const void* in, void* out, int dtype, int kind,
                                              int H, int X, int h_out, int r, int m,
                                              int keep_top, int keep_bottom, int ty, int tx,
                                              int ntaps, const int* tap_dy, const int* tap_dx,
                                              const float* tap_c, void* stream, int* shape) {
  return repro::band_entry(in, out, dtype, kind, H, X, h_out, r, m, keep_top, keep_bottom, ty,
                           tx, ntaps, tap_dy, tap_dx, tap_c, stream, shape);
}
