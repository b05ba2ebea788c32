// Fused k_on-step linear 2-D stencil as banded products on the tensor cores.
//
// Replaces the Pallas TPU kernel banded_fused_stencil
// (src/repro/kernels/stencil_banded_mxu.py, pallas_call at line 151), which
// recasts each step of a linear stencil as 2r+1 banded matmuls on the MXU:
//
//   centre = sum_dy  t[dy : TH-2r+dy, :] @ B_dy,   B_dy[x+dx, x] = c[dy, dx]
//
// One CTA per output tile, its apron'd tile in shared memory, the m steps
// ping-ponged between two buffers (as fused_stencil_band.cu), same band
// function and mask (stencil_tile.cuh).  Each step's centre is covered by
// 16 x 8 output fragments, one warp each, computed with
// mma.sync.m16n8k8 TF32 and fp32 accumulation.  What the design does
// about the three hazards of the recast on this card:
//
// * Precision.  TF32 keeps 10 mantissa bits, too few for the reference's
//   2e-5, and the coefficients (1/9, 1/81, ...) are not TF32-exact, so
//   both operands are split, x = hi + lo with hi = tf32(x), lo =
//   tf32(x - hi), and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
//   (3xTF32): about 2^-21 relative per product, fp32 accumulation.  No
//   atomics, no split-K: a cell's sum runs in one fixed order, so the same
//   band always gives the same bits.
// * Size.  The band matrices are never materialised (at box2d4r they would
//   be 9 x 136 x 128 fp32, 612 KiB): each thread builds its B fragments once,
//   in registers, from the (2r+1)^2 coefficients, B_dy[k, x] = c[dy, k-x]
//   for 0 <= k-x <= 2r, else 0.  An 8-column fragment touches only the
//   ceil((8+2r)/8) = 2 K-blocks of 8 that hold nonzeros, not TW/8: the same
//   sums as the dense product, without the zero blocks.
// * Edges.  No pad of the band and no fallback: loads outside the band fill
//   zeros and the global mask decides which cells update.  The shared tile
//   is padded up to whole fragments (rows to 16, columns to 8 plus one
//   K-block) with zeros, which only ever meet zero coefficients or feed
//   cells that are never written.
//
// Bound on an H100: at box2d4r, m=4, the least time is set by operations
// (the 161 FLOP per cell update at the 67 TFLOP/s fp32 rate) rather than
// bytes; the recast spends 3 x 2(2r+1) x 16 x 8 x 8 / (16 x 8) tensor-core
// FLOP per cell update instead, and reads each A element from shared memory
// once per (dy, K-block).
//
// bf16 bands hold bf16 in shared memory; their values and the coefficients
// rounded to bf16 are exact in TF32, so the split's low parts are zero and
// the product is exact, accumulated in fp32 and rounded to bf16 once per
// step, as the TPU kernel does.

#include <stdint.h>

#include "stencil_tile.cuh"

namespace repro {

struct DenseCoefs {
  float c[kMaxTaps];  // (2r+1) x (2r+1), row-major, zeros where no tap
};

// shared-tile layout: rows padded to whole 16-row fragments plus the 2r
// rows they read below, columns to whole 8-column fragments plus the extra
// K-block, the row stride then to 4 mod 32 words so that the 8 rows of an
// A-fragment load fall into distinct banks
struct BandedLayout {
  int mblocks, nblocks;  // fragments over the centre
  int rows, stride;      // allocated rows and row stride (elements)
};

inline BandedLayout banded_layout(const BandGeom& g) {
  const int kblocks = (8 + 2 * g.r + 7) / 8;
  BandedLayout l;
  l.mblocks = (g.th - 2 * g.r + 15) / 16;
  l.nblocks = (g.tw - 2 * g.r + 7) / 8;
  l.rows = 16 * l.mblocks + 2 * g.r;
  const int cols = 8 * (l.nblocks + kblocks - 1);
  l.stride = (cols - 4 + 31) / 32 * 32 + 4;
  return l;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ about 2^-22 |x|), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a coefficient as the band's type holds it (the TPU kernel casts the band
// matrices to the tile's dtype)
template <typename T>
__device__ __forceinline__ float coef_as(float c) {
  return to_f(from_f<T>(c));
}

template <typename T, int R>
__global__ void __launch_bounds__(256)
banded_kernel(const T* __restrict__ in, T* __restrict__ out, const BandGeom g,
              const BandedLayout l, const __grid_constant__ DenseCoefs coefs) {
  constexpr int N = 2 * R + 1;
  constexpr int KB = (8 + 2 * R + 7) / 8;  // nonzero K-blocks per fragment
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = l.rows * l.stride;
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + tile_elems;
  const int i = blockIdx.y, j = blockIdx.x;
  int sy, sx;
  tile_origin(g, i, j, sy, sx);

  // both buffers get the apron'd tile (zero outside the band and in the
  // padding): cells that never update then agree in both for all m steps
  for (int idx = threadIdx.x; idx < tile_elems; idx += blockDim.x) {
    const int ly = idx / l.stride, lx = idx - ly * l.stride;
    const int gy = sy + ly, gx = sx + lx;
    T v = from_f<T>(0.f);
    if (ly < g.th && lx < g.tw && gy >= 0 && gy < g.H && gx >= 0 && gx < g.X) {
      v = in[(int64_t)gy * g.X + gx];
    }
    cur[idx] = v;
    nxt[idx] = v;
  }

  // this lane's B fragments, hi and lo parts: b[h] = B[k = tig + 4h, n = gid]
  // of K-block kb, i.e. c[dy, 8kb + tig + 4h - gid] inside the band
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t bhi[N][KB][2], blo[N][KB][2];
#pragma unroll
  for (int dy = 0; dy < N; ++dy) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int dx = 8 * kb + tig + 4 * h - gid;
        const float c = (dx >= 0 && dx < N) ? coef_as<T>(coefs.c[dy * N + dx]) : 0.f;
        split_tf32(c, bhi[dy][kb][h], blo[dy][kb][h]);
      }
    }
  }
  __syncthreads();

  const int hc = g.th - 2 * R, wc = g.tw - 2 * R;  // centre extents
  const int nfrag = l.mblocks * l.nblocks;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int s = 0; s < g.m; ++s) {
    for (int f = warp; f < nfrag; f += nwarps) {
      const int mb = f / l.nblocks, nb = f - mb * l.nblocks;
      const int r0 = 16 * mb + gid;  // centre row of d[0], d[1]; d[2], d[3] are 8 below
      const int c0 = 8 * nb;         // first centre column (and K index) of the fragment
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int dy = 0; dy < N; ++dy) {
        // A_dy[row, k] = tile[row + dy, k]
        const T* pa = cur + (r0 + dy) * l.stride + c0 + tig;
        const T* pb = pa + 8 * l.stride;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const float a[4] = {to_f(pa[8 * kb]), to_f(pb[8 * kb]), to_f(pa[8 * kb + 4]),
                              to_f(pb[8 * kb + 4])};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(a[q], ahi[q], alo[q]);
          // small terms first
          mma_tf32(d, alo, bhi[dy][kb]);
          mma_tf32(d, ahi, blo[dy][kb]);
          mma_tf32(d, ahi, bhi[dy][kb]);
        }
      }
      // d[q] is centre cell (r0 + 8*(q >= 2), c0 + 2*tig + (q & 1))
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = r0 + ((q >> 1) << 3), cj = c0 + 2 * tig + (q & 1);
        if (ci < hc && cj < wc) {
          const int ly = ci + R, lx = cj + R;
          const int gy = sy + ly, gx = sx + lx;
          if (gy >= R && gy < g.H - R && gx >= R && gx < g.X - R) {
            nxt[ly * l.stride + lx] = from_f<T>(d[q]);
          }
        }
      }
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // output tile (i, j), masking the ragged bottom and right edges
  const int mr = g.m * R;
  for (int idx = threadIdx.x; idx < g.ty * g.tx; idx += blockDim.x) {
    const int ly = idx / g.tx, lx = idx - ly * g.tx;
    const int o = i * g.ty + ly, gx = j * g.tx + lx;
    if (o < g.h_out && gx < g.X) out[(int64_t)o * g.X + gx] = cur[(ly + mr) * l.stride + lx + mr];
  }
}

template <typename T, int R>
static cudaError_t launch(const void* in, void* out, const BandGeom& g, const DenseCoefs& c,
                          cudaStream_t stream) {
  const BandedLayout l = banded_layout(g);
  const size_t smem = 2ull * l.rows * l.stride * sizeof(T);
  cudaError_t err = allow_smem(banded_kernel<T, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.nx, g.ny);
  banded_kernel<T, R><<<grid, 256, smem, stream>>>(static_cast<const T*>(in),
                                                    static_cast<T*>(out), g, l, c);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_r(const void* in, void* out, const BandGeom& g, const DenseCoefs& c,
                            cudaStream_t s) {
  switch (g.r) {
    case 1: return launch<T, 1>(in, out, g, c, s);
    case 2: return launch<T, 2>(in, out, g, c, s);
    case 3: return launch<T, 3>(in, out, g, c, s);
    case 4: return launch<T, 4>(in, out, g, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// Returns the CUDA error code of the launch (0 on success).  Takes the same
// arguments as the other band kernels; the taps of a linear stencil are
// scattered into the dense (2r+1)^2 coefficient grid.
extern "C" int repro_banded_fused_stencil(const void* in, void* out, int dtype, int kind, int H,
                                          int X, int h_out, int r, int m, int keep_top,
                                          int keep_bottom, int ty, int tx, int ntaps,
                                          const int* tap_dy, const int* tap_dx,
                                          const float* tap_c, void* stream) {
  using namespace repro;
  BandGeom g;
  Taps taps;
  if (kind != kKindLinear || r < 1 || r > 4 ||
      !make_args(H, X, h_out, r, m, keep_top, keep_bottom, ty, tx, ntaps, tap_dy, tap_dx, tap_c,
                 &g, &taps)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = 2 * r + 1;
  DenseCoefs c = {};
  for (int k = 0; k < taps.n; ++k) {
    const int dy = taps.dy[k] + r, dx = taps.dx[k] + r;
    if (dy < 0 || dy >= n || dx < 0 || dx >= n) return (int)cudaErrorInvalidValue;
    c.c[dy * n + dx] = taps.c[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) return (int)launch_r<float>(in, out, g, c, s);
  if (dtype == kDtypeBF16) return (int)launch_r<__nv_bfloat16>(in, out, g, c, s);
  return (int)cudaErrorInvalidValue;
}
