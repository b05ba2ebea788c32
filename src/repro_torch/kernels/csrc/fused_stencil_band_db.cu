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

#include <stdint.h>

#include "stencil_tile.cuh"

namespace repro {

// compile-time shape of the taps: the kernel sums the window's taps in
// row-major order, which is the order of Stencil.taps() for these shapes
constexpr int kShapeBox = 0;
constexpr int kShapeStar = 1;
constexpr int kShapeGradient = 2;

template <int SHAPE, int R>
__device__ __forceinline__ constexpr bool is_tap(int dy, int dx) {
  return SHAPE == kShapeBox || dy == R || dx == R;
}

// which compile-time shape the taps are, or -1
inline int tap_shape(const Taps& t, int r) {
  for (int shape = kShapeBox; shape <= kShapeStar; ++shape) {
    int k = 0;
    bool ok = true;
    for (int dy = -r; dy <= r && ok; ++dy) {
      for (int dx = -r; dx <= r && ok; ++dx) {
        if (shape == kShapeStar && dy != 0 && dx != 0) continue;
        ok = k < t.n && t.dy[k] == dy && t.dx[k] == dx;
        ++k;
      }
    }
    if (ok && k == t.n) return shape;
  }
  return -1;
}

// elements per 16-byte chunk, and the shared tile's row stride: room for
// the apron'd row shifted right by up to V-1 to its aligned origin
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
inline int db_stride(int tw) {
  return (tw + 2 * (kVec<T> - 1)) / kVec<T> * kVec<T>;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start the copy of an apron'd tile into a ring slot (one commit group):
// the slot's column 0 is input column sx & -V
template <typename T>
__device__ void issue_tile_load(const T* __restrict__ in, T* slot, const BandGeom& g,
                                int stride, bool vec_ok, int sy, int sx) {
  constexpr int V = kVec<T>;
  const int sxa = sx & -V;
  const int nch = (sx - sxa + g.tw + V - 1) / V;
  // a 16-byte-aligned source for the zero-filling copies (which read nothing)
  const T* zsrc = reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(in) & ~uintptr_t(15));
  // a warp per row, a lane per chunk: no division per chunk
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int ly = threadIdx.x >> 5; ly < g.th; ly += nwarps) {
    const int gy = sy + ly;
    const bool row_in = gy >= 0 && gy < g.H;
    const T* row = in + (int64_t)(row_in ? gy : 0) * g.X;
    for (int q = lane; q < nch; q += 32) {
      const int gx0 = sxa + q * V;
      T* dst = slot + ly * stride + q * V;
      const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
      if (!row_in || gx0 + V <= 0 || gx0 >= g.X) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst), "l"(zsrc),
                     "r"(0));
      } else if (vec_ok && gx0 >= 0 && gx0 + V <= g.X) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sdst), "l"(row + gx0));
      } else {
        for (int e = 0; e < V; ++e) {
          const int gx = gx0 + e;
          const bool ok = gx >= 0 && gx < g.X;
          if constexpr (sizeof(T) == 4) {
            // src-size 0 zero-fills the cell outside the band
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdst + 4 * e),
                         "l"(ok ? row + gx : in), "r"(ok ? 4 : 0));
          } else {
            dst[e] = ok ? row[gx] : from_f<T>(0.f);
          }
        }
      }
    }
  }
  cp_async_commit();
}

// what one step's column walk needs
template <typename T>
struct Walk {
  const T* src;  // shared tile at (row 0, column lx - R)
  T* nxt;        // next shared tile (steps before the last)
  T* out;        // the output band (the last step)
  int stride, lx, y1;
  bool col_upd;     // the column is inside the global column mask
  int64_t out_col;  // output column index, gx
  int out_row0;     // output row of shared row 0
};

template <typename T, int N>
__device__ __forceinline__ void load_row(float (&w)[N], const T* p) {
#pragma unroll
  for (int dx = 0; dx < N; ++dx) w[dx] = to_f(p[dx]);
}

// cell (yy, lx) of the step is v (if it updates): store it
template <typename T, int R, bool MASK, bool LAST>
__device__ __forceinline__ void put(float v, const Walk<T>& k, const BandGeom& g, int sy,
                                    int yy) {
  if (MASK && !(k.col_upd && sy + yy >= R && sy + yy < g.H - R)) {
    v = to_f(k.src[yy * k.stride + R]);  // a frame or out-of-band cell keeps its value
  }
  if constexpr (LAST) {
    const int o = k.out_row0 + yy;
    if (o < g.h_out && k.out_col < g.X) k.out[(int64_t)o * g.X + k.out_col] = from_f<T>(v);
  } else {
    k.nxt[yy * k.stride + k.lx] = from_f<T>(v);
  }
}

// index of window cell (dy, dx) among the shape's taps in row-major order
template <int SHAPE, int R>
__device__ __forceinline__ constexpr int tap_index(int dy, int dx) {
  return SHAPE == kShapeBox ? dy * (2 * R + 1) + dx
                            : (dy < R ? dy : (dy == R ? R + dx : 2 * R + dy));
}

// append the taps of window row dy, applied to input row v, to a cell's
// sum: the plain version's left fold over its taps, continued in order
template <int SHAPE, int R>
__device__ __forceinline__ void add_row(float& acc, const float (&v)[2 * R + 1], int dy,
                                        const Taps& taps) {
#pragma unroll
  for (int dx = 0; dx < 2 * R + 1; ++dx) {
    if (is_tap<SHAPE, R>(dy, dx)) {
      const int t = tap_index<SHAPE, R>(dy, dx);
      const float p = __fmul_rn(taps.c[t], v[dx]);
      acc = t == 0 ? p : __fadd_rn(acc, p);
    }
  }
}

// Linear stencils: output row y+U of a column walk.  Rows arrive in
// order, so each output's sum can run as a left fold over its taps while
// the rows pass: acc[(U + q) % N] is output row y+U+q's partial sum, and
// the arriving row y+U+R is its window row 2R-q.  Output y+U is then
// complete.  The rotation is a renaming of registers.
template <typename T, int SHAPE, int R, bool MASK, bool LAST, bool CHECK, int U>
__device__ __forceinline__ void lin_row(float (&acc)[2 * R + 1], const Walk<T>& k,
                                        const BandGeom& g, int sy, int y, const Taps& taps) {
  constexpr int N = 2 * R + 1;
  const int yy = y + U;
  if (CHECK && yy >= k.y1) return;
  float v[N];
  load_row<T, N>(v, k.src + (yy + R) * k.stride);
#pragma unroll
  for (int q = 0; q < N; ++q) add_row<SHAPE, R>(acc[(U + q) % N], v, 2 * R - q, taps);
  put<T, R, MASK, LAST>(acc[U % N], k, g, sy, yy);
  if constexpr (U + 1 < N) {
    lin_row<T, SHAPE, R, MASK, LAST, CHECK, U + 1>(acc, k, g, sy, y, taps);
  }
}

// gradient2d: output row y+U of a column walk, from the 3 x 3 window whose
// row y+U-1+dy sits in w[(U + dy) % 3]
template <typename T, bool MASK, bool LAST, bool CHECK, int U>
__device__ __forceinline__ void grad_row(float (&w)[3][3], const Walk<T>& k, const BandGeom& g,
                                         int sy, int y) {
  const int yy = y + U;
  if (CHECK && yy >= k.y1) return;
  load_row<T, 3>(w[(U + 2) % 3], k.src + (yy + 1) * k.stride);
  const float (&c)[3] = w[(U + 1) % 3];
  put<T, 1, MASK, LAST>(gradient_update(c[1], w[U % 3][1], w[(U + 2) % 3][1], c[0], c[2]), k,
                        g, sy, yy);
  if constexpr (U + 1 < 3) grad_row<T, MASK, LAST, CHECK, U + 1>(w, k, g, sy, y);
}

// walk column k.lx down rows [y0, k.y1): whole blocks of N rows without
// bounds checks, so the compiler can overlap their loads and arithmetic,
// then the rest
template <typename T, int SHAPE, int R, bool MASK, bool LAST>
__device__ __forceinline__ void walk(const Walk<T>& k, const BandGeom& g, int sy, int y0,
                                     const Taps& taps) {
  constexpr int N = 2 * R + 1;
  int y = y0;
  if constexpr (SHAPE == kShapeGradient) {
    float w[3][3];
    load_row<T, 3>(w[0], k.src + (y0 - 1) * k.stride);
    load_row<T, 3>(w[1], k.src + y0 * k.stride);
    for (; y + 3 <= k.y1; y += 3) grad_row<T, MASK, LAST, false, 0>(w, k, g, sy, y);
    if (y < k.y1) grad_row<T, MASK, LAST, true, 0>(w, k, g, sy, y);
  } else {
    // rows y0-R .. y0+R-1 start the sums of outputs y0 .. y0+2R-1
    float acc[N];
#pragma unroll
    for (int q = 0; q < N - 1; ++q) {
      float v[N];
      load_row<T, N>(v, k.src + (y0 - R + q) * k.stride);
#pragma unroll
      for (int j = 0; j <= q; ++j) add_row<SHAPE, R>(acc[j], v, q - j, taps);
    }
    for (; y + N <= k.y1; y += N) {
      lin_row<T, SHAPE, R, MASK, LAST, false, 0>(acc, k, g, sy, y, taps);
    }
    if (y < k.y1) lin_row<T, SHAPE, R, MASK, LAST, true, 0>(acc, k, g, sy, y, taps);
  }
}

// step s: update rows/columns [(s+1)R, dim-(s+1)R) of the tile.  A warp
// takes a (32-column group, row segment) item; each lane walks its column
// down the segment.  The last step writes the output tile to `out`.
// step s's row segments per 32-column group (a) and their rows (b): the
// fewest rounds of warp items times the rows a segment walks, plus what a
// segment costs beyond them (over: the partial sums a linear walk leaves
// past its end, about R rows' work)
inline bool db_split(const BandGeom& g, int nwarps, int over, StepSplit* p) {
  if (g.m > kMaxSteps) return false;
  for (int s = 0; s < g.m; ++s) {
    const int lo = (s + 1) * g.r;
    const int hd = g.th - 2 * lo, groups = (g.tw - 2 * lo + 31) / 32;
    int nseg = 1, best = 0x7fffffff;
    for (int q = 1; q <= hd && q <= 4 * nwarps; ++q) {
      const int cost = (groups * q + nwarps - 1) / nwarps * ((hd + q - 1) / q + over);
      if (cost < best) {
        best = cost;
        nseg = q;
      }
    }
    p->a[s] = (short)nseg;
    p->b[s] = (short)((hd + nseg - 1) / nseg);
  }
  return true;
}

// step s: update rows/columns [(s+1)R, dim-(s+1)R) of the tile.  A warp
// takes a (32-column group, row segment) item; each lane walks its column
// down the segment.  The last step writes the output tile to `out`.
template <typename T, int SHAPE, int R, bool MASK, bool LAST>
__device__ void db_step(const T* cur, T* nxt, T* __restrict__ out, const BandGeom& g, int stride,
                        int s, int sy, int sx, int i, const Taps& taps, const StepSplit& split) {
  const int lo = (s + 1) * R;
  const int wd = g.tw - 2 * lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int groups = (wd + 31) >> 5;
  const int nseg = split.a[s], hs = split.b[s];
  for (int item = warp; item < groups * nseg; item += nwarps) {
    const int seg = item / groups;
    const int lx = lo + (item - seg * groups) * 32 + lane;
    const int y0 = lo + seg * hs;
    Walk<T> k;
    k.y1 = min(y0 + hs, g.th - lo);
    if (lx >= g.tw - lo || y0 >= k.y1) continue;
    k.src = cur + lx - R;
    k.nxt = nxt;
    k.out = out;
    k.stride = stride;
    k.lx = lx;
    const int gx = sx + lx;
    k.col_upd = gx >= R && gx < g.X - R;
    k.out_col = gx;
    k.out_row0 = i * g.ty - g.m * g.r;
    walk<T, SHAPE, R, MASK, LAST>(k, g, sy, y0, taps);
  }
}

template <typename T, int SHAPE, int R, bool MASK>
__device__ void db_steps(T* cur, T* nxt, T* __restrict__ out, const BandGeom& g, int stride,
                         int sy, int sx, int i, const Taps& taps, const StepSplit& split) {
  for (int s = 0; s + 1 < g.m; ++s) {
    db_step<T, SHAPE, R, MASK, false>(cur, nxt, out, g, stride, s, sy, sx, i, taps, split);
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  db_step<T, SHAPE, R, MASK, true>(cur, nxt, out, g, stride, g.m - 1, sy, sx, i, taps, split);
}

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
