// The column walk that steps a shared-memory tile: shared device code of
// the two fused-stencil kernels (fused_stencil_band.cu, one CTA per tile,
// and fused_stencil_band_db.cu, persistent with a cp.async ring).
//
// * Step loop.  Each thread walks one column of the step's region down
//   rows, holding the window in registers (the taps unrolled at compile
//   time over R and the box / star / gradient shape, in the plain
//   version's order): an update loads the 2r+1 cells of one new row
//   instead of every tap, and a linear stencil carries its sums as left
//   folds across the arriving rows.  Step s updates only the cells within
//   (m-1-s)*r of the output tile (the trapezoid); the frame mask is a
//   template flag, set only for tiles that touch a band edge; the last
//   step writes the output tile straight to device memory.  Warp splits
//   are planned on the host (db_split).
// * Copies.  issue_tile_load moves an apron'd tile's rows in 16-byte
//   cp.async.cg chunks into a buffer whose column 0 is the 16-byte-aligned
//   input column at or left of the tile (db_stride sizes the rows).
//
// In fp32 every cell is computed with the same _rn operations in the same
// order as the plain version, so the kernels are bitwise equal to it;
// bf16 accumulates in fp32 and rounds once per step.
#pragma once

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

}  // namespace repro
