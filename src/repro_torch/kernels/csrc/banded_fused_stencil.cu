// Fused k_on-step linear 2-D stencil as banded products on the tensor cores.
//
// Replaces the Pallas TPU kernel banded_fused_stencil
// (src/repro/kernels/stencil_banded_mxu.py, pallas_call at line 151), which
// recasts each step of a linear stencil as 2r+1 banded matmuls on the MXU:
//
//   centre = sum_dy  t[dy : TH-2r+dy, :] @ B_dy,   B_dy[x+dx, x] = c[dy, dx]
//
// Persistent CTAs walk the output tiles; each holds its apron'd tile in
// shared memory as fp32 (bf16 bands are widened on load), the m steps
// ping-ponged between two buffers, same band function and mask as the
// other band kernels (stencil_tile.cuh).  Each step is covered by 16 x 8
// output fragments computed with mma.sync m16n8k8 TF32 and fp32
// accumulation.
//
// Bound on an H100: at box2d4r, m=4, the least time is set by operations
// (161 FLOP per cell update at the 67 TFLOP/s fp32 rate) rather than bytes.
// The recast spends 3 x 2(2r+1) x 16 x 8 x 8 tensor-core FLOP per fragment
// and step instead; what keeps it from that count is the issue of the A
// operand (shared-memory loads and the TF32 split) beside the MMAs, which
// the design cuts:
//
// * A operand.  A warp owns a strip of up to kStrip consecutive fragments
//   in one 16-row block.  Per row offset dy it loads each 8-column K-block
//   of A once, with one ldmatrix.x4 (the b16 8x8 layout hands each lane
//   the 32-bit word the TF32 A fragment wants; rows are 16-byte aligned and
//   the row stride is 4 mod 32 words, so the loads are conflict-free),
//   those of dy + 1 while dy's MMAs run, and splits it once with two
//   instructions per element: block k feeds fragment k as its second
//   K-block and fragment k+1 as its first.  The strip's six products run
//   over all its fragments in turn, so their accumulators overlap.
// * Occupancy and copies.  Sixteen warps a CTA (or two CTAs of eight when
//   the tile leaves room for two), as many CTAs as fit the SMs, each
//   walking tiles b, b + grid, ...  The last step writes only to the
//   output band, so while it runs the free buffer receives the next tile
//   by cp.async.  The B fragments live in a small shared table (one row
//   per dy and lane), built once per CTA.
// * Trapezoid.  Step s updates only the cells within (m-1-s)*r of the
//   output tile: its fragment grid starts at row s*r and column (s*r
//   rounded down to 4) of the centre, about a fifth fewer MMAs at box2d4r,
//   m=4.  Both buffers start zeroed and each step writes every centre cell
//   of its grid (a frame cell as a copy), so what a step reads outside the
//   cells it needs is finite and meets only zero coefficients or feeds
//   cells no later step needs.
//
// Precision: TF32 keeps 10 mantissa bits, too few for the reference's 2e-5,
// and the coefficients (1/9, 1/81, ...) are not TF32-exact, so both operands
// are split, x = hi + lo, and each product is a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi (3xTF32), small terms first, per fragment in the order dy, then
// K-block, fp32 accumulation.  The coefficients split with rounding
// (hi = tf32(b), lo = tf32(b - hi)), once per CTA; the tile's values with
// truncation (hi = x cut to TF32, lo = x - hi, whose bits past TF32 the
// tensor cores ignore), two instructions per element: about 2^-20
// relative per product.  No atomics, no split-K: a cell's sum runs in
// one fixed order, so the same band always gives the same bits.
//
// Size: the band matrices are never materialised (at box2d4r they would be
// 9 x 136 x 128 fp32, 612 KiB): B_dy[k, x] = c[dy, k-x] for 0 <= k-x <= 2r,
// and an 8-column fragment touches only the 2 K-blocks of 8 that hold its
// nonzeros.  Edges: loads outside the band fill zeros and the global mask
// decides which cells update; the shared tile is padded with zeros up to
// the fragments every step reads.
//
// bf16 bands: their values and the coefficients rounded to bf16 are exact
// in TF32, so the low parts are zero and the product is exact, accumulated
// in fp32 and rounded to bf16 once per step, as the TPU kernel does.

#include <stdint.h>

#include "stencil_tile.cuh"

namespace repro {

constexpr int kStrip = 4;  // most fragments a warp's strip holds

struct DenseCoefs {
  float c[kMaxTaps];  // (2r+1) x (2r+1), row-major, zeros where no tap
};

// step s's fragment grid, in centre coordinates (centre row/column 0 is
// tile row/column r): mblocks x nblocks fragments from (row0, col0),
// covering rows [s*r, hc - s*r) and columns [s*r, wc - s*r)
struct StepGrid {
  int row0, col0, mblocks, nblocks;
};

__host__ __device__ inline StepGrid step_grid(const BandGeom& g, int s) {
  const int hc = g.th - 2 * g.r, wc = g.tw - 2 * g.r;
  const int lo = s * g.r;
  StepGrid q;
  q.row0 = lo;
  q.col0 = lo & ~3;  // ldmatrix rows start on 16 bytes
  q.mblocks = (hc - lo - q.row0 + 15) / 16;
  q.nblocks = (wc - lo - q.col0 + 7) / 8;
  return q;
}

// shared-tile layout of one fp32 buffer: the rows and columns every step's
// fragments read (2r rows below a fragment, one K-block right of it), the
// row stride then raised to 4 mod 32 words.  Mirrored by
// stencil_banded_mxu.banded_smem_bytes.
struct BandedLayout {
  int rows, stride;
};

inline BandedLayout banded_layout(const BandGeom& g) {
  int rows = 0, cols = 0;
  for (int s = 0; s < g.m; ++s) {
    const StepGrid q = step_grid(g, s);
    const int r1 = q.row0 + 16 * q.mblocks + 2 * g.r, c1 = q.col0 + 8 * (q.nblocks + 1);
    rows = r1 > rows ? r1 : rows;
    cols = c1 > cols ? c1 : cols;
  }
  BandedLayout l;
  l.rows = rows;
  l.stride = (cols - 4 + 31) / 32 * 32 + 4;
  return l;
}

// two fp32 buffers and the B table: (2r+1) x 32 lanes x 8 words
inline size_t banded_smem(const BandedLayout& l, int r) {
  return 2ull * l.rows * l.stride * sizeof(float) + (2ull * r + 1) * 32 * 8 * sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ about 2^-22 |x|), both TF32: the coefficients' split,
// done once per CTA
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// the A operand's split, on every element the MMAs read: hi is x cut to
// TF32 (sign, exponent, top 10 mantissa bits), lo = x - hi exactly in
// fp32 (it has at most 13 significant bits); the tensor cores read only
// the TF32 bits of lo, so x = hi + lo + about 2^-20 |x|.  Two instructions
// where cvt.rna takes three per part (an infinity test, an add, a mask).
__device__ __forceinline__ void split_a(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a value as the band's type holds it (the TPU kernel casts the band
// matrices to the tile's dtype, and rounds each step's result to it)
template <typename T>
__device__ __forceinline__ float held_as(float v) {
  return to_f(from_f<T>(v));
}

// step s's strips per 16-row block (a) and fragments per strip (b): the
// fewest strips of at most kStrip fragments, or more when that fills the
// warps better (a strip costs about b + 1 A loads per b x 6 MMAs)
inline bool banded_split(const BandGeom& g, int nwarps, StepSplit* split) {
  if (g.m > kMaxSteps) return false;
  for (int s = 0; s < g.m; ++s) {
    const StepGrid q = step_grid(g, s);
    int best = 0x7fffffff;
    for (int p = (q.nblocks + kStrip - 1) / kStrip; p <= q.nblocks; ++p) {
      const int len = (q.nblocks + p - 1) / p;
      const int cost = (q.mblocks * p + nwarps - 1) / nwarps * (4 * len + 1);
      if (cost < best) {
        best = cost;
        split->a[s] = (short)p;
        split->b[s] = (short)len;
      }
    }
  }
  return true;
}

// ldmatrix.x4 of one 16 x 8 A K-block: p is this lane's row address
__device__ __forceinline__ void load_block(const float* p, uint32_t (&a)[4]) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// One strip of LEN fragments from centre (r0, c0).  Per row offset dy the
// LEN + 1 A K-blocks are loaded once (those of dy + 1 while dy's products
// run) and split once, then each of the six products runs over all
// fragments (independent accumulators, so their latencies overlap); per
// fragment the order stays dy, K-block, then lo*hi, hi*lo, hi*hi.  Then
// the strip's cells go to the next buffer, or on the last step to the
// output band.
template <typename T, int R, int LEN>
__device__ __forceinline__ void strip(const float* cur, float* nxt, const uint4* btab,
                                      T* __restrict__ out, const BandGeom& g, int stride,
                                      bool last, int sy, int sx, int i, int r0, int c0) {
  constexpr int N = 2 * R + 1;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // this lane's ldmatrix row: matrices 0..3 are rows 0-7 / 8-15 of the
  // block, words 0-3 / 4-7; A_dy[row, k] = tile[row + dy, k]
  const float* pa = cur + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + c0 + (lane >> 4) * 4;
  float d[LEN][4];
#pragma unroll
  for (int f = 0; f < LEN; ++f) d[f][0] = d[f][1] = d[f][2] = d[f][3] = 0.f;
  uint32_t raw[LEN + 1][4];
#pragma unroll
  for (int b = 0; b <= LEN; ++b) load_block(pa + 8 * b, raw[b]);
#pragma unroll 1
  for (int dy = 0; dy < N; ++dy) {
    uint32_t ahi[LEN + 1][4], alo[LEN + 1][4];
#pragma unroll
    for (int b = 0; b <= LEN; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_a(raw[b][e], ahi[b][e], alo[b][e]);
    }
    if (dy + 1 < N) {
#pragma unroll
      for (int b = 0; b <= LEN; ++b) load_block(pa + (dy + 1) * stride + 8 * b, raw[b]);
    }
    // B_dy fragments of K-blocks 0 and 1, hi and lo: b[h] = B[k = tig + 4h, n = gid]
    const uint4 bh = btab[(dy * 32 + lane) * 2];
    const uint4 bl = btab[(dy * 32 + lane) * 2 + 1];
#pragma unroll
    for (int f = 0; f < LEN; ++f) mma_tf32(d[f], alo[f], bh.x, bh.y);
#pragma unroll
    for (int f = 0; f < LEN; ++f) mma_tf32(d[f], ahi[f], bl.x, bl.y);
#pragma unroll
    for (int f = 0; f < LEN; ++f) mma_tf32(d[f], ahi[f], bh.x, bh.y);
#pragma unroll
    for (int f = 0; f < LEN; ++f) mma_tf32(d[f], alo[f + 1], bh.z, bh.w);
#pragma unroll
    for (int f = 0; f < LEN; ++f) mma_tf32(d[f], ahi[f + 1], bl.z, bl.w);
#pragma unroll
    for (int f = 0; f < LEN; ++f) mma_tf32(d[f], ahi[f + 1], bh.z, bh.w);
  }

  // d[f][e] is centre cell (r0 + gid + 8*(e >= 2), c0 + 8f + 2*tig + (e & 1)),
  // tile cell (+R, +R).  A cell is written when it lies in the centre (or,
  // on the last step, in the output tile and the band), and it updates
  // when it passes the frame mask; the last step writes a frame cell's
  // input, which its buffer still holds.
  const int mr = g.m * R;
  bool row_ok[2], row_upd[2];
  int ly[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ly[h] = r0 + gid + 8 * h + R;
    const int gy = sy + ly[h];
    row_upd[h] = gy >= R && gy < g.H - R;
    row_ok[h] = last ? ly[h] >= mr && ly[h] < mr + g.ty && i * g.ty + ly[h] - mr < g.h_out
                     : ly[h] < g.th - R;
  }
#pragma unroll
  for (int f = 0; f < LEN; ++f) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int lx = c0 + 8 * f + 2 * tig + c + R, gx = sx + lx;
      const bool col_upd = gx >= R && gx < g.X - R;
      const bool col_ok = last ? lx >= mr && lx < mr + g.tx && gx < g.X : lx < g.tw - R;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!(row_ok[h] && col_ok)) continue;
        const float v = d[f][2 * h + c];
        if (!last) {
          const int at = ly[h] * stride + lx;
          nxt[at] = row_upd[h] && col_upd ? held_as<T>(v) : cur[at];
        } else {
          const float w = row_upd[h] && col_upd ? v : cur[ly[h] * stride + lx];
          out[(int64_t)(i * g.ty + ly[h] - mr) * g.X + gx] = from_f<T>(w);
        }
      }
    }
  }
}

template <typename T, int R>
__device__ void banded_step(const float* cur, float* nxt, const uint4* btab,
                            T* __restrict__ out, const BandGeom& g, int stride, int s,
                            bool last, int sy, int sx, int i, const StepSplit& split) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const StepGrid q = step_grid(g, s);
  const int sp = split.a[s], len = split.b[s];
  for (int w = warp; w < q.mblocks * sp; w += nwarps) {
    const int mb = w / sp, nb0 = (w - mb * sp) * len;
    const int cnt = min(len, q.nblocks - nb0);
    const int r0 = q.row0 + 16 * mb;  // centre row of the strip's first fragment row
    const int c0 = q.col0 + 8 * nb0;  // first centre column (and K index) of the strip
    switch (cnt) {
      case 1: strip<T, R, 1>(cur, nxt, btab, out, g, stride, last, sy, sx, i, r0, c0); break;
      case 2: strip<T, R, 2>(cur, nxt, btab, out, g, stride, last, sy, sx, i, r0, c0); break;
      case 3: strip<T, R, 3>(cur, nxt, btab, out, g, stride, last, sy, sx, i, r0, c0); break;
      case 4: strip<T, R, 4>(cur, nxt, btab, out, g, stride, last, sy, sx, i, r0, c0); break;
      default: break;  // a strip past the grid's last fragment
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// the apron'd tile from origin (sy, sx) into a shared buffer, zero outside
// the band and in the padding; a warp per row, a lane per column.  fp32
// moves by cp.async (the caller waits); bf16 is widened by ordinary loads.
template <typename T>
__device__ void load_tile_f32(const T* __restrict__ in, float* buf, const BandGeom& g,
                              const BandedLayout& l, int sy, int sx) {
  const int nwarps = blockDim.x >> 5;
  for (int ly = threadIdx.x >> 5; ly < l.rows; ly += nwarps) {
    const int gy = sy + ly;
    const bool row_in = ly < g.th && gy >= 0 && gy < g.H;
    const T* row = in + (int64_t)(row_in ? gy : 0) * g.X;
    for (int lx = threadIdx.x & 31; lx < l.stride; lx += 32) {
      const int gx = sx + lx;
      const bool ok = row_in && lx < g.tw && gx >= 0 && gx < g.X;
      if constexpr (sizeof(T) == 4) {
        // src-size 0 zero-fills
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(buf + ly * l.stride + lx));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                     "l"(ok ? row + gx : in), "r"(ok ? 4 : 0));
      } else {
        buf[ly * l.stride + lx] = ok ? to_f(row[gx]) : 0.f;
      }
    }
  }
  cp_async_commit();
}

// CTA b computes tiles b, b + gridDim.x, ...; the next tile's copy runs
// under the current one's last step (see the header)
template <typename T, int R>
__global__ void __launch_bounds__(512)
banded_kernel(const T* __restrict__ in, T* __restrict__ out, const __grid_constant__ BandGeom g,
              const BandedLayout l, const __grid_constant__ DenseCoefs coefs,
              const __grid_constant__ StepSplit split) {
  constexpr int N = 2 * R + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = l.rows * l.stride;
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + tile_elems;
  uint4* btab = reinterpret_cast<uint4*>(nxt + tile_elems);
  const int nt = g.ny * g.nx;
  int t = blockIdx.x;
  if (t >= nt) return;

  for (int idx = threadIdx.x; idx < 2 * tile_elems; idx += blockDim.x) cur[idx] = 0.f;
  // the B table: lane (gid, tig)'s B_dy fragments, hi then lo, K-blocks 0
  // and 1: B[k = tig + 4h, n = gid] of K-block kb is c[dy, 8kb + tig + 4h - gid]
  for (int e = threadIdx.x; e < N * 32; e += blockDim.x) {
    const int dy = e >> 5, ln = e & 31, gid = ln >> 2, tig = ln & 3;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int dx = 8 * kb + tig + 4 * h - gid;
        const float c = (dx >= 0 && dx < N) ? held_as<T>(coefs.c[dy * N + dx]) : 0.f;
        split_tf32(c, hi[2 * kb + h], lo[2 * kb + h]);
      }
    }
    btab[2 * e] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    btab[2 * e + 1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();
  int sy, sx;
  tile_origin(g, t / g.nx, t % g.nx, sy, sx);
  load_tile_f32(in, cur, g, l, sy, sx);
  cp_async_wait_all();
  __syncthreads();

  for (; t < nt; t += gridDim.x) {
    const int i = t / g.nx;
    tile_origin(g, i, t - i * g.nx, sy, sx);
    for (int s = 0; s + 1 < g.m; ++s) {
      banded_step<T, R>(cur, nxt, btab, out, g, l.stride, s, false, sy, sx, i, split);
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    const int next = t + gridDim.x;
    int nsy = 0, nsx = 0;
    if (next < nt) tile_origin(g, next / g.nx, next % g.nx, nsy, nsx);
    if (next < nt && sizeof(T) == 4) load_tile_f32(in, nxt, g, l, nsy, nsx);
    banded_step<T, R>(cur, nxt, btab, out, g, l.stride, g.m - 1, true, sy, sx, i, split);
    if (next < nt && sizeof(T) != 4) load_tile_f32(in, nxt, g, l, nsy, nsx);
    cp_async_wait_all();
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T, int R>
static cudaError_t launch(const void* in, void* out, const BandGeom& g, const DenseCoefs& c,
                          cudaStream_t stream, int* shape_out) {
  auto kernel = banded_kernel<T, R>;
  const BandedLayout l = banded_layout(g);
  const size_t smem = banded_smem(l, g.r);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // eight warps a CTA when two CTAs fit an SM, else sixteen
  int threads = 256, per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 2) {
    threads = 512;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nt = g.ny * g.nx;
  const int grid = nt < per_sm * sms ? nt : per_sm * sms;
  StepSplit split;
  if (!banded_split(g, threads / 32, &split)) return cudaErrorInvalidValue;
  if (shape_out) {
    shape_out[0] = threads;
    shape_out[1] = (int)smem;
    shape_out[2] = per_sm;
    shape_out[3] = grid;
    return cudaSuccess;
  }
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(in), static_cast<T*>(out), g, l,
                                          c, split);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_r(const void* in, void* out, const BandGeom& g, const DenseCoefs& c,
                            cudaStream_t s, int* shape_out) {
  switch (g.r) {
    case 1: return launch<T, 1>(in, out, g, c, s, shape_out);
    case 2: return launch<T, 2>(in, out, g, c, s, shape_out);
    case 3: return launch<T, 3>(in, out, g, c, s, shape_out);
    case 4: return launch<T, 4>(in, out, g, c, s, shape_out);
    default: return cudaErrorInvalidValue;
  }
}

static int banded_entry(const void* in, void* out, int dtype, int kind, int H, int X, int h_out,
                        int r, int m, int keep_top, int keep_bottom, int ty, int tx, int ntaps,
                        const int* tap_dy, const int* tap_dx, const float* tap_c, void* stream,
                        int* shape_out) {
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
  if (dtype == kDtypeF32) return (int)launch_r<float>(in, out, g, c, s, shape_out);
  if (dtype == kDtypeBF16) return (int)launch_r<__nv_bfloat16>(in, out, g, c, s, shape_out);
  return (int)cudaErrorInvalidValue;
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
  return repro::banded_entry(in, out, dtype, kind, H, X, h_out, r, m, keep_top, keep_bottom, ty,
                             tx, ntaps, tap_dy, tap_dx, tap_c, stream, nullptr);
}

// The launch the same arguments would make, without launching:
// shape[0..3] = threads per CTA, shared bytes per CTA, CTAs per SM (the
// occupancy API's), CTAs in the grid.
extern "C" int repro_banded_fused_stencil_shape(const void* in, void* out, int dtype, int kind,
                                                int H, int X, int h_out, int r, int m,
                                                int keep_top, int keep_bottom, int ty, int tx,
                                                int ntaps, const int* tap_dy, const int* tap_dx,
                                                const float* tap_c, void* stream, int* shape) {
  return repro::banded_entry(in, out, dtype, kind, H, X, h_out, r, m, keep_top, keep_bottom, ty,
                             tx, ntaps, tap_dy, tap_dx, tap_c, stream, shape);
}
