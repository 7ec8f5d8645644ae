// Reduced-precision Newton gram on the tensor cores, for NVIDIA Hopper
// (sm_90a): the same fused logistic gradient and Gauss-Newton Hessian as
// gram_grad_hess.cu,
//   t = y s,  sig = sigmoid(-t),
//   term1 = -y sig w,  kappa = w y^2 sig (1 - sig),
//   g = Bf^T term1                    (n,)   full float32 products
//   H = Bf^T diag(kappa) Bf           (n, n) bf16 operands, see below
// with the H product's operands rounded to bf16 as the JAX package's
// reduced-precision gram dots do (superdsm_tpu/dsm/pallas_kernels.py):
// a = Bf kappa (rounded to float32 first), b = Bf, and
//   passes = 1: H = bf16(a)^T bf16(b)                    (_gram_dot_1pass)
//   passes = 3: H = hi(a)^T hi(b) + hi(a)^T lo(b) + lo(a)^T hi(b),
//               hi(x) = bf16(x), lo(x) = bf16(x - hi(x)) (_dot_rows_3pass)
// (round to nearest even; the lo*lo term is dropped, as on the TPU).
//
// Replaces the reduced-precision bodies of the Pallas kernels: B1 with
// _grad_hess_kernel_1pass or _dot_rows_3pass (_fused_grad_hess_call, full
// dense gram), B2 and B3 with _dot_rows_3pass or the 1-pass dot
// (_tri_grad_hess_call, _banded_grad_hess_call: block-upper triangle,
// mirrored). Modes:
//   full     every (u, v) tile pair computed straight, as B1: in bf16 the
//            mirrored product differs from the straight one, because the
//            operand that carries kappa swaps;
//   triangle the tile pairs of the upper triangle of 128 x 128 blocks (the
//            TPU's block), both halves of each diagonal block straight, the
//            strictly lower blocks written as the transpose, as B2;
//   banded   triangle, skipping the chunks outside the band, as B3.
//
// What bounds it on the card: P n^2 / 2 multiply-adds per lane (n^2 in full
// mode), 1 or 3 bf16 mma each, against P n floats of Bf read once. At the
// main path's widths (n = 128 to 1024) that is below the tensor cores'
// ridge (~295 FLOP per byte), so the launch's bytes bound it; inside the
// block, the shared-memory traffic of the staged float32 tiles (each warp
// reads 4 KB per 16-row k-step for its 1,024 x 16 products) is the nearer
// limit.
//
// The design reuses what runs in the float32 kernel, around the tensor
// cores:
// * work items and split-P: a work item is (lane, tile pair, pixel segment
//   of seg_chunks chunks), planned by gram.split_plan from (P, n) alone,
//   as for one lane (never from B: a lane's sums would then depend on its
//   batch), with this kernel's own tile-pair count (nt^2 in full mode,
//   four per upper-triangle 128-block pair otherwise), at most
//   gram.MAX_SEGMENTS; the wrapper launches lanes in groups whose scratch
//   fits its cap. Like the float32 kernel it runs 128-thread blocks, 3
//   resident per SM, so the same target of work items applies. A split
//   launch writes float64 partial tiles (and g) to scratch, and
//   gram_bf16_reduce_kernel sums the segments in order s = 0, 1, ... and
//   writes H, its mirror and g;
// * a one-segment launch (a lane whose tile pairs alone reach the target,
//   or a short pixel loop) writes H and g itself (direct write), because
//   its float64 partials would move too many bytes: in full mode they take
//   twice the bytes of H, written once and read back by a second launch.
//   The direct write is the reduction of a single segment (0 + x = x in
//   float64), so the output does not depend on the path;
// * copies: the float32 kernel's ring of STAGES cp.async.cg stages, one
//   __syncthreads a chunk; every thread computes kappa and term1 once per
//   staged row (a diagonal pair copies its tile once, into b, and the
//   kappa pass writes the scaled copy into a), scaling with __fmul_rn;
// * fragments built in registers: there is no bf16 copy of the tiles in
//   shared memory. Each warp owns a 32 x 32 quadrant of the 64 x 64 tile:
//   2 m16 x 4 n8 mma tiles. The mma's row and column indices map onto tile
//   columns so that each thread reads its fragments as float4s: thread
//   (gid, tig) reads columns 4 gid .. 4 gid + 3 of the quadrant's a and b
//   at the pixel rows 2 tig + {0, 1, 8, 9} of the k-step (8 LDS.128, no
//   bank conflicts with the padded row stride LDS), splits them into bf16
//   hi/lo pairs in registers (split2; __fsub_rn keeps a - hi out of an
//   FMA), and issues the mma.sync m16n8k16 calls: each A fragment feeds 4
//   n8 tiles, each B fragment 2 m16 tiles;
// * the float32 mma accumulators go into float64 running sums every FLUSH
//   chunks, counted by chunk index (not by chunks loaded), so the chunks a
//   band skips add exact zeros and the banded mode equals the triangle
//   mode bitwise; g, from the diagonal pairs' unscaled tile, is float32
//   FMAs flushed the same way, as the float32 kernel sums it;
// * no atomics: results are bitwise reproducible run to run; a frozen lane
//   (active == 0) reads nothing and gives zeros.
//
// Accumulator layout of the m16n8k16 mma (float32 C): element c of n8 tile
// j in m16 tile i is mma row gid + 8 (c >> 1), column 2 tig + (c & 1); mma
// row gid + 8 h of m16 tile i is tile column 4 gid + 2 i + h of the a side,
// mma column q of n8 tile j is tile column 4 q + j of the b side. So
// thread (gid, tig) of a warp holds the quadrant's rows 4 gid + (0..3) and
// columns 8 tig + (0..7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TILE = 64;        // columns per tile (H tile is TILE x TILE)
constexpr int ROWS = 32;        // pixel rows per chunk (one pipeline stage)
constexpr int FLUSH = 2;        // chunks per float32 partial
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int LDS = TILE + 4;   // row stride of a staged tile (floats)
constexpr int THREADS = 128;    // 4 warps: quadrant (w / 2, w % 2)
constexpr int MIN_BLOCKS = 3;   // resident blocks per SM (bounds the registers)
constexpr int QUAD = TILE / 2;  // each warp owns a QUAD x QUAD quadrant
constexpr int BLOCK = 128;      // mirror granularity of triangle/banded mode
constexpr int SUB = BLOCK / TILE;
constexpr int TPR = THREADS / ROWS;  // threads per row in the kappa pass
constexpr int RED_THREADS = 256;
constexpr int RED_ROWS = RED_THREADS / TILE;  // tile rows per reduction block

enum Mode { FULL = 0, TRIANGLE = 1, BANDED = 2 };

static_assert(THREADS == 4 * 32 && THREADS % ROWS == 0, "warps and kappa pass");
static_assert(ROWS * (TILE / 4) % THREADS == 0, "copy split");
static_assert(3 * (ROWS / 4) <= THREADS, "s, y, w copies");
static_assert(STAGES == 4, "the ring's wait counts");
static_assert(ROWS % 16 == 0 && LDS % 4 == 0, "k-steps and float4 rows");

struct Stage {
  float a[ROWS][LDS];  // column tile u, scaled by kappa in place
  float b[ROWS][LDS];  // column tile v
  float s[ROWS];
  float y[ROWS];
  float w[ROWS];
  float t1[ROWS];      // term1 of the chunk's rows
};
static_assert(sizeof(Stage) % 16 == 0, "stage alignment");
constexpr int SMEM_BYTES = STAGES * (int)sizeof(Stage);
// the direct write stages the float32 tile in the ring's memory
static_assert(TILE * (TILE + 1) * (int)sizeof(float) <= SMEM_BYTES, "output tile");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two float32 values (the lower k index first) as the packed bf16 hi and lo
// parts (RNE); the subtraction is exact in float32 and never fused with a
// product.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(x0, __low2float(h)),
                                  __fsub_rn(x1, __high2float(h))));
}

template <int PASSES>
__device__ __forceinline__ void operand(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  if (PASSES == 3) {
    split2(x0, x1, hi, lo);
  } else {
    hi = bits(__floats2bfloat162_rn(x0, x1));
  }
}

__device__ __forceinline__ void load4(float (&dst)[4], const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

// The tile pair (u, v) of work item `pair`: row-major over all pairs in
// full mode; else the upper-triangle 128-block pairs (U <= V) row by row,
// SUB x SUB tile pairs each.
template <bool FULL_MODE>
__device__ __forceinline__ void pair_tiles(int pair, int nt, int& u, int& v) {
  if (FULL_MODE) {
    u = pair / nt;
    v = pair % nt;
    return;
  }
  const int nb = nt / SUB;
  int p = pair / (SUB * SUB);
  const int sub = pair % (SUB * SUB);
  int U = 0;
  while (p >= nb - U) {
    p -= nb - U;
    ++U;
  }
  u = U * SUB + sub / SUB;
  v = (U + p) * SUB + sub % SUB;
}

// Issues the copies of chunk c (tiles u and v, s, y, w) into `st`; a
// diagonal pair (u == v) copies its tile once, into b.
__device__ __forceinline__ void load_chunk(Stage& st, const float* Bfb,
                                           const float* sb, const float* yb,
                                           const float* wb, int n, int u,
                                           int v, int c, int tid) {
  const int p0 = c * ROWS;
#pragma unroll
  for (int k = 0; k < ROWS * (TILE / 4) / THREADS; ++k) {
    const int idx = tid + k * THREADS;
    const int r = idx / (TILE / 4);
    const int c4 = (idx % (TILE / 4)) * 4;
    const float* row = Bfb + (size_t)(p0 + r) * n;
    if (u != v) cp_async16(&st.a[r][c4], row + u * TILE + c4);
    cp_async16(&st.b[r][c4], row + v * TILE + c4);
  }
  constexpr int Q = ROWS / 4;
  if (tid < Q) {
    cp_async16(&st.s[tid * 4], sb + p0 + tid * 4);
  } else if (tid < 2 * Q) {
    cp_async16(&st.y[(tid - Q) * 4], yb + p0 + (tid - Q) * 4);
  } else if (tid < 3 * Q) {
    cp_async16(&st.w[(tid - 2 * Q) * 4], wb + p0 + (tid - 2 * Q) * 4);
  }
}

// kappa once per staged row (TPR threads a row; a diagonal pair scales its
// single tile from b into a): a = Bf kappa rounded to float32, as the TPU
// rounds it before the bf16 split; and term1 for g.
__device__ __forceinline__ void scale_chunk(Stage& st, bool diag, int tid) {
  const int r = tid / TPR;
  const int part4 = tid % TPR;
  const float yy = st.y[r];
  const float ww = st.w[r];
  const float t = yy * st.s[r];
  const float sig = 1.f / (1.f + expf(t));  // sigmoid(-t)
  const float kap = ww * yy * yy * sig * (1.f - sig);
#pragma unroll
  for (int k = 0; k < TILE / 4 / TPR; ++k) {
    const int c4 = (part4 + k * TPR) * 4;
    float4 x = *reinterpret_cast<const float4*>(diag ? &st.b[r][c4] : &st.a[r][c4]);
    x.x = __fmul_rn(x.x, kap);
    x.y = __fmul_rn(x.y, kap);
    x.z = __fmul_rn(x.z, kap);
    x.w = __fmul_rn(x.w, kap);
    *reinterpret_cast<float4*>(&st.a[r][c4]) = x;
  }
  if (part4 == 0) st.t1[r] = -yy * sig * ww;
}

// The products of one staged chunk into a warp's quadrant: per 16-row
// k-step, thread (gid, tig) loads a and b at columns ma .. ma + 3 and
// nb4 .. nb4 + 3 of the pixel rows k0 + 2 tig + {0, 1, 8, 9}, builds its
// fragments in registers and issues 8 (1 pass) or 24 (3 passes) mma.
template <int PASSES>
__device__ __forceinline__ void mma_chunk(const Stage& st, int tig, int ma,
                                          int nb4, float (&acc)[2][4][4]) {
#pragma unroll
  for (int k0 = 0; k0 < ROWS; k0 += 16) {
    const int r0 = k0 + 2 * tig;
    const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
    // A first, so that its float32 values are dead before B's are loaded
    float av[4][4], bv[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(av[q], &st.a[rows[q]][ma]);
    // m16 tile i: mma row gid is column ma + 2 i, row gid + 8 column
    // ma + 2 i + 1; registers 0-3: (row gid, k 2 tig), (row gid + 8,
    // k 2 tig), (row gid, k 2 tig + 8), (row gid + 8, k 2 tig + 8)
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int col = 2 * i + (reg & 1);
        const int q = (reg >> 1) * 2;
        operand<PASSES>(av[q][col], av[q + 1][col], ahi[i][reg], alo[i][reg]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(bv[q], &st.b[rows[q]][nb4]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // n8 tile j: mma column gid is column nb4 + j
      uint32_t bhi[2], blo[2];
      operand<PASSES>(bv[0][j], bv[1][j], bhi[0], blo[0]);
      operand<PASSES>(bv[2][j], bv[3][j], bhi[1], blo[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][j], ahi[i], bhi);
        if (PASSES == 3) {
          mma_bf16(acc[i][j], ahi[i], blo);
          mma_bf16(acc[i][j], alo[i], bhi);
        }
      }
    }
  }
}

__device__ __forceinline__ void flush_all(float (&acc)[2][4][4],
                                          double (&tot)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tot[i][j][c] += (double)acc[i][j][c];
        acc[i][j][c] = 0.f;
      }
}

template <int PASSES, bool FULL_MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gram_bf16_kernel(const float* __restrict__ Bf,
                 const float* __restrict__ s,
                 const float* __restrict__ yv,
                 const float* __restrict__ w,
                 const int* __restrict__ active,
                 const int* __restrict__ band,
                 float* __restrict__ g,
                 float* __restrict__ H,
                 double* __restrict__ part,
                 int P, int n, int seg_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);

  const int pair = blockIdx.x;
  const int seg = blockIdx.y;
  const int b = blockIdx.z;
  const int pairs = gridDim.x;
  const int nsegs = gridDim.y;
  const int B = gridDim.z;
  int u, v;
  pair_tiles<FULL_MODE>(pair, n / TILE, u, v);
  const bool diag = (u == v);
  const bool mirror = !FULL_MODE && (u / SUB != v / SUB);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;  // mma group id
  const int tig = lane % 4;  // thread in group
  const int mbase = (warp / 2) * QUAD;
  const int nbase = (warp % 2) * QUAD;
  const int ma = mbase + 4 * gid;   // this thread's a columns (4) ...
  const int nb4 = nbase + 4 * gid;  // ... and b columns, as mma operands
  const bool g_thread = diag && tid < TILE;  // sums g of column tid

  const bool on = active[b] != 0;
  if (!on && nsegs > 1) return;  // the reduction writes the zeros

  float acc[2][4][4];
  double tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0.f;
        tot[i][j][c] = 0.0;
      }
  float gacc = 0.f;
  double gtot = 0.0;

  if (on) {
    const float* Bfb = Bf + (size_t)b * P * n;
    const float* sb = s + (size_t)b * P;
    const float* yb = yv + (size_t)b * P;
    const float* wb = w + (size_t)b * P;
    const int nchunks = P / ROWS;
    const int c0 = seg * seg_chunks;
    const int c1 = min(c0 + seg_chunks, nchunks);
    const int* bandb = band == nullptr ? nullptr : band + (size_t)b * nchunks * 3;

    // first chunk >= c of the segment where both tiles can be nonzero
    // (uniform across the block)
    auto next_chunk = [&](int c) {
      if (bandb == nullptr) return c;
      for (; c < c1; ++c) {
        const int* bc = bandb + (size_t)c * 3;
        const bool in_u = (u == 0) ? (bc[0] != 0) : (bc[1] <= u && u <= bc[2]);
        const bool in_v = (v == 0) ? (bc[0] != 0) : (bc[1] <= v && v <= bc[2]);
        if (in_u && in_v) break;
      }
      return c;
    };

    // q[i]: the chunks in the ring from the one being multiplied on, in
    // pixel order (c1 = none)
    int q[STAGES - 1];
    int nxt = next_chunk(c0);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      q[i] = nxt;
      if (nxt < c1) {
        load_chunk(stages[i], Bfb, sb, yb, wb, n, u, v, nxt, tid);
        nxt = next_chunk(nxt + 1);
      }
      cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (q[0] < c1) scale_chunk(stages[0], diag, tid);

    int group = -1;  // the chunk / FLUSH group that acc holds
    for (int it = 0; q[0] < c1; ++it) {
      const int c = q[0];
      const Stage& st = stages[it % STAGES];
      cp_async_wait<STAGES - 3>();
      __syncthreads();  // chunk c scaled, chunk c + 1 landed, slot it - 1 free
#pragma unroll
      for (int i = 0; i < STAGES - 2; ++i) q[i] = q[i + 1];
      q[STAGES - 2] = nxt;
      if (nxt < c1) {
        load_chunk(stages[(it + STAGES - 1) % STAGES], Bfb, sb, yb, wb, n, u,
                   v, nxt, tid);
        nxt = next_chunk(nxt + 1);
      }
      cp_async_commit();
      if (q[0] < c1) scale_chunk(stages[(it + 1) % STAGES], diag, tid);

      if (c / FLUSH != group) {
        if (group >= 0) {
          flush_all(acc, tot);
          gtot += (double)gacc;
          gacc = 0.f;
        }
        group = c / FLUSH;
      }
      if (g_thread) {
#pragma unroll 8
        for (int r = 0; r < ROWS; ++r) gacc = fmaf(st.t1[r], st.b[r][tid], gacc);
      }
      mma_chunk<PASSES>(st, tig, ma, nb4, acc);
    }
    cp_async_wait<0>();
    flush_all(acc, tot);
    gtot += (double)gacc;
  }

  if (nsegs == 1) {
    // direct write: the tile through shared memory (the ring is free once
    // every warp is past its last chunk), so that H and its mirror are
    // written a row at a time
    __syncthreads();
    float(*T)[TILE + 1] = reinterpret_cast<float(*)[TILE + 1]>(smem_raw);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          T[ma + 2 * i + (c >> 1)][nbase + 8 * tig + 4 * (c & 1) + j] =
              (float)tot[i][j][c];
    __syncthreads();
    float* Hb = H + (size_t)b * n * n;
    for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
      const int r = idx / TILE;
      const int cc = idx % TILE;
      Hb[(size_t)(u * TILE + r) * n + v * TILE + cc] = T[r][cc];
      if (mirror) Hb[(size_t)(v * TILE + r) * n + u * TILE + cc] = T[cc][r];
    }
    if (g_thread) g[(size_t)b * n + u * TILE + tid] = (float)gtot;
    return;
  }

  // thread row ma + 2 i + h holds columns nbase + 8 tig + 4 e + j in
  // tot[i][j][2 h + e]
  double* Pt = part + (((size_t)seg * B + b) * pairs + pair) * (TILE * TILE);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double2* dst = reinterpret_cast<double2*>(
          Pt + (ma + 2 * i + h) * TILE + nbase + 8 * tig);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dst[2 * e] = make_double2(tot[i][0][2 * h + e], tot[i][1][2 * h + e]);
        dst[2 * e + 1] = make_double2(tot[i][2][2 * h + e], tot[i][3][2 * h + e]);
      }
    }
  }
  if (g_thread) {
    part[(size_t)nsegs * B * pairs * (TILE * TILE) + ((size_t)seg * B + b) * n +
         u * TILE + tid] = gtot;
  }
}

// Sums the segments' float64 partials of one (tile pair, lane) in segment
// order and writes RED_ROWS rows of the tile of H, their mirror (a pair in
// two different 128-blocks outside full mode) and (diagonal pairs) g; a
// frozen lane gets zeros. One thread per entry.
template <bool FULL_MODE>
__global__ void __launch_bounds__(RED_THREADS)
gram_bf16_reduce_kernel(const double* __restrict__ part,
                        const int* __restrict__ active,
                        float* __restrict__ g,
                        float* __restrict__ H,
                        int n, int nsegs) {
  __shared__ float tr[RED_ROWS][TILE + 1];
  const int pair = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * RED_ROWS;
  const int pairs = gridDim.x;
  const int B = gridDim.y;
  int u, v;
  pair_tiles<FULL_MODE>(pair, n / TILE, u, v);
  const bool mirror = !FULL_MODE && (u / SUB != v / SUB);
  const bool on = active[b] != 0;
  const size_t seg_stride = (size_t)B * pairs * (TILE * TILE);
  const int tid = threadIdx.x;
  const int i = row0 + tid / TILE;
  const int j = tid % TILE;
  const double* Pt = part + ((size_t)b * pairs + pair) * (TILE * TILE) + i * TILE + j;
  double sum = 0.0;
  if (on) {
#pragma unroll 16
    for (int sg = 0; sg < nsegs; ++sg) sum += Pt[sg * seg_stride];
  }
  const float x = (float)sum;
  float* Hb = H + (size_t)b * n * n;
  Hb[(size_t)(u * TILE + i) * n + v * TILE + j] = x;
  if (mirror) {
    tr[i - row0][j] = x;
    __syncthreads();
    // thread (jj, ii) writes H[v TILE + jj][u TILE + row0 + ii]
    const int ii = tid % RED_ROWS;
    const int jj = tid / RED_ROWS;
    Hb[(size_t)(v * TILE + jj) * n + u * TILE + row0 + ii] = tr[ii][jj];
  }
  if (u == v && blockIdx.z == 0 && tid < TILE) {
    const double* gpart = part + (size_t)nsegs * seg_stride;
    double gsum = 0.0;
    if (on) {
#pragma unroll 16
      for (int sg = 0; sg < nsegs; ++sg)
        gsum += gpart[((size_t)sg * B + b) * n + u * TILE + tid];
    }
    g[(size_t)b * n + u * TILE + tid] = (float)gsum;
  }
}

constexpr int MAX_DEVICES = 64;

// Launches the gram kernel (cudaFuncSetAttribute once per device and
// instance: the ring needs > 48 KB) and, for several segments, the
// reduction.
template <int PASSES, bool FULL_MODE>
int launch(const float* Bf, const float* s, const float* yv, const float* w,
           const int* active, const int* band, float* g, float* H,
           double* part, int B, int P, int n, int seg_chunks, int nsegs,
           cudaStream_t stream) {
  static std::atomic<bool> smem_attr_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_attr_set[dev].load()) {
    err = cudaFuncSetAttribute(gram_bf16_kernel<PASSES, FULL_MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_attr_set[dev].store(true);
  }
  const int nt = n / TILE;
  const int nb = n / BLOCK;
  const int pairs = FULL_MODE ? nt * nt : nb * (nb + 1) / 2 * SUB * SUB;
  gram_bf16_kernel<PASSES, FULL_MODE>
      <<<dim3(pairs, nsegs, B), THREADS, SMEM_BYTES, stream>>>(
          Bf, s, yv, w, active, band, g, H, part, P, n, seg_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsegs == 1) return (int)err;
  gram_bf16_reduce_kernel<FULL_MODE>
      <<<dim3(pairs, B, TILE / RED_ROWS), RED_THREADS, 0, stream>>>(
          part, active, g, H, n, nsegs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdsm_gram_bf16_tile() { return TILE; }
extern "C" int sdsm_gram_bf16_rows() { return ROWS; }
extern "C" int sdsm_gram_bf16_flush() { return FLUSH; }

// Launches the kernel (and, for several pixel segments, the reduction) on
// `stream`; returns cudaGetLastError() (0 = launched) or
// cudaErrorInvalidValue for arguments it does not take.
// Bf (B, P, n), s/yv/w (B, P) float32 row-major; active (B,) int32; band
// (B, P / ROWS, 3) int32, given exactly in banded mode; g (B, n), H (B, n, n)
// float32; part: float64 scratch of nsegs * B * (pairs * TILE^2 + n)
// entries when nsegs = ceil(P / ROWS / seg_chunks) > 1 (pairs: nt^2 in full
// mode, else 4 per upper-triangle 128-block pair), unused (may be null) at
// one segment. passes in {1, 3}; mode 0 full, 1 triangle, 2 banded.
// Requires P % ROWS == 0, n % TILE == 0 (n % 128 == 0 outside full mode),
// seg_chunks >= P / ROWS or a positive multiple of FLUSH, and 16-byte
// aligned Bf, s, yv, w, H and part.
extern "C" int sdsm_gram_bf16_grad_hess(const float* Bf, const float* s,
                                        const float* yv, const float* w,
                                        const int* active, const int* band,
                                        float* g, float* H, double* part,
                                        int B, int P, int n, int seg_chunks,
                                        int passes, int mode, void* stream) {
  if ((passes != 1 && passes != 3) || mode < FULL || mode > BANDED ||
      (band != nullptr) != (mode == BANDED) || P % ROWS != 0 ||
      n % (mode == FULL ? TILE : BLOCK) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  if (P <= 0 || seg_chunks <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int nchunks = P / ROWS;
  const int nsegs = (nchunks + seg_chunks - 1) / seg_chunks;
  if (nsegs > 65535 || (nsegs > 1 && (seg_chunks % FLUSH || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool full = (mode == FULL);
  if (passes == 3) {
    return full ? launch<3, true>(Bf, s, yv, w, active, band, g, H, part, B, P,
                                  n, seg_chunks, nsegs, st)
                : launch<3, false>(Bf, s, yv, w, active, band, g, H, part, B,
                                   P, n, seg_chunks, nsegs, st);
  }
  return full ? launch<1, true>(Bf, s, yv, w, active, band, g, H, part, B, P,
                                n, seg_chunks, nsegs, st)
              : launch<1, false>(Bf, s, yv, w, active, band, g, H, part, B, P,
                                 n, seg_chunks, nsegs, st);
}
