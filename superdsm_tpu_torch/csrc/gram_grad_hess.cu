// Fused logistic gradient and Gauss-Newton Hessian of the batched Newton
// solver, for NVIDIA Hopper (sm_90a).
//
// Per lane b, over the pixels p of its padded region:
//   t = y s,  sig = sigmoid(-t),
//   term1 = -y sig w,  kappa = w y^2 sig (1 - sig),
//   g = Bf^T term1                    (n,)
//   H = Bf^T diag(kappa) Bf           (n, n)
//
// Replaces the Pallas TPU kernels of superdsm_tpu/dsm/pallas_kernels.py:
// _fused_grad_hess_call (B1, full dense gram), _tri_grad_hess_call (B2,
// upper triangle of block pairs, lower triangle mirrored) and
// _banded_grad_hess_call (B3, only the column blocks that can be nonzero),
// with fused_grad_hess_batched's dispatch (B4) moved to
// superdsm_tpu_torch/dsm/gram.py.
//
// What bounds it on the card: the gram is P n (n + 1) / 2 fused multiply-adds
// per lane against P n floats of Bf read once, some 30 to 250 FLOP per byte
// at n = 128 to 1024, so it is bound by the FP32 FMA pipe (67 TFLOP/s on an
// H100 SXM at 700 W), Bf's bytes second. The precision contract is full
// float32 products (a reduced-precision gram stalled the LM solver on the
// TPU), so the tensor cores' TF32/bf16 paths are out.
//
// Precision: every product is a float32 FFMA; a float32 partial covers 64
// pixel rows (FLUSH chunks) and is then added into a float64 running sum.
// The Newton systems reach condition ~1e5 (the quadratic basis columns are
// nearly collinear over a small region), and a float32 running sum over
// 10^4 pixels drifts too far for them (measured: a cuBLAS float32 gram of
// the n = 6 systems, 4e-5 relative error, stalled the solver). No atomics,
// and every output is summed in a fixed order: results are bitwise
// reproducible run to run.
//
// How the design meets the FMA bound:
// * register-blocked tiles: a work item computes one 64 x 64 tile (u, v),
//   u <= v, of H (H is symmetric; H[v, u] is written as the exact
//   transpose). Each of its 4 warps owns a 32 x 32 quadrant, each thread an
//   8 x 4 sub-tile of it: per pixel row 32 FFMA against 3 LDS.128 that read
//   64 + 64 + 128 bytes a warp (the row operand is a broadcast). The
//   float32 partials and their float64 totals fit in 168 registers, so 3
//   blocks (12 warps) share an SM without spills;
// * a diagonal tile (u == v) skips its quadrant below the diagonal (the
//   mirror of the one above it): that warp sums g instead;
// * kappa is applied once per staged row: one pass scales the u tile in
//   place (one sigmoid and 16 FMULs a thread a chunk) and stores term1 for g;
// * pipelined copies: the pixels stream in ROWS-row chunks through a ring of
//   STAGES shared-memory stages filled by 16-byte cp.async.cg (two Bf column
//   tiles plus s, y and w). One __syncthreads a chunk: while chunk c is
//   multiplied, chunk c + 1 is scaled and chunks c + 2 and c + 3 are in
//   flight;
// * split-P: a work item is (lane, tile pair, pixel segment of seg_chunks
//   chunks). Few-lane launches (B = 1 re-solves, converged batches, the
//   small tail chunks) would otherwise run a handful of blocks on 132 SMs.
//   gram.split_plan picks seg_chunks from (P, n) alone, as for one lane,
//   never from B (a lane's sums would then depend on its batch) nor from
//   the count of active lanes (that would need a host sync): one segment
//   when pairs already reaches gram.TARGET_ITEMS work items, else enough
//   segments of at least gram.MIN_SEG_CHUNKS chunks to reach it, at most
//   gram.MAX_SEGMENTS; the wrapper launches lanes in groups whose scratch
//   fits its cap. seg_chunks is a multiple of
//   FLUSH, so the float32 partials are the same whatever the segment
//   count; only the float64 sums split. Each item writes its float64
//   partial tile (and g) to scratch that the wrapper allocates, and
//   gram_reduce_kernel sums the segments in order s = 0, 1, ... and writes
//   H with its mirror, and g: one output path at every segment count.
//   Results at two segment counts differ in the last bits.
// * banded mode: `band` gives, per (lane, chunk), whether column tile 0 is
//   nonzero and the range [lo, hi] of nonzero tiles >= 1 among valid
//   pixels. An item loads only the chunks where both its u and v tiles can
//   be nonzero; an item whose segment the band rules out entirely loads
//   nothing and writes a zero partial. The skipped products are exact zeros and the
//   float32 partials are flushed by chunk index (chunk / FLUSH), not by the
//   count of chunks loaded, so the banded mode equals the unbanded mode
//   bitwise at the same launch configuration (for finite inputs);
// * a frozen lane (active == 0) reads nothing and gives zeros.
//
// Alignment: P is a multiple of ROWS and n of TILE; Bf, s, y and w are
// 16-byte aligned (checked by the wrapper), so every cp.async source is.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TILE = 64;       // columns per tile (H tile is TILE x TILE)
constexpr int ROWS = 32;       // pixel rows per chunk (one pipeline stage)
constexpr int FLUSH = 2;       // chunks per float32 partial
constexpr int STAGES = 4;      // cp.async ring depth
constexpr int QUAD = TILE / 2;  // each warp owns a QUAD x QUAD quadrant
constexpr int TM = 8;          // sub-tile rows per thread (from the u tile)
constexpr int TN = 4;          // sub-tile columns per thread (from the v tile)
constexpr int THREADS = 128;   // 4 warps: quadrant (w / 2, w % 2)
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM (bounds the registers)
constexpr int LX = QUAD / TN;  // lanes along a quadrant's columns
constexpr int LY = 32 / LX;    // ... and along its rows, 2 float4s each
constexpr int G_WARP = 2;      // quadrant (1, 0): below a diagonal tile's diagonal
constexpr int MIRROR_WARP = 1; // quadrant (0, 1): its mirror is quadrant (1, 0)
constexpr int TPR = THREADS / ROWS;  // threads per row in the kappa pass
constexpr int RED_THREADS = 256;
constexpr int RED_ROWS = RED_THREADS / TILE;  // tile rows per reduction block

static_assert(TM == 2 * 4 && TN == 4 && LY * 4 * 2 == QUAD, "thread tile");
static_assert(THREADS == 4 * 32 && THREADS % ROWS == 0, "warps and kappa pass");
static_assert(ROWS * (TILE / 4) % THREADS == 0, "copy split");
static_assert(3 * (ROWS / 4) <= THREADS, "s, y, w copies");
static_assert(STAGES == 4, "the ring's wait counts");

struct Stage {
  float a[ROWS][TILE];  // column tile u, scaled by kappa in place
  float b[ROWS][TILE];  // column tile v
  float s[ROWS];
  float y[ROWS];
  float w[ROWS];
  float t1[ROWS];       // term1 of the chunk's rows
};
static_assert(sizeof(Stage) % 16 == 0, "stage alignment");
constexpr int SMEM_BYTES = STAGES * (int)sizeof(Stage);

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

// The upper-triangle tile pair of index `pair`, enumerated row by row.
__device__ __forceinline__ void pair_tiles(int pair, int nt, int& u, int& v) {
  u = 0;
  while (pair >= nt - u) {
    pair -= nt - u;
    ++u;
  }
  v = u + pair;
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
// single tile from b into a), and term1 for g.
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
    x.x *= kap;
    x.y *= kap;
    x.z *= kap;
    x.w *= kap;
    *reinterpret_cast<float4*>(&st.a[r][c4]) = x;
  }
  if (part4 == 0) st.t1[r] = -yy * sig * ww;
}

// One pixel row of a thread's 8 x 4 sub-tile: rows ra + (0..3) and
// ra + QUAD / 2 + (0..3) of the u tile, columns cb + (0..3) of the v tile.
__device__ __forceinline__ void fma_row(const Stage& st, int r, int ra, int cb,
                                        float (&acc)[TM][TN]) {
  const float4 a0 = *reinterpret_cast<const float4*>(&st.a[r][ra]);
  const float4 a1 = *reinterpret_cast<const float4*>(&st.a[r][ra + QUAD / 2]);
  const float4 b4 = *reinterpret_cast<const float4*>(&st.b[r][cb]);
  const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ void flush_all(float (&acc)[TM][TN], double (&tot)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      tot[i][j] += (double)acc[i][j];
      acc[i][j] = 0.f;
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gram_grad_hess_kernel(const float* __restrict__ Bf,
                      const float* __restrict__ s,
                      const float* __restrict__ yv,
                      const float* __restrict__ w,
                      const int* __restrict__ active,
                      const int* __restrict__ band,
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
  const int nt = n / TILE;
  int u, v;
  pair_tiles(pair, nt, u, v);
  const bool diag = (u == v);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // thread (ly, lx) of warp (qr, qc) holds tile rows ra + (0..3) and
  // ra + 16 + (0..3), and columns cb + (0..3): a warp reads 4 neighbouring
  // float4s of the u tile (each a broadcast to 8 lanes) and 8 of the v tile
  const int ra = (warp / 2) * QUAD + (lane / LX) * 4;
  const int cb = (warp % 2) * QUAD + (lane % LX) * 4;
  const bool g_warp = diag && warp == G_WARP;
  // quadrant (0, 1) of a diagonal tile also fills its mirror
  const bool mirror = diag && warp == MIRROR_WARP;

  if (active[b] == 0) return;  // the reduction writes the zeros

  float acc[TM][TN];
  double tot[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      tot[i][j] = 0.0;
    }
  float gacc[2] = {0.f, 0.f};
  double gtot[2] = {0.0, 0.0};

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
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          gtot[k] += (double)gacc[k];
          gacc[k] = 0.f;
        }
      }
      group = c / FLUSH;
    }
    if (g_warp) {
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) {
        gacc[0] = fmaf(st.t1[r], st.b[r][lane], gacc[0]);
        gacc[1] = fmaf(st.t1[r], st.b[r][lane + 32], gacc[1]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) fma_row(st, r, ra, cb, acc);
    }
  }
  cp_async_wait<0>();
  flush_all(acc, tot);
#pragma unroll
  for (int k = 0; k < 2; ++k) gtot[k] += (double)gacc[k];

  double* Pt = part + (((size_t)seg * B + b) * pairs + pair) * (TILE * TILE);
  if (!g_warp) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ra + (i / 4) * (QUAD / 2) + i % 4;
      double2* dst = reinterpret_cast<double2*>(Pt + row * TILE + cb);
      dst[0] = make_double2(tot[i][0], tot[i][1]);
      dst[1] = make_double2(tot[i][2], tot[i][3]);
      if (mirror) {
#pragma unroll
        for (int j = 0; j < TN; ++j) Pt[(cb + j) * TILE + row] = tot[i][j];
      }
    }
  } else {
    double* gpart = part + (size_t)nsegs * B * pairs * (TILE * TILE) +
                    ((size_t)seg * B + b) * n + u * TILE;
    gpart[lane] = gtot[0];
    gpart[lane + 32] = gtot[1];
  }
}

// Sums the segments' float64 partials of one (tile pair, lane) in segment
// order and writes RED_ROWS rows of the tile of H, their mirror and
// (diagonal pairs) g; a frozen lane gets zeros. One thread per entry, the
// segments' loads issued ahead of the (sequential) adds.
__global__ void __launch_bounds__(RED_THREADS)
gram_reduce_kernel(const double* __restrict__ part,
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
  pair_tiles(pair, n / TILE, u, v);
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
  if (u != v) {
    tr[i - row0][j] = x;
    __syncthreads();
    // thread (jj, ii) writes H[v TILE + jj][u TILE + row0 + ii]
    const int ii = tid % RED_ROWS;
    const int jj = tid / RED_ROWS;
    Hb[(size_t)(v * TILE + jj) * n + u * TILE + row0 + ii] = tr[ii][jj];
  } else if (blockIdx.z == 0 && tid < TILE) {
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

// cudaFuncSetAttribute once per device (the ring needs > 48 KB).
constexpr int MAX_DEVICES = 64;
std::atomic<bool> smem_attr_set[MAX_DEVICES];

}  // namespace

extern "C" int sdsm_gram_tile() { return TILE; }
extern "C" int sdsm_gram_rows() { return ROWS; }
extern "C" int sdsm_gram_flush() { return FLUSH; }

// Launches the kernel and the reduction on `stream`; returns
// cudaGetLastError() (0 = launched) or cudaErrorInvalidValue for arguments
// the kernel does not take.
// Bf (B, P, n), s/yv/w (B, P) float32 row-major; active (B,) int32; band
// (B, P / ROWS, 3) int32 or null (dense mode); g (B, n), H (B, n, n)
// float32; part: float64 scratch of nsegs * B * (pairs * TILE^2 + n)
// entries, nsegs = ceil(P / ROWS / seg_chunks).
// Requires n % TILE == 0, P % ROWS == 0, seg_chunks >= P / ROWS or a
// positive multiple of FLUSH, and 16-byte aligned Bf, s, yv, w and part.
extern "C" int sdsm_gram_grad_hess(const float* Bf, const float* s,
                                   const float* yv, const float* w,
                                   const int* active, const int* band,
                                   float* g, float* H, double* part, int B,
                                   int P, int n, int seg_chunks,
                                   void* stream) {
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  if (n % TILE || P % ROWS || P <= 0 || seg_chunks <= 0 || B > 65535 ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nchunks = P / ROWS;
  const int nsegs = (nchunks + seg_chunks - 1) / seg_chunks;
  if (nsegs > 65535 || (nsegs > 1 && seg_chunks % FLUSH))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_attr_set[dev].load()) {
    err = cudaFuncSetAttribute(gram_grad_hess_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_attr_set[dev].store(true);
  }
  const int nt = n / TILE;
  const int pairs = nt * (nt + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  gram_grad_hess_kernel<<<dim3(pairs, nsegs, B), THREADS, SMEM_BYTES, st>>>(
      Bf, s, yv, w, active, band, part, P, n, seg_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_reduce_kernel<<<dim3(pairs, B, TILE / RED_ROWS), RED_THREADS, 0, st>>>(
      part, active, g, H, n, nsegs);
  return (int)cudaGetLastError();
}
