// Reduced-precision Newton gram on the tensor cores, for NVIDIA Hopper
// (sm_90a): the same fused logistic gradient and Gauss-Newton Hessian as
// gram_grad_hess.cu,
//   t = y s,  sig = sigmoid(-t),
//   term1 = -y sig w,  kappa = w y^2 sig (1 - sig),
//   g = Bf^T term1                    (n,)   full float32 products
//   H = Bf^T diag(kappa) Bf           (n, n) bf16 operands, see below
// with the H product's operands rounded to bf16 as the JAX package's
// reduced-precision gram dots do (superdsm_tpu/dsm/pallas_kernels.py):
// a = Bf kappa (float32), b = Bf, and
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
// mode) against P n floats read. bf16 mma.sync (m16n8k16, float32
// accumulate) takes the products off the FP32 pipe; in this first version
// the per-chunk work of staging, kappa and the hi/lo split in shared memory
// and the float64 running sums are the bound, not the tensor cores.
//
// Shared with the float32 kernel, so that the knob changes only the
// operand precision: one thread block per (lane, tile pair); pixels in
// ROWS-row chunks staged through shared memory; kappa and term1 computed in
// the block; per-chunk float32 partials added into float64 running sums;
// g from the diagonal blocks' unscaled tile in float32 FMAs (bitwise the
// float32 kernel's g); no atomics (bitwise reproducible); a frozen lane
// (active == 0) reads nothing and writes zeros. Skipped band chunks add
// exact zeros, so the banded mode equals the triangle mode bitwise.
//
// Tensor-core layout: the contraction axis is the pixel axis. The chunk's
// operands are stored column-major (column, pixel) in shared memory, so
// each mma fragment register is one 32-bit load of two consecutive pixels.
// The 8 warps split the 64 x 64 tile into 4 row groups of 16 and 2 column
// groups of 32 (4 n8 tiles each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // columns per tile (H tile is TILE x TILE)
constexpr int ROWS = 32;       // pixel rows per shared-memory chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int BLOCK = 128;     // mirror granularity of triangle/banded mode
constexpr int KPAD = ROWS + 8; // padded pixel stride of the bf16 operands

enum Mode { FULL = 0, TRIANGLE = 1, BANDED = 2 };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Splits two float32 values into their bf16 hi and lo parts (RNE); the
// subtraction is exact in float32 and never fused with a product.
__device__ __forceinline__ void split2(float x0, float x1, __nv_bfloat162* hi,
                                       __nv_bfloat162* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *hi = h;
  *lo = __floats2bfloat162_rn(__fsub_rn(x0, __low2float(h)),
                              __fsub_rn(x1, __high2float(h)));
}

template <int PASSES, bool FULL_MODE>
__global__ void __launch_bounds__(THREADS)
gram_grad_hess_bf16_kernel(const float* __restrict__ Bf,
                           const float* __restrict__ s,
                           const float* __restrict__ yv,
                           const float* __restrict__ w,
                           const int* __restrict__ active,
                           const int* __restrict__ band,
                           float* __restrict__ g,
                           float* __restrict__ H,
                           int P, int n) {
  __shared__ __align__(16) float As[ROWS][TILE];
  __shared__ __align__(16) float Bs[ROWS][TILE];
  __shared__ __align__(16) __nv_bfloat16 Ahi[TILE][KPAD];
  __shared__ __align__(16) __nv_bfloat16 Bhi[TILE][KPAD];
  __shared__ __align__(16) __nv_bfloat16 Alo[PASSES == 3 ? TILE : 1][KPAD];
  __shared__ __align__(16) __nv_bfloat16 Blo[PASSES == 3 ? TILE : 1][KPAD];
  __shared__ float kap[ROWS];
  __shared__ float t1[ROWS];

  const int b = blockIdx.y;
  const int nt = n / TILE;
  int u, v;
  if (FULL_MODE) {
    u = blockIdx.x / nt;
    v = blockIdx.x % nt;
  } else {
    // blockIdx.x enumerates the upper-triangle 128-block pairs (U <= V) row
    // by row, four 64-column tile pairs each
    constexpr int SUB = BLOCK / TILE;
    const int nb = n / BLOCK;
    int pair = blockIdx.x / (SUB * SUB);
    const int sub = blockIdx.x % (SUB * SUB);
    int U = 0;
    while (pair >= nb - U) {
      pair -= nb - U;
      ++U;
    }
    const int V = U + pair;
    u = U * SUB + sub / SUB;
    v = V * SUB + sub % SUB;
  }
  const bool diag = (u == v);
  const bool mirror = !FULL_MODE && (u / (BLOCK / TILE) != v / (BLOCK / TILE));
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gid = lane / 4;       // mma group id
  const int tig = lane % 4;       // thread in group
  const int mrow = (warp / 2) * 16;   // this warp's 16 H rows in the tile
  const int ncol = (warp % 2) * 32;   // and its 32 H columns

  double tot[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[j][i] = 0.0;
  double gtot = 0.0;

  if (active[b] != 0) {
    const float* Bfb = Bf + (size_t)b * P * n;
    const float* sb = s + (size_t)b * P;
    const float* yb = yv + (size_t)b * P;
    const float* wb = w + (size_t)b * P;
    const int nchunks = P / ROWS;
    for (int c = 0; c < nchunks; ++c) {
      if (band != nullptr) {
        const int* bc = band + ((size_t)b * nchunks + c) * 3;
        const bool in_u = (u == 0) ? (bc[0] != 0) : (bc[1] <= u && u <= bc[2]);
        const bool in_v = (v == 0) ? (bc[0] != 0) : (bc[1] <= v && v <= bc[2]);
        if (!(in_u && in_v)) continue;  // uniform across the block
      }
      const int p0 = c * ROWS;
      if (tid < ROWS) {
        const float yy = yb[p0 + tid];
        const float ww = wb[p0 + tid];
        const float t = yy * sb[p0 + tid];
        const float sig = 1.f / (1.f + expf(t));  // sigmoid(-t)
        t1[tid] = -yy * sig * ww;
        kap[tid] = ww * yy * yy * sig * (1.f - sig);
      }
      for (int k = tid; k < ROWS * (TILE / 4); k += THREADS) {
        const int r = k / (TILE / 4);
        const int c4 = k % (TILE / 4);
        const float4* row =
            reinterpret_cast<const float4*>(Bfb + (size_t)(p0 + r) * n);
        reinterpret_cast<float4*>(&As[r][0])[c4] = row[u * (TILE / 4) + c4];
        reinterpret_cast<float4*>(&Bs[r][0])[c4] = row[v * (TILE / 4) + c4];
      }
      __syncthreads();
      if (diag && tid < TILE) {
        float gacc = 0.f;
#pragma unroll 8
        for (int r = 0; r < ROWS; ++r) gacc = fmaf(t1[r], Bs[r][tid], gacc);
        gtot += (double)gacc;
      }
      // bf16 operands, column-major: a = Bf_u kappa (rounded to float32
      // first, as on the TPU), b = Bf_v
      for (int k = tid; k < TILE * (ROWS / 2); k += THREADS) {
        const int m = k % TILE;
        const int r = 2 * (k / TILE);
        const float a0 = __fmul_rn(As[r][m], kap[r]);
        const float a1 = __fmul_rn(As[r + 1][m], kap[r + 1]);
        const float b0 = Bs[r][m];
        const float b1 = Bs[r + 1][m];
        __nv_bfloat162* ah = reinterpret_cast<__nv_bfloat162*>(&Ahi[m][r]);
        __nv_bfloat162* bh = reinterpret_cast<__nv_bfloat162*>(&Bhi[m][r]);
        if (PASSES == 3) {
          split2(a0, a1, ah, reinterpret_cast<__nv_bfloat162*>(&Alo[m][r]));
          split2(b0, b1, bh, reinterpret_cast<__nv_bfloat162*>(&Blo[m][r]));
        } else {
          *ah = __floats2bfloat162_rn(a0, a1);
          *bh = __floats2bfloat162_rn(b0, b1);
        }
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < ROWS; k0 += 16) {
        uint32_t ahi[4], alo[4];
        const int ar = mrow + gid;
        const int ak = k0 + 2 * tig;
        ahi[0] = ld32(&Ahi[ar][ak]);
        ahi[1] = ld32(&Ahi[ar + 8][ak]);
        ahi[2] = ld32(&Ahi[ar][ak + 8]);
        ahi[3] = ld32(&Ahi[ar + 8][ak + 8]);
        if (PASSES == 3) {
          alo[0] = ld32(&Alo[ar][ak]);
          alo[1] = ld32(&Alo[ar + 8][ak]);
          alo[2] = ld32(&Alo[ar][ak + 8]);
          alo[3] = ld32(&Alo[ar + 8][ak + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bn = ncol + j * 8 + gid;
          uint32_t bhi[2], blo[2];
          bhi[0] = ld32(&Bhi[bn][ak]);
          bhi[1] = ld32(&Bhi[bn][ak + 8]);
          mma_bf16(acc[j], ahi, bhi);
          if (PASSES == 3) {
            blo[0] = ld32(&Blo[bn][ak]);
            blo[1] = ld32(&Blo[bn][ak + 8]);
            mma_bf16(acc[j], ahi, blo);
            mma_bf16(acc[j], alo, bhi);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[j][i] += (double)acc[j][i];
      __syncthreads();
    }
  }

  // accumulator element i of n8 tile j: row gid (+8 for i >= 2), column
  // 2 tig + (i & 1)
  float* Hb = H + (size_t)b * n * n;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = u * TILE + mrow + gid + 8 * half;
      const int col = v * TILE + ncol + j * 8 + 2 * tig;
      const float x0 = (float)tot[j][2 * half];
      const float x1 = (float)tot[j][2 * half + 1];
      *reinterpret_cast<float2*>(Hb + (size_t)row * n + col) = make_float2(x0, x1);
      if (mirror) {
        Hb[(size_t)col * n + row] = x0;
        Hb[(size_t)(col + 1) * n + row] = x1;
      }
    }
  }
  if (diag && tid < TILE) g[(size_t)b * n + u * TILE + tid] = (float)gtot;
}

template <int PASSES, bool FULL_MODE>
void launch(const float* Bf, const float* s, const float* yv, const float* w,
            const int* active, const int* band, float* g, float* H, int B,
            int P, int n, cudaStream_t stream) {
  const int nt = n / TILE;
  const int nb = n / BLOCK;
  const int pairs = FULL_MODE ? nt * nt
                              : nb * (nb + 1) / 2 * (BLOCK / TILE) * (BLOCK / TILE);
  const dim3 grid(pairs, B);
  gram_grad_hess_bf16_kernel<PASSES, FULL_MODE><<<grid, THREADS, 0, stream>>>(
      Bf, s, yv, w, active, band, g, H, P, n);
}

}  // namespace

extern "C" int sdsm_gram_bf16_tile() { return TILE; }
extern "C" int sdsm_gram_bf16_rows() { return ROWS; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched)
// or cudaErrorInvalidValue for arguments it does not take.
// Bf (B, P, n), s/yv/w (B, P) float32 row-major; active (B,) int32; band
// (B, P / ROWS, 3) int32, given exactly in banded mode; g (B, n), H (B, n, n)
// float32. passes in {1, 3}; mode 0 full, 1 triangle, 2 banded. Requires
// P % ROWS == 0, n % TILE == 0 (n % 128 == 0 outside full mode) and
// 16-byte aligned Bf and H.
extern "C" int sdsm_gram_bf16_grad_hess(const float* Bf, const float* s,
                                        const float* yv, const float* w,
                                        const int* active, const int* band,
                                        float* g, float* H, int B, int P,
                                        int n, int passes, int mode,
                                        void* stream) {
  if ((passes != 1 && passes != 3) || mode < FULL || mode > BANDED ||
      (band != nullptr) != (mode == BANDED) || P % ROWS != 0 ||
      n % (mode == FULL ? TILE : BLOCK) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool full = (mode == FULL);
  if (passes == 3) {
    if (full) launch<3, true>(Bf, s, yv, w, active, band, g, H, B, P, n, st);
    else launch<3, false>(Bf, s, yv, w, active, band, g, H, B, P, n, st);
  } else {
    if (full) launch<1, true>(Bf, s, yv, w, active, band, g, H, B, P, n, st);
    else launch<1, false>(Bf, s, yv, w, active, band, g, H, B, P, n, st);
  }
  return (int)cudaGetLastError();
}
