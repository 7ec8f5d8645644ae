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
// _fused_grad_hess_call (full dense gram), _tri_grad_hess_call (upper
// triangle of 128x128 block pairs, lower triangle mirrored) and
// _banded_grad_hess_call (only the column blocks that can be nonzero), with
// fused_grad_hess_batched's dispatch moved to superdsm_tpu_torch/dsm/gram.py.
//
// What bounds it on the card: the gram is P n^2 / 2 fused multiply-adds per
// lane against P n floats read, so it is arithmetic-bound (at n = 512 some
// 256 FLOP per byte of Bf). The precision contract is full float32 (a
// reduced-precision gram stalled the LM solver on the TPU), so the tensor
// cores' TF32/bf16 paths are out and the bound is the FP32 FMA pipe.
//
// Design (first, simple, correct version; no wgmma/TMA yet):
// * one thread block per (lane, pair of TILE-wide column tiles u <= v):
//   H is symmetric, so only the upper-triangle tile pairs are computed and
//   H[v, u] is written as the exact transpose of H[u, v];
// * the block loops over the pixels in ROWS-row chunks staged through shared
//   memory; sigma, kappa and term1 of the chunk are computed in-block from
//   s, y and w, so neither the kappa-scaled copy of Bf nor the weights ever
//   go to device memory;
// * each of the 16 x 16 threads keeps a 4 x 4 sub-tile of H in registers:
//   FP32 FMAs over one chunk, then added to a float64 running sum. The
//   Newton systems reach condition ~1e5 (the quadratic basis columns are
//   nearly collinear over a small region), and a float32 running sum over
//   10^4 pixels drifts too far for them (measured: a cuBLAS float32 gram of
//   the n = 6 systems, 4e-5 relative error, stalled the solver); the
//   float64 adds cost 16 per 512 FMAs. g is accumulated the same way by
//   the diagonal blocks from their unscaled column tile;
// * no atomics, and every output is summed by one thread in pixel order:
//   results are bitwise reproducible run to run;
// * banded mode: `band` gives, per (lane, chunk), whether tile 0 is nonzero
//   and the range [lo, hi] of nonzero tiles >= 1 among valid pixels. A block
//   skips the chunks where its u or v tile is all zero. The skipped products
//   are exact zeros and the order of the remaining ones is unchanged, so the
//   banded mode equals the dense mode bitwise (for finite inputs);
// * a frozen lane (active == 0) reads nothing and writes zeros.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;       // columns per tile (H tile is TILE x TILE)
constexpr int ROWS = 32;       // pixel rows per shared-memory chunk
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
gram_grad_hess_kernel(const float* __restrict__ Bf,
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
  __shared__ float kap[ROWS];
  __shared__ float t1[ROWS];

  const int b = blockIdx.y;
  const int nt = n / TILE;
  // blockIdx.x enumerates the upper-triangle tile pairs row by row
  int pair = blockIdx.x;
  int u = 0;
  while (pair >= nt - u) {
    pair -= nt - u;
    ++u;
  }
  const int v = u + pair;
  const bool diag = (u == v);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // float32 sums within a chunk, float64 running sums across chunks
  double tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.0;
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
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) {
        const float kr = kap[r];
        const float4 a = reinterpret_cast<const float4*>(&As[r][0])[ty];
        const float4 bb = reinterpret_cast<const float4*>(&Bs[r][0])[tx];
        const float av[4] = {a.x * kr, a.y * kr, a.z * kr, a.w * kr};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tot[i][j] += (double)acc[i][j];
      __syncthreads();
    }
  }

  float out[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = (float)tot[i][j];
  float* Hb = H + (size_t)b * n * n;
  const int row0 = u * TILE + ty * 4;
  const int col0 = v * TILE + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(Hb + (size_t)(row0 + i) * n + col0) =
        make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
  }
  if (!diag) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Hb + (size_t)(col0 + j) * n + row0) =
          make_float4(out[0][j], out[1][j], out[2][j], out[3][j]);
    }
  }
  if (diag && tid < TILE) g[(size_t)b * n + u * TILE + tid] = (float)gtot;
}

}  // namespace

extern "C" int sdsm_gram_tile() { return TILE; }
extern "C" int sdsm_gram_rows() { return ROWS; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Bf (B, P, n), s/yv/w (B, P) float32 row-major; active (B,) int32; band
// (B, P / ROWS, 3) int32 or null (dense mode); g (B, n), H (B, n, n) float32.
// Requires n % TILE == 0, P % ROWS == 0 and 16-byte aligned Bf and H.
extern "C" int sdsm_gram_grad_hess(const float* Bf, const float* s,
                                   const float* yv, const float* w,
                                   const int* active, const int* band,
                                   float* g, float* H, int B, int P, int n,
                                   void* stream) {
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const int nt = n / TILE;
  const dim3 grid(nt * (nt + 1) / 2, B);
  gram_grad_hess_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      Bf, s, yv, w, active, band, g, H, P, n);
  return (int)cudaGetLastError();
}
