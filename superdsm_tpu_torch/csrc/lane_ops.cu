// Per-lane products and sums of the batched Newton solver, for NVIDIA
// Hopper (sm_90a), in an order fixed by the length of the reduction alone.
//
// The Newton loop of superdsm_tpu_torch/dsm/solver.py works on a batch of
// lanes (padded problems) at once. Its matrix-vector products (the surface
// s = Bf theta, the line-search direction u = Bf delta, PCG's H p) and its
// sums over a lane's pixels or parameters (energies, line-search and
// scale-sweep candidates, dot products) would otherwise go to cuBLAS and to
// PyTorch's reductions, whose split of a reduction across threads and
// blocks is chosen from the whole launch, batch size included. A lane's
// result would then depend on which lanes share its batch. These kernels
// give every output one order of summation that depends on the reduced
// length only:
//
//   lane_matvec:  out[r, p] = sum_j A[r, p, j] x[r, j]   (A (R, P, n))
//     slot l (l < 32) sums j = l, l + 32, ... in order (float32 FMA), then
//     a fixed tree adds slot l + m into slot l for m = 16, 8, 4, 2, 1.
//     Above SMALL_N columns one warp computes a row (its lanes are the
//     slots, the tree an xor-shuffle); at n <= SMALL_N (the c2f solves'
//     n = 6) one thread computes a whole row, slot by slot in registers,
//     which gives the same bits without 32 - n idle lanes (on an H100 it
//     is 1.7x faster at n <= 7 and 1.1-1.3x slower at n = 31, 32);
//   row_sum:      out[r] = sum_i x[r, i]                 (x (R, L))
//     one block of ROW_THREADS per row: thread t sums i = t, t + ROW_THREADS,
//     ... in order, then a fixed tree in shared memory.
//
// They replace no Pallas kernel: in the JAX package these are XLA's
// products and reductions inside the jitted Newton loop
// (superdsm_tpu/dsm/solver.py, _newton_step and _pcg_solve), whose order
// XLA fixes at compile time for each static shape.
//
// What bounds them on the card: both read each input once and do one FMA
// or add per element read (a quarter of a FLOP per byte), so bytes bound
// them; at the solver's sizes (10^4 to 10^6 elements a launch) launch
// latency dominates, which the CUDA graph of one Newton iteration hides.
// Float32 accumulation, as PyTorch's float32 sums and cuBLAS's sgemv do.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int MATVEC_THREADS = 256;  // 8 output rows a block
constexpr int ROW_THREADS = 256;
constexpr int SMALL_N = 8;          // one thread a row up to this n
constexpr int SMALL_THREADS = 256;  // rows a block at n <= SMALL_N

__global__ void __launch_bounds__(MATVEC_THREADS)
lane_matvec_kernel(const float* __restrict__ A, const float* __restrict__ x,
                   float* __restrict__ out, long long rows, int P, int n) {
  const long long row = (long long)blockIdx.x * (MATVEC_THREADS / WARP) +
                        threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (row >= rows) return;
  const long long r = row / P;
  const float* a = A + row * n;
  const float* xr = x + r * n;
  float acc = 0.0f;
  for (int j = lane; j < n; j += WARP) acc = fmaf(a[j], xr[j], acc);
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) out[row] = acc;
}

// One thread per output row at n <= SMALL_N: slot l holds fmaf(A[l], x[l], 0)
// (0 past n), as lane l of lane_matvec_kernel does, and the tree below adds
// what the xor-shuffle adds, so the two kernels agree bitwise.
__global__ void __launch_bounds__(SMALL_THREADS)
lane_matvec_small_kernel(const float* __restrict__ A,
                         const float* __restrict__ x, float* __restrict__ out,
                         long long rows, int P, int n) {
  const long long row = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (row >= rows) return;
  const float* a = A + row * n;
  const float* xr = x + (row / P) * n;
  float v[WARP];
#pragma unroll
  for (int l = 0; l < WARP; ++l)
    v[l] = l < SMALL_N && l < n ? fmaf(a[l], xr[l], 0.0f) : 0.0f;
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2) {
#pragma unroll
    for (int l = 0; l < m; ++l) v[l] += v[l + m];
  }
  out[row] = v[0];
}

__global__ void __launch_bounds__(ROW_THREADS)
row_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int L) {
  __shared__ float part[ROW_THREADS];
  const float* xr = x + (long long)blockIdx.x * L;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < L; i += ROW_THREADS) acc += xr[i];
  part[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int m = ROW_THREADS / 2; m > 0; m /= 2) {
    if (threadIdx.x < m) part[threadIdx.x] += part[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

}  // namespace

extern "C" int sdsm_lane_warp() { return WARP; }
extern "C" int sdsm_lane_small_n() { return SMALL_N; }
extern "C" int sdsm_lane_row_threads() { return ROW_THREADS; }

// out (R, P) = A (R, P, n) x (R, n), float32 row-major, on `stream`;
// returns cudaGetLastError() (0 = launched). warp_rows != 0 takes the
// warp-per-row kernel at every n (to hold the two kernels against each
// other).
extern "C" int sdsm_lane_matvec(const float* A, const float* x, float* out,
                                int R, int P, int n, int warp_rows,
                                void* stream) {
  if (R < 0 || P < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)R * P;
  if (rows == 0) return (int)cudaGetLastError();
  if (n <= SMALL_N && !warp_rows) {
    const long long blocks = (rows + SMALL_THREADS - 1) / SMALL_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    lane_matvec_small_kernel<<<(unsigned)blocks, SMALL_THREADS, 0,
                               (cudaStream_t)stream>>>(A, x, out, rows, P, n);
    return (int)cudaGetLastError();
  }
  const int per_block = MATVEC_THREADS / WARP;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_matvec_kernel<<<(unsigned)blocks, MATVEC_THREADS, 0,
                       (cudaStream_t)stream>>>(A, x, out, rows, P, n);
  return (int)cudaGetLastError();
}

// out (R,) = the row sums of x (R, L), float32 row-major, on `stream`.
extern "C" int sdsm_lane_row_sum(const float* x, float* out, int R, int L,
                                 void* stream) {
  if (R < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  row_sum_kernel<<<R, ROW_THREADS, 0, (cudaStream_t)stream>>>(x, out, L);
  return (int)cudaGetLastError();
}
