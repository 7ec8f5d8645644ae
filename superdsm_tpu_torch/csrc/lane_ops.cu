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
//     Above ROW_N = 32 columns one warp computes a row (its lanes are the
//     slots, the tree an xor-shuffle); at n <= 32 (the c2f solves' n = 6,
//     the smallest DSM bucket's n = 32) each slot holds one product, and
//     one thread computes a whole row, slot by slot in registers, which
//     gives the same bits without 32 - n idle lanes and 5 shuffles a row.
//     A block of that kernel first copies its 256 rows (256 n floats,
//     contiguous) into shared memory with 16-byte loads, then each thread
//     reads its row from there: a thread's own 4n-byte row read with n
//     scalar loads would leave the warp's loads strided.
//   lane sums:    out[o, k] = sum_i term(o, k, i)       (i < L)
//     slot t of ROW_THREADS = 256 adds term(t), term(t + 256), ... in turn
//     from 0, then a fixed tree adds slot t + m into slot t for m = 128,
//     64, ..., 1 (lane.lane_sum_in_kernel_order replays it on the host).
//     The term is an element of a strided tensor (lane_sum: (O, L, S) with
//     any strides, so the solver's (B, K, S) regularizer terms are summed in
//     place with no transposed copy), a product a_i b_i (lane_dot), or a softplus
//     energy term built in registers from the solver's own inputs
//     (softplus_energies), each intermediate rounded as PyTorch's op-by-op
//     expression rounds it: __fmul_rn / __fadd_rn, no FMA contraction, and
//     logaddexp(x, 0) written as ATen's CUDA kernel writes it.
//
// Layout of a lane sum. A slot's chain is the only sequential part of the
// order, so each thread loads UNROLL terms of its chain ahead into
// registers (memory-level parallelism) and then adds them in order; the
// tree runs in one warp per output: slots t + 128, t + 64, t + 32 are
// registers gathered from shared memory, m = 16 .. 1 shuffles. A plain sum
// (strided elements, products) takes one block per output (o, k), which
// holds its 256 slots: the solver's plain sums are short (PCG's and the
// step guard's dot products, the regularizer's (B, K, S) sums, traces).
// The softplus sums are long ((B, P) over P at up to 32768 pixels) and
// their terms cost some 60 instructions each: all of a block's threads
// build the terms (lane_softplus_kernel), and a cluster of CLUSTER = 8
// blocks holds the 256 slots of up to SLOTS_K outputs of one lane, block
// rank q slots 32 q .. 32 q + 31, whose tree gathers them over the
// cluster's distributed shared memory (the same order, so the same bits).
//
// They replace no Pallas kernel: in the JAX package these are XLA's
// products and reductions inside the jitted Newton loop
// (superdsm_tpu/dsm/solver.py, _newton_step and _pcg_solve), whose order
// XLA fixes at compile time for each static shape; there the line search's
// softplus terms and their sum are one XLA fusion (solver.py:217), as they
// are one kernel here.
//
// What bounds them on the card: the products and plain sums read each input
// once and do one FMA or add per element read, so bytes bound them; the
// softplus sums read four floats per pixel for S candidates, each a
// logaddexp whose accurate expf and log1pf take tens of instructions, so
// at S = 12 instruction issue bounds them, well before the bytes do (their
// terms are built by every thread of a block, not by the 256 slots
// alone). At the solver's sizes (10^4 to 10^6 elements a
// launch) launch latency dominates, which the CUDA graph of one Newton
// iteration hides; a B = 1 sum stays latency-bound under its fixed order
// (128 dependent adds a slot at 32768 pixels), and so do PCG's products at
// B = 1, 2 (n = 512: 16 dependent FMAs a slot).
// Float32 accumulation, as PyTorch's float32 sums and cuBLAS's sgemv do.
// Built without --use_fast_math: expf and log1pf must be the accurate ones
// that ATen's logaddexp calls.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int MATVEC_THREADS = 256;  // 8 output rows a block (n > ROW_N)
constexpr int ROW_THREADS = 256;     // slots of a lane sum
constexpr int CLUSTER = 8;           // blocks of one softplus sum
constexpr int SLOT_BLOCK = ROW_THREADS / CLUSTER;  // slots a block, 32
constexpr int SLOTS_K = 16;          // outputs of a softplus sum's cluster
constexpr int TERM_THREADS = 1024;   // threads of a softplus sum's block
constexpr int TERMS_A_THREAD = 4;    // terms a thread builds per group
constexpr int RESIDENT_BLOCKS = 2;   // softplus blocks an SM holds
constexpr int SMALL_N = 8;          // one thread a row up to this n ...
constexpr int ROW_N = 32;           // ... and, with a full tree, up to this
constexpr int SMALL_THREADS = 256;  // rows a block at n <= ROW_N

static_assert(SLOT_BLOCK == WARP, "a block's slots are one warp wide");

// A warp per output row (n > ROW_N): lane l sums j = l, l + 32, ... with
// fmaf, then the xor-shuffle tree. (Rows per warp and loads issued ahead
// measured slower at the table shapes on an H100; at PCG's (B, 512, 512)
// it ties torch.bmm, both latency-bound.)
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

// v[l] += v[l + m] for l < m, m = M, M / 2, ..., 1; returns v[0].
template <int M, int N>
__device__ __forceinline__ float pair_tree(float (&v)[N]) {
#pragma unroll
  for (int l = 0; l < M; ++l) v[l] = __fadd_rn(v[l], v[l + M]);
  if constexpr (M > 1) return pair_tree<M / 2>(v);
  else return v[0];
}

// One thread per output row at n <= NS (SMALL_N or ROW_N): slot l holds
// fmaf(A[l], x[l], 0) (0 past n), as lane l of lane_matvec_kernel does, and
// the tree below adds what the xor-shuffle adds (slot l + m into slot l), so
// the two kernels agree bitwise. At NS = SMALL_N the tree's steps m = 16
// and 8 add slots that hold 0 (n <= 8), which turns a -0 (an underflowed
// product) into +0 once: one add of 0 stands for both.
// The block's 256 rows (256 n floats, contiguous) are staged in shared
// memory first, with 16-byte loads when A is 16-byte aligned (a full
// block's rows start at a multiple of 1024 n bytes), at a row pitch of
// n | 1 floats so that a warp's threads read their rows from distinct
// banks. Rows of a block lie in one lane when P is a multiple of 256: its
// lane is computed once; else each thread divides in 32 bits (rows < 2^31).
template <int NS>
__global__ void __launch_bounds__(SMALL_THREADS)
lane_matvec_row_kernel(const float* __restrict__ A, const float* __restrict__ x,
                       float* __restrict__ out, int rows, int P, int n,
                       int vec) {
  __shared__ float tile[SMALL_THREADS * (NS + 1)];
  const int row0 = blockIdx.x * SMALL_THREADS;
  const int nrows = min(SMALL_THREADS, rows - row0);
  const float* a0 = A + (long long)row0 * n;
  const int count = nrows * n;
  const int pitch = n | 1;
  if (vec && nrows == SMALL_THREADS) {
    const float4* src = reinterpret_cast<const float4*>(a0);
#pragma unroll 4
    for (int i = threadIdx.x; i < count / 4; i += SMALL_THREADS) {
      const float4 q = __ldg(src + i);
      int r = 4 * i / n, c = 4 * i - r * n;
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        tile[r * pitch + c] = e[h];
        if (++c == n) { c = 0; ++r; }
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < count; i += SMALL_THREADS) {
      const int r = i / n;
      tile[r * pitch + i - r * n] = __ldg(a0 + i);
    }
  }
  __syncthreads();
  if ((int)threadIdx.x >= nrows) return;
  const int row = row0 + threadIdx.x;
  const unsigned r = P % SMALL_THREADS == 0 ? (unsigned)row0 / (unsigned)P
                                            : (unsigned)row / (unsigned)P;
  const float* a = tile + threadIdx.x * pitch;
  const float* xr = x + (long long)r * n;
  float v[NS];
#pragma unroll
  for (int l = 0; l < NS; ++l)
    v[l] = l < n ? fmaf(a[l], __ldg(xr + l), 0.0f) : 0.0f;
  if (NS == SMALL_N) {
#pragma unroll
    for (int l = 0; l < NS; ++l) v[l] = __fadd_rn(v[l], 0.0f);
  }
  out[row] = pair_tree<NS / 2>(v);
}

// logaddexp(a, 0) as ATen's CUDA float32 logaddexp computes it
// (aten/src/ATen/native/cuda/LogAddExpKernel.cu: opmath float, the same
// expression), so that a softplus term built here has the bits of
// torch.logaddexp(x, zeros(())) on the card; chip_smoke.py checks that over
// all 2^32 float32 bit patterns.
__device__ __forceinline__ float logaddexp0(float a) {
  const float b = 0.0f;
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);  // ATen's ::max(float, float)
  return m + log1pf(expf(-fabsf(a - b)));
}

// The terms of a lane sum: term(o, k, i) for lane (outer index) o, output k
// of the lane and reduced index i.
struct StridedTerm {  // x[o sO + i sL + k sS]
  const float* __restrict__ x;
  long long sO, sL, sS;
  __device__ __forceinline__ float operator()(long long o, int k, int i) const {
    return __ldg(x + o * sO + (long long)i * sL + (long long)k * sS);
  }
};

struct DotTerm {  // a[o, i] * b[o, i], (O, L) contiguous
  const float* __restrict__ a;
  const float* __restrict__ b;
  int L;
  __device__ __forceinline__ float operator()(long long o, int, int i) const {
    const long long j = o * L + i;
    return __fmul_rn(__ldg(a + j), __ldg(b + j));
  }
};

enum SoftplusMode { LINE_SEARCH = 0, SCALE_SWEEP = 1, SINGLE = 2 };

// w * softplus(x) with x, per mode (s, u, y, w (O, L) contiguous, c (S,)):
//   LINE_SEARCH  -(y * (s + u * c[k]))   solver.py's line search
//   SCALE_SWEEP  (-(y * s)) * c[k]       its scale sweep
//   SINGLE       -(y * s)                one energy
template <int MODE>
struct SoftplusTerm {
  const float* __restrict__ s;
  const float* __restrict__ u;
  const float* __restrict__ y;
  const float* __restrict__ w;
  const float* __restrict__ c;
  int L;
  __device__ __forceinline__ float operator()(long long o, int k, int i) const {
    const long long j = o * L + i;
    const float sv = __ldg(s + j), yv = __ldg(y + j), wv = __ldg(w + j);
    float t;
    if (MODE == LINE_SEARCH)
      t = -__fmul_rn(yv, __fadd_rn(sv, __fmul_rn(__ldg(u + j), __ldg(c + k))));
    else if (MODE == SCALE_SWEEP)
      t = __fmul_rn(-__fmul_rn(yv, sv), __ldg(c + k));
    else
      t = -__fmul_rn(yv, sv);
    return __fmul_rn(wv, logaddexp0(t));
  }
};

// Slot t's chain of output (o, k): term(t) + term(t + 256) + ... in turn
// from 0, UNROLL terms loaded ahead into registers before they are added.
template <int UNROLL, class Term>
__device__ __forceinline__ float slot_chain(const Term& term, long long o,
                                            int k, int t, int L) {
  const int chain = (L + ROW_THREADS - 1) / ROW_THREADS;
  float acc = 0.0f;
  for (int c0 = 0; c0 < chain; c0 += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int e = 0; e < UNROLL; ++e) {
      const int i = (c0 + e) * ROW_THREADS + t;
      v[e] = i < L ? term(o, k, i) : 0.0f;  // + 0 leaves acc (never -0)
    }
#pragma unroll
    for (int e = 0; e < UNROLL; ++e) acc = __fadd_rn(acc, v[e]);
  }
  return acc;
}

// The tree of one output over the cluster: v[r] holds slot 32 r + l (l the
// warp lane) after the chains; adds slot t + 128, + 64, + 32 (v) and then
// t + 16, ..., t + 1 (shuffles); lane 0 returns the sum.
__device__ __forceinline__ float slot_tree(float (&v)[CLUSTER]) {
#pragma unroll
  for (int m = CLUSTER / 2; m > 0; m /= 2) {
#pragma unroll
    for (int r = 0; r < m; ++r) v[r] = __fadd_rn(v[r], v[r + m]);
  }
  float acc = v[0];
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, m));
  return acc;
}

// The cluster's trees: after the chains each block holds part[tl * kb + kl]
// (slot 32 q + tl of its output kl, q its rank); warp w of rank q runs the
// tree of output w * CLUSTER + q over the ranks' shared memory.
__device__ __forceinline__ void cluster_trees(cg::cluster_group& cluster,
                                              const float* part, int kb,
                                              int kn, float* out) {
  cluster.sync();
  const int kt = threadIdx.x / WARP * CLUSTER + (int)cluster.block_rank();
  const int l = threadIdx.x % WARP;
  if (kt < kn) {
    float v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r)
      v[r] = cluster.map_shared_rank(part, r)[l * kb + kt];
    const float acc = slot_tree(v);
    if (l == 0) out[kt] = acc;
  }
  cluster.sync();  // no block leaves while its slots are read
}

// A lane sum in one block per output (o, k): thread t runs slot t's chain,
// and warp 0 runs the tree over the block's shared memory.
template <class Term, int UNROLL>
__global__ void __launch_bounds__(ROW_THREADS)
lane_sum_block_kernel(Term term, float* __restrict__ out, int L, int S) {
  __shared__ float part[ROW_THREADS];
  const long long o = blockIdx.x / S;
  const int k = blockIdx.x % S;
  const int t = threadIdx.x;
  part[t] = slot_chain<UNROLL>(term, o, k, t, L);
  __syncthreads();
  if (t < WARP) {
    float v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v[r] = part[r * WARP + t];
    const float acc = slot_tree(v);
    if (t == 0) out[o * S + k] = acc;
  }
}

// A softplus lane sum: its terms cost some 60 instructions each, more than
// a slot's chain can hide, so the block's threads build them for every
// slot and the slots only add. Per group of G chain steps each of the
// block's R threads of a (slot, output) pair builds TERMS_A_THREAD terms
// into shared memory (double-buffered: the next group's terms are built
// while the slots add this group's, in order), then the SLOT_BLOCK * kb
// slot threads add their G terms in turn. Thread j builds pair j % pairs,
// a warp per output (pixels neighbouring). Grid: CLUSTER blocks (one
// cluster) per (lane o, tile of up to SLOTS_K outputs).
template <int MODE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(TERM_THREADS)
lane_softplus_kernel(SoftplusTerm<MODE> term, float* __restrict__ out, int L,
                     int S, int kb, int k_tiles) {
  __shared__ float buf[2][TERM_THREADS * TERMS_A_THREAD];
  __shared__ float part[SLOT_BLOCK * SLOTS_K];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const long long tile = blockIdx.x / CLUSTER;
  const long long o = tile / k_tiles;
  const int k0 = (int)(tile % k_tiles) * kb;
  const int kn = min(kb, S - k0);
  const int pairs = SLOT_BLOCK * kb;
  const int R = blockDim.x / pairs;  // threads building one pair's terms
  const int G = R * TERMS_A_THREAD;          // chain steps a group
  const int j = threadIdx.x;
  const int pj = j % pairs, g0 = j / pairs;  // j < R * pairs (= blockDim.x)
  const int tl = pj % SLOT_BLOCK, kl = pj / SLOT_BLOCK;
  const int t = q * SLOT_BLOCK + tl;
  const bool live = kl < kn;
  const int chain = (L + ROW_THREADS - 1) / ROW_THREADS;
  const int groups = (chain + G - 1) / G;
  auto build = [&](int group, float* dst) {
    float v[TERMS_A_THREAD];
#pragma unroll
    for (int e = 0; e < TERMS_A_THREAD; ++e) {
      const int i = (group * G + g0 + e * R) * ROW_THREADS + t;
      v[e] = live && i < L ? term(o, k0 + kl, i) : 0.0f;  // + 0 leaves acc
    }
#pragma unroll
    for (int e = 0; e < TERMS_A_THREAD; ++e)
      dst[(g0 + e * R) * pairs + pj] = v[e];
  };
  build(0, buf[0]);
  __syncthreads();
  float acc = 0.0f;
  for (int group = 0; group < groups; ++group) {
    if (group + 1 < groups) build(group + 1, buf[(group + 1) & 1]);
    if (j < pairs) {
      const float* b = buf[group & 1] + pj;
      for (int g = 0; g < G; ++g) acc = __fadd_rn(acc, b[g * pairs]);
    }
    __syncthreads();
  }
  if (j < pairs && live) part[tl * kb + kl] = acc;
  cluster_trees(cluster, part, kb, kn, out + o * S + k0);
}

// logaddexp(x, 0) elementwise (the device function the softplus sums use),
// to hold it bitwise against ATen's kernel.
__global__ void softplus_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = logaddexp0(x[i]);
}

template <class Term, int UNROLL>
int launch_sum(const Term& term, float* out, long long O, int L, int S,
               cudaStream_t stream) {
  if (O < 0 || L < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (O == 0 || S == 0) return (int)cudaGetLastError();
  const long long blocks = O * S;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_sum_block_kernel<Term, UNROLL><<<(unsigned)blocks, ROW_THREADS, 0,
                                        stream>>>(term, out, L, S);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && n > 0)
      count = n;
    else
      return 132;
  }
  return count;
}

// The outputs of a lane go into k tiles until the grid would pass what the
// card holds at once (RESIDENT_BLOCKS an SM): more threads for few lanes.
template <int MODE>
int launch_softplus(const SoftplusTerm<MODE>& term, float* out, long long O,
                    int L, int S, cudaStream_t stream) {
  if (O < 0 || L < 0 || S < 1 || S > SLOTS_K) return (int)cudaErrorInvalidValue;
  if (O == 0) return (int)cudaGetLastError();
  const long long resident = (long long)RESIDENT_BLOCKS * sm_count();
  int k_tiles = 1;
  while (k_tiles < S && O * (k_tiles + 1) * CLUSTER <= resident) ++k_tiles;
  const int kb = (S + k_tiles - 1) / k_tiles;
  k_tiles = (S + kb - 1) / kb;
  const int pairs = SLOT_BLOCK * kb;
  const int threads = TERM_THREADS / pairs * pairs;
  const long long blocks = O * k_tiles * CLUSTER;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_softplus_kernel<MODE><<<(unsigned)blocks, threads, 0, stream>>>(
      term, out, L, S, kb, k_tiles);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= ROW_N && !warp_rows) {
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int blocks = (int)((rows + SMALL_THREADS - 1) / SMALL_THREADS);
    const int vec = ((unsigned long long)A % 16) == 0;
    if (n <= SMALL_N)
      lane_matvec_row_kernel<SMALL_N><<<blocks, SMALL_THREADS, 0, st>>>(
          A, x, out, (int)rows, P, n, vec);
    else
      lane_matvec_row_kernel<ROW_N><<<blocks, SMALL_THREADS, 0, st>>>(
          A, x, out, (int)rows, P, n, vec);
    return (int)cudaGetLastError();
  }
  const int per_block = MATVEC_THREADS / WARP;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_matvec_kernel<<<(unsigned)blocks, MATVEC_THREADS, 0, st>>>(A, x, out,
                                                                 rows, P, n);
  return (int)cudaGetLastError();
}

// out (O, S) = x summed over its middle axis, x (O, L, S) float32 with
// element strides (sO, sL, sS), on `stream`.
extern "C" int sdsm_lane_strided_sum(const float* x, float* out, int O, int L,
                                     int S, int sO, int sL, int sS,
                                     void* stream) {
  const StridedTerm term{x, sO, sL, sS};
  return launch_sum<StridedTerm, 16>(term, out, O, L, S,
                                     (cudaStream_t)stream);
}

// out (O,) = sum_i a[o, i] b[o, i], a and b (O, L) float32 contiguous.
extern "C" int sdsm_lane_dot(const float* a, const float* b, float* out, int O,
                             int L, void* stream) {
  const DotTerm term{a, b, L};
  return launch_sum<DotTerm, 16>(term, out, O, L, 1, (cudaStream_t)stream);
}

// out (O, S) = sum_p w softplus-term (see SoftplusTerm), s, u, y, w (O, L)
// float32 contiguous, c (S,), S <= 16; mode 0 line search, 1 scale sweep,
// 2 one energy (S = 1; u and c unused).
extern "C" int sdsm_lane_softplus_energies(const float* s, const float* u,
                                           const float* y, const float* w,
                                           const float* c, float* out, int O,
                                           int L, int S, int mode,
                                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case LINE_SEARCH:
      return launch_softplus<LINE_SEARCH>({s, u, y, w, c, L}, out, O, L, S, st);
    case SCALE_SWEEP:
      return launch_softplus<SCALE_SWEEP>({s, u, y, w, c, L}, out, O, L, S, st);
    case SINGLE:
      if (S != 1) return (int)cudaErrorInvalidValue;
      return launch_softplus<SINGLE>({s, u, y, w, c, L}, out, O, L, 1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out[i] = logaddexp(x[i], 0), count elements.
extern "C" int sdsm_lane_softplus(const float* x, float* out, int count,
                                  void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaGetLastError();
  softplus_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, out, count);
  return (int)cudaGetLastError();
}
