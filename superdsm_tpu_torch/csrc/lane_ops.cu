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
//   lane_pcg:     the whole Jacobi-preconditioned CG of solver._pcg_solve
//     for every lane of a batch in one launch, bitwise the chain of
//     lane_matvec, lane_dot and elementwise ATen ops that it replaces (see
//     the comment above lane_pcg_kernel).
//   lane_cholesky: the Newton direction -Hd^-1 g by Cholesky
//     (solver._cholesky_direction) for every lane of a batch in one
//     launch, one block a lane, in an order fixed by n alone (see the
//     comment above lane_cholesky_kernel).
//
// They replace no Pallas kernel: in the JAX package these are XLA's
// products and reductions inside the jitted Newton loop
// (superdsm_tpu/dsm/solver.py, _newton_step and _pcg_solve), whose order
// XLA fixes at compile time for each static shape; there the line search's
// softplus terms and their sum are one XLA fusion (solver.py:217), as they
// are one kernel here, PCG is one while_loop (solver.py:126), as it is
// one kernel here, and the Cholesky direction is cho_factor / cho_solve
// (solver.py:201-205), one kernel here.
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
// (128 dependent adds a slot at 32768 pixels), and so does lane_pcg (see
// there).
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
constexpr int PCG_CLUSTER = 8;      // blocks of one lane's PCG
constexpr int PCG_THREADS = ROW_THREADS;  // thread t is slot t of every dot
constexpr int PCG_WARPS = PCG_THREADS / WARP;
constexpr int PCG_GROUP = 4;        // rows a warp of lane_pcg computes at once
constexpr int CHOL_MAX_THREADS = 512;  // threads of a lane_cholesky block
constexpr int CHOL_COLS = 8;            // columns a warp of it updates at once
constexpr int CHOL_BACK = 4;            // rows a lane of its back substitution updates at once
constexpr int CHOL_SMEM_BYTES = 232448;  // shared memory a block may opt in to (sm_90)

static_assert(SLOT_BLOCK == WARP, "a block's slots are one warp wide");
static_assert(PCG_WARPS == CLUSTER, "slot_tree reads 8 warps of slots");

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

// ---------------------------------------------------------------------------
// lane_pcg: solver._pcg_solve in one launch.
//
// The chain it replaces issues some 17 launches a CG step (one lane_matvec,
// three lane_dots, the divisions, axpys and torch.where freezes), 64 steps
// a solve, each doing a microsecond of work or less: launches, not bodies,
// bound it. This kernel runs every step of every lane in one launch.
//
// Work split: one cluster of PCG_CLUSTER = 8 blocks per lane. Block q owns
// the rows q nr .. q nr + nr - 1 of the lane's H (nr = ceil(n / 8)) and
// keeps as many of them as its shared memory holds for the whole solve,
// loaded once with 16-byte asynchronous copies: all 64 at n = 512 (128
// KB); at n = 1024 and 2048 a lane's H (4 and 16 MB) exceeds any cluster's
// shared memory, and the block reads its other rows from global memory
// (L2) every step. Every block holds full replicas of x, r, p and dinv and
// updates all n elements itself, so every dot product and scalar is
// computed redundantly and identically in each block, with no broadcast.
// The only data exchanged is the product H p: each block writes each of
// its rows of H p into every block's shared memory (distributed shared
// memory), then one cluster barrier a step. H p is double-buffered across
// steps, which that one barrier makes safe: a block writes buffer k % 2
// again in step k + 2, after step k + 1's barrier, which every block
// passes only after it has read step k's H p.
//
// Order: each operation rounds as the chain's kernel or ATen op does.
// Rows as lane_matvec_kernel computes them (slot l < 32 sums j = l, l + 32,
// ... with fmaf, then the xor-shuffle tree); dot products as lane_dot does
// (slot t < 256 adds __fmul_rn products i = t, t + 256, ... in turn from
// 0, then slot_tree); 1 / d (ATen's reciprocal), b * dinv, b - H x,
// rz / (dot + eps), x + a p, r - a H p, r * dinv and z + beta p each an
// IEEE-rounded __fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn, never
// contracted; stop = rtol^2 * dot(b, b) + eps with the float32 values of
// rtol^2 and eps that ATen's scalar ops use.
//
// Freezing: a step updates x, r, p and rz of a live lane, then
// live = dot(r, r) > stop, as torch.where under the old live and then
// live &= ... do in the chain; a lane that is not live never changes
// again, so the cluster stops there, with the bits of all iters steps. A
// NaN fails the comparison and freezes the lane as the chain does.
//
// No deadlock: every block of a cluster computes live from identical
// replicas with identical operations, so all of them run the same steps
// and leave the loop together; no block waits at a cluster barrier that a
// peer skipped, and no block writes into a peer that has left (each step's
// writes precede that step's barrier, which the peer also waits at).
//
// What bounds it: per step a lane reads its H once (from shared memory at
// n = 512) for 2 n^2 operations and runs a chain of dependent phases (a
// 16-FMA row chain at n = 512, one cluster barrier, three block barriers,
// three 256-slot trees); at the solver's batches (B = 1 to 16 lanes, 8 to
// 128 of the 132 SMs) the steps' latency bounds it, far above the float32
// rate or the memory rate.

// The tree of a lane sum over the block's 256 slots (part: slot t at
// part[t]), run by every warp: the sum, in every thread.
__device__ __forceinline__ float block_tree(const float* part) {
  const int l = threadIdx.x % WARP;
  float v[CLUSTER];
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) v[r] = part[r * WARP + l];
  return __shfl_sync(0xffffffffu, slot_tree(v), 0);
}

template <bool GLOBAL>
__device__ __forceinline__ float pcg_load(const float* a) {
  if constexpr (GLOBAL) return __ldg(a);
  else return *a;
}

// Rows lo <= lr < hi of the block's slice (row lr at a0 + lr n) times v,
// each as lane_matvec_kernel computes a row: warp w takes rows lo + w,
// lo + w + 8, ..., PCG_GROUP of them at a time (independent chains, each
// in its own order); lane l < 8 then writes the row's sum (lane 0's, as
// lane_matvec_kernel stores it) into block l's buffer at dst + row0 + lr.
// (Eight rows at a time from global memory spilled and measured slower at
// n = 1024 and 2048 on an H100.)
template <bool GLOBAL>
__device__ __forceinline__ void pcg_rows(const float* __restrict__ a0, int lo,
                                         int hi, int n,
                                         const float* __restrict__ v,
                                         float* dst, int row0) {
  const int l = threadIdx.x % WARP;
  int lr = lo + (int)threadIdx.x / WARP;
  for (; lr + (PCG_GROUP - 1) * PCG_WARPS < hi; lr += PCG_GROUP * PCG_WARPS) {
    float acc[PCG_GROUP];
#pragma unroll
    for (int e = 0; e < PCG_GROUP; ++e) acc[e] = 0.0f;
#pragma unroll 4
    for (int j = l; j < n; j += WARP) {
      const float vj = v[j];
#pragma unroll
      for (int e = 0; e < PCG_GROUP; ++e)
        acc[e] = fmaf(pcg_load<GLOBAL>(a0 + (long long)(lr + e * PCG_WARPS) * n + j),
                      vj, acc[e]);
    }
#pragma unroll
    for (int e = 0; e < PCG_GROUP; ++e) {
#pragma unroll
      for (int m = WARP / 2; m > 0; m /= 2)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], m);
      const float s = __shfl_sync(0xffffffffu, acc[e], 0);
      if (l < PCG_CLUSTER) dst[row0 + lr + e * PCG_WARPS] = s;
    }
  }
  for (; lr < hi; lr += PCG_WARPS) {
    const float* a = a0 + (long long)lr * n;
    float acc = 0.0f;
    for (int j = l; j < n; j += WARP) acc = fmaf(pcg_load<GLOBAL>(a + j), v[j], acc);
#pragma unroll
    for (int m = WARP / 2; m > 0; m /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    const float s = __shfl_sync(0xffffffffu, acc, 0);
    if (l < PCG_CLUSTER) dst[row0 + lr] = s;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// H (B, n, n) and b (B, n) float32 contiguous -> x (B, n); grid B * 8
// blocks (one cluster a lane). Dynamic shared memory, in floats: the
// block's first `cached` rows (cached n), then x, r, p, dinv (n each), H p
// (2 n, double-buffered) and the slots of three dots (3 * 256).
__global__ void __cluster_dims__(PCG_CLUSTER, 1, 1) __launch_bounds__(PCG_THREADS)
lane_pcg_kernel(const float* __restrict__ H, const float* __restrict__ b,
                float* __restrict__ xout, int n, int iters, int cached,
                int vec, float stop2, float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const long long o = blockIdx.x / PCG_CLUSTER;
  const int t = threadIdx.x;
  const int nr = (n + PCG_CLUSTER - 1) / PCG_CLUSTER;
  const int row0 = q * nr;
  const int nrows = max(0, min(nr, n - row0));
  const int ncached = min(cached, nrows);
  const float* Hl = H + o * n * n;
  const float* Hrows = Hl + (long long)row0 * n;
  const float* bl = b + o * n;
  float* rows = smem;
  float* x = rows + (long long)cached * n;
  float* r = x + n;
  float* p = r + n;
  float* dinv = p + n;
  float* hp = dinv + n;
  float* part = hp + 2 * n;
  // peers may be written only once every block of the cluster runs
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (vec) {
    for (int i = t; i < ncached * n / 4; i += PCG_THREADS)
      cp_async16(rows + 4 * i, Hrows + 4 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = t; i < ncached * n; i += PCG_THREADS) rows[i] = __ldg(Hrows + i);
  }
  for (int i = t; i < n; i += PCG_THREADS) {
    const float di = __fdiv_rn(1.0f, __ldg(Hl + (long long)i * n + i));
    dinv[i] = di;
    x[i] = __fmul_rn(__ldg(bl + i), di);
  }
  if (vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // lane l < 8 of every warp writes into block l's H p
  float* dst = cluster.map_shared_rank(hp, (t % WARP) % PCG_CLUSTER);
  auto matvec = [&](const float* v, int buf) {
    pcg_rows<false>(rows, 0, ncached, n, v, dst + buf * n, row0);
    pcg_rows<true>(Hrows, ncached, nrows, n, v, dst + buf * n, row0);
    cluster.sync();
  };

  // r = b - H x, z = r dinv, p = z; rz = r.z, stop from b.b, live from r.r
  matvec(x, 0);
  float c_rz = 0.0f, c_bb = 0.0f, c_rr = 0.0f;
  for (int i = t; i < n; i += PCG_THREADS) {
    const float bi = __ldg(bl + i);
    const float ri = __fsub_rn(bi, hp[i]);
    const float zi = __fmul_rn(ri, dinv[i]);
    r[i] = ri;
    p[i] = zi;
    c_rz = __fadd_rn(c_rz, __fmul_rn(ri, zi));
    c_bb = __fadd_rn(c_bb, __fmul_rn(bi, bi));
    c_rr = __fadd_rn(c_rr, __fmul_rn(ri, ri));
  }
  part[t] = c_rz;
  part[PCG_THREADS + t] = c_bb;
  part[2 * PCG_THREADS + t] = c_rr;
  __syncthreads();
  float rz = block_tree(part);
  const float stop = __fadd_rn(__fmul_rn(stop2, block_tree(part + PCG_THREADS)), eps);
  bool live = block_tree(part + 2 * PCG_THREADS) > stop;

  // the steps; every block leaves together (see above)
  for (int it = 0; it < iters && live; ++it) {
    const int buf = (it + 1) & 1;
    const float* Hp = hp + buf * n;
    matvec(p, buf);
    float c = 0.0f;
    for (int i = t; i < n; i += PCG_THREADS) c = __fadd_rn(c, __fmul_rn(p[i], Hp[i]));
    part[t] = c;
    __syncthreads();
    const float a = __fdiv_rn(rz, __fadd_rn(block_tree(part), eps));
    c_rz = c_rr = 0.0f;
    for (int i = t; i < n; i += PCG_THREADS) {
      x[i] = __fadd_rn(x[i], __fmul_rn(a, p[i]));
      const float ri = __fsub_rn(r[i], __fmul_rn(a, Hp[i]));
      const float zi = __fmul_rn(ri, dinv[i]);
      r[i] = ri;
      c_rz = __fadd_rn(c_rz, __fmul_rn(ri, zi));
      c_rr = __fadd_rn(c_rr, __fmul_rn(ri, ri));
    }
    part[PCG_THREADS + t] = c_rz;
    part[2 * PCG_THREADS + t] = c_rr;
    __syncthreads();
    const float rz_new = block_tree(part + PCG_THREADS);
    const float beta = __fdiv_rn(rz_new, __fadd_rn(rz, eps));
    for (int i = t; i < n; i += PCG_THREADS)
      p[i] = __fadd_rn(__fmul_rn(r[i], dinv[i]), __fmul_rn(beta, p[i]));
    rz = rz_new;
    live = block_tree(part + 2 * PCG_THREADS) > stop;
    __syncthreads();  // p is read whole by the next step's rows
  }
  for (int i = t; i < nrows; i += PCG_THREADS) xout[o * n + row0 + i] = x[row0 + i];
}

// ---------------------------------------------------------------------------
// lane_cholesky: solver._cholesky_direction, delta = -Hd^-1 g by Cholesky,
// for every lane of a batch in one launch.
//
// It replaces, on the card, cuSOLVER's factor and solve called for each
// lane alone (two library calls a lane, 2 B launches a Newton step):
// cuSOLVER's batched routes give a lane other bits than a batch of one, and
// at n >= 64 bits that depend on the batch. In the JAX package this is
// jax.scipy.linalg.cho_factor / cho_solve inside the jitted Newton step
// (superdsm_tpu/dsm/solver.py:201-205), XLA's, not a Pallas kernel.
//
// Order, fixed by n alone (lane.cholesky_chain replays it op by op with
// ATen's elementwise ops): a right-looking factorization of the lower
// triangle of Hd (the upper one is never read) with the forward
// substitution fused into it, then the back substitution. For j = 0, ...,
// n - 1:
//   p = a_jj; the lane fails unless p > 0 (a NaN pivot fails too);
//   L_jj = sqrt(p); l_i = a_ij / L_jj = L_ij for i > j;
//   y_j = b_j / L_jj; b_i = b_i - l_i y_j for i > j;
//   a_ik = a_ik - l_i l_k for j < k <= i;
// then for j = n - 1, ..., 0: x_j = y_j / L_jj and y_i = y_i - L_ji x_j for
// i < j; delta = -x. Square roots and divisions are IEEE-rounded
// (__fsqrt_rn, __fdiv_rn, as ATen's); each update a - l m is rounded to
// float64 and then to float32 (chol_update): the product of two floats is
// exact in float64, so this matches the float32 fused multiply-adds of
// cuSOLVER's and LAPACK's factors except in rare double-rounding cases,
// and ATen's float64 ops give the same bits, where no ATen op gives a
// float32 FMA's. A product and a difference rounded apart, as __fmul_rn and
// __fsub_rn would, gave the Newton loop's near-singular systems up to ten
// times cuSOLVER's error on an H100 (tests/data/torch_port/
// cholesky_orders.py). Every a_ik and b_i takes its updates in the order
// j = 0, 1, ..., as a sequential left-looking dot would. A failed lane's
// delta is NaN in every entry (the chain's torch.where(fail, nan,
// delta)), which solver._newton_step's guard turns into a gradient step.
//
// Work split: one block a lane, its thread count chosen from n (which
// thread updates an entry does not change the entry's order). The lower
// triangle is packed by columns (column k, rows k..n-1, at k n - k (k + 1)
// / 2 + i). It lives, with L_jj, b, y and two buffers of a scaled column,
// in shared memory up to n = CHOL_SHARED_MAX_N (335; 137 KB at n = 256),
// above in a global scratch of the same layout that the wrapper allocates
// (303 KB a lane at n = 384, L2-resident), with the same code and order.
// Column j is one phase and one block barrier: threads update b and write
// column j's L over its a; warp w updates the columns j + 1 + 8 w .. j + 8 w
// + 8, then those 8 W further on, eight at a time (all loads first, so the
// updates of a row run side by side), its lanes over the columns' rows
// (consecutive addresses). Warp 0's first columns start at j + 1, so it
// also makes the next phase's operands as they become final: L_{j+1, j+1}
// and y_{j+1} (thread 0) and the scaled column L_{i, j+1} (a division a
// row), into the other buffer, while the other warps go on; no phase
// divides in its updates. Column j's entries are only read in its phase,
// through the buffer, and what a phase writes (columns > j, column j's L,
// b_i for i > j, the other buffer) is not read in it, so one barrier a
// column suffices. The back substitution runs in warp 0: in shared memory
// lane l holds y_i for i % 32 == l in registers and y_j comes by a
// shuffle; in the global scratch y stays there (one __syncwarp a column).
//
// What bounds it: n^3 / 3 operations per lane (some microseconds at the
// card's float32 rate at n = 256) against n dependent phases, each a block
// barrier and a square root and divisions on warp 0's path (hundreds of
// cycles at the last columns, where there is little else), and, at the
// first columns, the issue of the updates (a load, two conversions, a
// float64 fused multiply-add, a store): latency and issue, not bytes or
// the arithmetic rate, at every n of the solver (6 to 300).

// Floats of a lane's work space: the packed lower triangle, L_jj, b, y
// and the scaled column (two).
__host__ __device__ constexpr long long chol_floats(long long n) {
  return n * (n + 1) / 2 + 5 * n;
}

constexpr int chol_shared_max_n() {
  int n = 1;
  while (4 * chol_floats(n + 1) <= CHOL_SMEM_BYTES) ++n;
  return n;
}

constexpr int CHOL_SHARED_MAX_N = chol_shared_max_n();

// Registers of a lane of the back substitution in shared memory: y_i for
// i = l, l + 32, ... < CHOL_SHARED_MAX_N.
constexpr int CHOL_BACK_REGS = (CHOL_SHARED_MAX_N + WARP - 1) / WARP;

// a - l m rounded to float64, then to float32: the product of two floats
// is exact in float64, the fused multiply-add rounds the difference to
// float64 and the conversion rounds it to float32 (the plain version's
// (a.double() - l.double() * m.double()).float()); a float32 FMA, which
// rounds once, differs from it in rare double-rounding cases.
__device__ __forceinline__ float chol_update(float a, double l, double m) {
  return __double2float_rn(__fma_rn(-l, m, (double)a));
}

// Rows i0, i0 + 32, ..., (R of them, all < n) of columns ck[c] (c < C, all
// right of the diagonal block): a_ik = a_ik - l_i l_k, all loads first (the
// compiler cannot tell that the columns do not alias, and would otherwise
// run the updates one by one). FIRST: column ck[0] is the next one, whose
// scaled entries a_ik / dn go into lnext.
template <int R, bool FIRST>
__device__ __forceinline__ void chol_rows(float* a, const float* lcur,
                                          const double (&lk)[CHOL_COLS],
                                          const int (&ck)[CHOL_COLS], int i0,
                                          float* lnext, float dn) {
  double li[R];
  float v[R][CHOL_COLS];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    li[q] = (double)lcur[i0 + q * WARP];
#pragma unroll
    for (int c = 0; c < CHOL_COLS; ++c) v[q][c] = a[ck[c] + i0 + q * WARP];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int c = 0; c < CHOL_COLS; ++c) {
      v[q][c] = chol_update(v[q][c], li[q], lk[c]);
      a[ck[c] + i0 + q * WARP] = v[q][c];
    }
    if (FIRST) lnext[i0 + q * WARP] = __fdiv_rn(v[q][0], dn);
  }
}

template <bool GLOBAL>
__global__ void __launch_bounds__(CHOL_MAX_THREADS)
lane_cholesky_kernel(const float* __restrict__ H, const float* __restrict__ g,
                     float* __restrict__ out, float* __restrict__ scratch,
                     int n) {
  extern __shared__ __align__(16) float smem[];
  const long long o = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int l = t % WARP, w = t / WARP, W = T / WARP;
  float* a = GLOBAL ? scratch + o * chol_floats(n) : smem;
  float* d = a + n * (n + 1) / 2;  // L_jj
  float* b = d + n;
  float* y = b + n;
  float* lbuf = y + n;  // the scaled column j at lbuf + (j % 2) n
  // entry (i, k), i >= k, of the triangle packed by columns
  auto col0 = [n](int k) { return k * n - k * (k + 1) / 2; };
  const float* Hl = H + o * n * n;
  for (int i = w; i < n; i += W) {  // row i of Hd, read coalesced
#pragma unroll 4
    for (int k = l; k <= i; k += WARP) a[col0(k) + i] = __ldg(Hl + (long long)i * n + k);
  }
  for (int i = t; i < n; i += T) b[i] = __ldg(g + o * n + i);
  __syncthreads();
  {
    const float d0 = __fsqrt_rn(a[0]);
    if (t == 0) {
      d[0] = d0;
      y[0] = __fdiv_rn(b[0], d0);
    }
    for (int i = 1 + t; i < n; i += T) lbuf[i] = __fdiv_rn(a[i], d0);
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    float* cj = a + col0(j);
    if (!(cj[j] > 0.0f)) {  // the same value in every thread: all leave here
      for (int i = t; i < n; i += T) out[o * n + i] = __int_as_float(0x7fc00000);
      return;
    }
    // L_jj, y_j and l = L_{j+1.., j}, made in the phase before (below)
    const float* lcur = lbuf + (j % 2) * n;
    float* lnext = lbuf + ((j + 1) % 2) * n;
    const double yj = (double)y[j];
    float bnext = 0.0f;
    for (int i = j + 1 + t; i < n; i += T) {
      const float li = lcur[i];
      const float bi = chol_update(b[i], (double)li, yj);
      b[i] = bi;
      cj[i] = li;  // column j holds L from now on (no phase reads it but the last)
      if (i == j + 1) bnext = bi;  // thread 0: b_{j+1}, final
    }
    for (int k0 = j + 1 + w * CHOL_COLS; k0 < n; k0 += W * CHOL_COLS) {
      const bool first = k0 == j + 1;  // warp 0's first columns: j + 1 ...
      const int kn = min(CHOL_COLS, n - k0);
      double lk[CHOL_COLS];
      int ck[CHOL_COLS];
#pragma unroll
      for (int c = 0; c < CHOL_COLS; ++c) {
        const int k = min(k0 + c, n - 1);
        lk[c] = (double)lcur[k];
        ck[c] = col0(k);
      }
      const int i = k0 + l;  // the rows of the diagonal block
      float v[CHOL_COLS] = {};
      if (i < n) {
        const double li = (double)lcur[i];
#pragma unroll
        for (int c = 0; c < CHOL_COLS; ++c)
          v[c] = c < kn && k0 + c <= i ? a[ck[c] + i] : 0.0f;
#pragma unroll
        for (int c = 0; c < CHOL_COLS; ++c) {
          if (c < kn && k0 + c <= i) {
            v[c] = chol_update(v[c], li, lk[c]);
            a[ck[c] + i] = v[c];
          }
        }
      }
      // the next column's L_jj (thread 0: a_{j+1, j+1} is v[0]) and y,
      // and its scaled entries as they become final, while the other
      // warps go on
      float dn = 1.0f;
      if (first) {
        dn = __shfl_sync(0xffffffffu, __fsqrt_rn(v[0]), 0);
        if (t == 0) {
          d[j + 1] = dn;
          y[j + 1] = __fdiv_rn(bnext, dn);
        }
        if (i > j + 1 && i < n) lnext[i] = __fdiv_rn(v[0], dn);
      }
      if (kn == CHOL_COLS) {
        int i0 = k0 + WARP + l;
        if (first) {
          for (; i0 + WARP < n; i0 += 2 * WARP)
            chol_rows<2, true>(a, lcur, lk, ck, i0, lnext, dn);
          if (i0 < n) chol_rows<1, true>(a, lcur, lk, ck, i0, lnext, dn);
        } else {
          for (; i0 + WARP < n; i0 += 2 * WARP)
            chol_rows<2, false>(a, lcur, lk, ck, i0, lnext, dn);
          if (i0 < n) chol_rows<1, false>(a, lcur, lk, ck, i0, lnext, dn);
        }
      } else {
        for (int i0 = k0 + WARP + l; i0 < n; i0 += WARP) {
          const double li = (double)lcur[i0];
#pragma unroll
          for (int c = 0; c < CHOL_COLS; ++c) {
            if (c < kn) {
              const float u = chol_update(a[ck[c] + i0], li, lk[c]);
              a[ck[c] + i0] = u;
              if (c == 0 && first) lnext[i0] = __fdiv_rn(u, dn);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (w != 0) return;
  if constexpr (!GLOBAL) {
    // lane l holds y_i of i = l + 32 u in registers; y_j comes from its
    // lane by a shuffle
    float yr[CHOL_BACK_REGS];
    int cb[CHOL_BACK_REGS];
#pragma unroll
    for (int u = 0; u < CHOL_BACK_REGS; ++u) {
      const int i = l + u * WARP;
      yr[u] = i < n ? y[i] : 0.0f;
      cb[u] = i < n ? col0(i) : 0;
    }
    for (int j = n - 1; j >= 0; --j) {
      const int uj = j / WARP;
      float own = 0.0f;
#pragma unroll
      for (int u = 0; u < CHOL_BACK_REGS; ++u) own = u == uj ? yr[u] : own;
      const float xj = __fdiv_rn(__shfl_sync(0xffffffffu, own, j % WARP), d[j]);
#pragma unroll
      for (int u = 0; u < CHOL_BACK_REGS; ++u) {
        if (l + u * WARP < j) yr[u] = chol_update(yr[u], (double)a[cb[u] + j], (double)xj);
      }
      if (l == j % WARP) out[o * n + j] = -xj;
    }
  } else {
    for (int j = n - 1; j >= 0; --j) {
      const float xj = __fdiv_rn(y[j], d[j]);
      for (int i0 = l; i0 < j; i0 += CHOL_BACK * WARP) {
        float lji[CHOL_BACK], yi[CHOL_BACK];  // loads first
#pragma unroll
        for (int u = 0; u < CHOL_BACK; ++u) {
          const int i = i0 + u * WARP;
          lji[u] = i < j ? a[col0(i) + j] : 0.0f;
          yi[u] = i < j ? y[i] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < CHOL_BACK; ++u) {
          const int i = i0 + u * WARP;
          if (i < j) y[i] = chol_update(yi[u], (double)lji[u], (double)xj);
        }
      }
      if (l == j % WARP) out[o * n + j] = -xj;
      __syncwarp();
    }
  }
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

// x (B, n) = solver._pcg_solve(H, b, iters, rtol) with H (B, n, n) and b
// (B, n) float32 contiguous, stop2 and eps the float32 values of rtol^2 and
// 1e-30; one launch of B clusters on `stream`. Each block keeps as many of
// its rows of H in shared memory as the card's opt-in maximum leaves beside
// its vectors (6 n + 768 floats); n past that maximum is refused.
extern "C" int sdsm_lane_pcg(const float* H, const float* b, float* x, int B,
                             int n, int iters, float stop2, float eps,
                             void* stream) {
  if (B < 0 || n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  if ((long long)B * PCG_CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return (int)err;
  const long long vec_bytes = 4LL * (6LL * n + 3 * PCG_THREADS);
  if (vec_bytes > smem_max) return (int)cudaErrorInvalidValue;
  const long long row_bytes = 4LL * n;
  const long long nr = (n + PCG_CLUSTER - 1) / PCG_CLUSTER;
  const long long fit = (smem_max - vec_bytes) / row_bytes;
  const long long cached = fit < nr ? fit : nr;
  // the card's maximum, the same for every launch (threads launching
  // concurrently set the same value)
  err = cudaFuncSetAttribute(lane_pcg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return (int)err;
  const int vec = n % 4 == 0 && (unsigned long long)H % 16 == 0;
  lane_pcg_kernel<<<B * PCG_CLUSTER, PCG_THREADS,
                    (size_t)(vec_bytes + cached * row_bytes),
                    (cudaStream_t)stream>>>(H, b, x, n, iters, (int)cached, vec,
                                            stop2, eps);
  return (int)cudaGetLastError();
}

extern "C" int sdsm_lane_chol_shared_max_n() { return CHOL_SHARED_MAX_N; }

// delta (B, n) = solver._cholesky_direction(Hd, g), Hd (B, n, n) and g
// (B, n) float32 contiguous; one block a lane on `stream`. scratch: B *
// (n (n + 1) / 2 + 5 n) floats when n > CHOL_SHARED_MAX_N (the lanes' work
// space in global memory), else unused (may be null).
extern "C" int sdsm_lane_cholesky(const float* H, const float* g, float* out,
                                  float* scratch, int B, int n, void* stream) {
  if (B < 0 || n < 0 || chol_floats(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const int threads = n <= 32 ? 64 : n <= 64 ? 128 : n <= 128 ? 256 : CHOL_MAX_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= CHOL_SHARED_MAX_N) {
    // the opt-in maximum, the same for every launch (threads launching
    // concurrently set the same value)
    const cudaError_t err = cudaFuncSetAttribute(
        lane_cholesky_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CHOL_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    lane_cholesky_kernel<false><<<B, threads, (size_t)(4 * chol_floats(n)), st>>>(
        H, g, out, nullptr, n);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    lane_cholesky_kernel<true><<<B, threads, 0, st>>>(H, g, out, scratch, n);
  }
  return (int)cudaGetLastError();
}
