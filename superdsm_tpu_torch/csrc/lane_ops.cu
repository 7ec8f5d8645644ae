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
// their terms cost some 58 instructions each (chip_smoke.py --split counts
// them in the SASS): all of a block's threads build the terms, a thread
// every output of a tile for one pixel (lane_softplus_pixel_kernel), and a
// cluster of CLUSTER = 8 blocks holds the 256 slots of a tile of one lane,
// block rank q slots 32 q .. 32 q + 31, each of which it pushes to the
// block that runs the output's tree (the same order, so the same bits).
//
//   lane_pcg:     the whole Jacobi-preconditioned CG of solver._pcg_solve
//     for every lane of a batch in one launch, bitwise the chain of
//     lane_matvec, lane_dot and elementwise ATen ops that it replaces: with
//     a lane's H in its cluster's registers at n <= 512
//     (lane_pcg_reg_kernel), in shared memory and L2 above
//     (lane_pcg_kernel; see the comments above each).
//   lane_cholesky: the Newton direction -Hd^-1 g by Cholesky
//     (solver._cholesky_direction) for every lane of a batch in one
//     launch, in an order fixed by n alone: one block a lane at small n
//     (see the comment above lane_cholesky_kernel), a cluster of 8 blocks
//     a lane in panels of 8 columns above, and of 16 blocks above n = 807
//     (lane_cholesky_cluster_kernel).
//   the Newton step's ends: the damped Newton system before the direction
//     solve, and the guard, decrement, line-search regularizer candidates
//     and Armijo thresholds after it, bitwise the ATen ops and lane sums
//     they replace; on the solver's path the prologue and epilogue of the
//     direction launch (the step variants of lane_cholesky and lane_pcg),
//     and kernels of their own (lane_lm_system, lane_step_guard), which the
//     fused launch is held to (see the comment above lane_pcg).
//   lane_step_pick, lane_step_tail: the rest of the step, the line search's
//     pick and, after the scale sweep's sums, the sweep's regularizer sums
//     and pick, the new mu, the convergence test and the loop's freeze
//     writes in place, one launch each (see the comment above
//     lane_step_pick_kernel); in the Newton loop the three launches pick,
//     sweep and tail are one, lane_step_sweep (a mode of the softplus
//     sums: the pick its prologue, the tail in each lane's last cluster),
//     which the two kernels are held to.
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

#include <atomic>

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
constexpr int SMALL_N = 8;          // one thread a row up to this n ...
constexpr int ROW_N = 32;           // ... and, with a full tree, up to this
constexpr int SMALL_THREADS = 256;  // rows a block at n <= ROW_N
constexpr int PCG_CLUSTER = 8;      // blocks of one lane's PCG
constexpr int PCG_THREADS = ROW_THREADS;  // thread t is slot t of every dot
constexpr int PCG_WARPS = PCG_THREADS / WARP;
constexpr int PCG_GROUP = 4;        // rows a warp of lane_pcg computes at once
constexpr int CHOL_MAX_THREADS = 512;  // threads of a lane_cholesky block
constexpr int CHOL_COLS = 8;            // columns a warp of it updates at once
constexpr int CHOL_SMEM_BYTES = 232448;  // shared memory a block may opt in to (sm_90)
constexpr int CHOL_CLUSTER = 8;         // blocks of a lane on lane_cholesky's cluster route
constexpr int CHOL_WIDE_CLUSTER = 16;   // and on its wide routes (a non-portable cluster size)
constexpr int CHOL_PW = 8;              // columns of its panels
constexpr int CHOL_ONE_BLOCK_MAX_N = 32;    // one block a lane up to this n,
constexpr int CHOL_MANY_LANES_MAX_N = 128;  // and up to this one at many lanes

static_assert(SLOT_BLOCK == WARP, "a block's slots are one warp wide");
static_assert(PCG_WARPS == CLUSTER, "slot_tree reads 8 warps of slots");

// Phase stamps of a kernel (chip_smoke.py --split): built only with
// -DSDSM_SPLIT, which no main-path build defines; without it every call
// below is empty. Thread 0 of each block reads clock64() at each phase
// boundary (the counter does not agree across a block's warps, so one
// thread only) and adds the cycles since the last stamp to the phase's
// sum, kept in shared memory (not in registers every thread would
// reserve); at the end it writes, at block b's SPLIT_WORDS words of
// g_split, the sums, the steps counted, %globaltimer and clock64() at the
// start and the end, and the SM it ran on.
constexpr int SPLIT_PHASES = 13;
constexpr int SPLIT_WORDS = SPLIT_PHASES + 6;
constexpr int SPLIT_BLOCKS = 1024;
#ifdef SDSM_SPLIT
__device__ unsigned long long g_split[SPLIT_BLOCKS * SPLIT_WORDS];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block's words (one static allocation a kernel).
__device__ __forceinline__ unsigned long long* split_words() {
  __shared__ unsigned long long words[SPLIT_WORDS];
  return words;
}

struct Split {
  unsigned long long last;
  __device__ __forceinline__ void start() {
    if (threadIdx.x != 0) return;
    unsigned long long* w = split_words();
    for (int i = 0; i < SPLIT_WORDS; ++i) w[i] = 0;
    w[SPLIT_PHASES + 1] = global_ns();
    w[SPLIT_PHASES + 3] = last = clock64();
  }
  __device__ __forceinline__ void mark(int phase) {
    if (threadIdx.x != 0) return;
    const unsigned long long now = clock64();
    split_words()[phase] += now - last;
    last = now;
  }
  __device__ __forceinline__ void step() {
    if (threadIdx.x == 0) ++split_words()[SPLIT_PHASES];
  }
  __device__ __forceinline__ void finish() {
    if (threadIdx.x != 0 || blockIdx.x >= SPLIT_BLOCKS) return;
    unsigned long long* w = split_words();
    w[SPLIT_PHASES + 4] = clock64();
    w[SPLIT_PHASES + 2] = global_ns();
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    w[SPLIT_PHASES + 5] = smid;
    for (int i = 0; i < SPLIT_WORDS; ++i)
      g_split[(size_t)blockIdx.x * SPLIT_WORDS + i] = w[i];
  }
};
#else
struct Split {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void finish() {}
};
#endif

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Named barrier `id` of `count` threads: arrive without waiting / wait.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of shared address `a` in cluster block `rank`.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// v stored at cluster address a; completes 4 bytes on the mbarrier at
// cluster address bar (both in the same block).
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(a),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The one arrival of the mbarrier's phase, expecting `bytes` more.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the mbarrier's phase of parity `parity` is complete.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

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

enum SoftplusMode { LINE_SEARCH = 0, SCALE_SWEEP = 1, SINGLE = 2, STEP_SWEEP = 3 };

// w * softplus(x) with x, per mode (s, u, y, w (O, L) contiguous, c (S,)):
//   LINE_SEARCH  -(y * (s + u * c[k]))   solver.py's line search
//   SCALE_SWEEP  (-(y * s)) * c[k]       its scale sweep
//   SINGLE       -(y * s)                one energy
//   STEP_SWEEP   the scale sweep's on the surface s + t_step u, formed
//                as loaded (lane_step_sweep_kernel alone; no operator())
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

#ifdef SDSM_SPLIT
constexpr int TERM_THREADS = 1024;   // threads of a softplus sum's block
constexpr int TERMS_A_THREAD = 4;    // terms a thread builds per group
constexpr int RESIDENT_BLOCKS = 2;   // softplus blocks an SM holds

// The cluster's trees: after the chains each block holds part[tl * kb + kl]
// (slot 32 q + tl of its output kl, q its rank); warp w of rank q runs the
// tree of output w * CLUSTER + q over the ranks' shared memory.
__device__ __forceinline__ void cluster_trees(cg::cluster_group& cluster,
                                              const float* part, int kb,
                                              int kn, float* out, Split& split) {
  cluster.sync();
  split.mark(5);
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
  split.mark(6);
  cluster.sync();  // no block leaves while its slots are read
  split.mark(7);
  split.finish();
}

// PR 13's softplus lane sum (the route lane_softplus_pixel_kernel
// replaced), kept for chip_smoke.py --split's split before and after; no
// main-path build compiles it. Its terms cost some 60 instructions each,
// more than a slot's chain can hide, so the block's threads build them for every
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
  Split split;
  split.start();
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
  split.mark(0);
  __syncthreads();
  split.mark(1);
  float acc = 0.0f;
  for (int group = 0; group < groups; ++group) {
    if (group + 1 < groups) build(group + 1, buf[(group + 1) & 1]);
    split.mark(2);
    if (j < pairs) {
      const float* b = buf[group & 1] + pj;
      for (int g = 0; g < G; ++g) acc = __fadd_rn(acc, b[g * pairs]);
    }
    split.mark(3);
    __syncthreads();
    split.mark(4);
    split.step();
  }
  if (j < pairs && live) part[tl * kb + kl] = acc;
  cluster_trees(cluster, part, kb, kn, out + o * S + k0, split);
}
#endif  // SDSM_SPLIT

// A softplus lane sum, redesigned for issue and occupancy
// (lane_softplus_pixel_kernel): the same slots and order, another split
// of who builds a term.
//
// A cluster of CLUSTER = 8 blocks for (lane o, tile of kb outputs), block
// q the slots 32 q .. 32 q + 31, as above. Group g of a block's chain
// steps is SP_GROUP = SP_THREADS / 32 steps: thread j builds the pixel i =
// (g SP_GROUP + j / 32) 256 + 32 q + j % 32 (slot 32 q + j % 32, chain step
// g SP_GROUP + j / 32) for all kb outputs of the tile, s, u, y and w
// loaded once (a group ahead: their latency is hidden behind the terms of
// the group before) and y s formed once a pixel in the scale sweep (the
// plain version's t = y * s), into shared memory (double-buffered: group
// g + 1 is built while the slots add group g). Warp kl < kb adds output
// kl's 32 slots, each its group's terms in chain order. Then each slot
// goes, with st.async, to the block that owns the output (kl % 8),
// completing on that block's mbarrier, which expects 256 slots an output
// it owns: the owner waits for its slots' bytes alone, and the tree runs
// there, in one warp an output. The cluster barrier that makes the peers'
// mbarriers safe to push to is arrived at before the build and waited for
// after it, so no block waits for another's build at a barrier, and no
// block keeps its shared memory for a peer's reads.
//
// The grid: O clusters a tile of SP_KB outputs (softplus_pixel_plan).
constexpr int SP_THREADS = 512;  // threads of a block
constexpr int SP_BLOCKS = 2;     // blocks an SM must hold (at most 64 registers)
// Outputs a tile, and the fewest blocks a launch should have: the bench's
// shapes measured no faster at other widths on an H100 (chip_smoke.py
// --split times each launch at 1, 2, 3, 4, 6 and 12 tiles).
constexpr int SP_KB = 4;
constexpr int SP_MIN_BLOCKS = 96;
constexpr int SP_GROUP = SP_THREADS / SLOT_BLOCK;  // chain steps a group
constexpr int SP_WARPS = SP_THREADS / WARP;
static_assert(SP_WARPS == SP_GROUP, "a warp builds one chain step of a group");
static_assert(SP_WARPS >= SLOTS_K, "a warp adds one output's slots");

// Dynamic shared memory of the kernel at tile width kb, in floats: the two
// group buffers (SP_GROUP x kb x 32) and the slots of the outputs a block
// owns (two at most, 256 each).
__host__ __device__ constexpr int softplus_smem_floats(int kb) {
  return 2 * SP_GROUP * kb * SLOT_BLOCK + 2 * ROW_THREADS;
}

// A pixel's operands, loaded a group ahead of its terms.
struct SoftplusPixel {
  float s, u, y, w;
  bool in;  // a pixel of the chain (else its terms are 0)
};

// What the start of a launch's sums (softplus_pixel_sums) gives every
// thread: whether the tile's sums are to be made, and the line search's
// step t_step (STEP_SWEEP).
struct SumsStart {
  bool run;
  float ts;
};

// The hooks of softplus_pixel_sums for softplus_energies' launches: the
// sums made, each stored at out[o S + k].
struct SumsOut {
  float* __restrict__ out;
  __device__ __forceinline__ SumsStart start(Split&) const { return {true, 0.0f}; }
  __device__ __forceinline__ void before_trees(long long, int, int, int, float*, Split&) const {}
  __device__ __forceinline__ void store(long long o, int S, int k0, int kl, float sum) const {
    out[o * S + k0 + kl] = sum;
  }
};

// The sums of one tile (lane o, outputs k0 .. k0 + kn - 1): the body of
// lane_softplus_pixel_kernel (see above), and of lane_step_sweep_kernel
// (STEP_SWEEP), through `hooks` (SumsOut's, or the fused launch's):
// start(split) runs in every thread once the first groups' loads are
// issued and the cluster barrier is arrived at; in STEP_SWEEP it gives
// t_step (the pixels' surface is then s + t_step u, formed as loaded: s
// read coherently, the loop's s being written in this launch) or, for a
// lane already converged, run = false: the tile is left with no sum made
// and false is returned. before_trees(o, k0, kn, owned, free, split) runs
// in every thread once its slots are pushed, before the owners' trees
// (`free`: the group buffers, kb rows of 256 floats at least);
// store(o, S, k0, kl, sum) in lane 0 of the warp that owns the tile's
// output kl, with its sum.
template <int MODE, class Hooks>
__device__ __forceinline__ bool softplus_pixel_sums(const SoftplusTerm<MODE>& term, int L, int S,
                                                    int kb, int k_tiles, Split& split,
                                                    const Hooks& hooks) {
  extern __shared__ __align__(16) float sp_smem[];
  __shared__ __align__(8) unsigned long long bar;
  const int q = (int)cg::this_cluster().block_rank();
  const long long tile = blockIdx.x / CLUSTER;
  const long long o = tile / k_tiles;
  const int k0 = (int)(tile % k_tiles) * kb;
  const int kn = min(kb, S - k0);
  const int j = threadIdx.x, w = j / WARP, l = j % WARP;
  const int owned = (kn - q + CLUSTER - 1) / CLUSTER;  // outputs q, q + 8 of kn
  const int chain = (L + ROW_THREADS - 1) / ROW_THREADS;
  const int groups = (chain + SP_GROUP - 1) / SP_GROUP;
  const long long base = o * L;
  const int t = q * SLOT_BLOCK + l;  // this thread's slot in the build
  auto load = [&](int group) {
    const int c = group * SP_GROUP + w;
    const int i = c * ROW_THREADS + t;
    SoftplusPixel px{0.0f, 0.0f, 0.0f, 0.0f, c < chain && i < L};
    if (px.in) {
      const long long p = base + i;
      px.s = MODE == STEP_SWEEP ? __ldcg(term.s + p) : __ldg(term.s + p);
      px.y = __ldg(term.y + p);
      px.w = __ldg(term.w + p);
      if (MODE == LINE_SEARCH || MODE == STEP_SWEEP) px.u = __ldg(term.u + p);
    }
    return px;
  };
  SoftplusPixel cur = load(0);
  float* buf = sp_smem;                                // [2][SP_GROUP][kb][32]
  float* slots = sp_smem + 2 * SP_GROUP * kb * SLOT_BLOCK;  // [2][256]
  // the mbarrier's thread (in STEP_SWEEP warp 1: warp 0 picks)
  const int init = MODE == STEP_SWEEP ? WARP : 0;
  if (j == init) {
    mbar_init(smem_addr(&bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();
  SoftplusPixel next = groups > 1 ? load(1) : cur;
  const SumsStart start = hooks.start(split);
  if (!start.run) {
    cluster_wait();
    return false;
  }
  const float ts = start.ts;
  // the terms of pixel px into dst (its chain step w of the group)
  auto build = [&](const SoftplusPixel& px, float* dst) {
    float* d = dst + w * kb * SLOT_BLOCK + l;
    if (px.in) {
      if (MODE == LINE_SEARCH) {
#pragma unroll 4
        for (int kl = 0; kl < kn; ++kl) {
          const float x =
              -__fmul_rn(px.y, __fadd_rn(px.s, __fmul_rn(px.u, __ldg(term.c + k0 + kl))));
          d[kl * SLOT_BLOCK] = __fmul_rn(px.w, logaddexp0(x));
        }
      } else if (MODE == SCALE_SWEEP || MODE == STEP_SWEEP) {
        // the step's new surface as lane_step_pick writes it
        const float sv = MODE == STEP_SWEEP ? __fadd_rn(px.s, __fmul_rn(ts, px.u)) : px.s;
        const float ys = -__fmul_rn(px.y, sv);
#pragma unroll 4
        for (int kl = 0; kl < kn; ++kl)
          d[kl * SLOT_BLOCK] = __fmul_rn(px.w, logaddexp0(__fmul_rn(ys, __ldg(term.c + k0 + kl))));
      } else {
        d[0] = __fmul_rn(px.w, logaddexp0(-__fmul_rn(px.y, px.s)));
      }
    } else {
      for (int kl = 0; kl < kn; ++kl) d[kl * SLOT_BLOCK] = 0.0f;  // + 0 leaves acc
    }
  };
  build(cur, buf);
  split.mark(0);
  __syncthreads();
  split.mark(1);
  float acc = 0.0f;  // warp w < kn: output w's slot t
  for (int group = 0; group < groups; ++group) {
    if (group + 1 < groups) {
      cur = next;
      if (group + 2 < groups) next = load(group + 2);
      build(cur, buf + ((group + 1) & 1) * SP_GROUP * kb * SLOT_BLOCK);
    }
    split.mark(2);
    if (w < kn) {  // the steps past the chain hold zeros
      const float* b = buf + (group & 1) * SP_GROUP * kb * SLOT_BLOCK + w * SLOT_BLOCK + l;
      float v[SP_GROUP];
#pragma unroll
      for (int g = 0; g < SP_GROUP; ++g) v[g] = b[g * kb * SLOT_BLOCK];
#pragma unroll
      for (int g = 0; g < SP_GROUP; ++g) acc = __fadd_rn(acc, v[g]);
    }
    split.mark(3);
    __syncthreads();
    split.mark(4);
    split.step();
  }
  // each slot to its output's owner (output kl: block kl % 8, its slots
  // kl / 8), then the owner's trees
  if (j == init && owned > 0)
    mbar_expect(smem_addr(&bar), 4u * ROW_THREADS * (unsigned)owned);
  cluster_wait();
  if (w < kn) {
    const int owner = w % CLUSTER;
    st_async(cluster_addr(smem_addr(slots + (w / CLUSTER) * ROW_THREADS + t), owner), acc,
             cluster_addr(smem_addr(&bar), owner));
  }
  hooks.before_trees(o, k0, kn, owned, buf, split);
  if (owned > 0) mbar_wait(smem_addr(&bar), 0);
  split.mark(5);
  if (w < owned) {
    float v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v[r] = slots[w * ROW_THREADS + r * WARP + l];
    const float sum = slot_tree(v);
    if (l == 0) hooks.store(o, S, k0, q + w * CLUSTER, sum);
  }
  split.mark(6);
  return true;
}

template <int MODE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(SP_THREADS, SP_BLOCKS)
lane_softplus_pixel_kernel(SoftplusTerm<MODE> term, float* __restrict__ out, int L,
                           int S, int kb, int k_tiles) {
  Split split;
  split.start();
  softplus_pixel_sums(term, L, S, kb, k_tiles, split, SumsOut{out});
  split.finish();
}

// logaddexp(x, 0) elementwise (the device function the softplus sums use),
// to hold it bitwise against ATen's kernel.
__global__ void softplus_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = logaddexp0(x[i]);
}

// ---------------------------------------------------------------------------
// The two ends of a Newton step (solver._newton_step): the damped system
// before the direction solve and the step guard after it. Each replaces a
// run of ATen's elementwise kernels and lane sums (some 35 and 25 launches
// of a DSM iteration), and gives the bits of that run: every operation
// rounds as ATen's CUDA kernel rounds it (__fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn, no contraction), and every sum takes the lane
// sums' slot-and-tree order. They replace no Pallas kernel: in the JAX
// package these are XLA's fusions of the jitted Newton step
// (superdsm_tpu/dsm/solver.py:194-200, 208-227).
//
// Their arithmetic lives in the device functions below (Damp, lm_damp,
// step_guard_lane), which two kinds of kernel run:
//   - lane_lm_system_kernel and lane_step_guard_kernel, one launch each
//     around a direction launch (the oracles the fused launches are held
//     to, and the damped system of lane_pcg_kernel's route, n > 512);
//   - the direction kernels' step variants (template argument STEP):
//     STEP_FULL forms the damped system where the kernel loads H (the
//     prologue: the trace, then Hd's entries and g' as they are loaded,
//     never written to device memory) and runs the guard on the direction
//     where the kernel holds it (the epilogue); STEP_GUARD runs the
//     epilogue alone on a system the caller damped (the sharded solver's
//     own assembly). One launch a Newton step in place of three, and no Hd
//     round trip through device memory.
// What bounds them: the damped system moves H (one read; the standalone
// kernel also writes Hd), the guard a few vectors of a lane; at the
// solver's sizes both are at a launch's floor, which the fused variants
// remove, and the prologue's trace is n loads of a lane's diagonal and one
// block tree, before the direction's first load.
// ---------------------------------------------------------------------------

constexpr int LM_ROWS = 16;             // rows of Hd a block of lane_lm_system writes
constexpr int GUARD_MAX_S = SLOTS_K;    // line-search steps of the guard
constexpr int GUARD_MAX_N = 4096;       // lane_step_guard's direction in dynamic shared memory
// Floats of a block's guard scratch (GUARD_MAX_S rows of slots and the
// tree's total, padded): what the direction kernels' step variants add to,
// or find in, their shared memory.
constexpr int GUARD_FLOATS = GUARD_MAX_S * ROW_THREADS + 4;

// The direction kernels' variants: the direction alone; with the guard
// epilogue; with the damped-system prologue and the guard epilogue.
constexpr int STEP_PLAIN = 0, STEP_GUARD = 1, STEP_FULL = 2;

// ATen's clamp_min(v, 0) on CUDA: NaN propagates (fmaxf alone would drop it).
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// sqrt(xi * xi + eps), op by op.
__device__ __forceinline__ float reg_term2(float xi, float eps) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(xi, xi), eps));
}

// The regularizer's gradient at a deformation entry, as lane.reg_grad_hess
// builds it: (a * (xi / term2)) * kmask.
__device__ __forceinline__ float reg_grad(float xi, float a, float km, float eps) {
  return __fmul_rn(__fmul_rn(a, __fdiv_rn(xi, reg_term2(xi, eps))), km);
}

// Its Hessian diagonal there: clamp_min(a * (1.0 / term2 - (xi * xi) /
// term2 ** 3), 0) * kmask + (1.0 - kmask). PyTorch's 1.0 / t is
// reciprocal(t) * 1.0 and ATen's t ** 3 is (t * t) * t.
__device__ __forceinline__ float reg_hess(float xi, float a, float km, float eps) {
  const float t2 = reg_term2(xi, eps);
  const float r = __fmul_rn(__fdiv_rn(1.0f, t2), 1.0f);
  const float q = __fdiv_rn(__fmul_rn(xi, xi), __fmul_rn(__fmul_rn(t2, t2), t2));
  const float h = clamp_min0(__fmul_rn(a, __fsub_rn(r, q)));
  return __fadd_rn(__fmul_rn(h, km), __fsub_rn(1.0f, km));
}

// The tree of a lane sum over the 256 slots at part[s] (written, and
// published by a block barrier): warp 0 runs it, and every thread gets the
// sum. `part` and `total` may be used again right after it returns.
__device__ __forceinline__ float slots_total(const float* part, float* total) {
  const int t = threadIdx.x;
  if (t < WARP) {
    float v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v[r] = part[r * WARP + t];
    const float sum = slot_tree(v);
    if (t == 0) *total = sum;
  }
  __syncthreads();
  return *total;
}

// The lane sum of terms term(i), i < L, in lane_sum's order (slot s < 256
// adds terms s, s + 256, ... in turn from 0; then the tree), by a block of
// any multiple of 32 threads: thread t runs slots t, t + T, ...
template <class Term>
__device__ __forceinline__ float lane_slots_sum(int L, const Term& term, float* part,
                                                float* total) {
  for (int s = threadIdx.x; s < ROW_THREADS; s += blockDim.x) {
    float acc = 0.0f;
    for (int i = s; i < L; i += ROW_THREADS) acc = __fadd_rn(acc, term(i));
    part[s] = acc;
  }
  __syncthreads();
  return slots_total(part, total);
}

// A row read through the read-only cache, and one read with plain loads
// (in shared memory, or in device memory that the launch writes).
struct GlobalRow {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator()(int i) const { return __ldg(p + i); }
};
struct SharedRow {
  const float* p;
  __device__ __forceinline__ float operator()(int i) const { return p[i]; }
};

// The S regularizer sums of one lane, out[k] = clamp_min(a * lane_sum_K(km
// * (sqrt(xi(i, k)^2 + eps) - sq_eps)), 0): lane_sum's order over the (B,
// K, S) terms summed over K (slot s adds i = s, s + 256, ... in turn; then
// the tree), the S sums over the same 256 slots (thread t runs slots t, t +
// T, ...; a slot's S chains side by side, each in its own order, so their
// square roots overlap) and their trees over the block's warps. `part`
// holds GUARD_MAX_S rows of slots; km(i) is kmask[i] (GlobalRow or
// SharedRow); out[k] is written by lane 0 of one warp,
// with no barrier after it. The candidates xi(i, k): the line search's
// (GuardXi) in the guard, the scale sweep's (SweepXi) in lane_step_tail.
// The block computes the sums k = k0, k0 + dk, ... (k0 < dk) alone: blocks
// that share a lane's candidates deal its sums, each sum whole.
template <class Xi, class Km>
__device__ __forceinline__ void reg_sums(const Xi& xi, const Km& km, int K,
                                         int S, float a, float eps, float sq_eps,
                                         float (*part)[ROW_THREADS], float* out, int k0 = 0,
                                         int dk = 1) {
  const int t = threadIdx.x, T = blockDim.x;
  unsigned sums = 0;  // bit k: the block makes sum k (no modulo in the unrolled loops)
  for (int k = k0; k < S; k += dk) sums |= 1u << k;
  auto mine = [&](int k) { return (sums >> k) & 1u; };
  for (int s = t; s < ROW_THREADS; s += T) {
    float acc[GUARD_MAX_S];
#pragma unroll
    for (int k = 0; k < GUARD_MAX_S; ++k) acc[k] = 0.0f;
    for (int i = s; i < K; i += ROW_THREADS) {
      const float m = km(i);
#pragma unroll
      for (int k = 0; k < GUARD_MAX_S; ++k)
        if (mine(k)) acc[k] = __fadd_rn(acc[k], __fmul_rn(m, __fsub_rn(reg_term2(xi(i, k), eps), sq_eps)));
    }
#pragma unroll
    for (int k = 0; k < GUARD_MAX_S; ++k)
      if (mine(k)) part[k][s] = acc[k];
  }
  __syncthreads();
  const int lane = t % WARP;
  for (int k = k0 + dk * (t / WARP); k < S; k += dk * (T / WARP)) {
    float v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v[r] = part[k][r * WARP + lane];
    const float sum = slot_tree(v);
    if (lane == 0) out[k] = clamp_min0(__fmul_rn(a, sum));
  }
}

// The line search's candidates params[6 + i] + delta[6 + i] steps[k] (d: the
// lane's delta in shared memory).
struct GuardXi {
  const float* __restrict__ p;
  const float* d;
  const float* __restrict__ steps;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return __fadd_rn(__ldg(p + i), __fmul_rn(d[6 + i], __ldg(steps + k)));
  }
};

// What a step variant of a direction kernel reads and writes besides H, g
// and the direction's own arguments (the damped system's inputs, the
// guard's inputs and outputs; see lane_lm_system_kernel and
// lane_step_guard_kernel for each).
struct StepArgs {
  const float* __restrict__ params;  // (B, n)
  const float* __restrict__ mu;      // (B,) (STEP_FULL)
  const float* __restrict__ alpha;   // (B,) at n > 6
  const float* __restrict__ kmask;   // (B, n - 6) at n > 6
  const float* __restrict__ steps;   // (S,)
  const float* __restrict__ f0;      // (B,)
  float* __restrict__ delta;         // (B, n)
  float* __restrict__ decrement;     // (B,)
  float* __restrict__ reg_cand;      // (B, S) at n > 6
  float* __restrict__ thr;           // (B, S)
  int S;
  float eps, inv_n, tiny, sq_eps, armijo;
};

// The damped system of lane o (solver.py:297-304): at n > 6 (reg) the
// regularizer's Hessian diagonal added to H's diagonal and its gradient to
// g, masked by [1, kmask]; then Hd = H + c I, c = mu (trace / n + tiny)
// with the trace of the regularized H in lane_sum's order (lm_damp). ATen's
// steps kept: x / n with a Python n is x * (1.0f / n) (inv_n, from the
// host), H + diag_embed(reg_h) adds 0 off the diagonal (a -0 becomes +0),
// and the damping adds c * 0 there (NaN everywhere when c is not finite).
struct Damp {
  const float* __restrict__ p;
  const float* __restrict__ km;
  float a, eps, c_diag, c_off;
  bool reg;
  __device__ __forceinline__ Damp() {}  // unused (STEP_GUARD's)
  __device__ __forceinline__ Damp(const float* params, const float* kmask, const float* alpha,
                                  long long o, int n, float eps_)
      : p(params + o * n), eps(eps_), c_diag(0.0f), c_off(0.0f), reg(n > 6) {
    km = kmask + (reg ? o * (n - 6) : 0);
    a = reg ? __ldg(alpha + o) : 0.0f;
  }
  // H's diagonal entry i regularized: the trace's term
  __device__ __forceinline__ float trace_term(float h, int i) const {
    if (!reg) return h;
    return __fadd_rn(h, i < 6 ? 0.0f : reg_hess(__ldg(p + i), a, __ldg(km + i - 6), eps));
  }
  __device__ __forceinline__ void set_trace(float sum, float mu, float inv_n, float tiny) {
    const float c = __fmul_rn(mu, __fadd_rn(__fmul_rn(sum, inv_n), tiny));
    c_diag = __fmul_rn(c, 1.0f);
    c_off = __fmul_rn(c, 0.0f);
  }
  __device__ __forceinline__ float diag(float h, int i) const {
    return __fadd_rn(trace_term(h, i), c_diag);
  }
  // Hd[i, i] from the trace's term i (lm_damp's `terms`)
  __device__ __forceinline__ float from_term(float term) const { return __fadd_rn(term, c_diag); }
  __device__ __forceinline__ float off(float h) const {
    return __fadd_rn(reg ? __fadd_rn(h, 0.0f) : h, c_off);
  }
  // Hd[i, k] from H[i, k]
  __device__ __forceinline__ float at(float h, int i, int k) const {
    return i == k ? diag(h, i) : off(h);
  }
  // g'[i] from g[i]
  __device__ __forceinline__ float grad(float gi, int i) const {
    if (!reg) return gi;
    const float rg = i < 6 ? 0.0f : reg_grad(__ldg(p + i), a, __ldg(km + i - 6), eps);
    const float m = i < 6 ? 1.0f : __ldg(km + i - 6);
    return __fmul_rn(__fadd_rn(gi, rg), m);
  }
};

// The damping of lane o (H: its (n, n) block) computed by the calling block
// (its trace over the 256 slots in part, then c); every thread gets it.
// With `terms` (n floats), the trace's terms are kept there, visible to the
// block on return: the diagonal's damped entries then need no second
// regularizer term (Damp::from_term).
__device__ __forceinline__ Damp lm_damp(const StepArgs& sa, const float* __restrict__ H,
                                        long long o, int n, float* part, float* total,
                                        float* terms = nullptr) {
  Damp dm(sa.params, sa.kmask, sa.alpha, o, n, sa.eps);
  const float* h = H + o * n * n;
  const float sum = lane_slots_sum(n, [&](int i) {
    const float v = dm.trace_term(__ldg(h + (long long)i * n + i), i);
    if (terms != nullptr) terms[i] = v;
    return v;
  }, part, total);
  dm.set_trace(sum, __ldg(sa.mu + o), sa.inv_n, sa.tiny);
  return dm;
}

// g' of a step variant: the damped gradient (STEP_FULL) or g as given.
template <int STEP>
struct StepGrad {
  const float* __restrict__ g;
  Damp dm;
  __device__ __forceinline__ float operator()(int i) const {
    const float gi = __ldg(g + i);
    return STEP == STEP_FULL ? dm.grad(gi, i) : gi;
  }
};

// g' kept in shared memory by the kernel's prologue.
struct SharedGrad {
  const float* g;
  __device__ __forceinline__ float operator()(int i) const { return g[i]; }
};

// The guard's g' of lane o, its regularizer terms read afresh (the
// prologue's Damp need not stay live through the direction's registers).
template <int STEP>
__device__ __forceinline__ StepGrad<STEP> step_grad(const StepArgs& sa, const float* g,
                                                    long long o, int n) {
  return {g + o * n, STEP == STEP_FULL ? Damp(sa.params, sa.kmask, sa.alpha, o, n, sa.eps)
                                       : Damp()};
}

// The guard of lane o's direction (solver.py:309-312, 321-324, 329), by a
// block of T threads (a multiple of 32): d holds the direction (n floats in
// shared memory, each entry i visible to thread i % T), gp(i) is g'[i], and
// `bad` is set in a lane known to have failed (d's entries are then not
// read as a direction).
//   delta = d; where an entry is not finite (or `bad`), delta = -g' /
//     (sqrt(lane_dot(g', g')) + 1);
//   decrement = -lane_dot(g', delta);
//   thr[k] = f0 - (armijo * steps[k]) * decrement, the Armijo thresholds;
//   reg_cand[k] = clamp_min(alpha * lane_sum_K(kmask * (sqrt(xi * xi + eps)
//     - sqrt(eps))), 0), xi = params[6:] + delta[6:] * steps[k] (n > 6).
// Each sum takes lane_dot's and lane_sum's own order (lane_slots_sum), so
// the outputs are bitwise that chain with no tensor in between; the S
// regularizer sums run over the same 256 slots (reg_sums). part: GUARD_MAX_S
// rows of slots. `ranks` blocks holding the same direction (PCG's cluster:
// every block holds x) may share the guard: each runs the test and the
// fallback, block `rank` the sums k = rank, rank + ranks, ..., and block
// 0 alone the decrement and writes delta, the decrement and thresholds.
//
// Not inlined: a call at a kernel's end, compiled apart, leaves the
// direction kernel's own register allocation as it was (inlined, it slowed
// the cluster routes' trailing updates by a fifth at n = 256 on an H100,
// chip_smoke.py --split).
template <class Gp>
__device__ __noinline__ void step_guard_lane(const StepArgs& sa, long long o, int n, float* d,
                                                int bad, const Gp& gp,
                                                float (*part)[ROW_THREADS], float* total,
                                                Split& split, int rank = 0, int ranks = 1) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int i = t; i < n; i += T) bad |= !isfinite(d[i]);
  if (__syncthreads_or(bad)) {
    const float gg = lane_slots_sum(n, [&](int i) {
      const float gi = gp(i);
      return __fmul_rn(gi, gi);
    }, part[0], total);
    const float den = __fadd_rn(__fsqrt_rn(gg), 1.0f);
    for (int i = t; i < n; i += T) d[i] = __fdiv_rn(-gp(i), den);
    __syncthreads();
  }
  // d is published: by the barrier above, or that of the fallback
  if (rank == 0) {
    const float dec = -lane_slots_sum(n, [&](int i) { return __fmul_rn(gp(i), d[i]); },
                                      part[0], total);
    for (int i = t; i < n; i += T) sa.delta[o * n + i] = d[i];
    if (t == 0) sa.decrement[o] = dec;
    if (t < sa.S)
      sa.thr[o * sa.S + t] =
          __fsub_rn(__ldg(sa.f0 + o), __fmul_rn(__fmul_rn(sa.armijo, __ldg(sa.steps + t)), dec));
  }
  split.mark(11);
  const int K = n - 6;
  if (K <= 0) return;
  reg_sums(GuardXi{sa.params + o * n + 6, d, sa.steps}, GlobalRow{sa.kmask + o * K}, K, sa.S,
           __ldg(sa.alpha + o), sa.eps, sa.sq_eps, part, sa.reg_cand + o * sa.S, rank, ranks);
  split.mark(12);
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

// block_tree of two slot arrays at once (their loads and shuffles
// interleaved): the same two sums.
__device__ __forceinline__ void block_trees(const float* part0, const float* part1,
                                            float& sum0, float& sum1) {
  const int l = threadIdx.x % WARP;
  float v[CLUSTER], u[CLUSTER];
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) {
    v[r] = part0[r * WARP + l];
    u[r] = part1[r * WARP + l];
  }
#pragma unroll
  for (int m = CLUSTER / 2; m > 0; m /= 2) {
#pragma unroll
    for (int r = 0; r < m; ++r) {
      v[r] = __fadd_rn(v[r], v[r + m]);
      u[r] = __fadd_rn(u[r], u[r + m]);
    }
  }
  float a = v[0], b = u[0];
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2) {
    const float da = __shfl_down_sync(0xffffffffu, a, m);
    const float db = __shfl_down_sync(0xffffffffu, b, m);
    a = __fadd_rn(a, da);
    b = __fadd_rn(b, db);
  }
  sum0 = __shfl_sync(0xffffffffu, a, 0);
  sum1 = __shfl_sync(0xffffffffu, b, 0);
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
// STEP_GUARD (see above lane_pcg; no STEP_FULL: a damped read of H every
// step would cost this route, whose rows of H outside shared memory come
// from L2 each step, so its caller damps H once, lane_lm_system_kernel):
// block 0 runs the guard on -x, negated in place, once the loop is done
// (no peer writes into it after the last step's barrier), with its slots
// in the cached rows or, where those are fewer floats, after x; x is not
// written out.
template <int STEP>
__global__ void __cluster_dims__(PCG_CLUSTER, 1, 1) __launch_bounds__(PCG_THREADS)
lane_pcg_kernel(const float* __restrict__ H, const float* __restrict__ b,
                float* __restrict__ xout, int n, int iters, int cached,
                int vec, float stop2, float eps, StepArgs sa) {
  static_assert(STEP != STEP_FULL, "lane_pcg_kernel takes a damped system");
  extern __shared__ __align__(16) float smem[];
  Split split;
  split.start();
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
    split.mark(1);
    cluster.sync();
    split.mark(2);
  };

  // r = b - H x, z = r dinv, p = z; rz = r.z, stop from b.b, live from r.r
  split.mark(0);
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
  split.mark(0);

  // the steps; every block leaves together (see above)
  for (int it = 0; it < iters && live; ++it) {
    const int buf = (it + 1) & 1;
    const float* Hp = hp + buf * n;
    split.mark(0);
    matvec(p, buf);
    float c = 0.0f;
    for (int i = t; i < n; i += PCG_THREADS) c = __fadd_rn(c, __fmul_rn(p[i], Hp[i]));
    part[t] = c;
    split.mark(3);
    __syncthreads();
    split.mark(4);
    const float a = __fdiv_rn(rz, __fadd_rn(block_tree(part), eps));
    split.mark(5);
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
    split.mark(6);
    __syncthreads();
    split.mark(7);
    const float rz_new = block_tree(part + PCG_THREADS);
    const float beta = __fdiv_rn(rz_new, __fadd_rn(rz, eps));
    for (int i = t; i < n; i += PCG_THREADS)
      p[i] = __fadd_rn(__fmul_rn(r[i], dinv[i]), __fmul_rn(beta, p[i]));
    rz = rz_new;
    live = block_tree(part + 2 * PCG_THREADS) > stop;
    split.mark(8);
    __syncthreads();  // p is read whole by the next step's rows
    split.mark(9);
    split.step();
  }
  if constexpr (STEP == STEP_PLAIN) {
    for (int i = t; i < nrows; i += PCG_THREADS) xout[o * n + row0 + i] = x[row0 + i];
  } else if (q == 0) {
    for (int i = t; i < n; i += PCG_THREADS) x[i] = -x[i];  // the direction
    float* slots = (long long)cached * n >= GUARD_FLOATS ? rows : r;
    auto gpart = reinterpret_cast<float (*)[ROW_THREADS]>(slots);
    step_guard_lane(sa, o, n, x, 0, step_grad<STEP_GUARD>(sa, b, o, n), gpart,
                    gpart[GUARD_MAX_S], split);
  }
  split.finish();
}

// ---------------------------------------------------------------------------
// lane_pcg at n <= PCG_REG_MAX_N: the same order, redesigned for the
// latency of a step (lane_pcg_reg_kernel).
//
// Work split: a cluster of PCG_CLUSTER = 8 blocks a lane, block q owning
// rows q nr .. q nr + nr - 1 as above, but its rows live in registers for
// the whole solve: warp w holds rows w, w + 8, ..., (8 rows at nr <= 64)
// and lane l the columns j = l, l + 32, ... (16 at n <= 512), exactly the
// operands lane l of lane_matvec_kernel's warp uses for those rows, so a
// product reads no memory but p. Every warp holds the replicas of p, r and
// dinv at its lane's columns j = l + 32 k in registers too, and updates all
// of them itself: the next product needs no block barrier and no shared
// memory for p. Thread t also keeps x and the dots' slot t at i = t and t +
// 256 (k = w and w + 8).
//
// A product: each warp's 8 row chains (fmaf, j ascending, as
// lane_matvec_kernel), then the xor tree for all 8 rows at once, halving
// the rows a lane carries at each level (m = 16, 8, 4: a lane keeps the
// rows of its half and adds its partner's copy, the operands the 8
// separate trees add; m = 2, 1: one row a lane), so lanes 4 e .. 4 e + 3
// end with row w + 8 e's sum: 9 shuffles in place of 40. Each of those 4
// lanes pushes it to 2 of the 8 blocks (its own included) with st.async,
// which completes on an mbarrier in the receiving block's shared memory
// (one for each H p buffer, armed for n * 4 bytes a step). A block waits
// on its own mbarrier's phase, for the bytes it expects, and not for its
// peers' arrival at a cluster barrier.
//
// A step then has two block barriers: after p.Hp's slots (then every warp
// runs the tree and a = rz / (p.Hp + eps)), and after r.z's and r.r's
// slots (two trees: beta, live); x, r, z and p are updated in registers
// in between, with the same rounded ops as above. The slots of the three
// dots go to separate regions (pHp, rz, rr; the first product's b.b to a
// fourth): a region is written again only after a block barrier that
// every warp passes after its reads of it.
//
// Buffers and phases: H p is double-buffered, step it in buffer (it + 1) %
// 2 (the first product in buffer 0), its u-th use (u = (it + 1) / 2) the
// mbarrier's phase of parity u % 2. A block X reads buffer b of step k
// before block barrier 2 of step k; it pushes step k + 1's rows only
// after that barrier; a peer pushes step k + 2's rows into X's buffer b
// only after its own mbarrier has all of step k + 1's rows, X's included
// (st.async's completion releases at cluster scope, the wait acquires):
// so no row is overwritten before X has read it, and no step k + 2 byte
// reaches X's mbarrier before its step k phase is complete (X armed that
// phase before it pushed step k + 1). Every block runs the same steps
// (the no-deadlock argument above), waits for every byte pushed to it,
// and passes one last cluster barrier before it leaves.
//
// What bounds it: the chain of a step's phases (the row chains and
// their tree, the push and the wait, two barriers, three trees, two
// divisions), not the 2 n^2 operations nor H's bytes, which are read
// once a solve.
constexpr int PCG_REG_MAX_N = 512;
constexpr int PCG_REG_ROWS = 8;                    // rows a warp holds
constexpr int PCG_REG_COLS = PCG_REG_MAX_N / WARP;  // columns a lane holds
static_assert(PCG_REG_ROWS * PCG_WARPS * PCG_CLUSTER == PCG_REG_MAX_N,
              "a cluster's registers hold a lane's H");
static_assert(PCG_REG_COLS == 2 * PCG_WARPS, "slot t holds i = t and t + 256");

// H (B, n, n) and b (B, n) float32 contiguous -> x (B, n), n <= 512; grid
// B * 8 blocks (one cluster a lane).
// STEP (STEP_GUARD, STEP_FULL), the step variants (see above lane_pcg): with
// STEP_FULL every block computes its lane's trace and g' (its slots, the
// trace's terms and g' in its own static shared memory: peers may push
// into the H p buffers already), loads H's rows into registers as the
// plain variant does (with the damping applied as they load, the loads
// took 7 times as long, and with the trace after the loads were issued
// the launch took 2.5 us more, on an H100: chip_smoke.py --split, phase
// 3) and then damps them in place (Jacobi's diagonal of Hd from the
// trace's terms, g' for b). After the last cluster barrier every block
// runs the guard on -x (every block holds the whole of x, the same bits:
// thread t at i = t and t + 256, negated into the first H p buffer) and
// the g' it kept, block q the regularizer sums k = q, q + 8, ... (block
// 0's guard alone measured ~8 us after a 64 MB read, more than the
// lane_step_guard launch it replaced); x is not written out. Stamps: 10
// the trace and g', 9 the loads and the damping.
template <int STEP>
__global__ void __cluster_dims__(PCG_CLUSTER, 1, 1) __launch_bounds__(PCG_THREADS, 1)
lane_pcg_reg_kernel(const float* __restrict__ H, const float* __restrict__ b,
                    float* __restrict__ xout, int n, int iters, float stop2, float eps,
                    StepArgs sa) {
  __shared__ float hp[2][PCG_REG_MAX_N];
  __shared__ float part[4][PCG_THREADS];  // slots of p.Hp, r.z, r.r, b.b
  __shared__ float gpart[STEP == STEP_PLAIN ? 1 : GUARD_MAX_S][ROW_THREADS];  // the step's slots
  __shared__ float gtotal;
  __shared__ float gprime[STEP == STEP_FULL ? PCG_REG_MAX_N : 1];  // g' (STEP_FULL)
  __shared__ __align__(8) unsigned long long bar[2];
  Split split;
  split.start();
  const int q = (int)cg::this_cluster().block_rank();
  const long long o = blockIdx.x / PCG_CLUSTER;
  const int t = threadIdx.x, w = t / WARP, l = t % WARP;
  const int nr = (n + PCG_CLUSTER - 1) / PCG_CLUSTER;
  const int row0 = q * nr;
  const int nrows = max(0, min(nr, n - row0));
  const float* Hl = H + o * n * n;
  const float* bl = b + o * n;
  if (t == 0) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // peers are pushed to only once every block runs, its mbarriers set up
  cluster_arrive();
  // STEP_FULL: the trace and g' first, then H's rows raw into registers
  // (the plain variant's loads, all in flight at once: only the damping's
  // two constants stay live beside them), then Hd's entries in place
  Damp dm;
  float* terms = gpart[2];  // the trace's terms (two rows of slots: n <= 512)
  if constexpr (STEP == STEP_FULL) {
    dm = lm_damp(sa, H, o, n, gpart[0], &gtotal, terms);
    for (int i = t; i < n; i += PCG_THREADS) gprime[i] = dm.grad(__ldg(bl + i), i);
    __syncthreads();
  }
  split.mark(10);
  float a[PCG_REG_ROWS][PCG_REG_COLS];
#pragma unroll
  for (int e = 0; e < PCG_REG_ROWS; ++e) {
    const int lr = w + PCG_WARPS * e;
    const float* hr = Hl + (long long)(row0 + min(lr, max(nrows - 1, 0))) * n;
#pragma unroll
    for (int k = 0; k < PCG_REG_COLS; ++k) {
      const int j = l + WARP * k;
      a[e][k] = lr < nrows && j < n ? __ldg(hr + j) : 0.0f;
    }
  }
  if constexpr (STEP == STEP_FULL) {
#pragma unroll
    for (int e = 0; e < PCG_REG_ROWS; ++e) {
      const int i = row0 + w + PCG_WARPS * e;
#pragma unroll
      for (int k = 0; k < PCG_REG_COLS; ++k) {
        const int j = l + WARP * k;
        if (i - row0 < nrows && j < n) a[e][k] = i == j ? dm.from_term(terms[i]) : dm.off(a[e][k]);
      }
    }
  }
  auto diag = [&](int i) {
    if constexpr (STEP == STEP_FULL) return dm.from_term(terms[i]);
    return __ldg(Hl + (long long)i * n + i);
  };
  auto rhs = [&](int i) {
    if constexpr (STEP == STEP_FULL) return gprime[i];
    return __ldg(bl + i);
  };
  split.mark(9);
  float p[PCG_REG_COLS], r[PCG_REG_COLS], dinv[PCG_REG_COLS];
#pragma unroll
  for (int k = 0; k < PCG_REG_COLS; ++k) {
    const int j = l + WARP * k;
    dinv[k] = j < n ? __fdiv_rn(1.0f, diag(j)) : 0.0f;
    r[k] = j < n ? rhs(j) : 0.0f;     // b until the first product
    p[k] = __fmul_rn(r[k], dinv[k]);  // x = b dinv, the first product's vector
  }
  // the same values at i = t and t + 256 (columns k = w and w + 8 of the
  // arrays above, which an index by w would put in local memory): x and
  // the dots' slots
  float xs[2], rs[2] = {0.0f, 0.0f}, ps[2] = {0.0f, 0.0f}, ds[2], bs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = t + h * PCG_THREADS;
    ds[h] = i < n ? __fdiv_rn(1.0f, diag(i)) : 0.0f;
    bs[h] = i < n ? rhs(i) : 0.0f;
    xs[h] = __fmul_rn(bs[h], ds[h]);
  }
  // this lane's row (4 lanes a row) goes to blocks 2 c and 2 c + 1
  const int c = l % 4;
  const int er = l / 4, my_row = w + PCG_WARPS * er;
  const bool pushes = my_row < nrows;
  unsigned dst[2], dbar[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dst[h] = cluster_addr(smem_addr(&hp[0][row0 + my_row]), 2 * c + h);
    dbar[h] = cluster_addr(smem_addr(&bar[0]), 2 * c + h);
  }
  const unsigned tx = 4u * (unsigned)n;
  cluster_wait();

  // H v into buffer `buf` of every block; returns once this block has
  // all of it
  auto product = [&](const float (&v)[PCG_REG_COLS], int buf, unsigned parity) {
    float acc[PCG_REG_ROWS];
#pragma unroll
    for (int e = 0; e < PCG_REG_ROWS; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < PCG_REG_COLS; ++k) {
      if (l + WARP * k < n) {
#pragma unroll
        for (int e = 0; e < PCG_REG_ROWS; ++e) acc[e] = fmaf(a[e][k], v[k], acc[e]);
      }
    }
    // the xor tree of all 8 rows: at m = 16, 8, 4 a lane keeps half its rows
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool hi = l & 16;
      const float send = hi ? acc[h] : acc[h + 4];
      const float keep = hi ? acc[h + 4] : acc[h];
      acc[h] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool hi = l & 8;
      const float send = hi ? acc[h] : acc[h + 2];
      const float keep = hi ? acc[h + 2] : acc[h];
      acc[h] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
    }
    {
      const bool hi = l & 4;
      const float send = hi ? acc[0] : acc[1];
      const float keep = hi ? acc[1] : acc[0];
      acc[0] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
    }
    acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], 2));
    acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], 1));
    if (t == 0) mbar_expect(smem_addr(&bar[buf]), tx);
    if (pushes) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st_async(dst[h] + 4u * PCG_REG_MAX_N * buf, acc[0], dbar[h] + 8u * buf);
    }
    split.mark(1);
    mbar_wait(smem_addr(&bar[buf]), parity);
    split.mark(2);
  };

  // r = b - H x, z = r dinv, p = z; rz = r.z, stop from b.b, live from r.r
  split.mark(0);
  product(p, 0, 0);
#pragma unroll
  for (int k = 0; k < PCG_REG_COLS; ++k) {
    if (l + WARP * k < n) {
      r[k] = __fsub_rn(r[k], hp[0][l + WARP * k]);
      p[k] = __fmul_rn(r[k], dinv[k]);
    }
  }
  float c_rz = 0.0f, c_bb = 0.0f, c_rr = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = t + h * PCG_THREADS;
    if (i < n) {
      rs[h] = __fsub_rn(bs[h], hp[0][i]);
      ps[h] = __fmul_rn(rs[h], ds[h]);
      c_rz = __fadd_rn(c_rz, __fmul_rn(rs[h], ps[h]));
      c_bb = __fadd_rn(c_bb, __fmul_rn(bs[h], bs[h]));
      c_rr = __fadd_rn(c_rr, __fmul_rn(rs[h], rs[h]));
    }
  }
  part[1][t] = c_rz;
  part[2][t] = c_rr;
  part[3][t] = c_bb;
  __syncthreads();
  float rz, rr, bb;
  block_trees(part[1], part[2], rz, rr);
  bb = block_tree(part[3]);
  const float stop = __fadd_rn(__fmul_rn(stop2, bb), eps);
  bool live = rr > stop;
  split.mark(0);

  // the steps; every block leaves together
  for (int it = 0; it < iters && live; ++it) {
    const int buf = (it + 1) & 1;
    product(p, buf, ((it + 1) >> 1) & 1);
    const float* Hp = hp[buf];
    float cp = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (t + h * PCG_THREADS < n)
        cp = __fadd_rn(cp, __fmul_rn(ps[h], Hp[t + h * PCG_THREADS]));
    part[0][t] = cp;
    split.mark(3);
    __syncthreads();
    split.mark(4);
    const float al = __fdiv_rn(rz, __fadd_rn(block_tree(part[0]), eps));
    split.mark(5);
    c_rz = c_rr = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = t + h * PCG_THREADS;
      if (i < n) {
        xs[h] = __fadd_rn(xs[h], __fmul_rn(al, ps[h]));
        rs[h] = __fsub_rn(rs[h], __fmul_rn(al, Hp[i]));
        c_rz = __fadd_rn(c_rz, __fmul_rn(rs[h], __fmul_rn(rs[h], ds[h])));
        c_rr = __fadd_rn(c_rr, __fmul_rn(rs[h], rs[h]));
      }
    }
    part[1][t] = c_rz;
    part[2][t] = c_rr;
    split.mark(6);
#pragma unroll
    for (int k = 0; k < PCG_REG_COLS; ++k)
      if (l + WARP * k < n) r[k] = __fsub_rn(r[k], __fmul_rn(al, Hp[l + WARP * k]));
    __syncthreads();
    split.mark(7);
    float rz_new, rr;
    block_trees(part[1], part[2], rz_new, rr);
    const float beta = __fdiv_rn(rz_new, __fadd_rn(rz, eps));
#pragma unroll
    for (int k = 0; k < PCG_REG_COLS; ++k)
      p[k] = __fadd_rn(__fmul_rn(r[k], dinv[k]), __fmul_rn(beta, p[k]));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ps[h] = __fadd_rn(__fmul_rn(rs[h], ds[h]), __fmul_rn(beta, ps[h]));
    rz = rz_new;
    live = rr > stop;
    split.mark(8);
    split.step();
  }
  if constexpr (STEP == STEP_PLAIN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = t + h * PCG_THREADS;
      if (i >= row0 && i < row0 + nrows) xout[o * n + i] = xs[h];
    }
  }
  // no block leaves while a peer may still push into it
  cluster_arrive();
  cluster_wait();
  if constexpr (STEP != STEP_PLAIN) {
    // every block: its replica of x is the lane's; the guard shared over
    // the cluster (block q the sums k = q, q + 8, ...)
    float* d = hp[0];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (t + h * PCG_THREADS < n) d[t + h * PCG_THREADS] = -xs[h];
    if constexpr (STEP == STEP_FULL)
      step_guard_lane(sa, o, n, d, 0, SharedGrad{gprime}, gpart, &gtotal, split, q, PCG_CLUSTER);
    else
      step_guard_lane(sa, o, n, d, 0, step_grad<STEP>(sa, b, o, n), gpart, &gtotal, split, q,
                      PCG_CLUSTER);
  }
  split.finish();
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
// Routes (sdsm_lane_chol_route, from n and B; the order and so the bits
// from n alone): this kernel, one block a lane, for n <= CHOL_ONE_BLOCK_MAX_N
// (32), and up to n = CHOL_MANY_LANES_MAX_N (128) when a batch has more
// lanes than the card holds clusters at once, in shared memory; above it
// the cluster routes (lane_cholesky_cluster_kernel, below).
//
// Work split: one block a lane, its thread count chosen from n (which
// thread updates an entry does not change the entry's order). The lower
// triangle is packed by columns (column k, rows k..n-1, at k n - k (k + 1)
// / 2 + i). It lives, with L_jj, b, y and two buffers of a scaled column,
// in shared memory.
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
// column suffices. The back substitution runs in warp 0: lane l holds y_i
// for i % 32 == l in registers and y_j comes by a shuffle.
//
// What bounds it: n dependent phases, each a block barrier and a square
// root and divisions on warp 0's path, and, at the first columns, the
// issue of the updates (a load, two conversions, a float64 fused
// multiply-add, a store): latency and issue, not bytes or the arithmetic
// rate. One block a lane leaves most of the card idle at few lanes and
// takes n barriers; the cluster routes take n / 8.

// Floats of a lane's work space: the packed lower triangle, L_jj, b, y
// and the scaled column (two).
__host__ __device__ constexpr long long chol_floats(long long n) {
  return n * (n + 1) / 2 + 5 * n;
}

static_assert(4 * chol_floats(CHOL_MANY_LANES_MAX_N) <= CHOL_SMEM_BYTES,
              "the one-block route's work space fits shared memory");

// Registers of a lane of the back substitution in shared memory: y_i for
// i = l, l + 32, ... < CHOL_MANY_LANES_MAX_N.
constexpr int CHOL_BACK_REGS = (CHOL_MANY_LANES_MAX_N + WARP - 1) / WARP;

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

// lane_cholesky_kernel's back substitution, in warp 0: x from L (packed in
// a), L_jj (d) and y; out[j] = -x_j (the direction, in device memory or,
// for the step variants, in shared memory).
__device__ __forceinline__ void chol_back_one_block(const float* a, const float* d,
                                                    const float* y, int n, float* out) {
  const int l = threadIdx.x % WARP;
  auto col0 = [n](int k) { return k * n - k * (k + 1) / 2; };
  // lane l holds y_i of i = l + 32 u in registers; y_j comes from its lane
  // by a shuffle
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
    if (l == j % WARP) out[j] = -xj;
  }
}

// STEP (STEP_GUARD, STEP_FULL): the step variants (see above lane_pcg),
// with GUARD_FLOATS more floats of dynamic shared memory after the work
// space (the trace's and the guard's slots); the direction goes to the
// guard in shared memory (the scaled columns' buffers), not to `out`. A
// failed lane's guard takes the gradient step.
template <int STEP>
__global__ void __launch_bounds__(CHOL_MAX_THREADS)
lane_cholesky_kernel(const float* __restrict__ H, const float* __restrict__ g,
                     float* __restrict__ out, int n, StepArgs sa) {
  extern __shared__ __align__(16) float smem[];
  Split split;
  split.start();
  const long long o = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int l = t % WARP, w = t / WARP, W = T / WARP;
  float* a = smem;
  float* d = a + n * (n + 1) / 2;  // L_jj
  float* b = d + n;
  float* y = b + n;
  float* lbuf = y + n;  // the scaled column j at lbuf + (j % 2) n
  auto gpart = reinterpret_cast<float (*)[ROW_THREADS]>(lbuf + 2 * n);  // STEP's slots
  float* gtotal = gpart[GUARD_MAX_S];
  Damp dm;  // the trace's terms in d (L_jj, written after the loads)
  if constexpr (STEP == STEP_FULL) dm = lm_damp(sa, H, o, n, gpart[0], gtotal, d);
  split.mark(10);
  // entry (i, k), i >= k, of the triangle packed by columns
  auto col0 = [n](int k) { return k * n - k * (k + 1) / 2; };
  const float* Hl = H + o * n * n;
  for (int i = w; i < n; i += W) {  // row i of Hd, read coalesced
#pragma unroll 4
    for (int k = l; k <= i; k += WARP) {
      const float h = __ldg(Hl + (long long)i * n + k);
      if constexpr (STEP == STEP_FULL) a[col0(k) + i] = i == k ? dm.from_term(d[i]) : dm.off(h);
      else a[col0(k) + i] = h;
    }
  }
  for (int i = t; i < n; i += T) {
    const float gi = __ldg(g + o * n + i);
    b[i] = STEP == STEP_FULL ? dm.grad(gi, i) : gi;
  }
  __syncthreads();
  split.mark(0);
  {
    const float d0 = __fsqrt_rn(a[0]);
    if (t == 0) {
      d[0] = d0;
      y[0] = __fdiv_rn(b[0], d0);
    }
    for (int i = 1 + t; i < n; i += T) lbuf[i] = __fdiv_rn(a[i], d0);
  }
  __syncthreads();
  int fail = 0;
  for (int j = 0; j < n; ++j) {
    float* cj = a + col0(j);
    if (!(cj[j] > 0.0f)) {  // the same value in every thread: all leave here
      if constexpr (STEP == STEP_PLAIN) {
        for (int i = t; i < n; i += T) out[o * n + i] = __int_as_float(0x7fc00000);
        return;
      }
      fail = 1;
      break;
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
  split.mark(3);
  if (w == 0 && !fail) chol_back_one_block(a, d, y, n, STEP == STEP_PLAIN ? out + o * n : lbuf);
  if constexpr (STEP != STEP_PLAIN) {
    __syncthreads();
    split.mark(5);
    step_guard_lane(sa, o, n, lbuf, fail, step_grad<STEP>(sa, g, o, n), gpart, gtotal, split);
  }
  split.finish();
}

// ---------------------------------------------------------------------------
// lane_cholesky's cluster routes: the same order, split over a cluster of
// C blocks a lane and blocked into panels of CHOL_PW = 8 columns. C =
// CHOL_CLUSTER = 8 for CHOL_ONE_BLOCK_MAX_N < n <= CHOL_CLUSTER_MAX_N (but
// n <= 128 at more lanes than the card holds clusters at once:
// sdsm_lane_chol_route); C = CHOL_WIDE_CLUSTER = 16 above, a non-portable
// cluster size (launched through cudaLaunchKernelEx after the opt-in
// attribute; each cluster needs 16 free SMs of one GPC, and the lanes run
// in waves when the card holds fewer clusters than lanes), with the own
// panels in shared memory up to CHOL_WIDE_MAX_N and in the lane's global
// scratch above (GLOBAL: n = 2048, the largest DSM bucket, and every n
// whose panels no cluster holds).
//
// The forward substitution is the factor of one more row: b is row n of
// the augmented lower triangle (its update b_k - y_j L_kj is a_nk - l_nj
// l_kj with l_nj = b_j / L_jj = y_j, the same operations on the same
// values), so each column k holds rows k .. n and ends with y_k.
//
// Work split: panel r (columns r PW .. r PW + PW - 1, rows r PW .. n, a
// dense (n + 1 - r PW) x PW block, row-major, its upper corner unused)
// belongs to block r % C for the whole launch, in its shared memory or,
// with GLOBAL, in the panel's slot of the lane's scratch, where its owner
// publishes it (a working copy no other block reads before it is
// published there, in place). Its owner factors it: warp 0 the diagonal
// PW x PW block (a lane a row, the pivot and the scaled entries by
// shuffles), releasing each column to the other warps through a named
// barrier; each of those solves its rows below (a thread a row, in passes
// of CHOL_ROWS rows a thread: the first pass takes each column as warp 0
// releases it, later passes, at n > 967, find them all released) against
// the columns as they come. The owner publishes the panel (float32, as it
// is) into the lane's scratch in global memory, and one cluster barrier a
// panel orders that before every block reads it back, widens it to
// float64 once (in shared memory, or with GLOBAL in a slot of the scratch
// a block) and applies the panel's PW updates to each entry of its own
// later panels, the entry held in a register between them and rounded to
// float32 after each (chol_update): one load and store an entry a panel,
// where the one-block route takes one a column. Lookahead: the owner of
// panel p + 1 applies panel p to that panel first, factors and publishes
// it before it updates its other panels, and every other block arrives at
// the next barrier as soon as it has read panel p (barrier.cluster.arrive
// / wait split), so the chain of panels waits on factoring, not on the
// trailing updates. The scratch keeps every panel (the back substitution
// reads them all), so no slot of it is written by two blocks. Every entry
// takes the updates j = 0, 1, ... in order, and every L_jj, L_ij and y_j
// comes from the same __fsqrt_rn / __fdiv_rn, whichever block or thread
// computes it: the bits of the one-block route and of lane.cholesky_chain,
// at every C and wherever the panels live.
//
// Failure: the owner of panel p writes whether its pivot failed into every
// block (flag[p]) before the barrier after which all of them read it; on a
// failure every block writes NaN into its own columns and all leave after
// that same barrier, so no block waits at a barrier that a peer has left.
//
// The back substitution runs in block 0 alone, from the published panels
// (see there).
//
// What bounds it: latency, and above n ~ 800 the conversions. Every panel
// waits on a cluster barrier, the panel read back from L2, warp 0's PW
// pivots (each a shuffle, a square root, a division and an update in
// sequence) and the rows' last column; the back substitution on n
// dependent divisions and updates in one warp. The updates' two float32
// <-> float64 conversions each (16 a clock an SM on sm_90, a quarter of
// the float64 FMA rate; some n^3 / 6 a lane, over C SMs: n^3 / (96 C)
// clocks, some 0.8 ms at n = 1024 and 6 ms at n = 2048 on 16 SMs at 1.75
// GHz) bound the first panels' trailing updates, and at n = 2048 most of
// the launch. With GLOBAL the own panels' loads and stores (some n^3 / 48
// entries a lane) go through L2 from 16 SMs.

__host__ __device__ constexpr long long chol_panel_rows(long long n, long long r) {
  return n + 1 - r * CHOL_PW;
}

// Floats of block 0's panels (r = 0, C, 2 C, ...), the most any block holds.
__host__ __device__ constexpr long long chol_cluster_panel_floats(long long n, int C) {
  long long s = 0;
  for (long long r = 0; r * CHOL_PW < n; r += C) s += chol_panel_rows(n, r) * CHOL_PW;
  return s;
}

// Shared memory of a block of a cluster route: the applied panel widened
// ((n + 1) x PW doubles) and the own panels (both in the scratch with
// GLOBAL), the diagonal block's L (PW x PW doubles), L_jj (n) and flags
// (one a panel, and one); at least the back substitution's x, the group's
// y and the y held in shared memory (n, 32 and n floats at most).
__host__ __device__ constexpr long long chol_cluster_bytes(long long n, int C, bool global) {
  const long long fwd =
      8 * ((global ? 0 : (n + 1) * CHOL_PW) + CHOL_PW * CHOL_PW) +
      4 * ((global ? 0 : chol_cluster_panel_floats(n, C)) + n + (n + CHOL_PW - 1) / CHOL_PW + 1);
  const long long back = 4 * ((n + 3) / 4 * 4 + WARP + n);
  return fwd > back ? fwd : back;
}

// Shared memory of a block of a cluster route's variant STEP: at least the
// guard's direction and slots (block 0, after the back substitution).
__host__ __device__ constexpr long long chol_step_bytes(long long n, int C, bool global, int step) {
  const long long b = chol_cluster_bytes(n, C, global);
  const long long guard = step == STEP_PLAIN ? 0 : 4 * ((n + 3) / 4 * 4 + GUARD_FLOATS);
  return b > guard ? b : guard;
}

// The largest n whose panels a cluster of C blocks holds in shared memory.
constexpr int chol_cluster_max_n(int C) {
  int n = 1;
  while (chol_cluster_bytes(n + 1, C, false) <= CHOL_SMEM_BYTES) ++n;
  return n;
}

constexpr int CHOL_CLUSTER_MAX_N = chol_cluster_max_n(CHOL_CLUSTER);
constexpr int CHOL_WIDE_MAX_N = chol_cluster_max_n(CHOL_WIDE_CLUSTER);

// A lane's published panels in the scratch: panel p's rows p PW .. n from
// chol_pub_offset(n, p) on, in the layout of its owner's copy.
__host__ __device__ constexpr long long chol_pub_offset(long long n, long long p) {
  return CHOL_PW * (p * (n + 1) - CHOL_PW * p * (p - 1) / 2);
}

__host__ __device__ constexpr long long chol_pub_floats(long long n) {
  return chol_pub_offset(n, (n + CHOL_PW - 1) / CHOL_PW);
}

// Floats of a lane's scratch on a cluster route: the published panels and,
// with GLOBAL, a widened panel ((n + 1) x PW doubles) a block after them.
__host__ __device__ constexpr long long chol_scratch_floats(long long n, int C, bool global) {
  return chol_pub_floats(n) + (global ? 2LL * C * (n + 1) * CHOL_PW : 0);
}

// Threads of a block of a cluster route that factor rows below a panel's
// diagonal block (every warp but warp 0, which factors the block), and the
// rows a thread takes in a pass (one pass up to n = CHOL_CLUSTER_MAX_N).
constexpr int CHOL_ROW_THREADS = CHOL_MAX_THREADS - WARP;
constexpr int CHOL_ROWS = (CHOL_CLUSTER_MAX_N + 1 - CHOL_PW + CHOL_ROW_THREADS - 1) / CHOL_ROW_THREADS;
static_assert(CHOL_PW == 8 && CHOL_ROWS == 2, "panel layout and registers sized for this");
static_assert(CHOL_CLUSTER_MAX_N + 1 - CHOL_PW <= CHOL_ROWS * CHOL_ROW_THREADS,
              "the route of 8 blocks takes the rows below a diagonal block in one pass");
// Rows below a group of 32 that a thread of the back substitution holds
// in registers, and the rows they cover (the rest in shared memory).
constexpr int CHOL_BACK_COLS = 2;
constexpr int CHOL_BACK_ROWS = CHOL_BACK_COLS * CHOL_ROW_THREADS;
static_assert(CHOL_CLUSTER_MAX_N <= CHOL_BACK_ROWS,
              "the route of 8 blocks holds every row of its back substitution in registers");

// a's PW entries take the PW updates of the panel widened in lw: the row's
// L at li, the columns' at lw + k0 PW (kn of them), j in order.
__device__ __forceinline__ void chol_apply_row(float (&v)[CHOL_PW], const double* li,
                                               const double* lk, int kn) {
  double l[CHOL_PW];
#pragma unroll
  for (int j = 0; j < CHOL_PW; ++j) l[j] = li[j];
#pragma unroll
  for (int j = 0; j < CHOL_PW; ++j) {
#pragma unroll
    for (int m = 0; m < CHOL_PW; ++m)
      if (m < kn) v[m] = chol_update(v[m], l[j], lk[m * CHOL_PW + j]);
  }
}

__device__ __forceinline__ void chol_load_row(float (&v)[CHOL_PW], const float* a) {
#pragma unroll
  for (int c = 0; c < CHOL_PW; c += 4) {
    const float4 u = *reinterpret_cast<const float4*>(a + c);
    v[c] = u.x, v[c + 1] = u.y, v[c + 2] = u.z, v[c + 3] = u.w;
  }
}

__device__ __forceinline__ void chol_store_row(float* a, const float (&v)[CHOL_PW]) {
#pragma unroll
  for (int c = 0; c < CHOL_PW; c += 4)
    *reinterpret_cast<float4*>(a + c) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
}

// H (B, n, n), g (B, n) -> out (B, n); grid B C blocks of CHOL_MAX_THREADS,
// one cluster of C a lane (a launch attribute); dynamic shared memory
// chol_step_bytes(n, C, GLOBAL, STEP); scratch chol_scratch_floats(n, C,
// GLOBAL) floats a lane. Stamps (chip_smoke.py --split): 0 H loaded, 1 the
// waits at the cluster barrier, 2 the read-back of the published panel, 3
// factoring own panels, 4 the trailing updates, 5 the back substitution;
// the step variants' 10 the trace, 11 the guard and 12 its regularizer sums.
//
// STEP (STEP_GUARD, STEP_FULL), the step variants (see above lane_pcg):
// with STEP_FULL every block computes its lane's trace (n loads of H's
// diagonal, the slots in the first floats of its shared memory, which no
// other phase uses yet) and loads its panels as the damped system's
// entries, the augmented row as g'; block 0 runs the guard after the back
// substitution, on x negated in place in shared memory (its slots where the
// back substitution's y was), and on a failed lane after the barrier at
// which every block reads the failure (no peer writes into it after that
// barrier), where it takes the gradient step; no block writes `out`.
template <int C, bool GLOBAL, int STEP>
__global__ void __launch_bounds__(CHOL_MAX_THREADS, 1)
lane_cholesky_cluster_kernel(const float* __restrict__ H, const float* __restrict__ g,
                             float* __restrict__ out, float* __restrict__ scratch, int n,
                             StepArgs sa) {
  constexpr int PW = CHOL_PW;
  // only the routes of 16 blocks take n past one pass of rows below a
  // diagonal block and past the rows the back substitution holds in
  // registers
  constexpr bool WIDE = C > CHOL_CLUSTER;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const long long o = blockIdx.x / C;
  const int t = threadIdx.x, T = CHOL_MAX_THREADS;
  const int l = t % WARP, w = t / WARP;
  const int rows = n + 1;
  const int P = (n + PW - 1) / PW;
  Split split;
  split.start();
  float* pub = scratch + o * chol_scratch_floats(n, C, GLOBAL);  // the published panels
  // the applied panel's L, row i at i PW
  double* lw = GLOBAL ? reinterpret_cast<double*>(pub + chol_pub_floats(n)) + (long long)q * rows * PW
                      : reinterpret_cast<double*>(smem);
  // the diagonal block's L, (m, j) at m PW + j
  double* ld = GLOBAL ? reinterpret_cast<double*>(smem) : lw + (long long)rows * PW;
  float* A = reinterpret_cast<float*>(ld + PW * PW);  // the own panels in shared memory
  float* dg = GLOBAL ? A : A + chol_cluster_panel_floats(n, C);  // L_jj of the own columns
  int* flag = reinterpret_cast<int*>(dg + n);  // [p]: panel p failed; [P]: local
  // own panel r (r % C == q): its m-th, after the m before it; with GLOBAL
  // its published slot
  auto panel = [&](int r) {
    if (GLOBAL) return pub + chol_pub_offset(n, r);
    const long long m = (r - q) / C;
    return A + PW * (m * rows - PW * (q * m + C * m * (m - 1) / 2));
  };
  auto width = [&](int r) { return min(PW, n - r * PW); };

  // peers may be written only once every block of the cluster runs
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the trace's slots in the first floats of shared memory, its terms in the
  // widened panel's place after them (shared or global), both unused yet
  float* terms = reinterpret_cast<float*>(lw) + ROW_THREADS + 4;
  Damp dm;
  if constexpr (STEP == STEP_FULL) dm = lm_damp(sa, H, o, n, smem, smem + ROW_THREADS, terms);
  split.mark(10);
  const float* Hl = H + o * n * n;
  for (int r = q; r < P; r += C) {
    float* a = panel(r);
    const int c0 = r * PW;
    const int count = (rows - c0) * PW;
    for (int f = t; f < count; f += T) {
      const int i = c0 + f / PW, k = c0 + f % PW;
      float v = 0.0f;
      if (k < n && i >= k) {
        if (i < n) {
          if constexpr (STEP == STEP_FULL) {
            v = i == k ? dm.from_term(terms[i]) : dm.off(__ldg(Hl + (long long)i * n + k));
          } else {
            v = __ldg(Hl + (long long)i * n + k);
          }
        } else {
          v = __ldg(g + o * n + k);
          if (STEP == STEP_FULL) v = dm.grad(v, k);
        }
      }
      a[f] = v;
    }
  }
  __syncthreads();
  split.mark(0);
  cluster_wait();
  split.mark(1);

  // Own panel p, whose entries have the updates j < (p - 1) PW, takes panel
  // p - 1's (in lw; none for p = 0) and is factored and published. Warp 0:
  // the diagonal block, each column j released to the other warps through
  // named barrier 1 + j.
  auto diag = [&](int p) {
    float* a = panel(p);
    const int c0 = p * PW, wd = width(p);
    {
      if (p > 0) {  // the diagonal block's updates: four lanes a row, two columns each
        const int r = l >> 2, c = 2 * (l & 3);
        if (r < wd) {
          float2* e = reinterpret_cast<float2*>(a + r * PW + c);
          float2 u = *e;
          const double* li = lw + (c0 + r) * PW;
          const double* lk = lw + (long long)min(c0 + c, n - 1) * PW;
          const double* lk1 = lw + (long long)min(c0 + c + 1, n - 1) * PW;
#pragma unroll
          for (int j = 0; j < PW; ++j) {
            const double lij = li[j];
            u.x = chol_update(u.x, lij, lk[j]);
            u.y = chol_update(u.y, lij, lk1[j]);
          }
          *e = u;
        }
        __syncwarp();
      }
      // lane l holds row c0 + l; column j's pivot and l_lj by shuffles
      float v[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c) v[c] = l < wd ? a[l * PW + c] : 0.0f;
      bool ok = true;
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        if (j < wd) {
          // the pivot in every lane (a square root or division of another
          // lane's value could take the slow path for the whole warp)
          const float piv = __shfl_sync(0xffffffffu, v[j], j);
          ok = ok && piv > 0.0f;  // a NaN fails
          const float dj = __fsqrt_rn(piv);
          const float lj = __fdiv_rn(l > j && l < wd ? v[j] : piv, dj);
          const double ljd = (double)lj;
          if (l == j) dg[c0 + j] = dj;
          if (l > j && l < wd) ld[l * PW + j] = ljd;
          named_arrive(1 + j, T);
          v[j] = l > j ? lj : dj;
#pragma unroll
          for (int m = j + 1; m < PW; ++m) {
            const double lm = __shfl_sync(0xffffffffu, ljd, m);
            if (m < wd && l >= m) v[m] = chol_update(v[m], ljd, lm);
          }
        }
      }
      if (l < wd) {
        if (!GLOBAL) {  // with GLOBAL the published row below is the panel's own
#pragma unroll
          for (int c = 0; c < PW; ++c)
            if (c <= l) a[l * PW + c] = v[c];
        }
#pragma unroll
        for (int c = 0; c < PW; c += 4)
          __stcg(reinterpret_cast<float4*>(pub + chol_pub_offset(n, p) + l * PW + c),
                 make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]));
      }
      if (l == 0) flag[P] = !ok;
    }
  };
  // The other warps: the rows below it, CHOL_ROWS a thread a pass, each
  // column as warp 0 releases it (in the first pass; later passes find
  // every column released).
  auto rows_below = [&](int p) {
    float* a = panel(p);
    const int c0 = p * PW, wd = width(p), below = rows - c0 - wd;
    for (int f0 = 0; f0 == 0 || (WIDE && f0 < below); f0 += CHOL_ROWS * CHOL_ROW_THREADS) {
      float v[CHOL_ROWS][PW];
      int ir[CHOL_ROWS];
#pragma unroll
      for (int u = 0; u < CHOL_ROWS; ++u) {
        const int f = f0 + t - WARP + u * CHOL_ROW_THREADS;
        ir[u] = f < below ? c0 + wd + f : -1;
        if (ir[u] >= 0) {
          chol_load_row(v[u], a + (ir[u] - c0) * PW);
          if (p > 0) chol_apply_row(v[u], lw + (long long)ir[u] * PW, lw + (long long)c0 * PW, wd);
        }
      }
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        if (j < wd) {
          if (f0 == 0) named_sync(1 + j, T);
          const float dj = dg[c0 + j];
#pragma unroll
          for (int u = 0; u < CHOL_ROWS; ++u) {
            if (ir[u] >= 0) {
              v[u][j] = __fdiv_rn(v[u][j], dj);
              const double lj = (double)v[u][j];
#pragma unroll
              for (int m = j + 1; m < PW; ++m)
                if (m < wd) v[u][m] = chol_update(v[u][m], lj, ld[m * PW + j]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < CHOL_ROWS; ++u) {
        if (ir[u] >= 0) {
          if (!GLOBAL) chol_store_row(a + (ir[u] - c0) * PW, v[u]);
#pragma unroll
          for (int c = 0; c < PW; c += 4) {
            const float4 e = make_float4(v[u][c], v[u][c + 1], v[u][c + 2], v[u][c + 3]);
            __stcg(reinterpret_cast<float4*>(pub + chol_pub_offset(n, p) + (ir[u] - c0) * PW + c), e);
          }
        }
      }
    }
  };
  // the end of panel p: its flag into every block
  auto finish = [&](int p) {
    __syncthreads();
    if (t < C) *cluster.map_shared_rank(flag + p, t) = flag[P];
  };

  // Applies panel p (widened in lw) to the rows of own panels r_lo, r_lo +
  // C, ... < r_hi: entry (i, k) takes a_ik - l_ij l_kj for the panel's j in
  // order; threads over (panel, row) pairs.
  auto apply = [&](int r_lo, int r_hi) {
    int f = t, base = 0;
    for (int r = r_lo; r < r_hi; r += C) {
      const int c0 = r * PW, wd = width(r);
      const int cnt = rows - c0;
      float* a = panel(r);
      for (; f < base + cnt; f += T) {
        float* ar = a + (f - base) * PW;
        float v[PW];
        chol_load_row(v, ar);
        chol_apply_row(v, lw + (long long)(c0 + f - base) * PW, lw + (long long)c0 * PW, wd);
        chol_store_row(ar, v);
      }
      base += cnt;
    }
  };

  auto fail_out = [&]() {
    for (int r = q; r < P; r += C)
      for (int c = t; c < width(r); c += T) out[o * n + r * PW + c] = __int_as_float(0x7fc00000);
  };
  // the step variants' guard in block 0 (d: the direction, n4 floats from
  // smem; its slots after it)
  const int n4 = (n + 3) / 4 * 4;
  auto guard = [&](int fail) {
    auto gpart = reinterpret_cast<float (*)[ROW_THREADS]>(smem + n4);
    step_guard_lane(sa, o, n, smem, fail, step_grad<STEP>(sa, g, o, n), gpart,
                    gpart[GUARD_MAX_S], split);
  };

  // panel p's rows below its diagonal block, from the scratch, widened into lw
  auto widen = [&](int p) {
    const int lo = (p + 1) * PW;
    const float4* src = reinterpret_cast<const float4*>(pub + chol_pub_offset(n, p) + PW * PW);
    for (int f = t; f < (rows - lo) * PW / 4; f += T) {
      const float4 u = __ldcg(src + f);
      double2* d = reinterpret_cast<double2*>(lw + (long long)lo * PW + 4 * f);
      d[0] = make_double2(u.x, u.y);
      d[1] = make_double2(u.z, u.w);
    }
  };

  // own panel p, factored and published
  auto advance = [&](int p) {
    if (w == 0) diag(p);
    else rows_below(p);
    finish(p);
  };

  // forward: one cluster barrier a panel, after which every block reads
  // whether panel p failed and widens it; the owner of panel p + 1 applies
  // it there and factors that panel first (lookahead), and every other
  // block arrives at the next barrier as soon as it has read the panel
  if (q == 0) advance(0);
  split.mark(3);
  cluster_arrive();
  for (int p = 0;; ++p) {
    cluster_wait();
    split.mark(1);
    if (flag[p]) {  // every block reads it after the same barrier
      if constexpr (STEP == STEP_PLAIN) {
        fail_out();
      } else if (q == 0) {
        __syncthreads();  // every thread has read the flag that the guard overlays
        guard(1);
      }
      split.finish();
      return;
    }
    if (p == P - 1) break;
    widen(p);
    __syncthreads();
    split.mark(2);
    const bool next = (p + 1) % C == q;
    if (next) advance(p + 1);
    split.mark(3);
    cluster_arrive();
    // own panels after p (after p + 1 when this block factored it)
    apply(p + 1 + ((q - p - 1) % C + C) % C + (next ? C : 0), P);
    __syncthreads();  // lw is rewritten in the next step
    split.mark(4);
    split.step();
  }

  // Back substitution, in block 0 alone, from L, its diagonal and y in the
  // published panels (nothing is read from or written into a peer after the
  // last barrier: the others leave). Columns in groups of 32 from the last:
  // warp 0 holds the group's y (lane l: column g0 + l) and solves it, x_j
  // by a shuffle from the lane holding y_j and L_jj, releasing its x eight
  // columns at a time (named barriers 1 to 4) to the other warps, which
  // hold the y of the columns below (CHOL_BACK_COLS a thread in registers,
  // the rows from CHOL_BACK_ROWS on in shared memory, each row owned by one
  // thread) and apply them in order, j descending; at a group's start the
  // threads holding its columns in registers hand their y to warp 0.
  if (q != 0) {
    split.finish();
    return;
  }
  __syncthreads();  // every thread has read the flags that x and y overlay
  float* xsh = smem;                    // x_j
  float* ysh = smem + (n + 3) / 4 * 4;  // the group's y, handed to warp 0
  float* ysm = ysh + WARP;              // y_i of the rows i >= CHOL_BACK_ROWS
  auto at = [&](int i, int j) {  // L_ji (j >= i); y_i at j = n
    const int r = i / PW;
    return pub + chol_pub_offset(n, r) + (j - r * PW) * PW + i % PW;
  };
  float yb[CHOL_BACK_COLS];
  const float* lb[CHOL_BACK_COLS];
  int ib[CHOL_BACK_COLS];
#pragma unroll
  for (int u = 0; u < CHOL_BACK_COLS; ++u) {
    ib[u] = w == 0 ? n : t - WARP + u * CHOL_ROW_THREADS;
    lb[u] = at(min(ib[u], n - 1), 0);
    yb[u] = ib[u] < n ? __ldcg(lb[u] + PW * n) : 0.0f;
  }
  for (int i = CHOL_BACK_ROWS + t; i < n; i += T) ysm[i - CHOL_BACK_ROWS] = __ldcg(at(i, n));
  for (int g0 = (n - 1) / WARP * WARP; g0 >= 0; g0 -= WARP) {
#pragma unroll
    for (int u = 0; u < CHOL_BACK_COLS; ++u)
      if (ib[u] >= g0 && ib[u] < g0 + WARP) ysh[ib[u] - g0] = yb[u];
    __syncthreads();
    if (w == 0) {
      const int i = g0 + l;
      const float* li = at(min(i, n - 1), 0);
      float lv[WARP];  // L_ji of the group's columns j, loaded ahead
#pragma unroll
      for (int k = 0; k < WARP; ++k) lv[k] = i < g0 + k && g0 + k < n ? __ldcg(li + PW * (g0 + k)) : 0.0f;
      const float di = i < n ? __ldcg(li + PW * i) : 1.0f;  // L_ii
      float y = i >= n ? 0.0f : i < CHOL_BACK_ROWS ? ysh[l] : ysm[i - CHOL_BACK_ROWS];
#pragma unroll
      for (int c = 0; c < WARP / PW; ++c) {
#pragma unroll
        for (int k = WARP - 1 - PW * c; k >= WARP - PW * (c + 1); --k) {
          if (g0 + k < n) {
            // lane k holds y_j and L_jj
            const float xj = __shfl_sync(0xffffffffu, __fdiv_rn(y, di), k);
            if (l < k) y = chol_update(y, (double)lv[k], (double)xj);
            if (l == k) {
              xsh[g0 + k] = xj;
              if (STEP == STEP_PLAIN) out[o * n + g0 + k] = -xj;
            }
          }
        }
        named_arrive(1 + c, T);
      }
    } else {
#pragma unroll
      for (int c = 0; c < WARP / PW; ++c) {
        const int j0 = g0 + WARP - PW * (c + 1);  // this release's columns j0 .. j0 + PW - 1
        float lv[CHOL_BACK_COLS][PW];
#pragma unroll
        for (int u = 0; u < CHOL_BACK_COLS; ++u)
#pragma unroll
          for (int k = 0; k < PW; ++k)
            lv[u][k] = ib[u] < g0 && j0 + k < n ? __ldcg(lb[u] + PW * (j0 + k)) : 0.0f;
        named_sync(1 + c, T);
#pragma unroll
        for (int u = 0; u < CHOL_BACK_COLS; ++u) {
          if (ib[u] < g0) {
#pragma unroll
            for (int k = PW - 1; k >= 0; --k)
              if (j0 + k < n) yb[u] = chol_update(yb[u], (double)lv[u][k], (double)xsh[j0 + k]);
          }
        }
        // the rows from CHOL_BACK_ROWS on below the group (n > 992 only:
        // the routes of 16 blocks), CHOL_BACK_COLS a thread at a time
        if (WIDE) {
          for (int i0 = t - WARP + CHOL_BACK_ROWS; i0 < g0; i0 += CHOL_BACK_ROWS) {
#pragma unroll
            for (int u = 0; u < CHOL_BACK_COLS; ++u) {
              const int i = i0 + u * CHOL_ROW_THREADS;
              const float* li = at(min(i, n - 1), 0);
#pragma unroll
              for (int k = 0; k < PW; ++k)
                lv[u][k] = i < g0 && j0 + k < n ? __ldcg(li + PW * (j0 + k)) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < CHOL_BACK_COLS; ++u) {
              const int i = i0 + u * CHOL_ROW_THREADS;
              if (i < g0) {
                float y = ysm[i - CHOL_BACK_ROWS];
#pragma unroll
                for (int k = PW - 1; k >= 0; --k)
                  if (j0 + k < n) y = chol_update(y, (double)lv[u][k], (double)xsh[j0 + k]);
                ysm[i - CHOL_BACK_ROWS] = y;
              }
            }
          }
        }
      }
    }
  }
  split.mark(5);
  if constexpr (STEP != STEP_PLAIN) {
    __syncthreads();
    for (int i = t; i < n; i += T) xsh[i] = -xsh[i];  // the direction
    guard(0);
  }
  split.finish();
}


// ---------------------------------------------------------------------------
// The two ends of a Newton step as kernels of their own (see the device
// functions above lane_pcg for their arithmetic).

// Hd = H + diag(reg_h) + (mu scale_h) I and g' = (g + reg_g) * [1, kmask]
// for a lane (Damp; at n <= 6 no regularizer: g is left alone). A block
// writes LM_ROWS rows of one lane's Hd; each recomputes the lane's scale_h
// over the n diagonal entries in lane_sum's order (lm_damp), which needs no
// second launch and no grid-wide barrier. Row tile 0 writes g'. Bytes
// bound it (one read of H, one write of Hd).
__global__ void __launch_bounds__(ROW_THREADS)
lane_lm_system_kernel(StepArgs sa, const float* __restrict__ g, const float* __restrict__ H,
                      float* __restrict__ g_out, float* __restrict__ Hd, int n, int tiles) {
  __shared__ float part[ROW_THREADS];
  __shared__ float total;
  const long long o = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int t = threadIdx.x;
  const Damp dm = lm_damp(sa, H, o, n, part, &total);
  const float* h = H + o * n * n;
  float* hd = Hd + o * n * n;
  // column j of the tile's rows: all LM_ROWS loads issued before the first
  // store (a thread's loads in flight, not one after another)
  const int i0 = tile * LM_ROWS;
  for (int j = t; j < n; j += ROW_THREADS) {
    float v[LM_ROWS];
#pragma unroll
    for (int r = 0; r < LM_ROWS; ++r)
      v[r] = i0 + r < n ? __ldg(h + (long long)(i0 + r) * n + j) : 0.0f;
#pragma unroll
    for (int r = 0; r < LM_ROWS; ++r) {
      const int i = i0 + r;
      if (i >= n) break;
      hd[(long long)i * n + j] = dm.at(v[r], i, j);
    }
  }
  if (tile == 0 && dm.reg) {
    for (int i = t; i < n; i += ROW_THREADS) g_out[o * n + i] = dm.grad(__ldg(g + o * n + i), i);
  }
}

// The guard of a Newton direction and what the line search needs of it,
// for one lane a block (step_guard_lane): the direction dir (-dir with
// `negate`: PCG's solution) read into dynamic shared memory (n floats: the
// regularizer's terms read entries 6 + i that other threads loaded). Its
// launch and four dependent block trees bound it.
__global__ void __launch_bounds__(ROW_THREADS)
lane_step_guard_kernel(StepArgs sa, const float* __restrict__ dir, const float* __restrict__ g,
                       int n, int negate) {
  extern __shared__ float d[];
  __shared__ float part[GUARD_MAX_S][ROW_THREADS];
  __shared__ float total;
  Split split;
  split.start();
  const long long o = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) {
    const float v = __ldg(dir + o * n + i);
    d[i] = negate ? -v : v;
  }
  step_guard_lane(sa, o, n, d, 0, StepGrad<STEP_GUARD>{g + o * n, Damp()}, part, &total, split);
}

// ---------------------------------------------------------------------------
// The rest of a Newton step (solver._step_tail): the line search's pick
// after its softplus sums (lane_step_pick), and after the scale sweep's the
// sweep's regularizer sums and pick, the new mu, the convergence test and,
// in the loop, the freeze writes (lane_step_tail). Each replaces a run of
// ATen's elementwise kernels (some 20 and 55 launches an iteration) and
// gives that run's bits: __fmul_rn / __fadd_rn / __fsub_rn, no contraction;
// ATen's argmin (its first NaN, else its first least value), argmax of the
// int-cast Armijo test (its first passing step), NaN-keeping clamps; each
// gather from the device's steps and scales. Neither replaces a Pallas
// kernel: in the JAX package these are XLA's fusions of the jitted step
// (superdsm_tpu/dsm/solver.py:227-289) and of the loop body's freeze
// (:370-376). Both move a lane's surface once (read, and write scaled) and
// are bound by their launch and the sweep's sums at the bench's sizes.
//
// A lane takes STEP_BLOCKS blocks: each recomputes the lane's pick from its
// few candidates in its warp 0 (no second launch, no grid barrier; the
// code lane_step_sweep's prologue runs too) and writes every
// STEP_BLOCKS-th run of 256 surface entries; rank 0 also writes the lane's
// params and scalars. In the loop lane_step_tail writes the state in place
// (a lane already converged keeps every bit of it), so its blocks are a
// cluster: every block reads whether its lane was converged, then arrives at
// the cluster barrier, and rank 0 writes conv only after waiting at it.
// ---------------------------------------------------------------------------

constexpr int STEP_BLOCKS = 8;  // blocks of a lane (lane_step_tail's cluster)

// ATen's argmin over v[0 .. S) on the card (its LessOrNan order): the first
// NaN if one is there, else the first least value (-0 ties +0).
__device__ __forceinline__ int aten_argmin(const float* v, int S) {
  int best = 0;
  for (int k = 1; k < S; ++k)
    if (!isnan(v[best]) && (isnan(v[k]) || v[k] < v[best])) best = k;
  return best;
}

// clamp_min(v, lo) and clamp_max(v, hi) as ATen's CUDA kernels: NaN stays.
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_nan(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

struct PickArgs {
  const float* __restrict__ data_cand;  // (B, S)
  const float* __restrict__ reg_cand;   // (B, S), null at n <= 6
  const float* __restrict__ thr;        // (B, S) Armijo thresholds
  const float* __restrict__ f0;         // (B,)
  const float* __restrict__ steps;      // (S,)
  const float* __restrict__ params;     // (B, n)
  const float* __restrict__ delta;      // (B, n)
  const float* __restrict__ s;          // (B, P), null: no surface
  const float* __restrict__ u;          // (B, P)
  float* __restrict__ t_step;           // (B,)
  float* __restrict__ new_params;       // (B, n)
  float* __restrict__ new_s;            // (B, P)
  float* __restrict__ new_f;            // (B,)
  unsigned char* __restrict__ improved;   // (B,) bool
  unsigned char* __restrict__ full_step;  // (B,) bool
  int n, P, S;
};

// The line search's pick for one lane (solver.py's former 313-329):
//   f_cand = data_cand + reg_cand (n > 6); pick = the first k with f_cand[k]
//   <= thr[k], else argmin(f_cand); improved = f_cand[pick] < f0; t_step =
//   improved ? steps[pick] : 0; full_step = improved & (pick == 0);
//   new_params = params + t_step delta; new_s = s + t_step u; new_f =
//   improved ? f_cand[pick] : f0.
struct Pick {
  float ts, new_f;
  bool improved, full_step;
};

// What lane k < S of a warp loads for the pick of lane o (pick_loads):
// candidate k's data and regularizer energies, Armijo threshold and step;
// and, in every lane, the lane's f0 (read coherently: the loop's fval,
// written in the fused launch).
struct PickLoads {
  float d, r, thr, step, f0;
};

__device__ __forceinline__ PickLoads pick_loads(const float* __restrict__ data_cand,
                                                const float* __restrict__ reg_cand,
                                                const float* __restrict__ thr, const float* f0,
                                                const float* __restrict__ steps, long long o,
                                                int S) {
  const int l = threadIdx.x % WARP;
  PickLoads p{0.0f, 0.0f, 0.0f, 0.0f, f0[o]};
  if (l < S) {
    p.d = __ldg(data_cand + o * S + l);
    if (reg_cand) p.r = __ldg(reg_cand + o * S + l);
    p.thr = __ldg(thr + o * S + l);
    p.step = __ldg(steps + l);
  }
  return p;
}

// ATen's argmin of the values v of a warp's lanes l < S (S <= 32), which
// every lane gets: the first NaN, else the first least value (-0 ties
// +0), as aten_argmin. Its order (a NaN before any number, then the
// value, then the lane) is total, so a butterfly of shuffles finds its
// least element in five steps.
__device__ __forceinline__ int warp_argmin(float v, int S) {
  int idx = (int)(threadIdx.x % WARP);
  if (idx >= S) idx = WARP;  // not a candidate: after every one
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, m);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, m);
    bool other;  // whether (ov, oi) comes first
    if (oi >= WARP || idx >= WARP)
      other = oi < idx;
    else if (isnan(ov) != isnan(v))
      other = isnan(ov);
    else if (!isnan(v) && ov != v)
      other = ov < v;
    else
      other = oi < idx;
    if (other) {
      v = ov;
      idx = oi;
    }
  }
  return idx;
}

// The pick from a warp's pick_loads, every lane of which gets it: the
// candidate's energy d + r (d alone without a regularizer), the Armijo
// test a ballot (its lowest set bit the first passing step), else
// warp_argmin; the step and energy picked are shuffled from their lane.
// Inlined, as pick_loads: lane_step_sweep_kernel issues those loads before
// its first pixel loads and runs this once they are in.
__device__ __forceinline__ Pick pick_of(const PickLoads& p, bool reg, int S) {
  const int l = threadIdx.x % WARP;
  const float f = reg ? __fadd_rn(p.d, p.r) : p.d;
  const unsigned pass = __ballot_sync(0xffffffffu, l < S && f <= p.thr);
  const int pick = pass ? __ffs((int)pass) - 1 : warp_argmin(f, S);  // pass: warp-uniform
  const float f_pick = __shfl_sync(0xffffffffu, f, pick);
  const float step = __shfl_sync(0xffffffffu, p.step, pick);
  const bool improved = f_pick < p.f0;
  return {improved ? step : 0.0f, improved ? f_pick : p.f0, improved, improved && pick == 0};
}

__global__ void __launch_bounds__(ROW_THREADS) lane_step_pick_kernel(PickArgs a) {
  __shared__ float t_sh;
  const long long o = blockIdx.x / STEP_BLOCKS;
  const int rank = blockIdx.x % STEP_BLOCKS;
  const int t = threadIdx.x;
  if (t < WARP) {
    const Pick p = pick_of(pick_loads(a.data_cand, a.reg_cand, a.thr, a.f0, a.steps, o, a.S),
                           a.reg_cand != nullptr, a.S);
    if (t == 0) {
      t_sh = p.ts;
      if (rank == 0) {
        a.t_step[o] = p.ts;
        a.new_f[o] = p.new_f;
        a.improved[o] = p.improved;
        a.full_step[o] = p.full_step;
      }
    }
  }
  __syncthreads();
  const float ts = t_sh;
  if (rank == 0) {
    for (int i = t; i < a.n; i += ROW_THREADS) {
      const long long j = o * a.n + i;
      a.new_params[j] = __fadd_rn(__ldg(a.params + j), __fmul_rn(ts, __ldg(a.delta + j)));
    }
  }
  if (a.s != nullptr) {
    const float* s = a.s + o * a.P;
    const float* u = a.u + o * a.P;
    float* ns = a.new_s + o * a.P;
#pragma unroll 4
    for (int i = rank * ROW_THREADS + t; i < a.P; i += STEP_BLOCKS * ROW_THREADS)
      ns[i] = __fadd_rn(__ldg(s + i), __fmul_rn(ts, __ldg(u + i)));
  }
}

// The scale sweep's candidates new_params[6 + i] scales[k].
struct SweepXi {
  const float* __restrict__ p;
  const float* __restrict__ scales;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return __fmul_rn(__ldg(p + i), __ldg(scales + k));
  }
};

struct TailArgs {
  const float* __restrict__ data_sc;      // (B, S) the sweep's data energies
  const float* __restrict__ new_params;   // (B, n) lane_step_pick's
  const float* __restrict__ new_s;        // (B, P), null: no surface
  const float* __restrict__ new_f;        // (B,)
  const unsigned char* __restrict__ improved;
  const unsigned char* __restrict__ full_step;
  const float* mu;         // (B,) the step's mu (the loop's, written in place)
  const float* f0;         // (B,) the step's f0 (the loop's fval, written in place)
  const float* __restrict__ decrement;  // (B,)
  const float* __restrict__ alpha;      // (B,), null at n <= 6
  const float* __restrict__ kmask;      // (B, n - 6)
  const float* __restrict__ scales;     // (S,)
  float* params;   // (B, n) out, or the loop's params
  float* s;        // (B, P) out, or the loop's s (null: no surface)
  float* fval;     // (B,) out, or the loop's fval (may be null in the loop)
  float* mu_out;   // (B,) out, or mu itself
  unsigned char* conv;  // (B,) out, or the loop's conv (read, then or-ed)
  int* it_lane;         // (B,) the loop's (null: none)
  const int* it_dev;    // () the loop's iteration count, with it_lane
  int n, P, S, freeze;
  float eps, sq_eps, tol, mu_min, mu_max, mu_small;
};

// The tail's scale of one lane from its sweep's candidates f[k] =
// data_sc[k] + reg_sc[k] (S of them): pick = argmin(f) (aten_argmin in a
// thread, warp_argmin in a warp); boost = f[pick] < new_f and finite; c =
// boost ? scales[pick] : 1, f' = boost ? f[pick] : new_f (tail_boost)
struct TailPick {
  float c, f_new;
};

// ... from the least candidate f_pick and its scale.
__device__ __forceinline__ TailPick tail_boost(float f_pick, float scale, float nf) {
  const bool boost = f_pick < nf && isfinite(f_pick);
  return {boost ? scale : 1.0f, boost ? f_pick : nf};
}

// The tail's new mu and convergence test of one lane (its mu and f0 the
// step's):
//   mu' = full_step ? clamp_min(mu 0.25, mu_min) : improved ? mu :
//     clamp_max(mu 8, mu_max);
//   tiny_gain = (f0 - f') <= tol (|f0| + 1); converged = (0.5 decrement <=
//     tol (|f0| + 1) & mu <= mu_small & tiny_gain) | (!improved & mu >=
//     mu_max & tiny_gain).
struct TailTest {
  float mu_new;
  bool converged;
};

__device__ __forceinline__ TailTest tail_test_lane(float f_new, bool improved, bool full_step,
                                                   float mu, float f0, float decrement, float tol,
                                                   float mu_min, float mu_max, float mu_small) {
  const float mu_new = full_step ? clamp_min_nan(__fmul_rn(mu, 0.25f), mu_min)
                       : improved ? mu
                                  : clamp_max_nan(__fmul_rn(mu, 8.0f), mu_max);
  const float gain_tol = __fmul_rn(__fadd_rn(fabsf(f0), 1.0f), tol);
  const bool tiny_gain = __fsub_rn(f0, f_new) <= gain_tol;
  return {mu_new, (__fmul_rn(decrement, 0.5f) <= gain_tol && mu <= mu_small && tiny_gain) ||
                      (!improved && mu >= mu_max && tiny_gain)};
}

// The tail of one lane (solver.py's former 333-356, and with `freeze` the
// loop's 519-525):
//   reg_sc[k] = clamp_min(alpha lane_sum_K(kmask (sqrt(xi^2 + eps) -
//     sq_eps)), 0), xi = new_params[6:] scales[k] (n > 6; reg_sums, the
//     order of lane_sum over the (B, K, S) terms);
//   f_sc = data_sc + reg_sc; then its argmin and tail_boost, params' = new_params c,
//   s' = new_s c, and tail_test_lane.
// Without `freeze` it writes params', s', f', converged and mu' to its
// outputs; with it, in a lane whose conv was false it writes them over the
// loop's params, s, fval, conv and mu, and it_lane = *it_dev; a lane whose
// conv was true is left as it is (conv | converged is true).
__global__ void __cluster_dims__(STEP_BLOCKS, 1, 1) __launch_bounds__(ROW_THREADS)
lane_step_tail_kernel(TailArgs a) {
  __shared__ float part[GUARD_MAX_S][ROW_THREADS];
  __shared__ float reg[GUARD_MAX_S];
  __shared__ float c_sh;
  const long long o = blockIdx.x / STEP_BLOCKS;
  const int rank = blockIdx.x % STEP_BLOCKS;
  const int t = threadIdx.x;
  // every block reads its lane's conv before the cluster barrier, and rank
  // 0 writes it only after the barrier
  const bool frozen = a.freeze && a.conv[o];
  cluster_arrive();
  const int K = a.n - 6;
  if (K > 0)
    reg_sums(SweepXi{a.new_params + o * a.n + 6, a.scales}, GlobalRow{a.kmask + o * K}, K, a.S,
             __ldg(a.alpha + o), a.eps, a.sq_eps, part, reg);
  __syncthreads();
  TailPick tp{};
  TailTest tt{};
  if (t == 0) {
    for (int k = 0; k < a.S; ++k) {
      const float d = __ldg(a.data_sc + o * a.S + k);
      reg[k] = K > 0 ? __fadd_rn(d, reg[k]) : d;
    }
    const int pick = aten_argmin(reg, a.S);
    tp = tail_boost(reg[pick], __ldg(a.scales + pick), __ldg(a.new_f + o));
    c_sh = tp.c;
    if (rank == 0)
      tt = tail_test_lane(tp.f_new, a.improved[o], a.full_step[o], a.mu[o], a.f0[o],
                          __ldg(a.decrement + o), a.tol, a.mu_min, a.mu_max, a.mu_small);
  }
  __syncthreads();
  const float c = c_sh;
  if (!frozen) {
    if (rank == 0) {
      for (int i = t; i < a.n; i += ROW_THREADS)
        a.params[o * a.n + i] = __fmul_rn(__ldg(a.new_params + o * a.n + i), c);
    }
    if (a.s != nullptr) {
      const float* ns = a.new_s + o * a.P;
      float* s = a.s + o * a.P;
#pragma unroll 4
      for (int i = rank * ROW_THREADS + t; i < a.P; i += STEP_BLOCKS * ROW_THREADS)
        s[i] = __fmul_rn(__ldg(ns + i), c);
    }
  }
  cluster_wait();
  if (rank == 0 && t == 0 && !frozen) {
    if (a.fval != nullptr) a.fval[o] = tp.f_new;
    a.mu_out[o] = tt.mu_new;
    if (a.it_lane != nullptr) a.it_lane[o] = *a.it_dev;
    a.conv[o] = tt.converged;
  }
}

// ---------------------------------------------------------------------------
// lane_step_sweep: the pick, the scale sweep's sums and the tail of a Newton
// step in the loop (solver._newton_step given the loop's state) in one
// launch, bitwise lane_step_pick, softplus_energies (SCALE_SWEEP) and
// lane_step_tail (freeze) in turn. A STEP_SWEEP launch of the softplus
// sums (softplus_pixel_sums): O k_tiles clusters of 8 blocks, each a tile
// of the lane's scale outputs, with
//   - a prologue: warp 0 of every block loads the lane's pick candidates
//     (pick_loads, before the first pixel loads) and recomputes the pick
//     (pick_of) while those load; it reads the lane's conv too: the
//     clusters of a converged lane leave at once (its state is kept to the
//     bit, as the freeze keeps it);
//   - each pixel's surface s + t_step u formed as loaded (new_s is never
//     written), its sweep terms built from it as SCALE_SWEEP builds them;
//   - each output's regularizer sum, reg_sums' over (params + t_step
//     delta)[6:] scales[k], made by the output's owner block once it has
//     pushed its slots, while its peers' arrive (the pick's t_step is
//     known only after the prologue's loads, so made there it would delay
//     the first build: chip_smoke.py --split), and added to the output's
//     data energy;
//   - a lane of one tile (k_tiles = 1, the plan's from 8 lanes up: its
//     cluster is the lane's last) pushes each energy to every block of
//     its cluster with st.async, completing on that block's mbarrier,
//     which expects the S energies: each block waits for them alone, with
//     no cluster barrier (every write into a block is one it waits for, so
//     none leaves while a peer may still write to it); a lane of more
//     tiles stores each energy in the solve's scratch sums (B, S),
//     followed by one acquire-release atomic add to the lane's arrival
//     counter: the owner that brings it to S sets it back to 0 (for the
//     next launch, a graph's next replay) and flags every block of its
//     cluster, which then passes one cluster barrier;
//   - the lane's last cluster runs the tail: the scale's pick from the S
//     energies, s' = (s + t_step u) c, params' = (params + t_step delta) c
//     (a one-tile lane's loaded while its energies arrive), f', mu', conv
//     and it_lane in place. Nothing waits for another cluster: the last to
//     arrive finds the others' energies stored, whatever ran at once.
// What it saves: two launches a Newton iteration (the pick's and the
// tail's, each at a graph node's floor) and new_s's write and two reads.
// What bounds it: the sweep's terms (issue), as softplus_energies.
// ---------------------------------------------------------------------------

struct SweepArgs {
  const float* __restrict__ data_cand;  // (B, S) the line search's data energies
  const float* __restrict__ reg_cand;   // (B, S), null at n <= 6
  const float* __restrict__ thr;        // (B, S) Armijo thresholds
  const float* __restrict__ steps;      // (S,)
  const float* __restrict__ delta;      // (B, n)
  const float* __restrict__ decrement;  // (B,)
  const float* __restrict__ alpha;      // (B,), null at n <= 6
  const float* __restrict__ kmask;      // (B, n - 6)
  float* params;         // (B, n) the loop's, read and written in place
  float* s;              // (B, P) the loop's (the sweep's term.s)
  float* fval;           // (B,) the loop's (the step's f0)
  float* mu;             // (B,) the loop's
  unsigned char* conv;   // (B,) the loop's
  int* it_lane;          // (B,) the loop's (null: none)
  const int* it_dev;     // () the loop's iteration count, with it_lane
  int* arrivals;         // (B,) the solve's counters, 0 between launches
  float* sums;           // (B, SC) the solve's scratch: the sweep's energies f_sc
  int n, S;              // S: the line search's steps
  float eps, sq_eps, tol, mu_min, mu_max, mu_small;
};

// Regularizer dimensions K up to which lane_step_sweep's owner blocks keep
// the regularizer's operands in shared memory (the DSM buckets up to n =
// 518; above, they read them from device memory).
constexpr int SWEEP_REG_CACHE = SP_THREADS;

// A block's view of its lane's step in lane_step_sweep_kernel.
struct SweepShared {
  unsigned long long ebar;  // a one-tile lane's energies arrive on it
  float ts, new_f, c, f0, mu, decrement, alpha;
  int run, improved, full_step, last;
  float reg[GUARD_MAX_S];    // the regularizer of the tile's outputs the block owns
  float f[GUARD_MAX_S];      // the tail's candidates f_sc
  float scale[GUARD_MAX_S];  // the scales (the tail's pick reads them)
  // an owner block's regularizer operands params[6 + i], delta[6 + i],
  // kmask[i] (K <= SWEEP_REG_CACHE), loaded while warp 0 picks
  float rp[SWEEP_REG_CACHE], rd[SWEEP_REG_CACHE], rk[SWEEP_REG_CACHE];
};

// The scale sweep's candidates (params[6 + i] + t_step delta[6 + i])
// scales[k]: new_params as lane_step_pick forms it, from the loop's params
// (read coherently: the launch writes them) and delta, in device memory
// or their copies in shared memory (p, d: generic pointers).
struct StepSweepXi {
  const float* p;
  const float* d;
  float ts;
  const float* scales;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return __fmul_rn(__fadd_rn(p[i], __fmul_rn(ts, d[i])), scales[k]);
  }
};

// acquire-release atomic add at the card's scope; returns the old value.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The regularizer sums of the tile's outputs k0 + q, k0 + q + 8 (< k0 +
// kn) that block q owns, into sh.reg[q], sh.reg[q + 8]: reg_sums' order
// and terms (slot s adds i = s, s + 256, ... in turn, then the tree), its
// two sums side by side in registers (reg_sums, for any outputs a block
// may own, runs an unrolled, predicated chain for each of GUARD_MAX_S;
// that took ~1.5 us here on an NVIDIA H100 80GB HBM3 at 700 W:
// chip_smoke.py --split), its slots in `part`
// (two rows of 256 floats), its operands from sh's copies (K <=
// SWEEP_REG_CACHE) or device memory. Not inlined: compiled apart, it leaves the sums'
// register allocation as it was.
__device__ __noinline__ void sweep_reg_sums(const SweepArgs& a, long long o, int k0, int kn,
                                            float* part, SweepShared& sh) {
  const int n = a.n, K = n - 6, t = threadIdx.x, T = blockDim.x;
  const bool cached = K <= SWEEP_REG_CACHE;
  const int q = (int)cg::this_cluster().block_rank();
  const float* p = cached ? sh.rp : a.params + o * n + 6;
  const float* d = cached ? sh.rd : a.delta + o * n + 6;
  const float* km = cached ? sh.rk : a.kmask + o * K;
  const bool two = q + CLUSTER < kn;
  const float ts = sh.ts, eps = a.eps, sq_eps = a.sq_eps;
  const float c0 = sh.scale[k0 + q], c1 = two ? sh.scale[k0 + q + CLUSTER] : 0.0f;
  for (int s = t; s < ROW_THREADS; s += T) {
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int i = s; i < K; i += ROW_THREADS) {
      const float m = km[i];
      const float np = __fadd_rn(p[i], __fmul_rn(ts, d[i]));
      acc0 = __fadd_rn(acc0, __fmul_rn(m, __fsub_rn(reg_term2(__fmul_rn(np, c0), eps), sq_eps)));
      if (two)
        acc1 = __fadd_rn(acc1, __fmul_rn(m, __fsub_rn(reg_term2(__fmul_rn(np, c1), eps), sq_eps)));
    }
    part[s] = acc0;
    if (two) part[ROW_THREADS + s] = acc1;
  }
  __syncthreads();
  const int w = t / WARP, lane = t % WARP;
  if (w < 1 + two) {
    float v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v[r] = part[w * ROW_THREADS + r * WARP + lane];
    const float sum = slot_tree(v);
    if (lane == 0) sh.reg[q + w * CLUSTER] = clamp_min0(__fmul_rn(sh.alpha, sum));
  }
}

// softplus_pixel_sums' hooks in lane_step_sweep_kernel (see above).
struct SweepHooks {
  const SweepArgs& a;
  const float* __restrict__ scales;
  long long o;
  SweepShared& sh;
  int SC, k_tiles;
  PickLoads pl;        // warp 0's, with the lane's conv, mu and decrement
  unsigned char conv;
  float mu, decrement, alpha;
  float scale;         // thread t < SC's scale
  float rp, rd, rk;    // thread t's regularizer operands (i = t < K, K <= SWEEP_REG_CACHE)
  __device__ __forceinline__ SumsStart start(Split& split) const {
    const int t = threadIdx.x, K = a.n - 6;
    if (t < SC) sh.scale[t] = scale;
    if (K <= SWEEP_REG_CACHE && t < K) {
      sh.rp[t] = rp;
      sh.rd[t] = rd;
      sh.rk[t] = rk;
    }
    split.mark(12);
    if (threadIdx.x < WARP) {
      const Pick p = pick_of(pl, a.reg_cand != nullptr, a.S);
      if (threadIdx.x == 0) {
        sh.ts = p.ts;
        sh.new_f = p.new_f;
        sh.run = !conv;
        sh.improved = p.improved;
        sh.full_step = p.full_step;
        sh.f0 = pl.f0;
        sh.mu = mu;
        sh.decrement = decrement;
        sh.alpha = alpha;
        split.mark(7);
      }
    }
    __syncthreads();
    return {sh.run != 0, sh.ts};
  }
  // an owner's regularizer sums, while its peers' slots arrive (`part`:
  // the free group buffers)
  __device__ __forceinline__ void before_trees(long long, int k0, int kn, int owned, float* part,
                                               Split& split) const {
    if (owned > 0 && a.n > 6) {  // block-uniform
      sweep_reg_sums(a, o, k0, kn, part, sh);
      __syncthreads();
    }
    split.mark(9);
  }
  __device__ __forceinline__ void store(long long, int, int k0, int kl, float sum) const {
    const int k = k0 + kl;
    const float f = a.n > 6 ? __fadd_rn(sum, sh.reg[kl]) : sum;
    if (k_tiles == 1) {
      for (int r = 0; r < CLUSTER; ++r)
        st_async(cluster_addr(smem_addr(&sh.f[k]), r), f, cluster_addr(smem_addr(&sh.ebar), r));
      return;
    }
    a.sums[o * SC + k] = f;
    if (atom_add_acq_rel(a.arrivals + o, 1) == SC - 1) {
      a.arrivals[o] = 0;  // every output of the lane is stored
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = 0; r < CLUSTER; ++r) cluster.map_shared_rank(&sh, r)->last = 1;
    }
  }
};

// Lanes from which lane_step_sweep's plan takes one tile a lane.
constexpr int SWEEP_ONE_TILE_LANES = 8;

// Surface and params entries a thread of a one-tile lane's blocks loads
// while the energies arrive (the rest, at P > 32768 or n > 1024, after).
constexpr int SWEEP_PREFETCH_S = 8;
constexpr int SWEEP_PREFETCH_P = 2;

// The end of lane_step_sweep_kernel after a block's sums (every thread): a
// one-tile lane's blocks wait for the S energies on their mbarrier, a lane
// of more tiles passes one cluster barrier, after which its last cluster
// (the flagged) runs the tail (see above). Not inlined, as step_guard_lane.
__device__ __noinline__ void step_sweep_tail(const SoftplusTerm<STEP_SWEEP>& term,
                                             const SweepArgs& a, long long o, int SC,
                                             int k_tiles, SweepShared& sh, Split& split) {
  const int rank = (int)cg::this_cluster().block_rank();
  const int t = threadIdx.x;
  const int n = a.n, P = term.L;
  const float ts = sh.ts;
  float* s = a.s + o * P;
  const float* u = term.u + o * P;
  const int first = rank * SP_THREADS + t, stride = CLUSTER * SP_THREADS;
  const bool pre = k_tiles == 1;
  // a lane of more tiles: every owner's energy is stored and counted once
  // the barrier completes
  if (!pre) cluster_arrive();
  // a one-tile lane's new surface and params (new_s, new_params) load while
  // its energies arrive
  float ns[SWEEP_PREFETCH_S], np[SWEEP_PREFETCH_P];
  if (pre) {
#pragma unroll
    for (int e = 0; e < SWEEP_PREFETCH_S; ++e) {
      const int i = first + e * stride;
      ns[e] = i < P ? __fadd_rn(__ldcg(s + i), __fmul_rn(ts, __ldg(u + i))) : 0.0f;
    }
    if (rank == 0) {
#pragma unroll
      for (int e = 0; e < SWEEP_PREFETCH_P; ++e) {
        const int i = t + e * SP_THREADS;
        const long long j = o * n + i;
        np[e] = i < n ? __fadd_rn(__ldcg(a.params + j), __fmul_rn(ts, __ldg(a.delta + j))) : 0.0f;
      }
    }
    mbar_wait(smem_addr(&sh.ebar), 0);
  } else {
    cluster_wait();
  }
  split.mark(8);
  if (!pre && !sh.last) return;
  TailTest tt{};
  float f_new = 0.0f;
  if (t < WARP) {  // the scale's pick in warp 0, lane k holding f_sc[k]
    float f = 0.0f;
    if (t < SC) f = pre ? sh.f[t] : __ldcg(a.sums + o * SC + t);
    const int pick = warp_argmin(f, SC);
    const float f_pick = __shfl_sync(0xffffffffu, f, pick);
    if (t == 0) {
      const TailPick tp = tail_boost(f_pick, sh.scale[pick], sh.new_f);
      sh.c = tp.c;
      f_new = tp.f_new;
      if (rank == 0)
        tt = tail_test_lane(f_new, sh.improved, sh.full_step, sh.mu, sh.f0, sh.decrement,
                            a.tol, a.mu_min, a.mu_max, a.mu_small);
    }
  }
  __syncthreads();
  split.mark(10);
  const float c = sh.c;
  const int done_s = pre ? SWEEP_PREFETCH_S : 0, done_p = pre ? SWEEP_PREFETCH_P : 0;
  if (pre) {
#pragma unroll
    for (int e = 0; e < SWEEP_PREFETCH_S; ++e) {
      const int i = first + e * stride;
      if (i < P) s[i] = __fmul_rn(ns[e], c);
    }
  }
#pragma unroll 4
  for (int i = first + done_s * stride; i < P; i += stride)
    s[i] = __fmul_rn(__fadd_rn(__ldcg(s + i), __fmul_rn(ts, __ldg(u + i))), c);
  if (rank == 0) {
    if (pre) {
#pragma unroll
      for (int e = 0; e < SWEEP_PREFETCH_P; ++e) {
        const int i = t + e * SP_THREADS;
        if (i < n) a.params[o * n + i] = __fmul_rn(np[e], c);
      }
    }
    for (int i = t + done_p * SP_THREADS; i < n; i += SP_THREADS) {
      const long long j = o * n + i;
      a.params[j] = __fmul_rn(__fadd_rn(__ldcg(a.params + j), __fmul_rn(ts, __ldg(a.delta + j))),
                              c);
    }
    if (t == 0) {
      a.fval[o] = f_new;
      a.mu[o] = tt.mu_new;
      if (a.it_lane != nullptr) a.it_lane[o] = *a.it_dev;
      a.conv[o] = tt.converged;
    }
  }
  split.mark(11);
}

// The arguments are __grid_constant__: the device functions below take them
// by reference with no copy in local memory.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(SP_THREADS, SP_BLOCKS)
lane_step_sweep_kernel(const __grid_constant__ SoftplusTerm<STEP_SWEEP> term,
                       const __grid_constant__ SweepArgs a, int S, int kb, int k_tiles) {
  extern __shared__ __align__(16) float sp_smem[];
  __shared__ SweepShared sh;
  Split split;
  split.start();
  const long long o = blockIdx.x / CLUSTER / k_tiles;
  const int t = threadIdx.x, n = a.n, K = n - 6;
  const bool w0 = t < WARP;
  // the prologue's loads, issued before the first pixels' (the compiler
  // barrier below keeps them first): warp 0's pick, the scales, an owner
  // block's regularizer operands
  const bool own = (int)(blockIdx.x % CLUSTER) < min(S, kb) && K > 0 && K <= SWEEP_REG_CACHE &&
                   t < K;
  const long long r = o * n + 6 + t;
  const SweepHooks hooks{a, term.c, o, sh, S, k_tiles,
                         w0 ? pick_loads(a.data_cand, a.reg_cand, a.thr, a.fval, a.steps, o, a.S)
                            : PickLoads{},
                         w0 ? a.conv[o] : (unsigned char)0, w0 ? a.mu[o] : 0.0f,
                         w0 ? __ldg(a.decrement + o) : 0.0f,
                         w0 && K > 0 ? __ldg(a.alpha + o) : 0.0f,
                         t < S ? __ldg(term.c + t) : 0.0f, own ? __ldcg(a.params + r) : 0.0f,
                         own ? __ldg(a.delta + r) : 0.0f,
                         own ? __ldg(a.kmask + o * K + t) : 0.0f};
  asm volatile("" ::: "memory");
  // before the cluster barrier the sums' body arrives at: peers flag it, or
  // push the energies to its mbarrier, only after they wait there
  if (t == 0) sh.last = 0;
  if (t == WARP && k_tiles == 1) {  // the sums' body: this thread's fence covers the init
    mbar_init(smem_addr(&sh.ebar), 1);
    mbar_expect(smem_addr(&sh.ebar), 4u * (unsigned)S);
  }
  const bool ran = softplus_pixel_sums(term, term.L, S, kb, k_tiles, split, hooks);
  if (ran) step_sweep_tail(term, a, o, S, k_tiles, sh, split);
  split.finish();
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

// A softplus sum's launch: its outputs' tiles, the tile width, threads a
// block and blocks.
struct SoftplusPlan {
  int k_tiles, kb, threads;
  long long blocks;
};

#ifdef SDSM_SPLIT
// PR 13's plan and launch (chip_smoke.py --split).
// The outputs of a lane go into k tiles until the grid would pass what the
// card holds at once (RESIDENT_BLOCKS an SM): more threads for few lanes.
SoftplusPlan softplus_plan(long long O, int S) {
  const long long resident = (long long)RESIDENT_BLOCKS * sm_count();
  int k_tiles = 1;
  while (k_tiles < S && O * (k_tiles + 1) * CLUSTER <= resident) ++k_tiles;
  const int kb = (S + k_tiles - 1) / k_tiles;
  k_tiles = (S + kb - 1) / kb;
  const int pairs = SLOT_BLOCK * kb;
  return {k_tiles, kb, TERM_THREADS / pairs * pairs, O * k_tiles * CLUSTER};
}

template <int MODE>
int launch_softplus_pr13(const SoftplusTerm<MODE>& term, float* out, long long O,
                         int L, int S, cudaStream_t stream) {
  if (O < 0 || L < 0 || S < 1 || S > SLOTS_K) return (int)cudaErrorInvalidValue;
  if (O == 0) return (int)cudaGetLastError();
  const SoftplusPlan plan = softplus_plan(O, S);
  if (plan.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_softplus_kernel<MODE><<<(unsigned)plan.blocks, plan.threads, 0, stream>>>(
      term, out, L, S, plan.kb, plan.k_tiles);
  return (int)cudaGetLastError();
}
#endif  // SDSM_SPLIT

constexpr int MAX_DEVICES = 64;

#ifdef SDSM_SPLIT
int g_split_tiles = 0;  // --split's sweep: k tiles forced (0: the plan's)
#endif

// The kernel of a softplus launch in `MODE` (lane_step_sweep_kernel's
// owners keep their regularizer sums' slots in the free group buffers:
// kn <= kb rows of 256, so the same shared memory).
template <int MODE>
const void* pixel_kernel() {
  if constexpr (MODE == STEP_SWEEP)
    return (const void*)lane_step_sweep_kernel;
  else
    return (const void*)lane_softplus_pixel_kernel<MODE>;
}

// The tiles of a launch: SP_KB outputs a tile, or 2 where that leaves
// fewer than SP_MIN_BLOCKS blocks (few lanes), and wider tiles where the
// card cannot hold all O k_tiles clusters at once (cudaOccupancyMaxActiveClusters
// for the kernel of MODE at the tile's shared memory, asked once a device
// and width). A narrower tile spreads a lane over more blocks but loads
// each pixel once a tile. `tiles` > 0 forces k tiles of ceil(S / k)
// outputs (the sums' bits do not depend on it). Sets the kernel's shared
// memory maximum once a device. Returns 0 or a CUDA error.
template <int MODE>
int softplus_pixel_plan(long long O, int S, SoftplusPlan* plan, int tiles = 0) {
  static std::atomic<int> known[MAX_DEVICES][SLOTS_K + 1];  // clusters, 0: not asked
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(pixel_kernel<MODE>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * softplus_smem_floats(SLOTS_K));
    if (err != cudaSuccess) return (int)err;
    ready[dev].store(true, std::memory_order_release);
  }
  int kb = min(S, SP_KB);
  if (O * ((S + kb - 1) / kb) * CLUSTER < SP_MIN_BLOCKS) kb = min(S, 2);
  // lane_step_sweep: one tile a lane from SWEEP_ONE_TILE_LANES lanes up (no
  // counter, no energies through device memory; chip_smoke.py --split)
  if (MODE == STEP_SWEEP && O >= SWEEP_ONE_TILE_LANES) kb = S;
#ifdef SDSM_SPLIT
  if (g_split_tiles > 0) tiles = g_split_tiles;
#endif
  if (tiles > 0) {
    kb = (S + tiles - 1) / tiles;
    const int k_tiles = (S + kb - 1) / kb;
    *plan = {k_tiles, kb, SP_THREADS, O * k_tiles * CLUSTER};
    return 0;
  }
  for (;; ++kb) {
    const int k_tiles = (S + kb - 1) / kb;
    int clusters = known[dev][kb].load(std::memory_order_relaxed);
    if (clusters == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(CLUSTER);
      cfg.blockDim = dim3(SP_THREADS);
      cfg.dynamicSmemBytes = 4 * softplus_smem_floats(kb);
      err = cudaOccupancyMaxActiveClusters(&clusters, pixel_kernel<MODE>(), &cfg);
      if (err != cudaSuccess) return (int)err;
      known[dev][kb].store(clusters, std::memory_order_relaxed);
    }
    if (k_tiles == 1 || O * k_tiles <= clusters) {
      *plan = {k_tiles, kb, SP_THREADS, O * k_tiles * CLUSTER};
      return 0;
    }
  }
}

template <int MODE>
int launch_softplus(const SoftplusTerm<MODE>& term, float* out, long long O,
                    int L, int S, cudaStream_t stream) {
  if (O < 0 || L < 0 || S < 1 || S > SLOTS_K) return (int)cudaErrorInvalidValue;
  if (O == 0) return (int)cudaGetLastError();
  SoftplusPlan plan;
  const int err = softplus_pixel_plan<MODE>(O, S, &plan);
  if (err) return err;
  if (plan.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_softplus_pixel_kernel<MODE><<<(unsigned)plan.blocks, SP_THREADS,
                                     4 * softplus_smem_floats(plan.kb), stream>>>(
      term, out, L, S, plan.kb, plan.k_tiles);
  return (int)cudaGetLastError();
}

// lane_step_sweep_kernel's launch: O lanes, SC scales, `tiles` as in
// softplus_pixel_plan.
int launch_step_sweep(const SoftplusTerm<STEP_SWEEP>& term, const SweepArgs& a, long long O,
                      int SC, int tiles, cudaStream_t stream) {
  if (O == 0) return (int)cudaGetLastError();
  SoftplusPlan plan;
  const int err = softplus_pixel_plan<STEP_SWEEP>(O, SC, &plan, tiles);
  if (err) return err;
  if (plan.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_step_sweep_kernel<<<(unsigned)plan.blocks, SP_THREADS,
                           4 * softplus_smem_floats(plan.kb), stream>>>(
      term, a, SC, plan.kb, plan.k_tiles);
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

namespace {

// lane_pcg_kernel's launch: its dynamic shared memory (the vectors and the
// rows that fit beside them and its static shared memory), and its rows
// kept there; the step variant also needs its guard's slots in the rows or
// after x (cudaErrorInvalidValue where neither holds them).
template <int STEP>
int pcg_smem_plan(int n, long long* bytes, long long* cached) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, lane_pcg_kernel<STEP>);
  if (err != cudaSuccess) return (int)err;
  const long long avail = smem_max - (long long)attr.sharedSizeBytes;
  const long long vec_bytes = 4LL * (6LL * n + 3 * PCG_THREADS);
  if (vec_bytes > avail) return (int)cudaErrorInvalidValue;
  const long long nr = (n + PCG_CLUSTER - 1) / PCG_CLUSTER;
  const long long fit = (avail - vec_bytes) / (4LL * n);
  *cached = fit < nr ? fit : nr;
  *bytes = vec_bytes + *cached * 4LL * n;
  if (STEP != STEP_PLAIN && *cached * n < GUARD_FLOATS && 5LL * n + 3 * PCG_THREADS < GUARD_FLOATS)
    return (int)cudaErrorInvalidValue;
  // the card's maximum, the same for every launch (threads launching
  // concurrently set the same value)
  return (int)cudaFuncSetAttribute(lane_pcg_kernel<STEP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)avail);
}

template <int STEP>
int launch_pcg_smem(const float* H, const float* b, float* x, int B, int n, int iters,
                    float stop2, float eps, const StepArgs& sa, cudaStream_t stream) {
  long long bytes = 0, cached = 0;
  const int err = pcg_smem_plan<STEP>(n, &bytes, &cached);
  if (err) return err;
  const int vec = n % 4 == 0 && (unsigned long long)H % 16 == 0;
  lane_pcg_kernel<STEP><<<B * PCG_CLUSTER, PCG_THREADS, (size_t)bytes, stream>>>(
      H, b, x, n, iters, (int)cached, vec, stop2, eps, sa);
  return (int)cudaGetLastError();
}

// lane_pcg's launch of variant `step` on its route from n (the guard's
// StepArgs unused by STEP_PLAIN); STEP_FULL only at n <= PCG_REG_MAX_N.
int launch_pcg(int step, const float* H, const float* b, float* x, int B, int n, int iters,
               float stop2, float eps, const StepArgs& sa, cudaStream_t st) {
  if ((long long)B * PCG_CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(B * PCG_CLUSTER);
  if (n <= PCG_REG_MAX_N) {
    switch (step) {
      case STEP_PLAIN:
        lane_pcg_reg_kernel<STEP_PLAIN><<<grid, PCG_THREADS, 0, st>>>(H, b, x, n, iters, stop2, eps, sa);
        break;
      case STEP_GUARD:
        lane_pcg_reg_kernel<STEP_GUARD><<<grid, PCG_THREADS, 0, st>>>(H, b, x, n, iters, stop2, eps, sa);
        break;
      default:
        lane_pcg_reg_kernel<STEP_FULL><<<grid, PCG_THREADS, 0, st>>>(H, b, x, n, iters, stop2, eps, sa);
    }
    return (int)cudaGetLastError();
  }
  if (step == STEP_FULL) return (int)cudaErrorInvalidValue;
  return step == STEP_PLAIN ? launch_pcg_smem<STEP_PLAIN>(H, b, x, B, n, iters, stop2, eps, sa, st)
                            : launch_pcg_smem<STEP_GUARD>(H, b, x, B, n, iters, stop2, eps, sa, st);
}

}  // namespace

extern "C" int sdsm_lane_pcg_reg_max_n() { return PCG_REG_MAX_N; }

// x (B, n) = solver._pcg_solve(H, b, iters, rtol) with H (B, n, n) and b
// (B, n) float32 contiguous, stop2 and eps the float32 values of rtol^2 and
// 1e-30; one launch of B clusters on `stream`: lane_pcg_reg_kernel (H in
// registers) at n <= PCG_REG_MAX_N, else lane_pcg_kernel, whose blocks keep
// as many of their rows of H in shared memory as the card's opt-in maximum
// leaves beside their vectors (6 n + 768 floats; n past that maximum is
// refused). The two give the same bits (the same order).
extern "C" int sdsm_lane_pcg(const float* H, const float* b, float* x, int B,
                             int n, int iters, float stop2, float eps,
                             void* stream) {
  if (B < 0 || n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  return launch_pcg(STEP_PLAIN, H, b, x, B, n, iters, stop2, eps, StepArgs{},
                    (cudaStream_t)stream);
}

#ifdef SDSM_SPLIT
// chip_smoke.py --split: the stamps' layout, their reset and read-back, and
// what the card reports for a launch.
extern "C" int sdsm_lane_split_phases() { return SPLIT_PHASES; }
extern "C" int sdsm_lane_split_words() { return SPLIT_WORDS; }
extern "C" int sdsm_lane_split_blocks() { return SPLIT_BLOCKS; }

extern "C" int sdsm_lane_split_reset(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_split);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p, 0, sizeof(g_split), (cudaStream_t)stream);
  return (int)err;
}

extern "C" int sdsm_lane_split_read(void* host, void* stream) {
  cudaError_t err = cudaStreamSynchronize((cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_split, sizeof(g_split));
  return (int)err;
}

// out: registers a thread, local (spilled) bytes a thread, static and
// dynamic shared bytes a block, the clusters cudaOccupancyMaxActiveClusters
// reports as active at once, threads a block, blocks.
template <class K>
int kernel_info(K* kernel, long long blocks, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  const int v[7] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    (int)smem, clusters, threads, (int)blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// lane_pcg's launch at (B, n) as sdsm_lane_pcg makes it; `smem`: PR 13's
// kernel with its rows in shared memory (and L2) at any n.
extern "C" int sdsm_lane_split_pcg_info(int* out, int B, int n, int smem, void*) {
  if (n <= PCG_REG_MAX_N && !smem)
    return kernel_info(lane_pcg_reg_kernel<STEP_PLAIN>, (long long)B * PCG_CLUSTER, PCG_THREADS,
                       0, out);
  long long bytes = 0, cached = 0;
  const int err = pcg_smem_plan<STEP_PLAIN>(n, &bytes, &cached);
  if (err) return err;
  return kernel_info(lane_pcg_kernel<STEP_PLAIN>, (long long)B * PCG_CLUSTER, PCG_THREADS,
                     (size_t)bytes, out);
}

// PR 13's kernel at any n (the route that n <= PCG_REG_MAX_N left), for
// the split before and after.
extern "C" int sdsm_lane_split_pcg_smem(const float* H, const float* b, float* x, int B,
                                        int n, int iters, float stop2, float eps,
                                        void* stream) {
  return launch_pcg_smem<STEP_PLAIN>(H, b, x, B, n, iters, stop2, eps, StepArgs{},
                                    (cudaStream_t)stream);
}

template <int MODE>
int softplus_info(int* out, long long O, int S, bool pr13) {
  if (pr13) {
    const SoftplusPlan plan = softplus_plan(O, S);
    return kernel_info(lane_softplus_kernel<MODE>, plan.blocks, plan.threads, 0, out);
  }
  SoftplusPlan plan;
  const int err = softplus_pixel_plan<MODE>(O, S, &plan);
  if (err) return err;
  return kernel_info(lane_softplus_pixel_kernel<MODE>, plan.blocks, SP_THREADS,
                     4 * softplus_smem_floats(plan.kb), out);
}

// lane_step_sweep's launch at B lanes of SC scales (`tiles` as in
// sdsm_lane_step_sweep).
extern "C" int sdsm_lane_split_step_sweep_info(int* out, int B, int SC, int tiles, void*) {
  SoftplusPlan plan;
  const int err = softplus_pixel_plan<STEP_SWEEP>(B, SC, &plan, tiles);
  if (err) return err;
  return kernel_info(lane_step_sweep_kernel, plan.blocks, SP_THREADS,
                     4 * softplus_smem_floats(plan.kb), out);
}

// softplus_energies' launch at O lanes of S outputs in `mode`; `pr13`:
// PR 13's kernel and plan.
extern "C" int sdsm_lane_split_softplus_info(int* out, int O, int S, int mode, int pr13,
                                             void*) {
  switch (mode) {
    case LINE_SEARCH: return softplus_info<LINE_SEARCH>(out, O, S, pr13);
    case SCALE_SWEEP: return softplus_info<SCALE_SWEEP>(out, O, S, pr13);
    default: return softplus_info<SINGLE>(out, O, S, pr13);
  }
}

// One softplus term a thread, its operands loaded and the term stored, as
// the kernels build it: --split counts its SASS instructions.
template <int MODE>
__global__ void softplus_term_probe(SoftplusTerm<MODE> term, float* out) {
  const int i = threadIdx.x;
  const float sv = term.s[i], yv = term.y[i], wv = term.w[i];
  float x;
  if (MODE == LINE_SEARCH)
    x = -__fmul_rn(yv, __fadd_rn(sv, __fmul_rn(term.u[i], term.c[0])));
  else if (MODE == SCALE_SWEEP)
    x = __fmul_rn(-__fmul_rn(yv, sv), term.c[0]);
  else
    x = -__fmul_rn(yv, sv);
  out[i] = __fmul_rn(wv, logaddexp0(x));
}

// The probe's registers in `mode` (and the reason its code is emitted).
extern "C" int sdsm_lane_split_probe_regs(int mode, void*) {
  cudaFuncAttributes a;
  cudaError_t err = mode == LINE_SEARCH ? cudaFuncGetAttributes(&a, softplus_term_probe<LINE_SEARCH>)
                    : mode == SCALE_SWEEP ? cudaFuncGetAttributes(&a, softplus_term_probe<SCALE_SWEEP>)
                                          : cudaFuncGetAttributes(&a, softplus_term_probe<SINGLE>);
  return err == cudaSuccess ? a.numRegs : -(int)err;
}

// softplus_energies' launches with k tiles (0: the plan's own).
extern "C" int sdsm_lane_split_softplus_tiles(int k, void*) {
  g_split_tiles = k;
  return 0;
}

// sdsm_lane_softplus_energies with PR 13's kernel and plan.
extern "C" int sdsm_lane_split_softplus_pr13(const float* s, const float* u,
                                             const float* y, const float* w,
                                             const float* c, float* out, int O, int L,
                                             int S, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case LINE_SEARCH:
      return launch_softplus_pr13<LINE_SEARCH>({s, u, y, w, c, L}, out, O, L, S, st);
    case SCALE_SWEEP:
      return launch_softplus_pr13<SCALE_SWEEP>({s, u, y, w, c, L}, out, O, L, S, st);
    default:
      return launch_softplus_pr13<SINGLE>({s, u, y, w, c, L}, out, O, L, 1, st);
  }
}
#endif

namespace {

// A cluster route's kernel (sdsm_lane_chol_route's numbers 1-3) in variant
// `step` (STEP_PLAIN, STEP_GUARD, STEP_FULL).
struct CholKernel {
  void (*kernel)(const float*, const float*, float*, float*, int, StepArgs);
  int C;
  bool global;
};

template <int STEP>
CholKernel chol_kernel_of(int route) {
  switch (route) {
    case 1: return {lane_cholesky_cluster_kernel<CHOL_CLUSTER, false, STEP>, CHOL_CLUSTER, false};
    case 2:
      return {lane_cholesky_cluster_kernel<CHOL_WIDE_CLUSTER, false, STEP>, CHOL_WIDE_CLUSTER,
              false};
    default:
      return {lane_cholesky_cluster_kernel<CHOL_WIDE_CLUSTER, true, STEP>, CHOL_WIDE_CLUSTER, true};
  }
}

CholKernel chol_kernel(int route, int step) {
  return step == STEP_FULL    ? chol_kernel_of<STEP_FULL>(route)
         : step == STEP_GUARD ? chol_kernel_of<STEP_GUARD>(route)
                              : chol_kernel_of<STEP_PLAIN>(route);
}

// Sets the dynamic shared memory maximum of route `route`'s kernel (variant
// `step`) to what the card's opt-in maximum leaves beside its static shared
// memory (the stamped build's words), the same value at every launch
// (threads launching concurrently set the same one), and on the wide routes
// allows its non-portable cluster size; once a device, route and variant.
// *avail: that maximum.
template <class K>
int chol_setup(K* kernel, int route, int step, int* avail) {
  static std::atomic<int> known[MAX_DEVICES][4][3];  // avail + 1, 0: not set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int seen = known[dev][route][step].load(std::memory_order_acquire);
  if (seen > 0) {
    *avail = seen - 1;
    return 0;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    *avail = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *avail);
  }
  if (err == cudaSuccess && route >= 2)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  known[dev][route][step].store(*avail + 1, std::memory_order_release);
  return 0;
}

// The launch of cluster route `route` (variant `step`) at (B, n) on
// `stream`: B clusters of C blocks (a launch attribute), its kernel set up.
// Returns 0 or a CUDA error (cudaErrorInvalidValue where the block's shared
// memory passes the card's maximum).
int chol_cluster_config(int route, int step, long long B, int n, cudaStream_t stream,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, CholKernel* k) {
  *k = chol_kernel(route, step);
  int avail = 0;
  const int err = chol_setup(k->kernel, route, step, &avail);
  if (err) return err;
  const long long bytes = chol_step_bytes(n, k->C, k->global, step);
  if (bytes > avail || B * k->C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *cfg = {};
  cfg->gridDim = dim3((unsigned)(B * k->C));
  cfg->blockDim = dim3(CHOL_MAX_THREADS);
  cfg->dynamicSmemBytes = (size_t)bytes;
  cfg->stream = stream;
  *attr = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)k->C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

int launch_chol_cluster(int route, int step, const float* H, const float* g, float* out,
                        float* scratch, int B, int n, const StepArgs& sa, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  CholKernel k;
  const int err = chol_cluster_config(route, step, B, n, stream, &cfg, &attr, &k);
  if (err) return err;
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, k.kernel, H, g, out, scratch, n, sa);
  return launch != cudaSuccess ? (int)launch : (int)cudaGetLastError();
}

// Floats of a lane's scratch on `route` (1-3), 0 past the int range (the
// same in every variant).
int chol_route_floats(int route, int n) {
  const CholKernel k = chol_kernel(route, STEP_PLAIN);
  const long long f = chol_scratch_floats(n, k.C, k.global);
  return f > 0x7fffffffLL ? 0 : (int)f;
}

template <int STEP>
int launch_chol_one_block(const float* H, const float* g, float* out, int B, int n,
                          const StepArgs& sa, cudaStream_t stream) {
  int avail = 0;
  const int err = chol_setup(lane_cholesky_kernel<STEP>, 0, STEP, &avail);
  if (err) return err;
  const long long bytes = 4 * (chol_floats(n) + (STEP == STEP_PLAIN ? 0 : GUARD_FLOATS));
  if (bytes > avail) return (int)cudaErrorInvalidValue;
  const int threads = n <= 32 ? 64 : n <= 64 ? 128 : 256;
  lane_cholesky_kernel<STEP><<<B, threads, (size_t)bytes, stream>>>(H, g, out, n, sa);
  return (int)cudaGetLastError();
}

// lane_cholesky's launch of variant `step` on `route` (sdsm_lane_chol_route).
int launch_cholesky(int route, int step, const float* H, const float* g, float* out,
                    float* scratch, int B, int n, const StepArgs& sa, cudaStream_t st) {
  if (route == 0) {
    return step == STEP_FULL    ? launch_chol_one_block<STEP_FULL>(H, g, out, B, n, sa, st)
           : step == STEP_GUARD ? launch_chol_one_block<STEP_GUARD>(H, g, out, B, n, sa, st)
                                : launch_chol_one_block<STEP_PLAIN>(H, g, out, B, n, sa, st);
  }
  if (scratch == nullptr || chol_route_floats(route, n) == 0) return (int)cudaErrorInvalidValue;
  return launch_chol_cluster(route, step, H, g, out, scratch, B, n, sa, st);
}

// The guard's StepArgs (and the damped system's, where given).
StepArgs guard_args(const float* params, const float* mu, const float* alpha,
                    const float* kmask, const float* steps, const float* f0, float* delta,
                    float* decrement, float* reg_cand, float* thr, int S, float eps,
                    float inv_n, float tiny, float sq_eps, float armijo) {
  StepArgs sa = {};
  sa.params = params, sa.mu = mu, sa.alpha = alpha, sa.kmask = kmask, sa.steps = steps;
  sa.f0 = f0, sa.delta = delta, sa.decrement = decrement, sa.reg_cand = reg_cand, sa.thr = thr;
  sa.S = S, sa.eps = eps, sa.inv_n = inv_n, sa.tiny = tiny, sa.sq_eps = sq_eps;
  sa.armijo = armijo;
  return sa;
}

}  // namespace

extern "C" int sdsm_lane_chol_one_block_max_n() { return CHOL_ONE_BLOCK_MAX_N; }
extern "C" int sdsm_lane_chol_cluster_max_n() { return CHOL_CLUSTER_MAX_N; }
extern "C" int sdsm_lane_chol_wide_max_n() { return CHOL_WIDE_MAX_N; }

// lane_cholesky's route at (B, n), from n and B (an entry's order, and so
// its bits, follows from n alone):
//   0: n <= CHOL_ONE_BLOCK_MAX_N, or n <= CHOL_MANY_LANES_MAX_N with more
//      lanes than the card holds clusters at once: one block a lane, in
//      shared memory;
//   1: n <= CHOL_CLUSTER_MAX_N: a cluster of 8 blocks a lane, the panels
//      in shared memory;
//   2: n <= CHOL_WIDE_MAX_N: a cluster of 16 blocks a lane, the panels in
//      shared memory;
//   3: above: a cluster of 16 blocks a lane, the panels and the widened
//      panel in the global scratch.
// (The stream is not used: every entry point takes one.)
extern "C" int sdsm_lane_chol_route(int B, int n, void*) {
  if (n <= CHOL_ONE_BLOCK_MAX_N ||
      ((long long)B * CHOL_CLUSTER > sm_count() && n <= CHOL_MANY_LANES_MAX_N))
    return 0;
  return n <= CHOL_CLUSTER_MAX_N ? 1 : n <= CHOL_WIDE_MAX_N ? 2 : 3;
}

// Floats of a lane's scratch on that route: none on route 0; the
// published panels, and on route 3 a widened panel a block; 0 where they
// pass the int range (the launch is then refused).
extern "C" int sdsm_lane_chol_scratch_floats(int B, int n, void*) {
  if (B < 0 || n < 0) return 0;
  const int route = sdsm_lane_chol_route(B, n, nullptr);
  return route == 0 ? 0 : chol_route_floats(route, n);
}

// The clusters of lane_cholesky's launch at (B, n) that the card holds at
// once (cudaOccupancyMaxActiveClusters; 0 on route 0), or minus a CUDA
// error.
extern "C" int sdsm_lane_chol_clusters(int B, int n, void*) {
  const int route = sdsm_lane_chol_route(B, n, nullptr);
  if (route == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  CholKernel k;
  int err = chol_cluster_config(route, STEP_PLAIN, B, n, nullptr, &cfg, &attr, &k);
  int clusters = 0;
  if (!err) err = (int)cudaOccupancyMaxActiveClusters(&clusters, k.kernel, &cfg);
  return err ? -err : clusters;
}

// The library's load-time check: the card holds at least one cluster of
// every cluster route at its largest shared memory (n =
// CHOL_CLUSTER_MAX_N, CHOL_WIDE_MAX_N, and 2048, the largest DSM bucket,
// on route 3). 0, a CUDA error, or cudaErrorLaunchOutOfResources where the
// card holds none.
extern "C" int sdsm_lane_chol_check(void*) {
  for (int n : {CHOL_CLUSTER_MAX_N, CHOL_WIDE_MAX_N, 2048}) {
    const int clusters = sdsm_lane_chol_clusters(1, n, nullptr);
    if (clusters < 0) return -clusters;
    if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
  }
  return 0;
}

// delta (B, n) = solver._cholesky_direction(Hd, g), Hd (B, n, n) and g
// (B, n) float32 contiguous, in one launch on `stream`, on the route of
// sdsm_lane_chol_route; scratch: B sdsm_lane_chol_scratch_floats(B, n)
// floats (unused, may be null, on route 0). A cluster launch the card
// refuses returns its error: no other route is taken.
extern "C" int sdsm_lane_cholesky(const float* H, const float* g, float* out,
                                  float* scratch, int B, int n, void* stream) {
  if (B < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return launch_cholesky(sdsm_lane_chol_route(B, n, nullptr), STEP_PLAIN, H, g, out, scratch, B,
                         n, StepArgs{}, st);
}

#ifdef SDSM_SPLIT
// chip_smoke.py --split: lane_cholesky on a cluster route (1-3) forced at
// any n where its shared memory holds the panels, its scratch floats a
// lane, and what the card reports for the launch.
extern "C" int sdsm_lane_split_chol_floats(int n, int route, void*) {
  return route >= 1 && route <= 3 ? chol_route_floats(route, n) : 0;
}

extern "C" int sdsm_lane_split_cholesky(const float* H, const float* g, float* out,
                                        float* scratch, int B, int n, int route,
                                        void* stream) {
  if (B <= 0 || n <= 0 || scratch == nullptr || sdsm_lane_split_chol_floats(n, route, nullptr) == 0)
    return (int)cudaErrorInvalidValue;
  return launch_chol_cluster(route, STEP_PLAIN, H, g, out, scratch, B, n, StepArgs{},
                             (cudaStream_t)stream);
}

extern "C" int sdsm_lane_split_chol_info(int* out, int B, int n, int route, void*) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  CholKernel k;
  int err = chol_cluster_config(route, STEP_PLAIN, B, n, nullptr, &cfg, &attr, &k);
  cudaFuncAttributes a;
  int clusters = 0;
  if (!err) err = (int)cudaFuncGetAttributes(&a, k.kernel);
  if (!err) err = (int)cudaOccupancyMaxActiveClusters(&clusters, k.kernel, &cfg);
  if (err) return err;
  const int v[7] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    (int)cfg.dynamicSmemBytes, clusters, CHOL_MAX_THREADS, (int)cfg.gridDim.x};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
#endif

// (g', Hd) = the damped Newton system of solver._newton_step for B lanes
// (lane_lm_system_kernel): params, g (B, n), H (B, n, n), mu, alpha (B,),
// kmask (B, n - 6) float32 contiguous (alpha, kmask and g_out unused at n
// <= 6); eps, inv_n and tiny the float32 values of epsilon, 1 / n and
// 1e-12; one launch of B ceil(n / LM_ROWS) blocks on `stream`.
extern "C" int sdsm_lane_lm_system(const float* params, const float* mu, const float* alpha,
                                   const float* kmask, const float* g, const float* H,
                                   float* g_out, float* Hd, int B, int n, float eps,
                                   float inv_n, float tiny, void* stream) {
  if (B < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const int tiles = (n + LM_ROWS - 1) / LM_ROWS;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  StepArgs sa = {};
  sa.params = params, sa.mu = mu, sa.alpha = alpha, sa.kmask = kmask;
  sa.eps = eps, sa.inv_n = inv_n, sa.tiny = tiny;
  lane_lm_system_kernel<<<(unsigned)blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      sa, g, H, g_out, Hd, n, tiles);
  return (int)cudaGetLastError();
}

// (delta, decrement, reg_cand, thr) = the step guard of solver._newton_step
// for B lanes (lane_step_guard_kernel): dir, g, params (B, n), alpha, f0
// (B,), kmask (B, n - 6), steps (S,) float32 contiguous, 1 <= S <=
// GUARD_MAX_S, n <= GUARD_MAX_N; delta (B, n), decrement (B,), thr (B, S),
// reg_cand (B, S) (unused, may be null, at n <= 6, as are alpha, kmask and
// params); eps, sq_eps and armijo the float32 values of epsilon,
// sqrt(epsilon) and the Armijo constant; one block a lane on `stream`.
extern "C" int sdsm_lane_step_guard(const float* dir, const float* g, const float* params,
                                    const float* alpha, const float* kmask,
                                    const float* steps, const float* f0, float* delta,
                                    float* decrement, float* reg_cand, float* thr, int B,
                                    int n, int S, int negate, float eps, float sq_eps,
                                    float armijo, void* stream) {
  if (B < 0 || n < 0 || n > GUARD_MAX_N || S < 1 || S > GUARD_MAX_S)
    return (int)cudaErrorInvalidValue;
  if (n > 6 && reg_cand == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const StepArgs sa = guard_args(params, nullptr, alpha, kmask, steps, f0, delta, decrement,
                                 reg_cand, thr, S, eps, 0.0f, 0.0f, sq_eps, armijo);
  lane_step_guard_kernel<<<B, ROW_THREADS, (size_t)n * sizeof(float), (cudaStream_t)stream>>>(
      sa, dir, g, n, negate);
  return (int)cudaGetLastError();
}

// (delta, decrement, reg_cand, thr) = the direction of solver._newton_step
// and its guard for B lanes in one launch, the step variants of lane_pcg
// and lane_cholesky (see above lane_pcg): with `prologue`, H (B, n, n) and g
// (B, n) are the raw system, damped in the kernel as sdsm_lane_lm_system
// damps it (params, mu, alpha, kmask; eps, inv_n and tiny), else H and g
// are the damped system (g' of the guard); with `pcg` the direction is
// PCG's (iters, stop2 and cg_eps as sdsm_lane_pcg takes them), negated in
// the guard, else Cholesky's on the route of sdsm_lane_chol_route (scratch:
// B sdsm_lane_chol_scratch_floats(B, n) floats, null on route 0); the
// guard's steps, f0 and outputs as sdsm_lane_step_guard takes them (alpha,
// kmask and reg_cand unused at n <= 6), float32 contiguous, 1 <= S <=
// GUARD_MAX_S. The prologue with PCG past PCG_REG_MAX_N is refused (its
// caller damps the system with sdsm_lane_lm_system first), as is any launch
// the card refuses: no other kernel is taken.
extern "C" int sdsm_lane_newton_direction(
    const float* H, const float* g, const float* params, const float* mu, const float* alpha,
    const float* kmask, const float* steps, const float* f0, float* delta, float* decrement,
    float* reg_cand, float* thr, float* scratch, int B, int n, int S, int pcg, int prologue,
    int iters, float eps, float inv_n, float tiny, float sq_eps, float armijo, float stop2,
    float cg_eps, void* stream) {
  if (B < 0 || n < 0 || S < 1 || S > GUARD_MAX_S || iters < 0) return (int)cudaErrorInvalidValue;
  if ((n > 6 && (alpha == nullptr || kmask == nullptr || reg_cand == nullptr)) ||
      (prologue && mu == nullptr) || (pcg && prologue && n > PCG_REG_MAX_N))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const StepArgs sa = guard_args(params, mu, alpha, kmask, steps, f0, delta, decrement, reg_cand,
                                 thr, S, eps, inv_n, tiny, sq_eps, armijo);
  const int step = prologue ? STEP_FULL : STEP_GUARD;
  cudaStream_t st = (cudaStream_t)stream;
  if (pcg) return launch_pcg(step, H, g, nullptr, B, n, iters, stop2, cg_eps, sa, st);
  return launch_cholesky(sdsm_lane_chol_route(B, n, nullptr), step, H, g, nullptr, scratch, B, n,
                         sa, st);
}

#ifdef SDSM_SPLIT
// chip_smoke.py --split: what the card reports for the direction launch
// with the prologue (sdsm_lane_newton_direction's) at (B, n).
extern "C" int sdsm_lane_split_step_info(int* out, int B, int n, int pcg, void*) {
  if (pcg) {
    if (n > PCG_REG_MAX_N) return (int)cudaErrorInvalidValue;
    return kernel_info(lane_pcg_reg_kernel<STEP_FULL>, (long long)B * PCG_CLUSTER, PCG_THREADS,
                       0, out);
  }
  const int route = sdsm_lane_chol_route(B, n, nullptr);
  if (route == 0) {
    int avail = 0;
    const int err = chol_setup(lane_cholesky_kernel<STEP_FULL>, 0, STEP_FULL, &avail);
    if (err) return err;
    return kernel_info(lane_cholesky_kernel<STEP_FULL>, B, n <= 32 ? 64 : n <= 64 ? 128 : 256,
                       (size_t)(4 * (chol_floats(n) + GUARD_FLOATS)), out);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  CholKernel k;
  int err = chol_cluster_config(route, STEP_FULL, B, n, nullptr, &cfg, &attr, &k);
  cudaFuncAttributes a;
  int clusters = 0;
  if (!err) err = (int)cudaFuncGetAttributes(&a, k.kernel);
  if (!err) err = (int)cudaOccupancyMaxActiveClusters(&clusters, k.kernel, &cfg);
  if (err) return err;
  const int v[7] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    (int)cfg.dynamicSmemBytes, clusters, CHOL_MAX_THREADS, (int)cfg.gridDim.x};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
#endif

// (t_step, new_params, new_s, new_f, improved, full_step) = the line search's
// pick of solver._step_tail for B lanes (lane_step_pick_kernel):
// data_cand, thr (B, S), reg_cand (B, S) (null at n <= 6), f0 (B,), steps
// (S,), params, delta (B, n), s, u (B, P) (both null without a surface, as
// is new_s) float32 contiguous, 1 <= S <= GUARD_MAX_S; improved and
// full_step (B,) bool; one launch of B STEP_BLOCKS blocks on `stream`.
extern "C" int sdsm_lane_step_pick(const float* data_cand, const float* reg_cand,
                                   const float* thr, const float* f0, const float* steps,
                                   const float* params, const float* delta, const float* s,
                                   const float* u, float* t_step, float* new_params, float* new_s,
                                   float* new_f, unsigned char* improved,
                                   unsigned char* full_step, int B, int n, int P, int S,
                                   void* stream) {
  if (B < 0 || n < 0 || P < 0 || S < 1 || S > GUARD_MAX_S) return (int)cudaErrorInvalidValue;
  if ((s == nullptr) != (u == nullptr) || (s != nullptr && new_s == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const long long blocks = (long long)B * STEP_BLOCKS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_step_pick_kernel<<<(unsigned)blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      PickArgs{data_cand, reg_cand, thr, f0, steps, params, delta, s, u, t_step, new_params,
               new_s, new_f, improved, full_step, n, P, S});
  return (int)cudaGetLastError();
}

// The scale sweep's pick, the new mu, the convergence test and, with
// `freeze`, the loop's freeze writes, for B lanes (lane_step_tail_kernel):
// data_sc (B, S), new_params (B, n), new_s (B, P) (null without a surface,
// as is s), new_f, mu, f0, decrement (B,), alpha (B,) and kmask (B, n - 6)
// (unused at n <= 6), scales (S,) float32 contiguous, improved and full_step
// (B,) bool, 1 <= S <= GUARD_MAX_S; out: params (B, n), s (B, P), fval,
// mu_out (B,) float32, conv (B,) bool; with `freeze` these are the loop's
// own (mu_out the same as mu, fval as f0 or null; it_lane (B,) and it_dev
// () int32, or both null); eps, sq_eps, tol, mu_min, mu_max and mu_small the
// float32 values of epsilon, sqrt(epsilon), tol, MU_MIN, MU_MAX and 1e-4;
// one launch of B clusters of STEP_BLOCKS blocks on `stream`.
extern "C" int sdsm_lane_step_tail(const float* data_sc, const float* new_params,
                                   const float* new_s, const float* new_f,
                                   const unsigned char* improved, const unsigned char* full_step,
                                   const float* mu, const float* f0, const float* decrement,
                                   const float* alpha, const float* kmask, const float* scales,
                                   float* params, float* s, float* fval, float* mu_out,
                                   unsigned char* conv, int* it_lane, const int* it_dev, int B,
                                   int n, int P, int S, int freeze, float eps, float sq_eps,
                                   float tol, float mu_min, float mu_max, float mu_small,
                                   void* stream) {
  if (B < 0 || n < 0 || P < 0 || S < 1 || S > GUARD_MAX_S) return (int)cudaErrorInvalidValue;
  if ((new_s == nullptr) != (s == nullptr) || (it_lane == nullptr) != (it_dev == nullptr) ||
      (n > 6 && (alpha == nullptr || kmask == nullptr)) || (!freeze && fval == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const long long blocks = (long long)B * STEP_BLOCKS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lane_step_tail_kernel<<<(unsigned)blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      TailArgs{data_sc, new_params, new_s, new_f, improved, full_step, mu, f0, decrement, alpha,
               kmask, scales, params, s, fval, mu_out, conv, it_lane, it_dev, n, P, S, freeze,
               eps, sq_eps, tol, mu_min, mu_max, mu_small});
  return (int)cudaGetLastError();
}

// The pick, the scale sweep's data energies and the tail with the loop's
// freeze writes of solver._newton_step in the loop, for B lanes
// (lane_step_sweep_kernel): bitwise sdsm_lane_step_pick, then
// sdsm_lane_softplus_energies in mode 1 on its new_s, then
// sdsm_lane_step_tail with `freeze`. data_cand, thr (B, S), reg_cand (B, S)
// (null at n <= 6), steps (S,), delta (B, n), u, y, w (B, P), decrement,
// alpha (B,) and kmask (B, n - 6) (both null at n <= 6), scales (SC,)
// float32 contiguous, 1 <= S, SC <= GUARD_MAX_S; the loop's params (B, n),
// s (B, P), fval and mu (B,) float32 and conv (B,) bool, written in place
// in the lanes whose conv was false; it_lane (B,) and it_dev () int32, or
// both null; the solve's arrivals (B,) int32, all 0 (and 0 again after the
// launch), and sums (B, SC) float32 scratch; tiles 0 (the plan's) or the
// tiles of each lane's scales forced; eps, sq_eps, tol, mu_min, mu_max,
// mu_small as sdsm_lane_step_tail's. One launch on `stream`.
extern "C" int sdsm_lane_step_sweep(
    const float* data_cand, const float* reg_cand, const float* thr, const float* steps,
    const float* delta, const float* u, const float* y, const float* w, const float* decrement,
    const float* alpha, const float* kmask, const float* scales, float* params, float* s,
    float* fval, float* mu, unsigned char* conv, int* it_lane, const int* it_dev, int* arrivals,
    float* sums, int B, int n, int P, int S, int SC, int tiles, float eps, float sq_eps,
    float tol, float mu_min, float mu_max, float mu_small, void* stream) {
  if (B < 0 || n < 0 || P < 0 || S < 1 || S > GUARD_MAX_S || SC < 1 || SC > GUARD_MAX_S ||
      tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (!data_cand || !thr || !steps || !delta || !decrement || !scales || !params || !fval ||
      !mu || !conv || !arrivals || !sums || (P > 0 && (!u || !y || !w || !s)) ||
      (it_lane == nullptr) != (it_dev == nullptr) ||
      (n > 6 && (reg_cand == nullptr || alpha == nullptr || kmask == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_step_sweep(
      SoftplusTerm<STEP_SWEEP>{s, u, y, w, scales, P},
      SweepArgs{data_cand, n > 6 ? reg_cand : nullptr, thr, steps, delta, decrement, alpha,
                kmask, params, s, fval, mu, conv, it_lane, it_dev, arrivals, sums, n, S, eps,
                sq_eps, tol, mu_min, mu_max, mu_small},
      B, SC, tiles, (cudaStream_t)stream);
}
