// The Newton gram at the few-parameter sizes n = 6, 32 and 64, for NVIDIA
// Hopper (sm_90a): one launch a gram, float64 products and sums.
//
// Per lane b, over the pixels p of its padded region (as gram_grad_hess.cu):
//   t = y s,  sig = sigmoid(-t),
//   term1 = -y sig w,  kappa = w y^2 sig (1 - sig)     (float32)
//   g = Bf^T term1                    (n,)
//   H = Bf^T diag(kappa) Bf           (n, n)
//
// Replaces no Pallas kernel: the JAX package's Pallas grams serve n % 128 ==
// 0 only, and it computes these sizes with its XLA twin _data_grad_hess
// (superdsm_tpu/dsm/solver.py). Here they are the 6-parameter solves (n = 6)
// and the DSM lanes with K <= 58 (n = 32, 64), which the port computed with
// gram.grad_hess_plain: casts to float64, cuBLAS float64 products whose
// blocks each walk a lane's whole pixel range, casts back, several launches
// an iteration.
//
// Arithmetic: the function of gram.grad_hess_plain at 6 passes. kappa and
// term1 in float32 as gram._logistic_weights; each product of H formed in
// float64 as (B_pi kappa_p) B_pj (the first factor is exact in float64),
// each product of g as B_pi term1_p (exact); every sum over the pixels in
// float64; g and H rounded to float32 once. Only the order of the float64
// sums differs from the plain version.
//
// What bounds it on the card: per pixel 4 n + 12 bytes are read against
// n (n + 1) + 2 n float64 operations, 1.5 FLOP a byte at n = 6, 8 at n = 32,
// 16 at n = 64, below the 20 FLOP a byte at which the float64 tensor cores
// (67 TFLOP/s on an H100 SXM) meet HBM3 (3.35 TB/s): on paper HBM bytes
// bound all three sizes. Measured on an H100 (PERF.md), the n = 64 launch
// is bound by its products instead, its time scarcely changed without its
// copies: float64 mma.sync runs well below that peak. The design:
// * one block of 256 threads a (lane, pixel segment); the pixels stream in
//   chunks through a ring of STAGES shared-memory stages filled by 16-byte
//   cp.async, one __syncthreads a chunk;
// * n = 32, 64: each warp takes two k-steps of 4 pixel rows of a chunk and
//   keeps the whole upper triangle of 8 x 8 tiles of H in registers, as 20
//   (n = 64) or 6 (n = 32) blocks of 16 x 8, each updated by one float64
//   mma.sync m16n8k4 a k-step (a block on the diagonal computes 8 x 8
//   entries below it for nothing, 11% more work than the triangle at
//   n = 64). A lane converts its 8 (4) feature values of one row to float64
//   once and scales them by kappa: the same fragment layout serves A
//   (B kappa) and B (B). The staged rows are padded to put the 4 rows of a
//   k-step on distinct banks. g is summed by DFMA from the same values;
// * n = 6: one pixel row a thread, its 21 products of H and 6 of g by DFMA;
// * the warps' (threads') partials are summed in a fixed order (shuffles,
//   then the warps in order through shared memory);
// * split-P: gram.narrow_plan picks the segment from (P, n) alone, never
//   from B or the active lanes, so a lane's sums are the same in every
//   batch. Each segment's float64 partial goes to scratch; the lane's last
//   block to arrive (a counter per lane) sums the segments in order
//   s = 0, 1, ... and writes H (the upper triangle, mirrored) and g. One
//   segment writes them directly;
// * a chunk whose pixel weights are all 0 (the padded tail up to the bucket)
//   adds exact zeros and is neither loaded nor summed (a block reads its
//   segment's weights first); the bits do not change, since a float64 sum
//   that starts at +0 never holds -0;
// * a frozen lane (active == 0) reads nothing and gives zeros.
//
// Alignment: P is a multiple of the chunk rows (the wrapper pads); Bf, s, y
// and w are 16-byte aligned (checked by the wrapper), so every cp.async
// source is.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;             // cp.async ring depth
constexpr int MAX_SEG_CHUNKS = 1024;  // live-chunk flags a block holds
constexpr int KSTEPS = 2;             // 4-row k-steps a warp takes a chunk (MMA sizes)

// The geometry of size N. MMA sizes: a chunk is KSTEPS 4-row k-steps a
// warp, a staged row holds N + 8 floats (row stride = 8 banks mod 32); the
// triangle of 8 x 8 tiles is covered by NB * (NT - NB + 1) m16n8k4 blocks
// (16 rows of tiles 2 i, 2 i + 1 against the tiles J >= 2 i). n = 6: a
// chunk is one row a thread.
template <int N>
struct Geo {
  static constexpr bool MMA = N != 6;
  static constexpr int ROWS = MMA ? 4 * WARPS * KSTEPS : THREADS;
  static constexpr int LD = MMA ? N + 8 : N;
  static constexpr int NT = MMA ? N / 8 : 1;
  static constexpr int NB = NT / 2;
  static constexpr int OPS = NB * (NT - NB + 1);
  static constexpr int TILES = NT * (NT + 1) / 2;
  // float64 entries of a partial: every tile's 8 x 8 fragment (MMA) or the
  // upper triangle (n = 6), then g
  static constexpr int HE = MMA ? TILES * 64 : N * (N + 1) / 2;
  static constexpr int ENTRIES = HE + N;
};

template <int N>
struct Stage {
  float bf[Geo<N>::ROWS * Geo<N>::LD];
  float s[Geo<N>::ROWS];
  float y[Geo<N>::ROWS];
  float w[Geo<N>::ROWS];
};

template <int N>
constexpr int smem_bytes() {
  constexpr int ring = STAGES * (int)sizeof(Stage<N>);
  constexpr int red = WARPS * Geo<N>::ENTRIES * (int)sizeof(double);
  return ring > red ? ring : red;
}

static_assert(Geo<32>::ROWS * 32 % (4 * THREADS) == 0 &&
              Geo<64>::ROWS * 64 % (4 * THREADS) == 0, "copy split");
static_assert(sizeof(Stage<6>) % 16 == 0 && sizeof(Stage<32>) % 16 == 0 &&
              sizeof(Stage<64>) % 16 == 0, "stage alignment");
static_assert(smem_bytes<64>() <= 227 * 1024, "shared memory");
static_assert(Geo<6>::ROWS == THREADS, "n = 6: a row a thread");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// d += a b over a k-step: the 16 x 4 A fragment (rows g and g + 8 of the
// lane's group g = lane / 4, column lane % 4), the 4 x 8 B fragment (row
// lane % 4, column g); d: rows g and g + 8, columns 2 (lane % 4) + 0, 1.
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, "
      "{%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Index of the upper-triangle tile (I, J), I <= J, enumerated row by row.
template <int NT>
__host__ __device__ constexpr int tile_index(int I, int J) {
  return I * NT - I * (I - 1) / 2 + (J - I);
}

// The logistic weights of one pixel, as gram._logistic_weights rounds them.
__device__ __forceinline__ void logistic(float s, float y, float w,
                                         float& term1, float& kappa) {
  const float t = y * s;
  const float sig = 1.f / (1.f + expf(t));  // sigmoid(-t)
  term1 = -y * sig * w;
  kappa = w * y * y * sig * (1.f - sig);
}

// The upper-triangle tile (I, J), I <= J, of index t, enumerated row by row.
template <int NT>
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  I = 0;
  while (t >= NT - I) {
    t -= NT - I;
    ++I;
  }
  J = I + t;
}

// Issues the copies of chunk c (Bf rows, s, y, w) into `st`.
template <int N>
__device__ __forceinline__ void load_chunk(Stage<N>& st, const float* Bfb,
                                           const float* sb, const float* yb,
                                           const float* wb, int c, int tid) {
  using G = Geo<N>;
  constexpr int PIECES = G::ROWS * N / 4;
  const float* src = Bfb + (size_t)c * G::ROWS * N;
  for (int k = tid; k < PIECES; k += THREADS) {
    const int r = k * 4 / N;  // pieces never cross a row where LD != N
    const int col = k * 4 - r * N;
    cp_async16(&st.bf[r * G::LD + col], src + k * 4);
  }
  constexpr int Q = G::ROWS / 4;
  const size_t p0 = (size_t)c * G::ROWS;
  if (tid < Q) {
    cp_async16(&st.s[tid * 4], sb + p0 + tid * 4);
  } else if (tid < 2 * Q) {
    cp_async16(&st.y[(tid - Q) * 4], yb + p0 + (tid - Q) * 4);
  } else if (tid < 3 * Q) {
    cp_async16(&st.w[(tid - 2 * Q) * 4], wb + p0 + (tid - 2 * Q) * 4);
  }
}

// Accumulators of one thread.
template <int N, bool MMA = Geo<N>::MMA>
struct Acc;

// n = 32, 64: the warp's m16n8k4 blocks over the upper triangle and, in
// each lane, g's partials over the lane's rows of the k-steps (columns
// 8 X + lane / 4).
template <int N>
struct Acc<N, true> {
  using G = Geo<N>;
  static constexpr int NT = G::NT;
  double c[G::OPS][4];
  double g[NT];

  __device__ void zero() {
#pragma unroll
    for (int o = 0; o < G::OPS; ++o) c[o][0] = c[o][1] = c[o][2] = c[o][3] = 0.0;
#pragma unroll
    for (int x = 0; x < NT; ++x) g[x] = 0.0;
  }

  // warp w takes k-steps w, w + WARPS, ... of the chunk (rows 4 k .. 4 k + 3)
  __device__ void add(const Stage<N>& st, int warp, int lane) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int r = 4 * (warp + WARPS * ks) + (lane & 3);
      float t1, kap;
      logistic(st.s[r], st.y[r], st.w[r], t1, kap);
      const double dk = kap;
      const double dt = t1;
      const float* row = &st.bf[r * G::LD + (lane >> 2)];
      double a[NT], b[NT];
#pragma unroll
      for (int x = 0; x < NT; ++x) {
        b[x] = (double)row[8 * x];
        a[x] = b[x] * dk;
        g[x] = fma(b[x], dt, g[x]);
      }
      int o = 0;
#pragma unroll
      for (int i = 0; i < G::NB; ++i)
#pragma unroll
        for (int J = 2 * i; J < NT; ++J) dmma(c[o++], a[2 * i], a[2 * i + 1], b[J]);
    }
  }

  // the tiles' fragments in the order of tile_index (a block's lower half
  // at J = 2 i lies below the diagonal and is dropped); g over a k-step's
  // 4 rows: (r0 + r2) + (r1 + r3) into lanes 4 m
  __device__ void dump(double* red, int lane) {
#pragma unroll
    for (int x = 0; x < NT; ++x) {
      g[x] += __shfl_down_sync(0xffffffffu, g[x], 2);
      g[x] += __shfl_down_sync(0xffffffffu, g[x], 1);
    }
    int o = 0;
#pragma unroll
    for (int i = 0; i < G::NB; ++i)
#pragma unroll
      for (int J = 2 * i; J < NT; ++J, ++o) {
        *reinterpret_cast<double2*>(&red[tile_index<NT>(2 * i, J) * 64 + lane * 2]) =
            make_double2(c[o][0], c[o][1]);
        if (J > 2 * i)
          *reinterpret_cast<double2*>(&red[tile_index<NT>(2 * i + 1, J) * 64 + lane * 2]) =
              make_double2(c[o][2], c[o][3]);
      }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int x = 0; x < NT; ++x) red[G::HE + 8 * x + (lane >> 2)] = g[x];
    }
  }
};

// n = 6: the thread's upper triangle and g over its rows.
template <int N>
struct Acc<N, false> {
  static constexpr int HE = Geo<N>::HE;
  double v[Geo<N>::ENTRIES];

  __device__ void zero() {
#pragma unroll
    for (int e = 0; e < Geo<N>::ENTRIES; ++e) v[e] = 0.0;
  }

  // thread r takes row r of the chunk
  __device__ void add(const Stage<N>& st, int warp, int lane) {
    const int r = 32 * warp + lane;
    float t1, kap;
    logistic(st.s[r], st.y[r], st.w[r], t1, kap);
    const double dk = kap;
    const double dt = t1;
    const float2* row = reinterpret_cast<const float2*>(&st.bf[r * N]);
    double a[N], b[N];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 x = row[k];
      b[2 * k] = (double)x.x;
      b[2 * k + 1] = (double)x.y;
    }
    int e = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = b[i] * dk;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j, ++e) v[e] = fma(a[i], b[j], v[e]);
#pragma unroll
    for (int i = 0; i < N; ++i) v[HE + i] = fma(b[i], dt, v[HE + i]);
  }

  // the warp's 32 threads in a fixed tree (lanes l, l + 16, then l + 8, ...)
  __device__ void dump(double* red, int lane) {
#pragma unroll
    for (int e = 0; e < Geo<N>::ENTRIES; ++e) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v[e] += __shfl_down_sync(0xffffffffu, v[e], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < Geo<N>::ENTRIES; ++e) red[e] = v[e];
    }
  }
};

// Writes the lane's total of entry e: H[i][j] and its mirror, or g[i].
template <int N>
__device__ __forceinline__ void store(float* Hb, float* gb, int e, double v) {
  using G = Geo<N>;
  const float x = (float)v;
  if (e >= G::HE) {
    gb[e - G::HE] = x;
    return;
  }
  int i, j;
  if constexpr (G::MMA) {
    int I, J;
    tile_of<G::NT>(e / 64, I, J);
    const int ln = (e % 64) / 2;  // the fragment's lane: row ln / 4, columns 2 (ln % 4) + 0, 1
    i = 8 * I + (ln >> 2);
    j = 8 * J + (ln & 3) * 2 + (e & 1);
    if (i > j) return;  // below a diagonal tile's diagonal: the mirror of its entry above
  } else {
    i = 0;
    int k = e;
    while (k >= N - i) {
      k -= N - i;
      ++i;
    }
    j = i + k;
  }
  Hb[(size_t)i * N + j] = x;
  Hb[(size_t)j * N + i] = x;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
gram_narrow_kernel(const float* __restrict__ Bf, const float* __restrict__ s,
                   const float* __restrict__ yv, const float* __restrict__ w,
                   const int* __restrict__ active, float* __restrict__ g,
                   float* __restrict__ H, double* __restrict__ part,
                   int* __restrict__ arrivals, int P, int seg_chunks) {
  using G = Geo<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned char live[MAX_SEG_CHUNKS];
  __shared__ int is_last;
  Stage<N>* stages = reinterpret_cast<Stage<N>*>(smem_raw);

  const int seg = blockIdx.x;
  const int b = blockIdx.y;
  const int nsegs = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* Hb = H + (size_t)b * N * N;
  float* gb = g + (size_t)b * N;

  if (active[b] == 0) {
    if (seg == 0) {
      for (int e = tid; e < N * N; e += THREADS) Hb[e] = 0.f;
      if (tid < N) gb[tid] = 0.f;
    }
    return;
  }

  const float* Bfb = Bf + (size_t)b * P * N;
  const float* sb = s + (size_t)b * P;
  const float* yb = yv + (size_t)b * P;
  const float* wb = w + (size_t)b * P;
  const int nchunks = P / G::ROWS;
  const int c0 = seg * seg_chunks;
  const int c1 = min(c0 + seg_chunks, nchunks);

  // the segment's chunks that hold a nonzero (or NaN) weight
  for (int i = tid; i < c1 - c0; i += THREADS) live[i] = 0;
  __syncthreads();
  {
    const float4* w4 = reinterpret_cast<const float4*>(wb + (size_t)c0 * G::ROWS);
    const int n4 = (c1 - c0) * (G::ROWS / 4);
    for (int i = tid; i < n4; i += THREADS) {
      const float4 x = __ldg(w4 + i);
      if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f)
        live[i / (G::ROWS / 4)] = 1;
    }
  }
  __syncthreads();
  auto next_live = [&](int c) {
    while (c < c1 && !live[c - c0]) ++c;
    return c;
  };

  Acc<N> acc;
  acc.zero();

  // q[i]: the chunks in the ring from the one being summed on, in pixel
  // order (c1 = none)
  int q[STAGES - 1];
  int nxt = next_live(c0);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    q[i] = nxt;
    if (nxt < c1) {
      load_chunk<N>(stages[i], Bfb, sb, yb, wb, nxt, tid);
      nxt = next_live(nxt + 1);
    }
    cp_async_commit();
  }
  for (int it = 0; q[0] < c1; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk q[0] landed; the slot of chunk it - 1 is free
    const int issued = nxt;
    if (issued < c1) {
      load_chunk<N>(stages[(it + STAGES - 1) % STAGES], Bfb, sb, yb, wb, issued, tid);
      nxt = next_live(issued + 1);
    }
    cp_async_commit();
    acc.add(stages[it % STAGES], warp, lane);
#pragma unroll
    for (int i = 0; i < STAGES - 2; ++i) q[i] = q[i + 1];
    q[STAGES - 2] = issued;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the warps' partials

  double* red = reinterpret_cast<double*>(smem_raw);
  acc.dump(red + warp * G::ENTRIES, lane);
  __syncthreads();

  // the segment's partial: the warps in order
  for (int e = tid; e < G::ENTRIES; e += THREADS) {
    double v = 0.0;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) v += red[wp * G::ENTRIES + e];
    if (nsegs == 1) {
      store<N>(Hb, gb, e, v);
    } else {
      part[((size_t)b * nsegs + seg) * G::ENTRIES + e] = v;
    }
  }
  if (nsegs == 1) return;

  // the lane's last block sums the segments in order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&arrivals[b], 1) == nsegs - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const double* lane_parts = part + (size_t)b * nsegs * G::ENTRIES;
  constexpr int PER = (G::ENTRIES + THREADS - 1) / THREADS;  // entries a thread
  double v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = 0.0;
#pragma unroll 4
  for (int sg = 0; sg < nsegs; ++sg) {
    const double* ps = lane_parts + (size_t)sg * G::ENTRIES;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * THREADS;
      if (e < G::ENTRIES) v[k] += __ldcg(ps + e);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS;
    if (e < G::ENTRIES) store<N>(Hb, gb, e, v[k]);
  }
}

// cudaFuncSetAttribute once per device and size (the n = 64 partials need
// more than 48 KB).
constexpr int MAX_DEVICES = 64;
std::atomic<bool> smem_attr_set[3][MAX_DEVICES];

template <int N>
int launch(int slot, const float* Bf, const float* s, const float* yv,
           const float* w, const int* active, float* g, float* H, double* part,
           int* arrivals, int B, int P, int seg_chunks, cudaStream_t st) {
  using G = Geo<N>;
  if (P <= 0 || P % G::ROWS || seg_chunks <= 0 || seg_chunks > MAX_SEG_CHUNKS ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nchunks = P / G::ROWS;
  const int nsegs = (nchunks + seg_chunks - 1) / seg_chunks;
  if (nsegs > 1 && (part == nullptr || arrivals == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_attr_set[slot][dev].load()) {
    err = cudaFuncSetAttribute(gram_narrow_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<N>());
    if (err != cudaSuccess) return (int)err;
    smem_attr_set[slot][dev].store(true);
  }
  if (nsegs > 1) {
    err = cudaMemsetAsync(arrivals, 0, (size_t)B * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  gram_narrow_kernel<N><<<dim3(nsegs, B), THREADS, smem_bytes<N>(), st>>>(
      Bf, s, yv, w, active, g, H, part, arrivals, P, seg_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdsm_gram_narrow_rows_6() { return Geo<6>::ROWS; }
extern "C" int sdsm_gram_narrow_rows_32() { return Geo<32>::ROWS; }
extern "C" int sdsm_gram_narrow_rows_64() { return Geo<64>::ROWS; }
extern "C" int sdsm_gram_narrow_entries_6() { return Geo<6>::ENTRIES; }
extern "C" int sdsm_gram_narrow_entries_32() { return Geo<32>::ENTRIES; }
extern "C" int sdsm_gram_narrow_entries_64() { return Geo<64>::ENTRIES; }
extern "C" int sdsm_gram_narrow_max_seg_chunks() { return MAX_SEG_CHUNKS; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 =
// launched) or cudaErrorInvalidValue for arguments the kernel does not take.
// Bf (B, P, n), s/yv/w (B, P) float32 row-major; active (B,) int32; g (B, n),
// H (B, n, n) float32; with more than one segment, part: float64 scratch of
// B * nsegs * entries(n) entries and arrivals: B int32 counters, zeroed here
// on the stream, nsegs = ceil(P / rows(n) / seg_chunks).
// Requires n in {6, 32, 64}, P % rows(n) == 0, 0 < seg_chunks <=
// max_seg_chunks, and 16-byte aligned Bf, s, yv and w.
extern "C" int sdsm_gram_narrow_grad_hess(const float* Bf, const float* s,
                                          const float* yv, const float* w,
                                          const int* active, float* g, float* H,
                                          double* part, int* arrivals, int B,
                                          int P, int n, int seg_chunks,
                                          void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 6:
      return launch<6>(0, Bf, s, yv, w, active, g, H, part, arrivals, B, P, seg_chunks, st);
    case 32:
      return launch<32>(1, Bf, s, yv, w, active, g, H, part, arrivals, B, P, seg_chunks, st);
    case 64:
      return launch<64>(2, Bf, s, yv, w, active, g, H, part, arrivals, B, P, seg_chunks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
