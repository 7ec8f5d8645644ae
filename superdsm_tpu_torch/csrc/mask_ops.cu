// The decode of the solver's bit-packed crop masks on NVIDIA Hopper
// (sm_90a): superdsm_tpu_torch/dsm/solver.py's _mask_to_pix in one launch.
//
// A problem whose crop fits goes to the card as its crop mask, bit-packed
// row-major and MSB first (np.packbits), with its crop width wd and pixel
// count cnt (batching.solve_problems, the `poly-m` / `dsm-m` transfers).
// The solver wants each lane's pixels as (r, c) pairs in np.argwhere order:
//
//   out[o, k] = (p_k / wd, p_k % wd)   for k < min(bits set, pb, cnt), p_k
//                                       the position of row o's k-th set bit;
//             = (nbits / wd, nbits % wd) for bits set <= k < cnt (nbits =
//                                       8 nbytes, the plain version's key of
//                                       an unset bit);
//             = (0, 0)                  for k >= cnt,
//
// with out (B, pb, 2) int32 and the masks (B, nbytes) uint8. The plain
// version (_mask_to_pix) unpacks every bit and compacts the set ones with a
// sort of their keyed positions; this kernel is bitwise the same.
//
// It replaces no Pallas kernel: in the JAX package the decode is XLA's
// fusion of the same ops around one lax.sort
// (superdsm_tpu/dsm/solver.py:505-532). It is a stream compaction, and
// bytes bound it: a row's nbytes read once, pb (r, c) pairs written once.
//
// Layout. A cluster of MASK_CLUSTER = 8 blocks a row, block q the q-th
// eighth of the row's 16-byte chunks; thread t of a block loads chunk
// begin + t (then + MASK_THREADS, ...) whole and takes __popc of its four
// words. Pass 1 counts the block's set bits; the blocks' totals are then
// read over distributed shared memory after one cluster barrier, which
// gives block q its offset (the bits of blocks 0 .. q - 1) and the row's
// total. Pass 2 reloads the chunks (from L1 or L2), scans their counts
// over the block (warp shuffles, then the warps' totals) and writes each
// set bit at its rank. (Writing a tile's pairs into shared memory first and
// copying them out whole, or a warp's lanes writing one chunk's bits side
// by side, measured slower on an NVIDIA H100 80GB HBM3 at 700 W:
// chip_smoke.py phase 3.) The slots past the row's total are written by
// the whole cluster, each block a strided share. The cluster barrier's
// second half is waited for only before a block leaves, so a block's total
// stays readable until every peer has read it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int MASK_CLUSTER = 8;    // blocks of a row
constexpr int MASK_THREADS = 256;  // threads of a block
constexpr int MASK_WARPS = MASK_THREADS / WARP;
constexpr int CHUNK = 16;          // bytes a thread loads at once

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Chunk c of a row (16 bytes; those past nbytes read as 0), as four words
// whose bit i is the row's position 32 j + i of the chunk's word j: each
// byte's bits reversed (MSB first), the bytes kept in order.
struct Chunk {
  uint32_t w[4];
};

__device__ __forceinline__ Chunk load_chunk(const uint8_t* __restrict__ row, int c, int nbytes,
                                            bool vec) {
  uint32_t raw[4];
  if (vec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + c);
    raw[0] = q.x;
    raw[1] = q.y;
    raw[2] = q.z;
    raw[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = c * CHUNK + 4 * j + b;
        if (i < nbytes) v |= (uint32_t)__ldg(row + i) << (8 * b);
      }
      raw[j] = v;
    }
  }
  Chunk k;
#pragma unroll
  for (int j = 0; j < 4; ++j) k.w[j] = __byte_perm(__brev(raw[j]), 0, 0x0123);
  return k;
}

__device__ __forceinline__ int chunk_bits(const Chunk& k) {
  return __popc(k.w[0]) + __popc(k.w[1]) + __popc(k.w[2]) + __popc(k.w[3]);
}

// A position p = r wd + col of a row, kept as (r, col) while p grows: one
// division where a thread's chunk starts, then a carry for each set bit
// (the card has no integer divider: a division is tens of instructions).
struct RowCol {
  int r, col, p, wd;
  __device__ __forceinline__ RowCol(int p0, int wd_) : r(p0 / wd_), col(0), p(p0), wd(wd_) {
    col = p0 - r * wd;
  }
  __device__ __forceinline__ void move_to(int q) {
    col += q - p;
    p = q;
    while (col >= wd) {
      col -= wd;
      ++r;
    }
  }
  // the pair of slot `slot` (see above)
  __device__ __forceinline__ int2 pair(int slot, int cnt) const {
    return slot < cnt ? make_int2(r, col) : make_int2(0, 0);
  }
};

// The exclusive prefix of v over the block's threads; *total gets the sum.
// Every thread calls it; `warp_sums` holds MASK_WARPS + 1 ints.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums, int* total) {
  const int t = threadIdx.x, l = t % WARP, w = t / WARP;
  int inc = v;
#pragma unroll
  for (int m = 1; m < WARP; m *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, inc, m);
    if (l >= m) inc += o;
  }
  if (l == WARP - 1) warp_sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    int s = l < MASK_WARPS ? warp_sums[l] : 0;
#pragma unroll
    for (int m = 1; m < MASK_WARPS; m *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, s, m);
      if (l >= m) s += o;
    }
    if (l < MASK_WARPS) warp_sums[l] = s;  // inclusive over the warps
  }
  __syncthreads();
  const int before = (w > 0 ? warp_sums[w - 1] : 0) + inc - v;
  *total = warp_sums[MASK_WARPS - 1];
  __syncthreads();  // warp_sums is free again
  return before;
}

__global__ void __cluster_dims__(MASK_CLUSTER, 1, 1) __launch_bounds__(MASK_THREADS)
mask_to_pix_kernel(const uint8_t* __restrict__ mb, const int* __restrict__ wd_,
                   const int* __restrict__ cnt_, int2* __restrict__ out, int nbytes, int pb,
                   int vec) {
  __shared__ int block_bits;
  __shared__ int warp_sums[MASK_WARPS + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const long long o = blockIdx.x / MASK_CLUSTER;
  const int t = threadIdx.x;
  const uint8_t* row = mb + o * nbytes;
  int2* dst = out + o * pb;
  const int chunks = (nbytes + CHUNK - 1) / CHUNK;
  const int per = (chunks + MASK_CLUSTER - 1) / MASK_CLUSTER;
  const int begin = min(chunks, q * per), end = min(chunks, begin + per);
  const int wd = __ldg(wd_ + o), cnt = __ldg(cnt_ + o);
  // pass 1: the block's set bits
  int mine = 0;
  for (int c = begin + t; c < end; c += MASK_THREADS) mine += chunk_bits(load_chunk(row, c, nbytes, vec));
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2) mine += __shfl_xor_sync(0xffffffffu, mine, m);
  if (t % WARP == 0) warp_sums[t / WARP] = mine;
  __syncthreads();
  if (t == 0) {
    int s = 0;
    for (int w = 0; w < MASK_WARPS; ++w) s += warp_sums[w];
    block_bits = s;
  }
  cluster_arrive();  // release: block_bits
  cluster_wait();
  int offset = 0, total = 0;
  for (int r = 0; r < MASK_CLUSTER; ++r) {
    const int b = *cluster.map_shared_rank(&block_bits, r);
    if (r < q) offset += b;
    total += b;
  }
  cluster_arrive();  // this block has read its peers' totals
  // pass 2: each set bit at its rank, a tile of MASK_THREADS chunks at once
  for (int base = begin; base < end; base += MASK_THREADS) {
    const int c = base + t;
    const Chunk k = c < end ? load_chunk(row, c, nbytes, vec) : Chunk{{0u, 0u, 0u, 0u}};
    int tile = 0;
    int slot = offset + block_exclusive(chunk_bits(k), warp_sums, &tile);
    if (c < end) {
      RowCol at(c * (CHUNK * 8), wd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t v = k.w[j];
        const int p0 = c * (CHUNK * 8) + 32 * j;
        while (v != 0u && slot < pb) {
          at.move_to(p0 + __ffs((int)v) - 1);
          v &= v - 1u;
          dst[slot] = at.pair(slot, cnt);
          ++slot;
        }
      }
    }
    offset += tile;
  }
  // the slots past the row's set bits: position nbits
  const RowCol end_bit(nbytes * 8, wd);
  for (int s = total + q * MASK_THREADS + t; s < pb; s += MASK_CLUSTER * MASK_THREADS)
    dst[s] = end_bit.pair(s, cnt);
  cluster_wait();  // no block leaves while a peer may read its total
}

}  // namespace

extern "C" int sdsm_mask_cluster() { return MASK_CLUSTER; }
extern "C" int sdsm_mask_threads() { return MASK_THREADS; }

// out (B, pb, 2) int32 = solver._mask_to_pix(mb, wd, cnt, pb) for mb (B,
// nbytes) uint8, wd and cnt (B,) int32 (wd >= 1), all contiguous; one
// launch of B clusters on `stream`, no host sync. Returns
// cudaGetLastError() (0 = launched) or cudaErrorInvalidValue for sizes the
// kernel does not take (8 nbytes past the int range, B past the grid).
extern "C" int sdsm_mask_to_pix(const void* mb, const int* wd, const int* cnt, int* out, int B,
                                int nbytes, int pb, void* stream) {
  if (B < 0 || nbytes < 0 || pb < 0 || nbytes > 0x0fffffff) return (int)cudaErrorInvalidValue;
  if ((long long)B * MASK_CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || pb == 0) return (int)cudaGetLastError();
  const int vec = nbytes % CHUNK == 0 && (uintptr_t)mb % CHUNK == 0;
  mask_to_pix_kernel<<<(unsigned)B * MASK_CLUSTER, MASK_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(mb), wd, cnt, reinterpret_cast<int2*>(out), nbytes, pb, vec);
  return (int)cudaGetLastError();
}
