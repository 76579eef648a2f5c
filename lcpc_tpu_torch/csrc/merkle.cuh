// The Merkle tree over any digest's parent function: the kernel behind
// blake3_cols.cu's and sha256_cols.cu's merkle_tree entry points; and the
// verifier's path walk's argument check (walk_args_ok, both digests' walk
// entry points) and end (walk_end, sha256_walk_kernel's; BLAKE3's
// merkle_walk_quad_kernel, a quad of lanes a column, ends the same way
// split by lane).
//
// A digest is 8 u32 words (LE words of the digest bytes), and Hash::parent(cv,
// l, r) writes the parent node of l || r into cv (cv may alias neither input
// it has not read).  Leaves and nodes in device memory are int64 holding u32.
//
//   merkle_tree_kernel  the whole Merkle array.  A block of 256 threads builds
//                       the subtree of 1,024 leaves, level 1 from the leaves
//                       and the rest in shared memory, writing every node to
//                       its flat offset; the last block to finish (an atomic
//                       counter) builds the levels above the subtree roots.
//                       Zero digests pad the leaves to a power of two.
//
// What bounds it: its depth above the subtree roots (the last block's
// levels, one parent's latency each), and in the subtrees the parents'
// instructions over the warps a level keeps busy, fewer at each level up.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ldst.cuh"

namespace merkle {

constexpr int kTreeThreads = 256;
constexpr int kTreeNodes = 2 * kTreeThreads;  // a level in shared memory
constexpr int kTreeLeaves = 2 * kTreeNodes;   // a block's subtree

// the first node of level lvl in the flat leaves-first array
__device__ __forceinline__ long long level_offset(long long np2, int lvl) {
  return 2 * np2 - 2 * (np2 >> lvl);
}

// Merge the n nodes s[.][0, n) (a power of two <= kTreeNodes; nodes first
// .. first + n - 1 of level lvl) level by level in shared memory down to
// one, writing every new node to its place in out.
template <class Hash>
__device__ void merge_in_smem(uint32_t (*s)[kTreeNodes], int n, int lvl, long long first,
                              long long np2, long long* __restrict__ out) {
  const long long total = 2 * np2 - 1;
  const int t = threadIdx.x;
  for (; n > 1; n >>= 1) {
    const int half = n >> 1;
    uint32_t cv[8];
    if (t < half) {
      uint32_t l[8], r[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        l[w] = s[w][2 * t];
        r[w] = s[w][2 * t + 1];
      }
      Hash::parent(cv, l, r);
    }
    __syncthreads();
    ++lvl;
    first >>= 1;
    if (t < half) {
      const long long at = level_offset(np2, lvl) + first + t;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s[w][t] = cv[w];
        out[w * total + at] = cv[w];
      }
    }
    __syncthreads();
  }
}

// Subtree b over leaves [b sub, (b + 1) sub), sub = 2^log_sub, zero
// digests past n_cols, by one block: level 1 straight from the leaves (read
// by Ld, ldst.cuh; two parents a thread, copying the leaves into out on the
// way), the levels above it in shared memory s.  Ends with s free.
template <class Hash, class Ld>
__device__ __forceinline__ void build_subtree(long long b, const long long* __restrict__ leaves,
                                              long long ld, int n_cols, long long np2,
                                              int log_sub, long long* __restrict__ out,
                                              uint32_t (*s)[kTreeNodes]) {
  const int t = threadIdx.x;
  const long long total = 2 * np2 - 1;
  const int pairs = 1 << (log_sub - 1);
  const long long first = b * pairs;  // of level 1
  for (int i = t; i < pairs; i += kTreeThreads) {
    const long long leaf = 2 * (first + i);
    uint32_t l[8], r[8], cv[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      l[w] = leaf < n_cols ? (uint32_t)Ld::ld(leaves + w * ld + leaf) : 0u;
      r[w] = leaf + 1 < n_cols ? (uint32_t)Ld::ld(leaves + w * ld + leaf + 1) : 0u;
      out[w * total + leaf] = l[w];
      out[w * total + leaf + 1] = r[w];
    }
    Hash::parent(cv, l, r);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      s[w][i] = cv[w];
      out[w * total + np2 + first + i] = cv[w];  // level 1 starts at np2
    }
  }
  __syncthreads();
  merge_in_smem<Hash>(s, pairs, 1, first, np2, out);
}

// The levels above the n subtree roots (level lvl of out, n a power of two),
// by one block: levels wider than s through L2, then the rest in s.
template <class Hash>
__device__ __forceinline__ void build_top(long long n, int lvl, long long np2,
                                          long long* __restrict__ out,
                                          uint32_t (*s)[kTreeNodes]) {
  const int t = threadIdx.x;
  const long long total = 2 * np2 - 1;
  for (; n > kTreeNodes; n >>= 1, ++lvl) {  // levels wider than s
    const long long src = level_offset(np2, lvl), dst = level_offset(np2, lvl + 1);
    for (long long i = t; i < n / 2; i += kTreeThreads) {
      uint32_t l[8], r[8], cv[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        l[w] = (uint32_t)__ldcg(out + w * total + src + 2 * i);
        r[w] = (uint32_t)__ldcg(out + w * total + src + 2 * i + 1);
      }
      Hash::parent(cv, l, r);
#pragma unroll
      for (int w = 0; w < 8; ++w) out[w * total + dst + i] = cv[w];
    }
    __syncthreads();
  }
  const long long src = level_offset(np2, lvl);
  for (int i = t; i < n; i += kTreeThreads) {
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w][i] = (uint32_t)__ldcg(out + w * total + src + i);
  }
  __syncthreads();
  merge_in_smem<Hash>(s, (int)n, lvl, 0, np2, out);
}

// Block b builds subtree b (build_subtree; at most 512 blocks for a 2^19
// tree, so all of them are resident at once and their leaf loads overlap).
// The last block to finish (a counter in device memory, which that block
// resets) builds the levels above the subtree roots (build_top).
template <class Hash>
__global__ void __launch_bounds__(kTreeThreads)
merkle_tree_kernel(const long long* __restrict__ leaves, long long ld, int n_cols,
                   long long np2, int log_sub, long long* __restrict__ out,
                   unsigned* __restrict__ counter) {
  __shared__ uint32_t s[8][kTreeNodes];
  __shared__ bool last;
  const int t = threadIdx.x;
  if (np2 == 1) {  // the leaf is the root
    if (t < 8) out[t] = (uint32_t)leaves[t * ld];
    return;
  }
  build_subtree<Hash, lcpc::LoadPlain>(blockIdx.x, leaves, ld, n_cols, np2, log_sub, out, s);
  if (gridDim.x == 1) return;
  __threadfence();  // this block's nodes are visible before its count is
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  build_top<Hash>(gridDim.x, log_sub, np2, out, s);
  if (t == 0) *counter = 0u;  // ready for the next launch on this stream
}

// The end of column j's walk: its node cv written to out[:, j] or, with
// root given, compared with it, a difference clearing *flag (the verifier's
// path check; every column that differs stores the same 0)
__device__ __forceinline__ void walk_end(const uint32_t (&cv)[8], int j, int k,
                                         long long* __restrict__ out,
                                         const long long* __restrict__ root,
                                         int32_t* __restrict__ flag) {
  if (root != nullptr) {
    bool eq = true;
#pragma unroll
    for (int w = 0; w < 8; ++w) eq &= cv[w] == (uint32_t)root[w];
    if (!eq) *flag = 0;
    return;
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[(size_t)w * k + j] = cv[w];
}

// The whole Merkle tree over leaves (8, n_cols) int64 (word stride ld,
// column stride 1), zero digests padding them to np2 (a power of two >=
// n_cols): out (8, 2 np2 - 1) int64, contiguous, leaves first, then each
// level.  counter: one unsigned in device memory, 0 before the launch and
// again after it; launches that may overlap need their own.  Returns the
// launch's cudaError_t.
template <class Hash>
int launch_tree(const long long* leaves, long long ld, int n_cols, long long np2,
                long long* out, unsigned* counter, int device, void* stream) {
  if (leaves == nullptr || out == nullptr || counter == nullptr || n_cols < 1 ||
      np2 < n_cols || (np2 & (np2 - 1)) != 0 || np2 > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int log_sub = 0;
  while ((1LL << log_sub) < np2 && (1 << log_sub) < kTreeLeaves) ++log_sub;
  const long long blocks = np2 >> log_sub;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  merkle_tree_kernel<Hash><<<(unsigned)blocks, kTreeThreads, 0, (cudaStream_t)stream>>>(
      leaves, ld, n_cols, np2, log_sub, out, counter);
  return (int)cudaGetLastError();
}

// The arguments of a walk launch are valid: digs (8, k) and sibs (8, U)
// int64 at strides (d_w, d_c) and (s_w, s_c); inv (levels, k) and idx (k,)
// int64, contiguous, every inv < U; either out (8, k) int64, contiguous, or
// root (8,) int64 and flag.
inline bool walk_args_ok(const long long* digs, const long long* sibs, const long long* inv,
                         const long long* idx, int k, int levels, const long long* out,
                         const long long* root, const int32_t* flag) {
  return digs != nullptr && idx != nullptr && k >= 1 && levels >= 0 && levels <= 63 &&
         (levels == 0 || (sibs != nullptr && inv != nullptr)) &&
         (root != nullptr ? flag != nullptr : out != nullptr);
}

}  // namespace merkle
