// BLAKE3's compression and the bodies built on it, shared by the column
// hash and tree kernels (blake3_cols.cu) and the small commit's kernel
// (commit_small.cu): the compression, a parent node, a Merkle node, and
// one chunk's chaining value over a column of the stream.  Header-only:
// every function is inlined into its kernel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ldst.cuh"

namespace b3 {

constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;
constexpr uint32_t PARENT = 1u << 2;
constexpr uint32_t ROOT = 1u << 3;
constexpr uint32_t MERKLE = CHUNK_START | CHUNK_END | ROOT;  // a 64-byte message's hash
constexpr int kChunkWords = 256;  // a 1 KiB chunk
constexpr int kPrefixWords = 8;   // the column hash's 32 zero bytes

__constant__ uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                                0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

__device__ __forceinline__ uint32_t rotr16(uint32_t x) { return __byte_perm(x, 0, 0x1032); }
__device__ __forceinline__ uint32_t rotr8(uint32_t x) { return __byte_perm(x, 0, 0x0321); }
__device__ __forceinline__ uint32_t rotr12(uint32_t x) { return __funnelshift_r(x, x, 12); }
__device__ __forceinline__ uint32_t rotr7(uint32_t x) { return __funnelshift_r(x, x, 7); }

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                                  uint32_t mx, uint32_t my) {
  a = a + b + mx;
  d = rotr16(d ^ a);
  c = c + d;
  b = rotr12(b ^ c);
  a = a + b + my;
  d = rotr8(d ^ a);
  c = c + d;
  b = rotr7(b ^ c);
}

// cv <- the first 8 output words of compress(cv, m, counter, block_len, flags)
__device__ __forceinline__ void compress(uint32_t (&cv)[8], const uint32_t (&msg)[16],
                                         uint64_t counter, uint32_t block_len,
                                         uint32_t flags) {
  uint32_t s[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    kIV[0], kIV[1], kIV[2], kIV[3],
                    (uint32_t)counter, (uint32_t)(counter >> 32), block_len, flags};
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = msg[i];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(s[0], s[4], s[8], s[12], m[0], m[1]);
    g(s[1], s[5], s[9], s[13], m[2], m[3]);
    g(s[2], s[6], s[10], s[14], m[4], m[5]);
    g(s[3], s[7], s[11], s[15], m[6], m[7]);
    g(s[0], s[5], s[10], s[15], m[8], m[9]);
    g(s[1], s[6], s[11], s[12], m[10], m[11]);
    g(s[2], s[7], s[8], s[13], m[12], m[13]);
    g(s[3], s[4], s[9], s[14], m[14], m[15]);
    if (r < 6) {  // the message permutation: register renames once unrolled
      const uint32_t t[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],  m[4],  m[13],
                              m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = s[i] ^ s[i + 8];
}

// cv <- compress(IV, left || right, counter 0, len 64, flags): a parent node
__device__ __forceinline__ void parent_cv(uint32_t (&cv)[8], const uint32_t (&l)[8],
                                          const uint32_t (&r)[8], uint32_t flags) {
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    m[w] = l[w];
    m[8 + w] = r[w];
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) cv[w] = kIV[w];
  compress(cv, m, 0, 64u, flags);
}

struct Blake3Merkle {  // a Merkle node: blake3(left digest || right digest)
  static __device__ __forceinline__ void parent(uint32_t (&cv)[8], const uint32_t (&l)[8],
                                                const uint32_t (&r)[8]) {
    parent_cv(cv, l, r, MERKLE);
  }
};

// cv <- the chaining value of the chunk at stream words [first, first + len)
// of column c (len 1 .. 256): stream word i is carry[i * n_cols + c] when i
// < carry_len (zeros when carry is null: the in-memory hash's 8-word
// prefix), else words[(i - carry_len) * n_cols + c]; the chunk's counter is
// `counter`, and `root` marks a stream of one chunk.  A thread's 16 word
// loads a block run across consecutive columns in a warp: one coalesced
// row read each.  Ld reads words and carry (ldst.cuh).
template <class Ld>
__device__ __forceinline__ void chunk_cv(uint32_t (&cv)[8], const uint32_t* __restrict__ words,
                                         const uint32_t* __restrict__ carry, int carry_len,
                                         int n_cols, int c, long long first, int len,
                                         unsigned long long counter, bool root) {
  const int n_blocks = (len + 15) >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = kIV[i];
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int pos = 16 * b + t;  // word in the chunk
      const long long i = first + pos;
      uint32_t v = 0;
      if (pos < len) {
        if (i < carry_len) {
          if (carry != nullptr) v = Ld::ld(carry + (size_t)i * n_cols + c);
        } else {
          v = Ld::ld(words + (size_t)(i - carry_len) * n_cols + c);
        }
      }
      m[t] = v;
    }
    const bool last = b == n_blocks - 1;
    const uint32_t flags = (b == 0 ? CHUNK_START : 0u) |
                           (last ? (CHUNK_END | (root ? ROOT : 0u)) : 0u);
    const uint32_t block_len = last ? (uint32_t)(len - 16 * b) * 4u : 64u;
    compress(cv, m, counter, block_len, flags);
  }
}

}  // namespace b3
