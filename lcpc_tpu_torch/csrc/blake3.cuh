// BLAKE3's compression and the bodies built on it, shared by the column
// hash and tree kernels (blake3_cols.cu) and the small commit's kernel
// (commit_small.cu): the compression, a parent node, a Merkle node, one
// chunk's chaining value over a column of the stream, and a parent node by
// a quad of lanes (the verifier's path walk).  Header-only: every function
// is inlined into its kernel.

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

// ---- one compression by a quad of lanes ------------------------------------
//
// BLAKE3's row-vector form, the layout of its SSE4.1 and NEON code: lane q
// of a quad (four consecutive lanes of a warp, q = lane & 3) holds column q
// of the 4 x 4 state, a = s[q], b = s[4 + q], c = s[8 + q], d = s[12 + q],
// so the four G of a half-round run in four lanes at once and a
// compression's dependency chain is its 14 half-rounds of one G each.  The
// column step is one g a lane.  The diagonal step's G_i takes s[i], s[4 +
// (i + 1) % 4], s[8 + (i + 2) % 4], s[12 + (i + 3) % 4]: lane q runs
// G_{q - 1}, the one over its own b, with a from lane q - 1, c from lane q
// + 1 and d from lane q + 2 (__shfl_sync within the quad), and hands them
// back after.  b is the last word a g produces and the first the next one
// reads, so it never waits on a shuffle; a, c and d leave a g 2 to 5
// instructions before its end.  The message words of a step differ by
// lane: each is a select on the lane's two bits among four words held in
// registers (an array indexed by the lane would live in local memory).
// The feed-forward cv[i] = s[i] ^ s[i + 8] shuffles each word's halves from
// the two lanes holding them, so every lane of the quad ends with all 8
// words of the output: the next Merkle level's message.  Every lane of the
// warp must call it (the shuffles name the whole warp).

struct Quad {  // a lane's place in its quad, constant for a kernel
  bool p1, p2;             // the lane's bits: q = 2 p2 + p1
  int a_in, c_in, d_in;    // the diagonal step's source lanes: q - 1, q + 1, q + 2
  int a_out, c_out;        // and the way back: q + 1, q - 1 (d's is d_in)
  uint32_t iv_a, iv_b;     // kIV[q], kIV[4 + q]
  __device__ __forceinline__ explicit Quad(int lane) {
    const int q = lane & 3;
    p1 = q & 1;
    p2 = q & 2;
    a_in = c_out = (q + 3) & 3;
    c_in = a_out = (q + 1) & 3;
    d_in = (q + 2) & 3;
    iv_a = kIV[q];
    iv_b = kIV[4 + q];
  }
  // word q of (w0, w1, w2, w3)
  __device__ __forceinline__ uint32_t pick(uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3) const {
    return p2 ? (p1 ? w3 : w2) : (p1 ? w1 : w0);
  }
};

// node <- the 8 output words of compress(IV, msg, 0, 64, flags) (a parent
// node over msg = left || right) in every lane of the quad; msg holds the
// 16 words in every lane.
__device__ __forceinline__ void quad_parent(uint32_t (&node)[8], const uint32_t (&msg)[16],
                                            uint32_t flags, const Quad& L) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = msg[i];
  // s[8 .. 11] = IV[0 .. 3]; s[12 .. 15] = counter 0, 0, block_len 64, flags
  uint32_t a = L.iv_a, b = L.iv_b, c = L.iv_a, d = L.p2 ? (L.p1 ? flags : 64u) : 0u;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(a, b, c, d, L.pick(m[0], m[2], m[4], m[6]), L.pick(m[1], m[3], m[5], m[7]));
    a = __shfl_sync(kAll, a, L.a_in, 4);
    c = __shfl_sync(kAll, c, L.c_in, 4);
    d = __shfl_sync(kAll, d, L.d_in, 4);
    // lane q runs G_{q-1}: message words 8 + 2 (q - 1) and 9 + 2 (q - 1)
    g(a, b, c, d, L.pick(m[14], m[8], m[10], m[12]), L.pick(m[15], m[9], m[11], m[13]));
    if (r < 6) {
      a = __shfl_sync(kAll, a, L.a_out, 4);
      c = __shfl_sync(kAll, c, L.c_out, 4);
      d = __shfl_sync(kAll, d, L.d_in, 4);
      const uint32_t t[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],  m[4],  m[13],
                              m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
  }
  // lane p holds a_{p-1}, b_p, c_{p+1}, d_{p+2}: word i's halves from two lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    node[i] = __shfl_sync(kAll, a, (i + 1) & 3, 4) ^ __shfl_sync(kAll, c, (i + 3) & 3, 4);
    node[4 + i] = __shfl_sync(kAll, b, i, 4) ^ __shfl_sync(kAll, d, (i + 2) & 3, 4);
  }
}

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
