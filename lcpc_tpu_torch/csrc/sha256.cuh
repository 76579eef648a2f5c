// SHA-256's compression and the bodies built on it, shared by the column
// hash, tree and walk kernels (sha256_cols.cu) and the small commit's kernel
// (commit_small.cu): the constants, the two round bodies (sha256_cols.cu's
// header says which callers take which), the Merkle parents, and one
// column's hash (the wide kernel's thread).  Header-only: every function is
// inlined into its kernel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ldst.cuh"

namespace sha256 {

__constant__ uint32_t kH0[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                                0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

// W[t] + K[t] of the padding block of a 64-byte message (0x80000000, 14
// zero words, the bit length 512): a Merkle parent's second compression.
__constant__ uint32_t kPadWK[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u};

// 1, in constant memory so that the compiler cannot fold it: x * kOne + y is
// an add as IMAD, on the FMA pipe, where ptxas would put some of its adds on
// the ALU pipe with the rotates and the logic
__constant__ uint32_t kOne = 1;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }
__device__ __forceinline__ uint32_t add_fma(uint32_t x, uint32_t y) { return x * kOne + y; }

// W[t] from the rolling window w, where w[t & 15] holds W[t - 16] until it
// is replaced by W[t] (t >= 16); with kFma its adds are IMADs
template <bool kFma>
__device__ __forceinline__ void schedule_step(uint32_t (&w)[16], int t) {
  const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  if constexpr (kFma)
    w[t & 15] = add_fma(add_fma(add_fma(w[t & 15], w[(t - 7) & 15]), s0), s1);
  else
    w[t & 15] += s0 + w[(t - 7) & 15] + s1;
}

// h <- h + the 64 rounds from h; wk(t) returns W[t] + K[t] and is called
// once for each t, in order.  The column kernels' round, scheduled for their
// limit, the ALU pipe's issue: h + W + K and d + h + W + K are summed a
// round ahead (round t + 1's h is round t's g, its d round t's c) as IMADs
// on the FMA pipe, so a round has 12 ALU instructions (six funnel shifts,
// four LOP3, two IADD3: the next e is one add of them to Sigma1(e) and Ch(e,
// f, g), the next a adds Sigma0(a) + Maj(a, b, c) - d to it, T1 + T2).  In
// the SASS both the e and the a chain are three deep a round (a funnel
// shift, a LOP3, an IADD3: ptxas folds the a add into one IADD3), against
// four in parent_compress.  On an H100 the wide kernel 4% and the
// few-column kernel 4% faster than the same round with ptxas's adds; a lone
// warp's Merkle parent with the schedule inline was faster with
// parent_compress (2.59 against 2.66 us), whose adds take three inputs.
template <class WK>
__device__ __forceinline__ void rounds(uint32_t (&h)[8], WK&& wk) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], k = h[7];
  uint32_t hk = k + wk(0);
  uint32_t dhk = d + hk;
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t e1 = dhk + s1 + ch;
    const uint32_t a1 = e1 + (s0 + mj - d);
    if (t < 63) {
      hk = add_fma(g, wk(t + 1));
      dhk = add_fma(c, hk);
    }
    k = g;
    g = f;
    f = e;
    e = e1;
    d = c;
    c = b;
    b = a;
    a = a1;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += k;
}

// h <- compress(h, w), w the block's 16 big-endian message words (the
// schedule overwrites them in place): the wide column kernel's.
__device__ __forceinline__ void compress(uint32_t (&h)[8], uint32_t (&w)[16]) {
  rounds(h, [&](int t) -> uint32_t {
    if (t >= 16) schedule_step<true>(w, t);
    return w[t & 15] + kK[t];
  });
}

// h <- compress(h, w) for a Merkle parent: without kSchedule the block is
// the constant padding block (kPadWK) and w is not read.  The round is
// T1 = h + Sigma1(e) + Ch(e, f, g) + W + K, e = d + T1, a = T1 + Sigma0(a) +
// Maj(a, b, c).  Unrolled (a lone thread's chain: the latency probe) or, with kCompact,
// as trips of 16 rounds (the state's roles come back to the same registers
// every 8 rounds, the window's every 16; the schedule of W[t + 16] beside
// round t): ~0.4 of the straight code, for the tree, whose many warps, each
// at its own point of a ~40 KB unrolled parent, otherwise wait on
// instruction fetch (on an H100 the tree 1-19% faster compact at 2^10 to
// 2^19 leaves; the 6,593-column walk 12% faster compact, the 189-column
// walk 14% slower).
template <bool kSchedule, bool kCompact>
__device__ __forceinline__ void parent_compress(uint32_t (&h)[8], uint32_t (&w)[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], k = h[7];
  auto round = [&](uint32_t wk) {
    const uint32_t t1 = k + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + wk;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    k = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  };
  if constexpr (!kCompact) {
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      if constexpr (kSchedule) {
        if (t >= 16) schedule_step<false>(w, t);
        round(w[t & 15] + kK[t]);
      } else {
        round(kPadWK[t]);
      }
    }
  } else if constexpr (kSchedule) {
#pragma unroll 1
    for (int i = 0; i < 48; i += 16) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        round(w[j] + kK[i + j]);
        schedule_step<false>(w, j + 16);  // W[i + j + 16] into w[j]
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) round(w[j] + kK[48 + j]);
  } else {
#pragma unroll 1
    for (int i = 0; i < 64; i += 16) {
#pragma unroll
      for (int j = 0; j < 16; ++j) round(kPadWK[i + j]);
    }
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += k;
}

// A Merkle node: sha256(left digest bytes || right digest bytes), a
// scheduled compression and one over the padding block (the latency probe
// scripts/sha256_chain.cu times both forms).
struct Sha256Merkle {
  template <bool kCompact>
  static __device__ __forceinline__ void node(uint32_t (&cv)[8], const uint32_t (&l)[8],
                                              const uint32_t (&r)[8]) {
    uint32_t m[16], h[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      m[w] = bswap(l[w]);
      m[8 + w] = bswap(r[w]);
      h[w] = kH0[w];
    }
    parent_compress<true, kCompact>(h, m);
    parent_compress<false, kCompact>(h, m);
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[w] = bswap(h[w]);
  }
};

// The same node for merkle.cuh's tree, compact.
struct Sha256TreeMerkle {
  static __device__ __forceinline__ void parent(uint32_t (&cv)[8], const uint32_t (&l)[8],
                                                const uint32_t (&r)[8]) {
    Sha256Merkle::node<true>(cv, l, r);
  }
};

// Column c's stream is carry[0, carry_len) (zeros when carry is null), then
// words[0, n_words) (row stride ld), read by Ld (ldst.cuh).  Its state is
// cv (8, n_cols), or the initial hash value when cv is null.  An update
// (kFinish false) hashes the stream's whole blocks, then writes the
// chaining value to cv and the remaining words to carry[0, rem), both in
// place (the thread reads its column's carry before it writes it).  A
// finish pads the stream's end for a message of `bits` bits and writes the
// digest (8, n_cols) int64.
template <typename Word, bool kFinish, class Ld>
__device__ __forceinline__ void hash_column(int c, const Word* __restrict__ words, long long ld,
                                            long long n_words, int n_cols, int32_t* carry,
                                            int carry_len, int32_t* cv, unsigned long long bits,
                                            long long* __restrict__ digest) {
  auto word = [&](long long i) -> uint32_t {  // stream word i, LE as stored
    if (i < carry_len) return carry != nullptr ? (uint32_t)carry[i * n_cols + c] : 0u;
    return (uint32_t)Ld::ld(words + (i - carry_len) * ld + c);
  };
  uint32_t h[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = cv != nullptr ? (uint32_t)cv[(size_t)w * n_cols + c] : kH0[w];
  const long long total = carry_len + n_words;
  const long long n_full = total >> 4;
  long long b = 0;
  if (carry_len > 0 && n_full > 0) {  // the one block that holds carry words
    uint32_t m[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) m[t] = bswap(word(t));
    compress(h, m);
    b = 1;
  }
  for (; b < n_full; ++b) {  // words only: a load and a byte swap a word
    const Word* p = words + (16 * b - carry_len) * ld + c;
    uint32_t m[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) m[t] = bswap((uint32_t)Ld::ld(p + t * ld));
    compress(h, m);
  }
  const int rem = (int)(total - 16 * n_full);
  const long long at = 16 * n_full;
  if constexpr (kFinish) {
    // the 0x80000000 word, zeros, then the bit length in the last two words
    // of the last block: one block when rem + 3 <= 16, else two
    const int n_last = rem + 3 <= 16 ? 1 : 2;
#pragma unroll 1
    for (int blk = 0; blk < n_last; ++blk) {
      uint32_t m[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int p = 16 * blk + t;
        m[t] = p < rem ? bswap(word(at + p)) : (p == rem ? 0x80000000u : 0u);
      }
      if (blk == n_last - 1) {
        m[14] = (uint32_t)(bits >> 32);
        m[15] = (uint32_t)bits;
      }
      compress(h, m);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) digest[(size_t)w * n_cols + c] = (long long)bswap(h[w]);
  } else {
#pragma unroll
    for (int t = 0; t < 15; ++t) {
      if (t < rem) carry[(size_t)t * n_cols + c] = (int32_t)word(at + t);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[(size_t)w * n_cols + c] = (int32_t)h[w];
  }
}

}  // namespace sha256
