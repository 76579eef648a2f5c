// SHA-256 column hashing, the Merkle tree and the path walk: the second
// digest's kernels.
//
// Replaces the XLA-fused jnp graphs of the JAX package, none of them a Pallas
// kernel:
//   - lcpc_tpu/ops/sha256_jax.py: `_compress` (:53) and `hash_word_columns`
//     (:90), the per-column SHA-256 of 8 zero words || the column's LE words,
//     and `merkle_parent` / `merkle_layer` (:127, :144);
//   - lcpc_tpu/core/streaming.py: `_sha_update_fn` (:408), `_sha_finalize_fn`
//     (:428) and `StreamingSha256Hasher` (:448), the same hash fed by row
//     blocks with the chaining value and fewer than 16 buffered words carried;
//   - the commit's layer loops (lcpc_tpu/core/protocol.py:326-333, :376-383;
//     core/streaming.py:719-725) and the verifier's parent loop
//     (core/protocol.py:787-793).
//
//   sha256_cols       one thread per column, its chaining value in registers
//                     and the message schedule a rolling 16-word window (a
//                     64-word array would spill to local memory).  Stream
//                     word i of a column comes from the carry when i <
//                     carry_len (zeros when no carry is given: the in-memory
//                     hash's 8-word prefix), else from the words;
//                     consecutive threads take consecutive columns, so each
//                     word load is one coalesced row read across the warp.
//                     The LE words are byte-swapped at load, SHA-256 reading
//                     big-endian words.  An update hashes the stream's whole
//                     64-byte blocks and writes the chaining value and the
//                     rest (< 16 words) back; a finish appends the 0x80000000
//                     word, zeros and the 64-bit bit length (one final block
//                     when rem + 3 <= 16, else two) and writes the digest as
//                     LE words of its big-endian bytes.
//   merkle_tree,      merkle.cuh's kernels over SHA-256's parent node,
//   merkle_walk       sha256(left digest || right digest): two compressions,
//                     the second over the constant padding block (0x80000000,
//                     zeros, length 512), whose schedule plus K is the
//                     constant table kPadWK: 64 rounds and no schedule.
//
// What bounds them on an H100 (SXM, 700 W): sha256_cols, the ALU pipe.  A
// compression is 48 schedule steps of ~10 instructions (two funnel-shift
// rotates and a shift per sigma, a three-input xor, two three-input adds)
// and 64 rounds of ~14 (six rotates, two three-input xors, the choose and
// the majority as one LOP3 each, four adds): ptxas leaves 1,237 on the ALU
// pipe and 118 on the FMA pipe, twice a BLAKE3 compression, 74 ps at
// 16.75e12 a second against 19 ps to read its 64 bytes at 3.35 TB/s.  The
// trees do little work and are bound by their depth: a parent is two
// compressions in a chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "merkle.cuh"

namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// h <- compress(h, w), w the block's 16 big-endian message words (the
// schedule overwrites them in place); without kSchedule the block is the
// constant padding block and w is not read.
template <bool kSchedule>
__device__ __forceinline__ void compress(uint32_t (&h)[8], uint32_t (&w)[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], k = h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wk;
    if constexpr (kSchedule) {
      if (t >= 16) {  // w[t & 15] holds W[t - 16] until it is replaced by W[t]
        const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        w[t & 15] += (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)) + w[(t - 7) & 15] +
                     (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10));
      }
      wk = w[t & 15] + kK[t];
    } else {
      wk = kPadWK[t];
    }
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

struct Sha256Merkle {  // a Merkle node: sha256(left digest bytes || right digest bytes)
  static __device__ __forceinline__ void parent(uint32_t (&cv)[8], const uint32_t (&l)[8],
                                                const uint32_t (&r)[8]) {
    uint32_t m[16], h[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      m[w] = bswap(l[w]);
      m[8 + w] = bswap(r[w]);
      h[w] = kH0[w];
    }
    compress<true>(h, m);
    compress<false>(h, m);
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[w] = bswap(h[w]);
  }
};

// Column c's stream is carry[0, carry_len) (zeros when carry is null), then
// words[0, n_words) (row stride ld).  Its state is cv (8, n_cols), or the
// initial hash value when cv is null.  An update (kFinish false) hashes the
// stream's whole blocks, then writes the chaining value to cv and the
// remaining words to carry[0, rem), both in place (each thread reads its
// column's carry before it writes it).  A finish pads the stream's end for a
// message of `bits` bits and writes the digest (8, n_cols) int64.
template <typename Word, bool kFinish>
__global__ void __launch_bounds__(kThreads)
sha256_cols_kernel(const Word* __restrict__ words, long long ld, long long n_words, int n_cols,
                   int32_t* carry, int carry_len, int32_t* cv, unsigned long long bits,
                   long long* __restrict__ digest) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  auto word = [&](long long i) -> uint32_t {  // stream word i, LE as stored
    if (i < carry_len) return carry != nullptr ? (uint32_t)carry[i * n_cols + c] : 0u;
    return (uint32_t)words[(i - carry_len) * ld + c];
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
    compress<true>(h, m);
    b = 1;
  }
  for (; b < n_full; ++b) {  // words only: a load and a byte swap a word
    const Word* p = words + (16 * b - carry_len) * ld + c;
    uint32_t m[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) m[t] = bswap((uint32_t)p[t * ld]);
    compress<true>(h, m);
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
      compress<true>(h, m);
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

template <typename Word>
void launch_cols(const void* words, long long ld, long long n_words, int n_cols, int32_t* carry,
                 int carry_len, int32_t* cv, int finish, unsigned long long bits,
                 long long* digest, cudaStream_t s) {
  const unsigned blocks = (n_cols + kThreads - 1) / kThreads;
  const Word* w = static_cast<const Word*>(words);
  if (finish)
    sha256_cols_kernel<Word, true><<<blocks, kThreads, 0, s>>>(w, ld, n_words, n_cols, carry,
                                                               carry_len, cv, bits, digest);
  else
    sha256_cols_kernel<Word, false><<<blocks, kThreads, 0, s>>>(w, ld, n_words, n_cols, carry,
                                                                carry_len, cv, bits, digest);
}

}  // namespace

// SHA-256 of every column's stream, or a step of it: the stream of column c
// is carry[0, carry_len) ((16, n_cols) int32, zeros when carry is null: the
// 8-word prefix), then words (n_words, n_cols) at row stride ld, u32 values
// as int32 or, with words_i64, int64 storage.  The state is cv (8, n_cols)
// int32, the initial hash value when cv is null.
//   finish = 0: hash the stream's whole 64-byte blocks; write the chaining
//     value to cv and the rest, (carry_len + n_words) % 16 words, to carry,
//     in place (cv and carry required).
//   finish = 1: end the message of total_words words (all of it, earlier
//     updates' words and the prefix included) with its padding and write the
//     (8, n_cols) int64 digests, LE words of the big-endian digest bytes.
// Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_sha256_cols(const void* words, int words_i64, long long ld,
                                long long n_words, int n_cols, int32_t* carry, int carry_len,
                                int32_t* cv, int finish, long long total_words,
                                long long* digest, int device, void* stream) {
  if (n_cols < 1 || n_words < 0 || carry_len < 0 || carry_len > 16 ||
      (n_words > 0 && (words == nullptr || (n_words > 1 && ld < n_cols))) ||
      (!finish && (cv == nullptr || carry == nullptr)) ||
      (finish && (digest == nullptr || total_words < carry_len + n_words ||
                  total_words >= (1LL << 58))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bits = finish ? (unsigned long long)total_words * 32ull : 0ull;
  cudaStream_t s = (cudaStream_t)stream;
  if (words_i64)
    launch_cols<long long>(words, ld, n_words, n_cols, carry, carry_len, cv, finish, bits,
                           digest, s);
  else
    launch_cols<int32_t>(words, ld, n_words, n_cols, carry, carry_len, cv, finish, bits, digest,
                         s);
  return (int)cudaGetLastError();
}

// The whole Merkle tree over leaves (8, n_cols) int64 (word stride ld,
// column stride 1): merkle.cuh's launch_tree with SHA-256's parent.
extern "C" int lcpc_sha256_merkle_tree(const long long* leaves, long long ld, int n_cols,
                                       long long np2, long long* out, unsigned* counter,
                                       int device, void* stream) {
  return merkle::launch_tree<Sha256Merkle>(leaves, ld, n_cols, np2, out, counter, device,
                                           stream);
}

// The Merkle path walk of k opened columns over `levels` levels:
// merkle.cuh's launch_walk with SHA-256's parent.
extern "C" int lcpc_sha256_merkle_walk(const long long* digs, long long d_w, long long d_c,
                                       const long long* sibs, long long s_w, long long s_c,
                                       const long long* inv, const long long* idx, int k,
                                       int levels, long long* out, int device, void* stream) {
  return merkle::launch_walk<Sha256Merkle>(digs, d_w, d_c, sibs, s_w, s_c, inv, idx, k, levels,
                                           out, device, stream);
}
