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
//   sha256_cols       two kernels behind one entry, the caller picking one by
//                     the column count (ops/sha256.py: cols_route):
//     wide            one thread per column, its chaining value in registers
//                     and the message schedule a rolling 16-word window (a
//                     64-word array would spill to local memory), consecutive
//                     threads on consecutive columns, so each word load is
//                     one coalesced row read across the warp: the commit's
//                     and the streaming updates' 10^5 - 10^6 columns, where
//                     the card's ALU pipes are the limit;
//     few             32 columns a block of three warps: the round warp runs
//                     the compressions, one lane a column, and two schedule
//                     warps, one for the even 64-byte blocks and one for the
//                     odd, load their blocks' words, byte-swap them and write
//                     W[t] + K[t] for t = 0 .. 63 into a two-block ring in
//                     shared memory, the warps handing blocks over by named
//                     barriers: verify's opened columns (189, 6,593),
//                     where one column's chain of compressions is the
//                     limit and the schedule would lengthen each link.
//                     Both take the same stream: word i of a column comes
//                     from the carry when i < carry_len (zeros when no carry
//                     is given: the in-memory hash's 8-word prefix), else
//                     from the words; the LE words are byte-swapped at load,
//                     SHA-256 reading big-endian words.  An update hashes
//                     the stream's whole 64-byte blocks and writes the
//                     chaining value and the rest (< 16 words) back; a finish
//                     appends the 0x80000000 word, zeros and the 64-bit bit
//                     length (one final block when rem + 3 <= 16, else two)
//                     and writes the digest as LE words of its big-endian
//                     bytes.
//   merkle_tree       merkle.cuh's tree over SHA-256's parent node,
//                     sha256(left digest || right digest): two compressions,
//                     the second over the constant padding block (0x80000000,
//                     zeros, length 512), whose schedule plus K is the
//                     constant table kPadWK: 64 rounds and no schedule.  The
//                     tree takes the parent in 16-round trips
//                     (Sha256TreeMerkle).
//   merkle_walk       the verifier's walk, sha256_walk_kernel: the few-column
//                     kernel's pattern over the parents of 32 paths, a round
//                     warp and a schedule warp handing W + K over through
//                     shared memory; the roots written out, or compared with
//                     the commitment's root, clearing the verifier's flag.
//
// Two round bodies, each kept for the callers it was measured faster for
// (on an H100, 700 W):
//   rounds             the column kernels (wide and few) and the walk's round
//                      warp: its sums a round ahead as IMADs take the adds
//                      off the ALU pipe, the wide kernel's limit, and leave a
//                      round chain three instructions deep in the SASS (SHF,
//                      LOP3, IADD3);
//   parent_compress    the tree's parents, the schedule inline in its ALU
//                      form, in 16-round trips (kCompact): the tree's many
//                      warps would otherwise wait on instruction fetch (2^17
//                      leaves 0.0596 against 0.0743 ms unrolled); unrolled
//                      for the latency probe scripts/sha256_chain.cu.
//
// What bounds them on an H100 (SXM, 700 W).  The wide kernel: the ALU pipe.
// A compression is 48 schedule steps (two funnel-shift rotates and a shift
// per sigma, a three-input xor each, the adds as IMADs) and 64 rounds of 12
// ALU instructions (six funnel shifts, four LOP3, two IADD3) and two IMADs:
// ~1,130 on the ALU pipe and ~350 on the FMA pipe, 67 ps at 16.75e12 a
// second against 19 ps to read its 64 bytes at 3.35 TB/s.  The few-column
// kernel and the trees' narrow levels: one warp's issue and the round's
// dependency chain.  The ALU pipe takes 16 lanes of an SM's quarter a
// clock, so a warp issues an ALU instruction about every 2.2 clocks (eight
// independent chains in scripts/sha256_chain.cu), and a round of one column
// costs that times its ALU instructions however short its chain (three
// dependent instructions in the SASS, ~12.5 clocks): the round warp, freed
// of the schedule, runs at ~90% of that issue bound.
//
// The constants, both round bodies, the Merkle parents and the wide
// kernel's column body live in sha256.cuh, shared with the small commit's
// kernel (commit_small.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "merkle.cuh"
#include "sha256.cuh"

namespace {

using namespace sha256;  // the compression, the Merkle parents, the column body (sha256.cuh)

constexpr int kThreads = 128;    // the wide kernel's block: a thread a column
constexpr int kFewCols = 32;     // the few-column kernel's block: 32 columns, a lane each,
constexpr int kRing = 2;         // in a round warp and kRing schedule warps, one a ring slot
constexpr int kFewThreads = 32 * (1 + kRing);
constexpr int kBarThreads = 64;  // a slot's barriers: the round warp and the slot's schedule warp
constexpr int kBarFull = 1;      // named barriers kBarFull + slot, kBarEmpty + slot (0 is
constexpr int kBarEmpty = 3;     // __syncthreads')
constexpr int kWalkCols = 32;    // the walk's block: 32 columns, a lane each, in a round warp
constexpr int kWalkThreads = 64; // and a schedule warp (the barriers' kBarThreads)
constexpr int kBarDig = 1;       // the walk's named barriers: the level's node, then
constexpr int kBarWK = 2;        // W + K of rounds 16 c .. 16 c + 15 at kBarWK + c - 1

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
  hash_column<Word, kFinish, lcpc::LoadPlain>(c, words, ld, n_words, n_cols, carry, carry_len, cv,
                                               bits, digest);
}

// a named barrier of the few-column kernel's round warp and one schedule
// warp: wait for the other warp's arrival, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kBarThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kBarThreads) : "memory");
}

// sha256_cols_kernel's function over 32 columns a block, the message
// schedule off the round chain.  Schedule warp s builds the blocks b = s
// (mod 2): their 16 big-endian words (loaded one of its blocks ahead, so a
// load has two blocks' rounds to arrive), the schedule, and W[t] + K[t]
// into ring slot s, four rounds a 16-byte word, lane-minor (a warp's
// 16-byte loads and stores touch every bank once a quarter-warp); it waits
// for the slot's previous block to be consumed (kBarEmpty + s) and signals
// the block (kBarFull + s).  One schedule warp alone was the limit (its
// loads, one block ahead, stalled its register copies).  The round warp
// takes its block's 64 words with 16 loads and runs `rounds` alone: about
// 12 ALU instructions a round, against ~20 with the schedule inline.  Lanes
// past n_cols hash a copy of the last column and store nothing: every lane
// takes part in the barriers.
template <typename Word, bool kFinish>
__global__ void __launch_bounds__(kFewThreads)
sha256_few_kernel(const Word* __restrict__ words, long long ld, long long n_words, int n_cols,
                  int32_t* carry, int carry_len, int32_t* cv, unsigned long long bits,
                  long long* __restrict__ digest) {
  __shared__ uint4 ring[kRing][16][kFewCols];
  const int lane = threadIdx.x % kFewCols;
  const int c_at = blockIdx.x * kFewCols + lane;
  const bool live = c_at < n_cols;
  const int c = live ? c_at : n_cols - 1;
  const long long total = carry_len + n_words;
  const long long n_full = total >> 4;
  const int rem = (int)(total - 16 * n_full);
  const long long n_blocks = n_full + (kFinish ? (rem + 3 <= 16 ? 1 : 2) : 0);
  if (threadIdx.x < kFewCols) {  // the round warp
    uint32_t h[8];
#pragma unroll
    for (int w = 0; w < 8; ++w)
      h[w] = cv != nullptr ? (uint32_t)cv[(size_t)w * n_cols + c] : kH0[w];
    for (long long b = 0; b < n_blocks; ++b) {
      const int s = (int)(b % kRing);
      bar_sync(kBarFull + s);
      uint4 q[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) q[i] = ring[s][i][lane];
      rounds(h, [&](int t) -> uint32_t {
        const uint4& v = q[t >> 2];
        return (t & 3) == 0 ? v.x : (t & 3) == 1 ? v.y : (t & 3) == 2 ? v.z : v.w;
      });
      if (b + kRing < n_blocks) bar_arrive(kBarEmpty + s);
    }
    if (!live) return;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if constexpr (kFinish)
        digest[(size_t)w * n_cols + c] = (long long)bswap(h[w]);
      else
        cv[(size_t)w * n_cols + c] = (int32_t)h[w];
    }
    return;
  }
  // schedule warp s, blocks s, s + 2, ...
  const int s = threadIdx.x / kFewCols - 1;
  auto word = [&](long long i) -> uint32_t {  // stream word i, LE as stored
    if (i < carry_len) return carry != nullptr ? (uint32_t)carry[i * n_cols + c] : 0u;
    return (uint32_t)words[(i - carry_len) * ld + c];
  };
  const long long at = 16 * n_full;
  auto block = [&](long long b, uint32_t (&m)[16]) {  // block b's big-endian words
    if (b < n_full && (b > 0 || carry_len == 0)) {  // words only
      const Word* p = words + (16 * b - carry_len) * ld + c;
#pragma unroll
      for (int t = 0; t < 16; ++t) m[t] = bswap((uint32_t)p[t * ld]);
    } else if (b < n_full) {  // the one block that holds carry words
#pragma unroll
      for (int t = 0; t < 16; ++t) m[t] = bswap(word(t));
    } else {  // a finish's padding: the rest, 0x80000000, zeros, the bit length
      const int p0 = 16 * (int)(b - n_full);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int p = p0 + t;
        m[t] = p < rem ? bswap(word(at + p)) : (p == rem ? 0x80000000u : 0u);
      }
      if (b == n_blocks - 1) {
        m[14] = (uint32_t)(bits >> 32);
        m[15] = (uint32_t)bits;
      }
    }
  };
  uint32_t next[16];
  if (s < n_blocks) block(s, next);
  for (long long b = s; b < n_blocks; b += kRing) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = next[t];
    if (b + kRing < n_blocks) block(b + kRing, next);
    if (b >= kRing) bar_sync(kBarEmpty + s);
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      if (t >= 16) schedule_step<true>(w, t);
      v[t & 3] = w[t & 15] + kK[t];
      if ((t & 3) == 3) ring[s][t >> 2][lane] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    bar_arrive(kBarFull + s);
  }
  if constexpr (!kFinish) {
    if (live && s == 0) {
#pragma unroll
      for (int t = 0; t < 15; ++t) {
        if (t < rem) carry[(size_t)t * n_cols + c] = (int32_t)word(at + t);
      }
    }
  }
}

// The verifier's path walk, 32 opened columns a block: a round warp (a
// lane a column) and a schedule warp.  At each level the round warp
// publishes its node (kBarDig) and writes W + K of the first compression's
// rounds 0 - 15 from the message words bswap(left || right) itself, while
// the schedule warp builds W[t] + K[t] for t = 16 .. 63 from the same words
// and hands them over 16 at a time (kBarWK + chunk - 1); the second
// compression's, over the padding block, are the constant kPadWK, written
// once.  All of them sit in shared memory, four to a 16-byte word,
// lane-minor (the few-column kernel's ring).  The round warp runs both
// compressions through one unrolled body of `rounds` (a loop of two: the
// two compressions' 128 straight rounds were ~34 KB of code, and a walk
// built so waited on instruction fetch, 3.4 us a level on an H100 against
// 3.0 for a thread a column with the schedule inline), its W + K 16 at a
// time in registers, each 16 read four rounds before its first round; on
// an H100 2.3 us a level, ~30 clocks a round and the first chunk's
// handover (the schedule warp starts when the node is published).  A
// level costs the round warp
// 128 rounds of about 12 ALU instructions, against about 20 with the
// schedule inline.  One buffer suffices: the schedule warp writes a
// level's W + K only after that level's node, which the round warp
// publishes after reading the last chunk of the level before.  Both warps
// load each level's sibling, the next one while a level runs.  Lanes past k
// walk a copy of the last column and store nothing: every lane takes part
// in the barriers.
__global__ void __launch_bounds__(kWalkThreads)
sha256_walk_kernel(const long long* __restrict__ digs, long long d_w, long long d_c,
                   const long long* __restrict__ sibs, long long s_w, long long s_c,
                   const long long* __restrict__ inv, const long long* __restrict__ idx, int k,
                   int levels, long long* __restrict__ out, const long long* __restrict__ root,
                   int32_t* __restrict__ flag) {
  __shared__ uint32_t node[8][kWalkCols];
  __shared__ uint4 wk[32][kWalkCols];  // W + K of rounds 4i .. 4i + 3: both compressions
  const int lane = threadIdx.x % kWalkCols;
  const int j_at = blockIdx.x * kWalkCols + lane;
  const bool live = j_at < k;
  const int j = live ? j_at : k - 1;
  const long long col = idx[j];
  uint32_t sib[8];
  long long at_next = levels > 1 ? inv[(long long)k + j] * s_c : 0;
  if (levels > 0) {
    const long long at = inv[j] * s_c;
#pragma unroll
    for (int w = 0; w < 8; ++w) sib[w] = (uint32_t)sibs[w * s_w + at];
  }
  // the level's message words bswap(left || right), then the next sibling
  // loaded while the level runs
  auto message = [&](int lvl, const uint32_t (&cv)[8], uint32_t (&m)[16]) {
    const bool right = (col >> lvl) & 1;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      m[w] = bswap(right ? sib[w] : cv[w]);
      m[8 + w] = bswap(right ? cv[w] : sib[w]);
    }
    if (lvl + 1 < levels) {  // first read at the next level: the load has this one to land
#pragma unroll
      for (int w = 0; w < 8; ++w) sib[w] = (uint32_t)sibs[w * s_w + at_next];
      if (lvl + 2 < levels) at_next = inv[(long long)(lvl + 2) * k + j] * s_c;
    }
  };
  if (threadIdx.x < kWalkCols) {  // the round warp
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wk[16 + i][lane] = make_uint4(kPadWK[4 * i], kPadWK[4 * i + 1], kPadWK[4 * i + 2],
                                    kPadWK[4 * i + 3]);
    uint32_t cv[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[w] = (uint32_t)digs[w * d_w + j * d_c];
    for (int lvl = 0; lvl < levels; ++lvl) {
#pragma unroll
      for (int w = 0; w < 8; ++w) node[w][lane] = cv[w];
      bar_arrive(kBarDig);
      uint32_t m[16], h[8];
      message(lvl, cv, m);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wk[i][lane] = make_uint4(m[4 * i] + kK[4 * i], m[4 * i + 1] + kK[4 * i + 1],
                                 m[4 * i + 2] + kK[4 * i + 2], m[4 * i + 3] + kK[4 * i + 3]);
#pragma unroll
      for (int w = 0; w < 8; ++w) h[w] = kH0[w];
#pragma unroll 1
      for (int comp = 0; comp < 2; ++comp) {  // the scheduled block, then the padding
        const uint4* src = &wk[16 * comp][lane];
        uint4 q[4], next[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) q[u] = src[u * kWalkCols];
        rounds(h, [&](int t) -> uint32_t {
          const int i = t & 15;
          if (t < 48 && i == 12) {  // the next 16, four rounds ahead
            if (comp == 0) bar_sync(kBarWK + (t >> 4));
#pragma unroll
            for (int u = 0; u < 4; ++u) next[u] = src[(4 * ((t >> 4) + 1) + u) * kWalkCols];
          }
          if (t >= 16 && i == 0) {
#pragma unroll
            for (int u = 0; u < 4; ++u) q[u] = next[u];
          }
          const uint4& v = q[i >> 2];
          return (i & 3) == 0 ? v.x : (i & 3) == 1 ? v.y : (i & 3) == 2 ? v.z : v.w;
        });
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) cv[w] = bswap(h[w]);
    }
    if (live) merkle::walk_end(cv, j, k, out, root, flag);
    return;
  }
  // the schedule warp
  for (int lvl = 0; lvl < levels; ++lvl) {
    bar_sync(kBarDig);
    uint32_t cv[8], m[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[w] = node[w][lane];
    message(lvl, cv, m);
#pragma unroll 1
    for (int c = 1; c < 4; ++c) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 16; ++i) {  // W[16 c + i], the window's slot i
        schedule_step<true>(m, 16 + i);
        v[i & 3] = m[i] + kK[16 * c + i];
        if ((i & 3) == 3) wk[4 * c + (i >> 2)][lane] = make_uint4(v[0], v[1], v[2], v[3]);
      }
      bar_arrive(kBarWK + c - 1);
    }
  }
}

template <typename Word>
void launch_cols(const void* words, long long ld, long long n_words, int n_cols, int32_t* carry,
                 int carry_len, int32_t* cv, int finish, unsigned long long bits,
                 long long* digest, int few, cudaStream_t s) {
  const Word* w = static_cast<const Word*>(words);
  if (few) {
    const unsigned blocks = (n_cols + kFewCols - 1) / kFewCols;
    if (finish)
      sha256_few_kernel<Word, true><<<blocks, kFewThreads, 0, s>>>(w, ld, n_words, n_cols, carry,
                                                                   carry_len, cv, bits, digest);
    else
      sha256_few_kernel<Word, false><<<blocks, kFewThreads, 0, s>>>(
          w, ld, n_words, n_cols, carry, carry_len, cv, bits, digest);
    return;
  }
  const unsigned blocks = (n_cols + kThreads - 1) / kThreads;
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
// few = 1 launches the few-column kernel, 0 the wide one (the same result).
// Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_sha256_cols(const void* words, int words_i64, long long ld,
                                long long n_words, int n_cols, int32_t* carry, int carry_len,
                                int32_t* cv, int finish, long long total_words,
                                long long* digest, int few, int device, void* stream) {
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
                           digest, few, s);
  else
    launch_cols<int32_t>(words, ld, n_words, n_cols, carry, carry_len, cv, finish, bits, digest,
                         few, s);
  return (int)cudaGetLastError();
}

// The whole Merkle tree over leaves (8, n_cols) int64 (word stride ld,
// column stride 1): merkle.cuh's launch_tree with SHA-256's compact parent.
extern "C" int lcpc_sha256_merkle_tree(const long long* leaves, long long ld, int n_cols,
                                       long long np2, long long* out, unsigned* counter,
                                       int device, void* stream) {
  return merkle::launch_tree<Sha256TreeMerkle>(leaves, ld, n_cols, np2, out, counter, device,
                                               stream);
}

// The Merkle path walk of k opened columns over `levels` levels, the roots
// into out or compared with root (clearing *flag where one differs), the
// arguments as merkle.cuh's walk_args_ok takes them: sha256_walk_kernel.
extern "C" int lcpc_sha256_merkle_walk(const long long* digs, long long d_w, long long d_c,
                                       const long long* sibs, long long s_w, long long s_c,
                                       const long long* inv, const long long* idx, int k,
                                       int levels, long long* out, const long long* root,
                                       int32_t* flag, int device, void* stream) {
  if (!merkle::walk_args_ok(digs, sibs, inv, idx, k, levels, out, root, flag))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sha256_walk_kernel<<<(k + kWalkCols - 1) / kWalkCols, kWalkThreads, 0,
                       (cudaStream_t)stream>>>(digs, d_w, d_c, sibs, s_w, s_c, inv, idx, k,
                                               levels, out, root, flag);
  return (int)cudaGetLastError();
}
