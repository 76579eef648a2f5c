// BLAKE3 column hashing and Merkle layers: the commitment's digests.
//
// Replaces the XLA-fused jnp graphs of the JAX package, none of them a Pallas
// kernel:
//   - lcpc_tpu/ops/blake3_jax.py: `chunk_chain_scan` (:130),
//     `_hash_words_streams` (:160) and `hash_word_columns` (:249), the
//     per-column hash of 8 zero words || the column's words, with its chunk
//     tree (:221-245), and `merkle_parent` / `merkle_layer` (:264, :275);
//   - lcpc_tpu/core/streaming.py: `_update_fn` (:48), `_finalize_fn` (:90)
//     and `_merge_fn` (:127), the same chunk chain fed by row blocks with a
//     sub-chunk carry buffer, its final partial chunk and its chunk-tree
//     merge.
//
// Two kernels:
//
//   blake3_chunks   one thread per (column, chunk).  BLAKE3's 1 KiB chunks
//                   (256 words) are independent, so a thread runs its
//                   chunk's up to 16 compressions with the chaining value
//                   in registers and writes the chunk's CV; the counter is
//                   the global chunk index (chunk_base + chunk).  Stream
//                   word i of a column comes from the carry buffer when
//                   i < carry_len (zeros when no buffer is given: the
//                   in-memory hash's 8-word prefix), else from the words.
//                   Consecutive threads take consecutive columns, so each
//                   of a block's 16 word loads is one coalesced row read
//                   across the warp.  A final partial chunk takes its
//                   length: its last block has block_len = (len % 16) * 4
//                   or 64; ROOT is set only when the column is one chunk.
//   blake3_parents  one thread per output node and column: the node's CV is
//                   compress(IV, left || right, counter 0, len 64, flags).
//                   The chunk-tree merge runs it level by level with flags
//                   PARENT (PARENT | ROOT at the top), pairing adjacent CVs
//                   and promoting an odd last one (a copy), which is
//                   BLAKE3's largest-power-of-two-left tree; the Merkle
//                   layers run it with CHUNK_START | CHUNK_END | ROOT (a
//                   64-byte single-chunk hash).  Each operand is a strided
//                   (node, word, column) view, u32 words or int64 storage of
//                   u32 values (the digest tensors of core/protocol.py).
//
// The JAX package instead scans block by block over each column's chunks
// in sequence: it vectorizes over columns only.  Here the chunks are a grid
// dimension too, so verify's 189 opened columns of a 2^28 commit are
// 189 x 65 threads rather than 189.
//
// What bounds them on an H100 (SXM, 700 W): the integer issue.  A
// compression is 7 rounds x 8 G x 12 instructions (2 three-input adds, 2
// adds, 4 xors, 4 rotates; rotates by 16 and 8 are byte permutes, by 12 and
// 7 funnel shifts) plus 8 output xors, ~680 instructions, against 4 bytes of
// message per word read once: 2,056-word columns are ~0.66 ms of
// instructions per GB of words at 16.75e12 simple integer instructions/s,
// twice the 0.30 ms/GB of reading them at 3.35 TB/s.  The design keeps
// every message word in registers after one coalesced load and launches
// enough threads ((column, chunk) pairs) to fill the card's 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;
constexpr uint32_t ROOT = 1u << 3;

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

__device__ __forceinline__ void store_word(uint32_t* p, uint32_t v) { *p = v; }
__device__ __forceinline__ void store_word(long long* p, uint32_t v) { *p = (long long)v; }

// Chunk j (blockIdx.y) of column c: stream words [256 j, 256 j + len), len
// = 256 or final_len for the last chunk when final_len > 0.  out is the
// chunk-CV array (chunk, 8, n_cols) at chunk_base.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
blake3_chunks_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ carry,
                     int carry_len, int n_cols, unsigned long long chunk_base, int final_len,
                     int root, Out* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  const int j = blockIdx.y;
  const int len = (final_len > 0 && j == (int)gridDim.y - 1) ? final_len : 256;
  const int n_blocks = (len + 15) >> 4;
  const long long first = (long long)j * 256;
  uint32_t cv[8];
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
          if (carry != nullptr) v = __ldg(carry + (size_t)i * n_cols + c);
        } else {
          v = __ldg(words + (size_t)(i - carry_len) * n_cols + c);
        }
      }
      m[t] = v;
    }
    const bool last = b == n_blocks - 1;
    const uint32_t flags = (b == 0 ? CHUNK_START : 0u) |
                           (last ? (CHUNK_END | (root ? ROOT : 0u)) : 0u);
    const uint32_t block_len = last ? (uint32_t)(len - 16 * b) * 4u : 64u;
    compress(cv, m, chunk_base + (unsigned long long)j, block_len, flags);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) store_word(out + ((size_t)j * 8 + w) * n_cols + c, cv[w]);
}

struct View {  // element (node, word, column) at node * n + word * w + column * c
  long long n, w, c;
};

// Output node `node` of column c: compress(IV, left || right) for node <
// n_pairs, a copy of left (the promoted odd node) for n_pairs <= node < n_out.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
blake3_parents_kernel(const In* __restrict__ left, const In* __restrict__ right,
                      Out* __restrict__ out, long long n_pairs, long long n_out, int n_cols,
                      View lv, View rv, View ov, uint32_t flags) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_out * n_cols) return;
  const long long node = idx / n_cols;
  const long long c = idx - node * n_cols;
  const In* l = left + node * lv.n + c * lv.c;
  uint32_t cv[8];
  if (node < n_pairs) {
    const In* r = right + node * rv.n + c * rv.c;
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      m[w] = (uint32_t)l[w * lv.w];
      m[8 + w] = (uint32_t)r[w * rv.w];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = kIV[i];
    compress(cv, m, 0, 64u, flags);
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[w] = (uint32_t)l[w * lv.w];
  }
  Out* o = out + node * ov.n + c * ov.c;
#pragma unroll
  for (int w = 0; w < 8; ++w) store_word(o + w * ov.w, cv[w]);
}

template <typename In, typename Out>
cudaError_t launch_parents(const void* left, const void* right, void* out, long long n_pairs,
                           long long n_out, int n_cols, View lv, View rv, View ov,
                           uint32_t flags, cudaStream_t s) {
  const long long blocks = (n_out * n_cols + kThreads - 1) / kThreads;
  blake3_parents_kernel<In, Out><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const In*>(left), static_cast<const In*>(right), static_cast<Out*>(out),
      n_pairs, n_out, n_cols, lv, rv, ov, flags);
  return cudaGetLastError();
}

}  // namespace

// Chunk CVs of n_chunks consecutive chunks of every column's stream (carry
// words 0 .. carry_len-1, then words (n_words, n_cols) row-major), chunk j
// covering stream words [256 j, 256 j + 256), except that with final_len > 0
// the last chunk has final_len (1 .. 256) words and ends the stream; root
// marks a stream of one chunk (the CV is then the digest).  carry may be
// null (zeros).  Writes out (n_chunks, 8, n_cols), u32 words or, with
// out_i64, int64 storage.  Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_blake3_chunks(const int32_t* words, const int32_t* carry, int carry_len,
                                  long long n_words, int n_cols, long long chunk_base,
                                  int n_chunks, int final_len, int root, void* out,
                                  int out_i64, int device, void* stream) {
  const long long need = 256LL * (n_chunks - 1) + (final_len > 0 ? final_len : 256);
  if (n_cols < 1 || n_chunks < 1 || n_chunks > 65535 || carry_len < 0 || carry_len > 256 ||
      n_words < 0 || chunk_base < 0 || final_len < 0 || final_len > 256 ||
      carry_len + n_words < need || (words == nullptr && n_words > 0) || out == nullptr ||
      (root && (chunk_base != 0 || n_chunks != 1 || final_len == 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_cols + kThreads - 1) / kThreads, n_chunks);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  const uint32_t* cb = reinterpret_cast<const uint32_t*>(carry);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_i64)
    blake3_chunks_kernel<long long><<<grid, kThreads, 0, s>>>(
        w, cb, carry_len, n_cols, (unsigned long long)chunk_base, final_len, root,
        static_cast<long long*>(out));
  else
    blake3_chunks_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        w, cb, carry_len, n_cols, (unsigned long long)chunk_base, final_len, root,
        static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// Parent nodes: out node i (0 <= i < n_out) of every column is
// compress(IV, left_i || right_i, 0, 64, flags) for i < n_pairs and a copy
// of left_i otherwise.  Each operand is a strided (node, word, column) view
// in elements (stride triples l_*, r_*, o_*), u32 words or, with in_i64 /
// out_i64, int64 storage of u32 values.  Returns the launch's cudaError_t.
extern "C" int lcpc_blake3_parents(const void* left, const void* right, void* out,
                                   int in_i64, int out_i64, long long n_pairs, long long n_out,
                                   int n_cols, long long l_n, long long l_w, long long l_c,
                                   long long r_n, long long r_w, long long r_c, long long o_n,
                                   long long o_w, long long o_c, unsigned flags, int device,
                                   void* stream) {
  if (n_cols < 1 || n_pairs < 0 || n_out < n_pairs || n_out < 1 || left == nullptr ||
      out == nullptr || (n_pairs > 0 && right == nullptr) ||
      (n_out * n_cols + kThreads - 1) / kThreads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const View lv{l_n, l_w, l_c}, rv{r_n, r_w, r_c}, ov{o_n, o_w, o_c};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_i64 && out_i64)
    return (int)launch_parents<long long, long long>(left, right, out, n_pairs, n_out, n_cols,
                                                     lv, rv, ov, flags, s);
  if (in_i64)
    return (int)launch_parents<long long, uint32_t>(left, right, out, n_pairs, n_out, n_cols,
                                                    lv, rv, ov, flags, s);
  if (out_i64)
    return (int)launch_parents<uint32_t, long long>(left, right, out, n_pairs, n_out, n_cols,
                                                    lv, rv, ov, flags, s);
  return (int)launch_parents<uint32_t, uint32_t>(left, right, out, n_pairs, n_out, n_cols, lv,
                                                 rv, ov, flags, s);
}
