// BLAKE3 column hashing and the Merkle tree: the commitment's digests.
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
//     merge;
//   - lcpc_tpu/core/protocol.py: the commit's layer loop (:322-333, and
//     `_commit_fused_fn` :345-383) and the verifier's path walk in
//     `_verify_core_fn` (:840-845) and `_verify_core_cols_fn` (:793).
//
// Under jit XLA sees each of those trees whole; here each is one launch:
//
//   blake3_chunks     one thread per (column, chunk).  BLAKE3's 1 KiB chunks
//                     (256 words) are independent, so a thread runs its
//                     chunk's up to 16 compressions with the chaining value
//                     in registers and writes the chunk's CV; the counter is
//                     the global chunk index (chunk_base + chunk).  Stream
//                     word i of a column comes from the carry buffer when
//                     i < carry_len (zeros when no buffer is given: the
//                     in-memory hash's 8-word prefix), else from the words.
//                     Consecutive threads take consecutive columns, so each
//                     of a block's 16 word loads is one coalesced row read
//                     across the warp.  A final partial chunk takes its
//                     length: its last block has block_len = (len % 16) * 4
//                     or 64; ROOT is set only when the column is one chunk.
//   chunk tree        the chunk CVs of every column merged into its digest:
//                     with many columns a thread per column runs BLAKE3's CV
//                     stack in shared memory (n - 1 compressions in a chain,
//                     every thread busy); with few a warp per column merges
//                     level by level (ceil(log2 n) deep).
//   cols_few          the column hash of few columns (verify's opened ones)
//                     from words to digests in one launch: a warp a (32
//                     columns, chunk), kFewWarps chunks of a column group a
//                     block, so that each warp has a scheduler of its SM to
//                     itself (one warp's compression keeps a scheduler's
//                     ALU pipe 80% busy: two on one scheduler take twice
//                     as long); each lane's chunk chain fed from a ring of
//                     message blocks that cp.async fills kFewStages - 1
//                     blocks ahead ([stage][word][lane], a warp's 32 columns
//                     one 128-byte row segment a word), so no compression
//                     waits on its own loads; then the block's chunk tree
//                     level by level across its warps in shared memory, the
//                     same pairing as the chunk-tree kernels; with several
//                     blocks a column group, each writes its subtree's CV to
//                     scratch and counts in on a self-resetting counter, and
//                     the last block merges them level by level in shared
//                     memory.
//   merkle_tree       the whole Merkle array in one launch: merkle.cuh's
//                     kernel (shared with sha256_cols.cu) over BLAKE3's
//                     parent node.
//   merkle_walk       the verifier's path walk, a quad of lanes per opened
//                     column (blake3.cuh's quad_parent: the state's four
//                     columns in four lanes, the diagonals by shuffles), so
//                     a level waits on 14 G rather than 56 and on one
//                     lane's issue of a quarter of the compression; the
//                     next level's sibling is loaded while a level runs,
//                     and the child's words reach every lane of the quad by
//                     the feed-forward's shuffles.
//
// What bounds them on an H100 (SXM, 700 W): blake3_chunks, the integer pipes.
// A compression is 7 rounds x 8 G x 12 instructions (2 three-input adds, 2
// adds, 4 xors, 4 rotates; rotates by 16 and 8 are byte permutes, by 12 and
// 7 funnel shifts) plus 8 output xors, ~680 instructions.  The xors and
// rotates run on the ALU pipe; ptxas moves about half the adds to the FMA
// pipe (IMAD.IADD), so ~562 ALU-pipe instructions set the pace at 16.75e12
// a second, against 4 bytes of message per word read once: 2,056-word
// columns are ~0.53 ms of the ALU pipe per GB of words, 1.8 times the
// 0.30 ms/GB of reading them at 3.35 TB/s.  The trees do far less
// work (a 2^17-leaf tree is 0.005 ms of instructions), so what bounds them
// is their depth: a compression's dependency chain times the tree's levels,
// and before this design the host's issue of one launch per level.  So is
// the column hash of few columns: 189 columns of 2,056 words are 1,701
// chunks, far too few to fill the integer pipes, so its floor is a chunk's
// 16 chained compressions plus the chunk tree's ceil(log2 n) levels.
// blake3_chunks and the tree kernel took 2.4 times that, in two launches:
// each block's loads issued only after the previous compression ended,
// then the chunk CVs through device memory.  cols_few keeps the loads'
// latency off the chain and the CVs on the chip; its chunk chains still
// take ~1.0 us a block on the H100 against a lone compression's 0.73
// (scripts/time_blake3_few.py --trace), the block's 16 copies and ring
// reads adding ~400 SASS instructions to the compression's ~700.  The
// walk is a chain of depth dependent parents and its columns are few (189
// or 6,593): a thread a column took ~1.0 us a level on the H100 (one warp
// issuing the whole compression, 0.63-0.73 us, then waiting on its next
// loads), where the compression's own dependency chain is 14 G of ~12
// dependent instructions; the quad layout issues a quarter of it a lane
// and waits on that chain plus the diagonals' shuffles (0.47 us).
//
// The compression, the parent node, the quad's parent and the chunk body
// live in blake3.cuh, shared with the small commit's kernel
// (commit_small.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "blake3.cuh"
#include "merkle.cuh"

namespace {

using namespace b3;  // the compression, parent_cv, the flags (blake3.cuh)

constexpr int kThreads = 128;

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
  uint32_t cv[8];
  chunk_cv<lcpc::LoadNc>(cv, words, carry, carry_len, n_cols, c, (long long)j * 256, len,
                         chunk_base + (unsigned long long)j, root);
#pragma unroll
  for (int w = 0; w < 8; ++w) store_word(out + ((size_t)j * 8 + w) * n_cols + c, cv[w]);
}

// ---- the chunk tree: (n, 8, C) chunk CVs -> (8, C) digests ----------------

// One thread per column, BLAKE3's CV stack: chunk i < n - 1 is pushed after
// merging it with the stack top while the count of chunks so far (i + 1)
// has a trailing zero bit; the last chunk is then folded into the stack top
// down, ROOT on the last merge.  The stack lives in shared memory as
// [depth][word][thread], so a warp's accesses hit 32 different banks.
template <typename In>
__global__ void __launch_bounds__(kThreads)
chunk_tree_stack_kernel(const In* __restrict__ cvs, int n, int n_cols,
                        long long* __restrict__ out) {
  extern __shared__ uint32_t stack[];  // [depth][8][kThreads]
  const int t = threadIdx.x;
  const int c = blockIdx.x * kThreads + t;
  if (c >= n_cols) return;
  int top = 0;
  uint32_t cv[8], l[8];
  for (int i = 0;; ++i) {
#pragma unroll
    for (int w = 0; w < 8; ++w) cv[w] = (uint32_t)cvs[((size_t)i * 8 + w) * n_cols + c];
    if (i == n - 1) break;
    for (unsigned total = i + 1; (total & 1u) == 0; total >>= 1) {
      --top;
#pragma unroll
      for (int w = 0; w < 8; ++w) l[w] = stack[(top * 8 + w) * kThreads + t];
      parent_cv(cv, l, cv, PARENT);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) stack[(top * 8 + w) * kThreads + t] = cv[w];
    ++top;
  }
  while (top > 0) {
    --top;
#pragma unroll
    for (int w = 0; w < 8; ++w) l[w] = stack[(top * 8 + w) * kThreads + t];
    parent_cv(cv, l, cv, PARENT | (top == 0 ? ROOT : 0u));
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[(size_t)w * n_cols + c] = cv[w];
}

// One warp per column, for few columns: the tree level by level, adjacent
// pairs merged and an odd last node promoted (the same tree), each level in
// the warp's slice of shared memory ([word][node], cap = ceil(n / 2)
// nodes): ceil(log2 n) compressions deep instead of n - 1.
template <typename In>
__global__ void __launch_bounds__(kThreads)
chunk_tree_warp_kernel(const In* __restrict__ cvs, int n, int n_cols,
                       long long* __restrict__ out) {
  extern __shared__ uint32_t nodes[];  // [warp][8][cap]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (kThreads / 32) + warp;
  if (c >= n_cols) return;  // the whole warp leaves together
  const int cap = (n + 1) / 2;
  uint32_t* s = nodes + (size_t)warp * 8 * cap;
  uint32_t cv[8], l[8], r[8];
  for (int i = lane; i < cap; i += 32) {  // level 1, from the chunk CVs
#pragma unroll
    for (int w = 0; w < 8; ++w) l[w] = (uint32_t)cvs[((size_t)2 * i * 8 + w) * n_cols + c];
    if (2 * i + 1 < n) {
#pragma unroll
      for (int w = 0; w < 8; ++w)
        r[w] = (uint32_t)cvs[((size_t)(2 * i + 1) * 8 + w) * n_cols + c];
      parent_cv(cv, l, r, PARENT | (n == 2 ? ROOT : 0u));
    } else {
#pragma unroll
      for (int w = 0; w < 8; ++w) cv[w] = l[w];  // the promoted odd CV
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w * cap + i] = cv[w];
  }
  __syncwarp();
  for (int m = cap; m > 1; m = (m + 1) / 2) {
    const int pairs = m / 2;
    // a round reads nodes [2 base, 2 base + 64) and writes [base, base + 32)
    for (int base = 0; base < pairs; base += 32) {
      const int i = base + lane;
      if (i < pairs) {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          l[w] = s[w * cap + 2 * i];
          r[w] = s[w * cap + 2 * i + 1];
        }
        parent_cv(cv, l, r, PARENT | (m == 2 ? ROOT : 0u));
      }
      __syncwarp();
      if (i < pairs) {
#pragma unroll
        for (int w = 0; w < 8; ++w) s[w * cap + i] = cv[w];
      }
      __syncwarp();
    }
    if ((m & 1) && lane < 8) s[lane * cap + pairs] = s[lane * cap + m - 1];  // promote
    __syncwarp();
  }
  if (lane < 8) out[(size_t)lane * n_cols + c] = s[lane * cap];
}

// ---- the few-column route: (L, C) words -> (8, C) digests, one launch ----

constexpr int kFewWarps = 4;    // chunk warps a block: one a scheduler of its SM
constexpr int kFewStages = 4;   // a warp's ring of message blocks
constexpr int kFewRing = kFewStages * 16 * 32;  // its words, [stage][word][lane]
constexpr int kFewSlot = 8 * 32;                // a node of 32 columns, [word][lane]
constexpr int kFewSmemMax = 227 * 1024;         // an H100 block's dynamic shared memory

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block b of chunk j of column c (len words) into ring stage b % kFewStages:
// stream word 256 j + 16 b + t is words row (that - 8); the prefix's words,
// those past the chunk's end and a column past n_cols are zeros, stored
// directly.  A lane fills and reads only its own column's words.
__device__ __forceinline__ void few_issue(uint32_t* ring, const uint32_t* __restrict__ words,
                                         int n_cols, int c, bool col_ok, int j, int len,
                                         int b) {
  uint32_t* dst = ring + (b % kFewStages) * 16 * 32 + (threadIdx.x & 31);
  const long long first = (long long)kChunkWords * j + 16 * b - kPrefixWords;
  if (col_ok && first >= 0 && 16 * b + 16 <= len) {  // a whole block of words: no tests
    const uint32_t* src = words + first * n_cols + c;
#pragma unroll
    for (int t = 0; t < 16; ++t) cp_async4(dst + t * 32, src + (size_t)t * n_cols);
    return;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const long long row = first + t;
    if (col_ok && 16 * b + t < len && row >= 0)
      cp_async4(dst + t * 32, words + row * n_cols + c);
    else
      dst[t * 32] = 0u;
  }
}

// The CVs of warps 0 .. m-1 (a node a lane's column) merged into warp 0's,
// level by level: at level h warp w, a multiple of 2h, takes warp w + h's
// node as its right child when there is one; an odd last node rises
// unmerged (BLAKE3's tree, paired as chunk_tree_warp_kernel pairs it).  A
// warp writes its slot once, at the level it becomes a right child.  ROOT
// on the last merge when `root`.  Every thread of the block calls it.
__device__ __forceinline__ void merge_warps(uint32_t (&cv)[8], int m, bool root,
                                            uint32_t* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = 1; h < m; h <<= 1) {
    if (warp < m && (warp & (2 * h - 1)) == h) {
#pragma unroll
      for (int w = 0; w < 8; ++w) slots[(warp * 8 + w) * 32 + lane] = cv[w];
    }
    __syncthreads();
    if ((warp & (2 * h - 1)) == 0 && warp + h < m) {
      uint32_t r[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) r[w] = slots[((warp + h) * 8 + w) * 32 + lane];
      parent_cv(cv, cv, r, PARENT | (root && 2 * h >= m ? ROOT : 0u));
    }
  }
  __syncthreads();  // every slot read: free for the next merge
}

// The last block of a column group: its n >= 2 subtree CVs, in shared
// memory as nodes [node][word][lane], merged level by level (pairs, an odd
// last node promoted) by the block's warps a pair each, in rounds; ROOT on
// the last merge, whose CV warp 0 returns in cv.
__device__ __forceinline__ void merge_nodes(uint32_t (&cv)[8], int n, uint32_t* nodes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (; n > 2; n = (n + 1) / 2) {
    const int pairs = n / 2;
    for (int base = 0; base < pairs; base += n_warps) {
      const int i = base + warp;
      uint32_t l[8], r[8], p[8];
      if (i < pairs) {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          l[w] = nodes[(2 * i * 8 + w) * 32 + lane];
          r[w] = nodes[((2 * i + 1) * 8 + w) * 32 + lane];
        }
        parent_cv(p, l, r, PARENT);
      }
      __syncthreads();  // the round's nodes read before any is overwritten
      if (i < pairs) {
#pragma unroll
        for (int w = 0; w < 8; ++w) nodes[(i * 8 + w) * 32 + lane] = p[w];
      }
      __syncthreads();
    }
    if ((n & 1) && warp == 0) {  // promote: node n - 1 was written by no round
#pragma unroll
      for (int w = 0; w < 8; ++w)
        nodes[(pairs * 8 + w) * 32 + lane] = nodes[((n - 1) * 8 + w) * 32 + lane];
    }
    __syncthreads();
  }
  if (warp == 0) {
    uint32_t l[8], r[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      l[w] = nodes[w * 32 + lane];
      r[w] = nodes[(8 + w) * 32 + lane];
    }
    parent_cv(cv, l, r, PARENT | ROOT);
  }
}

// Block (x, y): columns [32 x, 32 x + 32), chunks [kFewWarps y, ...), warp w
// chunk kFewWarps y + w, with n_chunks chunks a column, the last final_len
// words.  One block a column group (gridDim.y == 1): its merge ends in the
// digest.  Several: each writes its subtree's CV to scratch (gridDim.y, 8,
// n_cols) and adds one to counters[x]; the last to arrive loads the
// gridDim.y CVs into shared memory (over the rings), merges them
// (merge_nodes: the subtrees are aligned runs of the level order, so the
// tree is the same) and sets counters[x] back to 0.
__global__ void __launch_bounds__(kFewWarps * 32)
blake3_cols_few_kernel(const uint32_t* __restrict__ words, int n_cols, int n_chunks,
                       int final_len, long long* __restrict__ out,
                       uint32_t* __restrict__ scratch, int* __restrict__ counters) {
  // rings [warp][kFewRing] (the last block's nodes after them), slots
  // [warp][kFewSlot], the flag: sized by lcpc_blake3_cols_few
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int n_groups = gridDim.y;
  const int ring_words = max(n_warps * kFewRing, n_groups > 1 ? n_groups * kFewSlot : 0);
  uint32_t* ring = smem + warp * kFewRing;
  uint32_t* slots = smem + ring_words;
  int* last = reinterpret_cast<int*>(slots + n_warps * kFewSlot);
  const int c = blockIdx.x * 32 + lane;
  const bool col_ok = c < n_cols;
  const int j = blockIdx.y * kFewWarps + warp;
  const int m = min(n_warps, n_chunks - (int)blockIdx.y * kFewWarps);  // this block's chunks
  uint32_t cv[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (warp < m) {
    const int len = j == n_chunks - 1 ? final_len : kChunkWords;
    const int n_blocks = (len + 15) >> 4;
#pragma unroll 1
    for (int s = 0; s < kFewStages - 1; ++s) {
      if (s < n_blocks) few_issue(ring, words, n_cols, c, col_ok, j, len, s);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = kIV[i];
    for (int b = 0; b < n_blocks; ++b) {
      if (b + kFewStages - 1 < n_blocks)
        few_issue(ring, words, n_cols, c, col_ok, j, len, b + kFewStages - 1);
      cp_async_commit();
      cp_async_wait<kFewStages - 1>();  // block b's group has landed
      uint32_t msg[16];
      const uint32_t* src = ring + (b % kFewStages) * 16 * 32 + lane;
#pragma unroll
      for (int t = 0; t < 16; ++t) msg[t] = src[t * 32];
      const bool end = b == n_blocks - 1;
      const uint32_t flags = (b == 0 ? CHUNK_START : 0u) |
                             (end ? (CHUNK_END | (n_chunks == 1 ? ROOT : 0u)) : 0u);
      compress(cv, msg, (unsigned long long)j, end ? (uint32_t)(len - 16 * b) * 4u : 64u,
               flags);
    }
  }
  merge_warps(cv, m, n_groups == 1, slots);
  if (n_groups > 1) {
    if (warp == 0 && col_ok) {
#pragma unroll
      for (int w = 0; w < 8; ++w) scratch[((size_t)blockIdx.y * 8 + w) * n_cols + c] = cv[w];
    }
    __threadfence();  // this block's CVs are visible before its count is
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(counters + blockIdx.x, 1) == n_groups - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int i = warp; i < n_groups; i += n_warps) {
#pragma unroll
      for (int w = 0; w < 8; ++w)
        smem[(i * 8 + w) * 32 + lane] =
            col_ok ? __ldcg(scratch + ((size_t)i * 8 + w) * n_cols + c) : 0u;
    }
    __syncthreads();
    merge_nodes(cv, n_groups, smem);
    if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch on this stream
  }
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int w = 0; w < 8; ++w) out[(size_t)w * n_cols + c] = cv[w];
  }
}

// ---- the verifier's path walk: a quad of lanes a column ---------------------

constexpr int kWalkQuadThreads = 128;  // 32 columns a block

// Column j (a quad of lanes) starts from its digest and walks `levels`
// levels: the sibling is sibs[:, inv[l, j]], on the left when bit l of
// idx[j] is set; each level one quad_parent over the side's message.  The
// next level's sibling and the index after it are loaded while a level
// runs, and each load is first read a level after it is issued (the index
// scaled, the sibling moved into place after the compression), in a loop
// body without branches (past the last level the loads repeat its row, read
// by no one): a level waits on its compression alone, not on a load's L2
// latency.  Quads past k walk column k - 1 and store nothing: every lane
// runs every shuffle.  The end is merkle.cuh's walk_end split by lane: lane
// q holds words q and 4 + q of the root it reached and writes them to out,
// or compares them with root's, the quad's four lanes voting (a ballot) and
// its first lane clearing *flag where any of them differs.
__global__ void __launch_bounds__(kWalkQuadThreads)
merkle_walk_quad_kernel(const long long* __restrict__ digs, long long d_w, long long d_c,
                        const long long* __restrict__ sibs, long long s_w, long long s_c,
                        const long long* __restrict__ inv, const long long* __restrict__ idx,
                        int k, int levels, long long* __restrict__ out,
                        const long long* __restrict__ root, int32_t* __restrict__ flag) {
  const Quad L(threadIdx.x);
  const int q = threadIdx.x & 3;
  const long long j_at = (long long)blockIdx.x * (kWalkQuadThreads / 4) + threadIdx.x / 4;
  const bool live = j_at < k;
  const long long j = live ? j_at : k - 1;
  uint32_t node[8], sib[8] = {};
#pragma unroll
  for (int w = 0; w < 8; ++w) node[w] = (uint32_t)digs[w * d_w + j * d_c];
  const long long col = idx[j];
  const long long last = levels > 0 ? levels - 1 : 0;  // a row of inv past which loads repeat
  long long inv_next = levels > 1 ? inv[(long long)k + j] : 0;  // level 1's sibling
  if (levels > 0) {
    const long long at = inv[j] * s_c;
#pragma unroll
    for (int w = 0; w < 8; ++w) sib[w] = (uint32_t)sibs[w * s_w + at];
  }
  for (int lvl = 0; lvl < levels; ++lvl) {
    // the next level's sibling, by the index loaded a level ago, and the
    // index after it; read after this level's compression, and the next
    const long long at = inv_next * s_c;
    uint32_t next[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) next[w] = (uint32_t)sibs[w * s_w + at];
    inv_next = inv[min((long long)lvl + 2, last) * k + j];
    // the side by selects: a quad's lanes take the same one, a warp's both
    const bool right = (col >> lvl) & 1;
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      m[w] = right ? sib[w] : node[w];
      m[8 + w] = right ? node[w] : sib[w];
    }
    quad_parent(node, m, MERKLE, L);
#pragma unroll
    for (int w = 0; w < 8; ++w) sib[w] = next[w];
  }
  const uint32_t lo = L.pick(node[0], node[1], node[2], node[3]);
  const uint32_t hi = L.pick(node[4], node[5], node[6], node[7]);
  if (root != nullptr) {
    const bool differ = lo != (uint32_t)root[q] || hi != (uint32_t)root[4 + q];
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, differ) >> (threadIdx.x & 28);
    if (live && q == 0 && (votes & 0xFu)) *flag = 0;
    return;
  }
  if (live) {
    out[(size_t)q * k + j] = lo;
    out[(size_t)(4 + q) * k + j] = hi;
  }
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

// The chunk tree of every column: cvs (n, 8, n_cols) chunk CVs, u32 words
// or, with in_i64, int64 storage -> out (8, n_cols) int64 digests, BLAKE3's
// largest-power-of-two-left tree over the n >= 2 CVs (PARENT, ROOT at the
// top).  lanes = 1: a thread per column with the CV stack (n < 2^16);
// lanes = 32: a warp per column, level by level (n <= 512).
extern "C" int lcpc_blake3_chunk_tree(const void* cvs, int in_i64, int n, int n_cols, int lanes,
                                      long long* out, int device, void* stream) {
  if (cvs == nullptr || out == nullptr || n < 2 || n_cols < 1 ||
      !((lanes == 1 && n <= 65536) || (lanes == 32 && n <= 512)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 1) {
    int depth = 0;  // the stack's height never exceeds the bit length of n - 1
    for (unsigned v = n - 1; v; v >>= 1) ++depth;
    const int smem = depth * 8 * kThreads * 4;
    const unsigned blocks = (n_cols + kThreads - 1) / kThreads;
    if (in_i64) {
      auto k = chunk_tree_stack_kernel<long long>;
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      k<<<blocks, kThreads, smem, s>>>(static_cast<const long long*>(cvs), n, n_cols, out);
    } else {
      auto k = chunk_tree_stack_kernel<uint32_t>;
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      k<<<blocks, kThreads, smem, s>>>(static_cast<const uint32_t*>(cvs), n, n_cols, out);
    }
  } else {
    const int per_block = kThreads / 32;
    const int smem = per_block * 8 * ((n + 1) / 2) * 4;
    const unsigned blocks = (n_cols + per_block - 1) / per_block;
    if (in_i64)
      chunk_tree_warp_kernel<long long><<<blocks, kThreads, smem, s>>>(
          static_cast<const long long*>(cvs), n, n_cols, out);
    else
      chunk_tree_warp_kernel<uint32_t><<<blocks, kThreads, smem, s>>>(
          static_cast<const uint32_t*>(cvs), n, n_cols, out);
  }
  return (int)cudaGetLastError();
}

// The column hash of words (n_words, n_cols) row-major u32 into out (8,
// n_cols) int64: column c's digest is BLAKE3 of 8 zero words || its words,
// in one launch.  With more than kFewWarps chunks a column (n_words > 1,016)
// it needs scratch, ceil(chunks / kFewWarps) x 8 x n_cols u32, and counters,
// one int a 32-column group, all 0 (the kernel leaves them 0); the last
// block's shared memory holds a node of each of those groups of chunks.
extern "C" int lcpc_blake3_cols_few(const int32_t* words, long long n_words, int n_cols,
                                    long long* out, void* scratch, int* counters, int device,
                                    void* stream) {
  const long long total = kPrefixWords + n_words;
  const long long n_chunks = (total + kChunkWords - 1) / kChunkWords;
  const long long n_groups = (n_chunks + kFewWarps - 1) / kFewWarps;
  const int n_warps = (int)(n_chunks < kFewWarps ? n_chunks : kFewWarps);
  const long long ring_words =
      n_groups > 1 && n_groups * kFewSlot > n_warps * kFewRing ? n_groups * kFewSlot
                                                               : n_warps * kFewRing;
  const long long smem = 4 * (ring_words + n_warps * kFewSlot + 1);
  if (n_cols < 1 || n_words < 0 || out == nullptr || (words == nullptr && n_words > 0) ||
      smem > kFewSmemMax || (n_groups > 1 && (scratch == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(blake3_cols_few_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_cols + 31) / 32, (unsigned)n_groups);
  blake3_cols_few_kernel<<<grid, n_warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(words), n_cols, (int)n_chunks,
      (int)(total - kChunkWords * (n_chunks - 1)), out, static_cast<uint32_t*>(scratch),
      counters);
  return (int)cudaGetLastError();
}

// The whole Merkle tree over leaves (8, n_cols) int64 (word stride ld,
// column stride 1): merkle.cuh's launch_tree with BLAKE3's parent.
extern "C" int lcpc_blake3_merkle_tree(const long long* leaves, long long ld, int n_cols,
                                       long long np2, long long* out, unsigned* counter,
                                       int device, void* stream) {
  return merkle::launch_tree<Blake3Merkle>(leaves, ld, n_cols, np2, out, counter, device,
                                           stream);
}

// The Merkle path walk of k opened columns over `levels` levels (arguments
// as merkle.cuh's walk_args_ok takes them), the roots into out or compared
// with root (clearing *flag where one differs): merkle_walk_quad_kernel.
extern "C" int lcpc_blake3_merkle_walk(const long long* digs, long long d_w, long long d_c,
                                       const long long* sibs, long long s_w, long long s_c,
                                       const long long* inv, const long long* idx, int k,
                                       int levels, long long* out, const long long* root,
                                       int32_t* flag, int device, void* stream) {
  if (!merkle::walk_args_ok(digs, sibs, inv, idx, k, levels, out, root, flag))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (4LL * k + kWalkQuadThreads - 1) / kWalkQuadThreads;
  merkle_walk_quad_kernel<<<(unsigned)blocks, kWalkQuadThreads, 0, (cudaStream_t)stream>>>(
      digs, d_w, d_c, sibs, s_w, s_c, inv, idx, k, levels, out, root, flag);
  return (int)cudaGetLastError();
}
