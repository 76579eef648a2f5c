// The verifier's fused core and the prover's one-launch opening.
//
// Replaces the XLA-fused graphs of lcpc_tpu, none of them a Pallas kernel:
//   - lcpc_tpu/core/protocol.py:807 `_verify_core_fn` and :767
//     `_verify_core_cols_fn`: the opened columns checked against the
//     degree-test and evaluation tensors and the encoded rows, the columns'
//     canonical hash words (their hash and the path walk against the root
//     follow in the digest's kernels: blake3_cols.cu, sha256_cols.cu);
//   - :730 `_eval_dot_fn`: the evaluation sum_j inner[j] p_eval[j] mod p,
//     fused into the same output;
//   - :547 `_gather_open` / :538 `_gather_packed` and
//     lcpc_tpu/core/streaming.py:332 `_gather_canon_fn`: everything the
//     prover opens, in one buffer.
//
//   verify_check  one grid of thread-block clusters, two kinds.
//     column clusters  32 opened columns (a lane each: every load and store
//                    of a warp is one run), the rows split over the
//                    cluster's `splits` blocks (at most 16).  A block
//                    streams its rows through a ring of kStages shared-memory
//                    stages, kChunk rows each (the columns' words and the
//                    tensors' at those rows, by cp.async, kStages - 1 chunks
//                    in flight while one is used); its 8 warps sum the T
//                    products ts[t, r] col[r, j] of the stage's rows
//                    unreduced (mont.cuh's Acc) and write from_mont(col) as
//                    the columns' canonical hash words, (R W, k), from the
//                    same stage.  Rank 0 fetches the wanted values first
//                    (enc_rows[:, t, idx[j]], or want[:, t, j] on the columns
//                    route, by cp.async into shared memory), so their load
//                    hides behind the products.  The warps' exact sums meet
//                    in shared memory and one warp reduces each t's once;
//                    the blocks' residues meet in distributed shared memory
//                    after a cluster barrier, rank 0 adds them and compares
//                    each sum with from_mont of its wanted value: a mismatch
//                    clears flag t.  Nothing of the column check meets in
//                    global memory.
//     eval clusters  a grid-stride run over j < npr of inner[j] p_eval[j],
//                    both canonical words, summed unreduced; a block's warps
//                    meet in shared memory (one reduction a lane), a
//                    cluster's blocks in distributed shared memory, the
//                    clusters through one counter: the last cluster to
//                    finish adds their residues and turns S R^-2 into S with
//                    one Montgomery product by R^3 mod p.
//     The grid fills the card once: at most 128 registers (two blocks an
//     SM), the eval blocks sized by the occupancy API beside the column
//     clusters, each cluster's blocks spread over distinct SMs.  The hot
//     code is kept small (the rows loop not unrolled, one reduction's code
//     for both kinds).  What bounds it is the CUDA cores' wide products.
//   gather_open   the opened columns as packed Montgomery words (W, R, k),
//                 walked in ascending column order: the host's plan lists
//                 the unique columns sorted, each with its slots j
//                 (sampling is with replacement), so a column is read once
//                 and written to every slot, its plan entry one 16-byte
//                 load.  From the committed codeword's limbs, read in
//                 place, a warp takes one (word w, row r) and up to 256 of
//                 its columns, 8 a lane all in flight; from packed words (the
//                 int64 words of the 2^29 opening) a thread takes one
//                 element's W words, lanes over neighbouring columns, by
//                 plain loads (a warp reads whole sectors there); from
//                 the kept canonical hash words (columns >= off, at c - off)
//                 a warp takes one row and 64 of its columns, W words each,
//                 converted to Montgomery form.  The scattered loads allocate
//                 nothing in L1 and mark their lines evict-first in L2.  Then
//                 the unique path nodes (8, U) of the Merkle array: one
//                 buffer for one copy to the host.
//
// state, the verifier's output (int32, set by the caller before the launch:
// one host-to-device copy with the inputs): T row flags (1), the path flag
// (1; cleared by the walk), the evaluation's W words (0) and the eval
// counter (0); the cluster that finds the counter full resets it, so a
// state serves launch after launch (timing).
//
// What bounds them on an H100: verify_check its bytes (the opened columns,
// the proof rows read once) or its wide products (T R k W^2 + npr W^2);
// gather_open its bytes, scattered reads of the opened columns' words, a
// limb or word in its own 32-byte sector: the card reads those at 0.8-1.0
// TB/s of sectors in any order (scripts/gather_probe.cu), a quarter of its
// streaming rate.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mont.cuh"

namespace cg = cooperative_groups;
using namespace lcpc;

namespace {

constexpr int kCols = 32;   // opened columns a column block, a lane each
constexpr int kWarps = 8;   // warps a block, over the rows (column blocks) or j (eval blocks)
constexpr int kThreads = 32 * kWarps;
constexpr int kAccWords = 16;  // accumulator rows a thread keeps: T is taken kAccWords / W at a time
constexpr int kChunk = 16;     // rows a stage of the ring
constexpr int kStages = 4;     // stages of the ring
constexpr int kMaxCluster = 16;
constexpr int kEvalTerms = 4;  // evaluation terms a thread has in flight
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kGatherThreads = 256;
constexpr int kLaneCols = 8;   // columns a lane of a Montgomery-source task
constexpr int kCanonCols = 2;  // columns a lane of a canonical-words task (W words each)

// an operand of elements (a, b), word w of element (a, b) at
// p + w s_w + a s_a + b s_b in int32 storage; with `limbs` the word axis
// holds 16-bit limbs and word w is limb 2w | limb 2w + 1 << 16
struct View {
  const int32_t* p;
  long long s_w, s_a, s_b;
  int limbs;
};

template <int W>
__device__ __forceinline__ void load(uint32_t (&x)[W], const View& v, long long a, long long b) {
  const int32_t* q = v.p + a * v.s_a + b * v.s_b;
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = (uint32_t)__ldg(q + w * v.s_w);
}

// 4 bytes global -> shared, asynchronous (completion by commit groups)
__device__ __forceinline__ void cp_async4(uint32_t* smem, const int32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// With -DLCPC_VC_TRACE (scripts/time_verify_core.py --trace), thread 0 of
// each block stamps %globaltimer into vc_trace at its phases (six slots a
// block); lcpc_vc_trace copies them out and clears them.
#ifdef LCPC_VC_TRACE
__device__ unsigned long long vc_trace[6 * 8192];
__device__ __forceinline__ unsigned long long vc_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define VC_STAMP(slot) \
  do {                 \
    if (threadIdx.x == 0) vc_trace[6 * blockIdx.x + (slot)] = vc_now(); \
  } while (0)
#else
#define VC_STAMP(slot) \
  do {                 \
  } while (0)
#endif

// an L2 cache policy marking lines evict-first, and a load that allocates
// nothing in L1 and takes that policy in L2 (L2::evict_first as such is only
// for 256-bit loads)
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint32_t ld_stream(const int32_t* p, unsigned long long pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// An exact sum (mont.cuh's Acc) in shared memory: its 3W + 1 words, a
// lane's kCols apart.
template <int W>
constexpr int kAccLen = 3 * W + 1;

template <int W>
__device__ __forceinline__ void acc_store(uint32_t* p, const Acc<W>& a) {
#pragma unroll
  for (int i = 0; i < 2 * W; ++i) p[i * kCols] = a.lo[i];
#pragma unroll
  for (int i = 0; i <= W; ++i) p[(2 * W + i) * kCols] = a.cw[i];
}

// a += the exact sum at p: the words in one carry chain (its carry into
// position 2W, cw[W]'s), the carry counts added
template <int W>
__device__ __forceinline__ void acc_add(Acc<W>& a, const uint32_t* p) {
  a.lo[0] = add_cc(a.lo[0], p[0]);
#pragma unroll
  for (int i = 1; i < 2 * W; ++i) a.lo[i] = addc_cc(a.lo[i], p[i * kCols]);
  a.cw[W] = addc(a.cw[W], p[3 * W * kCols]);
#pragma unroll
  for (int i = 0; i < W; ++i) a.cw[i] += p[(2 * W + i) * kCols];
}

// The residue S R^-2 mod p of the n exact sums at p, p + kAccLen kCols,
// ... (a lane's) into out[0], out[kCols], ...: one reduction for them all.
// Not inlined: the verifier's column and eval blocks share its one copy.
template <int W>
__device__ __noinline__ void finish_sums(uint32_t* out, const uint32_t* p, int n,
                                         const uint32_t* __restrict__ consts) {
  const Field<W> f(consts);
  Acc<W> a;
  a.zero();
  for (int m = 0; m < n; ++m) acc_add<W>(a, p + m * kAccLen<W> * kCols);
  uint32_t r[W];
  finish<W>(r, a, f, consts, false);
#pragma unroll
  for (int w = 0; w < W; ++w) out[w * kCols] = r[w];
}

// The shared memory of verify_check (32-bit words): the ring, its stages
// each (W, kChunk, kCols) column words and (W, kMaxT, kChunk) tensor words
// (after the rows it holds the warps' exact sums, (kMaxT, kWarps, 3W + 1,
// kCols), then the splits' residues); the block's residues (T, W, kCols);
// rank 0's wanted values (T, nw, kCols).
template <int W>
struct CheckSmem {
  static constexpr int kMaxT = kAccWords / W;
  static constexpr int kStageCol = W * kChunk * kCols;
  static constexpr int kStageTs = W * kMaxT * kChunk;
  static constexpr int kStage = kStageCol + kStageTs;
  static constexpr int kSums = kMaxT * kWarps * kAccLen<W> * kCols;
  static constexpr int kRing = kStages * kStage > kSums ? kStages * kStage : kSums;
  static size_t bytes(int T, int nw) {
    return 4 * ((size_t)kRing + (size_t)T * (W + nw) * kCols);
  }
};

struct CheckArgs {
  View ts;                // (W, T, R) words: element (t, r), Montgomery
  View col;               // (W, R, k) words: element (r, j), Montgomery, any value < R
  View want;              // element (t, idx[j]) of the encoded rows' limbs, or (t, j) words
  const long long* idx;   // (k,) the opened columns
  int want_at_idx;
  View pe, inner;         // (W, npr) canonical words: element (0, j)
  int T, k, groups, splits, eval_blocks;
  long long R, rows_split, npr;
  int32_t* words;         // (R W, k) canonical hash words
  int32_t* state;
  uint32_t* scratch;      // the eval clusters' residues
  const uint32_t* consts; // p | n0 | R^2 mod p | R mod p | R^3 mod p
};

// s += the other 31 lanes' s (mod p), into lane 0
template <int W>
__device__ __forceinline__ void warp_sum(uint32_t (&s)[W], const Field<W>& f) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t o[W];
#pragma unroll
    for (int w = 0; w < W; ++w) o[w] = __shfl_down_sync(0xFFFFFFFFu, s[w], off);
    f.add(s, s, o);
  }
}

// This block's share of sum_j inner[j] p_eval[j]: share b of n, its
// threads' j = b 256 + tid, then n 256 further, kEvalTerms terms' loads in
// flight a thread.  The 8 warps' exact sums meet in `sums`, warp 0 reduces
// each lane's once (into tmp) and adds the lanes: the block's residue into
// ev[0 .. W).  The caller's barrier follows.
template <int W>
__device__ __forceinline__ void eval_share(const CheckArgs& a, int b, int n, uint32_t* sums,
                                           uint32_t* tmp, uint32_t* ev, const Field<W>& f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  {
    Acc<W> acc;
    acc.zero();
    const long long step = (long long)n * kThreads;
    for (long long j0 = (long long)b * kThreads + threadIdx.x; j0 < a.npr;
         j0 += kEvalTerms * step) {
      uint32_t x[kEvalTerms][W], z[kEvalTerms][W];
#pragma unroll
      for (int q = 0; q < kEvalTerms; ++q) {
        const long long jj = j0 + q * step;
        if (jj < a.npr) {
          load<W>(x[q], a.pe, 0, jj);
          load<W>(z[q], a.inner, 0, jj);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) x[q][w] = z[q][w] = 0u;
        }
      }
#pragma unroll
      for (int q = 0; q < kEvalTerms; ++q) acc.mac(x[q], z[q]);
    }
    acc_store<W>(sums + warp * kAccLen<W> * kCols + lane, acc);
  }
  __syncthreads();
  if (warp == 0) {
    finish_sums<W>(tmp + lane, sums + lane, kWarps, a.consts);  // lane l's S R^-2
    uint32_t s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = tmp[w * kCols + lane];
    warp_sum<W>(s, f);
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) ev[w] = s[w];
    }
  }
}

// The evaluation's meet, by warp 0 of a cluster's rank 0 after a cluster
// barrier: the cluster's residues (a lane a block), then the n_clusters
// clusters' through the counter (none for one cluster); the last writes S
// from S R^-2 with one Montgomery product by R^3 mod p into the state.
template <int W>
__device__ __forceinline__ void eval_meet(const CheckArgs& a, const cg::cluster_group& cluster,
                                          int c_index, int n_clusters, uint32_t* ev,
                                          bool* last, const Field<W>& f) {
  const int lane = threadIdx.x % 32;
  uint32_t c[W] = {};
  if (lane < a.splits) {
    const uint32_t* o = cluster.map_shared_rank(ev, lane);
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = o[w];
  }
  warp_sum<W>(c, f);
  unsigned* counter = reinterpret_cast<unsigned*>(a.state + a.T + 1 + W);
  if (lane == 0 && n_clusters > 1) {
#pragma unroll
    for (int w = 0; w < W; ++w) a.scratch[(size_t)c_index * W + w] = c[w];
    __threadfence();  // this cluster's residue is visible before its count is
    *last = atomicAdd(counter, 1u) == (unsigned)n_clusters - 1;
  }
  __syncwarp();
  VC_STAMP(4);  // the counter
  if (n_clusters > 1 && !*last) return;
  uint32_t t[W] = {};
  if (n_clusters == 1) {  // one cluster: its residue is the sum
#pragma unroll
    for (int w = 0; w < W; ++w) t[w] = c[w];
  } else {
    __threadfence();
    if (lane == 0) *counter = 0u;  // ready for the next launch with this state
    for (int v = lane; v < n_clusters; v += 32) {
      uint32_t o[W];
#pragma unroll
      for (int w = 0; w < W; ++w) o[w] = __ldcg(a.scratch + (size_t)v * W + w);
      f.add(t, t, o);
    }
    warp_sum<W>(t, f);
  }
  if (lane == 0) {
    uint32_t r3[W], u[W];
#pragma unroll
    for (int w = 0; w < W; ++w) r3[w] = __ldg(a.consts + 3 * W + 1 + w);
    f.mul(u, t, r3);
#pragma unroll
    for (int w = 0; w < W; ++w) a.state[a.T + 1 + w] = (int32_t)u[w];
  }
  VC_STAMP(5);  // the evaluation
}

// two blocks an SM (at most 128 registers): the column clusters and the
// eval blocks fill the card in one wave
template <int W>
__global__ void __launch_bounds__(kThreads, 2) verify_check_kernel(const CheckArgs a) {
  using S = CheckSmem<W>;
  constexpr int kMaxT = S::kMaxT;
  constexpr int kLen = kAccLen<W>;
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* sums = sm;  // after the rows: the warps' exact sums, then the splits' residues
  uint32_t* res = sm + S::kRing;
  uint32_t* want_s = res + (size_t)a.T * W * kCols;
  __shared__ bool last;
  __shared__ uint32_t ev[W];  // the block's residue of the evaluation
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_col_blocks = a.groups * a.splits;
  VC_STAMP(0);

  if ((int)blockIdx.x < n_col_blocks) {
    const Field<W> f(a.consts);
    uint32_t p2[W];
    twice<W>(p2, f.p);
    const int g = blockIdx.x / a.splits;  // this cluster's column group; rank: its split
    const int nw = a.want_at_idx ? 2 * W : W;
    const int j_at = g * kCols + lane;
    const bool live = j_at < a.k;
    const long long r0 = (long long)rank * a.rows_split;
    const long long r1 = r0 + a.rows_split < a.R ? r0 + a.rows_split : a.R;
    const int n_chunks = r1 > r0 ? (int)((r1 - r0 + kChunk - 1) / kChunk) : 0;
    // chunk c of the rows into its stage: thread e's copies are words e,
    // e + 256, ... of the stage (lane-fastest: a warp copies a run)
    auto issue_chunk = [&](int c, int t0, int nt) {
      uint32_t* st = sm + (c % kStages) * S::kStage;
      const long long rc = r0 + (long long)c * kChunk;
      const int nr = r1 - rc < kChunk ? (int)(r1 - rc) : kChunk;
      const int jj = live ? j_at : a.k - 1;  // e % 32 == lane
#pragma unroll 4
      for (int e = threadIdx.x; e < S::kStageCol; e += kThreads) {
        const int rl = (e / kCols) % kChunk, w = e / (kCols * kChunk);
        if (rl < nr)
          cp_async4(st + e, a.col.p + w * a.col.s_w + (rc + rl) * a.col.s_a + jj * a.col.s_b);
      }
      uint32_t* sts = st + S::kStageCol;
      for (int e = threadIdx.x; e < S::kStageTs; e += kThreads) {
        const int rl = e % kChunk, u = (e / kChunk) % kMaxT, w = e / (kChunk * kMaxT);
        if (rl < nr && u < nt)
          cp_async4(sts + e, a.ts.p + w * a.ts.s_w + (t0 + u) * a.ts.s_a + (rc + rl) * a.ts.s_b);
      }
    };
    // rank 0's wanted values: word (or limb) w of row t at the lane's column
    auto issue_want = [&]() {
      const int jj = live ? j_at : a.k - 1;  // e % 32 == lane: one column a thread
      const long long c = a.want_at_idx ? a.idx[jj] : jj;
      for (int e = threadIdx.x; e < a.T * nw * kCols; e += kThreads) {
        const int q = e / kCols, t = q / nw, w = q % nw;
        cp_async4(want_s + e, a.want.p + w * a.want.s_w + t * a.want.s_a + c * a.want.s_b);
      }
    };

    for (int t0 = 0; t0 < a.T; t0 += kMaxT) {
      const int nt = a.T - t0 < kMaxT ? a.T - t0 : kMaxT;
      // groups: kStages - 1 chunks, then (first pass) the wanted values,
      // then a chunk an iteration (empty past the last)
#pragma unroll 1
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < n_chunks) issue_chunk(c, t0, nt);
        cp_async_commit();
      }
      if (t0 == 0) {
        if (rank == 0) issue_want();
        cp_async_commit();
      }
      Acc<W> acc[kMaxT];
#pragma unroll
      for (int u = 0; u < kMaxT; ++u) acc[u].zero();
#pragma unroll 1
      for (int c = 0; c < n_chunks; ++c) {
        if (c + kStages - 1 < n_chunks) issue_chunk(c + kStages - 1, t0, nt);
        cp_async_commit();
        // chunk c's group done: the groups after it may still be pending
        if (t0 == 0 && c < kStages - 1)
          cp_async_wait<kStages>();
        else
          cp_async_wait<kStages - 1>();
        __syncthreads();
        if (c == 0 && t0 == 0) VC_STAMP(1);  // the first chunk is in
        const uint32_t* st = sm + (c % kStages) * S::kStage;
        const uint32_t* sts = st + S::kStageCol;
        const long long rc = r0 + (long long)c * kChunk;
        const int nr = r1 - rc < kChunk ? (int)(r1 - rc) : kChunk;
#pragma unroll 1
        for (int rl = warp; rl < nr; rl += kWarps) {
          uint32_t x[W];
#pragma unroll
          for (int w = 0; w < W; ++w) x[w] = st[(w * kChunk + rl) * kCols + lane];
          if (t0 == 0 && live) {  // the column's canonical hash words
            uint32_t xr[W], z[W];
#pragma unroll
            for (int w = 0; w < W; ++w) xr[w] = x[w];
            reduce<W>(xr, f.p, p2);
            f.from_mont(z, xr);
            const long long r = rc + rl;
#pragma unroll
            for (int w = 0; w < W; ++w) a.words[(r * W + w) * a.k + j_at] = (int32_t)z[w];
          }
#pragma unroll
          for (int u = 0; u < kMaxT; ++u) {
            if (u < nt) {
              uint32_t s[W];
#pragma unroll
              for (int w = 0; w < W; ++w) s[w] = sts[(w * kMaxT + u) * kChunk + rl];
              acc[u].mac(s, x);
            }
          }
        }
        __syncthreads();  // the stage is refilled next
      }
      VC_STAMP(2);  // the rows
      // the 8 warps' exact sums of each t meet in shared memory; warp u
      // reduces t0 + u's once (each sum S < R_rows R^2: S R^-2, the plain value)
#pragma unroll
      for (int u = 0; u < kMaxT; ++u)
        if (u < nt) acc_store<W>(sums + (u * kWarps + warp) * kLen * kCols + lane, acc[u]);
      __syncthreads();
      if (warp < nt)
        finish_sums<W>(res + (t0 + warp) * W * kCols + lane,
                       sums + warp * kWarps * kLen * kCols + lane, kWarps, a.consts);
      __syncthreads();  // the sums are the next pass's ring
      VC_STAMP(3);  // the block's residues
    }
    cp_async_wait<0>();
    __syncthreads();  // rank 0's wanted values are in
    cluster.sync();   // every block's residues are in its shared memory
    VC_STAMP(4);
    if (rank == 0) {
      for (int t0 = 0; t0 < a.T; t0 += kMaxT) {
        const int nt = a.T - t0 < kMaxT ? a.T - t0 : kMaxT;
        // warp v adds the residues of ranks v, v + 8 (all kMaxT rows' words
        // in flight at once), then warp u adds the warps' for t0 + u
        uint32_t s[kMaxT][W] = {};
        for (int y = warp; y < a.splits; y += kWarps) {
          const uint32_t* o = cluster.map_shared_rank(res, y) + t0 * W * kCols + lane;
          uint32_t v[kMaxT][W];
#pragma unroll
          for (int u = 0; u < kMaxT; ++u)
#pragma unroll
            for (int w = 0; w < W; ++w) v[u][w] = u < nt ? o[(u * W + w) * kCols] : 0u;
#pragma unroll
          for (int u = 0; u < kMaxT; ++u) f.add(s[u], s[u], v[u]);
        }
#pragma unroll
        for (int u = 0; u < kMaxT; ++u)
#pragma unroll
          for (int w = 0; w < W; ++w) sums[((u * kWarps + warp) * W + w) * kCols + lane] = s[u][w];
        __syncthreads();
        if (warp < nt && live) {
          const int t = t0 + warp;
          const uint32_t* q = sums + (warp * kWarps) * W * kCols + lane;
          uint32_t r[W];
#pragma unroll
          for (int w = 0; w < W; ++w) r[w] = q[w * kCols];
#pragma unroll 1
          for (int v = 1; v < kWarps; ++v) {
            uint32_t o[W];
#pragma unroll
            for (int w = 0; w < W; ++w) o[w] = q[(v * W + w) * kCols];
            f.add(r, r, o);
          }
          // the plain value of sum_r ts[t, r] col[r, j] against from_mont
          // of the wanted value: a mismatch clears flag t
          const uint32_t* ws = want_s + t * nw * kCols + lane;
          uint32_t v[W], z[W];
#pragma unroll
          for (int w = 0; w < W; ++w)
            v[w] = a.want_at_idx ? (ws[2 * w * kCols] & 0xFFFFu) | (ws[(2 * w + 1) * kCols] << 16)
                                 : ws[w * kCols];
          reduce<W>(v, f.p, p2);
          f.from_mont(z, v);
          bool eq = true;
#pragma unroll
          for (int w = 0; w < W; ++w) eq &= z[w] == r[w];
          if (!eq) a.state[t] = 0;
        }
        __syncthreads();  // the sums' room is the next rows'
      }
      VC_STAMP(5);  // checked
    }
    cluster.sync();  // the other blocks' shared memory stays until rank 0 has read it
    return;
  }

  // an eval block: its share of the evaluation; the cluster's meet
  const Field<W> f(a.consts);
  const int e = blockIdx.x - n_col_blocks;
  eval_share<W>(a, e, a.eval_blocks, sums, sums + kWarps * kLen * kCols, ev, f);
  VC_STAMP(2);  // the block's residue
  cluster.sync();
  VC_STAMP(3);
  if (rank == 0 && warp == 0) eval_meet<W>(a, cluster, e / a.splits, a.eval_blocks / a.splits,
                                           ev, &last, f);
  cluster.sync();  // the cluster's blocks stay until rank 0 has read them
}

struct GatherArgs {
  const int4* plan;       // (U,) the unique columns ascending: (column, its first slot, the
                          // start of its run of slots in perm, the run's length)
  const int32_t* perm;    // (k,) the slots in column order
  int k, U, u_mont;       // u_mont: the unique columns below off
  long long R, off;
  View mont;              // element (r, c), c < off: packed words out as they are
  const int32_t* canon;   // (R W, n - off) canonical hash words: c >= off, at c - off
  long long canon_ld;
  const long long* hashes;  // (8, nodes) int64 digest words
  long long hashes_ld;
  const long long* uniq;  // (n_nodes,) node indices
  int n_nodes;
  int mont_chunks, canon_chunks;
  long long mont_tasks, mont_blocks, col_blocks;  // mont_blocks: the Montgomery source's
  int32_t* out;           // (W, R, k) words, then (8, n_nodes)
  const uint32_t* consts;
};

// word v of a column into its first slot j0 of the row o, then the rest of
// its run (a column drawn more than once)
__device__ __forceinline__ void put(int32_t* o, long long stride, const int4& e,
                                   const int32_t* perm, uint32_t v) {
  o[(long long)e.y * stride] = (int32_t)v;
  for (int s = e.z + 1; s < e.z + e.w; ++s) o[(long long)__ldg(perm + s) * stride] = (int32_t)v;
}

template <int W>
__global__ void __launch_bounds__(kGatherThreads) gather_open_kernel(const GatherArgs a) {
  const int lane = threadIdx.x % 32;
  VC_STAMP(0);
  if ((long long)blockIdx.x < a.col_blocks) {
    const unsigned long long pol = evict_first_policy();
    if ((long long)blockIdx.x < a.mont_blocks && a.mont.limbs) {
      // limbs 2w, 2w + 1 of row r at up to 256 unique columns below off, 8
      // a lane (a warp a task): each column's plan entry (one 16-byte
      // load), then its two limbs
      const long long task = (long long)blockIdx.x * (kGatherThreads / 32) + threadIdx.x / 32;
      if (task >= a.mont_tasks) return;
      const int chunk = (int)(task % a.mont_chunks);
      const long long rest = task / a.mont_chunks;
      const long long r = rest % a.R;
      const int w = (int)(rest / a.R);
      const int i0 = chunk * 32 * kLaneCols + lane;
      int4 e[kLaneCols];
      uint32_t v[kLaneCols];
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        const int i = i0 + 32 * q;
        e[q] = i < a.u_mont ? __ldg(a.plan + i) : make_int4(-1, 0, 0, 0);
      }
      const int32_t* base = a.mont.p + r * a.mont.s_a;
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        if (e[q].x >= 0) {
          const int32_t* p = base + (long long)e[q].x * a.mont.s_b;
          v[q] = (ld_stream(p + 2 * w * a.mont.s_w, pol) & 0xFFFFu) |
                 (ld_stream(p + (2 * w + 1) * a.mont.s_w, pol) << 16);
        }
      }
      int32_t* o = a.out + ((long long)w * a.R + r) * a.k;
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q)
        if (e[q].x >= 0) put(o, 1, e[q], a.perm, v[q]);
#ifdef LCPC_VC_TRACE
      atomicMax(&vc_trace[6 * blockIdx.x + 1], vc_now());  // the block's last store
#endif
      return;
    }
    if ((long long)blockIdx.x < a.mont_blocks) {
      // packed words: a thread an element (r, unique column i), its W
      // words (lanes over neighbouring columns)
      const long long t = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
      if (t >= a.R * a.u_mont) return;
      const long long r = t / a.u_mont;
      const int4 e = __ldg(a.plan + (t - r * a.u_mont));
      const int32_t* p = a.mont.p + r * a.mont.s_a + (long long)e.x * a.mont.s_b;
      uint32_t v[W];  // plain loads: these sectors are read whole, by neighbouring lanes
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = (uint32_t)__ldg(p + w * a.mont.s_w);
#pragma unroll
      for (int w = 0; w < W; ++w) put(a.out + ((long long)w * a.R + r) * a.k, 1, e, a.perm, v[w]);
#ifdef LCPC_VC_TRACE
      atomicMax(&vc_trace[6 * blockIdx.x + 1], vc_now());
#endif
      return;
    }
    // row r's W canonical words at up to 64 unique columns >= off, 2 a
    // lane, converted to Montgomery form: x R^2 R^-1
    const long long ct = ((long long)blockIdx.x - a.mont_blocks) * (kGatherThreads / 32) +
                         threadIdx.x / 32;
    if (ct >= a.R * a.canon_chunks) return;
    const int chunk = (int)(ct % a.canon_chunks);
    const long long r = ct / a.canon_chunks;
    const int i0 = a.u_mont + chunk * 32 * kCanonCols + lane;
    int4 e[kCanonCols];
    uint32_t v[kCanonCols][W];
#pragma unroll
    for (int q = 0; q < kCanonCols; ++q) {
      const int i = i0 + 32 * q;
      e[q] = i < a.U ? __ldg(a.plan + i) : make_int4(-1, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < kCanonCols; ++q) {
      if (e[q].x >= 0) {
        const int32_t* p = a.canon + r * W * a.canon_ld + (e[q].x - a.off);
#pragma unroll
        for (int w = 0; w < W; ++w) v[q][w] = ld_stream(p + w * a.canon_ld, pol);
      }
    }
    const Field<W> f(a.consts);
    uint32_t p2[W], r2[W];
    twice<W>(p2, f.p);
#pragma unroll
    for (int w = 0; w < W; ++w) r2[w] = __ldg(a.consts + W + 1 + w);
    const long long plane = a.R * a.k;
#pragma unroll
    for (int q = 0; q < kCanonCols; ++q) {
      if (e[q].x >= 0) {
        uint32_t x[W];
        reduce<W>(v[q], f.p, p2);
        f.mul(x, v[q], r2);
        int32_t* o = a.out + r * a.k;
#pragma unroll
        for (int w = 0; w < W; ++w) put(o + w * plane, 1, e[q], a.perm, x[w]);
      }
    }
#ifdef LCPC_VC_TRACE
    atomicMax(&vc_trace[6 * blockIdx.x + 1], vc_now());
#endif
    return;
  }
  const long long e = ((long long)blockIdx.x - a.col_blocks) * kGatherThreads + threadIdx.x;
  if (e >= 8LL * a.n_nodes) return;
  const int w = (int)(e / a.n_nodes), u = (int)(e % a.n_nodes);
  a.out[(long long)W * a.R * a.k + e] = (int32_t)(uint32_t)a.hashes[w * a.hashes_ld + a.uniq[u]];
}

// verify_check's launch configuration (its cluster of `splits` blocks, its
// dynamic shared memory) for a grid of one cluster, and how many such
// clusters the card holds at once
template <int W>
cudaError_t check_config(int T, int want_cols, int splits, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr, int* clusters) {
  const size_t smem = CheckSmem<W>::bytes(T, want_cols ? W : 2 * W);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  void (*kernel)(const CheckArgs) = verify_check_kernel<W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (splits > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)splits);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a cluster's blocks on distinct SMs where they fit: a column cluster's
  // splits each get an SM's products
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cfg->attrs = attr;
  cfg->numAttrs = 2;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, cfg);
}

template <int W>
cudaError_t launch_check(const CheckArgs& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  int clusters = 0;
  cudaError_t err =
      check_config<W>(a.T, !a.want_at_idx, a.splits, &cfg, attr, &clusters);
  if (err != cudaSuccess) return err;
  // a cluster the card cannot hold is refused here, not left to the launch
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)((long long)a.groups * a.splits + a.eval_blocks));
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, verify_check_kernel<W>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_gather(const GatherArgs& a, long long blocks, cudaStream_t s) {
  gather_open_kernel<W><<<(unsigned)blocks, kGatherThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The verifier's check: T rows of ts (W, T, R) against the opened columns
// col (W, R, k) (words, int32 storage, at the strides given), each sum's
// plain value against from_mont of want: the encoded rows' limbs at (t,
// idx[j]), or with want_cols the rows at the columns, words at (t, j); the hash
// words (R W, k) written to `words`; with eval_blocks > 0 the evaluation
// sum_j pe[j] inner[j] (both (W, npr) canonical words) into state.  The
// rows of each 32-column group split over a cluster of `splits` blocks (1
// .. 16) of rows_split rows each; the eval blocks (npr > 0: at
// least one cluster) come in clusters of the same size (eval_blocks a
// multiple of splits), the clusters' residues in scratch (a cluster's W
// words).  state as
// verify_core.py lays it out.  Returns the launch's cudaError_t
// (cudaErrorInvalidConfiguration where the card cannot hold one cluster).
extern "C" int lcpc_verify_check(
    const int32_t* ts, long long ts_sw, long long ts_st, long long ts_sr,
    const int32_t* col, long long col_sw, long long col_sr, long long col_sc,
    const int32_t* want, long long want_sw, long long want_st, long long want_sc, int want_cols,
    const long long* idx, const int32_t* pe, long long pe_sw, long long pe_sj,
    const int32_t* inner, long long in_sw, long long in_sj, int T, long long R, int k,
    long long npr, int splits, long long rows_split, int eval_blocks,
    int32_t* words, int32_t* state, uint32_t* scratch, const uint32_t* consts, int w32,
    int device, void* stream) {
  const int groups = (k + kCols - 1) / kCols;
  if (ts == nullptr || col == nullptr || want == nullptr || words == nullptr ||
      state == nullptr || consts == nullptr || (!want_cols && idx == nullptr) || T < 1 ||
      R < 1 || k < 1 || splits < 1 || splits > kMaxCluster ||
      rows_split < 1 || rows_split * splits < R || eval_blocks < 0 ||
      eval_blocks % splits != 0 ||
      (npr > 0) != (eval_blocks > 0) ||
      (npr > 0 && (pe == nullptr || inner == nullptr || scratch == nullptr)) ||
      (long long)groups * splits + eval_blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CheckArgs a{View{ts, ts_sw, ts_st, ts_sr, 0},
              View{col, col_sw, col_sr, col_sc, 0},
              View{want, want_sw, want_st, want_sc, !want_cols},
              idx, !want_cols,
              View{pe, pe_sw, 0, pe_sj, 0},
              View{inner, in_sw, 0, in_sj, 0},
              T, k, groups, splits, eval_blocks, R, rows_split, npr, words, state,
              scratch, consts};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_check<2>(a, s);
    case 4: return (int)launch_check<4>(a, s);
    case 6: return (int)launch_check<6>(a, s);
    case 8: return (int)launch_check<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many verify_check clusters of `splits` blocks (T rows of ts, the
// wanted values as limbs or, with want_cols, words) the card holds at once,
// into *clusters.  Returns the query's cudaError_t.
extern "C" int lcpc_verify_check_clusters(int w32, int splits, int T, int want_cols, int device,
                                          int* clusters) {
  if (clusters == nullptr || T < 1 || splits < 1 || splits > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  switch (w32) {
    case 2: return (int)check_config<2>(T, want_cols, splits, &cfg, attr, clusters);
    case 4: return (int)check_config<4>(T, want_cols, splits, &cfg, attr, clusters);
    case 6: return (int)check_config<6>(T, want_cols, splits, &cfg, attr, clusters);
    case 8: return (int)check_config<8>(T, want_cols, splits, &cfg, attr, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The prover's opening: by the plan (for each of the U unique columns of
// idx, ascending, four int32: the column, its first slot, the start of its
// run of slots in the k that follow (the slots in column order) and the
// run's length; 16-byte aligned; the first u_mont columns below off), each
// column's R rows into every slot j that
// names it, out[:, :, j], as packed Montgomery words (W, R, k): from mont
// (element (r, c) at the strides given, limbs or words) below off, else
// from canon (R W, n - off) canonical hash words at c - off; then
// hashes[:, uniq[u]] (int64 digest words, row stride hashes_ld) into
// out[W R k + w n_nodes + u].  Returns the launch's cudaError_t.
extern "C" int lcpc_gather_open(const int32_t* plan, int k, int U, int u_mont, long long R,
                                long long off, const int32_t* mont, long long m_sw,
                                long long m_sr, long long m_sc, int m_limbs,
                                const int32_t* canon, long long canon_ld,
                                const long long* hashes, long long hashes_ld,
                                const long long* uniq, int n_nodes, int32_t* out,
                                const uint32_t* consts, int w32, int device, void* stream) {
  if (out == nullptr || consts == nullptr || k < 0 || U < 0 || U > k || u_mont < 0 ||
      ((uintptr_t)plan & 15) != 0 ||
      u_mont > U || n_nodes < 0 || R < 1 || off < 0 || (k > 0 && plan == nullptr) ||
      (u_mont > 0 && mont == nullptr) || (U > u_mont && canon == nullptr) ||
      (n_nodes > 0 && (hashes == nullptr || uniq == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int mont_chunks = (u_mont + 32 * kLaneCols - 1) / (32 * kLaneCols);
  const int canon_chunks = (U - u_mont + 32 * kCanonCols - 1) / (32 * kCanonCols);
  // limbs: a warp a (word, row, 256 columns); words: a thread an element;
  // canonical words: a warp a (row, 64 columns)
  const long long mont_tasks = (long long)w32 * R * mont_chunks;
  const long long warps_a_block = kGatherThreads / 32;
  const long long mont_blocks =
      m_limbs ? (mont_tasks + warps_a_block - 1) / warps_a_block
              : (R * u_mont + kGatherThreads - 1) / kGatherThreads;
  const long long col_blocks =
      mont_blocks + (R * canon_chunks + warps_a_block - 1) / warps_a_block;
  const long long blocks = col_blocks + (8LL * n_nodes + kGatherThreads - 1) / kGatherThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  GatherArgs a{reinterpret_cast<const int4*>(plan), plan + 4LL * U, k, U, u_mont, R, off,
               View{mont, m_sw, m_sr, m_sc, m_limbs}, canon,
               canon_ld, hashes, hashes_ld, uniq, n_nodes, mont_chunks > 0 ? mont_chunks : 1,
               canon_chunks > 0 ? canon_chunks : 1, mont_tasks, mont_blocks, col_blocks, out,
               consts};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_gather<2>(a, blocks, s);
    case 4: return (int)launch_gather<4>(a, blocks, s);
    case 6: return (int)launch_gather<6>(a, blocks, s);
    case 8: return (int)launch_gather<8>(a, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef LCPC_VC_TRACE
// The stamps of the last launches (n words) into host, then cleared.
extern "C" int lcpc_vc_trace(unsigned long long* host, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(host, vc_trace, n * sizeof(unsigned long long));
  if (e != cudaSuccess) return (int)e;
  void* p = nullptr;
  e = cudaGetSymbolAddress(&p, vc_trace);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(vc_trace));
}
#endif
