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
//   verify_check  one grid, two kinds of blocks.
//     column blocks  32 opened columns, a lane each, and 8 warps over a
//                    split of the rows (lanes: neighbouring columns, so every
//                    load and store of a warp is one run).  Each thread sums
//                    the T products ts[t, r] col[r, j] of its rows unreduced
//                    (mont.cuh's Acc) and reduces each sum once; the warps'
//                    residues meet in shared memory.  The block of the rows'
//                    last split (a counter per 32 columns) adds the splits'
//                    residues, the plain value of each sum, and compares it
//                    with from_mont of the encoded row at the column
//                    (enc_rows[:, t, idx[j]] read in place, or want[:, t, j]
//                    on the columns route): a mismatch clears flag t.  The
//                    same pass writes from_mont(col) as the columns'
//                    canonical hash words, (R W, k).
//     eval blocks    a grid-stride run over j < npr of inner[j] p_eval[j],
//                    both canonical words, summed unreduced and reduced once
//                    a thread; the last eval block to finish (a counter)
//                    adds the blocks' residues and writes the evaluation's
//                    canonical words.
//   gather_open   the opened columns as packed Montgomery words (W, R, k):
//                 column c below `off` from a Montgomery operand (the
//                 committed codeword's limbs, or packed words, read in
//                 place), the rest from the kept canonical hash words at c -
//                 off, converted to Montgomery form; then the unique path
//                 nodes (8, U) of the Merkle array, one buffer for one copy
//                 to the host.
//
// state, the verifier's output (int32, set by the caller before the launch:
// one host-to-device copy with the inputs): T row flags (1), the path flag
// (1; cleared by the walk), the evaluation's W words (0), the eval counter
// (0) and one counter per 32 opened columns (0); the block that finds a
// counter full resets it, so a state serves launch after launch (timing).
//
// What bounds them on an H100: verify_check its bytes (the opened columns,
// the proof rows read once) or its wide products (T R k W^2 + npr W^2), a
// few microseconds at every shape of the paths, against tens of launches
// and host syncs it replaces; gather_open its bytes, scattered reads of the
// opened columns' words.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"

using namespace lcpc;

namespace {

constexpr int kCols = 32;   // opened columns a column block, a lane each
constexpr int kWarps = 8;   // warps a block, over the rows (column blocks) or j (eval blocks)
constexpr int kThreads = 32 * kWarps;
constexpr int kAccWords = 16;  // accumulator rows a thread keeps: T is taken kAccWords / W at a time
constexpr int kGatherThreads = 256;

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
  if (v.limbs) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      x[w] = ((uint32_t)__ldg(q + 2 * w * v.s_w) & 0xFFFFu) |
             ((uint32_t)__ldg(q + (2 * w + 1) * v.s_w) << 16);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = (uint32_t)__ldg(q + w * v.s_w);
  }
}

struct CheckArgs {
  View ts;                // (W, T, R) words: element (t, r), Montgomery
  View col;               // (W, R, k) words: element (r, j), Montgomery, any value < R
  View want;              // element (t, idx[j]) of the encoded rows, or (t, j)
  const long long* idx;   // (k,) the opened columns
  int want_at_idx;
  View pe, inner;         // (W, npr) canonical words: element (0, j)
  int T, k, groups, splits, eval_blocks;
  long long R, rows_split, npr;
  int32_t* words;         // (R W, k) canonical hash words
  int32_t* state;
  uint32_t* scratch;      // the splits' residues, then the eval blocks'
  const uint32_t* consts; // p | n0 | R^2 mod p | R mod p
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

template <int W>
__global__ void __launch_bounds__(kThreads) verify_check_kernel(const CheckArgs a) {
  constexpr int kMaxT = kAccWords / W;
  __shared__ uint32_t red[kMaxT][kWarps][W][kCols];
  __shared__ bool last;
  const Field<W> f(a.consts);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t p2[W];
  twice<W>(p2, f.p);
  unsigned* counters = reinterpret_cast<unsigned*>(a.state + a.T + 1 + W);
  const int n_col_blocks = a.groups * a.splits;

  if ((int)blockIdx.x < n_col_blocks) {
    const int g = blockIdx.x / a.splits, y = blockIdx.x % a.splits;
    const int j_at = g * kCols + lane;
    const bool live = j_at < a.k;
    const int j = live ? j_at : a.k - 1;  // past the edge: a valid column, no store
    const long long r0 = y * a.rows_split;
    const long long r1 = r0 + a.rows_split < a.R ? r0 + a.rows_split : a.R;
    // the plain value of sum_r ts[t, r] col[r, j] against from_mont of the
    // encoded row at the column: a mismatch clears flag t
    auto check = [&](int t, const uint32_t (&got)[W]) {
      if (!live) return;
      uint32_t v[W], z[W];
      load<W>(v, a.want, t, a.want_at_idx ? a.idx[j] : j);
      reduce<W>(v, f.p, p2);
      f.from_mont(z, v);
      bool eq = true;
#pragma unroll
      for (int w = 0; w < W; ++w) eq &= z[w] == got[w];
      if (!eq) a.state[t] = 0;
    };
    uint32_t* part = a.scratch + (size_t)g * a.T * a.splits * W * kCols;
    for (int t0 = 0; t0 < a.T; t0 += kMaxT) {
      Acc<W> acc[kMaxT];
#pragma unroll
      for (int u = 0; u < kMaxT; ++u) acc[u].zero();
      for (long long r = r0 + warp; r < r1; r += kWarps) {
        uint32_t x[W];
        load<W>(x, a.col, r, j);
        if (t0 == 0 && live) {  // the column's canonical hash words
          uint32_t xr[W], z[W];
#pragma unroll
          for (int w = 0; w < W; ++w) xr[w] = x[w];
          reduce<W>(xr, f.p, p2);
          f.from_mont(z, xr);
#pragma unroll
          for (int w = 0; w < W; ++w) a.words[(r * W + w) * a.k + j] = (int32_t)z[w];
        }
#pragma unroll
        for (int u = 0; u < kMaxT; ++u) {
          if (t0 + u < a.T) {
            uint32_t s[W];
            load<W>(s, a.ts, t0 + u, r);
            acc[u].mac(s, x);
          }
        }
      }
      // each sum S (< R_rows R^2) reduced once: S R^-2, the plain value
#pragma unroll
      for (int u = 0; u < kMaxT; ++u) {
        if (t0 + u < a.T) {
          uint32_t res[W];
          finish<W>(res, acc[u], f, a.consts, false);
#pragma unroll
          for (int w = 0; w < W; ++w) red[u][warp][w][lane] = res[w];
        }
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int u = 0; u < kMaxT; ++u) {
          const int t = t0 + u;
          if (t >= a.T) break;
          uint32_t s[W];
#pragma unroll
          for (int w = 0; w < W; ++w) s[w] = red[u][0][w][lane];
#pragma unroll
          for (int v = 1; v < kWarps; ++v) {
            uint32_t o[W];
#pragma unroll
            for (int w = 0; w < W; ++w) o[w] = red[u][v][w][lane];
            f.add(s, s, o);
          }
          if (a.splits == 1) {
            check(t, s);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w)
              part[(((size_t)t * a.splits + y) * W + w) * kCols + lane] = s[w];
          }
        }
      }
      __syncthreads();  // red is reused by the next t
    }
    if (a.splits == 1) return;
    __threadfence();  // this block's residues are visible before its count is
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counters + 1 + g, 1u) == (unsigned)a.splits - 1;
    __syncthreads();
    if (!last || warp != 0) return;
    __threadfence();
    if (lane == 0) counters[1 + g] = 0u;  // ready for the next launch with this state
    for (int t = 0; t < a.T; ++t) {
      uint32_t s[W] = {};
      for (int v = 0; v < a.splits; ++v) {
        uint32_t o[W];
#pragma unroll
        for (int w = 0; w < W; ++w)
          o[w] = __ldcg(part + (((size_t)t * a.splits + v) * W + w) * kCols + lane);
        f.add(s, s, o);
      }
      check(t, s);
    }
    return;
  }

  // an eval block: sum_j inner[j] p_eval[j] over its share of j
  const int e = blockIdx.x - n_col_blocks;
  Acc<W> acc;
  acc.zero();
  const long long step = (long long)a.eval_blocks * kThreads;
  for (long long jj = (long long)e * kThreads + threadIdx.x; jj < a.npr; jj += step) {
    uint32_t x[W], z[W];
    load<W>(x, a.pe, 0, jj);
    load<W>(z, a.inner, 0, jj);
    acc.mac(x, z);
  }
  uint32_t s[W];
  finish<W>(s, acc, f, a.consts, false);  // S R^-2 of this thread's sum S
#pragma unroll
  for (int w = 0; w < W; ++w) red[0][warp][w][lane] = s[w];
  __syncthreads();
  uint32_t* eparts = a.scratch + (size_t)a.groups * a.T * (a.splits > 1 ? a.splits : 0) * W * kCols;
  if (warp == 0) {
#pragma unroll
    for (int v = 1; v < kWarps; ++v) {
      uint32_t o[W];
#pragma unroll
      for (int w = 0; w < W; ++w) o[w] = red[0][v][w][lane];
      f.add(s, s, o);
    }
    warp_sum<W>(s, f);
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) eparts[(size_t)e * W + w] = s[w];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters, 1u) == (unsigned)a.eval_blocks - 1;
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();
  if (lane == 0) counters[0] = 0u;  // ready for the next launch with this state
  uint32_t t[W] = {};
  for (int v = lane; v < a.eval_blocks; v += 32) {
    uint32_t o[W];
#pragma unroll
    for (int w = 0; w < W; ++w) o[w] = __ldcg(eparts + (size_t)v * W + w);
    f.add(t, t, o);
  }
  warp_sum<W>(t, f);
  if (lane != 0) return;
  // S R^-2 -> S: two Montgomery products by R^2 mod p, each a factor R
  uint32_t r2[W], u[W];
#pragma unroll
  for (int w = 0; w < W; ++w) r2[w] = __ldg(a.consts + W + 1 + w);
  f.mul(u, t, r2);
  f.mul(t, u, r2);
#pragma unroll
  for (int w = 0; w < W; ++w) a.state[a.T + 1 + w] = (int32_t)t[w];
}

struct GatherArgs {
  const long long* idx;   // (k,) the opened columns
  int k, U;
  long long R, off;
  View mont;              // element (r, c), c < off: packed words out as they are
  const int32_t* canon;   // (R W, n - off) canonical hash words: c >= off, at c - off
  long long canon_ld;
  const long long* hashes;  // (8, nodes) int64 digest words
  long long hashes_ld;
  const long long* uniq;  // (U,) node indices
  long long col_blocks;
  int32_t* out;           // (W, R, k) words, then (8, U)
  const uint32_t* consts;
};

template <int W>
__global__ void __launch_bounds__(kGatherThreads) gather_open_kernel(const GatherArgs a) {
  if ((long long)blockIdx.x < a.col_blocks) {
    const long long e = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
    if (e >= a.R * a.k) return;
    const long long r = e / a.k;
    const int j = (int)(e - r * a.k);
    const long long c = a.idx[j];
    uint32_t x[W];
    if (c < a.off) {
      load<W>(x, a.mont, r, c);
    } else {  // canonical -> Montgomery: x R^2 R^-1
      const Field<W> f(a.consts);
      uint32_t p2[W], r2[W], v[W];
      twice<W>(p2, f.p);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        v[w] = (uint32_t)__ldg(a.canon + (r * W + w) * a.canon_ld + (c - a.off));
        r2[w] = __ldg(a.consts + W + 1 + w);
      }
      reduce<W>(v, f.p, p2);
      f.mul(x, v, r2);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) a.out[(w * a.R + r) * a.k + j] = (int32_t)x[w];
    return;
  }
  const long long e = ((long long)blockIdx.x - a.col_blocks) * kGatherThreads + threadIdx.x;
  if (e >= 8LL * a.U) return;
  const int w = (int)(e / a.U), u = (int)(e % a.U);
  a.out[(long long)W * a.R * a.k + e] = (int32_t)(uint32_t)a.hashes[w * a.hashes_ld + a.uniq[u]];
}

template <int W>
cudaError_t launch_check(const CheckArgs& a, cudaStream_t s) {
  const long long blocks = (long long)a.groups * a.splits + a.eval_blocks;
  verify_check_kernel<W><<<(unsigned)blocks, kThreads, 0, s>>>(a);
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
// rows split `splits` ways (rows_split rows each), 32 columns a group.
// state and scratch as verify_core.py lays them out.  Returns the launch's
// cudaError_t.
extern "C" int lcpc_verify_check(
    const int32_t* ts, long long ts_sw, long long ts_st, long long ts_sr,
    const int32_t* col, long long col_sw, long long col_sr, long long col_sc,
    const int32_t* want, long long want_sw, long long want_st, long long want_sc, int want_cols,
    const long long* idx, const int32_t* pe, long long pe_sw, long long pe_sj,
    const int32_t* inner, long long in_sw, long long in_sj, int T, long long R, int k,
    long long npr, int splits, long long rows_split, int eval_blocks, int32_t* words,
    int32_t* state, uint32_t* scratch, const uint32_t* consts, int w32, int device,
    void* stream) {
  const int groups = (k + kCols - 1) / kCols;
  if (ts == nullptr || col == nullptr || want == nullptr || words == nullptr ||
      state == nullptr || consts == nullptr || (!want_cols && idx == nullptr) || T < 1 ||
      R < 1 || k < 1 || splits < 1 || rows_split < 1 || rows_split * splits < R ||
      eval_blocks < 0 || (eval_blocks > 0 && (pe == nullptr || inner == nullptr || npr < 1)) ||
      ((splits > 1 || eval_blocks > 0) && scratch == nullptr) ||
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
              T, k, groups, splits, eval_blocks, R, rows_split, npr, words, state, scratch,
              consts};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_check<2>(a, s);
    case 4: return (int)launch_check<4>(a, s);
    case 6: return (int)launch_check<6>(a, s);
    case 8: return (int)launch_check<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The prover's opening: column idx[j] of R rows into out[:, :, j] as packed
// Montgomery words (W, R, k), from mont (element (r, c) at the strides
// given, limbs or words) for idx[j] < off, else from canon (R W, n - off)
// canonical hash words at idx[j] - off; then hashes[:, uniq[u]] (int64
// digest words, row stride hashes_ld) into out[W R k + w U + u].  Returns the
// launch's cudaError_t.
extern "C" int lcpc_gather_open(const long long* idx, int k, long long R, long long off,
                                const int32_t* mont, long long m_sw, long long m_sr,
                                long long m_sc, int m_limbs, const int32_t* canon,
                                long long canon_ld, const long long* hashes, long long hashes_ld,
                                const long long* uniq, int U, int32_t* out,
                                const uint32_t* consts, int w32, int device, void* stream) {
  if (out == nullptr || consts == nullptr || k < 0 || U < 0 || R < 1 || off < 0 ||
      (k > 0 && idx == nullptr) || (k > 0 && off > 0 && mont == nullptr) ||
      (U > 0 && (hashes == nullptr || uniq == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long col_blocks = (R * k + kGatherThreads - 1) / kGatherThreads;
  const long long blocks = col_blocks + (8LL * U + kGatherThreads - 1) / kGatherThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  GatherArgs a{idx, k, U, R, off, View{mont, m_sw, m_sr, m_sc, m_limbs}, canon, canon_ld,
               hashes, hashes_ld, uniq, col_blocks, out, consts};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_gather<2>(a, blocks, s);
    case 4: return (int)launch_gather<4>(a, blocks, s);
    case 6: return (int)launch_gather<6>(a, blocks, s);
    case 8: return (int)launch_gather<8>(a, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
