// The small commit as one persistent kernel launch: a (2W, length) limb
// vector to its padded coefficient matrix, its codeword and its whole Merkle
// array, for the Ligero (NTT) and the Brakedown CODE3 (expander) encodings,
// under BLAKE3 or SHA-256.
//
// Replaces lcpc_tpu's `_commit_fused_fn` (lcpc_tpu/core/protocol.py:345, an
// XLA-fused jit over pad, encode, pack, column hash and every Merkle layer;
// not a Pallas kernel): one dispatch from a shape's first commit.  The
// launch writes the commit's own freshly allocated tensors; nothing is
// captured, copied or cached between commits.
//
// One cooperative launch (cudaLaunchCooperativeKernel), its grid the blocks
// the work keeps busy, capped by the occupancy API on this kernel so that
// every block is resident; each phase
// loops its tiles, outputs or columns over the grid, and the phases meet at
// grid barriers (cooperative_groups' grid sync, which also orders their
// memory).  Intermediates live in one scratch tensor of the wrapper's
// (ops/commit_small.py): at these sizes it stays in L2.  Data an earlier
// phase wrote is read at L2 (ldst.cuh's LoadCg), never through the
// non-coherent read-only cache.
//
//   Ligero   the NTT passes of ops/commit_small.py's fused_passes (plan_passes
//            with tiles of 2^9 elements, a butterfly a thread a stage):
//            ntt.cuh's forward_tile,
//            the first pass reading the limbs in place (zeros past `length`)
//            and writing the padded matrix when the last row is short, the
//            last storing the codeword's limbs and its canonical hash words;
//            a barrier between passes.
//   Brakedown  the coefficients packed into the (positions, R, W) word buffer
//            of encodings/brakedown.py's encode_rows as index arithmetic
//            (the systematic part's limbs and hash words stored on the way),
//            then every level of the code's level table (the precodes, the
//            Reed-Solomon base case, the postcodes; built once an encoding
//            by SdigEncoding.device_tables) with spmv.cuh's row body, each
//            output's store also writing its codeword limbs and hash words;
//            a barrier between levels.
//   hash     BLAKE3: blake3.cuh's chunk body a (column, chunk), then, for
//            columns of more than one chunk, BLAKE3's CV stack a column (in
//            local memory) after a barrier; SHA-256: sha256.cuh's column body
//            a column.  The digests go to a leaf array.
//   tree     merkle.cuh's subtrees in shared memory (as many as blocks, of at
//            most 1,024 leaves), then, after a barrier, the levels above
//            their roots by block 0 (the barrier takes the place of
//            merkle_tree_kernel's self-resetting last-block counter).
//
// What bounds it on an H100: at these sizes the dependent chains, not the
// card's rates.  A Ligero 2^13 commit (8 x 4,096) is 12 stages of Montgomery
// butterflies in 2 passes (a stage about one product's chain, ~1.5 us at
// W = 8 with its shared-memory round trip and barrier), 5 chained
// compressions a column and a 12-level tree (a level about one
// compression's latency, 0.72 us), with 4 grid barriers of ~1 us; its
// operations at the card's rates take ~4 us (PERF.md §6).  The design
// removes what the staged route spent beyond that: a launch, a wrapper and
// a Python frame a stage (4 Ligero, 12-17 Brakedown with torch's packing).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "blake3.cuh"
#include "ldst.cuh"
#include "merkle.cuh"
#include "mont.cuh"
#include "ntt.cuh"
#include "sha256.cuh"
#include "spmv.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = merkle::kTreeThreads;  // 256: a subtree's block
constexpr int kMaxPasses = 4;
constexpr int kMaxStack = 16;  // the chunk tree's CV stack: columns of at most 2^16 chunks
constexpr size_t kTreeSmem = sizeof(uint32_t) * 8 * merkle::kTreeNodes;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// The column hash and the Merkle tree, what both encodings end with.
struct HashArgs {
  int32_t* words;      // (L, n_cols) canonical hash words
  uint32_t* cvs;       // (n_chunks, 8, n_cols) chunk CVs (BLAKE3, n_chunks > 1)
  long long* leaves;   // (8, n_cols) column digests
  long long* flat;     // (8, 2 np2 - 1) the Merkle array, leaves first
  long long L;         // words a column
  long long np2;       // leaves, padded to a power of two
  int n_cols;
  int n_chunks;        // BLAKE3 chunks a column, the 8-word prefix included
  int final_len;       // words of a column's last chunk
  int log_sub;         // subtrees of 2^log_sub leaves (set_subtrees)
};

struct LigeroArgs {
  const int32_t* arr;  // (2W, length) limbs
  int32_t* mat;        // (2W, R, k): the padded matrix, or null (no padding)
  int32_t* comm;       // (2W, R, n) codeword limbs
  uint32_t* buf;       // (R, n, W) between passes
  const uint32_t* tw;  // (n - 1, W) twiddles
  const uint32_t* consts;
  long long length;
  int R, log_n, k, n_passes;
  int hi[kMaxPasses], lo[kMaxPasses], log_t[kMaxPasses];
  HashArgs h;
};

// One level of the code (encodings/brakedown.py: SdigEncoding.device_tables,
// int64 slots): input and output positions in the word buffer, outputs,
// nonzeros, whether its outputs are codeword columns, and its CSR and
// constant block (spmv.cuh) on the card.
struct Level {
  long long in_pos, out_pos, n_out, nnz, codeword;
  const int32_t* row_ptr;
  const int32_t* cols;
  const int32_t* vals;
  const uint32_t* consts;
};

struct SdigArgs {
  const int32_t* arr;  // (2W, length) limbs
  int32_t* mat;        // (2W, R, k) or null
  int32_t* comm;       // (2W, R, n) codeword limbs
  int32_t* buf;        // (positions, R, W): the codeword, then the last precode's output
  const Level* levels;
  long long length;
  int n_levels, R, k, n;
  HashArgs h;
};

// a grid barrier: every block's work before it is done and visible after it
__device__ __forceinline__ void sync_phase(cg::grid_group& grid) { grid.sync(); }

// Thread t of the grid in warp-cyclic order: warp w of block b is warp w
// gridDim + b, so a loop over fewer threads than the grid spreads its warps
// over every block (and SM) instead of filling the first blocks; the lanes
// of a warp stay adjacent (coalesced loads, spmv.cuh's lane groups).
__device__ __forceinline__ long long grid_tid() {
  return ((long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 + (threadIdx.x & 31);
}
__device__ __forceinline__ long long grid_threads() { return (long long)gridDim.x * blockDim.x; }

// codeword column col of row r: v's limbs into comm (2W, R, n) and the
// canonical words of u (v, or v reduced below p) into words (R W, n)
template <int W>
__device__ __forceinline__ void store_column(int32_t* comm, int32_t* words,
                                             const lcpc::Field<W>& f, const uint32_t (&v)[W],
                                             const uint32_t (&u)[W], int R, long long n, int r,
                                             long long col) {
  const size_t plane = (size_t)R * n;
  int32_t* dst = comm + (size_t)r * n + col;
  uint32_t c[W];
  f.from_mont(c, u);
#pragma unroll
  for (int q = 0; q < W; ++q) {
    dst[(2 * q) * plane] = (int32_t)(v[q] & 0xFFFFu);
    dst[(2 * q + 1) * plane] = (int32_t)(v[q] >> 16);
    words[((size_t)r * W + q) * n + col] = (int32_t)c[q];
  }
}

// ---- Ligero: one NTT pass, its tiles over the grid -------------------------

template <int W>
__device__ __noinline__ void ligero_pass(const LigeroArgs& a, int p, uint32_t* s) {
  const bool first = p == 0, last = p == a.n_passes - 1;
  const int hi = a.hi[p], lo = a.lo[p], log_t = a.log_t[p];
  const long long tiles = (long long)a.R << (a.log_n - (hi - lo + 1 + log_t));
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    ntt::forward_tile<W>(b, first ? a.arr : nullptr, a.length, a.length,
                         first ? a.mat : nullptr, first ? nullptr : a.buf,
                         last ? nullptr : a.buf, last ? a.comm : nullptr,
                         last ? a.h.words : nullptr, a.tw, a.consts, a.R, a.log_n, a.k, hi, lo,
                         log_t, s);
    __syncthreads();  // s is read to the end of the tile
  }
}

// ---- Brakedown: the pack, then one level ------------------------------------

// coefficient t = r k + i (zero past length) -> buffer position i, row r;
// its limbs (and the padded matrix) and hash words stored on the way
template <int W>
__device__ __noinline__ void sdig_pack(const SdigArgs& a) {
  const lcpc::Field<W> f(a.levels[0].consts);
  uint32_t p2[W];
  lcpc::twice<W>(p2, f.p);
  const long long total = (long long)a.R * a.k;
  for (long long t = grid_tid(); t < total; t += grid_threads()) {
    const int r = (int)(t / a.k);
    const long long i = t - (long long)r * a.k;
    uint32_t v[W], u[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      uint32_t l0 = 0, l1 = 0;
      if (t < a.length) {
        l0 = (uint32_t)__ldg(a.arr + (2 * q) * a.length + t);
        l1 = (uint32_t)__ldg(a.arr + (2 * q + 1) * a.length + t);
      }
      if (a.mat != nullptr) {
        a.mat[(2 * q) * total + t] = (int32_t)l0;
        a.mat[(2 * q + 1) * total + t] = (int32_t)l1;
      }
      v[q] = u[q] = l0 | (l1 << 16);
    }
    spmv::store_words<W>(a.buf + ((size_t)i * a.R + r) * W, v);
    lcpc::reduce<W>(u, f.p, p2);  // the hash words of any limbs below R, as mont_map's
    store_column<W>(a.comm, a.h.words, f, v, u, a.R, a.n, r, i);
  }
}

// one level: spmv.cuh's row body over every (output, row), 2^log_s lanes
// an output (ops/spmv.py's split_lanes, the grid's threads as its wave);
// every warp runs the same trips (the loop's bound is a multiple of 32)
template <int W>
__device__ __noinline__ void sdig_level(const SdigArgs& a, int l) {
  const Level lv = a.levels[l];
  const long long R = a.R;
  const long long pairs = lv.n_out * R, wave = grid_threads();
  const long long rows = lv.n_out > 1 ? lv.n_out : 1;
  int log_s = 0;
  while (log_s < 5 && (pairs << log_s) < 2 * wave &&
         ((8LL << log_s) * rows <= lv.nnz ||
          ((2 * pairs << log_s) <= wave && (2LL << log_s) * rows <= lv.nnz)))
    ++log_s;
  const long long trips = ((pairs << log_s) + 31) & ~31LL;
  const int32_t* x = a.buf + lv.in_pos * R * W;
  const lcpc::Field<W> f(lv.consts);
  for (long long t = grid_tid(); t < trips; t += grid_threads()) {
    int c, r;
    uint32_t res[W];
    if (spmv::row_product<W, lcpc::LoadCg>(t, x, lv.row_ptr, lv.cols, lv.vals, lv.consts,
                                           (int)lv.n_out, (int)R, log_s, c, r, res)) {
      const long long pos = lv.out_pos + c;
      spmv::store_words<W>(a.buf + ((size_t)pos * R + r) * W, res);
      if (lv.codeword) store_column<W>(a.comm, a.h.words, f, res, res, (int)R, a.n, r, pos);
    }
  }
}

// ---- the column hash ------------------------------------------------------

// BLAKE3: a thread a (column, chunk): the chunk's CV, or, for a column of
// one chunk, its digest
__device__ __noinline__ void b3_chunks(const HashArgs& h) {
  const long long total = (long long)h.n_cols * h.n_chunks;
  for (long long t = grid_tid(); t < total; t += grid_threads()) {
    const int j = (int)(t / h.n_cols);
    const int c = (int)(t - (long long)j * h.n_cols);
    const int len = j == h.n_chunks - 1 ? h.final_len : b3::kChunkWords;
    uint32_t cv[8];
    b3::chunk_cv<lcpc::LoadCg>(cv, reinterpret_cast<const uint32_t*>(h.words), nullptr,
                               b3::kPrefixWords, h.n_cols, c, (long long)j * b3::kChunkWords,
                               len, (unsigned long long)j, h.n_chunks == 1);
    if (h.n_chunks == 1) {
#pragma unroll
      for (int w = 0; w < 8; ++w) h.leaves[(size_t)w * h.n_cols + c] = cv[w];
    } else {
#pragma unroll
      for (int w = 0; w < 8; ++w) h.cvs[((size_t)j * 8 + w) * h.n_cols + c] = cv[w];
    }
  }
}

// BLAKE3's chunk tree a column: chunk i < n - 1 pushed after merging it
// with the stack top while i + 1 has a trailing zero bit, then the last
// folded in top down, ROOT on the last merge (blake3_cols.cu's
// chunk_tree_stack_kernel, its stack in local memory)
__device__ __noinline__ void b3_merge(const HashArgs& h) {
  const int n = h.n_chunks;
  for (long long c = grid_tid(); c < h.n_cols; c += grid_threads()) {
    uint32_t stack[kMaxStack][8], cv[8], l[8];
    int top = 0;
    for (int i = 0;; ++i) {
#pragma unroll
      for (int w = 0; w < 8; ++w) cv[w] = __ldcg(h.cvs + ((size_t)i * 8 + w) * h.n_cols + c);
      if (i == n - 1) break;
      for (unsigned total = i + 1; (total & 1u) == 0; total >>= 1) {
        --top;
#pragma unroll
        for (int w = 0; w < 8; ++w) l[w] = stack[top][w];
        b3::parent_cv(cv, l, cv, b3::PARENT);
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) stack[top][w] = cv[w];
      ++top;
    }
    while (top > 0) {
      --top;
#pragma unroll
      for (int w = 0; w < 8; ++w) l[w] = stack[top][w];
      b3::parent_cv(cv, l, cv, b3::PARENT | (top == 0 ? b3::ROOT : 0u));
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) h.leaves[(size_t)w * h.n_cols + c] = cv[w];
  }
}

// SHA-256: a thread a column, sha256.cuh's column body (the wide kernel's)
__device__ __noinline__ void sha_columns(const HashArgs& h) {
  const unsigned long long bits = (unsigned long long)(b3::kPrefixWords + h.L) * 32ull;
  for (long long c = grid_tid(); c < h.n_cols; c += grid_threads())
    sha256::hash_column<int32_t, true, lcpc::LoadCg>((int)c, h.words, h.n_cols, h.L, h.n_cols,
                                                    nullptr, b3::kPrefixWords, nullptr, bits,
                                                    h.leaves);
}

struct Blake3Digest {
  using Merkle = b3::Blake3Merkle;
  static constexpr bool kChunks = true;  // a thread a (column, chunk)
  static __device__ __forceinline__ void columns(const HashArgs& h, cg::grid_group& grid) {
    b3_chunks(h);
    if (h.n_chunks > 1) {
      sync_phase(grid);
      b3_merge(h);
    }
  }
};

struct Sha256Digest {
  using Merkle = sha256::Sha256TreeMerkle;
  static constexpr bool kChunks = false;  // a thread a column
  static __device__ __forceinline__ void columns(const HashArgs& h, cg::grid_group&) {
    sha_columns(h);
  }
};

// ---- the Merkle tree --------------------------------------------------------

template <class Hash>
__device__ __noinline__ void tree_subtrees(const HashArgs& h, uint32_t (*s)[merkle::kTreeNodes]) {
  if (h.np2 == 1) {  // the leaf is the root
    if (blockIdx.x == 0 && threadIdx.x < 8)
      h.flat[threadIdx.x] = (uint32_t)__ldcg(h.leaves + threadIdx.x);
    return;
  }
  const long long n_sub = h.np2 >> h.log_sub;
  for (long long b = blockIdx.x; b < n_sub; b += gridDim.x) {
    merkle::build_subtree<Hash, lcpc::LoadCg>(b, h.leaves, h.n_cols, h.n_cols, h.np2,
                                              h.log_sub, h.flat, s);
    __syncthreads();  // s is read to the end of the subtree
  }
}

template <class Hash>
__device__ __noinline__ void tree_top(const HashArgs& h, uint32_t (*s)[merkle::kTreeNodes]) {
  if (blockIdx.x == 0) merkle::build_top<Hash>(h.np2 >> h.log_sub, h.log_sub, h.np2, h.flat, s);
}

// the column hash, then the tree
template <class D>
__device__ __forceinline__ void hash_and_tree(const HashArgs& h, uint32_t* smem,
                                              cg::grid_group& grid) {
  D::columns(h, grid);
  sync_phase(grid);
  auto* s = reinterpret_cast<uint32_t (*)[merkle::kTreeNodes]>(smem);
  tree_subtrees<typename D::Merkle>(h, s);
  if (h.np2 > 1 && (h.np2 >> h.log_sub) > 1) {
    sync_phase(grid);
    tree_top<typename D::Merkle>(h, s);
  }
}

// ---- the kernels --------------------------------------------------------------

template <int W, class D>
__global__ void __launch_bounds__(kThreads) commit_ligero_kernel(const __grid_constant__ LigeroArgs a) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  for (int p = 0; p < a.n_passes; ++p) {
    ligero_pass<W>(a, p, s);
    sync_phase(grid);
  }
  hash_and_tree<D>(a.h, s, grid);
}

template <int W, class D>
__global__ void __launch_bounds__(kThreads) commit_sdig_kernel(const __grid_constant__ SdigArgs a) {
  extern __shared__ uint4 smem_raw[];
  cg::grid_group grid = cg::this_grid();
  sdig_pack<W>(a);
  sync_phase(grid);
  for (int l = 0; l < a.n_levels; ++l) {
    sdig_level<W>(a, l);
    sync_phase(grid);
  }
  hash_and_tree<D>(a.h, reinterpret_cast<uint32_t*>(smem_raw), grid);
}

// What a kernel's launches keep: its dynamic shared memory cap as set, and
// its resident blocks an SM at the last size asked.
struct LaunchCache {
  size_t smem_set = 48 * 1024;  // the default dynamic shared memory cap
  size_t occ_smem = 0;
  int occ_blocks = 0;
};

// The grid of a cooperative launch of `kern`: min(want, the blocks that fit
// on the device at once: the occupancy API at kThreads and `smem` bytes of
// dynamic shared memory).  A block without work still waits at every
// barrier, polling, and takes issue slots from a working block on its SM:
// the grid is sized to the work.
template <class Args>
int grid_size(void (*kern)(Args), LaunchCache& cache, size_t smem, long long want, int device,
              long long& grid) {
  cudaError_t err;
  if (smem > cache.smem_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cache.smem_set = smem;
  }
  if (cache.occ_blocks == 0 || cache.occ_smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache.occ_blocks, kern, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    cache.occ_smem = smem;
  }
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long fit = (long long)cache.occ_blocks * n_sm;
  grid = want < fit ? want : fit;
  return grid < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

template <class Args>
int launch_coop(void (*kern)(Args), const Args& args, long long grid, size_t smem,
                cudaStream_t stream) {
  void* params[] = {const_cast<Args*>(&args)};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)grid),
                                          dim3(kThreads), params, smem, stream);
}

// Subtrees of 2^log_sub leaves, as few leaves as leave no more subtrees
// than blocks (at most kTreeLeaves): each level below the subtree roots
// then runs on as many SMs as the grid has, and the levels above them in
// block 0 after the barrier; the tree's depth is the same either way.
void set_subtrees(HashArgs& h, long long grid) {
  int log_np2 = 0;
  while ((1LL << log_np2) < h.np2) ++log_np2;
  int s = log_np2 < 1 ? log_np2 : 1;
  while ((1 << s) < merkle::kTreeLeaves && s < log_np2 && (h.np2 >> s) > grid) ++s;
  h.log_sub = s;
}

// fill the hash and tree fields from the shape; false if out of range
bool hash_shape(HashArgs& h, int32_t* words, uint32_t* cvs, long long* leaves, long long* flat,
                long long L, int n_cols, bool sha) {
  if (n_cols < 1 || L < 1 || words == nullptr || leaves == nullptr || flat == nullptr)
    return false;
  const long long total = b3::kPrefixWords + L;
  const long long n_chunks = (total + b3::kChunkWords - 1) / b3::kChunkWords;
  if (n_chunks > (1LL << kMaxStack) || (!sha && n_chunks > 1 && cvs == nullptr)) return false;
  long long np2 = 1;
  while (np2 < n_cols) np2 <<= 1;
  h.words = words;
  h.cvs = cvs;
  h.leaves = leaves;
  h.flat = flat;
  h.L = L;
  h.np2 = np2;
  h.n_cols = n_cols;
  h.n_chunks = (int)n_chunks;
  h.final_len = (int)(total - (long long)b3::kChunkWords * (n_chunks - 1));
  h.log_sub = 0;  // set_subtrees, once the grid is known
  return true;
}

long long blocks_for(long long threads, int per_block) {
  return (threads + per_block - 1) / per_block;
}

long long max_ll(long long a, long long b) { return a > b ? a : b; }

// the blocks the column hash keeps busy: two warps a block for its threads
// (a (column, chunk) each for BLAKE3, a column for SHA-256)
template <class D>
long long hash_blocks(const HashArgs& h) {
  return blocks_for((long long)h.n_cols * (D::kChunks ? h.n_chunks : 1), 64);
}

template <int W, class D>
int run_ligero(LigeroArgs a, int device, cudaStream_t stream) {
  size_t smem = kTreeSmem;
  long long want = hash_blocks<D>(a.h);  // and a block a tile
  for (int p = 0; p < a.n_passes; ++p) {
    const int log_tile = a.hi[p] - a.lo[p] + 1 + a.log_t[p];
    const size_t tile = (sizeof(uint32_t) * W) << log_tile;
    if (tile > smem) smem = tile;
    want = max_ll(want, (long long)a.R << (a.log_n - log_tile));
  }
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static LaunchCache cache;
  long long grid = 0;
  const int err = grid_size(commit_ligero_kernel<W, D>, cache, smem, want, device, grid);
  if (err != 0) return err;
  set_subtrees(a.h, grid);
  return launch_coop(commit_ligero_kernel<W, D>, a, grid, smem, stream);
}

// max_out: the widest level's outputs, at up to 8 lanes each
template <int W, class D>
int run_sdig(SdigArgs a, long long max_out, int device, cudaStream_t stream) {
  const long long want = max_ll(max_ll(blocks_for((long long)a.R * a.k, kThreads),
                                       blocks_for(8 * max_out * a.R, kThreads)),
                                hash_blocks<D>(a.h));
  static LaunchCache cache;
  long long grid = 0;
  const int err = grid_size(commit_sdig_kernel<W, D>, cache, kTreeSmem, want, device, grid);
  if (err != 0) return err;
  set_subtrees(a.h, grid);
  return launch_coop(commit_sdig_kernel<W, D>, a, grid, kTreeSmem, stream);
}

// the rows of a commit of `length` coefficients, k a row: R k >= length > (R - 1) k
bool rows_ok(long long length, int R, int k) {
  return length >= 1 && R >= 1 && k >= 1 && (long long)R * k >= length &&
         (long long)(R - 1) * k < length && (long long)R * k < (1LL << 31);
}

}  // namespace

// One Ligero commit, one launch on `stream` of CUDA device `device`:
// arr (2 w32, length) Montgomery limbs, k coefficients a row (R rows) ->
// mat (2 w32, R, k), the padded matrix (null when R k = length), comm
// (2 w32, R, 2^log_n) codeword limbs and flat (8, 2 np2 - 1) int64, the
// Merkle array of the column digests (sha = 0 BLAKE3, 1 SHA-256).  The
// NTT's passes are `passes` (hi, lo, log_t each, n_passes of them, the
// ladder's order: ops/ntt.py plan_passes); tw and consts its table
// (NttPlan.kernel_table).  Scratch: buf (R, 2^log_n, w32) when n_passes > 1,
// words (R w32, 2^log_n), cvs (n_chunks, 8, 2^log_n) when a column spans
// more than one BLAKE3 chunk, leaves (8, 2^log_n) int64.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int lcpc_commit_small_ligero(const int32_t* arr, long long length, int32_t* mat,
                                        int32_t* comm, long long* flat, uint32_t* buf,
                                        int32_t* words, uint32_t* cvs, long long* leaves,
                                        const uint32_t* tw, const uint32_t* consts,
                                        const int* passes, int n_passes, int w32, int sha, int R,
                                        int log_n, int k, int device, void* stream) {
  if (arr == nullptr || comm == nullptr || tw == nullptr || consts == nullptr ||
      passes == nullptr || !rows_ok(length, R, k) || log_n < 1 || log_n > 30 ||
      k > (1 << log_n) || ((long long)R << log_n) >= (1LL << 31) || n_passes < 1 ||
      n_passes > kMaxPasses || (n_passes > 1 && buf == nullptr) ||
      ((long long)R * k > length) != (mat != nullptr) || (sha != 0 && sha != 1))
    return (int)cudaErrorInvalidValue;
  LigeroArgs a{};
  int expect_hi = log_n - 1;
  for (int p = 0; p < n_passes; ++p) {  // the ladder's passes, in order, down to 0
    const int hi = passes[3 * p], lo = passes[3 * p + 1], log_t = passes[3 * p + 2];
    if (hi != expect_hi || lo < 0 || lo > hi || log_t < 0 || log_t > lo ||
        hi - lo + 1 + log_t > log_n || ((p == n_passes - 1) != (lo == 0)) ||
        (lo == 0 && log_t != 0))
      return (int)cudaErrorInvalidValue;
    a.hi[p] = hi;
    a.lo[p] = lo;
    a.log_t[p] = log_t;
    expect_hi = lo - 1;
  }
  a.arr = arr;
  a.mat = mat;
  a.comm = comm;
  a.buf = buf;
  a.tw = tw;
  a.consts = consts;
  a.length = length;
  a.R = R;
  a.log_n = log_n;
  a.k = k;
  a.n_passes = n_passes;
  if (!hash_shape(a.h, words, cvs, leaves, flat, (long long)R * w32, 1 << log_n, sha))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define LCPC_LIGERO(W) \
  (sha ? run_ligero<W, Sha256Digest>(a, device, s) : run_ligero<W, Blake3Digest>(a, device, s))
  switch (w32) {
    case 2: return LCPC_LIGERO(2);
    case 4: return LCPC_LIGERO(4);
    case 6: return LCPC_LIGERO(6);
    case 8: return LCPC_LIGERO(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LCPC_LIGERO
}

// One Brakedown CODE3 commit, one launch: arr, mat, comm, flat and sha as
// for Ligero (comm (2 w32, R, n_cols)); `levels` the encoding's level table
// on the card (n_levels rows of Level: SdigEncoding.device_tables), max_out
// its widest level's outputs.  Scratch: buf (positions, R, w32) (the
// codeword's n_cols positions and the last precode's outputs after them),
// words (R w32, n_cols), cvs (when a column spans more than one BLAKE3
// chunk), leaves (8, n_cols) int64.  Returns the launch's cudaError_t.
extern "C" int lcpc_commit_small_sdig(const int32_t* arr, long long length, int32_t* mat,
                                      int32_t* comm, long long* flat, int32_t* buf,
                                      int32_t* words, uint32_t* cvs, long long* leaves,
                                      const void* levels, int n_levels, long long max_out,
                                      int w32, int sha, int R, int k, int n_cols, int device,
                                      void* stream) {
  if (arr == nullptr || comm == nullptr || buf == nullptr || levels == nullptr ||
      !rows_ok(length, R, k) || n_cols <= k || (long long)R * n_cols >= (1LL << 31) ||
      n_levels < 1 || max_out < 1 || max_out * R >= (1LL << 31) ||
      ((long long)R * k > length) != (mat != nullptr) || (sha != 0 && sha != 1))
    return (int)cudaErrorInvalidValue;
  SdigArgs a{};
  a.arr = arr;
  a.mat = mat;
  a.comm = comm;
  a.buf = buf;
  a.levels = static_cast<const Level*>(levels);
  a.length = length;
  a.n_levels = n_levels;
  a.R = R;
  a.k = k;
  a.n = n_cols;
  if (!hash_shape(a.h, words, cvs, leaves, flat, (long long)R * w32, n_cols, sha))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define LCPC_SDIG(W)                                              \
  (sha ? run_sdig<W, Sha256Digest>(a, max_out, device, s)         \
       : run_sdig<W, Blake3Digest>(a, max_out, device, s))
  switch (w32) {
    case 2: return LCPC_SDIG(2);
    case 4: return LCPC_SDIG(4);
    case 6: return LCPC_SDIG(6);
    case 8: return LCPC_SDIG(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LCPC_SDIG
}
