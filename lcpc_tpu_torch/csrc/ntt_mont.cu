// Forward NTT over Montgomery words: the Ligero row encode.
//
// Replaces the XLA-fused jnp ladder `_ntt_forward` (lcpc_tpu/ops/ntt.py:80,
// run by `BatchedNtt`) and computes what the TPU's wide-field route
// `MxuNtt` (lcpc_tpu/ops/mxu_ntt.py:401) computes, including its
// canonical-output plan (`MxuNttPlan(canonical_out=True)`, mxu_ntt.py:258)
// fused with the hash-word pack (`_canon_pack_fn`, core/protocol.py:314);
// none of them is a Pallas kernel.  Per row of length n = 2^log_n,
// natural-order input and bit-reversed output:
//
//   out[bitrev(k)] = sum_j x[j] * w_n^(j k)
//
// by the Gentleman-Sande (decimation-in-frequency) ladder: stages with
// half-size m = n/2 .. 1, butterfly (a, b) -> (a + b, (a - b) * w_2m^j) on
// the pair (i, i + m) of each 2m-block, j = i mod m.  Every output is the
// unique residue < p, so the kernel equals the 16-bit-limb ladder limb for
// limb (R = 2^(32 W) = 2^(16 * 2W): the same Montgomery form).
//
// Passes.  The wrapper (ops/ntt.py: plan_passes) groups the stages into
// passes of consecutive half-sizes 2^hi .. 2^lo.  Such a pass pairs only
// indices that share their block of 2^(hi+1) and their residue mod 2^lo, so
// it splits into independent groups of G = 2^(hi-lo+1) elements at stride
// 2^lo.  One block owns one tile: a group x T = 2^log_t consecutive
// residues (T contiguous elements per group row, so every load and store is
// coalesced), runs the pass's stages on it in shared memory with
// __syncthreads() between stages, and writes it back.  The last pass (lo =
// 0, T = 1) owns contiguous chunks.  At n = 2^17, W = 8 the default plan is
// two passes: 7 stages over 128-element groups at stride 1,024 with T = 8,
// then 10 stages over 1,024-element chunks (32 KB of shared memory each).
//
// Layouts (int32 storage; a packed word i = limbs 2i | 2i+1 << 16):
//   limbs_in  (2W, R, k)   -- first pass: the rows as 16-bit limbs, packed
//                             into words in registers; columns k .. n-1 are
//                             zero and never read
//   words_in  (R, k, W)    -- or (lcpc_ntt_words_pass: the verifier's proof
//                             rows) canonical u32 words, each element
//                             reduced below p and taken to Montgomery form
//                             by one product with R^2 as it is loaded, so
//                             the rows' conversion is no launch of its own
//                             (ntt.cuh's forward_tile<W, true>; one product
//                             an element, 2 W^2 + W wide products, beside
//                             the pass's butterflies)
//   buf       (R, n, W)    -- between passes: one element is W contiguous
//                             words; a middle pass works in place
//   limbs_out (2W, R, n)   -- last pass, optional: the transform as 16-bit
//                             limbs
//   words_out (R W, n)     -- last pass, optional: from_mont of each output
//                             as LE u32 hash words, word r W + i, column c
//                             (ops/limbs.py `pack_row_words`' layout); the
//                             streaming commit asks for the words alone
//                             (at 2^28 a 256-row block's limbs are 8.6 GB)
//   tw        (n - 1, W)   -- stage twiddles in Montgomery form, half-size m
//                             at rows m - 1 .. 2m - 2: tw[m-1+j] = w_2m^j
//                             (read through L1/L2: 4 MB at ft255, n = 2^17)
//   consts    p[W] | n0 (= -p^-1 mod 2^32)
//
// Work mapping: a pass's tile loads with cp.async (from the packed buffer)
// or with plain loads that pack limbs in registers (the first pass); the
// wrapper gives each thread 4 butterflies of every stage (128 threads a
// block at the commit shape), or 2 where the grid is small (the verify
// shape: 256 threads), neighbouring threads on neighbouring elements; the product is skipped where j = 0 (the twiddle is 1).
// Several blocks share an SM, so one block's loads and stores can overlap
// another's products.
//
// Arithmetic: word-serial CIOS Montgomery multiplication (2 W^2 + W wide
// products, 136 at ft255) on a split accumulator, as sppark's mont_t keeps
// it: words at even and at odd positions in two arrays, so each product's
// lo/hi halves land in one register pair of a PTX carry chain and ptxas
// fuses them into one IMAD.WIDE.U32(.X); one conditional subtract at the
// end.  from_mont is the reduction steps alone (W^2 + W wide products),
// whose result is < p.  Add and subtract mod p are PTX carry and borrow
// chains.  Every field's p has a spare top bit, which keeps each chain's
// value inside its words.
//
// What bounds it on an H100 (SXM, 700 W: the data sheet's 67 TFLOP/s of
// fp32 lanes as 8.4 T wide products/s, two IMADs each, and 3.35 TB/s): the
// integer multiply-add issue.  A 2^17 commit encode of 256 rows of 32,768
// is 251.7 M non-trivial butterflies, 34.2 G wide products (4.09 ms), plus
// 2.4 G for the hash words (0.29 ms), against 3.76 GB of limbs read, limbs
// and words written and twiddles read once (1.12 ms).  The previous design
// ran one launch per head stage over device memory and packed and unpacked
// the layout in the wrapper (about 17 GB of traffic around the products);
// this one keeps each element in device memory for two passes and fuses
// the layout into them, and its multiply issues one IMAD.WIDE per product
// where the C form (64-bit sums) issued several instructions.  The route
// past the IMAD pipe is a different algorithm on the tensor cores (MxuNtt's
// int8 digit four-step), left open.
//
// The inverse (lcpc_ntt_inverse_pass) replaces the XLA-fused `_intt_inverse`
// (lcpc_tpu/ops/ntt.py:184, run by `BatchedIntt`; fffft's ifft_oi): bit-
// reversed input to in-order coefficients by the decimation-in-time ladder,
// half-sizes m = 1 .. n/2, butterfly (u, v) -> (u + v w_2m^-j, u - v w_2m^-j),
// then n^-1.  It runs the forward plan's passes in reverse, each pass's
// stages from its smallest half-size up, on the same tiles: the first pass
// (the contiguous chunks) reads the limbs, the last (the widest strided
// groups) multiplies by n^-1 and writes the limbs.  It reads the forward
// table: w_2m^-j = -w_2m^(m-j) (w_2m^m = -1), so the product is v w_2m^(m-j)
// and the butterfly's sum and difference swap.  The same bound as the
// forward (2 W^2 + W wide products a non-trivial butterfly) plus one
// product an element for n^-1: at 256 rows of 2^17, ft255, 38.8 G wide
// products (4.62 ms) against 4.3 GB of limbs (1.28 ms).
//
// LCPC_NTT_NO_PRODUCTS (a diagnostic build, scripts/time_ntt.py --parts)
// replaces every product by its input: wrong results, the passes' memory
// and shared-memory time alone.
//
// The forward pass body (forward_tile) and the tile helpers live in ntt.cuh,
// shared with the small commit's kernel (commit_small.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"
#include "ntt.cuh"

namespace {

using namespace lcpc;  // Field and its carry-chain steps
using namespace ntt;   // the forward pass body, the tile helpers (ntt.cuh)

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// One pass (half-sizes 2^hi .. 2^lo) over every row; block = one tile of
// G = 2^(hi-lo+1) group elements x T = 2^log_t consecutive residues.
// Input: limbs_in (first pass) or buf_in; output: buf_out, or (last pass,
// lo = log_t = 0, buf_out null) limbs_out and/or words_out.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
ntt_pass_kernel(const int32_t* __restrict__ limbs_in, const uint32_t* buf_in,
                uint32_t* buf_out, int32_t* __restrict__ limbs_out,
                int32_t* __restrict__ words_out, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ consts, int R, int log_n, int k, int hi,
                int lo, int log_t) {
  extern __shared__ uint4 smem_raw[];
  forward_tile<W>(blockIdx.x, limbs_in, (long long)R * k, (long long)R * k, nullptr, buf_in,
                  buf_out, limbs_out, words_out, tw, consts, R, log_n, k, hi, lo, log_t,
                  reinterpret_cast<uint32_t*>(smem_raw));
}

template <int W>
cudaError_t launch_pass(const int32_t* limbs_in, const uint32_t* buf_in, uint32_t* buf_out,
                        int32_t* limbs_out, int32_t* words_out, const uint32_t* tw,
                        const uint32_t* consts, int R, int log_n, int k, int hi, int lo,
                        int log_t, int threads, cudaStream_t stream) {
  const int log_tile = hi - lo + 1 + log_t;
  const size_t smem = ((size_t)W << log_tile) * sizeof(uint32_t);
  static size_t smem_set = 48 * 1024;  // the default dynamic shared memory cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const long long blocks = (long long)R << (log_n - log_tile);
  ntt_pass_kernel<W><<<(unsigned)blocks, threads, smem, stream>>>(
      limbs_in, buf_in, buf_out, limbs_out, words_out, tw, consts, R, log_n, k, hi, lo,
      log_t);
  return cudaGetLastError();
}

// The first pass over the verifier's proof rows as canonical words: (R, k,
// W) u32 words_in, each element taken to Montgomery form as it is loaded
// (forward_tile's kWordsIn); consts p | n0 | R^2.  Output as ntt_pass_kernel's.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
ntt_words_pass_kernel(const int32_t* __restrict__ words_in, uint32_t* buf_out,
                      int32_t* __restrict__ limbs_out, int32_t* __restrict__ words_out,
                      const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                      int R, int log_n, int k, int hi, int lo, int log_t) {
  extern __shared__ uint4 smem_raw[];
  forward_tile<W, true>(blockIdx.x, words_in, 0, (long long)R * k, nullptr, nullptr, buf_out,
                        limbs_out, words_out, tw, consts, R, log_n, k, hi, lo, log_t,
                        reinterpret_cast<uint32_t*>(smem_raw));
}

template <int W>
cudaError_t launch_words_pass(const int32_t* words_in, uint32_t* buf_out, int32_t* limbs_out,
                              int32_t* words_out, const uint32_t* tw, const uint32_t* consts,
                              int R, int log_n, int k, int hi, int lo, int log_t, int threads,
                              cudaStream_t stream) {
  const int log_tile = hi - lo + 1 + log_t;
  const size_t smem = ((size_t)W << log_tile) * sizeof(uint32_t);
  static size_t smem_set = 48 * 1024;  // the default dynamic shared memory cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_words_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const long long blocks = (long long)R << (log_n - log_tile);
  ntt_words_pass_kernel<W><<<(unsigned)blocks, threads, smem, stream>>>(
      words_in, buf_out, limbs_out, words_out, tw, consts, R, log_n, k, hi, lo, log_t);
  return cudaGetLastError();
}

// One pass of the inverse ladder (half-sizes 2^lo .. 2^hi, ascending) over
// every row; the tile is the forward pass's.  Input: limbs_in (the first
// pass, lo = log_t = 0) or buf_in; output: buf_out, or (the last pass, hi =
// log_n - 1, buf_out null) limbs_out times n^-1.  DIT butterfly on (e0, e1)
// of half-size m, j = its index mod m: t = v w_2m^-j, (u, v) -> (u + t,
// u - t).  The table holds the forward twiddles w_2m^j, and w_2m^-j = -w_2m^(m-j)
// (w_2m^m = -1): t' = v w_2m^(m-j) gives (u - t', u + t'); j = 0 needs no
// product.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
ntt_inverse_pass_kernel(const int32_t* __restrict__ limbs_in, const uint32_t* buf_in,
                        uint32_t* buf_out, int32_t* __restrict__ limbs_out,
                        const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                        int R, int log_n, int hi, int lo, int log_t) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_raw);
  const int log_tile = hi - lo + 1 + log_t;
  const int tile = 1 << log_tile;
  const int T = 1 << log_t;
  const long long n = 1LL << log_n;
  const long long b_id = blockIdx.x;
  const long long row = b_id >> (log_n - log_tile);
  const long long tt = b_id & ((1LL << (log_n - log_tile)) - 1);
  const long long rg = tt & ((1LL << (lo - log_t)) - 1);
  const long long base = ((tt >> (lo - log_t)) << (hi + 1)) + (rg << log_t);
  const size_t plane = (size_t)R * n;  // one limb plane of limbs_in / limbs_out

  if (limbs_in != nullptr) {
    // first pass (a contiguous chunk): 2W limb planes; word i = limb 2i | 2i+1 << 16
    const int32_t* src = limbs_in + (size_t)row * n + base;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      uint32_t v[W];
#pragma unroll
      for (int q = 0; q < W; ++q)
        v[q] = (uint32_t)__ldg(src + (2 * q) * plane + e) |
               ((uint32_t)__ldg(src + (2 * q + 1) * plane + e) << 16);
      store_words<W>(s + (size_t)e * W, v);
    }
  } else {
    load_tile_buf<W>(s, buf_in + ((size_t)row * n + base) * W, tile, T, lo);
  }
  __syncthreads();

  const Field<W> f(consts);
  for (int sg = lo; sg <= hi; ++sg) {
    const uint32_t* tw_m = tw + (size_t)((1LL << sg) - 1) * W;
    for (int b = threadIdx.x; b < tile / 2; b += blockDim.x) {
      int e0, e1;
      const long long j = bf_index(sg, b, lo, log_t, rg, e0, e1);
      uint32_t u[W], v[W], hi_w[W], lo_w[W];
      load_words<W>(u, s + (size_t)e0 * W);
      load_words<W>(v, s + (size_t)e1 * W);
      if (j != 0) {
        uint32_t w[W], t[W];
        ldg_words<W>(w, tw_m + (size_t)((1LL << sg) - j) * W);
        f.mul(t, v, w);
        f.sub(hi_w, u, t);
        f.add(lo_w, u, t);
      } else {
        f.add(hi_w, u, v);
        f.sub(lo_w, u, v);
      }
      store_words<W>(s + (size_t)e0 * W, hi_w);
      store_words<W>(s + (size_t)e1 * W, lo_w);
    }
    __syncthreads();
  }

  if (buf_out == nullptr) {
    // last pass: element e at base + (g << lo) + t, times n^-1, as 16-bit limbs
    uint32_t n_inv[W];
#pragma unroll
    for (int q = 0; q < W; ++q) n_inv[q] = __ldg(consts + W + 1 + q);
    int32_t* dst = limbs_out + (size_t)row * n + base;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const long long i = ((long long)(e >> log_t) << lo) + (e & (T - 1));
      uint32_t v[W], c[W];
      load_words<W>(v, s + (size_t)e * W);
      f.mul(c, v, n_inv);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        dst[(2 * q) * plane + i] = (int32_t)(c[q] & 0xFFFFu);
        dst[(2 * q + 1) * plane + i] = (int32_t)(c[q] >> 16);
      }
    }
  } else {
    store_tile_buf<W>(buf_out + ((size_t)row * n + base) * W, s, tile, T, lo);
  }
}

template <int W>
cudaError_t launch_inverse_pass(const int32_t* limbs_in, const uint32_t* buf_in,
                                uint32_t* buf_out, int32_t* limbs_out, const uint32_t* tw,
                                const uint32_t* consts, int R, int log_n, int hi, int lo,
                                int log_t, int threads, cudaStream_t stream) {
  const int log_tile = hi - lo + 1 + log_t;
  const size_t smem = ((size_t)W << log_tile) * sizeof(uint32_t);
  static size_t smem_set = 48 * 1024;  // the default dynamic shared memory cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_inverse_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const long long blocks = (long long)R << (log_n - log_tile);
  ntt_inverse_pass_kernel<W><<<(unsigned)blocks, threads, smem, stream>>>(
      limbs_in, buf_in, buf_out, limbs_out, tw, consts, R, log_n, hi, lo, log_t);
  return cudaGetLastError();
}

}  // namespace

// One pass of the ladder (half-sizes 2^hi .. 2^lo, tiles of 2^(hi-lo+1) x
// 2^log_t elements, `threads` per block) over every row, on `stream` of CUDA
// device `device`.  Exactly one input: limbs_in (2*w32, R, k) for the first
// pass (hi = log_n - 1), else the packed (R, 2^log_n, w32) buf_in.  Output:
// the packed buf_out (may equal buf_in), or for the last pass (lo = log_t =
// 0, buf_out null) limbs_out (2*w32, R, 2^log_n) and/or words_out (R*w32,
// 2^log_n), at least one of them.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int lcpc_ntt_pass(const int32_t* limbs_in, const uint32_t* buf_in,
                             uint32_t* buf_out, int32_t* limbs_out, int32_t* words_out,
                             const uint32_t* tw, const uint32_t* consts, int w32, int R,
                             int log_n, int k, int hi, int lo, int log_t, int threads,
                             int device, void* stream) {
  const bool first = limbs_in != nullptr, last = buf_out == nullptr;
  if (R < 0 || log_n < 1 || log_n > 30 || ((long long)R << log_n) >= (1LL << 40) ||
      hi >= log_n || lo < 0 || lo > hi || log_t < 0 || log_t > lo ||
      hi - lo + 1 + log_t > log_n || first == (buf_in != nullptr) ||
      (first && (hi != log_n - 1 || k < 0 || k > (1 << log_n))) ||
      (last && (lo != 0 || log_t != 0 || (limbs_out == nullptr && words_out == nullptr))) ||
      (!last && (limbs_out != nullptr || words_out != nullptr)) ||
      threads < 1 || threads > kMaxThreads ||
      ((size_t)w32 * 4 << (hi - lo + 1 + log_t)) > (size_t)kMaxSmem ||
      ((long long)R << (log_n - (hi - lo + 1 + log_t))) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define LCPC_NTT_PASS(W)                                                                  \
  launch_pass<W>(limbs_in, buf_in, buf_out, limbs_out, words_out, tw, consts, R, log_n, k, \
                 hi, lo, log_t, threads, s)
  switch (w32) {
    case 2: return (int)LCPC_NTT_PASS(2);
    case 4: return (int)LCPC_NTT_PASS(4);
    case 6: return (int)LCPC_NTT_PASS(6);
    case 8: return (int)LCPC_NTT_PASS(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LCPC_NTT_PASS
}

// The first pass of the ladder (hi = log_n - 1) over the verifier's proof
// rows as canonical words: words_in (R, k, w32) int32 storage of u32, any
// value below 2^(32 w32), 16-byte aligned (8 at w32 = 2 and 6), each
// element reduced below p and taken to Montgomery form as it is loaded
// (mont_map.cu's to_mont fused into the load); consts p[w32] | n0 | R^2
// mod p[w32] (ops/mont_dot.field_consts).  Output, tiles, threads and the
// return as lcpc_ntt_pass's.
extern "C" int lcpc_ntt_words_pass(const int32_t* words_in, uint32_t* buf_out,
                                   int32_t* limbs_out, int32_t* words_out, const uint32_t* tw,
                                   const uint32_t* consts, int w32, int R, int log_n, int k,
                                   int hi, int lo, int log_t, int threads, int device,
                                   void* stream) {
  const bool last = buf_out == nullptr;
  if (words_in == nullptr || R < 0 || log_n < 1 || log_n > 30 ||
      ((long long)R << log_n) >= (1LL << 40) || hi != log_n - 1 || lo < 0 || lo > hi ||
      log_t < 0 || log_t > lo || hi - lo + 1 + log_t > log_n || k < 0 || k > (1 << log_n) ||
      (last && (lo != 0 || log_t != 0 || (limbs_out == nullptr && words_out == nullptr))) ||
      (!last && (limbs_out != nullptr || words_out != nullptr)) ||
      threads < 1 || threads > kMaxThreads ||
      ((size_t)w32 * 4 << (hi - lo + 1 + log_t)) > (size_t)kMaxSmem ||
      ((long long)R << (log_n - (hi - lo + 1 + log_t))) >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(words_in) & (w32 % 4 == 0 ? 15 : 7)) != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define LCPC_NTT_WORDS_PASS(W)                                                               \
  launch_words_pass<W>(words_in, buf_out, limbs_out, words_out, tw, consts, R, log_n, k, hi, \
                       lo, log_t, threads, s)
  switch (w32) {
    case 2: return (int)LCPC_NTT_WORDS_PASS(2);
    case 4: return (int)LCPC_NTT_WORDS_PASS(4);
    case 6: return (int)LCPC_NTT_WORDS_PASS(6);
    case 8: return (int)LCPC_NTT_WORDS_PASS(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LCPC_NTT_WORDS_PASS
}

// One pass of the inverse ladder (half-sizes 2^lo .. 2^hi, the forward
// plan's passes in reverse) over every row.  Exactly one input: limbs_in
// (2*w32, R, 2^log_n), bit-reversed Montgomery limbs below p, for the first
// pass (lo = log_t = 0), else the packed (R, 2^log_n, w32) buf_in.  Output:
// the packed buf_out (may equal buf_in), or for the last pass (hi = log_n -
// 1, buf_out null) limbs_out (2*w32, R, 2^log_n), the in-order coefficients
// times n^-1.  tw is the forward table; consts p[w32] | n0 | n^-1[w32]
// (Montgomery form).  Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_ntt_inverse_pass(const int32_t* limbs_in, const uint32_t* buf_in,
                                     uint32_t* buf_out, int32_t* limbs_out, const uint32_t* tw,
                                     const uint32_t* consts, int w32, int R, int log_n, int hi,
                                     int lo, int log_t, int threads, int device, void* stream) {
  const bool first = limbs_in != nullptr, last = buf_out == nullptr;
  if (R < 0 || log_n < 1 || log_n > 30 || ((long long)R << log_n) >= (1LL << 40) ||
      hi >= log_n || lo < 0 || lo > hi || log_t < 0 || log_t > lo ||
      hi - lo + 1 + log_t > log_n || first == (buf_in != nullptr) ||
      first != (lo == 0) || (first && log_t != 0) || last != (hi == log_n - 1) ||
      last != (limbs_out != nullptr) || threads < 1 || threads > kMaxThreads ||
      ((size_t)w32 * 4 << (hi - lo + 1 + log_t)) > (size_t)kMaxSmem ||
      ((long long)R << (log_n - (hi - lo + 1 + log_t))) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define LCPC_NTT_INVERSE_PASS(W)                                                              \
  launch_inverse_pass<W>(limbs_in, buf_in, buf_out, limbs_out, tw, consts, R, log_n, hi, lo, \
                         log_t, threads, s)
  switch (w32) {
    case 2: return (int)LCPC_NTT_INVERSE_PASS(2);
    case 4: return (int)LCPC_NTT_INVERSE_PASS(4);
    case 6: return (int)LCPC_NTT_INVERSE_PASS(6);
    case 8: return (int)LCPC_NTT_INVERSE_PASS(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LCPC_NTT_INVERSE_PASS
}
