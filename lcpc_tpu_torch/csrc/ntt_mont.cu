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
// groups) writes them.  Its bound: 2 W^2 + W wide products a non-trivial
// butterfly (v's n^-1 folded into the last stage's twiddles) and W + 1 for
// each of the last stage's other n/2 + 1 operands' n^-1 (one Montgomery
// step of log2 n bits), at 256 rows of 2^17, ft255, 34.4 G wide products
// (4.10 ms) against 4.3 GB of limbs (1.28 ms).  The forward's tile
// (a shared-memory round trip and a barrier a stage, each twiddle read from
// L2 inside the product chain, n^-1 a product of its own at the store) kept
// it at 34% of that bound at R = 2 and 51% at R = 256.  This design
// (ntt_inverse_pass_kernel): stages two at a time in registers (radix 4: a
// thread's 4 elements through both, one round trip and one barrier a round,
// the first stage's twiddle shared by two butterflies); the first round read
// straight from the pass's input and the last written straight to its
// output; the tile's 16-byte chunks XOR-swizzled against bank conflicts;
// each round's first twiddle loaded before its elements and its second
// stage's after its first; an inverse table in ascending order whose last
// stage carries n^-1, and u n^-1 by one Montgomery step of log_n bits (u
// n^-1 + v w n^-1: one product and W + 1 wide products a last-stage
// butterfly where the twiddle and the store's n^-1 took three products);
// every butterfly's flags
// compile-time (runtime flags made ptxas keep carries and flags as register
// bits, a LOP3 each); 128 threads a block on large grids (two units a
// thread, more blocks an SM), 256 on small (ops/ntt.py
// NttPass.inverse_threads); each pass a programmatic dependent launch of
// the one before.

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

// ---- the inverse ladder ----

// The inverse pass's tile in shared memory, element e's W words: at W % 4 ==
// 0 its 16-byte chunks c = e W/4 + h at chunk c ^ ((c >> 3) & 7) (an XOR
// swizzle: the radix-4 rounds' lanes, 2^k elements apart, and a warp's 8
// consecutive residues fall on distinct banks), at W = 2, 6 plain at e W.
template <int W>
__device__ __forceinline__ void lds_elem(uint32_t (&x)[W], const uint32_t* s, int e) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const int c = e * (W / 4) + h;
      const uint4 q = reinterpret_cast<const uint4*>(s)[c ^ ((c >> 3) & 7)];
      x[4 * h] = q.x; x[4 * h + 1] = q.y; x[4 * h + 2] = q.z; x[4 * h + 3] = q.w;
    }
  } else {
    load_words<W>(x, s + (size_t)e * W);
  }
}

template <int W>
__device__ __forceinline__ void sts_elem(uint32_t* s, int e, const uint32_t (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const int c = e * (W / 4) + h;
      reinterpret_cast<uint4*>(s)[c ^ ((c >> 3) & 7)] =
          make_uint4(x[4 * h], x[4 * h + 1], x[4 * h + 2], x[4 * h + 3]);
    }
  } else {
    store_words<W>(s + (size_t)e * W, x);
  }
}

// The pass's input element at row offset i: the limb planes (the first pass;
// word q = limb 2q | 2q+1 << 16) or the packed buffer
template <int W>
__device__ __forceinline__ void load_elem(uint32_t (&x)[W], const int32_t* lin, size_t plane,
                                          const uint32_t* bin, long long i) {
  if (lin != nullptr) {
#pragma unroll
    for (int q = 0; q < W; ++q)
      x[q] = (uint32_t)__ldg(lin + (2 * q) * plane + i) |
             ((uint32_t)__ldg(lin + (2 * q + 1) * plane + i) << 16);
  } else {
    load_words<W>(x, bin + i * W);
  }
}

// The pass's output element at row offset i: the limb planes (the last
// pass) or the packed buffer
template <int W>
__device__ __forceinline__ void store_elem(int32_t* lout, size_t plane, uint32_t* bout,
                                           long long i, const uint32_t (&x)[W]) {
  if (lout != nullptr) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      lout[(2 * q) * plane + i] = (int32_t)(x[q] & 0xFFFFu);
      lout[(2 * q + 1) * plane + i] = (int32_t)(x[q] >> 16);
    }
  } else {
    store_words<W>(bout + i * W, x);
  }
}

// r = x 2^-k mod p for x < p, 1 <= k <= 31: one Montgomery step of k bits,
// (x + m p) / 2^k with m = -x p^-1 mod 2^k, below 2p, then a conditional
// subtract.  In Montgomery form too (x R 2^-k), so n^-1 for n = 2^k costs W
// wide products instead of a product's 2 W^2 + W.
template <int W>
__device__ __forceinline__ void div_pow2(const Field<W>& f, uint32_t (&r)[W],
                                         const uint32_t (&x)[W], int k) {
  const uint32_t m = (x[0] * f.n0) & ((1u << k) - 1u);
  uint32_t s[W + 1];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    c += (uint64_t)m * f.p[i] + x[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  s[W] = (uint32_t)c;
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = __funnelshift_r(s[i], s[i + 1], k);
  cond_sub<W>(r, f.p);
}

// DIT butterfly (u, v) -> (u + v w, u - v w).  FOLD (the transform's last
// stage, n = 2^log_n, whose table entries are w n^-1): u times n^-1 first
// (div_pow2), so the outputs carry the 1/n scale.  Every flag is a template
// argument: ptxas then keeps no predicate of its own beside the products'
// carry chains (runtime flags had it save and restore carries and flags as
// bits of a register, a LOP3 each).
template <int W, bool FOLD>
__device__ __forceinline__ void inv_bfly(const Field<W>& f, uint32_t (&u)[W], uint32_t (&v)[W],
                                         const uint32_t (&w)[W], int log_n) {
  uint32_t t[W], sum[W];
  f.mul(t, v, w);
  if constexpr (FOLD) {
    uint32_t us[W];
    div_pow2<W>(f, us, u, log_n);
#pragma unroll
    for (int i = 0; i < W; ++i) u[i] = us[i];
  }
  f.add(sum, u, t);
  f.sub(v, u, t);
#pragma unroll
  for (int i = 0; i < W; ++i) u[i] = sum[i];
}

// (u, v) -> (u + v, u - v): a butterfly whose twiddle is 1
template <int W>
__device__ __forceinline__ void add_sub(const Field<W>& f, uint32_t (&u)[W], uint32_t (&v)[W]) {
  uint32_t sum[W];
  f.add(sum, u, v);
  f.sub(v, u, v);
#pragma unroll
  for (int i = 0; i < W; ++i) u[i] = sum[i];
}

// A radix-4 unit's round: stage sg on (x0, x1), (x2, x3) at twiddle w1 (j1);
// STAGES = 2: also stage sg + 1 on (x0, x2) at j1 and (x1, x3) at j1 + 2^sg,
// their twiddles read from t2 (stage sg + 1's row at j1) after the first
// stage, so fewer registers are live across its products.  Every butterfly
// multiplies: at j = 0 by the table's 1 (or n^-1), the same residue; a warp
// whose lanes mix j = 0 with others would run the product anyway.
template <int W, int STAGES, bool FOLD>
__device__ __forceinline__ void round_compute(const Field<W>& f, uint32_t (&x)[4][W],
                                              const uint32_t (&w1)[W], const uint32_t* t2,
                                              int sg, int log_n) {
  inv_bfly<W, (FOLD && STAGES == 1)>(f, x[0], x[1], w1, log_n);
  inv_bfly<W, (FOLD && STAGES == 1)>(f, x[2], x[3], w1, log_n);
  if constexpr (STAGES == 2) {
    uint32_t w2[W], w3[W];  // loaded after the first stage: fewer registers live
    ldg_words<W>(w2, t2);
    ldg_words<W>(w3, t2 + ((size_t)W << sg));
    inv_bfly<W, FOLD>(f, x[0], x[2], w2, log_n);
    inv_bfly<W, FOLD>(f, x[1], x[3], w3, log_n);
  }
}

// The first pass's first round (lo = 0, T = 1, not the transform's last):
// stage 0's twiddles are all 1, stage 1's are 1 and w_4^-1 (w): one
// product a unit for both stages, none for stage 0 alone
template <int W, int STAGES>
__device__ __forceinline__ void round_first(const Field<W>& f, uint32_t (&x)[4][W],
                                            const uint32_t (&w)[W], int log_n) {
  add_sub<W>(f, x[0], x[1]);
  add_sub<W>(f, x[2], x[3]);
  if constexpr (STAGES == 2) {
    add_sub<W>(f, x[0], x[2]);
    inv_bfly<W, false>(f, x[1], x[3], w, log_n);
  }
}

// One pass of the inverse ladder (half-sizes 2^lo .. 2^hi ascending, K = hi
// - lo + 1 stages) over every row; block = one tile of the forward pass's
// shape (G = 2^K group elements at stride 2^lo x T = 2^log_t residues;
// element e = g T + t at row offset (g << lo) + t from the tile's base).
// The stages run in rounds of two (radix 4: a thread holds the 4 elements
// g0 + m 2^k, m < 4, of a unit, t = unit mod T, through both stages), the
// first round one stage where K is odd.  The first round reads its
// elements from the pass's input (limbs_in, the first pass: 16-byte loads
// of 4 consecutive limbs a plane; else buf_in), the last writes them out
// (buf_out, or the last pass's limbs_out), the rounds between meet in
// shared memory with one barrier each.  Each round's first twiddle is read
// before its elements.  The first pass's first round (stages 0 and 1) has
// one product a unit.  The transform's last stage (the last pass's) reads
// w_n^-j n^-1 from the table and divides u by n = 2^log_n (div_pow2): the
// 1/n scale for W wide products a butterfly.  A round's variant (stages,
// fold) is chosen per block, outside the products.  K = 1: a thread a
// butterfly, input to output.
// Registers for two blocks of kMaxThreads an SM: 128 at W = 8, no spill
// (on an H100 at 256 rows of 2^17, 80 registers spilled 56 bytes for 2%, 64
// spilled 484 bytes for 2%; at 2 rows both lost 1-3%).
template <int W>
__global__ void __launch_bounds__(kMaxThreads, 2)
ntt_inverse_pass_kernel(const int32_t* __restrict__ limbs_in, const uint32_t* buf_in,
                        uint32_t* buf_out, int32_t* __restrict__ limbs_out,
                        const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                        int R, int log_n, int hi, int lo, int log_t) {
  // programmatic dependent launch (launch_inverse_pass): the next pass's
  // blocks may be scheduled as this grid's retire, and this grid reads
  // nothing before the previous grid in the stream has finished
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  extern __shared__ uint4 smem_raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_raw);
  const int K = hi - lo + 1;
  const int log_tile = K + log_t;
  const int T = 1 << log_t;
  const long long n = 1LL << log_n;
  const long long b_id = blockIdx.x;
  const long long row = b_id >> (log_n - log_tile);
  const long long tt = b_id & ((1LL << (log_n - log_tile)) - 1);
  const long long rg = tt & ((1LL << (lo - log_t)) - 1);
  const long long base = ((tt >> (lo - log_t)) << (hi + 1)) + (rg << log_t);
  const size_t plane = (size_t)R * n;  // one limb plane of limbs_in / limbs_out
  const size_t at = (size_t)row * n + base;
  const int32_t* lin = limbs_in == nullptr ? nullptr : limbs_in + at;
  const uint32_t* bin = buf_in == nullptr ? nullptr : buf_in + at * W;
  int32_t* lout = limbs_out == nullptr ? nullptr : limbs_out + at;
  uint32_t* bout = buf_out == nullptr ? nullptr : buf_out + at * W;
  const long long rj = rg << log_t;  // every twiddle index's residue part
  const bool fold_pass = hi == log_n - 1;
  const Field<W> f(consts);

  if (K == 1) {  // butterfly (t, t + 2^lo) at twiddle rj + t
    const uint32_t* tw_s = tw + ((1LL << lo) - 1) * W;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      uint32_t w[W], u[W], v[W];
      ldg_words<W>(w, tw_s + (rj + t) * W);
      load_elem<W>(u, lin, plane, bin, t);
      load_elem<W>(v, lin, plane, bin, (1LL << lo) + t);
      if (fold_pass)
        inv_bfly<W, true>(f, u, v, w, log_n);
      else
        inv_bfly<W, false>(f, u, v, w, log_n);
      store_elem<W>(lout, plane, bout, t, u);
      store_elem<W>(lout, plane, bout, (1LL << lo) + t, v);
    }
    return;
  }

  const int units = 1 << (log_tile - 2);
  const int s0 = (K & 1) ? 1 : 2;  // the first round's stages
  for (int k = 0; k < K; k += (k == 0 ? s0 : 2)) {
    const int stages = k == 0 ? s0 : 2;
    const bool first = k == 0, last = k + stages == K, fold = fold_pass && last;
    if (!first) __syncthreads();
    const int sg = lo + k;
    for (int uu = threadIdx.x; uu < units; uu += blockDim.x) {
      // the unit: residue t, groups g0 + m 2^k (bits k, k + 1 of g zero in g0)
      const int t = uu & (T - 1), q = uu >> log_t;
      const int jg = q & ((1 << k) - 1);
      const int g0 = ((q >> k) << (k + 2)) | jg;
      const long long j1 = ((long long)jg << lo) + rj + t;
      // the first pass's first round takes its one twiddle alone (round_first)
      const bool lead = first && lin != nullptr && !fold;
      uint32_t w1[W], x[4][W];
      const uint32_t* t2 = tw + ((2LL << sg) - 1 + j1) * W;  // stage sg + 1 at j1
      if (lead) {
        if (stages == 2) ldg_words<W>(w1, t2 + W);  // w_4^-1 (j1 = 0)
      } else {
        ldg_words<W>(w1, tw + ((1LL << sg) - 1 + j1) * W);
      }
      const long long i0 = ((long long)g0 << lo) + t, di = 1LL << (sg);
      const int e0 = (g0 << log_t) + t, de = T << k;
      if (first && lin != nullptr) {
        // the first pass (lo = 0, T = 1): the unit's 4 elements are
        // consecutive, one 16-byte load a limb plane
#pragma unroll
        for (int qw = 0; qw < W; ++qw) {
          const int4 l0 = __ldg(reinterpret_cast<const int4*>(lin + (2 * qw) * plane + i0));
          const int4 l1 = __ldg(reinterpret_cast<const int4*>(lin + (2 * qw + 1) * plane + i0));
          x[0][qw] = __byte_perm(l0.x, l1.x, 0x5410);  // limb 2qw | limb 2qw+1 << 16
          x[1][qw] = __byte_perm(l0.y, l1.y, 0x5410);
          x[2][qw] = __byte_perm(l0.z, l1.z, 0x5410);
          x[3][qw] = __byte_perm(l0.w, l1.w, 0x5410);
        }
      } else if (first) {
#pragma unroll
        for (int m = 0; m < 4; ++m) load_elem<W>(x[m], nullptr, plane, bin, i0 + m * di);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) lds_elem<W>(x[m], s, e0 + m * de);
      }
      if (lead && stages == 2)
        round_first<W, 2>(f, x, w1, log_n);
      else if (lead)
        round_first<W, 1>(f, x, w1, log_n);
      else if (stages == 1)  // the first round of an odd pass: never the transform's last
        round_compute<W, 1, false>(f, x, w1, t2, sg, log_n);
      else if (fold)
        round_compute<W, 2, true>(f, x, w1, t2, sg, log_n);
      else
        round_compute<W, 2, false>(f, x, w1, t2, sg, log_n);
      if (last) {
#pragma unroll
        for (int m = 0; m < 4; ++m) store_elem<W>(lout, plane, bout, i0 + m * di, x[m]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) sts_elem<W>(s, e0 + m * de, x[m]);
      }
    }
  }
}

template <int W>
cudaError_t launch_inverse_pass(const int32_t* limbs_in, const uint32_t* buf_in,
                                uint32_t* buf_out, int32_t* limbs_out, const uint32_t* tw,
                                const uint32_t* consts, int R, int log_n, int hi, int lo,
                                int log_t, int threads, cudaStream_t stream) {
  const int log_tile = hi - lo + 1 + log_t;
  // shared memory only where rounds meet (more than one round)
  const size_t smem = hi - lo + 1 > 2 ? ((size_t)W << log_tile) * sizeof(uint32_t) : 0;
  static size_t smem_set = 48 * 1024;  // the default dynamic shared memory cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_inverse_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const long long blocks = (long long)R << (log_n - log_tile);
  // launched as a programmatic dependent of the grid before it in the
  // stream: the second pass's launch overlaps the first pass's last blocks
  // (at 2 rows of 2^17 on an H100, 0.0711 against 0.0731 ms)
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ntt_inverse_pass_kernel<W>, limbs_in, buf_in, buf_out,
                            limbs_out, tw, consts, R, log_n, hi, lo, log_t);
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
// (2*w32, R, 2^log_n), bit-reversed Montgomery limbs below p, 16-byte
// aligned, for the first pass (lo = log_t = 0), else the packed (R,
// 2^log_n, w32) buf_in.  Output: the packed buf_out (may equal buf_in), or
// for the last pass (hi = log_n - 1, buf_out null) limbs_out (2*w32, R,
// 2^log_n), the in-order coefficients times n^-1.  tw is the inverse table
// (ops/ntt.py InttPlan.kernel_table: w_2m^-j at row m - 1 + j, the last
// stage's times n^-1); consts p[w32] | n0.
// `threads` a block: a radix-4 unit each a round (a butterfly each where
// the pass has one stage).  Returns the launch's cudaError_t (0 on success).
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
      ((long long)R << (log_n - (hi - lo + 1 + log_t))) >= (1LL << 31) ||
      (first && hi > lo && reinterpret_cast<uintptr_t>(limbs_in) % 16 != 0))
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
