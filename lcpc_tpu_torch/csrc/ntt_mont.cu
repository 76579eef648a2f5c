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
//   buf       (R, n, W)    -- between passes: one element is W contiguous
//                             words; a middle pass works in place
//   limbs_out (2W, R, n)   -- last pass: the transform as 16-bit limbs
//   words_out (R W, n)     -- last pass, optional: from_mont of each output
//                             as LE u32 hash words, word r W + i, column c
//                             (core/protocol.py `_pack_words`' layout)
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
// LCPC_NTT_NO_PRODUCTS (a diagnostic build, scripts/time_ntt.py --parts)
// replaces every product by its input: wrong results, the passes' memory
// and shared-memory time alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// W words from a W*4-byte aligned address, in 16- or 8-byte loads
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&d)[W], const uint32_t* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i / 4];
      d[i] = q.x; d[i + 1] = q.y; d[i + 2] = q.z; d[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 q = reinterpret_cast<const uint2*>(p)[i / 2];
      d[i] = q.x; d[i + 1] = q.y;
    }
  }
}

// the same through the read-only data cache (for the twiddle table)
template <int W>
__device__ __forceinline__ void ldg_words(uint32_t (&d)[W], const uint32_t* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
      d[i] = q.x; d[i + 1] = q.y; d[i + 2] = q.z; d[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + i / 2);
      d[i] = q.x; d[i + 1] = q.y;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&d)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      reinterpret_cast<uint4*>(p)[i / 4] = make_uint4(d[i], d[i + 1], d[i + 2], d[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2)
      reinterpret_cast<uint2*>(p)[i / 2] = make_uint2(d[i], d[i + 1]);
  }
}

// asynchronous global -> shared copies of 16 (cache-global) or 8 bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::: "memory");
}

// PTX carry-chain steps: one instruction each; the carry flag flows from
// one to the next in program order (nothing between them touches it)
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// one 32 x 32 -> 64 product added into a word pair (lo, hi) in one carry
// chain; ptxas fuses each lo/hi pair into one IMAD.WIDE.U32(.X)
__device__ __forceinline__ void mul_pair(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  asm volatile("mul.lo.u32 %0, %2, %3;\n\tmul.hi.u32 %1, %2, %3;"
               : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void mad_pair_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                            uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_pair_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                             uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
// (lo, hi) = a b + (lo2, hi2) + carry: the pair two words up, moved down
__device__ __forceinline__ void madc_pair_down_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                                  uint32_t b, uint32_t lo2, uint32_t hi2) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %4;\n\tmadc.hi.cc.u32 %1, %2, %3, %5;"
               : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b), "r"(lo2), "r"(hi2));
}
__device__ __forceinline__ void madc_pair_top(uint32_t& lo, uint32_t& hi, uint32_t a,
                                              uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0;\n\tmadc.hi.u32 %1, %2, %3, 0;"
               : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc[0 .. 2H-1] += x[0], x[2], .. x[2H-2] times b at every other word, one
// carry chain (carry out left in the flag)
template <int W>
__device__ __forceinline__ void cmad_even(uint32_t* acc, const uint32_t* x, uint32_t b) {
  mad_pair_cc(acc[0], acc[1], x[0], b);
#pragma unroll
  for (int j = 2; j < W; j += 2) madc_pair_cc(acc[j], acc[j + 1], x[j], b);
}

template <int W>
struct Field {
  uint32_t p[W];
  uint32_t n0;

  __device__ __forceinline__ Field(const uint32_t* __restrict__ consts) {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __ldg(consts + i);
    n0 = __ldg(consts + W);
  }

  // r = a + b mod p for a, b < p (a + b < 2p < 2^(32 W): p has a spare
  // top bit, so the sum never carries out)
  __device__ __forceinline__ void add(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t s[W], d[W];
    s[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) s[i] = addc_cc(a[i], b[i]);
    d[0] = sub_cc(s[0], p[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = subc_cc(s[i], p[i]);
    const uint32_t lt = subc(0, 0);  // all ones where a + b < p
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = lt ? s[i] : d[i];
  }

  // r = a - b mod p for a, b < p
  __device__ __forceinline__ void sub(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t d[W];
    d[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = subc_cc(a[i], b[i]);
    const uint32_t mask = subc(0, 0);  // add p back where a < b
    r[0] = add_cc(d[0], p[0] & mask);
#pragma unroll
    for (int i = 1; i < W - 1; ++i) r[i] = addc_cc(d[i], p[i] & mask);
    r[W - 1] = addc(d[W - 1], p[W - 1] & mask);
  }

  // one CIOS step on the split accumulator (sppark's mont_t layout): `ev`
  // holds words at positions k, `od` at k + 1, each product's lo/hi pair in
  // one word pair, so every 32 x 32 -> 64 product is one IMAD.WIDE.  The
  // step adds a * bi and m * p (m = ev[0] n0), zeroing position 0; the
  // next step reads the shifted value with the two arrays' roles swapped.
  // Every field's p has a spare top bit, so the value stays below
  // 2^(32 (W + 1)) and no chain carries out of position W.
  __device__ __forceinline__ void cios_step(uint32_t (&ev)[W], uint32_t (&od)[W],
                                            const uint32_t (&a)[W], uint32_t bi,
                                            bool first) const {
    if (first) {
#pragma unroll
      for (int j = 0; j < W; j += 2) {
        mul_pair(ev[j], ev[j + 1], a[j], bi);
        mul_pair(od[j], od[j + 1], a[j + 1], bi);
      }
    } else {
      // od holds the previous even array (position 0 zeroed): od[1] moves
      // to position 0, od[k + 2] to odd position k
      ev[0] = add_cc(ev[0], od[1]);
#pragma unroll
      for (int j = 0; j < W - 2; j += 2)
        madc_pair_down_cc(od[j], od[j + 1], a[j + 1], bi, od[j + 2], od[j + 3]);
      madc_pair_top(od[W - 2], od[W - 1], a[W - 1], bi);
      cmad_even<W>(ev, a, bi);
      od[W - 1] = addc(od[W - 1], 0);
    }
    const uint32_t m = ev[0] * n0;
    cmad_even<W>(od, p + 1, m);
    cmad_even<W>(ev, p, m);
    od[W - 1] = addc(od[W - 1], 0);
  }

  // r = a * b * 2^(-32 W) mod p for a, b < p: CIOS word-serial over b, the
  // result below 2p, then one conditional subtract
  __device__ __forceinline__ void mul(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t ev[W], od[W];
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      cios_step(ev, od, a, b[i], i == 0);
      cios_step(od, ev, a, b[i + 1], false);
    }
    uint32_t t[W];
    merge(t, ev, od);  // the last step left od at positions k, ev at k + 1
    uint32_t d[W];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t u = (uint64_t)t[i] - p[i] - borrow;
      d[i] = (uint32_t)u;
      borrow = (uint32_t)(u >> 63);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = borrow == 0 ? d[i] : t[i];  // t >= p
  }

  // the split accumulator's reduction step alone (no product): adds m * p
  // and leaves the value for the next step with the arrays' roles swapped
  __device__ __forceinline__ void redc_step(uint32_t (&ev)[W], uint32_t (&od)[W],
                                            bool first) const {
    if (!first) {
      ev[0] = add_cc(ev[0], od[1]);
#pragma unroll
      for (int j = 0; j < W - 2; ++j) od[j] = addc_cc(od[j + 2], 0);
      od[W - 2] = addc(0, 0);
      od[W - 1] = 0;
    }
    const uint32_t m = ev[0] * n0;
    cmad_even<W>(od, p + 1, m);
    cmad_even<W>(ev, p, m);
    od[W - 1] = addc(od[W - 1], 0);
  }

  // ev[k] + od[k + 1] at position k: the split accumulator after its last
  // step (od[0] zero), shifted, in W words
  __device__ __forceinline__ void merge(uint32_t (&t)[W], const uint32_t (&ev)[W],
                                        const uint32_t (&od)[W]) const {
    t[0] = add_cc(ev[0], od[1]);
#pragma unroll
    for (int j = 1; j < W - 1; ++j) t[j] = addc_cc(ev[j], od[j + 1]);
    t[W - 1] = addc(ev[W - 1], 0);
  }

  // r = a * 2^(-32 W) mod p for a < p: W reduction steps; the result
  // (a + M p) / 2^(32 W) with M < 2^(32 W) is below p, so no subtract
  __device__ __forceinline__ void from_mont(uint32_t (&r)[W], const uint32_t (&a)[W]) const {
    uint32_t ev[W], od[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ev[i] = a[i];
      od[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      redc_step(ev, od, i == 0);
      redc_step(od, ev, false);
    }
    merge(r, ev, od);
  }
};

// Butterfly b of stage 2^sg in a tile: its elements e0, e1 (= e0 + half-
// size) in the tile and its twiddle index j (in the stage's row of tw)
__device__ __forceinline__ long long bf_index(int sg, int b, int lo, int log_t, long long rg,
                                              int& e0, int& e1) {
  const int log_mg = sg - lo;  // half-size in group elements
  const int gp = b >> log_t;
  const int t = b & ((1 << log_t) - 1);
  const int jg = gp & ((1 << log_mg) - 1);
  e0 = (((((gp >> log_mg) << (log_mg + 1)) + jg)) << log_t) + t;
  e1 = e0 + (1 << (log_mg + log_t));
  return ((long long)jg << lo) + (rg << log_t) + t;
}

// One pass (half-sizes 2^hi .. 2^lo) over every row; block = one tile of
// G = 2^(hi-lo+1) group elements x T = 2^log_t consecutive residues.
// Input: limbs_in (first pass) or buf_in; output: buf_out, or limbs_out
// (last pass, lo = log_t = 0) and optionally words_out.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
ntt_pass_kernel(const int32_t* __restrict__ limbs_in, const uint32_t* buf_in,
                uint32_t* buf_out, int32_t* __restrict__ limbs_out,
                int32_t* __restrict__ words_out, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ consts, int R, int log_n, int k, int hi,
                int lo, int log_t) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_raw);
  const int log_g = hi - lo + 1;
  const int log_tile = log_g + log_t;
  const int tile = 1 << log_tile;
  const int T = 1 << log_t;
  const long long n = 1LL << log_n;
  const long long b_id = blockIdx.x;
  const long long row = b_id >> (log_n - log_tile);
  const long long tt = b_id & ((1LL << (log_n - log_tile)) - 1);  // tile in its row
  const int log_rg = lo - log_t;                 // residue groups of T
  const long long rg = tt & ((1LL << log_rg) - 1);
  const long long blk = tt >> log_rg;            // block of 2^(hi+1)
  // row index of tile element (g, t): base + (g << lo) + t
  const long long base = (blk << (hi + 1)) + (rg << log_t);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  // ---- load the tile into shared memory (element e = g*T + t at s + e*W)
  if (limbs_in != nullptr) {
    // first pass: 2W limb rows of (R, k); pack word i = limb 2i | 2i+1 << 16
    const size_t plane = (size_t)R * k;
    const int32_t* src = limbs_in + (size_t)row * k;
    for (int e = tid; e < tile; e += nth) {
      const long long i = base + ((long long)(e >> log_t) << lo) + (e & (T - 1));
      uint32_t v[W];
      if (i < k) {
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const uint32_t l0 = (uint32_t)__ldg(src + (2 * q) * plane + i);
          const uint32_t l1 = (uint32_t)__ldg(src + (2 * q + 1) * plane + i);
          v[q] = l0 | (l1 << 16);
        }
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) v[q] = 0;
      }
      store_words<W>(s + (size_t)e * W, v);
    }
  } else {
    // a group row is T*W contiguous words in the packed buffer
    const uint32_t* src = buf_in + ((size_t)row * n + base) * W;
    constexpr int kChunk = (W % 4 == 0) ? 4 : 2;  // words per copy
    const int per_row = (T * W) / kChunk;
    for (int q = tid; q < tile * W / kChunk; q += nth) {
      const int g = q / per_row;
      const int off = (q - g * per_row) * kChunk;
      const uint32_t* gp = src + ((size_t)g << lo) * W + off;
      uint32_t* sp = s + (size_t)g * T * W + off;
      if constexpr (kChunk == 4) cp_async16(sp, gp);
      else cp_async8(sp, gp);
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // ---- the stages, in shared memory
  const Field<W> f(consts);
  for (int sg = hi; sg >= lo; --sg) {
    const uint32_t* tw_m = tw + (size_t)((1LL << sg) - 1) * W;
    for (int b = tid; b < tile / 2; b += nth) {
      int e0, e1;
      const long long j = bf_index(sg, b, lo, log_t, rg, e0, e1);
      uint32_t a[W], c[W], sum[W], d[W];
      load_words<W>(a, s + (size_t)e0 * W);
      load_words<W>(c, s + (size_t)e1 * W);
      f.add(sum, a, c);
      f.sub(d, a, c);
#ifdef LCPC_NTT_NO_PRODUCTS
      if (false) {
#else
      if (j != 0) {  // w^0 = 1: the difference is the product
#endif
        uint32_t w[W];
        ldg_words<W>(w, tw_m + (size_t)j * W);
        f.mul(c, d, w);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) c[i] = d[i];
      }
      store_words<W>(s + (size_t)e0 * W, sum);
      store_words<W>(s + (size_t)e1 * W, c);
    }
    __syncthreads();
  }

  // ---- write the tile back
  if (limbs_out != nullptr) {
    // last pass: contiguous chunk (lo = log_t = 0), element e at index base + e
    const size_t plane = (size_t)R * n;
    int32_t* dst = limbs_out + (size_t)row * n + base;
    int32_t* wdst = words_out == nullptr ? nullptr : words_out + ((size_t)row * W * n + base);
    for (int e = tid; e < tile; e += nth) {
      uint32_t v[W];
      load_words<W>(v, s + (size_t)e * W);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        dst[(2 * q) * plane + e] = (int32_t)(v[q] & 0xFFFFu);
        dst[(2 * q + 1) * plane + e] = (int32_t)(v[q] >> 16);
      }
      if (wdst != nullptr) {
        uint32_t c[W];
        f.from_mont(c, v);
#pragma unroll
        for (int q = 0; q < W; ++q) wdst[(size_t)q * n + e] = (int32_t)c[q];
      }
    }
  } else {
    uint32_t* dst = buf_out + ((size_t)row * n + base) * W;
    constexpr int kChunk = (W % 4 == 0) ? 4 : 2;
    const int per_row = (T * W) / kChunk;
    for (int q = tid; q < tile * W / kChunk; q += nth) {
      const int g = q / per_row;
      const int off = (q - g * per_row) * kChunk;
      uint32_t* gp = dst + ((size_t)g << lo) * W + off;
      const uint32_t* sp = s + (size_t)g * T * W + off;
      if constexpr (kChunk == 4)
        *reinterpret_cast<uint4*>(gp) = *reinterpret_cast<const uint4*>(sp);
      else
        *reinterpret_cast<uint2*>(gp) = *reinterpret_cast<const uint2*>(sp);
    }
  }
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

}  // namespace

// One pass of the ladder (half-sizes 2^hi .. 2^lo, tiles of 2^(hi-lo+1) x
// 2^log_t elements, `threads` per block) over every row, on `stream` of CUDA
// device `device`.  Exactly one input: limbs_in (2*w32, R, k) for the first
// pass (hi = log_n - 1), else the packed (R, 2^log_n, w32) buf_in.  Exactly
// one output: the packed buf_out (may equal buf_in), or for the last pass
// (lo = log_t = 0) limbs_out (2*w32, R, 2^log_n) and, when not null,
// words_out (R*w32, 2^log_n).  Returns the launch's cudaError_t (0 on
// success).
extern "C" int lcpc_ntt_pass(const int32_t* limbs_in, const uint32_t* buf_in,
                             uint32_t* buf_out, int32_t* limbs_out, int32_t* words_out,
                             const uint32_t* tw, const uint32_t* consts, int w32, int R,
                             int log_n, int k, int hi, int lo, int log_t, int threads,
                             int device, void* stream) {
  const bool first = limbs_in != nullptr, last = limbs_out != nullptr;
  if (R < 0 || log_n < 1 || log_n > 30 || ((long long)R << log_n) >= (1LL << 40) ||
      hi >= log_n || lo < 0 || lo > hi || log_t < 0 || log_t > lo ||
      hi - lo + 1 + log_t > log_n || first == (buf_in != nullptr) ||
      last == (buf_out != nullptr) || (first && (hi != log_n - 1 || k < 0 || k > (1 << log_n))) ||
      (last && (lo != 0 || log_t != 0)) || (!last && words_out != nullptr) ||
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
