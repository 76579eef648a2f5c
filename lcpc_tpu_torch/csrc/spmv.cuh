// The expander SpMV's row body and its carry-save accumulator, shared by
// the level kernel (spmv_mont.cu, whose header describes the work mapping
// and the arithmetic) and the small commit's kernel (commit_small.cu).
// Header-only: every function is inlined into its kernel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ldst.cuh"

namespace spmv {

// One carry chain: a[0..2H-1] += vi * (x[0] + x[2] 2^64 + ... + x[2H-2]
// 2^(64(H-1))), carry out counted in cy.  H = W32 / 2 product pairs.
template <int H>
struct Chain;

template <>
struct Chain<1> {
  static __device__ __forceinline__ void run(uint32_t* a, uint32_t& cy, uint32_t vi,
                                             const uint32_t* x) {
    asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(cy)
        : "r"(vi), "r"(x[0]));
  }
};

template <>
struct Chain<2> {
  static __device__ __forceinline__ void run(uint32_t* a, uint32_t& cy, uint32_t vi,
                                             const uint32_t* x) {
    asm("mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(cy)
        : "r"(vi), "r"(x[0]), "r"(x[2]));
  }
};

template <>
struct Chain<3> {
  static __device__ __forceinline__ void run(uint32_t* a, uint32_t& cy, uint32_t vi,
                                             const uint32_t* x) {
    asm("mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]),
          "+r"(cy)
        : "r"(vi), "r"(x[0]), "r"(x[2]), "r"(x[4]));
  }
};

template <>
struct Chain<4> {
  static __device__ __forceinline__ void run(uint32_t* a, uint32_t& cy, uint32_t vi,
                                             const uint32_t* x) {
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]),
          "+r"(a[6]), "+r"(a[7]), "+r"(cy)
        : "r"(vi), "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]));
  }
};

// Carry-save accumulator of sum_k v_k * x_k:
//   sum_p e[p] 2^(32p) + sum_q o[q] 2^(32(q+1))
//   + sum_i c0[i] 2^(32(i+W)) + c1[i] 2^(32(i+W+1))
// A product v[i] x[j] whose position i+j is even goes to e, an odd one to
// o (shifted one word), so every lo/hi pair of a chain sits at an even
// index.  ptxas fuses each mad.lo.cc/madc.hi.cc pair into one 64-bit
// IMAD.WIDE.U32(.X) with carry in and out, and an even-aligned pair keeps
// every accumulator word in one fixed register pair: no moves.
template <int W>
struct Acc {
  uint32_t e[2 * W], o[2 * W - 2], c0[W], c1[W];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2 * W; ++i) e[i] = 0;
#pragma unroll
    for (int i = 0; i < 2 * W - 2; ++i) o[i] = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) c0[i] = c1[i] = 0;
  }

  __device__ __forceinline__ void mac(const uint32_t (&v)[W], const uint32_t (&x)[W]) {
#pragma unroll
    for (int i = 0; i < W; i += 2) {  // even row: x[0], x[2], .. at even positions
      Chain<W / 2>::run(e + i, c0[i], v[i], x);          // positions i .. i+W-1
      Chain<W / 2>::run(o + i, c1[i], v[i], x + 1);      // positions i+1 .. i+W
    }
#pragma unroll
    for (int i = 1; i < W; i += 2) {  // odd row: x[1], x[3], .. at even positions
      Chain<W / 2>::run(e + i + 1, c1[i], v[i], x + 1);  // positions i+1 .. i+W
      Chain<W / 2>::run(o + i - 1, c0[i], v[i], x);      // positions i .. i+W-1
    }
  }

  // fold into 2W+2 plain words (the top word stays 0 for K < 2^32)
  __device__ __forceinline__ void fold(uint32_t (&u)[2 * W + 2]) const {
    uint64_t t = 0;
#pragma unroll
    for (int p = 0; p < 2 * W + 2; ++p) {
      if (p < 2 * W) t += e[p];
      if (p >= 1 && p <= 2 * W - 2) t += o[p - 1];
      if (p >= W && p <= 2 * W - 1) t += c0[p - W];
      if (p >= W + 1 && p <= 2 * W) t += c1[p - W - 1];
      u[p] = (uint32_t)t;
      t >>= 32;
    }
  }
};

// W 32-bit words from a W*4-byte aligned address, in 16- or 8-byte loads by
// Ld (ldst.cuh)
template <int W, class Ld>
__device__ __forceinline__ void load_words(uint32_t (&d)[W], const int32_t* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 q = Ld::ld(reinterpret_cast<const uint4*>(p) + i / 4);
      d[i] = q.x; d[i + 1] = q.y; d[i + 2] = q.z; d[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 q = Ld::ld(reinterpret_cast<const uint2*>(p) + i / 2);
      d[i] = q.x; d[i + 1] = q.y;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_words(int32_t* p, const uint32_t* d) {
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

// consts layout (uint32): p[W] | n0 (-p^-1 mod 2^32) | n_mult |
//                         n_mult multiples of p, descending, W+1 words each
//
// Thread tid of the level's n_out R 2^log_s (lanes past the last output
// take part in the shuffles and hold nothing): S = 2^log_s adjacent lanes
// own output (c, r), lane s taking nonzeros row_ptr[c] + s + j S; x read
// by LdX (ldst.cuh), vals, cols and row_ptr through the read-only cache.
// Every lane of a warp calls it together.  Returns true in the lane that
// holds the result: out = (sum_k vals[k] x[cols[k], r]) R^-1 mod p, its
// output at (c_out, r_out).
template <int W, class LdX>
__device__ __forceinline__ bool row_product(long long tid, const int32_t* __restrict__ x,
                                            const int32_t* __restrict__ row_ptr,
                                            const int32_t* __restrict__ cols,
                                            const int32_t* __restrict__ vals,
                                            const uint32_t* __restrict__ consts, int n_out,
                                            int R, int log_s, int& c_out, int& r_out,
                                            uint32_t (&out)[W]) {
  const int S = 1 << log_s;
  const long long pair = tid >> log_s;
  const int s = (int)(tid & (S - 1));
  // lanes past the last output stay in to the end: every lane of a warp
  // takes part in the shuffles
  const bool valid = pair < (long long)n_out * R;
  int c = 0, r = 0, beg = 0, end = 0;
  if (valid) {
    c = (int)(pair / R);
    r = (int)(pair - (long long)c * R);
    beg = __ldg(row_ptr + c);
    end = __ldg(row_ptr + c + 1);
  }

  Acc<W> acc;
  acc.zero();
  const size_t xrow = (size_t)R * W;  // words of one input element
  const int32_t* xr = x + (size_t)r * W;
  uint32_t va[W], xa[W], vb[W], xb[W];
  int k = beg + s;
  int cn = 0;  // column of the next nonzero whose x is not yet in flight
  if (k < end) {
    load_words<W, lcpc::LoadNc>(va, vals + (size_t)k * W);
    load_words<W, LdX>(xa, xr + (size_t)__ldg(cols + k) * xrow);
    if (k + S < end) cn = __ldg(cols + k + S);
  }
  // one nonzero a trip, unrolled by the compiler (which renames the two
  // buffers; a loop unrolled by hand made ptxas move accumulators instead)
#pragma unroll 2
  for (; k < end; k += S) {
    const int k1 = k + S;
    if (k1 < end) {
      load_words<W, lcpc::LoadNc>(vb, vals + (size_t)k1 * W);
      load_words<W, LdX>(xb, xr + (size_t)cn * xrow);
      if (k1 + S < end) cn = __ldg(cols + k1 + S);
    }
    acc.mac(va, xa);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      va[i] = vb[i];
      xa[i] = xb[i];
    }
  }

  uint32_t u[2 * W + 2];
  acc.fold(u);
  // split-K: add the S lanes' partial sums (each < the total < 2^(32(2W+1)))
  for (int off = 1; off < S; off <<= 1) {
    uint64_t t = 0;
#pragma unroll
    for (int p = 0; p < 2 * W + 1; ++p) {
      t += (uint64_t)u[p] + __shfl_xor_sync(0xffffffffu, u[p], off);
      u[p] = (uint32_t)t;
      t >>= 32;
    }
  }
  if (!valid || s != 0) return false;

  uint32_t p[W];
#pragma unroll
  for (int i = 0; i < W; ++i) p[i] = __ldg(consts + i);
  const uint32_t n0 = __ldg(consts + W);
  const int n_mult = (int)__ldg(consts + W + 1);
  const uint32_t* mult = consts + W + 2;

  // word-serial Montgomery reduction: u += m_i * p * 2^(32 i), i < W
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t m = u[i] * n0;
    uint64_t cy = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t t = (uint64_t)m * p[j] + u[i + j] + cy;
      u[i + j] = (uint32_t)t;
      cy = t >> 32;
    }
#pragma unroll
    for (int j = i + W; j < 2 * W + 2; ++j) {
      const uint64_t t = (uint64_t)u[j] + cy;
      u[j] = (uint32_t)t;
      cy = t >> 32;
    }
  }

  // value (V + M p) / R < (kmax p / R + 1) p: W + 1 words
  uint32_t res[W + 1];
#pragma unroll
  for (int i = 0; i <= W; ++i) res[i] = u[W + i];

  for (int q = 0; q < n_mult; ++q) {
    const uint32_t* mq = mult + q * (W + 1);
    uint32_t d[W + 1];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i <= W; ++i) {
      const uint64_t t = (uint64_t)res[i] - __ldg(mq + i) - borrow;
      d[i] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    if (!borrow) {
#pragma unroll
      for (int i = 0; i <= W; ++i) res[i] = d[i];
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = res[i];
  c_out = c;
  r_out = r;
  return true;
}

}  // namespace spmv
