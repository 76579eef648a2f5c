// Expander SpMV over Montgomery words: y = A x for one ragged-CSR level of
// the Brakedown (SDIG) encoding, with the gather fused into the kernel.
//
// Replaces the TPU's Pallas kernel `spmv_mont` (lcpc_tpu/ops/spmv_pallas.py,
// `_build_kernel`/`_spmv_fn`, pallas_call at line 180) together with the
// `jnp.take` gather that feeds it (lcpc_tpu/encodings/brakedown.py,
// `_apply_mat_device`).  The TPU needed a fixed slot count, so it walks a
// padded CSR over a materialized (K, W, r, n) gather block; here every
// output row has exactly its own nonzeros and the x rows are read in place.
//
//   y[c, r] = (sum_{k in row c} vals[k] * x[cols[k], r]) * R^-1 mod p
//
// Layouts (int32 storage of packed 32-bit words, word i = limbs 2i | 2i+1):
//   x       (n_in, R, W32)   -- the packed codeword buffer of encode_rows:
//                               one (element, r) is W32*4 contiguous bytes
//   row_ptr (n_out + 1)      -- nonzeros of output c: row_ptr[c] .. [c+1]
//   cols    (nnz)            -- input index of each nonzero
//   vals    (nnz, W32)       -- Montgomery value of each nonzero
//   y       (n_out, R, W32)
//
// Work mapping: S = 2^log_s lanes (adjacent in a warp) own one (c, r); lane
// s takes nonzeros row_ptr[c] + s + j*S.  The wrapper picks S per launch
// (ops/spmv.py: split_lanes) so that small levels and r = 2 still put a
// few waves of warps on the card.  All R*S lanes of one output load the same cols/vals words (one
// broadcast transaction per warp), and each lane gathers W32*4 bytes of its
// x row with 16-byte loads.  The loop is software-pipelined in registers:
// the next nonzero's value and x words, and the column index after that,
// are in flight while the current product is accumulated, which breaks the
// col -> x dependent-load chain.
//
// Arithmetic: each k's W32 x W32 word product is added into a carry-save
// accumulator with PTX carry chains.  For every word v[i], one chain of
// mad.lo.cc / madc.hi.cc adds v[i] times every other word of x (x[0],
// x[2], .. or x[1], x[3], ..: their lo/hi pairs tile the chain without
// overlap) into W32 accumulator words, and addc counts the chain's carry
// out in a separate word; the products at even positions go to e[], the
// odd ones to o[].  ptxas turns each lo/hi pair into ONE IMAD.WIDE.U32(.X)
// with the carry in and out in predicates, so a k costs W32^2 wide
// multiply-adds and 2*W32 carry counts -- 1 + 2/W32 instructions per
// 32x32 -> 64 product, with no carry propagation, before the loop's loads,
// index arithmetic and the register moves ptxas adds.  Measured with
// cuobjdump -sass on the built library (nvcc 12.8, sm_90a; chip_smoke.py
// phase 2 prints it): the W32 = 8 k loop, unrolled to two nonzeros, is 314
// instructions for 128 wide products, 2.45 per product (128 IMAD.WIDE.U32
// and .X, 32 carry counts, 97 moves, 57 loads and loop arithmetic).  After
// the loop the carry-save words are folded into
// 2*W32 + 2 words, the S lanes add theirs with warp shuffles (a full carry
// chain per step), and one word-serial Montgomery reduction and a
// conditional-subtract chain over power-of-two multiples of p (bound
// kmax*p/R + 3 for the level's longest row, the reference's max_mult) run
// once per output.  The result is the unique residue < p, so it matches the
// 16-bit-limb reference bit for bit (16*W == 32*W32: same R).
//
// What bounds it on an H100 (chip_smoke.py and scripts/sweep_spmv_lanes.py
// measure it; numbers in PERF.md): the integer multiply-add issue.  Per
// nonzero and r the kernel gathers one 32-byte x sector and does W32^2 wide
// products.  At the 2^23 ft255 commit (r = 36) pointing every gather at one
// L1-resident element takes the gathers' HBM traffic away but only ~5% of
// the time, so the k loop's IMAD pipe binds: the W32^2 IMAD.WIDE, the carry
// counts and the register moves ptxas adds (chip_smoke.py prints the SASS
// count per wide product).  At r = 2 the work is small and latency binds
// (13 dependent launches of 5 us and more), which the split over S lanes
// shortens.  An int8 tensor-core digit product is the route past the IMAD
// pipe.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// W 32-bit words from a W*4-byte aligned address, in 16- or 8-byte loads
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&d)[W], const int32_t* p) {
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
template <int W>
__global__ void __launch_bounds__(128, 4)
spmv_mont_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ cols, const int32_t* __restrict__ vals,
                 int32_t* __restrict__ y, const uint32_t* __restrict__ consts,
                 int n_out, int R, int log_s) {
  const int S = 1 << log_s;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
    load_words<W>(va, vals + (size_t)k * W);
    load_words<W>(xa, xr + (size_t)__ldg(cols + k) * xrow);
    if (k + S < end) cn = __ldg(cols + k + S);
  }
  // one nonzero a trip, unrolled by the compiler (which renames the two
  // buffers; a loop unrolled by hand made ptxas move accumulators instead)
#pragma unroll 2
  for (; k < end; k += S) {
    const int k1 = k + S;
    if (k1 < end) {
      load_words<W>(vb, vals + (size_t)k1 * W);
      load_words<W>(xb, xr + (size_t)cn * xrow);
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
  if (!valid || s != 0) return;

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
  store_words<W>(y + ((size_t)c * R + r) * W, res);
}

template <int W>
cudaError_t launch(const int32_t* x, const int32_t* row_ptr, const int32_t* cols,
                   const int32_t* vals, int32_t* y, const uint32_t* consts, int n_out,
                   int R, int log_s, cudaStream_t stream) {
  const long long n = ((long long)n_out * R) << log_s;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  spmv_mont_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      x, row_ptr, cols, vals, y, consts, n_out, R, log_s);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of CUDA device `device` with 2^log_s lanes per
// (output, r); returns the cudaError_t of the launch (0 on success).
extern "C" int lcpc_spmv_mont(const int32_t* x, const int32_t* row_ptr,
                              const int32_t* cols, const int32_t* vals, int32_t* y,
                              const uint32_t* consts, int w32, int n_out, int R,
                              int log_s, int device, void* stream) {
  if ((long long)n_out * R == 0) return 0;
  if (log_s < 0 || log_s > 5) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch<2>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    case 4: return (int)launch<4>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    case 6: return (int)launch<6>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    case 8: return (int)launch<8>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
