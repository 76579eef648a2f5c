// The forward NTT's pass body and the tile helpers, shared by the pass
// kernels (ntt_mont.cu, whose header describes the passes, tiles and
// layouts) and the small commit's kernel (commit_small.cu).  Header-only:
// every function is inlined into its kernel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"

namespace ntt {

using lcpc::Field;

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

// A tile between shared memory (element e = g*T + t at s + e*W) and the
// packed buffer, whose group row g is T*W contiguous words at src + (g <<
// lo)*W: asynchronous copies in, plain stores out, 16 or 8 bytes each
template <int W>
__device__ __forceinline__ void load_tile_buf(uint32_t* s, const uint32_t* src, int tile, int T,
                                              int lo) {
  constexpr int kChunk = (W % 4 == 0) ? 4 : 2;  // words per copy
  const int per_row = (T * W) / kChunk;
  for (int q = threadIdx.x; q < tile * W / kChunk; q += blockDim.x) {
    const int g = q / per_row;
    const int off = (q - g * per_row) * kChunk;
    const uint32_t* gp = src + ((size_t)g << lo) * W + off;
    uint32_t* sp = s + (size_t)g * T * W + off;
    if constexpr (kChunk == 4) cp_async16(sp, gp);
    else cp_async8(sp, gp);
  }
  cp_async_wait_all();
}

template <int W>
__device__ __forceinline__ void store_tile_buf(uint32_t* dst, const uint32_t* s, int tile, int T,
                                               int lo) {
  constexpr int kChunk = (W % 4 == 0) ? 4 : 2;
  const int per_row = (T * W) / kChunk;
  for (int q = threadIdx.x; q < tile * W / kChunk; q += blockDim.x) {
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

// v <- the element of W canonical words at x (any value below 2^(32 W)) in
// Montgomery form: reduced below p, then one product with R^2 mod p
// (consts: p | n0 | R^2), as mont_map.cu's to_mont
template <int W>
__device__ __forceinline__ void to_mont_words(uint32_t (&v)[W], const uint32_t* x_at,
                                              const uint32_t* __restrict__ consts) {
  const Field<W> f(consts);
  uint32_t x[W], p2[W], r2[W];
  ldg_words<W>(x, x_at);
#pragma unroll
  for (int q = 0; q < W; ++q) r2[q] = __ldg(consts + W + 1 + q);
  lcpc::twice<W>(p2, f.p);
  lcpc::reduce<W>(x, f.p, p2);
  f.mul(v, x, r2);
}

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

// One tile (b_id) of the pass of half-sizes 2^hi .. 2^lo over every row:
// G = 2^(hi-lo+1) group elements x T = 2^log_t consecutive residues, in
// shared memory s (W << log_tile words), by the block's threads.  Input:
// limbs_in (the first pass: 2W limb planes of `plane` elements, row r's
// column i at r k + i, elements from `limit` on zero; mat_out, if given,
// receives the (2W, R, k) matrix so read) or buf_in; output: buf_out, or
// (the last pass, lo = log_t = 0, buf_out null) limbs_out and/or words_out.
// kWordsIn (the verifier's proof rows): limbs_in holds canonical words
// instead, (R, k, W) u32 as int32, element (r, i) the W words at (r k + i)
// W, any value below 2^(32 W); each element read is reduced below p and
// taken to Montgomery form by one product with R^2 mod p (consts + W + 1:
// the constant block p | n0 | R^2), as mont_map.cu's to_mont; plane is
// unused.  Ends with the tile written and s still being read: a block
// taking another tile synchronizes first.
template <int W, bool kWordsIn = false>
__device__ __forceinline__ void forward_tile(
    long long b_id, const int32_t* __restrict__ limbs_in, long long plane, long long limit,
    int32_t* __restrict__ mat_out, const uint32_t* buf_in, uint32_t* buf_out,
    int32_t* __restrict__ limbs_out, int32_t* __restrict__ words_out,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts, int R, int log_n,
    int k, int hi, int lo, int log_t, uint32_t* s) {
  const int log_g = hi - lo + 1;
  const int log_tile = log_g + log_t;
  const int tile = 1 << log_tile;
  const int T = 1 << log_t;
  const long long n = 1LL << log_n;
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
    // first pass: 2W limb planes of `plane` elements, row r's column i at
    // r k + i, zero from `limit` on; pack word i = limb 2i | 2i+1 << 16
    const long long row0 = row * k;
    const int32_t* src = limbs_in + row0;
    for (int e = tid; e < tile; e += nth) {
      const long long i = base + ((long long)(e >> log_t) << lo) + (e & (T - 1));
      uint32_t v[W];
      if (i < k && row0 + i < limit) {
        if constexpr (kWordsIn) {
          to_mont_words<W>(v, reinterpret_cast<const uint32_t*>(limbs_in) + (row0 + i) * W,
                           consts);
        } else {
#pragma unroll
          for (int q = 0; q < W; ++q) {
            const uint32_t l0 = (uint32_t)__ldg(src + (2 * q) * plane + i);
            const uint32_t l1 = (uint32_t)__ldg(src + (2 * q + 1) * plane + i);
            v[q] = l0 | (l1 << 16);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) v[q] = 0;
      }
      if (mat_out != nullptr && i < k) {  // the padded (2W, R, k) matrix
        int32_t* m = mat_out + row0 + i;
#pragma unroll
        for (int q = 0; q < W; ++q) {
          m[(2 * q) * (size_t)R * k] = (int32_t)(v[q] & 0xFFFFu);
          m[(2 * q + 1) * (size_t)R * k] = (int32_t)(v[q] >> 16);
        }
      }
      store_words<W>(s + (size_t)e * W, v);
    }
  } else {
    load_tile_buf<W>(s, buf_in + ((size_t)row * n + base) * W, tile, T, lo);
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
  if (buf_out == nullptr) {
    // last pass: contiguous chunk (lo = log_t = 0), element e at index base + e
    const size_t out_plane = (size_t)R * n;
    int32_t* dst = limbs_out == nullptr ? nullptr : limbs_out + (size_t)row * n + base;
    int32_t* wdst = words_out == nullptr ? nullptr : words_out + ((size_t)row * W * n + base);
    for (int e = tid; e < tile; e += nth) {
      uint32_t v[W];
      load_words<W>(v, s + (size_t)e * W);
      if (dst != nullptr) {
#pragma unroll
        for (int q = 0; q < W; ++q) {
          dst[(2 * q) * out_plane + e] = (int32_t)(v[q] & 0xFFFFu);
          dst[(2 * q + 1) * out_plane + e] = (int32_t)(v[q] >> 16);
        }
      }
      if (wdst != nullptr) {
        uint32_t c[W];
        f.from_mont(c, v);
#pragma unroll
        for (int q = 0; q < W; ++q) wdst[(size_t)q * n + e] = (int32_t)c[q];
      }
    }
  } else {
    store_tile_buf<W>(buf_out + ((size_t)row * n + base) * W, s, tile, T, lo);
  }
}

}  // namespace ntt
