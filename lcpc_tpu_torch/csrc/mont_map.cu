// Elementwise Montgomery maps over field elements, one thread an element:
// the port of lcpc_tpu's FieldOps limb graphs (lcpc_tpu/ops/limbs.py:121
// add, :131 sub, :149 neg, :224 _mul_unrolled behind mul, mul_const,
// to_mont and from_mont) and of the canonical hash-word pack
// (lcpc_tpu/core/protocol.py:307 _pack_words, :315 _canon_pack_fn), which
// the from_mont map writes straight out.
//
//   mont_mul_map     mul:       a b R^-1 mod p
//                    to_mont:   a R^2 R^-1 = a R mod p (b the constant R^2)
//                    from_mont: a R^-1 mod p
//   mont_addsub_map  add: a + b, sub: a - b, neg: -a (mod p)
//
// An operand is a strided view of (rows, R, C) elements: its rows are
// 16-bit limbs (2 W of them, int32 storage) or 32-bit words (W of them,
// int32 storage of u32, word i = limb 2i | limb 2i + 1 << 16); element
// (r, c) starts at r sr + c sc and row i lies i s0 further.  The hash-word
// layout of pack_row_words, (R W, C) words with word i of (r, c) at row
// r W + i, is the words view s0 = C, sr = W C, sc = 1.  Limb-major operands
// and hash words alike put consecutive c in consecutive threads, so every
// load and store of a warp is one coalesced run.
//
// Every input is first reduced below p (conditional subtracts of 2p, then
// p: each field's R = 2^(32 W) is below 4p), so each map returns the unique
// residue < p for any input below R, as the plain versions do for theirs
// (ops/mont_map.py); Field<W> (mont.cuh) then works on reduced operands.
//
// Element-contiguous words (mont_mul_map_kernel's WHOLE mode).  A words
// view with s0 = 1 holds each element's W words side by side: the
// verifier's proof rows (R, k, W) and Brakedown's packed level buffer
// (positions, R, W).  There a thread an element has neighbouring threads
// 4 W bytes apart (8 W for the buffer's two rows), and each of its W 4-byte
// stores a warp makes touches 32 sectors for 4 bytes each.  Where a and out
// are both so viewed and aligned (16 bytes at W % 4 == 0, else 8), this
// mode loads and stores each element whole, in 16- or 8-byte accesses, and
// walks the elements in the output's address order (the wrapper orders R
// and C so): a warp's stores cover one contiguous run.  (Staging a warp's
// elements in shared memory so that each store instruction writes whole
// sectors measured no faster on an H100; an input-only mode, for the proof
// rows to a new limb-major tensor, measured no faster than the strided
// mode.)  What bounds it: the bytes (4 W in and out an element) against the
// to_mont product's 2 W^2 + W wide products, the larger at ft255 by 1.2x.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"

using namespace lcpc;

namespace {

constexpr int kThreads = 256;
constexpr int kMul = 0, kToMont = 1, kFromMont = 2;  // mont_mul_map's ops
constexpr int kAdd = 0, kSub = 1, kNeg = 2;          // mont_addsub_map's ops

struct View {
  int32_t* p;
  long long s0, sr, sc;  // element strides: a row (limb or word), r, c
  int limbs;             // rows are 16-bit limbs (else 32-bit words)
};

template <int W>
__device__ __forceinline__ void load(uint32_t (&x)[W], const View& v, long long off) {
  const int32_t* q = v.p + off;
  if (v.limbs) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      x[i] = ((uint32_t)__ldg(q + 2 * i * v.s0) & 0xFFFFu) |
             ((uint32_t)__ldg(q + (2 * i + 1) * v.s0) << 16);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = (uint32_t)__ldg(q + i * v.s0);
  }
}

template <int W>
__device__ __forceinline__ void store(const View& v, long long off, const uint32_t (&x)[W]) {
  int32_t* q = v.p + off;
  if (v.limbs) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      q[2 * i * v.s0] = (int32_t)(x[i] & 0xFFFFu);
      q[(2 * i + 1) * v.s0] = (int32_t)(x[i] >> 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) q[i * v.s0] = (int32_t)x[i];
  }
}

template <int W>
__device__ __forceinline__ void load_vec(uint32_t (&x)[W], const int32_t* q) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + i / 4);
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q) + i / 2);
      x[i] = v.x; x[i + 1] = v.y;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_vec(int32_t* q, const uint32_t (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      reinterpret_cast<uint4*>(q)[i / 4] = make_uint4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2)
      reinterpret_cast<uint2*>(q)[i / 2] = make_uint2(x[i], x[i + 1]);
  }
}

// WHOLE (a and out element-contiguous, aligned words views: the header): a
// 1-D grid over the R C < 2^31 elements in out's address order, e = r C +
// c, each element loaded and stored whole; b (mul) read as ever
template <int W, int OP, bool WHOLE = false>
__global__ void __launch_bounds__(kThreads)
    mont_mul_map_kernel(const View a, const View b, const View out,
                        const uint32_t* __restrict__ consts, long long R, long long C) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (WHOLE ? R * C : C)) return;
  const Field<W> f(consts);
  uint32_t p2[W];
  twice<W>(p2, f.p);
  // WHOLE: 32-bit index arithmetic and one trip (64-bit indexes and the
  // grid-stride step took 69 registers at W = 8 for 58, 6% slower on an H100)
  const long long r0 = WHOLE ? (long long)((unsigned)t / (unsigned)C) : (long long)blockIdx.y;
  const long long c = WHOLE ? (long long)((unsigned)t - (unsigned)r0 * (unsigned)C) : t;
  for (long long r = r0; r < (WHOLE ? r0 + 1 : R); r += (WHOLE ? 1u : gridDim.y)) {
    uint32_t x[W], z[W];
    if constexpr (WHOLE)
      load_vec<W>(x, a.p + r * a.sr + c * a.sc);
    else
      load<W>(x, a, r * a.sr + c * a.sc);
    reduce<W>(x, f.p, p2);
    if (OP == kFromMont) {
      f.from_mont(z, x);  // below p for x < p
    } else {
      uint32_t y[W];
      load<W>(y, b, r * b.sr + c * b.sc);
      reduce<W>(y, f.p, p2);
      f.mul(z, x, y);
    }
    if constexpr (WHOLE)
      store_vec<W>(out.p + r * out.sr + c * out.sc, z);
    else
      store<W>(out, r * out.sr + c * out.sc, z);
  }
}

template <int W, int OP>
__global__ void __launch_bounds__(kThreads)
    mont_addsub_map_kernel(const View a, const View b, const View out,
                           const uint32_t* __restrict__ consts, long long R, long long C) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const Field<W> f(consts);
  uint32_t p2[W];
  twice<W>(p2, f.p);
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    uint32_t x[W], y[W], z[W];
    load<W>(x, a, r * a.sr + c * a.sc);
    reduce<W>(x, f.p, p2);
    if (OP == kNeg) {
#pragma unroll
      for (int i = 0; i < W; ++i) y[i] = 0;
      f.sub(z, y, x);
    } else {
      load<W>(y, b, r * b.sr + c * b.sc);
      reduce<W>(y, f.p, p2);
      if (OP == kAdd)
        f.add(z, x, y);
      else
        f.sub(z, x, y);
    }
    store<W>(out, r * out.sr + c * out.sc, z);
  }
}

dim3 grid_of(long long R, long long C) {
  return dim3((unsigned)((C + kThreads - 1) / kThreads), (unsigned)(R < 65535 ? R : 65535));
}

template <int W, bool WHOLE>
cudaError_t launch_mul(int op, const View& a, const View& b, const View& out,
                       const uint32_t* consts, long long R, long long C, cudaStream_t s) {
  const dim3 grid = WHOLE ? dim3((unsigned)((R * C + kThreads - 1) / kThreads)) : grid_of(R, C);
  if (op == kFromMont)
    mont_mul_map_kernel<W, kFromMont, WHOLE><<<grid, kThreads, 0, s>>>(a, b, out, consts, R, C);
  else
    mont_mul_map_kernel<W, kMul, WHOLE><<<grid, kThreads, 0, s>>>(a, b, out, consts, R, C);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_mul(int op, bool whole, const View& a, const View& b, const View& out,
                       const uint32_t* consts, long long R, long long C, cudaStream_t s) {
  return whole ? launch_mul<W, true>(op, a, b, out, consts, R, C, s)
               : launch_mul<W, false>(op, a, b, out, consts, R, C, s);
}

template <int W>
cudaError_t launch_addsub(int op, const View& a, const View& b, const View& out,
                          const uint32_t* consts, long long R, long long C, cudaStream_t s) {
  const dim3 grid = grid_of(R, C);
  if (op == kAdd)
    mont_addsub_map_kernel<W, kAdd><<<grid, kThreads, 0, s>>>(a, b, out, consts, R, C);
  else if (op == kSub)
    mont_addsub_map_kernel<W, kSub><<<grid, kThreads, 0, s>>>(a, b, out, consts, R, C);
  else
    mont_addsub_map_kernel<W, kNeg><<<grid, kThreads, 0, s>>>(a, b, out, consts, R, C);
  return cudaGetLastError();
}

bool valid(int op, const View& a, const View& b, const View& out, const uint32_t* consts,
           long long R, long long C, bool needs_b) {
  return a.p != nullptr && out.p != nullptr && consts != nullptr && (b.p != nullptr || !needs_b) &&
         op >= 0 && op <= 2 && R >= 1 && C >= 1 && (C + kThreads - 1) / kThreads < (1LL << 31);
}

// a view the element-contiguous mode loads or stores whole: words, s0 = 1,
// its address and both element strides aligned to the accesses
bool whole_view(const View& v, int w32) {
  const long long align = w32 % 4 == 0 ? 4 : 2;  // in words
  return !v.limbs && v.s0 == 1 && reinterpret_cast<uintptr_t>(v.p) % (4 * align) == 0 &&
         v.sr % align == 0 && v.sc % align == 0;
}

}  // namespace

// The entry points: op, then a, b and out as (pointer, row stride, r
// stride, c stride, limbs), element strides of int32; consts is p | n0 |
// R^2 mod p (ops/mont_dot.field_consts); R x C elements.  Returns the
// launch's cudaError_t.  lcpc_mont_mul_map's `whole` takes the
// element-contiguous mode (R C < 2^31 elements walked r C + c); a view it
// cannot take is refused (cudaErrorInvalidValue), never taken the other way.
extern "C" int lcpc_mont_mul_map(int op, int32_t* a, long long a_s0, long long a_sr,
                                 long long a_sc, int a_limbs, int32_t* b, long long b_s0,
                                 long long b_sr, long long b_sc, int b_limbs, int32_t* out,
                                 long long o_s0, long long o_sr, long long o_sc, int o_limbs,
                                 const uint32_t* consts, int w32, long long R, long long C,
                                 int device, void* stream, int whole) {
  const View va{a, a_s0, a_sr, a_sc, a_limbs}, vo{out, o_s0, o_sr, o_sc, o_limbs};
  // to_mont: b is the constant R^2 mod p, every element's
  const View vb = op == kToMont ? View{(int32_t*)(consts + w32 + 1), 1, 0, 0, 0}
                                : View{b, b_s0, b_sr, b_sc, b_limbs};
  if (!valid(op, va, vb, vo, consts, R, C, op == kMul) ||
      (whole && (R * C >= (1LL << 31) || !whole_view(va, w32) || !whole_view(vo, w32))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_mul<2>(op, whole, va, vb, vo, consts, R, C, s);
    case 4: return (int)launch_mul<4>(op, whole, va, vb, vo, consts, R, C, s);
    case 6: return (int)launch_mul<6>(op, whole, va, vb, vo, consts, R, C, s);
    case 8: return (int)launch_mul<8>(op, whole, va, vb, vo, consts, R, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int lcpc_mont_addsub_map(int op, int32_t* a, long long a_s0, long long a_sr,
                                    long long a_sc, int a_limbs, int32_t* b, long long b_s0,
                                    long long b_sr, long long b_sc, int b_limbs, int32_t* out,
                                    long long o_s0, long long o_sr, long long o_sc, int o_limbs,
                                    const uint32_t* consts, int w32, long long R, long long C,
                                    int device, void* stream) {
  const View va{a, a_s0, a_sr, a_sc, a_limbs}, vb{b, b_s0, b_sr, b_sc, b_limbs},
      vo{out, o_s0, o_sr, o_sc, o_limbs};
  if (!valid(op, va, vb, vo, consts, R, C, op != kNeg)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_addsub<2>(op, va, vb, vo, consts, R, C, s);
    case 4: return (int)launch_addsub<4>(op, va, vb, vo, consts, R, C, s);
    case 6: return (int)launch_addsub<6>(op, va, vb, vo, consts, R, C, s);
    case 8: return (int)launch_addsub<8>(op, va, vb, vo, consts, R, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
