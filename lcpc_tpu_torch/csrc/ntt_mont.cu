// Forward NTT over Montgomery words: the Ligero row encode.
//
// Replaces the XLA-fused jnp ladder `_ntt_forward` (lcpc_tpu/ops/ntt.py:80,
// run by `BatchedNtt`) and computes what the TPU's wide-field route
// `MxuNtt` (lcpc_tpu/ops/mxu_ntt.py:401) computes; neither is a Pallas
// kernel.  Per row of length n = 2^log_n, natural-order input and
// bit-reversed output:
//
//   out[bitrev(k)] = sum_j x[j] * w_n^(j k)
//
// by the Gentleman-Sande (decimation-in-frequency) ladder: stages with
// half-size m = n/2 .. 1, butterfly (a, b) -> (a + b, (a - b) * w_2m^j) on
// the pair (i, i + m) of each 2m-block, j = i mod m.  Every output is the
// unique residue < p, so the kernel equals the 16-bit-limb ladder limb for
// limb (R = 2^(32 W) = 2^(16 * 2W): the same Montgomery form).
//
// Layouts (int32 storage of packed 32-bit words, word i = limbs 2i | 2i+1):
//   x      (R, n, W)   -- the rows, transformed in place; one element is
//                         W contiguous words (two 16-byte loads at ft255)
//   tw     (n - 1, W)  -- stage twiddles in Montgomery form, stage of
//                         half-size m at rows m - 1 .. 2m - 2: tw[m-1+j] =
//                         w_2m^j (the table stays in L2: 4 MB at ft255,
//                         n = 2^17)
//   consts p[W] | n0 (= -p^-1 mod 2^32)
//
// Work mapping:
//   - head stages (m >= C, the chunk): one launch per stage, one thread per
//     butterfly over device memory; neighbouring threads take neighbouring
//     j, so every load and store is coalesced;
//   - tail stages (m < C): one launch; each block owns one contiguous chunk
//     of C elements (independent sub-transforms), loads it into shared
//     memory, runs the log2 C stages with __syncthreads() between them and
//     writes it back.  C = min(n, 1024): 32 KB of shared memory at ft255.
//     This is the Hopper form of the JAX head/tail split (ops/ntt.py:86-116),
//     whose TAIL_C = 128 was the TPU's lane width.
//
// Arithmetic: word-serial CIOS Montgomery multiplication with 32 x 32 -> 64
// products (2 W^2 + W wide products, 136 at ft255) and one conditional
// subtract; add and subtract mod p by carry and borrow chains.
//
// What bounds it on an H100 (SXM, 700 W: the data sheet's 67 TFLOP/s of
// fp32 lanes as 8.4 T wide products/s, two IMADs each, and 3.35 TB/s): the
// integer multiply-add throughput.  A 2^17 commit encode of 256 rows is 285 M
// butterflies, 38.8 G wide products (4.63 ms), against 1.35 GB of packed
// rows, codeword and twiddles read or written once (0.40 ms).  This
// first design keeps every product on the CUDA cores and spends its memory
// traffic freely: each head stage streams the whole buffer once more (7
// stages at n = 2^17), which is of the order of the product bound itself.
// A later design moves more stages into shared memory (radix-2^k head
// passes) and the products onto the tensor cores (an int8 digit product,
// as MxuNtt does on the TPU's MXU).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogChunk = 10;  // C <= 1024: W = 8 words -> 32 KB shared

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

template <int W>
struct Field {
  uint32_t p[W];
  uint32_t n0;

  __device__ __forceinline__ Field(const uint32_t* __restrict__ consts) {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __ldg(consts + i);
    n0 = __ldg(consts + W);
  }

  // r = a + b mod p for a, b < p
  __device__ __forceinline__ void add(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t s[W], d[W];
    uint32_t carry = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t t = (uint64_t)a[i] + b[i] + carry;
      s[i] = (uint32_t)t;
      carry = (uint32_t)(t >> 32);
    }
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t t = (uint64_t)s[i] - p[i] - borrow;
      d[i] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    const bool ge = carry != 0 || borrow == 0;  // a + b >= p
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = ge ? d[i] : s[i];
  }

  // r = a - b mod p for a, b < p
  __device__ __forceinline__ void sub(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t t = (uint64_t)a[i] - b[i] - borrow;
      r[i] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    const uint32_t mask = 0u - borrow;  // add p back where a < b
    uint32_t carry = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t t = (uint64_t)r[i] + (p[i] & mask) + carry;
      r[i] = (uint32_t)t;
      carry = (uint32_t)(t >> 32);
    }
  }

  // r = a * b * 2^(-32 W) mod p for a, b < p (CIOS, then one conditional
  // subtract: the CIOS result is below 2p)
  __device__ __forceinline__ void mul(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t t[W + 2];
#pragma unroll
    for (int i = 0; i < W + 2; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const uint64_t s = (uint64_t)a[i] * b[j] + t[j] + c;
        t[j] = (uint32_t)s;
        c = s >> 32;
      }
      uint64_t s = (uint64_t)t[W] + c;
      t[W] = (uint32_t)s;
      t[W + 1] = (uint32_t)(s >> 32);
      const uint32_t m = t[0] * n0;
      s = (uint64_t)m * p[0] + t[0];
      c = s >> 32;
#pragma unroll
      for (int j = 1; j < W; ++j) {
        s = (uint64_t)m * p[j] + t[j] + c;
        t[j - 1] = (uint32_t)s;
        c = s >> 32;
      }
      s = (uint64_t)t[W] + c;
      t[W - 1] = (uint32_t)s;
      t[W] = t[W + 1] + (uint32_t)(s >> 32);
    }
    uint32_t d[W];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t u = (uint64_t)t[i] - p[i] - borrow;
      d[i] = (uint32_t)u;
      borrow = (uint32_t)(u >> 63);
    }
    const bool ge = t[W] != 0 || borrow == 0;  // t >= p
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = ge ? d[i] : t[i];
  }

  // DIF butterfly in place: (a, b) <- (a + b, (a - b) * w)
  __device__ __forceinline__ void butterfly(uint32_t (&a)[W], uint32_t (&b)[W],
                                            const uint32_t (&w)[W]) const {
    uint32_t s[W], d[W];
    add(s, a, b);
    sub(d, a, b);
    mul(b, d, w);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = s[i];
  }
};

// one head stage of half-size m = 2^log_m over every row: thread = butterfly
template <int W>
__global__ void __launch_bounds__(kThreads)
ntt_head_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ consts, long long n_bf, int log_n,
                int log_m) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_bf) return;
  const long long row = t >> (log_n - 1);
  const long long b = t & ((1LL << (log_n - 1)) - 1);  // butterfly in its row
  const long long m = 1LL << log_m;
  const long long j = b & (m - 1);
  const long long i0 = ((b >> log_m) << (log_m + 1)) + j;
  uint32_t* pa = x + ((row << log_n) + i0) * W;
  uint32_t* pb = pa + m * W;
  const Field<W> f(consts);
  uint32_t a[W], bb[W], w[W];
  load_words<W>(a, pa);
  load_words<W>(bb, pb);
  ldg_words<W>(w, tw + (m - 1 + j) * W);
  f.butterfly(a, bb, w);
  store_words<W>(pa, a);
  store_words<W>(pb, bb);
}

// every stage of half-size m < C = 2^log_c: block = one chunk of C elements
template <int W>
__global__ void __launch_bounds__(kThreads)
ntt_tail_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ consts, int log_c) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_raw);
  const int c = 1 << log_c;
  uint32_t* g = x + (size_t)blockIdx.x * ((size_t)c * W);
  for (int i = threadIdx.x; i < c * W; i += blockDim.x) s[i] = g[i];
  __syncthreads();
  const Field<W> f(consts);
  for (int log_m = log_c - 1; log_m >= 0; --log_m) {
    const int m = 1 << log_m;
    for (int b = threadIdx.x; b < c / 2; b += blockDim.x) {
      const int j = b & (m - 1);
      const int i0 = ((b >> log_m) << (log_m + 1)) + j;
      uint32_t a[W], bb[W], w[W];
      load_words<W>(a, s + i0 * W);
      load_words<W>(bb, s + (i0 + m) * W);
      ldg_words<W>(w, tw + (size_t)(m - 1 + j) * W);
      f.butterfly(a, bb, w);
      store_words<W>(s + i0 * W, a);
      store_words<W>(s + (i0 + m) * W, bb);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < c * W; i += blockDim.x) g[i] = s[i];
}

template <int W>
cudaError_t launch_head(uint32_t* x, const uint32_t* tw, const uint32_t* consts, int R,
                        int log_n, int log_m, cudaStream_t stream) {
  const long long n_bf = (long long)R << (log_n - 1);
  const long long blocks = (n_bf + kThreads - 1) / kThreads;
  ntt_head_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(x, tw, consts, n_bf,
                                                                log_n, log_m);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_tail(uint32_t* x, const uint32_t* tw, const uint32_t* consts, int R,
                        int log_n, int log_c, cudaStream_t stream) {
  const long long blocks = (long long)R << (log_n - log_c);
  const int half = 1 << (log_c - 1);
  const int threads = half < kThreads ? half : kThreads;
  const size_t smem = ((size_t)W << log_c) * sizeof(uint32_t);
  ntt_tail_kernel<W><<<(unsigned)blocks, threads, smem, stream>>>(x, tw, consts, log_c);
  return cudaGetLastError();
}

bool bad_shape(int R, int log_n) {
  return R < 0 || log_n < 1 || log_n > 30 || ((long long)R << log_n) >= (1LL << 40) ||
         (((long long)R << (log_n - 1)) + kThreads) / kThreads >= (1LL << 31);
}

}  // namespace

// One head stage (half-size 2^log_m, log_c <= log_m < log_n) of every row
// of the packed (R, 2^log_n, w32) buffer x, in place, on `stream` of CUDA
// device `device`.  Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_ntt_head(uint32_t* x, const uint32_t* tw, const uint32_t* consts,
                             int w32, int R, int log_n, int log_m, int device,
                             void* stream) {
  if (bad_shape(R, log_n) || log_m < 0 || log_m >= log_n)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_head<2>(x, tw, consts, R, log_n, log_m, s);
    case 4: return (int)launch_head<4>(x, tw, consts, R, log_n, log_m, s);
    case 6: return (int)launch_head<6>(x, tw, consts, R, log_n, log_m, s);
    case 8: return (int)launch_head<8>(x, tw, consts, R, log_n, log_m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Every stage of half-size below 2^log_c (1 <= log_c <= min(log_n, 10)) of
// every row, one block per chunk of 2^log_c elements, in place.
extern "C" int lcpc_ntt_tail(uint32_t* x, const uint32_t* tw, const uint32_t* consts,
                             int w32, int R, int log_n, int log_c, int device,
                             void* stream) {
  if (bad_shape(R, log_n) || log_c < 1 || log_c > log_n || log_c > kMaxLogChunk)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_tail<2>(x, tw, consts, R, log_n, log_c, s);
    case 4: return (int)launch_tail<4>(x, tw, consts, R, log_n, log_c, s);
    case 6: return (int)launch_tail<6>(x, tw, consts, R, log_n, log_c, s);
    case 8: return (int)launch_tail<8>(x, tw, consts, R, log_n, log_c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
