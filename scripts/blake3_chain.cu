// Latency probe of one BLAKE3 compression, for the trees' dependency floor:
// n dependent parent compressions, each one's CV the next one's message,
// in three layouts:
//   - one thread, through the same parent_cv every tree kernel of the
//     library uses (lcpc_blake3_compress_chain).  Its loop body is kPerTrip
//     compressions and the loop's own few instructions, so its SASS is
//     also the per-compression instruction mix the BLAKE3 bounds are
//     counted from;
//   - one thread with the adds moved to the FMA pipe (x * 1 + y as IMAD,
//     the 1 from constant memory so that the compiler cannot fold it):
//     a = b + (a + m) and c = d + c, so that the ALU pipe carries the xors
//     and rotates alone (lcpc_blake3_compress_chain_fma);
//   - one quad of lanes, through blake3.cuh's quad_parent, the compression
//     of the verifier's path walk (merkle_walk_quad_kernel), one
//     compression a trip as the walk runs one a level
//     (lcpc_blake3_quad_chain).
//
// A measurement helper, not part of the package: scripts/kernel_bench.py
// builds it (build_chain) into its own library beside the kernels.

#include "../lcpc_tpu_torch/csrc/blake3_cols.cu"

namespace {
constexpr int kPerTrip = 4;

__constant__ uint32_t kOneFma = 1;

__device__ __forceinline__ uint32_t add_fma(uint32_t x, uint32_t y) { return x * kOneFma + y; }

__device__ __forceinline__ void g_fma(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                                      uint32_t mx, uint32_t my) {
  a = add_fma(b, add_fma(a, mx));
  d = rotr16(d ^ a);
  c = add_fma(d, c);
  b = rotr12(b ^ c);
  a = add_fma(b, add_fma(a, my));
  d = rotr8(d ^ a);
  c = add_fma(d, c);
  b = rotr7(b ^ c);
}

// parent_cv with g_fma: cv <- compress(IV, l || r, 0, 64, flags)
__device__ __forceinline__ void parent_cv_fma(uint32_t (&cv)[8], const uint32_t (&l)[8],
                                              const uint32_t (&r)[8], uint32_t flags) {
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    m[w] = l[w];
    m[8 + w] = r[w];
  }
  uint32_t s[16] = {kIV[0], kIV[1], kIV[2], kIV[3], kIV[4], kIV[5], kIV[6], kIV[7],
                    kIV[0], kIV[1], kIV[2], kIV[3], 0u, 0u, 64u, flags};
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g_fma(s[0], s[4], s[8], s[12], m[0], m[1]);
    g_fma(s[1], s[5], s[9], s[13], m[2], m[3]);
    g_fma(s[2], s[6], s[10], s[14], m[4], m[5]);
    g_fma(s[3], s[7], s[11], s[15], m[6], m[7]);
    g_fma(s[0], s[5], s[10], s[15], m[8], m[9]);
    g_fma(s[1], s[6], s[11], s[12], m[10], m[11]);
    g_fma(s[2], s[7], s[8], s[13], m[12], m[13]);
    g_fma(s[3], s[4], s[9], s[14], m[14], m[15]);
    if (r < 6) {
      const uint32_t t[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],  m[4],  m[13],
                              m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = s[i] ^ s[i + 8];
}

template <bool kFma>
__global__ void compress_chain_kernel(const long long* __restrict__ cv0, int n,
                                      long long* __restrict__ out) {
  // indexed by the thread (the one thread reads cv0[0 .. 7]) so that the
  // compiler keeps the chain on the vector pipes the kernels use: values
  // every thread of a warp shares would go to the uniform datapath
  const int t0 = 8 * threadIdx.x;
  uint32_t cv[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) cv[w] = (uint32_t)cv0[t0 + w];
#pragma unroll 1
  for (int i = 0; i < n; i += kPerTrip) {
#pragma unroll
    for (int t = 0; t < kPerTrip; ++t) {
      if constexpr (kFma)
        parent_cv_fma(cv, cv, cv, PARENT);
      else
        parent_cv(cv, cv, cv, PARENT);
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[t0 + w] = cv[w];
}

// one quad (4 threads): n dependent quad_parent compressions of cv || cv
__global__ void quad_chain_kernel(const long long* __restrict__ cv0, int n,
                                  long long* __restrict__ out) {
  const Quad L(threadIdx.x);
  const int t0 = 8 * (threadIdx.x >> 2);  // 0, as the thread count has it
  uint32_t node[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) node[w] = (uint32_t)cv0[t0 + w];
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) m[w] = m[8 + w] = node[w];
    quad_parent(node, m, PARENT, L);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) out[t0 + w] = node[w];
  }
}
}  // namespace

// n (a multiple of 4) dependent parent compressions cv <- compress(IV,
// cv || cv, 0, 64, PARENT) in one thread, starting from cv0 (8,) int64:
// out (8,) int64.
extern "C" int lcpc_blake3_compress_chain(const long long* cv0, int n, long long* out,
                                          void* stream) {
  if (cv0 == nullptr || out == nullptr || n < 0 || n % kPerTrip) return (int)cudaErrorInvalidValue;
  compress_chain_kernel<false><<<1, 1, 0, (cudaStream_t)stream>>>(cv0, n, out);
  return (int)cudaGetLastError();
}

// The same with the adds on the FMA pipe.
extern "C" int lcpc_blake3_compress_chain_fma(const long long* cv0, int n, long long* out,
                                              void* stream) {
  if (cv0 == nullptr || out == nullptr || n < 0 || n % kPerTrip) return (int)cudaErrorInvalidValue;
  compress_chain_kernel<true><<<1, 1, 0, (cudaStream_t)stream>>>(cv0, n, out);
  return (int)cudaGetLastError();
}

// The same n compressions (any n >= 0) by one quad of lanes (quad_parent).
extern "C" int lcpc_blake3_quad_chain(const long long* cv0, int n, long long* out,
                                      void* stream) {
  if (cv0 == nullptr || out == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  quad_chain_kernel<<<1, 4, 0, (cudaStream_t)stream>>>(cv0, n, out);
  return (int)cudaGetLastError();
}
