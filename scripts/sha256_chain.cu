// Latency probes of SHA-256, for the trees' dependency floor and the bounds:
// one thread runs n dependent steps, either compressions h <- compress(h,
// h || h) (the column hash's scheduled compression) or Merkle parents h <-
// parent(h, h) (two compressions, the second over the constant padding
// block), through the same code sha256_cols.cu's kernels use.  Each loop
// body is kPerTrip steps and the loop's own few instructions, so its SASS is
// also the per-step instruction mix the SHA-256 bounds are counted from.
// Two steps a trip, not BLAKE3's four: four parents are ~146 KB of straight
// code, more than the instruction cache holds, and one thread then waits on
// instruction fetch (6.4 us a parent, against 3 us a level in the walk
// kernel on an H100).
//
// A measurement helper, not part of the package: scripts/kernel_bench.py
// builds it (build_chain) into its own library beside the kernels.

#include "../lcpc_tpu_torch/csrc/sha256_cols.cu"

namespace {
constexpr int kPerTrip = 2;

// indexed by the thread (the one thread reads cv0[0 .. 7]) so that the
// compiler keeps the chain on the vector pipes the kernels use: values
// every thread of a warp shares would go to the uniform datapath
__global__ void sha256_compress_chain_kernel(const long long* __restrict__ cv0, int n,
                                             long long* __restrict__ out) {
  const int t0 = 8 * threadIdx.x;
  uint32_t h[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = (uint32_t)cv0[t0 + w];
#pragma unroll 1
  for (int i = 0; i < n; i += kPerTrip) {
#pragma unroll
    for (int t = 0; t < kPerTrip; ++t) {
      uint32_t m[16];
#pragma unroll
      for (int w = 0; w < 8; ++w) m[w] = m[8 + w] = h[w];
      compress<true>(h, m);
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[t0 + w] = h[w];
}

__global__ void sha256_parent_chain_kernel(const long long* __restrict__ cv0, int n,
                                           long long* __restrict__ out) {
  const int t0 = 8 * threadIdx.x;
  uint32_t h[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = (uint32_t)cv0[t0 + w];
#pragma unroll 1
  for (int i = 0; i < n; i += kPerTrip) {
#pragma unroll
    for (int t = 0; t < kPerTrip; ++t) Sha256Merkle::parent(h, h, h);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[t0 + w] = h[w];
}
}  // namespace

// n (a multiple of 2) dependent steps in one thread from h0 (8,) int64 (u32
// values): compressions h <- compress(h, h || h) when parent is 0, Merkle
// parents h <- parent(h, h) when it is 1; out (8,) int64.
extern "C" int lcpc_sha256_chain(const long long* h0, int n, int parent, long long* out,
                                 void* stream) {
  if (h0 == nullptr || out == nullptr || n < 0 || n % kPerTrip) return (int)cudaErrorInvalidValue;
  if (parent)
    sha256_parent_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(h0, n, out);
  else
    sha256_compress_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(h0, n, out);
  return (int)cudaGetLastError();
}
