// Latency probe of one BLAKE3 compression, for the trees' dependency floor:
// one thread runs n dependent parent compressions, each one's CV the next
// one's message, through the same parent_cv every tree kernel of the
// library uses.  Its loop body is kPerTrip compressions and the loop's own
// few instructions, so its SASS is also the per-compression instruction mix
// the BLAKE3 bounds are counted from.
//
// A measurement helper, not part of the package: scripts/kernel_bench.py
// builds it (build_chain) into its own library beside the kernels.

#include "../lcpc_tpu_torch/csrc/blake3_cols.cu"

namespace {
constexpr int kPerTrip = 4;

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
    for (int t = 0; t < kPerTrip; ++t) parent_cv(cv, cv, cv, PARENT);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[t0 + w] = cv[w];
}
}  // namespace

// n (a multiple of 4) dependent parent compressions cv <- compress(IV,
// cv || cv, 0, 64, PARENT) in one thread, starting from cv0 (8,) int64:
// out (8,) int64.
extern "C" int lcpc_blake3_compress_chain(const long long* cv0, int n, long long* out,
                                          void* stream) {
  if (cv0 == nullptr || out == nullptr || n < 0 || n % kPerTrip) return (int)cudaErrorInvalidValue;
  compress_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(cv0, n, out);
  return (int)cudaGetLastError();
}
