// Instruction-count probe of one digit of the seeded generator: one thread
// runs n dependent steps x <- x0 ^ x1 of threefry2x32(key, (0, x)), through
// the same threefry2x32 the generator (csrc/seeded_gen.cu) uses.  That is
// what the generator's function needs for a digit: one threefry2x32 of a
// fixed key on the counter (0, c) and the xor of its two outputs (the digit
// mask rides the same three-input LOP3).  Its loop body is kPerTrip steps
// and the loop's own few instructions, so its SASS is the per-digit
// instruction mix the generator's bound is counted from; the kernel's own
// work beyond it (each thread's chunk key, the 64-bit index split, the
// bound checks) is not in the count.
//
// A measurement helper, not part of the package: scripts/kernel_bench.py
// builds it (build_chain) into its own library beside the kernels.

#include "../lcpc_tpu_torch/csrc/seeded_gen.cu"

namespace {
constexpr int kPerTrip = 4;

__global__ void threefry_chain_kernel(const long long* __restrict__ in, int n,
                                      long long* __restrict__ out) {
  // indexed by the thread (the one thread reads in[0 .. 2]) so that the
  // compiler keeps the chain on the vector pipes the generator uses: values
  // every thread of a warp shares would go to the uniform datapath
  const int t0 = 3 * threadIdx.x;
  const uint32_t k0 = (uint32_t)in[t0], k1 = (uint32_t)in[t0 + 1];
  uint32_t x = (uint32_t)in[t0 + 2];
#pragma unroll 1
  for (int i = 0; i < n; i += kPerTrip) {
#pragma unroll
    for (int t = 0; t < kPerTrip; ++t) {
      uint32_t x0 = 0, x1 = x;
      threefry2x32(k0, k1, x0, x1);
      x = x0 ^ x1;
    }
  }
  out[threadIdx.x] = x;
}
}  // namespace

// n (a multiple of 4) dependent steps x <- x0 ^ x1 of threefry2x32((k0, k1),
// (0, x)) in one thread, from in = (k0, k1, x) (3,) int64: out (1,) int64.
extern "C" int lcpc_threefry_chain(const long long* in, int n, long long* out, void* stream) {
  if (in == nullptr || out == nullptr || n < 0 || n % kPerTrip) return (int)cudaErrorInvalidValue;
  threefry_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(in, n, out);
  return (int)cudaGetLastError();
}
