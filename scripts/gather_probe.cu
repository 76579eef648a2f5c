// The card's floor for a gather whose every element sits in its own 32-byte
// sector: one 4-byte load per distinct sector, nothing else.
//
// The sectors: `rows` plane-rows, each a run of `stride` words of one
// buffer (rows x stride words, at least 2 GB), k sectors in each, at
// ascending stratified positions (sector j of row r lies in the j-th of k
// equal buckets of the row, at a hashed offset inside it): the layout of
// the prover's opened columns, a plane-row of the codeword each, 189 or
// 6,593 columns of it.  Element e = r k + j.
//
// The order: `random` 0 gives thread t elements t, t + B, ..., t + 7 B of its
// block's run of 8 B (B threads a block), so a warp's 32 loads ascend
// through one plane-row; `random` 1 maps e through a bijection of [0, n)
// first (an odd multiply and an xorshift on the next power of two, cycle
// walking into [0, n)), so a warp's loads land anywhere.  Each thread has its
// 8 loads in flight before it uses one.  `evict_first` 1 loads with
// ld.global.nc.L1::no_allocate.L2::cache_hint under an evict-first policy
// (createpolicy), 0 with ld.global.nc.
//
// lcpc_probe_l2_granularity sets cudaLimitMaxL2FetchGranularity (0 .. 128
// bytes) for the whole device; it is measured only.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//     -o libgather_probe.so scripts/gather_probe.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// a bijection of [0, 2^bits), walked until it lands below n
__device__ __forceinline__ long long permute(long long e, long long n, int bits) {
  const unsigned long long mask = (1ULL << bits) - 1;
  unsigned long long x = (unsigned long long)e;
  do {
    x = (x * 0x9E3779B97F4A7C15ULL + 0x632BE59BD9B4E019ULL) & mask;
    x ^= x >> (bits / 2 + 1);
    x = (x * 0xBF58476D1CE4E5B9ULL) & mask;
  } while (x >= (unsigned long long)n);
  return (long long)x;
}

// an L2 cache policy marking lines evict-first; a load that allocates
// nothing in L1 and takes that policy in L2 (L2::evict_first as such is
// only for 256-bit loads)
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int32_t load_ef(const int32_t* p, unsigned long long pol) {
  int32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__global__ void __launch_bounds__(kThreads) probe_kernel(
    const int32_t* __restrict__ buf, long long n, int k, long long stride, long long bucket,
    int random, int bits, int evict_first, int32_t* out) {
  const long long base = (long long)blockIdx.x * kPerThread * kThreads + threadIdx.x;
  const unsigned long long pol = evict_first_policy();
  int32_t v[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    long long e = base + (long long)u * kThreads;
    v[u] = 0;
    if (e < n) {
      if (random) e = permute(e, n, bits);
      const long long r = e / k;
      const long long j = e - r * k;
      const long long s = j * bucket + mix32((uint32_t)(r * 0x10001 + j)) % bucket;
      const int32_t* p = buf + r * stride + s * 8;
      v[u] = evict_first ? load_ef(p, pol) : __ldg(p);
    }
  }
  int32_t acc = 0;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) acc ^= v[u];
  if (acc == 0x5EC7025E) out[0] = acc;  // keeps the loads; the buffer never holds it
}

}  // namespace

// One pass over n = rows k sectors of buf (rows x stride int32 words).
// Returns the launch's cudaError_t.
extern "C" int lcpc_probe_sectors(const int32_t* buf, long long rows, int k, long long stride,
                                  int random, int evict_first, int32_t* out, void* stream) {
  if (buf == nullptr || out == nullptr || rows < 1 || k < 1 || stride < 8LL * k)
    return (int)cudaErrorInvalidValue;
  const long long n = rows * k;
  int bits = 1;
  while ((1LL << bits) < n) ++bits;
  const long long blocks = (n + kPerThread * kThreads - 1) / (kPerThread * kThreads);
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      buf, n, k, stride, stride / 8 / k, random, bits, evict_first, out);
  return (int)cudaGetLastError();
}

extern "C" int lcpc_probe_l2_granularity(int bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
}

extern "C" int lcpc_probe_get_l2_granularity(long long* bytes) {
  size_t v = 0;
  const cudaError_t err = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  *bytes = (long long)v;
  return (int)err;
}
