// Latency probes of SHA-256, for the trees' dependency floor and the bounds:
// one thread runs n dependent steps, either compressions h <- compress(h,
// h || h) (the wide column kernel's scheduled compression) or Merkle parents
// h <- parent(h, h) (two compressions, the second over the constant padding
// block; the walk's unrolled parent or the tree's compact one), through the
// same code sha256_cols.cu's kernels use.  Each loop
// body is kPerTrip steps and the loop's own few instructions, so its SASS is
// also the per-step instruction mix the SHA-256 bounds are counted from.
// Two steps a trip, not BLAKE3's four: four parents are ~146 KB of straight
// code, more than the instruction cache holds, and one thread then waits on
// instruction fetch (6.4 us a parent, against 3 us a level in the walk
// kernel on an H100).
//
// The op chains measure the card, not the code: one thread runs n
// instructions of one kind (IADD3, LOP3, SHF, IMAD) in 1 or 8 independent
// chains, each reading its chain's last result and two of 16 loaded
// registers (so ptxas can fold no two into one), the loop's clock64()
// cycles beside.  One chain gives an instruction's latency, eight the clocks
// one warp takes to issue one of that kind when nothing waits: the cycles
// over the chains' instructions of that kind in the loop's SASS.  These
// bound a round's dependency chain and one warp's issue (PERF.md).
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
      compress(h, m);
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[t0 + w] = h[w];
}

template <bool kCompact>
__global__ void sha256_parent_chain_kernel(const long long* __restrict__ cv0, int n,
                                           long long* __restrict__ out) {
  const int t0 = 8 * threadIdx.x;
  uint32_t h[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = (uint32_t)cv0[t0 + w];
#pragma unroll 1
  for (int i = 0; i < n; i += kPerTrip) {
#pragma unroll
    for (int t = 0; t < kPerTrip; ++t) Sha256Merkle::node<kCompact>(h, h, h);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[t0 + w] = h[w];
}
constexpr int kOpPerTrip = 64;  // chain instructions in an op chain's loop body

template <int kOp, int kChains>
__global__ void op_chain_kernel(const long long* __restrict__ v0, int n,
                                long long* __restrict__ out) {
  uint32_t v[16], x[kChains];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = (uint32_t)v0[16 * threadIdx.x + i];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = v[c];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i += kOpPerTrip) {
#pragma unroll
    for (int j = 0; j < kOpPerTrip; ++j) {
      const uint32_t p = v[j & 15], q = v[(7 * j + 3) & 15];
      uint32_t& y = x[j % kChains];
      if constexpr (kOp == 0)  // IADD3 y, y, p, q
        asm volatile("add.u32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;" : "+r"(y) : "r"(p), "r"(q));
      else if constexpr (kOp == 1)  // LOP3: y ^ p ^ q
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(y) : "r"(p), "r"(q));
      else if constexpr (kOp == 2)  // SHF: the low word of (p:y) >> 7
        asm volatile("shf.r.wrap.b32 %0, %0, %1, 7;" : "+r"(y) : "r"(p));
      else  // IMAD: y * p + q
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(y) : "r"(p), "r"(q));
    }
  }
  const long long t1 = clock64();
  uint32_t all = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) all ^= x[c];
  out[0] = all;
  out[1] = t1 - t0;
}
}  // namespace

// n (a multiple of 2) dependent steps in one thread from h0 (8,) int64 (u32
// values): compressions h <- compress(h, h || h) when parent is 0, Merkle
// parents h <- parent(h, h) when it is 1 (the walk's, unrolled) or 2 (the
// tree's, compact); out (8,) int64.
extern "C" int lcpc_sha256_chain(const long long* h0, int n, int parent, long long* out,
                                 void* stream) {
  if (h0 == nullptr || out == nullptr || n < 0 || n % kPerTrip) return (int)cudaErrorInvalidValue;
  if (parent == 2)
    sha256_parent_chain_kernel<true><<<1, 1, 0, (cudaStream_t)stream>>>(h0, n, out);
  else if (parent)
    sha256_parent_chain_kernel<false><<<1, 1, 0, (cudaStream_t)stream>>>(h0, n, out);
  else
    sha256_compress_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(h0, n, out);
  return (int)cudaGetLastError();
}

// n (a multiple of 64) instructions of kind op (0 IADD3, 1 LOP3, 2 SHF, 3
// IMAD) in one thread, in one chain (wide = 0) or eight independent ones
// (wide = 1), from the 16 values v0 (16,) int64: out (2,) int64, the last
// values' xor and the loop's clock64() cycles.
template <int kChains>
void launch_op_chain(int op, const long long* v0, int n, long long* out, cudaStream_t s) {
  switch (op) {
    case 0: op_chain_kernel<0, kChains><<<1, 1, 0, s>>>(v0, n, out); break;
    case 1: op_chain_kernel<1, kChains><<<1, 1, 0, s>>>(v0, n, out); break;
    case 2: op_chain_kernel<2, kChains><<<1, 1, 0, s>>>(v0, n, out); break;
    default: op_chain_kernel<3, kChains><<<1, 1, 0, s>>>(v0, n, out); break;
  }
}

extern "C" int lcpc_op_chain(int op, int wide, const long long* v0, int n, long long* out,
                             void* stream) {
  if (v0 == nullptr || out == nullptr || n < 0 || n % kOpPerTrip || op < 0 || op > 3)
    return (int)cudaErrorInvalidValue;
  if (wide)
    launch_op_chain<8>(op, v0, n, out, (cudaStream_t)stream);
  else
    launch_op_chain<1>(op, v0, n, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
