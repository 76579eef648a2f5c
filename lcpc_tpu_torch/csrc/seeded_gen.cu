// Seeded coefficients: the streaming commit's device-generated coefficient
// source (SeededCoeffSource, core/coeffs.py).
//
// Replaces the XLA-fused generator of lcpc_tpu/core/coeffs.py: `_gen_span_fn`
// (:143, jax.random.bits over vmapped fold_in keys) and `_digits_to_limbs_fn`
// (:194, `_from7` of ops/mxu_ntt.py:324); neither is a Pallas kernel.  The
// values are JAX's own, bit for bit: under jax_threefry_partitionable (the
// default since JAX 0.5) `jax.random.bits(k, (W7, chunk), uint8)` is
// low8(x0 ^ x1) of threefry2x32(k, (0, flat index)), and fold_in(key, c) is
// threefry2x32(key, (0, c)).  So coefficient i (chunk c = i / chunk,
// position j = i % chunk) has the 7-bit digits
//
//   digit d = low8(x0 ^ x1) of threefry2x32(fold_in(key, c), (0, d chunk + j)) & mask[d]
//
// (mask 0x7F, the top digit's mask keeps the value below 2^(num_bits - 1)
// < p), and its value sum_d digit_d 2^(7 d) read as the Montgomery form.
// Coefficients at or past `length` are zero (the commit matrix padding).
//
// One thread per coefficient: it derives its chunk's key (one threefry),
// runs one threefry per digit, and either stores each digit byte ("digits",
// (W7, n) uint8 planes) or packs the digits into the element's words in
// registers and stores them as 16-bit limbs ("limbs", (2 W32, n) int32) or
// 32-bit words ("packed", (W32, n) int32); every store is coalesced.
//
// What bounds it on an H100: the integer pipes.  A threefry2x32 is 20
// rounds of add, rotate (one funnel shift) and xor plus 6 key injections;
// at ft255 an element takes 38 of them, ~3,000 instructions, against 32
// bytes written (limbs: 64).  chip_smoke.py counts the kernel's SASS by pipe
// (ALU: LOP3, SHF, IADD3, ...; FMA: IMAD) and sets the bound from it.  The
// design gives the ALU pipe nothing but the generator: no shared memory, no
// transposes, the digit-to-limb carries folded into shifts of the packed
// words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Threefry-2x32, 20 rounds (Salmon et al. 2011), as jax._src.prng.threefry_2x32
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define LCPC_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r);      \
  x1 ^= x0;
#define LCPC_TF_ROUNDS_A LCPC_TF_ROUND(13) LCPC_TF_ROUND(15) LCPC_TF_ROUND(26) LCPC_TF_ROUND(6)
#define LCPC_TF_ROUNDS_B LCPC_TF_ROUND(17) LCPC_TF_ROUND(29) LCPC_TF_ROUND(16) LCPC_TF_ROUND(24)
  LCPC_TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  LCPC_TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  LCPC_TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  LCPC_TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  LCPC_TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef LCPC_TF_ROUNDS_A
#undef LCPC_TF_ROUNDS_B
#undef LCPC_TF_ROUND
}

enum Form { kDigits = 0, kLimbs = 1, kPacked = 2 };

// Coefficients [i0, i0 + n) of the source, element e = i - i0 at column e of
// the output planes; one instantiation per output form, so that each holds
// only the instructions its threads run (the SASS count of the bound).
template <int W32, int W7, int FORM>
__global__ void __launch_bounds__(kThreads)
seeded_gen_kernel(uint32_t key0, uint32_t key1, long long i0, long long n, long long length,
                  long long chunk, uint32_t top_mask, void* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long i = i0 + e;
  const bool live = i < length;
  const long long c = i / chunk;
  const uint32_t j = (uint32_t)(i - c * chunk);
  uint32_t f0 = 0, f1 = (uint32_t)c;  // fold_in(key, c)
  threefry2x32(key0, key1, f0, f1);
  uint32_t words[W32];
#pragma unroll
  for (int q = 0; q < W32; ++q) words[q] = 0;
  uint8_t* digits = reinterpret_cast<uint8_t*>(out);
#pragma unroll
  for (int d = 0; d < W7; ++d) {
    uint32_t x0 = 0, x1 = (uint32_t)d * (uint32_t)chunk + j;
    threefry2x32(f0, f1, x0, x1);
    const uint32_t v = live ? (x0 ^ x1) & (d == W7 - 1 ? top_mask : 0x7Fu) : 0u;
    if constexpr (FORM == kDigits) {
      digits[(long long)d * n + e] = (uint8_t)v;
    } else {
      const int bit = 7 * d, w = bit / 32, s = bit % 32;
      words[w] |= v << s;
      if (s > 25 && w + 1 < W32) words[w + 1] |= v >> (32 - s);
    }
  }
  int32_t* o = reinterpret_cast<int32_t*>(out);
  if constexpr (FORM == kLimbs) {
#pragma unroll
    for (int q = 0; q < W32; ++q) {
      o[(long long)(2 * q) * n + e] = (int32_t)(words[q] & 0xFFFFu);
      o[(long long)(2 * q + 1) * n + e] = (int32_t)(words[q] >> 16);
    }
  } else if constexpr (FORM == kPacked) {
#pragma unroll
    for (int q = 0; q < W32; ++q) o[(long long)q * n + e] = (int32_t)words[q];
  }
}

template <int W32, int W7>
cudaError_t launch(uint32_t key0, uint32_t key1, long long i0, long long n, long long length,
                   long long chunk, uint32_t top_mask, int form, void* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (form == kDigits)
    seeded_gen_kernel<W32, W7, kDigits><<<blocks, kThreads, 0, stream>>>(
        key0, key1, i0, n, length, chunk, top_mask, out);
  else if (form == kLimbs)
    seeded_gen_kernel<W32, W7, kLimbs><<<blocks, kThreads, 0, stream>>>(
        key0, key1, i0, n, length, chunk, top_mask, out);
  else
    seeded_gen_kernel<W32, W7, kPacked><<<blocks, kThreads, 0, stream>>>(
        key0, key1, i0, n, length, chunk, top_mask, out);
  return cudaGetLastError();
}

}  // namespace

// Coefficients [i0, i0 + n) of the seeded source with key (key0, key1),
// `chunk` coefficients a generator chunk, zero at or past `length`, on
// `stream` of CUDA device `device`.  form 0: (w7, n) uint8 digit planes;
// 1: (2 w32, n) int32 16-bit limbs; 2: (w32, n) int32 words.  w7 must be
// the field's digit count ((num_bits + 6) / 7 for w32 = 2, 4, 6, 8: 9, 19,
// 28, 37).  Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_seeded_gen(unsigned key0, unsigned key1, long long i0, long long n,
                               long long length, long long chunk, unsigned top_mask, int w32,
                               int w7, int form, void* out, int device, void* stream) {
  if (n < 0 || i0 < 0 || chunk < 1 || (long long)w7 * chunk > (1LL << 32) || form < 0 ||
      form > 2 || out == nullptr || (n + kThreads - 1) / kThreads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (w32 == 2 && w7 == 9) return (int)launch<2, 9>(key0, key1, i0, n, length, chunk, top_mask, form, out, s);
  if (w32 == 4 && w7 == 19) return (int)launch<4, 19>(key0, key1, i0, n, length, chunk, top_mask, form, out, s);
  if (w32 == 6 && w7 == 28) return (int)launch<6, 28>(key0, key1, i0, n, length, chunk, top_mask, form, out, s);
  if (w32 == 8 && w7 == 37) return (int)launch<8, 37>(key0, key1, i0, n, length, chunk, top_mask, form, out, s);
  return (int)cudaErrorInvalidValue;
}
