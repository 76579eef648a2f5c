// The power table of the direct column evaluation: V[m, j] = g_j^m in
// Montgomery form, for m < K and the opened columns' points
// g_j = w^bitrev(c_j) (MxuColumnEval, ops/mxu_prove.py), so that an opened
// Reed-Solomon codeword column is the coefficient rows times V
// (csrc/mont_dot.cu).
//
// Replaces `_kernel_build_fns` (lcpc_tpu/ops/mxu_prove.py:319), XLA-fused,
// not Pallas: there a low ladder g^t (t < A) and a high ladder g^(A q) give
// each entry of one super-chunk with one Montgomery product, and a scalar
// per super-chunk folds the offsets in afterwards.  Here the same two
// ladders give every entry of the table directly:
//
//   V[q A + t, j] = lo[t, j] hi[q, j],  lo[t, j] = g_j^t,  hi[q, j] = g_j^(A q)
//
// with A = 32, as digit planes (KT, k, 4W, 128) u8, what the tile mont_dot
// kernel reads on the tensor cores (the prover's column evaluation and the
// verifier's rows at the opened columns): [t, j, d, e] is byte d of entry
// m = 128 t + e of point j, zero past K; each k-tile of 128 m is one
// contiguous slab of every point's planes, one TMA box of the wgmma's B
// operand.  The store runs along m, so a warp owns one point and 128
// neighbouring m: lane l takes t = 4 (l mod 8) .. + 3 of the q = l / 8,
// holds its four low powers in registers and forms four entries with one
// product each; a 4 x 4 byte transpose of each word gives four plane rows
// of 4 bytes, and the warp's 32 lanes store 128 contiguous bytes of each.
// The high ladder is shared across the warp: lane l holds g^(A q) of the
// warp's q0 + l, advanced by one product by g^(32 A) every 32 q, and the
// lanes that need it read it by shuffle.  The verifier's two rows read
// this layout too: with the tile kernel, table included, 0.363 ms against
// 0.658 for a (W, K, k) words table with the CUDA-core kernel at 2^23, and
// 1.924 against 4.358 at 2^29 (an H100, scripts/time_thin_dot.py).
//
// The only host work is the k points g_j (one pow each, as in lcpc_tpu).
//
// What bounds it on an H100 (700 W): the products, 2 W^2 + W wide products
// an entry (136 at ft255), at 8.4 T/s, ~1.06 of them an entry with the
// ladders; against the table's bytes written once (32 bytes an entry at
// ft255, 3.35 TB/s) the products take ~1.7x longer.  At the 2^29 prove
// (262,144 x 189 entries, 1.6 GB) the bound is ~0.8 ms.

#include "mont.cuh"

namespace {

using namespace lcpc;

constexpr int kA = 32;  // the low ladder's length

template <int W>
__device__ __forceinline__ void copy(uint32_t (&r)[W], const uint32_t (&a)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = a[i];
}

// r = g^e (Montgomery), left to right square and multiply; g^0 = one
template <int W>
__device__ __forceinline__ void pow_mont(uint32_t (&r)[W], const uint32_t (&g)[W], unsigned e,
                                         const uint32_t (&one)[W], const Field<W>& f) {
  if (e == 0) {
    copy(r, one);
    return;
  }
  copy(r, g);
  for (int s = 30 - __clz(e); s >= 0; --s) {
    uint32_t t[W];
    copy(t, r);
    f.mul(r, t, t);
    if ((e >> s) & 1u) {
      copy(t, r);
      f.mul(r, t, g);
    }
  }
}

template <int W>
__device__ __forceinline__ void square_n(uint32_t (&r)[W], int n, const Field<W>& f) {
  for (int s = 0; s < n; ++s) {
    uint32_t t[W];
    copy(t, r);
    f.mul(r, t, t);
  }
}

constexpr int kPlaneWarps = 4;   // warps a block (planes)
constexpr int kPlaneRounds = 8;  // rounds of 32 q a warp
constexpr long long kPlaneM = (long long)kPlaneWarps * kPlaneRounds * 32 * kA;  // m a block

template <int W>
__global__ void __launch_bounds__(32 * kPlaneWarps)
power_planes_kernel(const int32_t* __restrict__ g, uint8_t* __restrict__ out,
                    const uint32_t* __restrict__ consts, int K, int k) {
  constexpr int D = 4 * W;
  const long long kp = (long long)(K + 127) / 128 * 128;  // K to whole k-tiles
  const Field<W> f(consts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.y;
  const unsigned q0 = ((unsigned)blockIdx.x * kPlaneWarps + warp) * (kPlaneRounds * 32);
  if ((long long)q0 * kA >= kp) return;  // the whole warp past the table
  uint32_t gj[W], one[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    gj[i] = (uint32_t)__ldg(g + (long long)i * k + j);
    one[i] = __ldg(consts + 2 * W + 1 + i);
  }
  // this lane's low powers g^t, t = 4c .. 4c + 3
  const int c = lane & 7;
  uint32_t lo[4][W];
  pow_mont(lo[0], gj, 4u * c, one, f);
#pragma unroll
  for (int u = 1; u < 4; ++u) f.mul(lo[u], lo[u - 1], gj);
  // g^A, g^(32 A), and this lane's high power g^(A (q0 + lane))
  uint32_t ga[W], step[W], h_own[W];
  copy(ga, gj);
  square_n(ga, 5, f);
  copy(step, ga);
  square_n(step, 5, f);
  pow_mont(h_own, ga, q0 + lane, one, f);
  for (int round = 0; round < kPlaneRounds; ++round) {
#pragma unroll 1
    for (int s = 0; s < 8; ++s) {
      const int src = 4 * s + (lane >> 3);  // the lane holding this lane's q
      uint32_t h[W];
#pragma unroll
      for (int i = 0; i < W; ++i) h[i] = __shfl_sync(0xffffffffu, h_own[i], src);
      const long long m0 = ((long long)q0 + 32 * round + src) * kA + 4 * c;
      if (m0 < kp) {
        uint32_t v[4][W];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (m0 + u < K) {
            f.mul(v[u], lo[u], h);
          } else {
#pragma unroll
            for (int i = 0; i < W; ++i) v[u][i] = 0;  // the pad past K
          }
        }
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const uint32_t x[4] = {v[0][i], v[1][i], v[2][i], v[3][i]};
          uint32_t o[4];
          transpose4(x, o);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            *(uint32_t*)(out + (((m0 >> 7) * k + j) * D + 4 * i + b) * 128 + (m0 & 127)) = o[b];
        }
      }
    }
    uint32_t t[W];
    copy(t, h_own);
    f.mul(h_own, t, step);
  }
}

template <int W>
cudaError_t launch(const int32_t* g, uint8_t* out, const uint32_t* consts, int K, int k,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((K + kPlaneM - 1) / kPlaneM), (unsigned)k);
  power_planes_kernel<W><<<grid, 32 * kPlaneWarps, 0, stream>>>(g, out, consts, K, k);
  return cudaGetLastError();
}

}  // namespace

// The table of the points g (w32, k) int32 words (Montgomery) on `stream`
// of CUDA device `device`: out (KT, k, 4 w32, 128) u8, KT = ceil(K / 128),
// out[t, j, d, e] = byte d of g_j^(128 t + e) (Montgomery), zero past K.
// consts: p[w32] | n0 | r2[w32] | one[w32].  Returns the launch's
// cudaError_t (0 on success).
extern "C" int lcpc_power_table(const int32_t* g, uint8_t* out, const uint32_t* consts, int w32,
                                int K, int k, int device, void* stream) {
  if (g == nullptr || out == nullptr || consts == nullptr || K < 1 || k < 1 ||
      (long long)K > (1LL << 30) || k > 65535 || ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch<2>(g, out, consts, K, k, s);
    case 4: return (int)launch<4>(g, out, consts, K, k, s);
    case 6: return (int)launch<6>(g, out, consts, K, k, s);
    case 8: return (int)launch<8>(g, out, consts, K, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
