// Expander SpMV over Montgomery limbs: y = A x for one padded-CSR level of
// the Brakedown (SDIG) encoding, with the gather fused into the kernel.
//
// Replaces the TPU's Pallas kernel `spmv_mont` (lcpc_tpu/ops/spmv_pallas.py,
// `_build_kernel`/`_spmv_fn`, pallas_call at line 180) together with the
// `jnp.take` gather that feeds it (lcpc_tpu/encodings/brakedown.py,
// `_apply_mat_device`).  The TPU version materializes the gathered operand
// block g (K, W, r, n) in HBM in 1 GB chunks and walks a sequential
// (n, r, k) grid with VMEM scratch accumulators; here each thread owns one
// output element (c, r), loads its own column indices and reads the x rows
// directly, so the k loop runs inside the thread and nothing is staged.
//
//   y[c, :, r] = (sum_k vals[k, :, c] * x[cols[k, c], :, r]) * R^-1 mod p
//
// Layouts (int32 storage of 16-bit Montgomery limbs, limb index w):
//   x    (n_in, W, R)    -- the column-major codeword layout of encode_rows
//   cols (K, n_out)      -- padded-CSR input indices, pad slots index 0
//   vals (K, W, n_out)   -- Montgomery values, pad slots hold 0
//   y    (n_out, W, R)
//
// Arithmetic: limb pairs are repacked into W32 = W/2 32-bit words, and the
// K products of 32x32 -> 64-bit words accumulate lazily in 2*W32 64-bit
// columns (low and high halves split, so a column stays below
// 2^33 * W32 * K).  One carry-normalize, one word-serial Montgomery
// reduction and a conditional-subtract chain over power-of-two multiples of
// p (bound K*p/R + 3, the reference's max_mult) run once per output.  The
// result is the unique residue < p, so it matches the 16-bit-limb reference
// bit for bit although the limb width differs (16*W == 32*W32: same R).
//
// What bounds it on an H100: each output reads K gathered x rows of W*4
// bytes for its r, i.e. sum over levels of K*n_out*W*R*4 bytes through L2
// (threads of one output row share each 32-byte sector, and an input row is
// reused by every output that references it), and does K*W32^2 wide
// products.  At the 2^23 ft255 commit (W32 = 8, r = 36) the products bound
// it: counted at the CUDA-core int32 multiply rate they take ~3.5x longer
// than moving the level's bytes once (chip_smoke.py prints both per level).
// The design therefore keeps every accumulator and the reduction in
// registers (no shared memory, no spills), and reads each index and value
// once per (k, c), broadcast across the r threads of that output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// consts layout (uint32): p[W32] | n0 (-p^-1 mod 2^32) | n_mult |
//                         n_mult multiples of p, descending, W32+1 words each
template <int W32>
__global__ void __launch_bounds__(256)
spmv_mont_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ vals, int32_t* __restrict__ y,
                 const uint32_t* __restrict__ consts, int K, int n_out, int R) {
  constexpr int W = 2 * W32;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)n_out * R) return;
  const int c = (int)(tid / R);
  const int r = (int)(tid - (long long)c * R);

  uint64_t acc[2 * W32];
#pragma unroll
  for (int i = 0; i < 2 * W32; ++i) acc[i] = 0;

  const size_t xrow = (size_t)W * R;
  for (int k = 0; k < K; ++k) {
    const int col = __ldg(cols + (size_t)k * n_out + c);
    const int32_t* vp = vals + (size_t)k * W * n_out + c;
    const int32_t* xp = x + (size_t)col * xrow + r;
    uint32_t v[W32], xv[W32];
#pragma unroll
    for (int i = 0; i < W32; ++i) {
      v[i] = (uint32_t)__ldg(vp + (size_t)(2 * i) * n_out) |
             ((uint32_t)__ldg(vp + (size_t)(2 * i + 1) * n_out) << 16);
      xv[i] = (uint32_t)__ldg(xp + (size_t)(2 * i) * R) |
              ((uint32_t)__ldg(xp + (size_t)(2 * i + 1) * R) << 16);
    }
#pragma unroll
    for (int i = 0; i < W32; ++i) {
#pragma unroll
      for (int j = 0; j < W32; ++j) {
        const uint64_t prod = (uint64_t)v[i] * xv[j];
        acc[i + j] += (uint32_t)prod;
        acc[i + j + 1] += prod >> 32;
      }
    }
  }

  // carry-normalize to 32-bit words; two spare words for the reduction
  uint32_t u[2 * W32 + 2];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 2 * W32; ++i) {
    const uint64_t s = acc[i] + carry;
    u[i] = (uint32_t)s;
    carry = s >> 32;
  }
  u[2 * W32] = (uint32_t)carry;
  u[2 * W32 + 1] = 0;

  uint32_t p[W32];
#pragma unroll
  for (int i = 0; i < W32; ++i) p[i] = __ldg(consts + i);
  const uint32_t n0 = __ldg(consts + W32);
  const int n_mult = (int)__ldg(consts + W32 + 1);
  const uint32_t* mult = consts + W32 + 2;

  // word-serial Montgomery reduction: u += m_i * p * 2^(32 i), i < W32
#pragma unroll
  for (int i = 0; i < W32; ++i) {
    const uint32_t m = u[i] * n0;
    uint64_t cy = 0;
#pragma unroll
    for (int j = 0; j < W32; ++j) {
      const uint64_t s = (uint64_t)m * p[j] + u[i + j] + cy;
      u[i + j] = (uint32_t)s;
      cy = s >> 32;
    }
#pragma unroll
    for (int j = i + W32; j < 2 * W32 + 2; ++j) {
      const uint64_t s = (uint64_t)u[j] + cy;
      u[j] = (uint32_t)s;
      cy = s >> 32;
    }
  }

  // value (V + M p) / R < (K p / R + 1) p: W32 + 1 words
  uint32_t res[W32 + 1];
#pragma unroll
  for (int i = 0; i <= W32; ++i) res[i] = u[W32 + i];

  for (int q = 0; q < n_mult; ++q) {
    const uint32_t* mq = mult + q * (W32 + 1);
    uint32_t d[W32 + 1];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i <= W32; ++i) {
      const uint64_t s = (uint64_t)res[i] - __ldg(mq + i) - borrow;
      d[i] = (uint32_t)s;
      borrow = (uint32_t)(s >> 63);
    }
    if (!borrow) {
#pragma unroll
      for (int i = 0; i <= W32; ++i) res[i] = d[i];
    }
  }

  int32_t* yp = y + (size_t)c * W * R + r;
#pragma unroll
  for (int i = 0; i < W32; ++i) {
    yp[(size_t)(2 * i) * R] = (int32_t)(res[i] & 0xFFFFu);
    yp[(size_t)(2 * i + 1) * R] = (int32_t)(res[i] >> 16);
  }
}

template <int W32>
cudaError_t launch(const int32_t* x, const int32_t* cols, const int32_t* vals,
                   int32_t* y, const uint32_t* consts, int K, int n_out, int R,
                   cudaStream_t stream) {
  const long long n = (long long)n_out * R;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  spmv_mont_kernel<W32><<<(unsigned)blocks, threads, 0, stream>>>(
      x, cols, vals, y, consts, K, n_out, R);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of CUDA device `device`; returns the cudaError_t of
// the launch (0 on success).
extern "C" int lcpc_spmv_mont(const int32_t* x, const int32_t* cols,
                              const int32_t* vals, int32_t* y,
                              const uint32_t* consts, int w32, int K,
                              int n_out, int R, int device, void* stream) {
  if ((long long)n_out * R == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch<2>(x, cols, vals, y, consts, K, n_out, R, s);
    case 4: return (int)launch<4>(x, cols, vals, y, consts, K, n_out, R, s);
    case 6: return (int)launch<6>(x, cols, vals, y, consts, K, n_out, R, s);
    case 8: return (int)launch<8>(x, cols, vals, y, consts, K, n_out, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
