// Expander SpMV over Montgomery words: y = A x for one ragged-CSR level of
// the Brakedown (SDIG) encoding, with the gather fused into the kernel.
//
// Replaces the TPU's Pallas kernel `spmv_mont` (lcpc_tpu/ops/spmv_pallas.py,
// `_build_kernel`/`_spmv_fn`, pallas_call at line 180) together with the
// `jnp.take` gather that feeds it (lcpc_tpu/encodings/brakedown.py,
// `_apply_mat_device`).  The TPU needed a fixed slot count, so it walks a
// padded CSR over a materialized (K, W, r, n) gather block; here every
// output row has exactly its own nonzeros and the x rows are read in place.
//
//   y[c, r] = (sum_{k in row c} vals[k] * x[cols[k], r]) * R^-1 mod p
//
// Layouts (int32 storage of packed 32-bit words, word i = limbs 2i | 2i+1):
//   x       (n_in, R, W32)   -- the packed codeword buffer of encode_rows:
//                               one (element, r) is W32*4 contiguous bytes
//   row_ptr (n_out + 1)      -- nonzeros of output c: row_ptr[c] .. [c+1]
//   cols    (nnz)            -- input index of each nonzero
//   vals    (nnz, W32)       -- Montgomery value of each nonzero
//   y       (n_out, R, W32)
//
// Work mapping: S = 2^log_s lanes (adjacent in a warp) own one (c, r); lane
// s takes nonzeros row_ptr[c] + s + j*S.  The wrapper picks S per launch
// (ops/spmv.py: split_lanes) so that small levels and r = 2 still put a
// few waves of warps on the card.  All R*S lanes of one output load the same cols/vals words (one
// broadcast transaction per warp), and each lane gathers W32*4 bytes of its
// x row with 16-byte loads.  The loop is software-pipelined in registers:
// the next nonzero's value and x words, and the column index after that,
// are in flight while the current product is accumulated, which breaks the
// col -> x dependent-load chain.
//
// Arithmetic: each k's W32 x W32 word product is added into a carry-save
// accumulator with PTX carry chains.  For every word v[i], one chain of
// mad.lo.cc / madc.hi.cc adds v[i] times every other word of x (x[0],
// x[2], .. or x[1], x[3], ..: their lo/hi pairs tile the chain without
// overlap) into W32 accumulator words, and addc counts the chain's carry
// out in a separate word; the products at even positions go to e[], the
// odd ones to o[].  ptxas turns each lo/hi pair into ONE IMAD.WIDE.U32(.X)
// with the carry in and out in predicates, so a k costs W32^2 wide
// multiply-adds and 2*W32 carry counts -- 1 + 2/W32 instructions per
// 32x32 -> 64 product, with no carry propagation, before the loop's loads,
// index arithmetic and the register moves ptxas adds.  Measured with
// cuobjdump -sass on the built library (nvcc 12.8, sm_90a; chip_smoke.py
// phase 2 prints it): the W32 = 8 k loop, unrolled to two nonzeros, is 314
// instructions for 128 wide products, 2.45 per product (128 IMAD.WIDE.U32
// and .X, 32 carry counts, 97 moves, 57 loads and loop arithmetic).  After
// the loop the carry-save words are folded into
// 2*W32 + 2 words, the S lanes add theirs with warp shuffles (a full carry
// chain per step), and one word-serial Montgomery reduction and a
// conditional-subtract chain over power-of-two multiples of p (bound
// kmax*p/R + 3 for the level's longest row, the reference's max_mult) run
// once per output.  The result is the unique residue < p, so it matches the
// 16-bit-limb reference bit for bit (16*W == 32*W32: same R).
//
// What bounds it on an H100 (chip_smoke.py and scripts/sweep_spmv_lanes.py
// measure it; numbers in PERF.md): the integer multiply-add issue.  Per
// nonzero and r the kernel gathers one 32-byte x sector and does W32^2 wide
// products.  At the 2^23 ft255 commit (r = 36) pointing every gather at one
// L1-resident element takes the gathers' HBM traffic away but only ~5% of
// the time, so the k loop's IMAD pipe binds: the W32^2 IMAD.WIDE, the carry
// counts and the register moves ptxas adds (chip_smoke.py prints the SASS
// count per wide product).  At r = 2 the work is small and latency binds
// (13 dependent launches of 5 us and more), which the split over S lanes
// shortens.  An int8 tensor-core digit product is the route past the IMAD
// pipe.
//
// The row body (row_product) and its accumulator live in spmv.cuh, shared
// with the small commit's kernel (commit_small.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "spmv.cuh"

namespace {

using namespace spmv;  // the row body, the accumulator, the word loads (spmv.cuh)

// One thread (or lane) per output (c, r): spmv.cuh's row_product
template <int W>
__global__ void __launch_bounds__(128, 4)
spmv_mont_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ cols, const int32_t* __restrict__ vals,
                 int32_t* __restrict__ y, const uint32_t* __restrict__ consts,
                 int n_out, int R, int log_s) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int c, r;
  uint32_t res[W];
  if (row_product<W, lcpc::LoadNc>(tid, x, row_ptr, cols, vals, consts, n_out, R, log_s, c,
                                   r, res))
    store_words<W>(y + ((size_t)c * R + r) * W, res);
}

template <int W>
cudaError_t launch(const int32_t* x, const int32_t* row_ptr, const int32_t* cols,
                   const int32_t* vals, int32_t* y, const uint32_t* consts, int n_out,
                   int R, int log_s, cudaStream_t stream) {
  const long long n = ((long long)n_out * R) << log_s;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  spmv_mont_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      x, row_ptr, cols, vals, y, consts, n_out, R, log_s);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of CUDA device `device` with 2^log_s lanes per
// (output, r); returns the cudaError_t of the launch (0 on success).
extern "C" int lcpc_spmv_mont(const int32_t* x, const int32_t* row_ptr,
                              const int32_t* cols, const int32_t* vals, int32_t* y,
                              const uint32_t* consts, int w32, int n_out, int R,
                              int log_s, int device, void* stream) {
  if ((long long)n_out * R == 0) return 0;
  if (log_s < 0 || log_s > 5) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch<2>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    case 4: return (int)launch<4>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    case 6: return (int)launch<6>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    case 8: return (int)launch<8>(x, row_ptr, cols, vals, y, consts, n_out, R, log_s, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
