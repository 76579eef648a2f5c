// Modular matrix product over Montgomery words: the prover's collapse, the
// direct column evaluation and the verifier's column check.
//
// Replaces the XLA-fused contractions of lcpc_tpu: `FieldOps.collapse_canon`
// and `collapse_words` (lcpc_tpu/ops/limbs.py:375, 421), `MxuCollapse`
// (`_banded_collapse_kernel`, `_collapse_fns`; ops/mxu_prove.py:86, 128, 184)
// and `MxuColumnEval` (`_eval_fns`, `_eval_chunking`; ops/mxu_prove.py:235,
// 258, 357); none is a Pallas kernel.  The TPU routes contract int8 digit
// planes on the MXU; this kernel computes the same outputs directly:
//
//   out[a, b] = (sum_k X[a, k] Y[k, b]) R^-2 mod p     ("canonical")
//   out[a, b] = (sum_k X[a, k] Y[k, b]) R^-1 mod p     ("mont")
//
// for X, Y Montgomery elements (x R, y R) of W 32-bit words, R = 2^(32 W):
// the canonical form is the plain value of sum x y (what the collapse and
// the column check compare), the Montgomery form that of an opened codeword
// column (column c of a Reed-Solomon row is the row at w^bitrev(c): Y is the
// power table of csrc/power_table.cu).  Any X, Y below R are taken: a
// verifier's untrusted column words need not be reduced.
//
// Lazy accumulation.  Each output keeps the exact integer sum of its
// products: 2W words of product columns plus W + 1 carry counters (the sum
// stays below K R^2 < 2^(64 W + 31) for K < 2^31).  A product x y adds W
// rows x_i y: the even-j and the odd-j products of a row each form one PTX
// carry chain over adjacent word pairs (lo, hi), which ptxas fuses into one
// IMAD.WIDE.U32(.X) per 32 x 32 -> 64 product, and each chain's carry out
// goes to its counter: W^2 wide products and 2W adds a product.  The sum is
// reduced once per output: two Montgomery reductions take it below 2p, one
// subtract to canonical, one Montgomery product by R^2 mod p to the
// Montgomery form.
//
// Two shapes of work:
//   thin   A <= 2 rows (the collapse's T = 2 tensors, the verifier's rows):
//          a thread per output column b, both rows in its registers, the
//          rows' X elements staged through shared memory (every thread
//          reads the same ones), Y read by each thread from device memory
//          (neighbouring threads, neighbouring columns).
//   tile   A > 2 (the column evaluation: coefficient rows x the power
//          table): a 32 x 32 output tile a block, 16 x 16 threads of 2 x 2
//          outputs; X and Y tiles of 8 k-steps staged in shared memory, so
//          each element loaded from device memory feeds 32 outputs.
// Where the grid would not fill the card the wrapper splits K: each split
// writes canonical partials, and a second, thin launch sums them (X the
// constant R^2 mod p, so sum_s partial_s R^2 R^-2 = sum_s partial_s).
//
// Operands are strided: element (i, k) word w of an operand at
// ptr + w s_w + i s_0 + k s_1, in int32 storage; with `limbs` set the word
// axis holds 16-bit limbs and word w is limb 2w | limb 2w+1 << 16.  So the
// callers' limb-major (W, ...) limb tensors, packed (W/2, ...) word
// tensors and transposes are read in place.
//
// What bounds it on an H100 (700 W): the wide products, W^2 a multiply-add
// (64 at ft255), at 8.4 T/s (the 67 TFLOP/s fp32 lanes as 16.75 T IMADs/s,
// two a wide product).  The 2^29 column evaluation is 2,048 x 262,144 x 189
// x 64 = 6.5e12 of them, ~0.77 s; its bytes (17 GB of coefficients, 1.6 GB
// of table a 32-row tile row) are far below.  The route past the IMAD pipe
// is lcpc_tpu's int8 digit method on the tensor cores, left open.

#include "mont.cuh"

namespace {

using namespace lcpc;

constexpr int kThinThreads = 128;
constexpr int kThinBK = 32;  // k-steps of X staged a round (thin)
constexpr int kTileThreads = 256;
constexpr int kTile = 32;  // output tile (tile)
constexpr int kTileBK = 8;  // k-steps of X and Y staged a round (tile)

struct Operand {
  const int32_t* ptr;
  long long s_w, s_0, s_1;
  int limbs;
};

template <int W>
__device__ __forceinline__ void load_elem(uint32_t (&v)[W], const Operand& o, long long i,
                                          long long k) {
  const int32_t* p = o.ptr + i * o.s_0 + k * o.s_1;
  if (o.limbs) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      v[w] = ((uint32_t)__ldg(p + (2 * w) * o.s_w) & 0xFFFFu) |
             ((uint32_t)__ldg(p + (2 * w + 1) * o.s_w) << 16);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = (uint32_t)__ldg(p + w * o.s_w);
  }
}

// the exact sum: word columns at positions 0 .. 2W-1 and the carries into
// positions W .. 2W
template <int W>
struct Acc {
  uint32_t lo[2 * W];
  uint32_t cw[W + 1];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2 * W; ++i) lo[i] = 0;
#pragma unroll
    for (int i = 0; i <= W; ++i) cw[i] = 0;
  }

  // += x y: row i's even-j products at word pairs (i + j, i + j + 1) in one
  // carry chain (carry out into position i + W), its odd-j products in
  // another (carry out into position i + W + 1)
  __device__ __forceinline__ void mac(const uint32_t (&x)[W], const uint32_t (&y)[W]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      mad_pair_cc(lo[i], lo[i + 1], x[i], y[0]);
#pragma unroll
      for (int j = 2; j < W; j += 2) madc_pair_cc(lo[i + j], lo[i + j + 1], x[i], y[j]);
      cw[i] = addc(cw[i], 0);
      mad_pair_cc(lo[i + 1], lo[i + 2], x[i], y[1]);
#pragma unroll
      for (int j = 3; j < W; j += 2) madc_pair_cc(lo[i + j], lo[i + j + 1], x[i], y[j]);
      cw[i + 1] = addc(cw[i + 1], 0);
    }
  }
};

// W Montgomery reduction steps on the 2W + 1 words of v: v[W .. 2W] becomes
// (v + M p) / R for the M < R that zeroes the low W words
template <int W>
__device__ __forceinline__ void redc_wide(uint32_t (&v)[2 * W + 1], const Field<W>& f) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t m = v[i] * f.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t t = (uint64_t)m * f.p[j] + v[i + j] + c;
      v[i + j] = (uint32_t)t;
      c = t >> 32;
    }
#pragma unroll
    for (int j = i + W; j <= 2 * W; ++j) {
      const uint64_t t = (uint64_t)v[j] + c;
      v[j] = (uint32_t)t;
      c = t >> 32;
    }
  }
}

// the sum's residue: canonical (S R^-2 mod p) or, with `mont`, S R^-1 mod p
template <int W>
__device__ __forceinline__ void finish(uint32_t (&r)[W], const Acc<W>& a, const Field<W>& f,
                                       const uint32_t* __restrict__ consts, bool mont) {
  uint32_t v[2 * W + 1];
#pragma unroll
  for (int m = 0; m < W; ++m) v[m] = a.lo[m];
  uint64_t c = 0;
#pragma unroll
  for (int m = W; m < 2 * W; ++m) {
    const uint64_t t = (uint64_t)a.lo[m] + a.cw[m - W] + c;
    v[m] = (uint32_t)t;
    c = t >> 32;
  }
  v[2 * W] = a.cw[W] + (uint32_t)c;  // S < K R^2: the top word holds it
  redc_wide<W>(v, f);                 // v[W .. 2W] < K R + p
  uint32_t u[2 * W + 1];
#pragma unroll
  for (int m = 0; m <= W; ++m) u[m] = v[W + m];
#pragma unroll
  for (int m = W + 1; m <= 2 * W; ++m) u[m] = 0;
  redc_wide<W>(u, f);  // u[W .. 2W] < K + 1 + p < 2p
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t t = (uint64_t)u[W + i] - f.p[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = borrow ? u[W + i] : d[i];
  if (mont) {
    uint32_t r2[W], x[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      r2[i] = __ldg(consts + W + 1 + i);
      x[i] = r[i];
    }
    f.mul(r, x, r2);
  }
}

struct Out {
  int32_t* ptr;
  long long s_w, s_a, s_b, s_split;
};

template <int W>
__device__ __forceinline__ void store(const Out& o, int split, long long a, long long b,
                                      const uint32_t (&r)[W]) {
  int32_t* p = o.ptr + split * o.s_split + a * o.s_a + b * o.s_b;
#pragma unroll
  for (int w = 0; w < W; ++w) p[w * o.s_w] = (int32_t)r[w];
}

template <int W, int TA>
__global__ void __launch_bounds__(kThinThreads)
mont_dot_thin_kernel(Operand X, Operand Y, Out out, const uint32_t* __restrict__ consts, int A,
                     long long K, long long B, long long k_split, int mont) {
  __shared__ uint32_t xs[kThinBK][TA][W];
  const Field<W> f(consts);
  const long long b = (long long)blockIdx.x * kThinThreads + threadIdx.x;
  const long long bc = b < B ? b : B - 1;  // past the edge: a valid column, no store
  const long long k0 = (long long)blockIdx.y * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  Acc<W> acc[TA];
#pragma unroll
  for (int a = 0; a < TA; ++a) acc[a].zero();
  for (long long kb = k0; kb < k1; kb += kThinBK) {
    const int n = (int)(k1 - kb < kThinBK ? k1 - kb : kThinBK);
    __syncthreads();
    for (int e = threadIdx.x; e < n * TA; e += kThinThreads) {
      const int kk = e / TA, a = e % TA;
      uint32_t v[W];
      load_elem<W>(v, X, a < A ? a : 0, kb + kk);
#pragma unroll
      for (int w = 0; w < W; ++w) xs[kk][a][w] = v[w];
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < n; ++kk) {
      uint32_t y[W];
      load_elem<W>(y, Y, kb + kk, bc);
#pragma unroll
      for (int a = 0; a < TA; ++a) {
        uint32_t x[W];
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = xs[kk][a][w];
        acc[a].mac(x, y);
      }
    }
  }
  if (b >= B) return;
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    if (a >= A) break;
    uint32_t r[W];
    finish<W>(r, acc[a], f, consts, mont);
    store<W>(out, blockIdx.y, a, b, r);
  }
}

template <int W>
__global__ void __launch_bounds__(kTileThreads)
mont_dot_tile_kernel(Operand X, Operand Y, Out out, const uint32_t* __restrict__ consts,
                     long long A, long long K, long long B, long long k_split, int mont) {
  __shared__ uint32_t xs[kTileBK][W][kTile];
  __shared__ uint32_t ys[kTileBK][W][kTile];
  const Field<W> f(consts);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long a0 = (long long)blockIdx.y * kTile, b0 = (long long)blockIdx.x * kTile;
  const long long k0 = (long long)blockIdx.z * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  Acc<W> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j].zero();
  for (long long kb = k0; kb < k1; kb += kTileBK) {
    const int n = (int)(k1 - kb < kTileBK ? k1 - kb : kTileBK);
    __syncthreads();
    {
      // X: row r, step kk (neighbouring threads, neighbouring steps)
      const int r = threadIdx.x / kTileBK, kk = threadIdx.x % kTileBK;
      if (kk < n) {
        const long long a = a0 + r < A ? a0 + r : A - 1;
        uint32_t v[W];
        load_elem<W>(v, X, a, kb + kk);
#pragma unroll
        for (int w = 0; w < W; ++w) xs[kk][w][r] = v[w];
      }
      // Y: step kk, column c (neighbouring threads, neighbouring columns)
      const int kk2 = threadIdx.x / kTile, c = threadIdx.x % kTile;
      if (kk2 < n) {
        const long long b = b0 + c < B ? b0 + c : B - 1;
        uint32_t v[W];
        load_elem<W>(v, Y, kb + kk2, b);
#pragma unroll
        for (int w = 0; w < W; ++w) ys[kk2][w][c] = v[w];
      }
    }
    __syncthreads();
    for (int kk = 0; kk < n; ++kk) {
      uint32_t x0[W], x1[W], y0[W], y1[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        x0[w] = xs[kk][w][ty];
        x1[w] = xs[kk][w][ty + 16];
        y0[w] = ys[kk][w][tx];
        y1[w] = ys[kk][w][tx + 16];
      }
      acc[0][0].mac(x0, y0);
      acc[0][1].mac(x0, y1);
      acc[1][0].mac(x1, y0);
      acc[1][1].mac(x1, y1);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long a = a0 + ty + 16 * i, b = b0 + tx + 16 * j;
      if (a < A && b < B) {
        uint32_t r[W];
        finish<W>(r, acc[i][j], f, consts, mont);
        store<W>(out, blockIdx.z, a, b, r);
      }
    }
}

static_assert(kTileThreads == kTile * kTileBK, "one X and one Y element a thread a round");

template <int W>
cudaError_t launch(const Operand& X, const Operand& Y, const Out& out, const uint32_t* consts,
                   long long A, long long K, long long B, long long k_split, int n_split,
                   int mont, cudaStream_t stream) {
  if (A <= 2) {
    const dim3 grid((unsigned)((B + kThinThreads - 1) / kThinThreads), (unsigned)n_split);
    if (A == 1)
      mont_dot_thin_kernel<W, 1><<<grid, kThinThreads, 0, stream>>>(X, Y, out, consts, 1, K, B,
                                                                    k_split, mont);
    else
      mont_dot_thin_kernel<W, 2><<<grid, kThinThreads, 0, stream>>>(X, Y, out, consts, 2, K, B,
                                                                    k_split, mont);
  } else {
    const dim3 grid((unsigned)((B + kTile - 1) / kTile), (unsigned)((A + kTile - 1) / kTile),
                    (unsigned)n_split);
    mont_dot_tile_kernel<W><<<grid, kTileThreads, 0, stream>>>(X, Y, out, consts, A, K, B,
                                                               k_split, mont);
  }
  return cudaGetLastError();
}

}  // namespace

// out[a, b] (+ split * os_split) = sum over k in split's range of X[a, k]
// Y[k, b], reduced (mont = 0: canonical, 1: Montgomery), for a < A, b < B,
// K split into n_split ranges of k_split; X element (a, k) word w at
// x + w xs_w + a xs_a + k xs_k (x_limbs: the word axis holds 16-bit limbs),
// Y element (k, b) likewise, out words int32.  A <= 2 takes the thin
// kernel, else the tiled one.  consts: p[w32] | n0 | r2[w32] | one[w32].
// Returns the launch's cudaError_t (0 on success).
extern "C" int lcpc_mont_dot(const int32_t* x, long long xs_w, long long xs_a, long long xs_k,
                             int x_limbs, const int32_t* y, long long ys_w, long long ys_k,
                             long long ys_b, int y_limbs, int32_t* out, long long os_w,
                             long long os_a, long long os_b, long long os_split,
                             const uint32_t* consts, int w32, long long A, long long K,
                             long long B, long long k_split, int n_split, int mont, int device,
                             void* stream) {
  if (x == nullptr || y == nullptr || out == nullptr || consts == nullptr || A < 1 || B < 1 ||
      K < 1 || k_split < 1 || n_split < 1 || n_split > 65535 ||
      (long long)n_split * k_split < K || (long long)(n_split - 1) * k_split >= K ||
      K >= (1LL << 31) || (A > 2 && (A + kTile - 1) / kTile > 65535) ||
      (B + kThinThreads - 1) / kThinThreads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Operand X{x, xs_w, xs_a, xs_k, x_limbs}, Y{y, ys_w, ys_k, ys_b, y_limbs};
  const Out o{out, os_w, os_a, os_b, os_split};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch<2>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    case 4: return (int)launch<4>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    case 6: return (int)launch<6>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    case 8: return (int)launch<8>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
