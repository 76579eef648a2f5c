// Modular matrix product over Montgomery words: the prover's collapse, the
// direct column evaluation and the verifier's column check.
//
// Replaces the XLA-fused contractions of lcpc_tpu: `FieldOps.collapse_canon`
// and `collapse_words` (lcpc_tpu/ops/limbs.py:375, 421), `MxuCollapse`
// (`_banded_collapse_kernel`, `_collapse_fns`; ops/mxu_prove.py:86, 128, 184)
// and `MxuColumnEval` (`_eval_fns`, `_eval_chunking`; ops/mxu_prove.py:235,
// 258, 357); none is a Pallas kernel.  Both compute
//
//   out[a, b] = (sum_k X[a, k] Y[k, b]) R^-2 mod p     ("canonical")
//   out[a, b] = (sum_k X[a, k] Y[k, b]) R^-1 mod p     ("mont")
//
// for X, Y Montgomery elements (x R, y R) of W 32-bit words, R = 2^(32 W):
// the canonical form is the plain value of sum x y (what the collapse and
// the column check compare), the Montgomery form that of an opened codeword
// column (column c of a Reed-Solomon row is the row at w^bitrev(c): Y is the
// power table of csrc/power_table.cu).  Any X, Y below R are taken: a
// verifier's untrusted column words need not be reduced.  Each output's
// exact sum S < K R^2 is reduced once: two Montgomery reductions take it
// below 2p, one subtract to canonical, one Montgomery product by R^2 mod p
// to the Montgomery form.
//
// Three kernels:
//
// thin (A <= 2 rows below thin_tc's measured crossover, ops/mont_dot.py:
//   route: the sums of partials, Brakedown's 36-row collapse, dots of one
//   column; Y as words).  A thread per output column b, both rows in its
//   registers, the rows' X elements staged through shared memory, Y read
//   by each thread from device memory (neighbouring threads, neighbouring
//   columns).
//   Lazy accumulation on the CUDA cores: 2W words of product columns plus
//   W + 1 carry counters; a product x y adds W rows x_i y, the even-j and
//   the odd-j products of a row each one PTX carry chain over adjacent
//   word pairs, which ptxas fuses into one IMAD.WIDE.U32(.X) per
//   32 x 32 -> 64 product: W^2 wide products and 2W adds a product.  Bound
//   by those products on the CUDA cores.
//
// thin_tc (A <= 2 rows against many columns: every prove's collapse, the
//   2 tensors against the coefficient block; Y as words or limbs, read in
//   place).  The tile kernel's u8 GEMM (below) with the roles swapped:
//   Y's byte digits are wgmma's register operand, M = its (column, digit)
//   rows, and x's digit planes (N = 64: the 2 rows' D digits, zero past
//   2D) the shared-memory operand, built once a block from x's words.  A
//   block is two warpgroups walking tiles of CB = 2 (64 / W) columns (a
//   grid-stride loop); its 64 quads each own a column pair and a word w,
//   so a warpgroup's 4 wgmma.m64n64k32 tiles are the digits 4 w + d
//   (d < 4) of its columns: the 64 rows of a tile are ordered digit by
//   digit, and at W = 6 (CB = 20) 4 quads pad.  A stage is 32 rows of the
//   tile's columns, every word, copied by TMA (16-byte strides) or, for
//   any other strides (Brakedown's (W, 36, 235,173) limbs: a row is 940,692
//   bytes), a word at a time by cp.async, in place either way; 4 stages
//   in flight on mbarriers.  A thread takes 4 rows of one word of its 2
//   columns and one 4 x 4 byte transpose (PRMT) gives its 4 digits' A
//   fragments: no operand in shared memory is written by the threads
//   while wgmmas run, so no proxy fence stalls them.  After a tile's k
//   range the fold: each digit tile's accumulators through shared memory,
//   each thread summing one (word, output) row into a window of 35
//   anti-diagonal sums, the windows into Q_s by shared atomics (32 bits
//   hold them for ranges of at most 2,048 k-steps), each output's exact
//   sum S to scratch; the block reduces its outputs together after its
//   last tile.  Bound by its bytes: the 2^29 collapse reads 17.2 GB of
//   words (5.13 ms at 3.35 TB/s); its 2 K B D^2 byte products take 1.11.
//   Measured on an H100 (scripts/time_thin_dot.py): 5.76 ms, 89% of the
//   bytes bound (the CUDA-core thin kernel: 13.8 ms).
//
// tile (the column evaluation: coefficient rows x the power table; Y as
//   byte-digit planes).  lcpc_tpu runs this contraction on its matrix unit
//   as int8 digit convolutions in base 2^7 (the MXU is signed); Hopper's
//   wgmma takes u8 x u8 -> s32, so here a value's digits are simply its
//   D = 4W bytes, x = sum_i x_i 2^(8 i), and the product is one u8 GEMM
//   over digit planes:
//
//     P[(a, i), (b, j)] = sum_k x_i[a, k] y_j[k, b]     (M' = A D, N' = B D)
//     S[a, b]           = sum_{i, j} P[(a, i), (b, j)] 2^(8 (i + j))
//
//   A block is two warpgroups; warpgroup g takes RA = 64 / D coefficient
//   rows (64 digit rows) and the block PB = 256 / D points (256 digit
//   columns), and issues wgmma.m64n256k32.s32.u8.u8 per 32 k-steps, A from
//   registers, B from shared memory.  Per stage of 128 k-steps, thread 0
//   issues two TMA copies, each as soon as its buffer is free: the table's
//   256 x 128-byte tile (the planes laid out k-tile by k-tile, as
//   power_table writes them, so the tile is one contiguous 32 KB slab;
//   128-byte swizzle, the layout the wgmma descriptor reads; 4 stages) and
//   the coefficients' own words (PA rows x W words, or 2W 16-bit limbs, x
//   128 k; never transposed or copied in device memory; up to 6 stages).
//   Each lane builds its A fragment from the raw words: byte i mod 4 of
//   word i / 4 is digit i, and 3 PRMTs pack a digit's 4 neighbouring k.
//   There is no A tile in shared memory, so no generic-to-async proxy
//   fence stalls the wgmmas in flight.  mbarriers carry the copies' bytes
//   and the stages' releases.
//   An s32 accumulator holds at most floor((2^31 - 1) / 255^2) = 33,025
//   byte products, so a block takes at most 2^15 k-steps: the wrapper
//   splits K into ranges of at most 2^15 (more where the grid would not
//   fill the card), each block folds its planes once, at its end, through
//   shared memory (the anti-diagonal sums Q_s = sum_{i+j=s} P_ij < D 2^31,
//   then S = sum_s Q_s 2^(8 s) with carries) and reduces S.
//
//   What bounds it on an H100 (700 W): the byte products, A K B D^2
//   multiply-adds at 1,979 T int8 operations/s (2 a multiply-add); the
//   2^29 column evaluation is 2,048 x 262,144 x 189 x 1,024 = 1.04e14 of
//   them, ~105 ms (the CUDA cores' wide products bounded the former IMAD
//   kernel at 775 ms).  The bytes are far below; the traffic from L2 into
//   the SMs is not (each coefficient tile is read again for every tile of
//   points, each table tile for every tile of rows: ~1.2 TB at 2^29), so
//   the grid runs the row tiles of a chunk of kChunk point tiles together:
//   a chunk's table slabs stay in L2 while its row tiles stream through.
//   Measured (scripts/time_column_eval.py): 46% of the tensor-core bound at
//   2^29; what holds it there is in PERF.md.
//
// Where a grid would not fill the card the wrapper splits K: each split
// writes canonical partials, and a second, thin launch sums them (X the
// constant R^2 mod p, so sum_s partial_s R^2 R^-2 = sum_s partial_s).
//
// Operands are strided: element (i, k) word w of an operand at
// ptr + w s_w + i s_0 + k s_1, in int32 storage; with `limbs` set the word
// axis holds 16-bit limbs and word w is limb 2w | limb 2w+1 << 16.  So the
// callers' limb-major (W, ...) limb tensors, packed (W/2, ...) word
// tensors and transposes are read in place (the tile kernel's X by TMA:
// unit stride along k, the other strides multiples of 4).  The tile
// kernel's Y is the (KT, B, D, 128) u8 digit-plane tensor: [t, b, j, e] is
// byte j of Y[128 t + e, b].

#include <cuda.h>

#include "mont.cuh"

namespace {

using namespace lcpc;

constexpr int kThinThreads = 128;
constexpr int kThinBK = 32;  // k-steps of X staged a round (thin)

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

// ---- the tile kernel: byte-digit planes on the tensor cores ----------------------

constexpr int kTcThreads = 256;  // two warpgroups: 8 warps, up to 255 registers a thread
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kKT = 128;         // k-steps a stage: one 128-byte swizzle row
constexpr int kBStages = 4;      // the table's tiles in flight
constexpr int kRawStages = 6;    // the coefficients' raw words in flight (at most)
constexpr int kARows = 128;      // digit rows (a, i) a block, 64 a warpgroup
constexpr int kBRows = 256;      // digit rows (b, j) a block: wgmma's N
constexpr int kBTile = kBRows * kKT;
constexpr int kRawOff = kBStages * kBTile;
constexpr int kRawBytes = 98304;
constexpr int kFoldK = 1 << 15;  // k-steps a block at most (s32 sums of byte products)
constexpr int kAccStride = kBRows + 8;  // words a row of the staged accumulator
constexpr int kChunk = 2;  // point tiles a raster chunk (timed at 2^29: 2 of 1..24 fastest)

template <int W>
struct Tc {
  static constexpr int D = 4 * W;                    // digits (bytes) an element
  static constexpr int RA = 64 / D;                  // coefficient rows a warpgroup
  static constexpr int PA = 2 * RA;                  // coefficient rows a block
  static constexpr int PB = kBRows / D;              // points a block
  static constexpr int NOUT = PA * PB;
  static constexpr int NQ = 2 * D - 1;               // anti-diagonals s = i + j
  static constexpr int FOLD = kARows * kAccStride * 4 + NOUT * NQ * 8;
  static constexpr int TILES = kRawOff + kRawBytes;
  static constexpr int BARS = TILES > FOLD ? TILES : FOLD;
  static constexpr int SMEM = BARS + 8 * (2 * kBStages + 2 * kRawStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// an arrival that also expects `bytes` of asynchronous copies on `bar`
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// a TMA copy of the box at (c0, c1, c2) of the tensor map into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}
// wait for the phase of parity `parity` to complete; a wait past ~2^36
// cycles traps (a fault, not a hang)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 36)) __trap();
  } while (!done);
}

// the shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d[64 x 256] += A[64 x 32] B[256 x 32]^T, u8 x u8 -> s32: A from registers
// (the m16n8k32 fragment per warp: a[0] row l/4, k 4 (l%4) .. + 3; a[1] row
// + 8; a[2], a[3] k + 16), B from shared memory
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

template <int W>
__global__ void __launch_bounds__(kTcThreads, 1)
mont_dot_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap planes, Out out,
                   const uint32_t* __restrict__ consts, long long A, long long K, long long B,
                   long long k_split, int mont, int limbs) {
  using T = Tc<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw_base & 1023)) & 1023);  // 1,024-aligned tiles
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bfull0 = sbase + T::BARS, bempty0 = bfull0 + 8 * kBStages;
  const uint32_t rfull0 = bempty0 + 8 * kBStages, rempty0 = rfull0 + 8 * kRawStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  // the tile: point tiles in chunks of kChunk, a chunk's fastest, then the
  // row tiles (the blocks that run together share row and point tiles)
  long long ta, tb;
  {
    const long long n_tb = (B + T::PB - 1) / T::PB, n_ta = (A + T::PA - 1) / T::PA;
    const long long chunk = blockIdx.x / (kChunk * n_ta), r = blockIdx.x % (kChunk * n_ta);
    const long long w = n_tb - chunk * kChunk < kChunk ? n_tb - chunk * kChunk : kChunk;
    ta = r / w;
    tb = chunk * kChunk + r % w;
  }
  const long long a0 = ta * T::PA, b0 = tb * T::PB;
  const long long k0 = (long long)blockIdx.z * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  const int nt = (int)((k1 - k0 + kKT - 1) / kKT);
  // the raw words of a stage: PA rows x W words (2W limbs) x 128 k, int32
  const int raw_stage = T::PA * (limbs ? 2 * W : W) * kKT * 4;
  const int ahead = kRawBytes / raw_stage < kRawStages ? kRawBytes / raw_stage : kRawStages;
  uint32_t acc[128];  // this warpgroup's 64 x 256 accumulators
  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(bfull0 + 8 * s, 1);          // the TMA's bytes
      mbar_init(bempty0 + 8 * s, kTcWarps);  // each warp, its wgmma done
    }
    for (int s = 0; s < kRawStages; ++s) {
      mbar_init(rfull0 + 8 * s, 1);
      mbar_init(rempty0 + 8 * s, kTcWarps);  // each warp, its fragments read
    }
    fence_mbar_init();
  }
  __syncthreads();

  {
    // warpgroup g owns digit rows 64 g .. + 63 (its RA coefficient rows),
    // warp q of it rows 16 q .. + 15.  A lane's wgmma
    // A fragment is two digit rows (l/4 and l/4 + 8 of its warp) at 4 + 4
    // neighbouring k a 32-step: each 4 bytes are byte `sel` of 4
    // neighbouring raw words (element (a, k) word or limb i / bpe holds
    // digit i), read from the raw stage as 16 bytes and packed by 3 PRMTs;
    // the 4 lanes of a row quad read the same words (broadcast)
    const int lane = tid & 31, row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int bpe = limbs ? 2 : 4;  // digit bytes a raw int32
    int off[2];
    uint32_t sel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows `row` and `row + 8`
      const int r = row + 8 * h - wg * 64, ar = r / T::D, i = r % T::D;
      const int al = ar < T::RA ? wg * T::RA + ar : -1;  // -1: a padding row
      off[h] = al < 0 ? -1 : (((i / bpe) * T::PA + al) * kKT + 4 * (lane & 3)) * 4;
      const uint32_t b = i % bpe;
      sel[h] = b | ((4 + b) << 4);
    }
    // thread 0 also issues the TMA copies: stage t's raw coefficient words
    // and its table tile, each once its buffer is free
    auto copy_raw = [&](int t) {
      const int r = t % ahead;
      mbar_arrive_tx(rfull0 + 8 * r, raw_stage);
      tma_load_3d(sbase + kRawOff + r * raw_stage, &xmap, (int)(k0 + (long long)t * kKT),
                  (int)a0, 0, rfull0 + 8 * r);
    };
    auto copy_b = [&](int t) {
      const int s = t % kBStages;
      mbar_arrive_tx(bfull0 + 8 * s, kBTile);
      tma_load_3d(sbase + s * kBTile, &planes, 0, (int)(b0 * T::D), (int)(k0 / kKT) + t,
                  bfull0 + 8 * s);
    };
    if (tid == 0) {
      for (int t = 0; t < ahead && t < nt; ++t) copy_raw(t);
      for (int t = 0; t < kBStages && t < nt; ++t) copy_b(t);
    }
    auto build = [&](uint32_t (&frag)[4][4], int t) {  // tile t's fragments, its raw stage freed
      const int r = t % ahead;
      mbar_wait(rfull0 + 8 * r, (t / ahead) & 1);
      const uint8_t* raw = smem + kRawOff + r * raw_stage;
#pragma unroll
      for (int kk = 0; kk < kKT / 32; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a[q]: row h = q & 1, k + 16 (q >> 1)
          const int h = q & 1;
          uint32_t v = 0;
          if (off[h] >= 0) {
            const uint4 x = *(const uint4*)(raw + off[h] + (32 * kk + 16 * (q >> 1)) * 4);
            v = __byte_perm(__byte_perm(x.x, x.y, sel[h]), __byte_perm(x.z, x.w, sel[h]),
                            0x5410);
          }
          frag[kk][q] = v;
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(rempty0 + 8 * r);
      if (tid == 0 && t + ahead < nt) {
        mbar_wait(rempty0 + 8 * r, (t / ahead) & 1);
        copy_raw(t + ahead);
      }
    };
    // one stage: tile t's wgmmas from `cur`, then tile t + 1's fragments
    // into `nxt` once tile t - 1's wgmmas (which read `nxt`) are done
    auto stage = [&](int t, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
      const int s = t % kBStages;
      mbar_wait(bfull0 + 8 * s, (t / kBStages) & 1);
      const uint64_t db = sw128_desc(sbase + s * kBTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKT / 32; ++kk) wgmma_u8(acc, cur[kk], db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(nxt);
      if (t > 0) {
        const int sp = (t - 1) % kBStages;
        if (lane == 0) mbar_arrive(bempty0 + 8 * sp);
        if (tid == 0 && t - 1 + kBStages < nt) {
          mbar_wait(bempty0 + 8 * sp, ((t - 1) / kBStages) & 1);
          copy_b(t - 1 + kBStages);
        }
      }
      if (t + 1 < nt) build(nxt, t + 1);
    };
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    uint32_t f0[4][4], f1[4][4] = {};
    build(f0, 0);
    for (int t = 0; t < nt; t += 2) {
      stage(t, f0, f1);
      if (t + 1 < nt) stage(t + 1, f1, f0);
    }
    wgmma_wait<0>();
    fence_regs(f0);
    fence_regs(f1);
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_acc(acc[i]);
  }
  __syncthreads();  // every stage consumed: the tiles' memory is free
  // the fold: the accumulators into shared memory (row (a, i), column (b,
  // j)), the anti-diagonal sums Q_s of each output, then its wide sum
  {
    uint32_t* sacc = (uint32_t*)smem;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2), c0 = 2 * (tid & 3);
#pragma unroll
    for (int g = 0; g < 32; ++g) {
      *(uint2*)(sacc + r0 * kAccStride + 8 * g + c0) = make_uint2(acc[4 * g], acc[4 * g + 1]);
      *(uint2*)(sacc + (r0 + 8) * kAccStride + 8 * g + c0) =
          make_uint2(acc[4 * g + 2], acc[4 * g + 3]);
    }
  }
  __syncthreads();
  const uint32_t* sacc = (const uint32_t*)smem;
  uint64_t* qs = (uint64_t*)(smem + kARows * kAccStride * 4);
  for (int e = tid; e < T::NOUT * T::NQ; e += kTcThreads) {
    const int o = e / T::NQ, s = e % T::NQ;
    const int oa = o / T::PB;
    const int rb = (oa / T::RA) * 64 + (oa % T::RA) * T::D, cb = (o % T::PB) * T::D;
    const int i0 = s < T::D ? 0 : s - T::D + 1, i1 = s < T::D ? s : T::D - 1;
    uint64_t sum = 0;
    for (int i = i0; i <= i1; ++i) sum += sacc[(rb + i) * kAccStride + cb + s - i];
    qs[e] = sum;  // < D 2^31
  }
  __syncthreads();
  const Field<W> f(consts);
  for (int o = tid; o < T::NOUT; o += kTcThreads) {
    const long long a = a0 + o / T::PB, b = b0 + o % T::PB;
    if (a >= A || b >= B) continue;
    const uint64_t* q = qs + o * T::NQ;
    uint32_t v[2 * W + 1];
    uint64_t c = 0;
#pragma unroll
    for (int m = 0; m < 2 * W; ++m) {  // word m: Q_{4m .. 4m+3} and the carry, < 2^61
      uint64_t t = c;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * m + u < T::NQ) t += q[4 * m + u] << (8 * u);
      v[m] = (uint32_t)t;
      c = t >> 32;
    }
    v[2 * W] = (uint32_t)c;  // S < 2^15 R^2
    uint32_t r[W];
    reduce_wide<W>(r, v, f, consts, mont);
    store<W>(out, blockIdx.z, a, b, r);
  }
}

// ---- the thin path on the tensor cores: A <= 2 rows against words --------------

constexpr int kTtThreads = 256;  // two warpgroups: 64 quads, each a column pair x a word
constexpr int kTtWarps = kTtThreads / 32;
constexpr int kTtN = 64;         // wgmma N: the x digit rows (a, i), zero past 2D
constexpr int kTtStages = 4;     // stages of Y in flight
constexpr int kTtStaging = 128 * kTtN * 4;  // the fold's staged accumulators
constexpr int kSmemMax = 232448;  // dynamic shared memory a block at most
constexpr int kTtMaxK = 2048;     // k-steps a range at most: the fold's 32-bit sums

template <int W, bool LIMBS>
struct Tt {
  static constexpr int D = 4 * W;                  // digits (bytes) an element
  static constexpr int CPB = 64 / W;               // column pairs a tile
  static constexpr int CB = 2 * CPB;               // columns a tile
  static constexpr int NQ = 2 * D - 1;             // anti-diagonals s = i + j
  static constexpr int NOUT = 2 * CB;              // outputs (a, b) a tile
  static constexpr int UNITS = LIMBS ? 2 * W : W;  // int32 units an element of Y
  static constexpr int STAGE = UNITS * 32 * CB * 4;  // a stage: 32 rows of a tile, every unit
  static constexpr int AR = (kTtN + D - 1) / D;    // x rows the digit rows span (2 used)
  static constexpr int WIDE = 2 * W + 1;           // words of an output's exact sum
};

// d[64 x 64] (+)= A[64 x 32] B[64 x 32]^T, u8 x u8 -> s32, A from registers
// (the fragment of wgmma_u8), B from shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_u8_n64(uint32_t (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}
// an arrival on `bar` once this thread's earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// word w of element (i, k) of an operand (limbs: limb 2w | limb 2w+1 << 16)
__device__ __forceinline__ uint32_t load_word(const Operand& o, long long i, long long k, int w) {
  const int32_t* p = o.ptr + i * o.s_0 + k * o.s_1;
  if (o.limbs)
    return __byte_perm((uint32_t)__ldg(p + (2 * w) * o.s_w),
                       (uint32_t)__ldg(p + (2 * w + 1) * o.s_w), 0x5410);
  return (uint32_t)__ldg(p + w * o.s_w);
}

template <int W, bool LIMBS>
__global__ void __launch_bounds__(kTtThreads, 1)
mont_dot_thin_tc_kernel(const __grid_constant__ CUtensorMap ymap, Operand X, Operand Y, Out out,
                        int32_t* __restrict__ wide, const uint32_t* __restrict__ consts, int A,
                        long long K, long long B, long long k_split, int mont, int tma) {
  using T = Tt<W, LIMBS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw_base & 1023)) & 1023);  // 1,024-aligned planes
  const int kcp = (int)((k_split + kKT - 1) / kKT * kKT);          // planes' k, whole k-tiles
  const int ring_off = kTtN * kcp, stg_off = ring_off + kTtStages * T::STAGE;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + stg_off + kTtStaging, empty0 = full0 + 8 * kTtStages;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const long long k0 = (long long)blockIdx.y * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  const int nks = (int)((k1 - k0 + 31) / 32);  // k32 steps
  const long long n_tiles = (B + T::CB - 1) / T::CB;
  const int my_tiles = blockIdx.x < n_tiles
                           ? (int)((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) : 0;
  const int total = my_tiles * nks;  // stages (tile, k32 step) of this block
  if (tid == 0) {
    for (int s = 0; s < kTtStages; ++s) {
      mbar_init(full0 + 8 * s, tma ? 1 : kTtThreads);  // the TMA's bytes, or every thread's
      mbar_init(empty0 + 8 * s, kTtWarps);             // each warp, its fragments read
    }
    fence_mbar_init();
  }

  // x's digit planes for this K range, once: row n = a D + i holds byte i
  // of x[a, k] (zero for a >= A and past the range), k-tiles of 128 k in
  // the 128-byte swizzle the wgmma descriptor reads (16-byte chunk index
  // xor the row mod 8).  Within each 16 k the positions are transposed as
  // 4 x 4, position 4 c + u holding k = c + 4 u, the order in which the
  // fragments read Y's rows (below).  Written by generic stores, so the
  // async proxy that the wgmmas read through is fenced once.
  {
    const int kq_n = kcp / 4;
    for (int t = tid; t < T::AR * W * kq_n; t += kTtThreads) {
      const int kq = t % kq_n, w = (t / kq_n) % W, a = t / (kq_n * W);
      const long long kb = k0 + 16 * (kq >> 2) + (kq & 3);
      uint32_t v[4], o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long k = kb + 4 * u;
        v[u] = a < A && k < k1 ? load_word(X, a, k, w) : 0u;
      }
      transpose4(v, o);
      const int kk = (4 * kq) & (kKT - 1), tile = (4 * kq) / kKT;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int n = a * T::D + 4 * w + d;
        if (n < kTtN)
          *(uint32_t*)(smem + tile * kTtN * kKT + (n >> 3) * 1024 + (n & 7) * 128 +
                       ((((kk >> 4) ^ (n & 7)) << 4) | (kk & 15))) = o[d];
      }
    }
    fence_proxy_async();
    __syncthreads();
  }

  // stage g = (the block's tile g / nks, k32 step g % nks) into slot g %
  // kTtStages: Y's 32 rows x CB columns x every unit, [unit][row][column];
  // past B and this range the words are zero (TMA) or left stale
  // (cp.async): they meet zero planes or fold into outputs never stored.  By TMA, one thread; else every thread copies words
  // (any strides: Brakedown's odd row stride) and arrives when they land.
  auto produce = [&](int g) {
    const long long tile = blockIdx.x + (long long)(g / nks) * gridDim.x;
    const long long row0 = k0 + 32LL * (g % nks), col0 = tile * T::CB;
    const int slot = g % kTtStages;
    const uint32_t dst = sbase + ring_off + slot * T::STAGE, bar = full0 + 8 * slot;
    if (tma) {
      mbar_arrive_tx(bar, T::STAGE);
      tma_load_3d(dst, &ymap, (int)col0, (int)row0, 0, bar);
      return;
    }
#pragma unroll 1
    for (int e = tid; e < T::UNITS * 32 * T::CB; e += kTtThreads) {
      const int col = e % T::CB, r = (e / T::CB) % 32, unit = e / (32 * T::CB);
      if (row0 + r < k1 && col0 + col < B)  // else stale words: against zero planes or unread
        cp_async4(dst + 4 * e, Y.ptr + unit * Y.s_w + (row0 + r) * Y.s_0 + (col0 + col) * Y.s_1);
    }
    cp_async_arrive(bar);
  };
  // this thread's quad: word w of the column pair cp (padding quads past W
  // CPB, at W = 6, read slot 0's words: their rows are never folded)
  const int qg = tid >> 2;
  const int w = qg < W * T::CPB ? qg / T::CPB : 0, cp = qg < W * T::CPB ? qg % T::CPB : 0;
  // stage g's fragments: tile d (digit 4 w + d) of this warpgroup's 64
  // rows, a[2 h + e] = column 2 cp + e at positions 16 h + 4 c .. + 3,
  // which hold rows 16 h + c + 4 u (u < 4: neighbouring lanes read
  // neighbouring rows, two bank-free wavefronts a warp); the wgmma's row
  // l/4 is column e = 0, row l/4 + 8 column e = 1; one 4 x 4 byte
  // transpose of a column's 4 words gives its 4 digits.  Then the slot is
  // released and, once every warp has, refilled with stage g + kTtStages.
  auto build = [&](uint32_t (&frag)[4][4], int g) {
    const int slot = g % kTtStages;
    mbar_wait(full0 + 8 * slot, (g / kTtStages) & 1);
    const uint8_t* base = smem + ring_off + slot * T::STAGE + 8 * cp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t x0[4], x1[4], o0[4], o1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 16 * h + c + 4 * u;
        uint2 v = *(const uint2*)(base + ((LIMBS ? 2 * w : w) * 32 + r) * T::CB * 4);
        if (LIMBS) {
          const uint2 hi = *(const uint2*)(base + ((2 * w + 1) * 32 + r) * T::CB * 4);
          v.x = __byte_perm(v.x, hi.x, 0x5410);
          v.y = __byte_perm(v.y, hi.y, 0x5410);
        }
        x0[u] = v.x;
        x1[u] = v.y;
      }
      transpose4(x0, o0);
      transpose4(x1, o1);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        frag[d][2 * h] = o0[d];
        frag[d][2 * h + 1] = o1[d];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    if (g + kTtStages < total && (tma ? tid == 0 : true)) {
      mbar_wait(empty0 + 8 * slot, (g / kTtStages) & 1);
      produce(g + kTtStages);
    }
  };

  for (int g = 0; g < kTtStages && g < total; ++g)
    if (tma ? tid == 0 : true) produce(g);
  uint32_t acc[4][32];  // this warpgroup's 4 tiles of 64 rows x 64 digit columns
  uint32_t* stg = (uint32_t*)(smem + stg_off);
  // the fold's roles: thread (fw, fo), word fw of output fo = (fa, b = 2
  // cp + e), cp fastest (a warp's 8-lane phases read 8 rows of distinct
  // swizzle, bank-free); its staged row, that of quad fw CPB + cp
  const int fw = tid / T::NOUT, fo = tid % T::NOUT;
  const bool fold_live = fw < W;
  const int fa = fo / (2 * T::CPB), fq = fw * T::CPB + fo % T::CPB;
  const int frow = (fq >> 3) * 16 + (fq & 7) + 8 * ((fo / T::CPB) % 2);
  int g = 0;
  for (int m = 0; m < my_tiles; ++m) {
    const long long tile = blockIdx.x + (long long)m * gridDim.x;
    {
      // k32 step ks: the 4 tiles' wgmmas from `cur` (x's planes at k32 step
      // ks), then step ks + 1's fragments into `nxt` once step ks - 1's
      // wgmmas (which read `nxt`) are done
      auto step = [&](int ks, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
        const uint64_t db = sw128_desc(sbase + (ks >> 2) * kTtN * kKT) + 2 * (ks & 3);
        wgmma_fence();
#pragma unroll
        for (int d = 0; d < 4; ++d) wgmma_u8_n64(acc[d], cur[d], db, ks > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(nxt);
        ++g;
        if (ks + 1 < nks) build(nxt, g);
      };
      uint32_t f0[4][4], f1[4][4] = {};
      build(f0, g);
      for (int ks = 0; ks < nks; ks += 2) {
        step(ks, f0, f1);
        if (ks + 1 < nks) step(ks + 1, f1, f0);
      }
      wgmma_wait<0>();
      fence_regs(f0);
      fence_regs(f1);
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_acc(acc[d][i]);
    }
    // the fold, a tile d at a time: the accumulators into shared memory
    // (row: the wgmma row, column: the digit column (a, i) xor 8 (row mod
    // 8), bank-free both ways), then thread (word fw, output fo = (a, b))
    // adds the D values of its row, P[(b, 4 fw + d), (a, i)], into its
    // window win[d + i] of the anti-diagonal sums Q_{4 fw + d + i}; the
    // windows then go into each output's Q_s by shared-memory atomics.
    // Every sum fits 32 bits: a range of at most kTtMaxK k-steps gives
    // P < 2048 255^2 < 2^27 and Q_s < D 2^27 <= 2^32.
    uint32_t win[T::D + 3];
#pragma unroll
    for (int p = 0; p < T::D + 3; ++p) win[p] = 0;
    const int r0 = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int g8 = 0; g8 < 8; ++g8) {
        const int col = (8 * g8 + 2 * c) ^ ((r0 & 7) << 3);
        *(uint2*)(stg + r0 * kTtN + col) = make_uint2(acc[d][4 * g8], acc[d][4 * g8 + 1]);
        *(uint2*)(stg + (r0 + 8) * kTtN + col) =
            make_uint2(acc[d][4 * g8 + 2], acc[d][4 * g8 + 3]);
      }
      __syncthreads();
      if (fold_live) {
#pragma unroll
        for (int m4 = 0; m4 < T::D / 4; ++m4) {
          const uint4 v = *(const uint4*)(stg + frow * kTtN +
                                          ((fa * T::D + 4 * m4) ^ ((frow & 7) << 3)));
          win[d + 4 * m4] += v.x;
          win[d + 4 * m4 + 1] += v.y;
          win[d + 4 * m4 + 2] += v.z;
          win[d + 4 * m4 + 3] += v.w;
        }
      }
      __syncthreads();
    }
    uint32_t* qs = stg;
    for (int e = tid; e < T::NOUT * T::NQ; e += kTtThreads) qs[e] = 0;
    __syncthreads();
    if (fold_live) {
#pragma unroll
      for (int p = 0; p < T::D + 3; ++p) atomicAdd(qs + fo * T::NQ + 4 * fw + p, win[p]);
    }
    __syncthreads();
    // each output's exact sum S = sum_s Q_s 2^(8 s) into `wide`: the block
    // reduces its outputs together after its last tile, in parallel, not
    // one warp a tile here
    for (int o = tid; o < T::NOUT; o += kTtThreads) {
      const int a = o / (2 * T::CPB);
      const long long b = tile * T::CB + 2 * (o % T::CPB) + (o / T::CPB) % 2;
      if (a >= A || b >= B) continue;
      const uint32_t* qo = qs + o * T::NQ;
      int32_t* wo = wide + (((long long)blockIdx.y * T::WIDE) * A + a) * B + b;
      uint64_t cr = 0;
#pragma unroll
      for (int mm = 0; mm < 2 * W; ++mm) {  // word mm: Q_{4mm .. 4mm+3} and the carry
        uint64_t t = cr;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * mm + u < T::NQ) t += (uint64_t)qo[4 * mm + u] << (8 * u);
        wo[mm * A * B] = (int32_t)(uint32_t)t;
        cr = t >> 32;
      }
      wo[2 * W * A * B] = (int32_t)(uint32_t)cr;  // S < k_split R^2
    }
    __syncthreads();  // the sums read before the next tile's fold writes
  }
  // the block's outputs reduced: canonical (or Montgomery) residues of S
  __syncthreads();
  const Field<W> f(consts);
  for (int idx = tid; idx < my_tiles * T::NOUT; idx += kTtThreads) {
    const int o = idx % T::NOUT, a = o / (2 * T::CPB);
    const long long b = (blockIdx.x + (long long)(idx / T::NOUT) * gridDim.x) * T::CB +
                        2 * (o % T::CPB) + (o / T::CPB) % 2;
    if (a >= A || b >= B) continue;
    const int32_t* wo = wide + (((long long)blockIdx.y * T::WIDE) * A + a) * B + b;
    uint32_t v[2 * W + 1], r[W];
#pragma unroll
    for (int mm = 0; mm <= 2 * W; ++mm) v[mm] = (uint32_t)wo[mm * A * B];
    reduce_wide<W>(r, v, f, consts, mont);
    store<W>(out, blockIdx.y, a, b, r);
  }
}

template <int W>
cudaError_t launch_thin(const Operand& X, const Operand& Y, const Out& out,
                        const uint32_t* consts, long long A, long long K, long long B,
                        long long k_split, int n_split, int mont, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + kThinThreads - 1) / kThinThreads), (unsigned)n_split);
  if (A == 1)
    mont_dot_thin_kernel<W, 1><<<grid, kThinThreads, 0, stream>>>(X, Y, out, consts, 1, K, B,
                                                                  k_split, mont);
  else
    mont_dot_thin_kernel<W, 2><<<grid, kThinThreads, 0, stream>>>(X, Y, out, consts, 2, K, B,
                                                                  k_split, mont);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

template <int W>
cudaError_t launch_tc(const int32_t* x, long long xs_w, long long xs_a, int x_limbs,
                      const uint8_t* planes, long long kt, const Out& out, const uint32_t* consts,
                      long long A, long long K, long long B, long long k_split, int n_split,
                      int mont, cudaStream_t stream) {
  using T = Tc<W>;
  const long long ta = (A + T::PA - 1) / T::PA, tb = (B + T::PB - 1) / T::PB;
  if (ta * tb >= (1LL << 31) || B * T::D >= (1LL << 31) || kt >= (1LL << 31) ||
      A >= (1LL << 31) || K >= (1LL << 31))
    return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // X as (words or limbs) x A rows x K int32, read in boxes of PA rows x
  // 128 k, every word (zero past A and K)
  CUtensorMap xmap;
  const cuuint32_t lw = x_limbs ? 2 * W : W;
  const cuuint64_t xdims[3] = {(cuuint64_t)K, (cuuint64_t)A, lw};
  const cuuint64_t xstrides[2] = {(cuuint64_t)xs_a * 4, (cuuint64_t)xs_w * 4};
  const cuuint32_t xbox[3] = {kKT, T::PA, lw}, elem[3] = {1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, (void*)x, xdims, xstrides, xbox, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // the planes as kt k-tiles of (B D) rows of 128 bytes, read in boxes of
  // 256 rows in the 128-byte swizzle (rows past B D read as zero)
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)kKT, (cuuint64_t)(B * T::D), (cuuint64_t)kt};
  const cuuint64_t strides[2] = {(cuuint64_t)kKT, (cuuint64_t)(B * T::D * kKT)};
  const cuuint32_t box[3] = {kKT, kBRows, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)planes, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mont_dot_tc_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(ta * tb), 1, (unsigned)n_split);
  mont_dot_tc_kernel<W><<<grid, kTcThreads, T::SMEM, stream>>>(xmap, map, out, consts, A, K, B,
                                                               k_split, mont, x_limbs);
  return cudaGetLastError();
}

template <int W, bool LIMBS>
long long thin_tc_smem(long long k_split) {
  return 1024 + kTtN * ((k_split + kKT - 1) / kKT * kKT) + kTtStages * Tt<W, LIMBS>::STAGE +
         kTtStaging + 16 * kTtStages;
}

template <int W, bool LIMBS>
cudaError_t launch_thin_tc(const Operand& X, const Operand& Y, const Out& out, int32_t* wide,
                           const uint32_t* consts, long long A, long long K, long long B,
                           long long k_split, int n_split, int mont, int tma, int grid_x,
                           cudaStream_t stream) {
  using T = Tt<W, LIMBS>;
  const long long smem = thin_tc_smem<W, LIMBS>(k_split);
  const long long n_tiles = (B + T::CB - 1) / T::CB;
  if (smem > kSmemMax || n_tiles * ((k_split + 31) / 32) >= (1LL << 31) ||
      (tma && (K >= (1LL << 31) || B >= (1LL << 31))))
    return cudaErrorInvalidValue;
  // Y as units x K rows x B columns of int32, read in boxes of every unit x
  // 32 rows x CB columns (zero past B and K)
  CUtensorMap ymap = {};
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)K, (cuuint64_t)T::UNITS};
    const cuuint64_t strides[2] = {(cuuint64_t)Y.s_0 * 4, (cuuint64_t)Y.s_w * 4};
    const cuuint32_t box[3] = {T::CB, 32, T::UNITS}, elem[3] = {1, 1, 1};
    if (encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, (void*)Y.ptr, dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(mont_dot_thin_tc_kernel<W, LIMBS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)grid_x, (unsigned)n_split);
  mont_dot_thin_tc_kernel<W, LIMBS><<<grid, kTtThreads, smem, stream>>>(
      ymap, X, Y, out, wide, consts, (int)A, K, B, k_split, mont, tma);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_thin_tc_w(const Operand& X, const Operand& Y, const Out& out, int32_t* wide,
                             const uint32_t* consts, long long A, long long K, long long B,
                             long long k_split, int n_split, int mont, int tma, int grid_x,
                             cudaStream_t stream) {
  if (Y.limbs)
    return launch_thin_tc<W, true>(X, Y, out, wide, consts, A, K, B, k_split, n_split, mont,
                                   tma, grid_x, stream);
  return launch_thin_tc<W, false>(X, Y, out, wide, consts, A, K, B, k_split, n_split, mont,
                                  tma, grid_x, stream);
}

}  // namespace

// out[a, b] (+ split * os_split) = sum over k in split's range of X[a, k]
// Y[k, b], reduced (mont = 0: canonical, 1: Montgomery), for a < A <= 2,
// b < B, K split into n_split ranges of k_split; X element (a, k) word w at
// x + w xs_w + a xs_a + k xs_k (x_limbs: the word axis holds 16-bit limbs),
// Y element (k, b) likewise, out words int32: the thin kernel.  consts:
// p[w32] | n0 | r2[w32] | one[w32].  Returns the launch's cudaError_t (0 on
// success).
extern "C" int lcpc_mont_dot(const int32_t* x, long long xs_w, long long xs_a, long long xs_k,
                             int x_limbs, const int32_t* y, long long ys_w, long long ys_k,
                             long long ys_b, int y_limbs, int32_t* out, long long os_w,
                             long long os_a, long long os_b, long long os_split,
                             const uint32_t* consts, int w32, long long A, long long K,
                             long long B, long long k_split, int n_split, int mont, int device,
                             void* stream) {
  if (x == nullptr || y == nullptr || out == nullptr || consts == nullptr || A < 1 || A > 2 ||
      B < 1 || K < 1 || k_split < 1 || n_split < 1 || n_split > 65535 ||
      (long long)n_split * k_split < K || (long long)(n_split - 1) * k_split >= K ||
      K >= (1LL << 31) || (B + kThinThreads - 1) / kThinThreads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Operand X{x, xs_w, xs_a, xs_k, x_limbs}, Y{y, ys_w, ys_k, ys_b, y_limbs};
  const Out o{out, os_w, os_a, os_b, os_split};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_thin<2>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    case 4: return (int)launch_thin<4>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    case 6: return (int)launch_thin<6>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    case 8: return (int)launch_thin<8>(X, Y, o, consts, A, K, B, k_split, n_split, mont, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same product with Y as digit planes, on the tensor cores: planes
// (kt, B, 4 w32, 128) u8, [t, b, j, e] byte j of Y[128 t + e, b] (kt >= K /
// 128, the pointer 16-byte aligned); X element (a, k) word w at x + w xs_w +
// a xs_a + k (x_limbs: the word axis holds 16-bit limbs), x 16-byte aligned
// and xs_w, xs_a multiples of 4; any A >= 1.  k_split a multiple of 128, at
// most 2^15.
extern "C" int lcpc_mont_dot_planes(const int32_t* x, long long xs_w, long long xs_a,
                                    int x_limbs, const uint8_t* planes, long long kt,
                                    int32_t* out, long long os_w, long long os_a, long long os_b,
                                    long long os_split, const uint32_t* consts, int w32,
                                    long long A, long long K, long long B, long long k_split,
                                    int n_split, int mont, int device, void* stream) {
  if (x == nullptr || planes == nullptr || out == nullptr || consts == nullptr || A < 1 ||
      B < 1 || K < 1 || kt * kKT < K || ((uintptr_t)planes & 15) || ((uintptr_t)x & 15) ||
      xs_w % 4 || xs_a % 4 || k_split < 1 || k_split % kKT || k_split > kFoldK || n_split < 1 ||
      n_split > 65535 || (long long)n_split * k_split < K ||
      (long long)(n_split - 1) * k_split >= K)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Out o{out, os_w, os_a, os_b, os_split};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2:
      return (int)launch_tc<2>(x, xs_w, xs_a, x_limbs, planes, kt, o, consts, A, K, B, k_split,
                               n_split, mont, s);
    case 4:
      return (int)launch_tc<4>(x, xs_w, xs_a, x_limbs, planes, kt, o, consts, A, K, B, k_split,
                               n_split, mont, s);
    case 6:
      return (int)launch_tc<6>(x, xs_w, xs_a, x_limbs, planes, kt, o, consts, A, K, B, k_split,
                               n_split, mont, s);
    case 8:
      return (int)launch_tc<8>(x, xs_w, xs_a, x_limbs, planes, kt, o, consts, A, K, B, k_split,
                               n_split, mont, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The thin product on the tensor cores: the same operands and outputs as
// lcpc_mont_dot (A <= 2 rows, Y as words or limbs read in place), K split
// into n_split ranges of k_split, grid_x blocks a range, each taking every
// grid_x-th tile of columns; wide is scratch of n_split (2 w32 + 1) A B
// int32, the exact sums before their reduction.  tma = 1 reads Y by TMA:
// ys_b = 1, y 16-byte aligned, ys_w and ys_k multiples of 4; else by
// cp.async a word at a time (any strides).  The dynamic shared memory,
// 1,024 + 64 ceil(k_split / 128) 128 + 4 stages of 16,384 (limbs: 32,768)
// bytes + 32,832, must be at most 232,448 bytes.
extern "C" int lcpc_mont_dot_thin_tc(const int32_t* x, long long xs_w, long long xs_a,
                                     long long xs_k, int x_limbs, const int32_t* y,
                                     long long ys_w, long long ys_k, long long ys_b, int y_limbs,
                                     int32_t* out, long long os_w, long long os_a, long long os_b,
                                     long long os_split, int32_t* wide, const uint32_t* consts,
                                     int w32, long long A, long long K, long long B,
                                     long long k_split, int n_split, int mont, int tma,
                                     int grid_x, int device, void* stream) {
  if (x == nullptr || y == nullptr || out == nullptr || wide == nullptr || consts == nullptr ||
      A < 1 || A > 2 || B < 1 || K < 1 || k_split < 1 || k_split > kTtMaxK || n_split < 1 ||
      n_split > 65535 || (long long)n_split * k_split < K ||
      (long long)(n_split - 1) * k_split >= K || grid_x < 1 || grid_x > 65535 ||
      (tma && (ys_b != 1 || ((uintptr_t)y & 15) || (ys_w & 3) || (ys_k & 3))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Operand X{x, xs_w, xs_a, xs_k, x_limbs}, Y{y, ys_w, ys_k, ys_b, y_limbs};
  const Out o{out, os_w, os_a, os_b, os_split};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2:
      return (int)launch_thin_tc_w<2>(X, Y, o, wide, consts, A, K, B, k_split, n_split, mont,
                                      tma, grid_x, s);
    case 4:
      return (int)launch_thin_tc_w<4>(X, Y, o, wide, consts, A, K, B, k_split, n_split, mont,
                                      tma, grid_x, s);
    case 6:
      return (int)launch_thin_tc_w<6>(X, Y, o, wide, consts, A, K, B, k_split, n_split, mont,
                                      tma, grid_x, s);
    case 8:
      return (int)launch_thin_tc_w<8>(X, Y, o, wide, consts, A, K, B, k_split, n_split, mont,
                                      tma, grid_x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
