// The four-step NTT's two DFT steps on the u8 tensor cores (ops/mxu_ntt.py:
// MxuNtt, the route the Ligero encode takes where encodings/ligero.py:
// ntt_route says "mxu").
//
// Replaces lcpc_tpu's `MxuNtt` (lcpc_tpu/ops/mxu_ntt.py:401): its int8
// digit convolutions `_conv_digits` (:371), the separated base-2^7
// Montgomery reduction `ReducePlan` (:91) with its Toeplitz matmuls
// `_matmul_toep` (:385) and carries `_carry7` (:348), and the twiddle
// product between the two steps; XLA-fused, not a Pallas kernel.  For a
// transform of n = A B points (MxuNttPlan: A, B, the nonzero input
// channels A_nz = in_len / B), one kernel template, launched twice:
//
//   STEP 1: z[r, u, j]        = tw[j, u] sum_{i < A_nz} K1[u, i] x[r, i B + j]
//   STEP 3: out[r, u B + v]   = sum_{j < B} K2[v, j] z[r, u, j]
//
// Each is a product of NR "row" elements (the data: STEP 1 x's columns j,
// STEP 3 z's rows u) with NCOL "column" elements (the constants: STEP 1
// K1's rows u, STEP 3 K2's rows v) over a contraction of C elements.  An
// element is D = 4 W bytes (W 32-bit words, little-endian).  lcpc_tpu's MXU
// took signed 7-bit digits; Hopper's tensor cores take u8 x u8 -> s32, so
// the digits are the elements' bytes and the digit convolution is a
// Toeplitz product:
//
//   Q[(row, s), col] = sum_c sum_dx X_{row,c}[s - dx] K_{col,c}[dx]   (u8 MMA)
//   S[row, col]      = sum_{s < 2D - 1} Q[(row, s), col] 2^(8 s)
//
// with s, the anti-diagonal, an MMA row: the data's side is the Toeplitz
// operand (rows (row, s), SR = 2D - 1 rounded up to 16 of them an
// element), built in the A fragments from each element's bytes reversed in
// a zero-padded shared-memory slot (one funnel shift a register); the
// constants' side is their bytes as they are (ldmatrix).  The anti-
// diagonal sums come out of the MMA whole (no fold), each below
// 2^32 while C D <= 65,536: longer contractions run in chunks of that
// many bytes, their sums met in shared memory.  S, below C R^2, is reduced
// once (mont.cuh's reduce_wide: two Montgomery reductions and a subtract,
// S R^-2 mod p).  The constants carry the factor that makes that the wanted
// form: K1, and K2 of the Montgomery plan, hold w^e R^2 mod p (Montgomery
// limbs in give Montgomery values out), the canonical plan's K2 w^e R
// (canonical values out: lcpc_tpu's R^-1 folded into k2).  Canonical words
// in (verify's proof rows) leave every step's value canonical; STEP 3's
// store then multiplies by R^2 where Montgomery limbs are wanted (lconv),
// and takes Montgomery values out of Montgomery form where hash words are
// wanted (wconv).
//
// What takes the role of each piece of lcpc_tpu's: the constants' byte
// tables are built once on the host (MxuNttPlan.device_tables: (NCOL, CP,
// D) bytes, CP = C rounded up to a stage) and streamed in by cp.async;
// `_to7` is STEP 1's loading threads, which put each element's words of x
// byte-reversed into its slot (STEP 3's z is stored reversed by STEP 1, so
// its slots fill by cp.async); `_conv_digits` and the Toeplitz matmuls are
// mma.sync.m16n8k32 u8 over a block tile of BR x 64 outputs (4 warps, each
// PW rows x 64 columns); `_carry7` is the assembly of S from the 2D - 1
// sums (a thread an output, through shared memory) and `ReducePlan` is
// reduce_wide; `_from7` and the twiddle `ops.mul` are STEP 1's store (one
// CIOS product by tw); STEP 3's store writes limbs (W 16-bit limbs as
// int32, (2W, R, n)) and canonical hash words ((R W, n), ntt_forward's
// layouts), a warp's lanes along consecutive v.
//
// What bounds it on an H100: the u8 multiply-adds, SR D of them an output
// and contraction element (2D - 1 needed: the Toeplitz operand's zeros
// double the D^2 of a plain digit product), at 989.4e12/s; the Ligero 2^23
// ft255 commit's transform (R = 256, n = 2^17, A_nz = 128, B = 256) is
// 1.32e13 digit products, 13.3 ms at that rate, against the ladder's 4.4 ms
// bound (csrc/ntt_mont.cu).  Beside them the epilogue's wide products and
// the operands' traffic from L2: each block re-reads the constants of its
// 64 columns and the data of its BR rows.  mma.sync and cp.async, no wgmma,
// no TMA.

#include "mont.cuh"

namespace {

using namespace lcpc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;            // column elements a block (and a warp)
constexpr int kChunkBytes = 1 << 16; // contraction bytes whose sums stay below 2^32

template <int W>
struct Dft {
  static constexpr int D = 4 * W;                       // bytes (digits) an element
  static constexpr int SR = (2 * D - 1 + 15) / 16 * 16; // anti-diagonal rows an element
  static constexpr int MTP = SR / 16;                   // m16 tiles an element
  static constexpr int PW = 64 / SR > 0 ? 64 / SR : 1;  // row elements a warp
  static constexpr int BR = kWarps * PW;                // row elements a block
  static constexpr int MT = PW * MTP;                   // m16 tiles a warp
  static constexpr int NT = kCols / 8;                  // n8 tiles a warp
  static constexpr int CS = D >= 24 ? 8 : 256 / D;      // contraction elements a stage
  static constexpr int KS = CS * D;                     // contraction bytes a stage
  static constexpr int BRS = KS + 16;                   // bytes a constants row in smem
  // a slot: element digit d at byte OFF - d, zeros around; OFF - D + 1 is
  // 16-aligned and OFF >= SR - 1 so every window's bytes lie in the slot
  static constexpr int OFF = (SR - 1 - (D - 1) + 15) / 16 * 16 + D - 1;
  static constexpr int ST = (OFF + D + 4 + 15) / 16 * 16;  // bytes a slot
  static constexpr int A_STAGE = BR * CS * ST;             // the slots of a stage
  static constexpr int B_STAGE = kCols * BRS;              // the constants of a stage
  static constexpr int PIPE = 2 * (A_STAGE + B_STAGE);
  static constexpr int DS = kCols + 8;                     // words a row of the dump
  static constexpr int DUMP = kWarps * PW * SR * DS * 4;
  static constexpr int PART = kWarps * PW * kCols * (2 * W + 1) * 4;  // chunk partial sums
  static constexpr int MAIN = PIPE > DUMP ? PIPE : DUMP;
  static constexpr int SMEM = MAIN + PART;
  static constexpr int TASKS = (BR * CS * W + kThreads - 1) / kThreads;  // STEP 1 words a thread
  static_assert(OFF >= SR - 1 && (OFF - D + 1) % 16 == 0 && KS % 32 == 0, "slot layout");
  static_assert(PW * SR <= 64 && MT * 16 == PW * SR, "warp tile");
};

struct DftArgs {
  const uint8_t* tbl;    // the constants: (NCOL, cp, D) bytes, zero from C on
  long long cp;
  const int32_t* x;      // STEP 1: word w of element m of row r at x + w s_w + r s_r + m s_m
  long long s_w, s_r, s_m;
  long long k;           // STEP 1: elements of a row that exist (m >= k reads 0)
  long long sc, sq;      // STEP 1: element (c, row) is m = c sc + row sq
  int limbs;             // STEP 1: the word axis holds 16-bit limbs: word w = limb 2w | 2w+1 << 16
  const uint8_t* z;      // STEP 3: (R, NR, C, D) bytes, each element's bytes reversed
  int NR, NCOL, C, R;
  int chunk;             // contraction elements a chunk (a multiple of CS, chunk D <= 2^16)
  const int32_t* tw;     // STEP 1: (NR, NCOL, W) Montgomery words
  uint8_t* zout;         // STEP 1: (R, NCOL, NR, D) bytes out, each element's bytes reversed
  int32_t* lout;         // STEP 3: (2W, R, NR NCOL) limbs out, or null
  int32_t* wout;         // STEP 3: (R W, NR NCOL) canonical hash words out, or null
  int lconv, wconv;      // STEP 3: limbs times R (to_mont); words from_mont
  const uint32_t* consts;  // p | n0 | R^2 mod p | ... (ops/mont_dot.py field_consts)
};

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 8) bytes global -> shared, zero-filled past `valid` bytes (0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 16-byte tiles: lane l gives row l % 8 of tile l / 8; d[j] is
// word l % 4 of row l / 4 of tile j
__device__ __forceinline__ void ldmatrix4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_addr(p)));
}

// d[16 x 8] += A[16 x 32] B[32 x 8], u8 x u8 -> s32 (A row-major: a[0] row
// l/4, k 4 (l%4) .. + 3; a[1] row + 8; a[2], a[3] k + 16; B column-major:
// b[0] column l/4, k 4 (l%4) .. + 3; b[1] k + 16)
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int W>
__device__ __forceinline__ uint32_t load_word(const DftArgs& a, long long at, int w) {
  if (a.limbs)
    return ((uint32_t)__ldg(a.x + at + (2 * w) * a.s_w) & 0xFFFFu) |
           ((uint32_t)__ldg(a.x + at + (2 * w + 1) * a.s_w) << 16);
  return (uint32_t)__ldg(a.x + at + w * a.s_w);
}

// STEP 1's row slots of one stage: task e = (row, c, w), row fastest; word
// w of x's element (c, row), 0 where it does not exist
template <int W>
__device__ __forceinline__ void step1_fetch(const DftArgs& a, uint32_t (&v)[Dft<W>::TASKS],
                                            int row0, int c0, long long xrow) {
  using T = Dft<W>;
#pragma unroll
  for (int i = 0; i < T::TASKS; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int rl = e % T::BR, cl = (e / T::BR) % T::CS, w = e / (T::BR * T::CS);
    const int row = row0 + rl, c = c0 + cl;
    const long long m = (long long)c * a.sc + (long long)row * a.sq;
    v[i] = (e < T::BR * T::CS * W && row < a.NR && c < a.C && m < a.k)
               ? load_word<W>(a, xrow + m * a.s_m, w) : 0u;
  }
}

template <int W>
__device__ __forceinline__ void step1_store(uint8_t* slots, const uint32_t (&v)[Dft<W>::TASKS]) {
  using T = Dft<W>;
#pragma unroll
  for (int i = 0; i < T::TASKS; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= T::BR * T::CS * W) break;
    const int rl = e % T::BR, cl = (e / T::BR) % T::CS, w = e / (T::BR * T::CS);
    // digits 4w .. 4w + 3 at bytes OFF - 4w - 3 .. OFF - 4w, reversed
    *reinterpret_cast<uint32_t*>(slots + (rl * T::CS + cl) * T::ST + T::OFF - 3 - 4 * w) =
        __byte_perm(v[i], 0, 0x0123);
  }
}

// STEP 3's row slots of one stage by cp.async: z's reversed elements
// (row, c0 + cl), zero-filled where they do not exist
template <int W>
__device__ __forceinline__ void step3_fetch(const DftArgs& a, uint8_t* slots, int row0, int c0,
                                            long long r) {
  using T = Dft<W>;
  constexpr int PIECE = T::D % 16 == 0 ? 16 : 8;
  constexpr int PIECES = T::D / PIECE;
  for (int e = threadIdx.x; e < T::BR * T::CS * PIECES; e += kThreads) {
    const int pc = e % PIECES, cl = (e / PIECES) % T::CS, rl = e / (PIECES * T::CS);
    const int row = row0 + rl, c = c0 + cl;
    const bool ok = row < a.NR && c < a.C;
    const uint8_t* src = ok ? a.z + (((r * a.NR + row) * a.C + c) * T::D + pc * PIECE) : a.z;
    uint8_t* dst = slots + (rl * T::CS + cl) * T::ST + T::OFF - T::D + 1 + pc * PIECE;
    if (PIECE == 16) cp_async16(dst, src, ok ? 16 : 0);
    else cp_async8(dst, src, ok ? 8 : 0);
  }
}

// the constants of one stage: KS bytes of each of the block's columns
template <int W>
__device__ __forceinline__ void table_fetch(const DftArgs& a, uint8_t* bs, int col0, int c0) {
  using T = Dft<W>;
  constexpr int SEGS = T::KS / 16;
  for (int e = threadIdx.x; e < kCols * SEGS; e += kThreads) {
    const int seg = e % SEGS, cl = e / SEGS;
    const int col = col0 + cl;
    const bool ok = col < a.NCOL && (long long)c0 * T::D + seg * 16 < a.cp * T::D;
    const uint8_t* src = ok ? a.tbl + ((long long)col * a.cp * T::D + (long long)c0 * T::D +
                                       seg * 16) : a.tbl;
    cp_async16(bs + cl * T::BRS + seg * 16, src, ok ? 16 : 0);
  }
}

template <int W, int STEP>
__global__ void __launch_bounds__(kThreads, 2)
mxu_dft_kernel(const DftArgs a) {
  using T = Dft<W>;
  extern __shared__ __align__(16) uint8_t smem[];
  // stage b's row slots at a_st + b A_STAGE, its constants at b_st + b B_STAGE
  uint8_t* const a_st = smem;
  uint8_t* const b_st = smem + 2 * T::A_STAGE;
  uint32_t* const part = reinterpret_cast<uint32_t*>(smem + T::MAIN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the block's tile: column tiles fastest, so the blocks in flight share
  // their rows' data
  const long long n_ct = (a.NCOL + kCols - 1) / kCols, n_rt = (a.NR + T::BR - 1) / T::BR;
  long long bid = blockIdx.x;
  const int col0 = (int)(bid % n_ct) * kCols;
  bid /= n_ct;
  const int row0 = (int)(bid % n_rt) * T::BR;
  const long long r = bid / n_rt;
  const long long xrow = r * a.s_r;
  // a register's window: bytes OFF - s + dx .. + 3 of its slot, s = row g
  // of the tile; the shift is the same for every window of this thread
  const int sh = 8 * ((T::OFF - g) & 3);
  const int n_chunks = (a.C + a.chunk - 1) / a.chunk;

  uint32_t acc[T::MT][T::NT][4];
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int cb = ch * a.chunk, ce = min(a.C, cb + a.chunk);
    const int n_st = (ce - cb + T::CS - 1) / T::CS;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    // the slots' zeros (the last chunk's dump lay over them)
    __syncthreads();
    for (int e = tid; e < 2 * T::A_STAGE / 16; e += kThreads)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    uint32_t xv[T::TASKS];
    table_fetch<W>(a, b_st, col0, cb);
    if (STEP == 1) {
      step1_fetch<W>(a, xv, row0, cb, xrow);
      step1_store<W>(a_st, xv);
    } else {
      step3_fetch<W>(a, a_st, row0, cb, r);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int st = 0; st < n_st; ++st) {
      const int buf = st & 1, c0 = cb + st * T::CS;
      const bool next = st + 1 < n_st;
      if (next) {  // the next stage's loads, in flight during this one's products
        table_fetch<W>(a, b_st + (buf ^ 1) * T::B_STAGE, col0, c0 + T::CS);
        if (STEP == 1) step1_fetch<W>(a, xv, row0, c0 + T::CS, xrow);
        else step3_fetch<W>(a, a_st + (buf ^ 1) * T::A_STAGE, row0, c0 + T::CS, r);
        cp_async_commit();
      }
      const uint8_t* as = a_st + buf * T::A_STAGE + warp * T::PW * T::CS * T::ST;
      const uint8_t* bs = b_st + buf * T::B_STAGE;
#pragma unroll
      for (int kk0 = 0; kk0 < T::KS; kk0 += 32) {
        uint32_t bf[T::NT][2];
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np) {
          const int j = lane >> 3;
          uint32_t d[4];
          ldmatrix4(d, bs + ((2 * np + (j >> 1)) * 8 + (lane & 7)) * T::BRS + kk0 + 16 * (j & 1));
          bf[2 * np][0] = d[0];
          bf[2 * np][1] = d[1];
          bf[2 * np + 1][0] = d[2];
          bf[2 * np + 1][1] = d[3];
        }
        uint32_t af[T::MT][4];
#pragma unroll
        for (int pl = 0; pl < T::PW; ++pl)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = kk0 + 4 * t + 16 * h, c = kk / T::D, dx = kk % T::D;
            const uint8_t* base = as + (pl * T::CS + c) * T::ST + T::OFF + dx - g;
            const uint8_t* wb = base - ((T::OFF - g) & 3);  // 4-aligned
#pragma unroll
            for (int mt = 0; mt < T::MTP; ++mt)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const uint8_t* p = wb - 16 * mt - 8 * i;
                af[pl * T::MTP + mt][i + 2 * h] = __funnelshift_r(ld32(p), ld32(p + 4), sh);
              }
          }
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) mma_u8(acc[mt][nt], af[mt], bf[nt]);
      }
      if (next) {
        if (STEP == 1) step1_store<W>(a_st + (buf ^ 1) * T::A_STAGE, xv);
        cp_async_wait_all();
      }
      __syncthreads();
    }

    // the sums to this warp's dump (rows (element, s), 64 columns), then a
    // lane an output: S = sum_s Q_s 2^(8 s), 2W + 1 words
    uint32_t* dump = reinterpret_cast<uint32_t*>(smem) + warp * T::PW * T::SR * T::DS;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int row = mt * 16 + g, col = nt * 8 + 2 * t;
        *reinterpret_cast<uint2*>(dump + row * T::DS + col) =
            make_uint2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<uint2*>(dump + (row + 8) * T::DS + col) =
            make_uint2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncwarp();
    const bool last = ch + 1 == n_chunks;
    const Field<W> f(a.consts);
    for (int o = lane; o < T::PW * kCols; o += 32) {
      const int pl = o / kCols, cl = o % kCols;
      const int row = row0 + warp * T::PW + pl, col = col0 + cl;
      if (row >= a.NR || col >= a.NCOL) continue;
      unsigned long long wc[2 * W + 1];
#pragma unroll
      for (int i = 0; i <= 2 * W; ++i) wc[i] = 0;
      const uint32_t* q = dump + pl * T::SR * T::DS + cl;
#pragma unroll
      for (int s = 0; s < 2 * T::D - 1; ++s) {
        const unsigned long long v = (unsigned long long)q[s * T::DS] << (8 * (s & 3));
        wc[s >> 2] += (uint32_t)v;
        wc[(s >> 2) + 1] += v >> 32;
      }
      uint32_t* pp = part + ((warp * T::PW + pl) * kCols + cl) * (2 * W + 1);
      if (ch > 0) {
#pragma unroll
        for (int i = 0; i <= 2 * W; ++i) wc[i] += pp[i];
      }
      uint32_t v[2 * W + 1];
      unsigned long long c = 0;
#pragma unroll
      for (int i = 0; i <= 2 * W; ++i) {
        const unsigned long long x = wc[i] + c;
        v[i] = (uint32_t)x;
        c = x >> 32;
      }
      if (!last) {
#pragma unroll
        for (int i = 0; i <= 2 * W; ++i) pp[i] = v[i];
        continue;
      }
      uint32_t res[W];
      reduce_wide<W>(res, v, f, a.consts, false);  // S R^-2 mod p
      if (STEP == 1) {
        uint32_t tw[W], zr[W];
        const int32_t* tp = a.tw + ((long long)row * a.NCOL + col) * W;
#pragma unroll
        for (int w = 0; w < W; ++w) tw[w] = (uint32_t)__ldg(tp + w);
        f.mul(zr, res, tw);
        uint32_t* zp = reinterpret_cast<uint32_t*>(
            a.zout + ((r * a.NCOL + col) * a.NR + row) * T::D);
#pragma unroll
        for (int w = 0; w < W; ++w) zp[w] = __byte_perm(zr[W - 1 - w], 0, 0x0123);
      } else {
        const long long n = (long long)a.NR * a.NCOL, at = (long long)row * a.NCOL + col;
        if (a.lout) {
          uint32_t lv[W];
          if (a.lconv) {
            uint32_t r2[W];
#pragma unroll
            for (int w = 0; w < W; ++w) r2[w] = __ldg(a.consts + W + 1 + w);
            f.mul(lv, res, r2);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) lv[w] = res[w];
          }
          int32_t* lp = a.lout + r * n + at;
          const long long plane = (long long)a.R * n;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            lp[(2 * w) * plane] = (int32_t)(lv[w] & 0xFFFFu);
            lp[(2 * w + 1) * plane] = (int32_t)(lv[w] >> 16);
          }
        }
        if (a.wout) {
          uint32_t wv[W];
          if (a.wconv) {
            f.from_mont(wv, res);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) wv[w] = res[w];
          }
          int32_t* wp = a.wout + r * W * n + at;
#pragma unroll
          for (int w = 0; w < W; ++w) wp[w * n] = (int32_t)wv[w];
        }
      }
    }
  }
}

template <int W, int STEP>
cudaError_t launch(const DftArgs& a, cudaStream_t s) {
  using T = Dft<W>;
  const long long blocks = (long long)a.R * ((a.NR + T::BR - 1) / T::BR) *
                           ((a.NCOL + kCols - 1) / kCols);
  if (blocks >= (1LL << 31) || a.chunk % T::CS || (long long)a.chunk * T::D > kChunkBytes ||
      a.cp % T::CS || a.cp < a.C)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mxu_dft_kernel<W, STEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  mxu_dft_kernel<W, STEP><<<(unsigned)blocks, kThreads, T::SMEM, s>>>(a);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_step(int step, const DftArgs& a, cudaStream_t s) {
  return step == 1 ? launch<W, 1>(a, s) : launch<W, 3>(a, s);
}

}  // namespace

// One DFT step of MxuNtt (step 1 or 3; arguments as DftArgs, pointers as
// void*); returns the launch's cudaError_t.  Refused (cudaErrorInvalidValue)
// without a kernel launch: an unknown step or W, a chunk that is no whole
// number of stages or past 2^16 bytes, cp not a whole number of stages
// covering C, a missing operand or output.
extern "C" int lcpc_mxu_dft(int step, int w32, const void* tbl, long long cp, int NR, int NCOL,
                            int C, int chunk, const void* x, long long s_w, long long s_r,
                            long long s_m, int limbs, long long k, long long sc, long long sq,
                            const void* z, const void* tw, void* zout, void* lout, void* wout,
                            int lconv, int wconv, const void* consts, int R, int device,
                            void* stream) {
  const DftArgs a{(const uint8_t*)tbl, cp, (const int32_t*)x, s_w, s_r, s_m, k, sc, sq, limbs,
                  (const uint8_t*)z, NR, NCOL, C, R, chunk, (const int32_t*)tw,
                  (uint8_t*)zout, (int32_t*)lout, (int32_t*)wout, lconv, wconv,
                  (const uint32_t*)consts};
  if ((step != 1 && step != 3) || NR < 1 || NCOL < 1 || C < 1 || R < 1 || chunk < 1 || !tbl ||
      !consts || (step == 1 && (!x || !tw || !zout)) ||
      (step == 3 && (!z || (!lout && !wout))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch_step<2>(step, a, s);
    case 4: return (int)launch_step<4>(step, a, s);
    case 6: return (int)launch_step<6>(step, a, s);
    case 8: return (int)launch_step<8>(step, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
