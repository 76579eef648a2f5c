// The power table of the direct column evaluation: V[m, j] = g_j^m in
// Montgomery form, for m < K and the opened columns' points
// g_j = w^bitrev(c_j) (MxuColumnEval, ops/mxu_prove.py), so that an opened
// Reed-Solomon codeword column is the coefficient rows times V
// (csrc/mont_dot.cu).
//
// Replaces `_kernel_build_fns` (lcpc_tpu/ops/mxu_prove.py:319), XLA-fused,
// not Pallas: there a low ladder g^t (t < A) and a high ladder g^(A q) give
// each entry of one super-chunk with one Montgomery product.  Here the same
// split gives every entry of the table directly, with A = 128, one k-tile:
//
//   V[128 t + e, j] = lo[e, j] hi[t, j],  lo[e, j] = g_j^e,  hi[t, j] = g_j^(128 t)
//
// as digit planes (KT, k, 4W, 128) u8, what the tile mont_dot kernel reads
// on the tensor cores (the prover's column evaluation and the verifier's
// rows at the opened columns): [t, j, d, e] is byte d of entry m = 128 t + e
// of point j, zero past K; each k-tile of 128 m is one contiguous slab of
// every point's planes, one TMA box of the wgmma's B operand.
//
// What bounds it on an H100 (700 W): the products, one Montgomery product
// (2 W^2 + W wide products, 136 at ft255) an entry, at 8.4 T/s; the table's
// bytes written once (32 an entry at ft255, 3.35 TB/s) take ~0.6 of that.
// 32,768 x 189 entries (the 2^23 verify): 0.1006 ms; 262,144 x 189 (the
// 2^29 prove, 1.6 GB): 0.8046 ms.  So the design keeps the IMAD pipe busy
// with entries and spends next to nothing on anything else:
//
// - One grid wave that fills the card at every shape: the host sizes the
//   grid to the SMs times the blocks an SM holds (the occupancy API) and
//   gives each block an equal run of the flattened (point, k-tile) space,
//   each of its kWarps warps an equal part of that: the work per warp
//   follows K, k and the SM count, not a fixed 32,768 entries a block.
// - No per-lane ladder.  A block first builds, in shared memory, the tables
//   of the (at most kPts) points its run touches, one warp a point, each
//   table by doubling (a step: lanes [h, 2h) multiply the entries of lanes
//   [0, h) by x = X^h, lane h squares x): lo (g^e, e < 128), mid
//   (g^(128 i), i < 64) and one digit table (g^(4096 32^d i), i < 32) for
//   each base-32 digit of t / 32: 17 products deep at K = 2^15 (20 at
//   2^18), once a block, against the 15 (18) squarings that g^(128 t)
//   needs at the least; one product's latency on an otherwise idle SM is
//   long (a carry chain), so this is the start of every launch.
// - A warp then takes its tiles in runs of up to 32 from its first tile t:
//   lane l forms hi[t + l] = mid[t % 32 + l] times the digit tables' entries
//   of t / 32's nonzero digits (0-2 products a run at the path's shapes)
//   and leaves it in the warp's shared buffer; each tile of the run is then
//   one product an entry: lane l reads hi[t + s] (one broadcast) and its
//   four lo[4 l + u] (conflict-free: lo is stored u-major), forms four
//   entries, and a 4 x 4 byte transpose of each word gives four plane rows
//   of 4 bytes: the warp's 32 lanes store 128 contiguous bytes of each.  The
//   stores are off the IMAD pipe; 16-byte stores would need a shared-memory
//   or shuffle transpose of the entries first, more instructions than the
//   stores they save.
// - A whole tile's four products carry no branch, so they overlap (the
//   product is a carry chain with little parallelism of its own); the pad
//   past K takes a separate path.  Blocks of 10 warps, two an SM (96
//   registers at W32 = 8, no spill): 20 warps an SM.  At 80 registers
//   (24 warps) ptxas spills the four overlapping products' state.

#include "mont.cuh"

namespace {

using namespace lcpc;

constexpr int kTile = 128;   // entries a k-tile (a warp's store row, 4 a lane)
constexpr int kRun = 32;     // tiles a run: lane l holds hi of tile t + l
constexpr int kWarps = 10;   // warps a block
constexpr int kPts = 4;      // points a block spans at most (the grid is sized so)
constexpr int kLo = 128;     // lo table: g^e, e < 128 (stored u-major, see below)
constexpr int kMid = 64;     // mid table: g^(128 i), i < 64
constexpr int kDigit = 32;   // each digit table: g^(4096 32^d i), i < 32
constexpr unsigned kFull = 0xffffffffu;

// base-32 digits of (KT - 1) / 32: the digit tables a point needs
inline int digit_tables(long long kt) {
  int n = 0;
  for (long long c = (kt - 1) >> 5; c != 0; c >>= 5) ++n;
  return n;
}

inline int table_entries(int ndig) { return kLo + kMid + kDigit * ndig; }

// W consecutive words of shared memory, in the widest aligned pieces
template <int W>
__device__ __forceinline__ void load_entry(uint32_t (&r)[W], const uint32_t* s) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 q = *(const uint4*)(s + i);
      r[i] = q.x, r[i + 1] = q.y, r[i + 2] = q.z, r[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 q = *(const uint2*)(s + i);
      r[i] = q.x, r[i + 1] = q.y;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_entry(uint32_t* s, const uint32_t (&r)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *(uint4*)(s + i) = make_uint4(r[i], r[i + 1], r[i + 2], r[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) *(uint2*)(s + i) = make_uint2(r[i], r[i + 1]);
  }
}

// One doubling step of a table held an entry a lane, lanes [0, h) valid
// and x = X^h on every lane: lanes (h, 2h) take e[lane - h] x, lane h keeps
// x as its entry and squares it; every lane leaves with x = X^(2h).  One
// product for the warp.  h < 32.
template <int W>
__device__ __forceinline__ void double_step(uint32_t (&e)[W], uint32_t (&x)[W], int h, int lane,
                                            const Field<W>& f) {
  uint32_t a[W], r[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t lower = __shfl_sync(kFull, e[i], (lane - h) & 31);
    a[i] = lane == h ? x[i] : lower;
  }
  f.mul(r, a, x);
  const bool mine = lane > h && lane < 2 * h;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (lane == h) e[i] = x[i];
    if (mine) e[i] = r[i];
    x[i] = __shfl_sync(kFull, r[i], h);
  }
}

// e = X^lane for lanes below n (n <= 32) from x = X; x leaves as X^(2^s),
// 2^s the first power of two >= n (X^32 when n > 16).  consts: p | n0 |
// r2 | one, each entry W words (one = R mod p, the Montgomery 1).
template <int W>
__device__ __forceinline__ void doubling(uint32_t (&e)[W], uint32_t (&x)[W], int n,
                                         const uint32_t* __restrict__ consts, int lane,
                                         const Field<W>& f) {
#pragma unroll
  for (int i = 0; i < W; ++i) e[i] = __ldg(consts + 2 * W + 1 + i);
  for (int h = 1; h < n; h *= 2) double_step(e, x, h, lane, f);
}

// The tables of point j (one warp), written to `tab`: lo at entry
// 32 (e % 4) + e / 4 (lane l's four are the entries l, 32 + l, 64 + l,
// 96 + l), mid at kLo + i, digit table d at kLo + kMid + 32 d + i.
template <int W>
__device__ void build_tables(const int32_t* __restrict__ g, int k, int j,
                             const uint32_t* __restrict__ consts, uint32_t* __restrict__ tab,
                             int kt, int ndig, int lane, const Field<W>& f) {
  // lo entry e lives at 32 (e % 4) + e / 4
  auto lo = [&](int e) { return tab + (32 * (e & 3) + (e >> 2)) * W; };
  uint32_t x[W], e[W], a[W], r[W], x64[W];
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = (uint32_t)__ldg(g + (long long)i * k + j);
  doubling(e, x, 32, consts, lane, f);  // e = g^lane, x = g^32
  store_entry(lo(lane), e);
  // g^(32 + lane), lane 0 squaring g^32 instead (its entry is g^32 itself)
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = lane == 0 ? x[i] : e[i];
  f.mul(r, a, x);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    a[i] = lane == 0 ? x[i] : r[i];
    x64[i] = __shfl_sync(kFull, r[i], 0);
  }
  store_entry(lo(32 + lane), a);
  // g^(64 + lane) the same way (x leaves as g^128), g^(96 + lane) =
  // g^(32 + lane) g^64
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = lane == 0 ? x64[i] : e[i];
  f.mul(r, a, x64);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    a[i] = lane == 0 ? x64[i] : r[i];
    x[i] = __shfl_sync(kFull, r[i], 0);
  }
  store_entry(lo(64 + lane), a);
  load_entry(a, lo(32 + lane));
  f.mul(r, a, x64);
  store_entry(lo(96 + lane), r);
  // mid: g^(128 i) for i < min(64, KT); x leaves as g^4096 when KT > 32
  const int n_mid = kt < kMid ? kt : kMid;
  doubling(e, x, n_mid < 32 ? n_mid : 32, consts, lane, f);
  if (lane < n_mid) store_entry(tab + (kLo + lane) * W, e);
  if (n_mid > 32) {
    f.mul(r, e, x);  // lane 0: one x = g^4096
    if (32 + lane < n_mid) store_entry(tab + (kLo + 32 + lane) * W, r);
  }
  // the digit tables: base g^(4096 32^d); every table below the top one is
  // whole, so its doubling leaves x as the next one's base
  for (int d = 0; d < ndig; ++d) {
    const int top = ((kt - 1) >> (5 * (d + 1))) + 1;
    const int n = d + 1 < ndig || top > kDigit ? kDigit : top;
    doubling(e, x, n, consts, lane, f);
    if (lane < n) store_entry(tab + (kLo + kMid + kDigit * d + lane) * W, e);
  }
}

template <int W>
__global__ void __launch_bounds__(32 * kWarps, 2)
power_planes_kernel(const int32_t* __restrict__ g, uint8_t* __restrict__ out,
                    const uint32_t* __restrict__ consts, int K, int k, int kt, int ndig,
                    int entries) {
  extern __shared__ __align__(16) uint32_t smem[];  // kPts point tables, then kWarps run buffers
  constexpr int D = 4 * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Values that would wait in registers through the prologue or a run of
  // tiles live in shared memory instead (read once a run): the block's
  // range and each warp's tiles left.
  __shared__ int s_range[3], s_left[kWarps];
  {
    const int total = k * kt;  // flattened (point, tile): u = j KT + t; below 2^31 (the host)
    const int ua = (int)((long long)total * blockIdx.x / gridDim.x);
    const int ub = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
    if (ua >= ub) return;  // the whole block
    // the block's points: at most kPts (the host sizes the grid so)
    const int jp = ua / kt, np = (ub - 1) / kt - jp + 1;
    if (threadIdx.x == 0) s_range[0] = ua, s_range[1] = ub, s_range[2] = jp;
    if (warp < np) build_tables<W>(g, k, jp + warp, consts, smem + warp * entries * W, kt, ndig,
                                   lane, Field<W>(consts));
  }
  __syncthreads();
  const int ua = s_range[0], ub = s_range[1];
  const int run = (kPts * entries + warp * kRun) * W;  // this warp's hi buffer (words)
  const Field<W> f(consts);
  const int w0 = ua + (int)((long long)(ub - ua) * warp / kWarps);
  // this warp's tiles: s_left[warp] of them from tile t of point j
  if (lane == 0) s_left[warp] = ua + (int)((long long)(ub - ua) * (warp + 1) / kWarps) - w0;
  __syncwarp();
  int j = w0 / kt, t = w0 - j * kt;
  for (int left; (left = s_left[warp]) > 0;) {
    const int n = min(min(left, kRun), kt - t);
    __syncwarp();  // every lane has read s_left
    if (lane == 0) s_left[warp] = left - n;
    const int tab = (j - s_range[2]) * entries * W;  // the point's tables (words)
    {  // this lane's hi: g^(128 (t + lane))
      uint32_t hi[W], x[W];
      load_entry(hi, smem + tab + (kLo + (t & 31) + lane) * W);
      for (int d = 0, c = t >> 5; c != 0; ++d, c >>= 5) {
        if (c & 31) {
          load_entry(x, smem + tab + (kLo + kMid + kDigit * d + (c & 31)) * W);
          f.mul(hi, hi, x);  // Field::mul writes r after its last read of a
        }
      }
      __syncwarp();  // the last run's buffer is read
      store_entry(smem + run + lane * W, hi);
      __syncwarp();
    }
    for (int s = 0; s < n; ++s) {
      const int tt = t + s;
      uint32_t h[W], v[4][W];
      load_entry(h, smem + run + s * W);
      if ((tt + 1) * kTile <= K) {  // a whole tile: four independent products
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t a[W];
          load_entry(a, smem + tab + (32 * q + lane) * W);
          f.mul(v[q], a, h);
        }
      } else {  // the point's last tile, past K in part
        const int lim = K - tt * kTile - 4 * lane;  // this lane's entries below K
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < lim) {
            uint32_t a[W];
            load_entry(a, smem + tab + (32 * q + lane) * W);
            f.mul(v[q], a, h);
          } else {
#pragma unroll
            for (int i = 0; i < W; ++i) v[q][i] = 0;  // the pad past K
          }
        }
      }
      uint8_t* dst = out + ((long long)tt * k + j) * (D * kTile) + 4 * lane;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t xs[4] = {v[0][i], v[1][i], v[2][i], v[3][i]};
        uint32_t o[4];
        transpose4(xs, o);
#pragma unroll
        for (int b = 0; b < 4; ++b) *(uint32_t*)(dst + (4 * i + b) * kTile) = o[b];
      }
    }
    t += n;
    if (t == kt) t = 0, ++j;
  }
}

template <int W>
cudaError_t launch(const int32_t* g, uint8_t* out, const uint32_t* consts, int K, int k,
                   int device, cudaStream_t stream) {
  const long long kt = ((long long)K + kTile - 1) / kTile;
  const long long total = (long long)k * kt;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;  // > 8 TB of table
  const int ndig = digit_tables(kt);
  const size_t smem = ((size_t)kPts * table_entries(ndig) + (size_t)kWarps * kRun) * W * 4;
  int n_sm = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, power_planes_kernel<W>,
                                                      32 * kWarps, smem);
  if (err != cudaSuccess) return err;
  // one wave of blocks, each with at least a tile a warp, unless a block
  // would then span more than kPts points (a run of (kPts - 1) KT tiles
  // touches at most kPts)
  long long blocks = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const long long most = (total + kWarps - 1) / kWarps;
  const long long need = (total + (kPts - 1) * kt - 1) / ((kPts - 1) * kt);
  if (blocks > most) blocks = most;
  if (blocks < need) blocks = need;
  power_planes_kernel<W><<<(unsigned)blocks, 32 * kWarps, smem, stream>>>(
      g, out, consts, K, k, (int)kt, ndig, table_entries(ndig));
  return cudaGetLastError();
}

}  // namespace

// The table of the points g (w32, k) int32 words (Montgomery) on `stream`
// of CUDA device `device`: out (KT, k, 4 w32, 128) u8, KT = ceil(K / 128),
// out[t, j, d, e] = byte d of g_j^(128 t + e) (Montgomery), zero past K.
// consts: p[w32] | n0 | r2[w32] | one[w32].  Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for KT k >= 2^31, a
// table past 8 TB).
extern "C" int lcpc_power_table(const int32_t* g, uint8_t* out, const uint32_t* consts, int w32,
                                int K, int k, int device, void* stream) {
  if (g == nullptr || out == nullptr || consts == nullptr || K < 1 || k < 1 ||
      (long long)K > (1LL << 30) || k > 65535 || ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w32) {
    case 2: return (int)launch<2>(g, out, consts, K, k, device, s);
    case 4: return (int)launch<4>(g, out, consts, K, k, device, s);
    case 6: return (int)launch<6>(g, out, consts, K, k, device, s);
    case 8: return (int)launch<8>(g, out, consts, K, k, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
