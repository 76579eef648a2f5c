// Montgomery arithmetic over 32-bit words, shared by the NTT, the prover's
// and the verifier's kernels and the field maps (ntt_mont.cu, mont_dot.cu,
// power_table.cu, verify_core.cu, mont_map.cu): a
// word-serial CIOS product on a split accumulator (sppark's mont_t layout:
// each 32 x 32 -> 64 product's lo/hi halves in one register pair of a PTX
// carry chain, which ptxas fuses into one IMAD.WIDE.U32(.X)); an element
// is W words, little-endian, R = 2^(32 W).  Every field's p has a spare top
// bit, which keeps each chain's value inside its words.
//
// consts layout (uint32): p[W] | n0 (= -p^-1 mod 2^32), what Field reads;
// the prover's kernels append r2[W] (R^2 mod p) | one[W] (R mod p, the
// Montgomery form of 1) | r3[W] (R^3 mod p: verify_core.cu's S R^-2 -> S
// in one product).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lcpc {


// PTX carry-chain steps: one instruction each; the carry flag flows from
// one to the next in program order (nothing between them touches it)
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// one 32 x 32 -> 64 product added into a word pair (lo, hi) in one carry
// chain; ptxas fuses each lo/hi pair into one IMAD.WIDE.U32(.X)
__device__ __forceinline__ void mul_pair(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  asm volatile("mul.lo.u32 %0, %2, %3;\n\tmul.hi.u32 %1, %2, %3;"
               : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void mad_pair_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                            uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_pair_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                             uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
// (lo, hi) = a b + (lo2, hi2) + carry: the pair two words up, moved down
__device__ __forceinline__ void madc_pair_down_cc(uint32_t& lo, uint32_t& hi, uint32_t a,
                                                  uint32_t b, uint32_t lo2, uint32_t hi2) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %4;\n\tmadc.hi.cc.u32 %1, %2, %3, %5;"
               : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b), "r"(lo2), "r"(hi2));
}
__device__ __forceinline__ void madc_pair_top(uint32_t& lo, uint32_t& hi, uint32_t a,
                                              uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0;\n\tmadc.hi.u32 %1, %2, %3, 0;"
               : "=&r"(lo), "=&r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc[0 .. 2H-1] += x[0], x[2], .. x[2H-2] times b at every other word, one
// carry chain (carry out left in the flag)
template <int W>
__device__ __forceinline__ void cmad_even(uint32_t* acc, const uint32_t* x, uint32_t b) {
  mad_pair_cc(acc[0], acc[1], x[0], b);
#pragma unroll
  for (int j = 2; j < W; j += 2) madc_pair_cc(acc[j], acc[j + 1], x[j], b);
}

// the 4 x 4 byte transpose: o[b] holds byte b of x[0], x[1], x[2], x[3], in
// that order (four PRMTs make byte pairs, four more the quadruples); the
// digit-plane kernels' step from four words to four planes of 4 bytes
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140), t3 = __byte_perm(x[2], x[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

template <int W>
struct Field {
  uint32_t p[W];
  uint32_t n0;

  __device__ __forceinline__ Field(const uint32_t* __restrict__ consts) {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __ldg(consts + i);
    n0 = __ldg(consts + W);
  }

  // r = a + b mod p for a, b < p (a + b < 2p < 2^(32 W): p has a spare
  // top bit, so the sum never carries out)
  __device__ __forceinline__ void add(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t s[W], d[W];
    s[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) s[i] = addc_cc(a[i], b[i]);
    d[0] = sub_cc(s[0], p[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = subc_cc(s[i], p[i]);
    const uint32_t lt = subc(0, 0);  // all ones where a + b < p
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = lt ? s[i] : d[i];
  }

  // r = a - b mod p for a, b < p
  __device__ __forceinline__ void sub(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t d[W];
    d[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = subc_cc(a[i], b[i]);
    const uint32_t mask = subc(0, 0);  // add p back where a < b
    r[0] = add_cc(d[0], p[0] & mask);
#pragma unroll
    for (int i = 1; i < W - 1; ++i) r[i] = addc_cc(d[i], p[i] & mask);
    r[W - 1] = addc(d[W - 1], p[W - 1] & mask);
  }

  // one CIOS step on the split accumulator (sppark's mont_t layout): `ev`
  // holds words at positions k, `od` at k + 1, each product's lo/hi pair in
  // one word pair, so every 32 x 32 -> 64 product is one IMAD.WIDE.  The
  // step adds a * bi and m * p (m = ev[0] n0), zeroing position 0; the
  // next step reads the shifted value with the two arrays' roles swapped.
  // Every field's p has a spare top bit, so the value stays below
  // 2^(32 (W + 1)) and no chain carries out of position W.
  __device__ __forceinline__ void cios_step(uint32_t (&ev)[W], uint32_t (&od)[W],
                                            const uint32_t (&a)[W], uint32_t bi,
                                            bool first) const {
    if (first) {
#pragma unroll
      for (int j = 0; j < W; j += 2) {
        mul_pair(ev[j], ev[j + 1], a[j], bi);
        mul_pair(od[j], od[j + 1], a[j + 1], bi);
      }
    } else {
      // od holds the previous even array (position 0 zeroed): od[1] moves
      // to position 0, od[k + 2] to odd position k
      ev[0] = add_cc(ev[0], od[1]);
#pragma unroll
      for (int j = 0; j < W - 2; j += 2)
        madc_pair_down_cc(od[j], od[j + 1], a[j + 1], bi, od[j + 2], od[j + 3]);
      madc_pair_top(od[W - 2], od[W - 1], a[W - 1], bi);
      cmad_even<W>(ev, a, bi);
      od[W - 1] = addc(od[W - 1], 0);
    }
    const uint32_t m = ev[0] * n0;
    cmad_even<W>(od, p + 1, m);
    cmad_even<W>(ev, p, m);
    od[W - 1] = addc(od[W - 1], 0);
  }

  // r = a * b * 2^(-32 W) mod p for a, b < p: CIOS word-serial over b, the
  // result below 2p, then one conditional subtract
  __device__ __forceinline__ void mul(uint32_t (&r)[W], const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) const {
    uint32_t ev[W], od[W];
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      cios_step(ev, od, a, b[i], i == 0);
      cios_step(od, ev, a, b[i + 1], false);
    }
    uint32_t t[W];
    merge(t, ev, od);  // the last step left od at positions k, ev at k + 1
    uint32_t d[W];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t u = (uint64_t)t[i] - p[i] - borrow;
      d[i] = (uint32_t)u;
      borrow = (uint32_t)(u >> 63);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = borrow == 0 ? d[i] : t[i];  // t >= p
  }

  // the split accumulator's reduction step alone (no product): adds m * p
  // and leaves the value for the next step with the arrays' roles swapped
  __device__ __forceinline__ void redc_step(uint32_t (&ev)[W], uint32_t (&od)[W],
                                            bool first) const {
    if (!first) {
      ev[0] = add_cc(ev[0], od[1]);
#pragma unroll
      for (int j = 0; j < W - 2; ++j) od[j] = addc_cc(od[j + 2], 0);
      od[W - 2] = addc(0, 0);
      od[W - 1] = 0;
    }
    const uint32_t m = ev[0] * n0;
    cmad_even<W>(od, p + 1, m);
    cmad_even<W>(ev, p, m);
    od[W - 1] = addc(od[W - 1], 0);
  }

  // ev[k] + od[k + 1] at position k: the split accumulator after its last
  // step (od[0] zero), shifted, in W words
  __device__ __forceinline__ void merge(uint32_t (&t)[W], const uint32_t (&ev)[W],
                                        const uint32_t (&od)[W]) const {
    t[0] = add_cc(ev[0], od[1]);
#pragma unroll
    for (int j = 1; j < W - 1; ++j) t[j] = addc_cc(ev[j], od[j + 1]);
    t[W - 1] = addc(ev[W - 1], 0);
  }

  // r = a * 2^(-32 W) mod p for a < p: W reduction steps; the result
  // (a + M p) / 2^(32 W) with M < 2^(32 W) is below p, so no subtract
  __device__ __forceinline__ void from_mont(uint32_t (&r)[W], const uint32_t (&a)[W]) const {
    uint32_t ev[W], od[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ev[i] = a[i];
      od[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      redc_step(ev, od, i == 0);
      redc_step(od, ev, false);
    }
    merge(r, ev, od);
  }
};

// ---- reductions of any input below R and of lazy sums, shared by the field
// maps, the products and the verifier's kernels (mont_map.cu, mont_dot.cu,
// verify_core.cu) ----

// x -= m where x >= m (one borrow chain, then a select)
template <int W>
__device__ __forceinline__ void cond_sub(uint32_t (&x)[W], const uint32_t (&m)[W]) {
  uint32_t d[W];
  d[0] = sub_cc(x[0], m[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) d[i] = subc_cc(x[i], m[i]);
  const uint32_t lt = subc(0, 0);  // all ones where x < m
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = lt ? x[i] : d[i];
}

// x < 2^(32 W) < 4p -> x mod p: x < 4p - 2p after the first subtract
template <int W>
__device__ __forceinline__ void reduce(uint32_t (&x)[W], const uint32_t (&p)[W],
                                       const uint32_t (&p2)[W]) {
  cond_sub<W>(x, p2);
  cond_sub<W>(x, p);
}

// 2p (p's spare top bit keeps it in W words)
template <int W>
__device__ __forceinline__ void twice(uint32_t (&p2)[W], const uint32_t (&p)[W]) {
  p2[0] = p[0] << 1;
#pragma unroll
  for (int i = 1; i < W; ++i) p2[i] = (p[i] << 1) | (p[i - 1] >> 31);
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

// the residue of the sum S = v (2W + 1 words, S < K R^2 for K < 2^31):
// canonical (S R^-2 mod p) or, with `mont`, S R^-1 mod p
template <int W>
__device__ __forceinline__ void reduce_wide(uint32_t (&r)[W], uint32_t (&v)[2 * W + 1],
                                            const Field<W>& f,
                                            const uint32_t* __restrict__ consts, bool mont) {
  redc_wide<W>(v, f);  // v[W .. 2W] < K R + p
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

// the residue of a lazy sum (mont_dot.cu's thin kernel, verify_core.cu)
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
  reduce_wide<W>(r, v, f, consts, mont);
}

}  // namespace lcpc
