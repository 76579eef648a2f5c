"""Sampling semantics matching the Rust stack bit-for-bit.

- `field_random_vec`: ff 0.12 `Field::random` (rejection over masked u64
  limbs interpreted as Montgomery form), as used for degree-test tensors
  (lcpc-2d/src/lib.rs:874,1030) and expander matrix values (matgen.rs:174-180).
- `uniform_indices`: rand 0.8 `Uniform::new(0, n)` for usize (Lemire widening
  multiply with rejection zone), as used for column openings
  (lcpc-2d/src/lib.rs:907-910,1077-1080) and matgen column sampling
  (matgen.rs:119,146-159).
"""

from __future__ import annotations

import numpy as np

from ..fields.spec import FieldSpec
from .chacha import ChaCha20Rng

_U64_MASK = (1 << 64) - 1


def field_random_vec(spec: FieldSpec, rng: ChaCha20Rng, n: int) -> list[int]:
    """Draw n field elements exactly as n calls to ff's Field::random.

    May over-consume the RNG past the draw that produced the n-th element
    (only use with throw-away RNGs, as the reference does for FS expansion).
    Returns canonical values (Montgomery interpretation already removed).
    """
    L = spec.limbs64
    top_mask = _U64_MASK >> spec.shave_bits
    p = spec.p
    rinv = spec.Rinv
    out: list[int] = []
    # expected acceptance rate is p / 2^num_bits (>= 1/2); draw with slack
    while len(out) < n:
        need = n - len(out)
        m = max(16, need * 2)
        draws = rng.next_u64_array(m * L)
        if L == 1:
            xs = draws & np.uint64(top_mask)
            for x in xs:
                x = int(x)
                if x < p:
                    out.append((x * rinv) % p)
                    if len(out) == n:
                        break
        else:
            draws = draws.reshape(m, L)
            for row in draws:
                x = int.from_bytes(row.tobytes(), "little")
                x &= (top_mask << (64 * (L - 1))) | ((1 << (64 * (L - 1))) - 1)
                if x < p:
                    out.append((x * rinv) % p)
                    if len(out) == n:
                        break
    return out


def field_random_raw(spec: FieldSpec, rng: ChaCha20Rng) -> int:
    """One ff Field::random draw; returns the ACCEPTED MASKED DRAW, i.e. the
    element's Montgomery representation (value = draw * R^-1 mod p)."""
    top_mask = _U64_MASK >> spec.shave_bits
    while True:
        limbs = [rng.next_u64() for _ in range(spec.limbs64)]
        limbs[-1] &= top_mask
        x = 0
        for i, l in enumerate(limbs):
            x |= l << (64 * i)
        if x < spec.p:
            return x


def field_random_scalar(spec: FieldSpec, rng: ChaCha20Rng) -> int:
    """One ff Field::random draw, consuming exactly what Rust consumes."""
    return (field_random_raw(spec, rng) * spec.Rinv) % spec.p


def field_random_nonzero_raw(spec: FieldSpec, rng: ChaCha20Rng) -> int:
    """matgen.rs:174-180 (Montgomery-form result): redraw until nonzero.
    The value is zero iff the raw draw is zero (x < p and v = x*R^-1)."""
    x = field_random_raw(spec, rng)
    while x == 0:
        x = field_random_raw(spec, rng)
    return x


class UniformUsize:
    """rand 0.8 UniformInt<usize> distribution over [0, range)."""

    def __init__(self, range_: int):
        assert 0 < range_ <= _U64_MASK
        self.range = range_
        ints_to_reject = (_U64_MASK - range_ + 1) % range_
        self.zone = _U64_MASK - ints_to_reject

    def sample(self, rng: ChaCha20Rng) -> int:
        while True:
            v = rng.next_u64()
            m = v * self.range
            hi, lo = m >> 64, m & _U64_MASK
            if lo <= self.zone:
                return hi


def uniform_indices(n: int, rng: ChaCha20Rng, count: int) -> list[int]:
    """`count` samples from Uniform::new(0usize, n) (with replacement).

    Vectorized with EXACT stream consumption: draw `count` u64s at once; if
    all land in the acceptance zone (overwhelmingly likely — the rejection
    zone is < n/2^64), the batch is the answer.  On a rejection, everything
    from the first rejected draw on is recomputed from a rewound stream so
    consumption matches the reference's one-at-a-time loop bit-for-bit.
    """
    dist = UniformUsize(n)
    out: list[int] = []
    while len(out) < count:
        need = count - len(out)
        draws = rng.next_u64_array(need)
        m = draws.astype(object) * n  # exact 128-bit products
        lo = m & _U64_MASK
        ok = lo <= dist.zone
        if bool(ok.all()):
            out.extend(int(v) for v in (m >> 64))
            break
        first_bad = int(np.argmin(ok))
        out.extend(int(v) for v in (m[:first_bad] >> 64))
        # consume the rejected draw (already drawn) and redo the rest
        rng.rewind_u64(need - first_bad - 1)
    return out
