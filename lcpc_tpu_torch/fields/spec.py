"""Field specifications and host-side scalar arithmetic.

Mirrors the semantics of `ff` 0.12's `PrimeField` derive as used by the
reference (`lcpc-test-fields/src/lib.rs:13-59`):

- internal representation is Montgomery form with R = 2^(64*L), L = #u64 limbs;
- `to_repr()` is the canonical value in little-endian bytes (8*L bytes);
- `Field::random(rng)` rejection-samples L u64 words (masked to NUM_BITS) and
  *interprets the accepted integer as the Montgomery representation*, i.e. the
  sampled field value is X * R^{-1} mod p (fs/sampling.py);
- `s` (2-adicity) and `ROOT_OF_UNITY = g^((p-1)/2^s)` drive the Ligero NTT
  (ops/ntt.py).

All host arithmetic here is exact Python-int math; the device layer
(`lcpc_tpu_torch.ops.limbs`) must agree with it bit-for-bit (twin-tested).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field p with a chosen multiplicative generator.

    Derived constants replicate ff 0.12's derive:
    `num_bits` = bit length of p, `shave_bits` = 64*L - num_bits,
    `s` = 2-adicity of p-1, `root_of_unity` = generator^t with p-1 = 2^s * t.
    """

    name: str
    p: int
    generator: int

    # ---- size / limb constants -------------------------------------------------
    @cached_property
    def num_bits(self) -> int:
        return self.p.bit_length()

    @cached_property
    def limbs64(self) -> int:
        """Number of u64 limbs in the Rust `ff` representation."""
        return (self.num_bits + 63) // 64

    @cached_property
    def repr_bytes(self) -> int:
        """Size of the canonical little-endian repr (== 8 * limbs64)."""
        return 8 * self.limbs64

    @cached_property
    def shave_bits(self) -> int:
        """ff derive's REPR_SHAVE_BITS: high bits masked off in random()."""
        return 64 * self.limbs64 - self.num_bits

    @cached_property
    def w16(self) -> int:
        """Number of 16-bit device limbs (16*w16 == 64*limbs64)."""
        return 4 * self.limbs64

    # ---- log2 cardinality (lcpc-2d/src/lib.rs:61-71 SizedField) ----------------
    @cached_property
    def flog2(self) -> int:
        return self.num_bits - 1

    # ---- Montgomery constants --------------------------------------------------
    @cached_property
    def R(self) -> int:
        """Montgomery radix 2^(64*L) mod p (same for the 16-bit device base)."""
        return pow(2, 64 * self.limbs64, self.p)

    @cached_property
    def R2(self) -> int:
        return pow(2, 128 * self.limbs64, self.p)

    @cached_property
    def Rinv(self) -> int:
        return pow(self.R, -1, self.p)

    @cached_property
    def n0inv_full(self) -> int:
        """-p^{-1} mod R (full-width Montgomery constant, R = 2^(16*w16))."""
        r = 1 << (16 * self.w16)
        return (-pow(self.p, -1, r)) % r

    # ---- 2-adicity / roots of unity (NTT) --------------------------------------
    @cached_property
    def s(self) -> int:
        """2-adicity: largest s with 2^s | p-1 (ff derive's `S`)."""
        t = self.p - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        return s

    @cached_property
    def t_odd(self) -> int:
        return (self.p - 1) >> self.s

    @cached_property
    def root_of_unity(self) -> int:
        """g^t mod p: a primitive 2^s-th root of unity (ff's ROOT_OF_UNITY)."""
        return pow(self.generator, self.t_odd, self.p)

    def root_for_log_len(self, log_len: int) -> int:
        """Primitive 2^log_len-th root of unity: ROOT_OF_UNITY^(2^(s - log_len))."""
        assert 0 <= log_len <= self.s, (log_len, self.s)
        return pow(self.root_of_unity, 1 << (self.s - log_len), self.p)

    # ---- Montgomery conversion (host) ----------------------------------------
    def to_mont(self, v: int) -> int:
        return (v * self.R) % self.p

    def from_mont(self, m: int) -> int:
        return (m * self.Rinv) % self.p

    # ---- canonical serialization (ff to_repr / FieldHash) ----------------------
    def to_repr(self, v: int) -> bytes:
        """Canonical little-endian bytes of value v (lcpc-2d/src/lib.rs:52-58)."""
        assert 0 <= v < self.p
        return v.to_bytes(self.repr_bytes, "little")


# The four test fields (lcpc-test-fields/src/lib.rs:13-59).
FT63 = FieldSpec("ft63", 5102708120182849537, 10)
FT127 = FieldSpec("ft127", 146823888364060453008360742206866194433, 3)
FT191 = FieldSpec(
    "ft191", 1697146272512170708389931801544665676545308500647389167617, 5
)
FT255 = FieldSpec(
    "ft255",
    46242760681095663677370860714659204618859642560429202607213929836750194081793,
    5,
)

ALL_FIELDS = (FT63, FT127, FT191, FT255)
