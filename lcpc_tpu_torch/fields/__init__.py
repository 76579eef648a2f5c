"""Prime-field layer: specs and host-side (Python-int) arithmetic.

The four test fields mirror the reference's `lcpc-test-fields/src/lib.rs:13-59`
(ff 0.12 `PrimeField` derive, little-endian repr, Montgomery form with
R = 2^(64*L)).  The port stores field elements as vectors of 16-bit limbs
in int32 tensors; since 16*W16 == 64*L64 for all four fields, the device
Montgomery form is numerically identical to the Rust `ff` internal form, which
makes wire serialization (bincode of the internal limbs) a pure repacking.
"""

from .spec import (
    FieldSpec,
    FT63,
    FT127,
    FT191,
    FT255,
    ALL_FIELDS,
)

__all__ = [
    "FieldSpec",
    "FT63",
    "FT127",
    "FT191",
    "FT255",
    "ALL_FIELDS",
]
