"""Pluggable digest interface — the analogue of the reference's `D: Digest`
genericity (lcpc-2d/src/lib.rs:34-58).

The commitment pipeline needs three digest operations over (8, C) u32
digest-word tensors (int64 storage): column leaf hashes, Merkle layers and
one Merkle parent step; `host` is the byte-level twin.  BLAKE3 is the
default; SHA256 is the second construction behind the same plug point.
Protocol entry points accept a `digest=` parameter; proofs do not record the
digest (as in the reference, prover and verifier agree out of band).
"""

from __future__ import annotations

import dataclasses

from . import blake3 as _blake3
from . import sha256 as _sha256


@dataclasses.dataclass(frozen=True)
class DeviceDigest:
    name: str
    hash_word_columns: callable  # (L, C) words -> (8, C)
    merkle_layer: callable       # (8, 2n) -> (8, n)
    merkle_parent: callable      # (8, n), (8, n) -> (8, n)
    host: callable               # bytes -> 32-byte digest


BLAKE3 = DeviceDigest(
    name="blake3",
    hash_word_columns=_blake3.hash_word_columns,
    merkle_layer=_blake3.merkle_layer,
    merkle_parent=_blake3.merkle_parent,
    host=_blake3.blake3,
)

SHA256 = DeviceDigest(
    name="sha256",
    hash_word_columns=_sha256.hash_word_columns,
    merkle_layer=_sha256.merkle_layer,
    merkle_parent=_sha256.merkle_parent,
    host=_sha256.digest_host,
)

DIGESTS_BY_NAME = {d.name: d for d in (BLAKE3, SHA256)}
