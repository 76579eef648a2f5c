"""Pluggable digest interface — the analogue of the reference's `D: Digest`
genericity (lcpc-2d/src/lib.rs:34-58).

The commitment pipeline needs three digest operations over (8, C) u32
digest-word tensors (int64 storage): column leaf hashes, Merkle layers and
one Merkle parent step.  This slice of the port carries BLAKE3; SHA-256 is
still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

from . import blake3 as _blake3


@dataclasses.dataclass(frozen=True)
class DeviceDigest:
    name: str
    hash_word_columns: callable  # (L, C) words -> (8, C)
    merkle_layer: callable       # (8, 2n) -> (8, n)
    merkle_parent: callable      # (8, n), (8, n) -> (8, n)


BLAKE3 = DeviceDigest(
    name="blake3",
    hash_word_columns=_blake3.hash_word_columns,
    merkle_layer=_blake3.merkle_layer,
    merkle_parent=_blake3.merkle_parent,
)
