"""Pluggable digest interface — the analogue of the reference's `D: Digest`
genericity (lcpc-2d/src/lib.rs:34-58).

The commitment pipeline needs these digest operations over (8, C) u32
digest-word tensors (int64 storage): column leaf hashes (of (L, C) u32 words,
int32 storage or int64), the whole Merkle array and the verifier's path
walk; `host` is the byte-level twin.  BLAKE3
is the default, its entries the wrappers of the CUDA kernels in
csrc/blake3_cols.cu (ops/blake3.py); SHA256 is the second construction
behind the same plug point, its entries the wrappers of csrc/sha256_cols.cu
(ops/sha256.py).  Each tree and each walk is one launch, the column hash one
launch for SHA-256 and, for BLAKE3, one at verify's column counts (its
few-column kernel) and two past them (chunks, then the chunk tree).
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
    merkle_tree: callable        # (8, n) leaves, np2 -> (8, 2 np2 - 1), leaves first
    merkle_walk: callable        # digs (8, k), sibs (8, U), inv (L, k), idx (k,) -> (8, k);
                                 # with root= and flag=, the verifier's check (None)
    merkle_walk_plain: callable  # the walk's plain version, on any device
    host: callable               # bytes -> 32-byte digest
    hash_word_columns_plain: callable  # the column hash's plain version, on any device
    merkle_tree_plain: callable        # the tree's plain version, on any device


BLAKE3 = DeviceDigest(
    name="blake3",
    hash_word_columns=_blake3.hash_word_columns,
    merkle_tree=_blake3.merkle_tree,
    merkle_walk=_blake3.merkle_walk,
    merkle_walk_plain=_blake3.merkle_walk_plain,
    host=_blake3.blake3,
    hash_word_columns_plain=_blake3.hash_word_columns_plain,
    merkle_tree_plain=_blake3.merkle_tree_plain,
)

SHA256 = DeviceDigest(
    name="sha256",
    hash_word_columns=_sha256.hash_word_columns,
    merkle_tree=_sha256.merkle_tree,
    merkle_walk=_sha256.merkle_walk,
    merkle_walk_plain=_sha256.merkle_walk_plain,
    host=_sha256.digest_host,
    hash_word_columns_plain=_sha256.hash_word_columns_plain,
    merkle_tree_plain=_sha256.merkle_tree_plain,
)

DIGESTS_BY_NAME = {d.name: d for d in (BLAKE3, SHA256)}
