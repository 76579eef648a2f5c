"""The sharded streaming commit: row blocks over torch.distributed ranks
(port of lcpc_tpu/parallel/mesh_streaming.py).

The two big-N mechanisms together: the codeword is never held whole
(core/streaming.py, row blocks folded into per-column hash state), and
within a block the row encodes shard over the ranks.  For each block every
rank encodes its share of the block's rows to canonical hash words, one
all_to_all moves the words to their columns' owners
(mesh_protocol.encode_reshard: lcpc_tpu's `_block_words_fn`), and each
rank folds its column slice of the block into its own StreamingColumnHasher
or StreamingSha256Hasher: an update works column by column, so it needs no
communication.  At the end the leaves are all-gathered and every rank
builds the same Merkle tree.  The hash words are kept column-sharded for
prove's openings, so the kept codeword scales with the ranks.  The row
block is a multiple of the rank count (mesh_streaming.py:184-189), each
rank encoding an equal share; the proof is mesh_protocol's sharded prove.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import streaming
from ..core.encoding import LcEncoding
from ..ops.digest import BLAKE3, DeviceDigest
from . import mesh_protocol, multihost
from .comm import Comm
from .mesh_protocol import ShardedCommit, _round_up


@dataclasses.dataclass
class ShardedCommitStreaming(ShardedCommit):
    """A sharded commitment made by row blocks of `row_block` rows (all
    ranks together); openable and proved like ShardedCommit."""

    row_block: int = 0


def sharded_commit_streaming(coeffs, enc: LcEncoding, mesh=None,
                             row_block: "int | None" = None,
                             digest: DeviceDigest = BLAKE3) -> ShardedCommitStreaming:
    """Row-blocked sharded commit; every rank calls it with the same
    `coeffs` and gets the same root, equal to protocol.commit's.
    `row_block` rows a block (rounded as commit_streaming rounds it, then up
    to a multiple of the ranks); by default sized from the device budget
    for each rank's share."""
    hasher_cls = streaming._STREAM_HASHERS.get(digest.name)
    if hasher_cls is None:
        raise ValueError(f"no streaming hasher for digest {digest.name!r}")
    c = Comm(mesh)
    mat, n_rows, n_per_row, n_cols = mesh_protocol._padded_rows(coeffs, enc, c.world)
    device = mat.device
    wpe = enc.spec.w16 // 2
    cl = _round_up(n_cols, c.world) // c.world
    total_words = 8 + n_rows * wpe  # the column hash's 32-byte zero prefix first
    resident = (mat.numel() * 4 + n_rows * wpe * cl * 4
                + hasher_cls.resident_bytes(cl, total_words))
    if row_block is None:  # each rank's share sized from its budget
        rb = c.world * streaming._row_block_for(enc, -(-n_rows // c.world), None, resident)
    else:
        rb = streaming._row_block_for(enc, n_rows, row_block)
    rb = max(c.world, _round_up(rb, c.world))

    hasher = hasher_cls(cl, total_words, device)
    words = torch.empty((n_rows * wpe, cl), dtype=torch.int32, device=device)
    for r0 in range(0, n_rows, rb):
        true_rows = min(rb, n_rows - r0)
        share = _round_up(true_rows, c.world) // c.world
        block = mat[:, r0 + c.rank * share : r0 + (c.rank + 1) * share]
        blk_words = mesh_protocol.encode_reshard(enc, c, block, true_rows)
        hasher.update(blk_words)
        words[r0 * wpe : (r0 + true_rows) * wpe] = blk_words
        del blk_words
    flat = mesh_protocol.merkle_from_slices(c, digest, hasher.finalize(), n_cols)
    coeffs_local = multihost.local_shard(mat, 1, c.rank, c.world).contiguous()
    return ShardedCommitStreaming(enc=enc, mesh=mesh, coeffs=coeffs_local, words=words,
                                  n_rows=n_rows, n_per_row=n_per_row, n_cols=n_cols,
                                  hashes_dev=flat, digest=digest, row_block=rb)


# prove() against the sharded streaming state is mesh_protocol's sharded
# prove: the collapse on the row shards, the openings from the kept
# column-sharded words
sharded_prove_streaming = mesh_protocol.sharded_prove
