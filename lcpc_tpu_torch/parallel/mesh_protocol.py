"""The sharded commit and prove over torch.distributed ranks (port of
lcpc_tpu/parallel/mesh_protocol.py).

Every rank calls the same entry point with the same host-replicated inputs
and runs the port's kernels on its own device; the ranks meet only in the
collectives of parallel/comm.py.  Roots, proofs and wire bytes equal the
single-device commit and prove (and so lcpc_tpu's):

- commit, "rows" (lcpc_tpu's `_build_commit_fn`): each rank encodes its
  shard of the rows (`encode_rows_lowmem(canonical=True,
  post=pack_row_words)`: the NTT's or SpMV's kernels, straight to the
  canonical hash words), one all_to_all reshards the words rows -> columns,
  each rank hashes its column slice (`hash_word_columns`: blake3_chunks and
  the chunk tree, or the few-column kernel for a slice of at most
  `blake3.FEW_COLS_MAX` columns, or sha256_cols), the leaf digests are
  all-gathered and every rank builds the same Merkle tree (`merkle_tree`).
  Rows that do not divide the ranks are padded with zero rows, dropped
  before hashing; codewords whose columns do not divide the ranks
  (Brakedown) get zero pad columns, whose leaves are dropped before the
  tree.  What is resharded
  and kept are the packed canonical hash words, 32 B an ft255 element (the
  limbs would be 64): lcpc_tpu keeps limbs; the bytes out are the same.
- commit, "wide" (`_build_commit_fn_wide`): every rank holds all rows but a
  B slice of each, and the DistNtt 4-step transform (parallel/dist_ntt.py)
  leaves each rank a contiguous column slice, hashed in place.
- prove: the port's `prove_core` runs on every rank in lockstep.  The
  collapse (`_build_collapse_fn`) is a local `FieldOps.collapse_canon`
  (mont_dot) on the row shard, an all_gather of the canonical partials and
  a modular tree-add (`FieldOps.sum`: mont_addsub_map on the card); a raw
  all_reduce sum would wrap the limbs.  Each opened column comes from the
  rank that owns it (`_gather_fn`), its path from the replicated tree.
- verify: unchanged (core/protocol.py: verify), single-device by design.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import protocol
from ..core.encoding import LcEncoding
from ..core.protocol import LcEvalProof, ProverError, _next_pow2, _pack_pairs
from ..fs.merlin import Transcript
from ..ops import blake3
from ..ops.digest import BLAKE3, DeviceDigest
from ..ops.limbs import get_ops, limbs_to_device, pack_row_words
from . import multihost
from .comm import Comm
from .dist_ntt import DistNtt, wide_split

STRATEGIES = ("auto", "rows", "wide")


def make_mesh(axis: str = "r"):
    """The 1-D mesh over every rank (multihost.make_multihost_mesh)."""
    return multihost.make_multihost_mesh(axis)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class ShardedCommit:
    """One rank's share of a sharded commitment; openable like LcCommit.

    `coeffs` is this rank's row shard (W, n_rows_pad/world, n_per_row) of
    Montgomery limbs (pad rows zero), `words` its column slice of the
    codeword's canonical hash words, (n_rows*W/2, n_cols_pad/world) int32
    (pad columns zero), and `hashes_dev` the whole Merkle array, the same on
    every rank."""

    enc: LcEncoding
    mesh: object
    coeffs: torch.Tensor
    words: torch.Tensor
    n_rows: int
    n_per_row: int
    n_cols: int
    hashes_dev: torch.Tensor  # (8, 2*np2-1) int64 digest words, leaves first
    digest: DeviceDigest = BLAKE3
    strategy: str = "rows"
    _hashes_np: "np.ndarray | None" = None
    _root: "bytes | None" = None

    @property
    def hashes(self) -> np.ndarray:
        """The flat Merkle byte array, byte-identical to the serial commit's."""
        if self._hashes_np is None:
            self._hashes_np = blake3.digests_to_bytes(self.hashes_dev)
        return self._hashes_np

    def get_root(self) -> bytes:
        if self._root is None:
            self._root = blake3.digests_to_bytes(self.hashes_dev[:, -1:])[0].tobytes()
        return self._root

    def get_n_rows(self) -> int:
        return self.n_rows

    def get_n_per_row(self) -> int:
        return self.n_per_row

    def get_n_cols(self) -> int:
        return self.n_cols

    def prove(self, outer_tensor: list[int], tr: Transcript) -> LcEvalProof:
        return sharded_prove(self, outer_tensor, tr)


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------


def _padded_rows(coeffs, enc: LcEncoding, world: int):
    """(mat, n_rows, n_per_row, n_cols): the host-replicated coefficients as
    a (W, n_rows_pad, n_per_row) matrix on the encoding's device, zero rows
    padding n_rows to a multiple of `world`."""
    arr = protocol.coeff_limbs(coeffs, enc)
    length = arr.shape[1]
    n_rows, n_per_row, n_cols = enc.get_dims(length)
    if not enc.dims_ok(n_per_row, n_cols):
        raise ProverError("TooBig", "n_cols is too large for this encoding")
    n_rows_pad = _round_up(n_rows, world)
    arr = torch.nn.functional.pad(arr, (0, n_rows_pad * n_per_row - length))
    return arr.reshape(arr.shape[0], n_rows_pad, n_per_row), n_rows, n_per_row, n_cols


def encode_reshard(enc: LcEncoding, c: Comm, rows: torch.Tensor, true_rows: int) -> torch.Tensor:
    """Encode this rank's rows and reshard the codeword's canonical hash
    words rows -> columns: (true_rows*W/2, n_cols_pad/world) int32, the
    ranks' rows in rank order with pad rows past `true_rows` dropped."""
    w32 = enc.spec.w16 // 2
    words = enc.encode_rows_lowmem(rows, post=pack_row_words, canonical=True)  # (r*W/2, nc)
    nc_pad = _round_up(enc.n_cols, c.world)
    words = torch.nn.functional.pad(words, (0, nc_pad - enc.n_cols))
    chunks = words.reshape(words.shape[0], c.world, nc_pad // c.world).transpose(0, 1)
    return c.exchange(chunks).flatten(0, 1)[: true_rows * w32]


def merkle_from_slices(c: Comm, digest: DeviceDigest, leaves: torch.Tensor,
                       n_cols: int) -> torch.Tensor:
    """Every rank's leaf digests of its column slice (8, n_cols_pad/world)
    all-gathered, the pad leaves dropped and the whole Merkle array built
    on every rank: (8, 2*np2-1) int64."""
    every = c.gather(leaves)  # (world, 8, cl)
    full = every.permute(1, 0, 2).reshape(8, -1)[:, :n_cols]
    return digest.merkle_tree(full.contiguous(), _next_pow2(n_cols))


def _pick_wide(enc: LcEncoding, strategy: str, n_rows: int, world: int) -> bool:
    """lcpc_tpu's strategy rule (mesh_protocol.py:296-311): "wide" needs a
    power-of-two Reed-Solomon codeword whose A and B both divide over the
    ranks; "auto" takes it when there are more ranks than rows."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if strategy == "rows":
        return False
    from ..encodings.ligero import LigeroEncoding

    nc = enc.n_cols
    a, b = wide_split(nc)
    ok = (isinstance(enc, LigeroEncoding) and nc & (nc - 1) == 0 and nc >= 4
          and a % world == 0 and b % world == 0)
    if strategy == "wide" and not ok:
        raise ValueError("the wide strategy needs a Ligero codeword whose A and B "
                         f"(here {a} x {b}) each divide over {world} ranks")
    return ok and (strategy == "wide" or n_rows < world)


_dist_ntts: dict = {}


def _dist_ntt(spec, n: int, mesh, device) -> DistNtt:
    """One DistNtt (its plans and this rank's twiddle slice) per size, group
    and device."""
    key = (spec, n, Comm(mesh).group, torch.device(device))
    if key not in _dist_ntts:
        _dist_ntts[key] = DistNtt(spec, n, mesh, device)
    return _dist_ntts[key]


def sharded_commit(coeffs, enc: LcEncoding, mesh=None, digest: DeviceDigest = BLAKE3,
                   strategy: str = "auto") -> ShardedCommit:
    """Commit over the ranks of `mesh` (a 1-D DeviceMesh, a ProcessGroup,
    or None for every rank); every rank calls it with the same `coeffs`
    (protocol.commit's: canonical ints or (W, N) Montgomery limbs) and gets
    the same root, equal to protocol.commit's.

    `strategy`: "rows" shards the row encodes, "wide" each row's transform
    (the DistNtt), "auto" picks wide when there are more ranks than rows
    and the encoding allows it."""
    c = Comm(mesh)
    mat, n_rows, n_per_row, n_cols = _padded_rows(coeffs, enc, c.world)
    wide = _pick_wide(enc, strategy, n_rows, c.world)
    coeffs_local = multihost.local_shard(mat, 1, c.rank, c.world).contiguous()
    if wide:
        # every rank: all rows, its B slice of each (zero-padded to n_cols)
        dn = _dist_ntt(enc.spec, n_cols, mesh, enc.device)
        x = torch.nn.functional.pad(mat[:, :n_rows], (0, n_cols - n_per_row))
        x = x.reshape(x.shape[0], n_rows, dn.a, dn.b)
        words = dn(multihost.local_shard(x, 3, c.rank, c.world).contiguous(), output="words")
    else:
        words = encode_reshard(enc, c, coeffs_local, n_rows)
    del mat
    flat = merkle_from_slices(c, digest, digest.hash_word_columns(words), n_cols)
    return ShardedCommit(enc=enc, mesh=mesh, coeffs=coeffs_local, words=words,
                         n_rows=n_rows, n_per_row=n_per_row, n_cols=n_cols,
                         hashes_dev=flat, digest=digest,
                         strategy="wide" if wide else "rows")


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------


def sharded_collapse(comm: ShardedCommit, ts: "list[list[int]]") -> np.ndarray:
    """T tensors of n_rows plain ints -> (T, n_per_row, W/2) canonical wire
    words (prove_core's collapse_words_fn): this rank's rows through
    collapse_canon, the partials all-gathered and summed mod p by
    FieldOps.sum (a binary tree of mont_addsub_map adds on the card)."""
    c = Comm(comm.mesh)
    ops = get_ops(comm.enc.spec)
    rl = comm.coeffs.shape[1]
    r0 = c.rank * rl
    local = [t[r0 : r0 + rl] + [0] * (rl - len(t[r0 : r0 + rl])) for t in ts]
    ts_l = limbs_to_device(np.stack([ops.encode_host(t) for t in local], axis=1),
                           comm.coeffs.device)  # (W, T, rl)
    parts = c.gather(ops.collapse_canon(ts_l, comm.coeffs))  # (world, W, T, npr)
    tot = ops.sum(parts.transpose(0, 1), axis=1)  # (W, T, npr) canonical
    return _pack_pairs(tot).permute(1, 2, 0).cpu().numpy().astype(np.uint32)


def sharded_open_columns(comm: ShardedCommit, cols: list[int]) -> protocol.BatchedColumns:
    """The opened columns (each from the rank whose slice holds it: one
    all_gather of every rank's picks) and their paths from the replicated
    tree (prove_core's open_columns_fn)."""
    c = Comm(comm.mesh)
    cl = comm.words.shape[1]
    idx = np.asarray(cols, dtype=np.int64)
    owner = idx // cl
    mine = np.where(owner == c.rank, idx - c.rank * cl, 0)
    dev = comm.words.device
    picked = comm.words.index_select(1, torch.as_tensor(mine, device=dev))  # (R*W/2, k)
    every = c.gather(picked)  # (world, R*W/2, k)
    sel = every[torch.as_tensor(owner, device=dev), :, torch.arange(len(cols), device=dev)]
    return protocol._open_batched(comm.enc.spec, comm.hashes_dev, comm.n_cols, comm.n_rows,
                                  cols, range(len(cols)), canon=sel.T.contiguous())


def sharded_prove(comm: ShardedCommit, outer_tensor: list[int],
                  tr: Transcript) -> LcEvalProof:
    """prove() against a sharded commitment, every rank in lockstep; the
    proof bytes equal the single-device prover's."""
    return protocol.prove_core(
        comm.enc, tr, comm.n_rows, comm.n_cols, outer_tensor,
        lambda ts: sharded_collapse(comm, ts),
        lambda cols: sharded_open_columns(comm, cols),
    )
