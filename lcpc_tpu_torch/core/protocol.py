"""The 2-D linear-code polynomial commitment: commit / prove / verify (torch).

Port of lcpc_tpu/core/protocol.py (itself lcpc-2d/src/lib.rs:622-1123):

- commit: pad coefficients into an (n_rows x n_per_row) matrix, batch-encode
  every row on the encoding's device, canonicalize and pack to LE words,
  hash columns and build the Merkle tree there (lib.rs:622-704);
- prove: per degree test, draw a ChaCha tensor from the transcript, collapse
  the coefficient matrix on the device, then Fiat-Shamir column sampling and
  column openings (lib.rs:1004-1123);
- verify: re-derive the challenges, re-encode the proof rows on the device,
  and check every opened column's Merkle path and degree-test/eval dot
  products in one batched step (lib.rs:832-1000).

Fiat-Shamir order is load-bearing: p_random(s) -> p_eval -> column indices,
with columns sampled WITH replacement (lib.rs:1024-1080).  Device tensors are
int32 16-bit Montgomery limbs and int64 u32 words; what crosses to the host
is numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fs.chacha import ChaCha20Rng
from ..fs.merlin import Transcript
from ..fs.sampling import field_random_vec, uniform_indices
from ..ops import blake3
from ..ops.digest import BLAKE3, DeviceDigest
from ..ops.limbs import get_ops, limbs_to_device, pack_row_words
from .encoding import LcEncoding


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


# ---------------------------------------------------------------------------
# data types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LcCommit:
    """Prover state (lcpc-2d/src/lib.rs:173-184).

    The Merkle array stays on the device as digest words (hashes_dev,
    (8, 2*np2-1) int64 u32 words, leaves first): the host only needs the
    32-byte root and the path nodes of each proof.  The byte view
    materializes lazily for serialization/inspection.
    """

    enc: LcEncoding
    coeffs: torch.Tensor  # (W, n_rows, n_per_row) int32 Montgomery limbs
    comm: torch.Tensor    # (W, n_rows, n_cols) int32 Montgomery limbs
    n_rows: int
    n_per_row: int
    n_cols: int
    hashes_dev: torch.Tensor  # (8, 2*np2-1) int64 digest words, leaves first
    digest: DeviceDigest = BLAKE3
    _hashes_np: "np.ndarray | None" = None
    _root: "bytes | None" = None

    @property
    def hashes(self) -> np.ndarray:
        """Full flat Merkle array as (2*np2-1, 32) u8 (lib.rs layout)."""
        if self._hashes_np is None:
            self._hashes_np = blake3.digests_to_bytes(self.hashes_dev)
        return self._hashes_np

    def get_root(self) -> bytes:
        if self._root is None:
            if self._hashes_np is not None:
                self._root = bytes(self._hashes_np[-1])
            else:
                self._root = blake3.digests_to_bytes(
                    self.hashes_dev[:, -1:])[0].tobytes()
        return self._root

    def get_n_rows(self) -> int:
        return self.n_rows

    def get_n_per_row(self) -> int:
        return self.n_per_row

    def get_n_cols(self) -> int:
        return self.n_cols

    def prove(self, outer_tensor: list[int], tr: Transcript) -> "LcEvalProof":
        return prove(self, outer_tensor, self.enc, tr)


@dataclasses.dataclass
class LcColumn:
    """One opened column + Merkle path (lib.rs:401-408).

    col_mont holds the column values as Montgomery 16-bit limbs (W, n_rows) —
    numerically identical to the Rust wire form, so serialization repacks.
    """

    col_mont: np.ndarray  # (W, n_rows) uint32 16-bit limbs
    path: list[bytes]


@dataclasses.dataclass
class BatchedColumns:
    """All opened columns + paths as two rectangular arrays (the form the
    prover's gather emits and verify/serialize consume wholesale)."""

    col_w: np.ndarray  # (W/2, n_rows, k) packed u32 Montgomery words
    paths: np.ndarray  # (k, path_len, 32) uint8 sibling digests


class LcEvalProof:
    """Evaluation proof (lib.rs:491-500).

    The row vectors are held in EITHER of two equivalent forms: packed
    canonical to_repr rows ((n, repr_bytes) uint8, the form the prover's
    collapse emits and the transcript absorbs) or lists of Python ints, which
    materialize lazily on first access; a materialized list may be mutated by
    the caller, so materializing invalidates the rows.  Columns follow the
    same two-form pattern: a BatchedColumns array pair or a mutable list of
    LcColumn; materializing the list invalidates the batched form.
    """

    def __init__(self, n_cols: int, p_eval=None, p_random_vec=None,
                 columns=None, *, p_eval_rows=None, p_random_rows=None,
                 columns_batched: "BatchedColumns | None" = None):
        self.n_cols = n_cols
        assert (columns is None) != (columns_batched is None)
        self._columns_list: "list[LcColumn] | None" = columns
        self._columns_batched = columns_batched
        assert (p_eval is None) != (p_eval_rows is None)
        assert (p_random_vec is None) != (p_random_rows is None)
        self._p_eval = p_eval
        self._p_eval_rows = p_eval_rows
        self._p_random_vec = p_random_vec
        self._p_random_rows = p_random_rows

    # -- column views ----------------------------------------------------------

    @property
    def columns(self) -> "list[LcColumn]":
        """Mutable per-column view (the reference's pub Vec<LcColumn>);
        materializing invalidates the batched arrays (they may go stale)."""
        if self._columns_list is None:
            b = self._columns_batched
            gathered = _unpack_cols(b.col_w)  # (W, R, k)
            k = b.col_w.shape[2]
            self._columns_list = [
                LcColumn(
                    col_mont=gathered[:, :, j],
                    path=[bytes(b.paths[j, lvl]) for lvl in range(b.paths.shape[1])],
                )
                for j in range(k)
            ]
            self._columns_batched = None
        return self._columns_list

    @columns.setter
    def columns(self, v: "list[LcColumn]") -> None:
        self._columns_list = v
        self._columns_batched = None

    def n_columns(self) -> int:
        if self._columns_batched is not None:
            return self._columns_batched.col_w.shape[2]
        return len(self._columns_list)

    def columns_batched(self) -> "BatchedColumns":
        """Batched array view; built from the list form if needed (the list
        must be rectangular — verify() pre-checks for typed errors)."""
        if self._columns_batched is not None:
            return self._columns_batched
        cols = self._columns_list
        col_mat = np.stack([c.col_mont for c in cols], axis=2)  # (W, R, k)
        col_w = col_mat[0::2] | (col_mat[1::2] << np.uint32(16))
        paths = np.frombuffer(
            b"".join(b"".join(c.path) for c in cols), dtype=np.uint8
        ).reshape(len(cols), len(cols[0].path), 32)
        return BatchedColumns(col_w=col_w, paths=paths)

    # -- lazy int views (mutable, like the reference's pub Vec fields) ---------

    @property
    def p_eval(self) -> list[int]:
        if self._p_eval is None:
            self._p_eval = _repr_rows_to_ints(self._p_eval_rows)
            self._p_eval_rows = None  # the list may be mutated; rows go stale
        return self._p_eval

    @p_eval.setter
    def p_eval(self, v: list[int]) -> None:
        self._p_eval = v
        self._p_eval_rows = None

    @property
    def p_random_vec(self) -> list[list[int]]:
        if self._p_random_vec is None:
            self._p_random_vec = [
                _repr_rows_to_ints(r) for r in self._p_random_rows
            ]
            self._p_random_rows = None
        return self._p_random_vec

    @p_random_vec.setter
    def p_random_vec(self, v: list[list[int]]) -> None:
        self._p_random_vec = v
        self._p_random_rows = None

    # -- repr-row views (fast path for verify/serialize) ------------------------

    def p_eval_as_rows(self, spec) -> np.ndarray:
        if self._p_eval_rows is not None:
            return self._p_eval_rows
        return _ints_to_repr_rows(spec, self._p_eval)

    def n_degree_rows(self) -> int:
        if self._p_random_rows is not None:
            return len(self._p_random_rows)
        return len(self._p_random_vec)

    def p_random_as_rows(self, spec, i: int) -> np.ndarray:
        if self._p_random_rows is not None:
            return self._p_random_rows[i]
        return _ints_to_repr_rows(spec, self._p_random_vec[i])

    def get_n_cols(self) -> int:
        return self.n_cols

    def get_n_per_row(self) -> int:
        if self._p_eval is not None:
            return len(self._p_eval)
        return self._p_eval_rows.shape[0]

    def verify(self, root: bytes, outer_tensor: list[int], inner_tensor: list[int],
               enc: LcEncoding, tr: Transcript,
               digest: "DeviceDigest" = BLAKE3) -> int:
        return verify(root, outer_tensor, inner_tensor, self, enc, tr, digest)


class ProverError(Exception):
    """Typed prover failure (ProverError, lcpc-2d/src/lib.rs:111-132).

    kinds: "TooBig" (encoding cannot produce dims), "Encode" (row encode
    failed), "Commit" (inconsistent commitment fields), "ColumnNumber"
    (opened column out of range), "OuterTensor" (wrong tensor size).
    """

    def __init__(self, kind: str, msg: "str | None" = None):
        super().__init__(msg or kind)
        self.kind = kind


class VerifierError(Exception):
    """Typed verifier failure (VerifierError, lcpc-2d/src/lib.rs:138-169).

    kinds: "NumColOpens", "ColumnPath", "ColumnEval", "ColumnDegree",
    "OuterTensor", "InnerTensor", "EncodingDims", "Encode".
    """

    def __init__(self, kind: str):
        super().__init__(kind)
        self.kind = kind


# ---------------------------------------------------------------------------
# commit (lib.rs:622-785)
# ---------------------------------------------------------------------------


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 storage of u32 words -> their u32 values as int64."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _pack_words(canon: torch.Tensor) -> torch.Tensor:
    """(W, R, C) canonical limbs -> (R*W/2, C) LE u32 words (int64), row-major."""
    return _u32(pack_row_words(canon))


def _hash_and_merkleize(words: torch.Tensor, n_cols_np2: int,
                        digest: DeviceDigest = BLAKE3) -> torch.Tensor:
    """Column digests of the (R*W/2, n_cols) canonical hash words (int32
    storage) + every Merkle layer, flattened leaves first: (8, 2*np2-1)
    int64."""
    n_cols = words.shape[1]
    leaves = digest.hash_word_columns(_u32(words))  # (8, n_cols)
    if n_cols_np2 > n_cols:  # zero digests pad the leaves (lib.rs:665)
        leaves = torch.nn.functional.pad(leaves, (0, n_cols_np2 - n_cols))
    layers = [leaves]
    while layers[-1].shape[1] > 1:
        layers.append(digest.merkle_layer(layers[-1]))
    return torch.cat(layers, dim=1)


def commit(coeffs: "list[int] | np.ndarray | torch.Tensor", enc: LcEncoding,
           digest: DeviceDigest = BLAKE3) -> LcCommit:
    """Commit to a polynomial (lib.rs:622-671) on the encoding's device.

    `coeffs` is either a list of canonical Python ints, or a (W, N) limb
    array/tensor already in Montgomery form.  `digest` selects the hash.
    """
    ops = get_ops(enc.spec)
    if isinstance(coeffs, list):
        arr = limbs_to_device(ops.encode_host(coeffs), enc.device)  # (W, N)
    elif isinstance(coeffs, np.ndarray):
        arr = limbs_to_device(coeffs, enc.device)
    else:
        arr = coeffs.to(device=enc.device, dtype=torch.int32)
    if arr.dim() != 2 or arr.shape[0] != ops.w:
        raise ValueError(f"coeffs must be ({ops.w}, N) limbs, got {tuple(arr.shape)}")
    length = arr.shape[1]

    n_rows, n_per_row, n_cols = enc.get_dims(length)
    assert n_rows * n_per_row >= length
    assert (n_rows - 1) * n_per_row < length
    if not enc.dims_ok(n_per_row, n_cols):
        # the reference's ProverError::TooBig path (lib.rs:627)
        raise ProverError("TooBig", "n_cols is too large for this encoding")

    pad = n_rows * n_per_row - length
    if pad:
        arr = torch.nn.functional.pad(arr, (0, pad))
    mat = arr.reshape(ops.w, n_rows, n_per_row)
    comm_mat, words = enc.encode_rows_words(mat)  # (W, n_rows, n_cols), hash words
    n_cols_np2 = _next_pow2(n_cols)
    flat = _hash_and_merkleize(words, n_cols_np2, digest)
    assert flat.shape[1] == 2 * n_cols_np2 - 1

    return LcCommit(
        enc=enc,
        coeffs=mat,
        comm=comm_mat,
        n_rows=n_rows,
        n_per_row=n_per_row,
        n_cols=n_cols,
        hashes_dev=flat,
        digest=digest,
    )


# ---------------------------------------------------------------------------
# prove (lib.rs:1004-1123)
# ---------------------------------------------------------------------------


def _repr_rows_to_ints(rows: np.ndarray) -> list[int]:
    return [int.from_bytes(rows[i].tobytes(), "little") for i in range(rows.shape[0])]


def _ints_to_repr_rows(spec, vals: list[int]) -> np.ndarray:
    buf = b"".join(spec.to_repr(v) for v in vals)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(vals), spec.repr_bytes)


def _words_to_repr_rows(words: np.ndarray) -> np.ndarray:
    """(n, W/2) u32 LE words -> (n, 2W) uint8 repr rows."""
    w32 = np.ascontiguousarray(words.astype("<u4"))
    return w32.view(np.uint8).reshape(words.shape[0], -1)


def _rows_lt_p(spec, rows: np.ndarray) -> bool:
    """Vectorized canonical-range check: every repr row < p."""
    u16 = rows.view("<u2")  # (n, W)
    n, w = u16.shape
    lt = np.zeros(n, dtype=bool)
    eq = np.ones(n, dtype=bool)
    for i in range(w - 1, -1, -1):
        pi = (spec.p >> (16 * i)) & 0xFFFF
        lt |= eq & (u16[:, i] < pi)
        eq &= u16[:, i] == pi
    return bool(lt.all())


def path_node_indices(n_cols: int, cols: list[int]) -> np.ndarray:
    """(k, path_len) flat indices of the sibling nodes for each opened column
    within the leaves-first hashes array (open_column, lib.rs:788-825)."""
    n_cols_np2 = _next_pow2(n_cols)
    path_len = max(0, n_cols_np2.bit_length() - 1)
    offsets = []
    off = 0
    size = n_cols_np2
    while size >= 1:
        offsets.append(off)
        off += size
        if size == 1:
            break
        size //= 2
    cc = np.asarray(cols, dtype=np.int64)[:, None] >> np.arange(path_len)[None, :]
    return (np.asarray(offsets[:path_len], dtype=np.int64)[None, :] + (cc ^ 1)
            ).astype(np.int32)


def _pack_pairs(limbs: torch.Tensor) -> torch.Tensor:
    """(W, ...) 16-bit limbs -> (W/2, ...) u32 words (int64)."""
    limbs = limbs.to(torch.int64)
    return limbs[0::2] | (limbs[1::2] << 16)


def _gather_open(comm_arr: torch.Tensor, hashes_dev: torch.Tensor,
                 col_idx: torch.Tensor, path_idx: torch.Tensor):
    """Everything prove pulls per opening: packed column words (W/2, R, k)
    and the sibling path digests (8, U) gathered from the Merkle array."""
    packed = _pack_pairs(comm_arr.index_select(2, col_idx))
    path_digs = hashes_dev.index_select(1, path_idx)
    return packed, path_digs


def _unpack_cols(words: np.ndarray) -> np.ndarray:
    """(W/2, R, k) u32 words -> (W, R, k) u32 16-bit limbs."""
    half, r, k = words.shape
    out = np.empty((2 * half, r, k), dtype=np.uint32)
    out[0::2] = words & np.uint32(0xFFFF)
    out[1::2] = words >> np.uint32(16)
    return out


def _open_columns(comm: LcCommit, cols: list[int]) -> BatchedColumns:
    """Extract columns + Merkle paths (open_column, lib.rs:788-825); only the
    UNIQUE path nodes (paths share most upper-tree nodes) leave the device."""
    device = comm.comm.device
    col_idx = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=device)
    path_idx = path_node_indices(comm.n_cols, cols)  # (k, L)
    uniq, inv = np.unique(path_idx.reshape(-1), return_inverse=True)
    packed, path_digs = _gather_open(
        comm.comm, comm.hashes_dev, col_idx,
        torch.as_tensor(uniq.astype(np.int64), device=device))
    uniq_bytes = blake3.digests_to_bytes(path_digs)  # (n_uniq, 32)
    paths = uniq_bytes[inv.reshape(-1)].reshape(len(cols), path_idx.shape[1], 32)
    return BatchedColumns(col_w=packed.cpu().numpy().astype(np.uint32),
                          paths=paths)


def prove_core(enc: LcEncoding, tr: Transcript, n_rows: int, n_cols: int,
               outer_tensor: list[int], collapse_words_fn, open_columns_fn,
               ) -> LcEvalProof:
    """Fiat-Shamir choreography of prove (lib.rs:1004-1093).

    collapse_words_fn: (W, T, n_rows) Montgomery np tensor stack ->
        (T, n_per_row, W/2) canonical wire words (numpy uint32).
    open_columns_fn: list of column indices -> BatchedColumns.
    The FS order p_random(s) -> p_eval -> column indices is load-bearing.
    """
    spec = enc.spec
    ops = get_ops(spec)
    if len(outer_tensor) != n_rows:
        raise ProverError("OuterTensor", "outer tensor: wrong size")

    n_degree_tests_ = enc.get_n_degree_tests()
    # the eval collapse rides the final degree test's device call, so the
    # loop must run at least once (lib.rs:613-616: a ceil of a positive ratio)
    assert n_degree_tests_ >= 1
    outer_limbs = ops.encode_host(outer_tensor)  # (W, R) Montgomery
    p_random_rows: list[np.ndarray] = []
    eval_rows = None
    for i in range(n_degree_tests_):
        key = tr.challenge_bytes(enc.LABEL_DT, 32)
        rng = ChaCha20Rng(key)
        rand_tensor = field_random_vec(spec, rng, n_rows)
        t = ops.encode_host(rand_tensor)
        if i == n_degree_tests_ - 1:
            ts = np.stack([t, outer_limbs], axis=1)  # (W, 2, R)
        else:
            ts = t[:, None, :]
        words = collapse_words_fn(ts)  # (T, npr, W/2) canonical words
        rows = _words_to_repr_rows(words[0])
        tr.append_elements(enc.LABEL_PR, rows)
        p_random_rows.append(rows)
        if i == n_degree_tests_ - 1:
            eval_rows = _words_to_repr_rows(words[1])

    tr.append_elements(enc.LABEL_PE, eval_rows)

    n_col_opens = enc.get_n_col_opens()
    key = tr.challenge_bytes(enc.LABEL_CO, 32)
    cols_rng = ChaCha20Rng(key)
    cols_to_open = uniform_indices(n_cols, cols_rng, n_col_opens)
    columns = open_columns_fn(cols_to_open)

    return LcEvalProof(
        n_cols=n_cols,
        p_eval_rows=eval_rows,
        p_random_rows=p_random_rows,
        columns_batched=columns,
    )


def prove(comm: LcCommit, outer_tensor: list[int], enc: LcEncoding,
          tr: Transcript) -> LcEvalProof:
    """Evaluation proof for `comm` on the commitment's device."""
    ops = get_ops(enc.spec)
    device = comm.coeffs.device

    def collapse_words_fn(ts: np.ndarray) -> np.ndarray:
        words = ops.collapse_words(limbs_to_device(ts, device), comm.coeffs)
        return words.cpu().numpy().astype(np.uint32)

    return prove_core(
        enc, tr, comm.n_rows, comm.n_cols, outer_tensor,
        collapse_words_fn, functools.partial(_open_columns, comm),
    )


# ---------------------------------------------------------------------------
# verify (lib.rs:832-1000)
# ---------------------------------------------------------------------------


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(W/2, ...) u32 words (int64) -> (W, ...) int32 16-bit limbs."""
    lo = words & 0xFFFF
    hi = words >> 16
    return torch.stack([lo, hi], dim=1).reshape(-1, *words.shape[1:]).to(torch.int32)


def _rows_encode(enc: LcEncoding, rows_w: torch.Tensor) -> torch.Tensor:
    """Packed repr words (T, npr, W/2) -> encoded rows (W, T, n_cols)."""
    ops = get_ops(enc.spec)
    rows_raw = _unpack_words(rows_w.permute(2, 0, 1))  # (W, T, npr) canonical
    return enc.encode_rows(ops.to_mont(rows_raw))


def _eval_dot(ops, rows_w: torch.Tensor, inner_w: torch.Tensor) -> torch.Tensor:
    """Σ inner_tensor[j] * p_eval[j] mod p on the device, (W,) canonical limbs.

    rows_w: (T, npr, W/2) canonical repr words, p_eval last; inner_w:
    (npr, W/2) canonical words (lib.rs:947-951)."""
    pe = ops.to_mont(_unpack_words(rows_w[-1:].permute(2, 0, 1)))     # (W, 1, npr)
    inner = ops.to_mont(_unpack_words(inner_w[None].permute(2, 0, 1)))  # (W, 1, npr)
    return ops.collapse_canon(inner, pe.permute(0, 2, 1)).reshape(-1)


def _verify_core(ops, digest: DeviceDigest, enc_rows, ts, col_w, idx,
                 uniq_sibs, inv, bits, root_w) -> np.ndarray:
    """The batched verifier step, all on the device:

      enc_rows  (W, T, n_cols) Montgomery — encoded [p_random..., p_eval]
      ts        (W, T, R) Montgomery — [rand_tensors..., outer_tensor]
      col_w     (W/2, R, k) — opened column values, packed Montgomery words
      idx       (k,) — opened column indices
      uniq_sibs (8, U) — unique sibling digests
      inv       (L, k) — per-level map from column to unique digest
      bits      (L, k) bool — is-right bit of the walk at each level
      root_w    (8,) — expected root digest words
    Returns (T+1,) bool flags: per-row dot checks [0..T), path check [T].
    """
    col_mat = _unpack_words(col_w)                       # (W, R, k)
    got = ops.collapse_canon(ts, col_mat)                # (W, T, k) canonical
    want = ops.from_mont(enc_rows.index_select(2, idx))
    ok_rows = (got == want).all(dim=2).all(dim=0)        # (T,)

    digs = digest.hash_word_columns(_pack_words(ops.from_mont(col_mat)))  # (8, k)
    for lvl in range(inv.shape[0]):
        s = uniq_sibs.index_select(1, inv[lvl])          # (8, k)
        is_right = bits[lvl]
        left = torch.where(is_right, s, digs)
        right = torch.where(is_right, digs, s)
        digs = digest.merkle_parent(left, right)
    ok_path = (digs == root_w[:, None]).all()
    return torch.cat([ok_rows, ok_path[None]]).cpu().numpy()


def verify(root: bytes, outer_tensor: list[int], inner_tensor: list[int],
           proof: LcEvalProof, enc: LcEncoding, tr: Transcript,
           digest: DeviceDigest = BLAKE3) -> int:
    """Verify an evaluation proof on the encoding's device; returns the
    evaluation (lib.rs:832-952).  `digest` must match the committer's."""
    spec = enc.spec
    ops = get_ops(spec)
    device = enc.device

    n_col_opens = enc.get_n_col_opens()
    if n_col_opens != proof.n_columns() or n_col_opens == 0:
        raise VerifierError("NumColOpens")
    if proof._columns_batched is not None:
        n_rows = proof._columns_batched.col_w.shape[1]
    else:
        n_rows = proof._columns_list[0].col_mont.shape[1]
    n_cols = proof.get_n_cols()
    n_per_row = proof.get_n_per_row()
    if len(inner_tensor) != n_per_row:
        raise VerifierError("InnerTensor")
    if len(outer_tensor) != n_rows:
        raise VerifierError("OuterTensor")
    if not enc.dims_ok(n_per_row, n_cols):
        raise VerifierError("EncodingDims")

    # structural validation of the (untrusted) proof before any batching,
    # with the reference's error kinds (lib.rs:862-944)
    n_degree_tests_ = enc.get_n_degree_tests()
    # the reference indexes proof.p_random_vec[0..ndt) (lib.rs:868-894):
    # extra rows are ignored; missing rows are a typed failure here
    if proof.n_degree_rows() < n_degree_tests_:
        raise VerifierError("EncodingDims")
    try:
        # int-backed proofs re-encode here; to_repr's range assert rejects
        # out-of-range elements (row-backed proofs are range-checked below)
        p_random_rows = [
            proof.p_random_as_rows(spec, i) for i in range(n_degree_tests_)
        ]
        p_eval_rows = proof.p_eval_as_rows(spec)
    except (AssertionError, OverflowError):
        raise VerifierError("EncodingDims")
    for rows_i in p_random_rows:
        if rows_i.shape[0] > n_cols:
            # a row LONGER than n_cols fails inside enc.encode (lib.rs:882-888)
            raise VerifierError("Encode")
        if not _rows_lt_p(spec, rows_i):
            raise VerifierError("EncodingDims")
    odd_rows = any(r.shape[0] != n_per_row for r in p_random_rows)
    if not _rows_lt_p(spec, p_eval_rows):
        raise VerifierError("EncodingDims")
    expected_path_len = max(0, _next_pow2(n_cols).bit_length() - 1)
    if proof._columns_batched is not None:
        batched = proof._columns_batched
        if batched.col_w.shape != (ops.w // 2, n_rows, n_col_opens):
            raise VerifierError("ColumnDegree")
        if batched.paths.shape != (n_col_opens, expected_path_len, 32):
            raise VerifierError("ColumnPath")
    else:
        for col in proof._columns_list:
            if col.col_mont.shape != (ops.w, n_rows):
                raise VerifierError("ColumnDegree")
            if len(col.path) != expected_path_len or any(
                len(h) != 32 for h in col.path
            ):
                raise VerifierError("ColumnPath")
        batched = proof.columns_batched()

    # step 1 (host/transcript only): re-derive degree-test tensors and the
    # column challenge — FS order p_random(s) -> p_eval -> columns
    rand_tensors: list[list[int]] = []
    for i in range(n_degree_tests_):
        key = tr.challenge_bytes(enc.LABEL_DT, 32)
        rng = ChaCha20Rng(key)
        rand_tensors.append(field_random_vec(spec, rng, n_rows))
        tr.append_elements(enc.LABEL_PR, p_random_rows[i])

    tr.append_elements(enc.LABEL_PE, p_eval_rows)

    key = tr.challenge_bytes(enc.LABEL_CO, 32)
    cols_rng = ChaCha20Rng(key)
    cols_to_open = uniform_indices(n_cols, cols_rng, n_col_opens)

    # step 2 (device): encode the proof rows, check every opened column's
    # degree/eval dot products and Merkle path
    T = n_degree_tests_ + 1
    # the evaluation Σ inner·p_eval (lib.rs:947-951) runs on the device when
    # the rows do; the host dot covers the odd-rows path and unreduced inner
    fuse_eval = not odd_rows and all(0 <= v < spec.p for v in inner_tensor)
    if odd_rows:
        # wrong-LENGTH p_random rows (<= n_cols) are valid inputs to the
        # reference verifier: it zero-pads to n_cols and encodes
        # (lib.rs:882-888), and the mismatch surfaces as ColumnDegree.  The
        # batched encode needs uniform row lengths, so take the host twin.
        cols_list = []
        for r_ in p_random_rows + [p_eval_rows]:
            cw = enc.encode_row_host(_repr_rows_to_ints(r_))
            cols_list.append(ops.encode_host(cw))
        enc_rows = limbs_to_device(np.stack(cols_list, axis=1), device)  # (W, T, nc)
    else:
        rows_w = np.stack(
            [np.ascontiguousarray(r).view("<u4") for r in p_random_rows]
            + [np.ascontiguousarray(p_eval_rows).view("<u4")],
            axis=0,
        )  # (T, n_per_row, W/2) canonical repr words
        rows_dev = torch.from_numpy(rows_w.astype(np.int64)).to(device)
        enc_rows = _rows_encode(enc, rows_dev)

    ts = np.stack(
        [ops.encode_host(t) for t in rand_tensors] + [ops.encode_host(outer_tensor)],
        axis=1,
    )  # (W, T, n_rows) Montgomery
    idx = np.asarray(cols_to_open, dtype=np.int64)

    # sibling digests dedup by VALUE (honest paths share most upper-tree
    # nodes); equal values collapsing to one slot is check-for-check
    # equivalent to independent per-path walks (lib.rs:955-982).  Group by
    # TREE POSITION first and confirm value consistency with one compare;
    # inconsistent groups (adversarial only) fall back to value dedup.
    path_len = expected_path_len
    flat = np.ascontiguousarray(batched.paths).reshape(-1, 32)
    pos = path_node_indices(n_cols, cols_to_open).reshape(-1)  # (k*L,)
    _, first_idx, inv = np.unique(pos, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    uniq_bytes = flat[first_idx]  # (U, 32) representative per position
    if not np.array_equal(uniq_bytes[inv], flat):
        uniq_v, inv = np.unique(
            flat.view([("v", "V32")]).reshape(-1), return_inverse=True
        )
        inv = inv.reshape(-1)
        uniq_bytes = np.ascontiguousarray(uniq_v.view(np.uint8)).reshape(-1, 32)
    uniq_sibs = blake3.bytes_to_digests(uniq_bytes)  # (8, U)
    inv = np.ascontiguousarray(inv.reshape(n_col_opens, path_len).T)  # (L, k)
    bits = ((idx[None, :] >> np.arange(path_len)[:, None]) & 1).astype(bool)
    root_w = np.frombuffer(root, dtype="<u4").astype(np.int64)

    dev = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(device)
    flags = _verify_core(
        ops, digest, enc_rows, limbs_to_device(ts, device),
        dev(batched.col_w, np.int64), dev(idx, np.int64),
        dev(uniq_sibs, np.int64), dev(inv, np.int64), dev(bits, np.bool_),
        dev(root_w, np.int64),
    )
    for i in range(n_degree_tests_):
        if not flags[i]:
            raise VerifierError("ColumnDegree")
    if not flags[n_degree_tests_]:
        raise VerifierError("ColumnEval")
    if not flags[T]:
        raise VerifierError("ColumnPath")

    if fuse_eval:
        inner_w = ops.encode_repr_words(inner_tensor)  # (npr, W/2)
        ev = _eval_dot(ops, rows_dev, dev(inner_w, np.int64))
        return int.from_bytes(
            ev.cpu().numpy().astype("<u2").tobytes(), "little")
    # host evaluation dot (odd-rows path / unreduced inner)
    acc = 0
    for t_v, e_v in zip(inner_tensor, _repr_rows_to_ints(p_eval_rows)):
        acc = (acc + t_v * e_v) % spec.p
    return acc
