"""bincode-compatible wire serialization for proofs, roots, and commitments.

Byte-level mirror of the reference's serde layer (lcpc-2d/src/lib.rs:186-268,
352-397,430-487,536-609) under bincode 1.3's default config (little-endian,
fixed-width ints):

- `usize` -> u64 LE;
- `Vec<T>` -> u64 count + items;
- field element -> the ff-derive serde form: the *Montgomery* limb array as
  L u64s LE (the derive serializes the internal repr, not to_repr());
- `WrappedOutput` (digest) -> serde_bytes: u64 len + raw bytes.

Because the port's Montgomery limb form equals ff's (16*W == 64*L), a field
element's wire bytes are exactly the little-endian bytes of its 16-bit limb
vector, so bulk column serialization is a numpy repack.  Byte-identical to
lcpc_tpu/core/wire.py: proofs cross between the two packages as these bytes.
Malformed input bytes raise ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

import torch

from ..fields.spec import FieldSpec
from .protocol import LcColumn, LcEvalProof


def _u64(n: int) -> bytes:
    return struct.pack("<Q", n)


def _felem(spec: FieldSpec, v: int) -> bytes:
    return spec.to_mont(v).to_bytes(spec.repr_bytes, "little")


def _felem_vec(spec: FieldSpec, vals: list[int]) -> bytes:
    return _u64(len(vals)) + b"".join(_felem(spec, v) for v in vals)


def _col_mont_bytes(col_mont: np.ndarray) -> bytes:
    """(W, R) u32 16-bit limbs -> R elements' wire bytes (Montgomery LE)."""
    w, r = col_mont.shape
    u16 = np.asarray(col_mont, dtype=np.uint32).T.astype("<u2")  # (R, W)
    return u16.tobytes()


def _digest(b: bytes) -> bytes:
    return _u64(len(b)) + b


def _proof_row_ints(proof: LcEvalProof, which: str, i: int = 0) -> list[int]:
    """Int views of p_eval / p_random_vec[i] WITHOUT invalidating the proof's
    fast packed-row representation (the public getters hand out mutable
    lists, so they must drop the rows; serialization only reads)."""
    if which == "eval":
        if proof._p_eval is not None:
            return proof._p_eval
        from .protocol import _repr_rows_to_ints

        return _repr_rows_to_ints(proof._p_eval_rows)
    if proof._p_random_vec is not None:
        return proof._p_random_vec[i]
    from .protocol import _repr_rows_to_ints

    return _repr_rows_to_ints(proof._p_random_rows[i])


def serialize_proof(spec: FieldSpec, proof: LcEvalProof) -> bytes:
    out = [_u64(proof.n_cols)]
    out.append(_felem_vec(spec, _proof_row_ints(proof, "eval")))
    n_pr = (len(proof._p_random_vec) if proof._p_random_vec is not None
            else len(proof._p_random_rows))
    out.append(_u64(n_pr))
    for i in range(n_pr):
        out.append(_felem_vec(spec, _proof_row_ints(proof, "random", i)))
    # columns: one vectorized pass over the batched arrays (per-column
    # Python assembly costs 100s of ms at Brakedown's ~6.6k openings)
    if proof.n_columns() == 0:
        out.append(_u64(0))
        return b"".join(out)
    b = proof.columns_batched()
    halfw, n_rows, k = b.col_w.shape
    path_len = b.paths.shape[1]
    out.append(_u64(k))
    elem_bytes = n_rows * halfw * 4
    rec = np.zeros((k, 8 + elem_bytes + 8 + path_len * 40), dtype=np.uint8)
    rec[:, 0:8] = np.frombuffer(_u64(n_rows), dtype=np.uint8)
    cols_t = np.ascontiguousarray(
        np.transpose(b.col_w, (2, 1, 0)).astype("<u4")
    )  # (k, R, W/2) words, LE == Montgomery limb bytes
    rec[:, 8 : 8 + elem_bytes] = cols_t.view(np.uint8).reshape(k, elem_bytes)
    off = 8 + elem_bytes
    rec[:, off : off + 8] = np.frombuffer(_u64(path_len), dtype=np.uint8)
    pr = rec[:, off + 8 :].reshape(k, path_len, 40)
    pr[:, :, 0:8] = np.frombuffer(_u64(32), dtype=np.uint8)
    pr[:, :, 8:] = b.paths
    out.append(rec.tobytes())
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated")
        self.pos += n
        return b


def _read_felem_vec(spec: FieldSpec, r: _Reader) -> list[int]:
    n = r.u64()
    out = []
    for _ in range(n):
        m = int.from_bytes(r.take(spec.repr_bytes), "little")
        if m >= spec.p:
            raise ValueError("non-canonical field element")
        out.append(spec.from_mont(m))
    return out


def deserialize_proof(spec: FieldSpec, data: bytes) -> LcEvalProof:
    from .protocol import BatchedColumns

    r = _Reader(data)
    n_cols = r.u64()
    p_eval = _read_felem_vec(spec, r)
    n_pr = r.u64()
    p_random_vec = [_read_felem_vec(spec, r) for _ in range(n_pr)]
    n_columns = r.u64()
    w = spec.w16
    if n_columns == 0:
        if r.pos != len(data):
            raise ValueError("trailing bytes")
        return LcEvalProof(n_cols=n_cols, p_eval=p_eval,
                           p_random_vec=p_random_vec, columns=[])
    # rectangular fast path: every honest proof has uniform (n_rows,
    # path_len, 32-byte digests), so the column block parses as one array
    n_rows = r.u64()
    elem_bytes = n_rows * spec.repr_bytes
    path_len_probe = struct.unpack_from("<Q", data, r.pos + elem_bytes)[0]
    rec_size = 8 + elem_bytes + 8 + path_len_probe * 40
    r.pos -= 8
    if len(data) - r.pos != n_columns * rec_size:
        raise ValueError("malformed columns")
    rec = np.frombuffer(r.take(n_columns * rec_size), dtype=np.uint8).reshape(
        n_columns, rec_size
    )
    heads = rec[:, 0:8].copy().view("<u8").reshape(-1)
    if not (heads == n_rows).all():
        raise ValueError("ragged column rows")
    pl = rec[:, 8 + elem_bytes : 16 + elem_bytes].copy().view("<u8").reshape(-1)
    if not (pl == path_len_probe).all():
        raise ValueError("ragged path lengths")
    pr = rec[:, 16 + elem_bytes :].reshape(n_columns, path_len_probe, 40)
    lens = np.ascontiguousarray(pr[:, :, 0:8]).view("<u8")
    if not (lens == 32).all():
        raise ValueError("bad digest length")
    paths = np.ascontiguousarray(pr[:, :, 8:])  # (k, L, 32)
    words = np.ascontiguousarray(rec[:, 8 : 8 + elem_bytes]).view(
        "<u4"
    ).reshape(n_columns, n_rows, w // 2)
    col_w = np.ascontiguousarray(np.transpose(words, (2, 1, 0))).astype(
        np.uint32
    )
    if r.pos != len(data):
        raise ValueError("trailing bytes")
    return LcEvalProof(
        n_cols=n_cols, p_eval=p_eval, p_random_vec=p_random_vec,
        columns_batched=BatchedColumns(col_w=col_w, paths=paths),
    )


def serialize_root(root: bytes) -> bytes:
    return _digest(root)


def deserialize_root(data: bytes) -> bytes:
    r = _Reader(data)
    ln = r.u64()
    out = r.take(ln)
    if r.pos != len(data):
        raise ValueError("malformed wire bytes")
    return out


def proof_size_bytes(spec: FieldSpec, proof: LcEvalProof) -> int:
    """Size of the bincode encoding (comparable to BASELINE proof sizes)."""
    return len(serialize_proof(spec, proof))


# ---------------------------------------------------------------------------
# commitment (prover state) serialization — the reference's checkpoint/resume
# analogue (full serde of LcCommit incl. both matrices, lib.rs:186-268)
# ---------------------------------------------------------------------------


def _mont_matrix_bytes(arr) -> bytes:
    """(W, R, C) 16-bit Montgomery limbs (tensor or array) -> row-major
    element wire bytes."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    # element order: row-major over (R, C); limbs LE within each element
    u16 = np.ascontiguousarray(
        np.moveaxis(np.asarray(arr, dtype=np.uint32), 0, 2)
    ).astype("<u2")  # (R, C, W)
    return u16.tobytes()


def serialize_commit(spec: FieldSpec, comm) -> bytes:
    """bincode of WrappedLcCommit { comm, coeffs, n_rows, n_cols, n_per_row,
    hashes } (lcpc-2d/src/lib.rs:186-197)."""
    out = [
        _u64(comm.n_rows * comm.n_cols),
        _mont_matrix_bytes(comm.comm),
        _u64(comm.n_rows * comm.n_per_row),
        _mont_matrix_bytes(comm.coeffs),
        _u64(comm.n_rows),
        _u64(comm.n_cols),
        _u64(comm.n_per_row),
        _u64(comm.hashes.shape[0]),
    ]
    for i in range(comm.hashes.shape[0]):
        out.append(_digest(bytes(comm.hashes[i])))
    return b"".join(out)


def deserialize_commit(spec: FieldSpec, data: bytes, enc, digest=None):
    """Rebuild an LcCommit (device tensors on enc.device) from serialize_commit.

    The digest lives in the Rust TYPE, not the byte stream, so the caller
    declares it here (default BLAKE3), as Rust deserializes into a concrete
    LcCommit<D, E>."""
    from ..ops import blake3
    from ..ops.digest import BLAKE3
    from .protocol import LcCommit

    if digest is None:
        digest = BLAKE3

    r = _Reader(data)
    w = spec.w16

    def read_matrix(count):
        raw = r.take(count * spec.repr_bytes)
        u16 = np.frombuffer(raw, dtype="<u2").reshape(count, w)
        return np.ascontiguousarray(u16.T).astype(np.int32)

    n_comm = r.u64()
    comm_flat = read_matrix(n_comm)
    n_coeffs = r.u64()
    coeffs_flat = read_matrix(n_coeffs)
    n_rows = r.u64()
    n_cols = r.u64()
    n_per_row = r.u64()
    n_hashes = r.u64()
    hashes = np.empty((n_hashes, 32), dtype=np.uint8)
    for i in range(n_hashes):
        ln = r.u64()
        hashes[i] = np.frombuffer(r.take(ln), dtype=np.uint8)
    if r.pos != len(data):
        raise ValueError("malformed wire bytes")
    if n_comm != n_rows * n_cols or n_coeffs != n_rows * n_per_row:
        raise ValueError("malformed wire bytes")
    dev = enc.device
    return LcCommit(
        enc=enc,
        coeffs=torch.from_numpy(coeffs_flat.reshape(w, n_rows, n_per_row)).to(dev),
        comm=torch.from_numpy(comm_flat.reshape(w, n_rows, n_cols)).to(dev),
        n_rows=n_rows,
        n_per_row=n_per_row,
        n_cols=n_cols,
        hashes_dev=torch.from_numpy(
            blake3.bytes_to_digests(hashes).astype(np.int64)).to(dev),
        digest=digest,
        _hashes_np=hashes,
    )
