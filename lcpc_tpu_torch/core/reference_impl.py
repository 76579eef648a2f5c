"""Serial host twin of the full protocol (Python ints and the host BLAKE3),
a port of lcpc_tpu/core/reference_impl.py.

This mirrors the reference's test strategy of keeping serial twins of every
parallel kernel (lcpc-2d/src/lib.rs:1127-1249, tests.rs:137-165): the device
path must agree with this module bit-for-bit on small instances, and at
ft255 it is the yardstick of the port's tests (sharded paths included)
where lcpc_tpu's jitted graphs would compile for minutes.  Only suitable
for tiny sizes.
"""

from __future__ import annotations

import dataclasses

from ..fields.spec import FieldSpec
from ..fs.chacha import ChaCha20Rng
from ..fs.merlin import Transcript
from ..fs.sampling import field_random_vec, uniform_indices
from ..ops.blake3 import blake3
from .encoding import LcEncoding

ZERO_DIGEST = bytes(32)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


@dataclasses.dataclass
class RefCommit:
    enc: LcEncoding
    coeffs: list[list[int]]  # n_rows x n_per_row canonical
    comm: list[list[int]]    # n_rows x n_cols canonical
    hashes: list[bytes]      # 2*np2-1 digests, leaves first

    @property
    def n_rows(self):
        return len(self.coeffs)

    @property
    def n_per_row(self):
        return len(self.coeffs[0])

    @property
    def n_cols(self):
        return len(self.comm[0])

    def get_root(self) -> bytes:
        return self.hashes[-1]


def ref_commit(coeffs: list[int], enc: LcEncoding) -> RefCommit:
    spec = enc.spec
    n_rows, n_per_row, n_cols = enc.get_dims(len(coeffs))
    padded = list(coeffs) + [0] * (n_rows * n_per_row - len(coeffs))
    mat = [padded[r * n_per_row : (r + 1) * n_per_row] for r in range(n_rows)]
    comm = [enc.encode_row_host(row) for row in mat]

    # column hashes: blake3(32 zero bytes || column reprs) (lib.rs:706-745)
    np2 = _next_pow2(n_cols)
    hashes: list[bytes] = []
    for c in range(n_cols):
        msg = ZERO_DIGEST + b"".join(spec.to_repr(comm[r][c]) for r in range(n_rows))
        hashes.append(blake3(msg))
    hashes += [ZERO_DIGEST] * (np2 - n_cols)

    # merkle layers (lib.rs:747-785)
    layer = hashes[:]
    while len(layer) > 1:
        nxt = [blake3(layer[2 * i] + layer[2 * i + 1]) for i in range(len(layer) // 2)]
        hashes += nxt
        layer = nxt
    return RefCommit(enc=enc, coeffs=mat, comm=comm, hashes=hashes)


@dataclasses.dataclass
class RefColumn:
    col: list[int]
    path: list[bytes]


@dataclasses.dataclass
class RefProof:
    n_cols: int
    p_eval: list[int]
    p_random_vec: list[list[int]]
    columns: list[RefColumn]


def _ref_collapse(spec: FieldSpec, coeffs, tensor):
    n_per_row = len(coeffs[0])
    out = [0] * n_per_row
    for row_vals, t in zip(coeffs, tensor):
        for c in range(n_per_row):
            out[c] = (out[c] + row_vals[c] * t) % spec.p
    return out


def _ref_open_column(comm: RefCommit, col: int) -> RefColumn:
    vals = [comm.comm[r][col] for r in range(comm.n_rows)]
    np2 = _next_pow2(comm.n_cols)
    path = []
    hashes = comm.hashes
    off = 0
    size = np2
    c = col
    while size > 1:
        path.append(hashes[off + (c ^ 1)])
        off += size
        size //= 2
        c >>= 1
    return RefColumn(col=vals, path=path)


def ref_prove(comm: RefCommit, outer_tensor: list[int], enc: LcEncoding,
              tr: Transcript) -> RefProof:
    spec = enc.spec
    assert len(outer_tensor) == comm.n_rows
    p_random_vec = []
    for _ in range(enc.get_n_degree_tests()):
        key = tr.challenge_bytes(enc.LABEL_DT, 32)
        rand_tensor = field_random_vec(spec, ChaCha20Rng(key), comm.n_rows)
        p_random = _ref_collapse(spec, comm.coeffs, rand_tensor)
        for v in p_random:
            tr.append_message(enc.LABEL_PR, spec.to_repr(v))
        p_random_vec.append(p_random)

    p_eval = _ref_collapse(spec, comm.coeffs, outer_tensor)
    for v in p_eval:
        tr.append_message(enc.LABEL_PE, spec.to_repr(v))

    key = tr.challenge_bytes(enc.LABEL_CO, 32)
    cols = uniform_indices(comm.n_cols, ChaCha20Rng(key), enc.get_n_col_opens())
    columns = [_ref_open_column(comm, c) for c in cols]
    return RefProof(
        n_cols=comm.n_cols, p_eval=p_eval, p_random_vec=p_random_vec,
        columns=columns,
    )


def ref_verify(root: bytes, outer_tensor: list[int], inner_tensor: list[int],
               proof: RefProof, enc: LcEncoding, tr: Transcript) -> int:
    spec = enc.spec
    n_col_opens = enc.get_n_col_opens()
    assert n_col_opens == len(proof.columns) and n_col_opens > 0
    n_rows = len(proof.columns[0].col)
    n_cols = proof.n_cols
    n_per_row = len(proof.p_eval)
    assert len(inner_tensor) == n_per_row
    assert len(outer_tensor) == n_rows
    assert enc.dims_ok(n_per_row, n_cols)

    rand_tensors = []
    p_random_fft = []
    for i in range(enc.get_n_degree_tests()):
        key = tr.challenge_bytes(enc.LABEL_DT, 32)
        rand_tensors.append(field_random_vec(spec, ChaCha20Rng(key), n_rows))
        p_random_fft.append(enc.encode_row_host(proof.p_random_vec[i]))
        for v in proof.p_random_vec[i]:
            tr.append_message(enc.LABEL_PR, spec.to_repr(v))

    for v in proof.p_eval:
        tr.append_message(enc.LABEL_PE, spec.to_repr(v))

    key = tr.challenge_bytes(enc.LABEL_CO, 32)
    cols_to_open = uniform_indices(n_cols, ChaCha20Rng(key), n_col_opens)

    p_eval_fft = enc.encode_row_host(proof.p_eval)

    for col_num, column in zip(cols_to_open, proof.columns):
        for i, rt in enumerate(rand_tensors):
            dot = sum(t * e for t, e in zip(rt, column.col)) % spec.p
            assert dot == p_random_fft[i][col_num], "ColumnDegree"
        dot = sum(t * e for t, e in zip(outer_tensor, column.col)) % spec.p
        assert dot == p_eval_fft[col_num], "ColumnEval"
        # merkle path
        msg = ZERO_DIGEST + b"".join(spec.to_repr(v) for v in column.col)
        h = blake3(msg)
        c = col_num
        for p_dig in column.path:
            h = blake3(h + p_dig) if c % 2 == 0 else blake3(p_dig + h)
            c >>= 1
        assert h == root, "ColumnPath"

    return sum(t * e for t, e in zip(inner_tensor, proof.p_eval)) % spec.p
