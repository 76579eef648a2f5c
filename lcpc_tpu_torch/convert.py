"""Carrying state from the JAX reference package into the port.

The port imports nothing of `lcpc_tpu`, so state crosses as plain numpy
arrays: the caller pulls the arrays out of a reference object and hands them
here.  Proofs cross through their wire bytes (core/wire.py) instead.

    from lcpc_tpu_torch import convert
    mat = convert.sparse_mats_from_numpy(m.col_ptr, m.row_idx, m.vals_mont,
                                         spec=FT255, n_out=m.n_out, n_in=m.n_in)
    comm = convert.commit_from_numpy(np.asarray(jc.coeffs), np.asarray(jc.comm),
                                     jc.hashes, enc=enc)
"""

from __future__ import annotations

import numpy as np
import torch

from .core.encoding import LcEncoding
from .core.protocol import LcCommit
from .encodings.brakedown import SparseMat
from .fields.spec import FieldSpec
from .ops import blake3
from .ops.digest import BLAKE3, DeviceDigest
from .ops.limbs import limbs_to_device


def sparse_mats_from_numpy(col_ptr: np.ndarray, row_idx: np.ndarray,
                           vals_mont: np.ndarray, *, spec: FieldSpec,
                           n_out: int, n_in: int) -> SparseMat:
    """A reference SparseMat's CSC arrays -> the port's SparseMat.

    col_ptr (n_in+1,), row_idx (nnz,) and vals_mont (nnz, limbs64) uint64
    Montgomery limbs, exactly as lcpc_tpu.encodings.brakedown.SparseMat holds
    them."""
    vals_mont = np.ascontiguousarray(vals_mont, dtype=np.uint64)
    if vals_mont.shape != (row_idx.shape[0], spec.limbs64):
        raise ValueError(f"vals_mont shape {vals_mont.shape} does not match "
                         f"({row_idx.shape[0]}, {spec.limbs64})")
    if col_ptr.shape != (n_in + 1,):
        raise ValueError(f"col_ptr shape {col_ptr.shape} != ({n_in + 1},)")
    return SparseMat(
        spec=spec,
        n_out=n_out,
        n_in=n_in,
        col_ptr=np.asarray(col_ptr, dtype=np.int64).copy(),
        row_idx=np.asarray(row_idx, dtype=np.int64).copy(),
        vals_mont=vals_mont.copy(),
    )


def commit_from_numpy(coeffs_limbs: np.ndarray, comm_limbs: np.ndarray,
                      hashes: np.ndarray, *, enc: LcEncoding,
                      digest: DeviceDigest = BLAKE3) -> LcCommit:
    """A reference LcCommit's arrays -> a port LcCommit on enc.device.

    coeffs_limbs (W, n_rows, n_per_row) and comm_limbs (W, n_rows, n_cols)
    16-bit Montgomery limbs; hashes the (2*np2-1, 32) uint8 Merkle array,
    leaves first (LcCommit.hashes)."""
    w, n_rows, n_per_row = coeffs_limbs.shape
    n_cols = comm_limbs.shape[2]
    if comm_limbs.shape[:2] != (w, n_rows) or w != enc.spec.w16:
        raise ValueError(f"inconsistent commit arrays {coeffs_limbs.shape} "
                         f"and {comm_limbs.shape} for {enc.spec.name}")
    hashes = np.ascontiguousarray(hashes, dtype=np.uint8)
    return LcCommit(
        enc=enc,
        coeffs=limbs_to_device(coeffs_limbs, enc.device),
        comm=limbs_to_device(comm_limbs, enc.device),
        n_rows=n_rows,
        n_per_row=n_per_row,
        n_cols=n_cols,
        hashes_dev=torch.from_numpy(
            blake3.bytes_to_digests(hashes).astype(np.int64)).to(enc.device),
        digest=digest,
        _hashes_np=hashes,
    )
