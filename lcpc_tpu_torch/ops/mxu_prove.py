"""The prover's contractions: the collapse and the direct column evaluation
(port of lcpc_tpu/ops/mxu_prove.py, with its names).

1. The collapse (lcpc-2d/src/lib.rs:1095-1123): tensor (T, R) x
   coefficients (R, C), canonical, as wire words.  `MxuCollapse` runs it by
   row blocks (a resident matrix, or a CoeffSource regenerating or uploading
   blocks): each block's product goes into one partial per block and one
   launch sums them, so no block's partial is ever added in plain torch.
2. The column opening of a Reed-Solomon code: an opened column c of the
   codeword is the row polynomial at g_c = w^bitrev(c), so the k opened
   columns of a block are its coefficients (rows, npr) x V (npr, k) with
   V[m, j] = g_j^m.  `MxuColumnEval` builds V once per set of columns
   (ops/mont_dot.py: power_table) and evaluates blocks against it, in
   place of re-encoding every block when the codeword was not kept.

lcpc_tpu contracts int8 digit planes (base 2^7) on the TPU's matrix unit;
here both products are mont_dot (csrc/mont_dot.cu) on the tensor cores
over the values' own bytes as u8 digits: the collapse's two rows against
the coefficient words read in place, the column evaluation against V's
digit planes (power_table writes V as such planes).
The outputs are lcpc_tpu's: MxuCollapse's equal FieldOps.collapse_words,
MxuColumnEval's equal the columns gathered out of LcEncoding.encode_rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.spec import FieldSpec
from .limbs import get_ops, limbs_to_device
from .mont_dot import field_consts, mont_dot, power_table
from .ntt import bit_reverse
from .spmv import pack_words

_IN_FORMS = ("limbs", "packed")


def mxu_prove_enabled(spec: FieldSpec) -> bool:
    """The fields whose prove takes these routes, as in lcpc_tpu on its
    accelerator: W >= 8 16-bit limbs (ft127 and up).  The route depends on
    the field and the size, not the device."""
    return spec.w16 >= 8


def _packed_ints(spec: FieldSpec, rows: "list[list[int]]", device) -> torch.Tensor:
    """T lists of plain field ints -> (W/2, T, n) Montgomery words on `device`."""
    ops = get_ops(spec)
    limbs = np.stack([ops.encode_host(r) for r in rows], axis=1)  # (W, T, n)
    return pack_words(limbs_to_device(limbs, device), 0)


class MxuCollapse:
    """collapse_words by row blocks.

    `in_form` declares the coefficient-block layout: "limbs" ((W, rows, C)
    16-bit limbs) or "packed" ((W/2, rows, C) int32 words)."""

    def __init__(self, spec: FieldSpec, n_rows: int, packed: bool = False,
                 in_form: "str | None" = None):
        self.spec = spec
        self.n_rows = n_rows
        self.in_form = in_form if in_form else ("packed" if packed else "limbs")
        if self.in_form not in _IN_FORMS:
            raise ValueError(f"MxuCollapse: in_form must be limbs or packed, got {in_form!r}")

    def __call__(self, tensor_ints: "list[list[int]]", coeffs_dev: torch.Tensor) -> torch.Tensor:
        """tensor_ints: T lists of n_rows plain field ints; coeffs_dev:
        (W or W/2, n_rows, C) Montgomery.  Returns (T, C, W/2) canonical
        wire words, int64 u32 values (== FieldOps.collapse_words)."""
        return self.collapse_source(tensor_ints, lambda r0, r1: coeffs_dev[:, r0:r1, :],
                                    self.n_rows, self.n_rows)

    def collapse_source(self, tensor_ints: "list[list[int]]", get_block, n_rows: int,
                        row_block: int) -> torch.Tensor:
        """Blocked variant: coefficient rows from get_block(r0, r1); each
        block's canonical product lands in its own partial, and one launch
        sums the partials."""
        spec, w32 = self.spec, self.spec.w16 // 2
        blocks = [(r0, min(r0 + row_block, n_rows)) for r0 in range(0, n_rows, row_block)]
        parts = ts = None
        for s, (r0, r1) in enumerate(blocks):
            blk = get_block(r0, r1)
            if parts is None:
                ts = _packed_ints(spec, tensor_ints, blk.device)  # (W/2, T, n_rows)
                parts = torch.empty((w32, len(blocks), ts.shape[1], blk.shape[2]),
                                    dtype=torch.int32, device=blk.device)
            mont_dot(spec, ts[:, :, r0:r1], blk, y_form=self.in_form, out=parts[:, s])
        acc = parts[:, 0] if len(blocks) == 1 else _sum_partials(spec, parts)
        return (acc.to(torch.int64) & 0xFFFFFFFF).permute(1, 2, 0)


def _sum_partials(spec: FieldSpec, parts: torch.Tensor) -> torch.Tensor:
    """(W/2, S, T, C) canonical partials -> (W/2, T, C) canonical sums over
    S: one mont_dot of x the constant R^2 mod p (R^2 R^-2 = 1) with the
    partials as (W/2, S, T C)."""
    w32, S, T, C = parts.shape
    r2 = field_consts(spec, parts.device)[w32 + 1 : 2 * w32 + 1]
    x = r2[:, None, None].expand(w32, 1, S)
    return mont_dot(spec, x, parts.reshape(w32, S, T * C)).reshape(w32, T, C)


def column_points(spec: FieldSpec, n_cols: int, cols: "list[int]") -> "list[int]":
    """The points g_j = w^bitrev(c_j) of the opened columns c_j of an
    n_cols-column Reed-Solomon codeword (w a primitive n_cols-th root of
    unity), as plain ints: only the opened indices are bit-reversed."""
    w_nc = spec.root_for_log_len(n_cols.bit_length() - 1)
    return [pow(w_nc, int(r), spec.p) for r in bit_reverse(cols, n_cols)]


class MxuColumnEval:
    """Direct evaluation of opened Reed-Solomon codeword columns.

    For LigeroEncoding: column c = row polynomial at w_nc^bitrev(c).  Usage:
    ev = MxuColumnEval(enc); ev.set_columns(cols); ev.eval_block(block) per
    row block -> (W/2, rows, k) packed Montgomery words, int64 u32 values,
    equal to gathering the same columns out of enc.encode_rows(block).

    The power table is digit planes, read by mont_dot's tile kernel for
    the prover's blocks and the verifier's two rows alike (at 2^23 and 2^29
    the planes table and the tile kernel take half the time or less of a
    words table and the thin kernel on an H100, scripts/time_thin_dot.py)."""

    def __init__(self, enc):
        self.enc = enc
        self.spec = enc.spec
        self.ops = get_ops(enc.spec)
        self._table = None

    def set_columns(self, cols: "list[int]") -> None:
        gs = column_points(self.spec, self.enc.n_cols, cols)
        g = pack_words(limbs_to_device(self.ops.encode_host(gs), self.enc.device), 0)
        self._table = power_table(self.spec, g, self.enc.n_per_row)

    @property
    def table_bytes(self) -> int:
        return 0 if self._table is None else self._table.numel() * self._table.element_size()

    def eval_block(self, block: torch.Tensor, in_form: str = "limbs") -> torch.Tensor:
        """block (W | W/2, rows, n_per_row) -> (W/2, rows, k) packed
        Montgomery words of the opened columns, int64 u32 values."""
        if self._table is None:
            raise RuntimeError("MxuColumnEval: set_columns first")
        if in_form not in _IN_FORMS:
            raise ValueError(f"eval_block: in_form must be limbs or packed, got {in_form!r}")
        if block.shape[2] != self.enc.n_per_row:
            raise ValueError(f"eval_block: rows of {self.enc.n_per_row} coefficients, got "
                             f"{tuple(block.shape)}")
        words = mont_dot(self.spec, block, self._table, "mont", x_form=in_form, y_form="planes")
        return words.to(torch.int64) & 0xFFFFFFFF
