"""Ligero (Reed-Solomon) encoding: NTT row encode + proof-size-optimal dims.

Port of lcpc_tpu/encodings/ligero.py, which reimplements
`LigeroEncodingRho` (lcpc-ligero-pc/src/lib.rs:32-195):
- rate rho = rho_num/rho_den (default 1/2 like `LigeroEncoding`);
- number of column openings ceil(-lambda / log2((1+rho)/2)) (lib.rs:61-64);
- `_get_dims` picks n_cols near sqrt(n_col_opens*len/ndt)/rho, capped by the
  field's 2-adicity, then keeps whichever of {nc, nc/2} minimizes proof size
  (lib.rs:70-112);
- encode = zero-pad the row to n_cols and apply the in-order-input,
  bit-reversed-output NTT (fft_io_pc, lib.rs:162-164): ops/ntt.ntt_forward,
  which launches the CUDA ladder on the GPU and runs its plain twin on the
  CPU; the commit's encode (`encode_rows_words`) also takes the column-hash
  words from the NTT's last pass.

The dimension formulas use f64 arithmetic in Rust; Python floats are the same
IEEE doubles, and the operation order is kept identical.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from ..core.encoding import LcEncoding
from ..core.soundness import n_degree_tests
from ..fields.spec import FieldSpec
from ..ops.limbs import get_ops
from ..ops.ntt import get_ntt, ntt_forward, ntt_host
from ..utils.device import resolve_device

LAMBDA = 128


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


class LigeroEncoding(LcEncoding):
    """Rate-rho RS encoding (default rho = 1/2, like the Rust alias).

    `device=None` places the encode on the GPU and raises without one; pass
    device="cpu" for the plain PyTorch path."""

    def __init__(self, spec: FieldSpec, n_per_row: int, n_cols: int,
                 rho_num: int = 1, rho_den: int = 2, device=None):
        self.spec = spec
        self.rho_num = rho_num
        self.rho_den = rho_den
        if not self._dims_ok_static(n_per_row, n_cols) or n_cols.bit_length() - 1 > spec.s:
            raise ValueError(f"invalid Ligero dims ({n_per_row}, {n_cols}) for {spec.name}")
        self.n_per_row = n_per_row
        self.n_cols = n_cols
        self.device = resolve_device(device)
        self.ops = get_ops(spec)

    # ---- constructors (lib.rs:120-148) ---------------------------------------

    @classmethod
    def new(cls, spec: FieldSpec, length: int, rho_num: int = 1, rho_den: int = 2,
            device=None):
        dims = cls._get_dims(spec, length, rho_num, rho_den)
        assert dims is not None, "no valid dims (2-adicity cap?)"
        _, n_per_row, n_cols = dims
        return cls(spec, n_per_row, n_cols, rho_num, rho_den, device)

    @classmethod
    def new_ml(cls, spec: FieldSpec, n_vars: int, rho_num: int = 1, rho_den: int = 2,
               device=None):
        n_monomials = 1 << n_vars
        dims = cls._get_dims(spec, n_monomials, rho_num, rho_den)
        assert dims is not None
        n_rows, n_per_row, n_cols = dims
        assert n_rows & (n_rows - 1) == 0
        assert n_per_row & (n_per_row - 1) == 0
        assert n_rows * n_per_row == n_monomials
        return cls(spec, n_per_row, n_cols, rho_num, rho_den, device)

    @classmethod
    def new_from_dims(cls, spec: FieldSpec, n_per_row: int, n_cols: int,
                      rho_num: int = 1, rho_den: int = 2, device=None):
        return cls(spec, n_per_row, n_cols, rho_num, rho_den, device)

    # ---- parameter logic (lib.rs:45-118) -------------------------------------

    @classmethod
    def _rho(cls, rho_num, rho_den) -> float:
        assert rho_num < rho_den
        return rho_num / rho_den

    @classmethod
    def n_col_opens_static(cls, rho_num: int, rho_den: int) -> int:
        den = math.log2((1.0 + cls._rho(rho_num, rho_den)) / 2.0)
        return math.ceil(-float(LAMBDA) / den)

    @classmethod
    def _n_degree_tests_static(cls, spec: FieldSpec, n_cols: int) -> int:
        return n_degree_tests(LAMBDA, n_cols, spec.flog2)

    @classmethod
    def _get_dims(cls, spec: FieldSpec, length: int, rho_num: int, rho_den: int):
        rho = cls._rho(rho_num, rho_den)
        n_col_opens = cls.n_col_opens_static(rho_num, rho_den)
        lncf = float(n_col_opens * length)
        ndt = float(
            cls._n_degree_tests_static(spec, math.ceil(math.sqrt(lncf) / rho))
        )
        nc1 = _next_pow2(math.ceil(math.sqrt(lncf / ndt) / rho))
        if nc1 > (1 << spec.s):
            return None

        np1 = nc1 * rho_num // rho_den
        nr1 = (length + np1 - 1) // np1
        nd1 = cls._n_degree_tests_static(spec, nc1)
        assert np1 * nr1 >= length
        assert np1 * (nr1 - 1) < length

        nc2 = nc1 // 2
        np2 = np1 // 2
        nr2 = (length + np2 - 1) // np2
        nd2 = cls._n_degree_tests_static(spec, nc2)
        assert nc2 & (nc2 - 1) == 0
        assert np2 * nr2 >= length
        assert np2 * (nr2 - 1) < length

        sz1 = n_col_opens * nr1 + (1 + nd1) * np1
        sz2 = n_col_opens * nr2 + (1 + nd2) * np2
        return (nr1, np1, nc1) if sz1 < sz2 else (nr2, np2, nc2)

    @staticmethod
    def _dims_ok_static(n_per_row: int, n_cols: int) -> bool:
        return n_per_row < n_cols and (n_cols & (n_cols - 1)) == 0

    # ---- LcEncoding interface ------------------------------------------------

    def get_dims(self, length: int) -> tuple[int, int, int]:
        n_rows = (length + self.n_per_row - 1) // self.n_per_row
        return (n_rows, self.n_per_row, self.n_cols)

    def dims_ok(self, n_per_row: int, n_cols: int) -> bool:
        return (
            self._dims_ok_static(n_per_row, n_cols)
            and n_per_row == self.n_per_row
            and n_cols == self.n_cols
        )

    def get_n_col_opens(self) -> int:
        return self.n_col_opens_static(self.rho_num, self.rho_den)

    def get_n_degree_tests(self) -> int:
        return self._n_degree_tests_static(self.spec, self.n_cols)

    def _check_rows(self, rows: torch.Tensor) -> torch.Tensor:
        w, r, npr = rows.shape
        if npr != self.n_per_row or w != self.ops.w:
            raise ValueError(f"rows must be ({self.ops.w}, R, {self.n_per_row}), "
                             f"got {tuple(rows.shape)}")
        return rows

    def encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(W, R, n_per_row) -> (W, R, n_cols) int32 Montgomery limbs: each
        row zero-padded to n_cols and transformed (the NTT's first pass reads
        only the n_per_row columns)."""
        return ntt_forward(get_ntt(self.spec, self.n_cols), self._check_rows(rows))

    def encode_rows_words(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """encode_rows with the hash words written by the NTT's last pass."""
        return ntt_forward(get_ntt(self.spec, self.n_cols), self._check_rows(rows),
                           canon_words=True)

    def encode_row_host(self, row: list[int]) -> list[int]:
        assert len(row) <= self.n_cols
        padded = list(row) + [0] * (self.n_cols - len(row))
        return ntt_host(self.spec, padded)

    @property
    def rho(self) -> Fraction:
        return Fraction(self.rho_num, self.rho_den)
