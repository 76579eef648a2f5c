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
  words from the NTT's last pass, and the streaming commit's
  (`encode_rows_words_only`) takes only those;
- `ntt_route` (lcpc_tpu's `_pick_ntt`) sends every encode, and its plain
  version, through the four-step tensor-core transform instead
  (ops/mxu_ntt.py: MxuNtt, the same bytes) where `MXU_NTT` asks for it.

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
from ..ops.commit_small import NttTables
from ..ops.limbs import get_ops, pack_row_words
from ..ops.mxu_ntt import MxuNtt, get_mxu_ntt, mxu_ntt_plain, mxu_supported
from ..ops.ntt import get_ntt, ntt_forward, ntt_forward_plain, ntt_host
from ..utils.device import resolve_device

LAMBDA = 128

# lcpc_tpu's LCPC_MXU_NTT=1/0: True takes MxuNtt wherever mxu_supported
# admits the transform, False (the default) the ladder everywhere.  Set the
# attribute; no environment variable is read.  False because the ladder won at
# every shape measured: on an NVIDIA H100 80GB HBM3 at 700 W the four-step
# kernel took 80.1-80.2 ms against the ladder's 6.7-6.9 at the 2^23 commit's
# transform (ft255, 256 x 2^17 from 2^15 inputs) and 0.655 against 0.075 at
# verify's 2 rows (chip_smoke.py phase 20, PERF.md section 6).
MXU_NTT: bool = False


def ntt_route(spec: FieldSpec, n: int, in_len: "int | None" = None) -> str:
    """"mxu" or "ladder": the transform of an n-point encode whose first
    in_len inputs may be nonzero (lcpc_tpu's `_pick_ntt`).  With MXU_NTT set,
    "mxu" where mxu_supported admits the zero-padded or the full plan, the
    ladder beyond them, as lcpc_tpu falls back; the ladder otherwise."""
    if MXU_NTT and (mxu_supported(spec, n, in_len) or mxu_supported(spec, n)):
        return "mxu"
    return "ladder"


def _mxu_ntt(spec: FieldSpec, n: int, in_len: int) -> "MxuNtt | None":
    """The MxuNtt an encode takes where ntt_route says "mxu" (lcpc_tpu's
    choice of plan: the zero-padded one where admitted, else the full one),
    else None."""
    if ntt_route(spec, n, in_len) != "mxu":
        return None
    return get_mxu_ntt(spec, n, in_len if mxu_supported(spec, n, in_len) else None)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


class LigeroEncoding(LcEncoding):
    """Rate-rho RS encoding (default rho = 1/2, like the Rust alias).

    `device=None` places the encode on the GPU and raises without one; pass
    device="cpu" for the plain PyTorch path."""

    # an opened codeword column is the row polynomial at w^bitrev(c): prove
    # and verify may evaluate it directly (ops/mxu_prove.py: MxuColumnEval)
    supports_direct_col_eval = True

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
        self._tables = None

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

    def device_tables(self) -> NttTables:
        """The NTT plan's twiddle table and constants on self.device (what
        the small commit's kernel reads: ops/commit_small.py), kept after
        the first call."""
        if self._tables is None:
            self._tables = NttTables(*get_ntt(self.spec, self.n_cols).kernel_table(self.device))
        return self._tables

    def _mxu(self) -> "MxuNtt | None":
        """The four-step transform where ntt_route picks it, else None."""
        return _mxu_ntt(self.spec, self.n_cols, _next_pow2(self.n_per_row))

    def _ntt(self, x: torch.Tensor, **modes):
        """The encode's transform of x with ntt_forward's `output=` /
        `input=` modes: the four-step one where ntt_route picks it, else
        the ladder."""
        mxu = self._mxu()
        if mxu is not None:
            return mxu(x, **modes)
        return ntt_forward(get_ntt(self.spec, self.n_cols), x, **modes)

    def encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(W, R, n_per_row) -> (W, R, n_cols) int32 Montgomery limbs: each
        row zero-padded to n_cols and transformed (the NTT's first pass reads
        only the n_per_row columns)."""
        return self._ntt(self._check_rows(rows))

    def encode_canon_rows(self, rows_w: torch.Tensor) -> torch.Tensor:
        """encode_rows of (R, n_per_row, W/2) canonical words (the verifier's
        proof rows): the NTT's first pass takes each element to Montgomery
        form as it loads it (ntt_forward(input="words")), so the conversion
        has no launch of its own on the card; on the CPU the plain chain,
        mont_mul_map_plain's to_mont then ntt_forward_plain."""
        r, npr, w32 = rows_w.shape
        if npr != self.n_per_row or w32 != self.ops.w // 2:
            raise ValueError(f"rows must be (R, {self.n_per_row}, {self.ops.w // 2}) words, "
                             f"got {tuple(rows_w.shape)}")
        return self._ntt(rows_w, input="words")

    def encode_rows_words(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """encode_rows with the hash words written by the NTT's last pass."""
        return self._ntt(self._check_rows(rows), output="both")

    def encode_rows_words_plain(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """encode_rows_words through the plain versions (ntt_forward_plain,
        from_mont_plain and the pack) on rows' device; mxu_ntt_plain where
        ntt_route picks the four-step transform."""
        mxu = self._mxu()
        if mxu is not None:
            return mxu_ntt_plain(mxu, self._check_rows(rows), output="both")
        plan = get_ntt(self.spec, self.n_cols)
        limbs = ntt_forward_plain(plan, self._check_rows(rows))
        return limbs, pack_row_words(self.ops.from_mont_plain(limbs))

    def encode_rows_words_only(self, rows: torch.Tensor) -> torch.Tensor:
        """The hash words alone: the NTT's last pass writes no limbs."""
        return self._ntt(self._check_rows(rows), output="words")

    def stream_bytes_per_row(self) -> int:
        """The row's limbs in, the NTT's packed scratch and the words out:
        4 * (W n_per_row + W n_cols)."""
        w = self.spec.w16
        return 4 * (w * self.n_per_row + w * self.n_cols)

    def encode_row_host(self, row: list[int]) -> list[int]:
        assert len(row) <= self.n_cols
        padded = list(row) + [0] * (self.n_cols - len(row))
        return ntt_host(self.spec, padded)

    @property
    def rho(self) -> Fraction:
        return Fraction(self.rho_num, self.rho_den)
