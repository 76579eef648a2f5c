"""The LcEncoding plugin interface (mirrors lcpc-2d/src/lib.rs:74-104).

An encoding supplies the field, dimension logic, soundness counts, and the
row-encoding function in two flavors: a batched tensor implementation on the
encoding's device (`encode_rows`, the hot path) and a host slow twin
(`encode_row_host`) used by tests and by verify's odd-row-length path.

Note on Fiat-Shamir labels: the reference's `def_labels!` macro
(lcpc-2d/src/macros.rs:29-36) interpolates `$l` inside a byte-string literal,
which Rust macros do NOT substitute — so every encoding actually shares the
literal labels b"$l//DT" / b"$l//PR" / b"$l//PE" / b"$l//CO".  We replicate
that faithfully for bit-compatibility.
"""

from __future__ import annotations

import abc

import torch

from ..fields.spec import FieldSpec
from ..ops.limbs import get_ops, pack_row_words

LABEL_DT = b"$l//DT"
LABEL_PR = b"$l//PR"
LABEL_PE = b"$l//PE"
LABEL_CO = b"$l//CO"


class LcEncoding(abc.ABC):
    """A linear code usable by the 2-D polynomial commitment."""

    spec: FieldSpec
    device: torch.device

    LABEL_DT = LABEL_DT
    LABEL_PR = LABEL_PR
    LABEL_PE = LABEL_PE
    LABEL_CO = LABEL_CO

    @abc.abstractmethod
    def get_dims(self, length: int) -> tuple[int, int, int]:
        """(n_rows, n_per_row, n_cols) for a coefficient vector of `length`."""

    @abc.abstractmethod
    def dims_ok(self, n_per_row: int, n_cols: int) -> bool:
        ...

    @abc.abstractmethod
    def get_n_col_opens(self) -> int:
        ...

    @abc.abstractmethod
    def get_n_degree_tests(self) -> int:
        ...

    @abc.abstractmethod
    def encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Batched systematic encode: (W, R, n_per_row) -> (W, R, n_cols).

        Input/output int32 Montgomery limbs (limb-major) on self.device.
        """

    def encode_rows_words(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """encode_rows and the codeword's column-hash words: ((W, R, n_cols)
        Montgomery limbs, (R*W/2, n_cols) canonical LE u32 words as int32
        storage, ops.limbs.pack_row_words' layout).  This default converts
        and packs after the encode; an encoding whose kernel writes the words
        itself overrides it."""
        limbs = self.encode_rows(rows)
        return limbs, pack_row_words(get_ops(self.spec).from_mont(limbs))

    @abc.abstractmethod
    def encode_row_host(self, row: list[int]) -> list[int]:
        """Slow twin of encode_rows on one row of canonical Python ints."""
