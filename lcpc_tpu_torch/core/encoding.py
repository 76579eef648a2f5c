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

    @abc.abstractmethod
    def encode_canon_rows(self, rows_w: torch.Tensor) -> torch.Tensor:
        """encode_rows of rows given as canonical words, the verifier's
        proof rows: (R, n_per_row, W/2) int32 storage of u32 (any value
        below 2^(16 W)) -> (W, R, n_cols) Montgomery limbs, equal to
        encode_rows of their to_mont.  Each encoding folds the conversion
        into its encode's first kernel."""

    def device_tables(self):
        """The tables on self.device that the small commit's kernel
        (ops/commit_small.py: NttTables or LevelTable) reads besides its
        operands, built now if they are not yet.  None here: an encoding
        without that kernel commits stage by stage."""
        return None

    def encode_rows_words(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """encode_rows and the codeword's column-hash words: ((W, R, n_cols)
        Montgomery limbs, (R*W/2, n_cols) canonical LE u32 words as int32
        storage, ops.limbs.pack_row_words' layout).  This default converts
        and packs after the encode (FieldOps.canon_words: one mont_map launch
        on the card); an encoding whose kernel writes the words itself
        overrides it."""
        limbs = self.encode_rows(rows)
        return limbs, get_ops(self.spec).canon_words(limbs)

    def encode_rows_words_only(self, rows: torch.Tensor) -> torch.Tensor:
        """The hash words of encode_rows_words alone, (R*W/2, n_cols) int32
        storage: the streaming commit's block encode (the contract of
        lcpc_tpu's encode_rows_lowmem(post=_pack_words, canonical=True)).
        An encoding whose kernel can skip the limbs overrides it."""
        return self.encode_rows_words(rows)[1]

    def encode_rows_lowmem(self, rows: torch.Tensor, post=None,
                           canonical: bool = False) -> torch.Tensor:
        """encode_rows for a consumer that wants another form (lcpc_tpu's
        encode_rows_lowmem, core/encoding.py:62 and encodings/ligero.py:258),
        bit-identical to it: `canonical=True` gives canonical limbs instead
        of Montgomery, and `post` maps the encoded (W, R, n_cols) limbs to
        the consumer's form.  The sharded and streaming commits' form,
        `canonical=True, post=pack_row_words`, comes straight from
        encode_rows_words_only (Ligero: the NTT's last pass writes the
        words, no limbs stored; otherwise one mont_map launch); any other
        is encode_rows, then from_mont (a mont_map launch) and `post`."""
        if canonical and post is pack_row_words:
            return self.encode_rows_words_only(rows)
        out = self.encode_rows(rows)
        if canonical:
            out = get_ops(self.spec).from_mont(out)
        return post(out) if post is not None else out

    def stream_bytes_per_row(self) -> int:
        """Device bytes one row of encode_rows_words_only holds while it
        runs: the row's limbs in, then, per codeword column, the encode's
        limbs and packed buffer, their canonical form and the words
        (4 * (W n_per_row + 3 W n_cols)); the streaming commit sizes its row
        blocks from it."""
        w = self.spec.w16
        return 4 * (w * self.n_per_row + 3 * w * self.n_cols)

    @abc.abstractmethod
    def encode_row_host(self, row: list[int]) -> list[int]:
        """Slow twin of encode_rows on one row of canonical Python ints."""
