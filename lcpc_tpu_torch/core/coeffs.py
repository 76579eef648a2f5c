"""Block-wise coefficient sources for the streaming commit (port of
lcpc_tpu/core/coeffs.py).

A CoeffSource supplies the commit's coefficient matrix by row blocks, as
(W, m, n_per_row) int32 Montgomery 16-bit limbs zero-padded past `length`
(the commit matrix padding, lib.rs:640-645):

- ArrayCoeffSource: a tensor on the device, (W, N) limbs or packed (W/2, N)
  int32 words (limbs 2i | 2i+1 << 16, half the bytes); the packed form
  stays packed at rest and unpacks per block.  `raw_block` is the slice in
  its own layout.
- HostCoeffSource: a numpy array in host RAM, (W, N) limbs or packed
  (W/2, N) u32 words; each block is copied into one pinned staging buffer
  and uploaded from there (synchronously: the buffer is reused only after
  the copy has finished).

- SeededCoeffSource: coefficients made on the device from a seed, block by
  block, never resident: lcpc_tpu's own values (the threefry generator of
  ops/threefry.py, the kernel csrc/seeded_gen.cu), so a commit from the same
  seed has the same root in both packages.

Sources place their blocks on the device they are given (`cuda` unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..ops import threefry
from ..ops.limbs import get_ops
from ..ops.spmv import unpack_words
from ..utils.device import resolve_device


def _layout(rows: int, spec: FieldSpec, packed: "bool | None") -> bool:
    w = get_ops(spec).w
    if packed is None:
        packed = rows == w // 2
    if rows != (w // 2 if packed else w):
        raise ValueError(f"coefficients must be ({w}, N) limbs or ({w // 2}, N) packed "
                         f"words for {spec.name}, got {rows} rows (packed={packed})")
    return packed


class CoeffSource:
    """Interface: supplies Montgomery coefficient blocks by row range."""

    length: int  # number of coefficients (pre-padding)
    spec: FieldSpec
    device: torch.device
    packed: bool = False

    def set_dims(self, n_rows: int, n_per_row: int) -> None:
        """Called once by commit with the matrix shape before any block()."""
        self.n_rows = n_rows
        self.n_per_row = n_per_row

    def block(self, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) as (W, r1-r0, n_per_row) Montgomery limbs (padded)."""
        raise NotImplementedError

    @property
    def resident_bytes(self) -> int:
        """Device-resident footprint commit must budget around."""
        return 0


class ArrayCoeffSource(CoeffSource):
    """Device-resident coefficients; block() is a slice of the padded matrix.

    Accepts (W, N) unpacked limbs or (W/2, N) packed int32 words; the packed
    form stays packed at rest (half the bytes) and unpacks per block.  The
    tensor moves to `device` (default cuda) when it lies elsewhere."""

    def __init__(self, arr: torch.Tensor, spec: FieldSpec, packed: "bool | None" = None,
                 device=None):
        self.spec = spec
        self.device = resolve_device(device)
        if arr.dim() != 2 or arr.dtype != torch.int32:
            raise ValueError(f"ArrayCoeffSource: a 2-D int32 tensor, got {tuple(arr.shape)} "
                             f"{arr.dtype}")
        self.packed = _layout(arr.shape[0], spec, packed)
        self.arr = arr.to(self.device)
        self.length = self.arr.shape[1]
        self._mat = None

    def set_dims(self, n_rows: int, n_per_row: int) -> None:
        super().set_dims(n_rows, n_per_row)
        pad = n_rows * n_per_row - self.length
        arr = torch.nn.functional.pad(self.arr, (0, pad)) if pad else self.arr
        self._mat = arr.reshape(arr.shape[0], n_rows, n_per_row)

    def block(self, r0: int, r1: int) -> torch.Tensor:
        blk = self._mat[:, r0:r1, :]
        return unpack_words(blk, 0) if self.packed else blk

    def raw_block(self, r0: int, r1: int) -> torch.Tensor:
        """Native-layout slice (packed stays packed)."""
        return self._mat[:, r0:r1, :]

    @property
    def resident_bytes(self) -> int:
        return self.arr.numel() * self.arr.element_size()


class HostCoeffSource(CoeffSource):
    """Host-RAM-resident coefficients, uploaded per block.

    `arr` is a numpy (W, N) or packed (W/2, N) uint32 (or int32) array, or a
    list of canonical ints (converted once to Montgomery limbs).  Blocks go
    to `device` (default cuda) through one pinned staging buffer there."""

    def __init__(self, arr, spec: FieldSpec, packed: "bool | None" = None, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        if isinstance(arr, list):
            arr = get_ops(spec).encode_host(arr)
            packed = False
        arr = np.asarray(arr)
        if arr.ndim != 2 or arr.dtype not in (np.uint32, np.int32):
            raise ValueError(f"HostCoeffSource: a 2-D uint32 array, got {arr.shape} "
                             f"{arr.dtype}")
        self.packed = _layout(arr.shape[0], spec, packed)
        self.arr = arr.view(np.int32)  # the same bits, as torch's int32 storage
        self.length = self.arr.shape[1]
        self._staging = None

    def _upload(self, piece: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(piece))
        if self.device.type != "cuda":
            return src.to(self.device)
        n = src.numel()
        if self._staging is None or self._staging.numel() < n:
            self._staging = torch.empty(n, dtype=torch.int32, pin_memory=True)
        stage = self._staging[:n].view(src.shape)
        stage.copy_(src)
        dev = stage.to(self.device, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()  # staging reusable
        return dev

    def block(self, r0: int, r1: int) -> torch.Tensor:
        npr = self.n_per_row
        i0, i1 = r0 * npr, r1 * npr
        piece = self.arr[:, i0:min(i1, self.length)]
        if piece.shape[1] < i1 - i0:  # zero-pad the tail block
            piece = np.pad(piece, [(0, 0), (0, i1 - i0 - piece.shape[1])])
        dev = self._upload(piece)
        if self.packed:
            dev = unpack_words(dev, 0)
        return dev.reshape(-1, r1 - r0, npr)


class SeededCoeffSource(CoeffSource):
    """Deterministic device-generated coefficients, regenerated per block.

    Element i lives in generation chunk i // chunk; chunk c is a pure
    function of (seed, c): lcpc_tpu's 7-bit digit planes of
    jax.random.bits(fold_in(PRNGKey(seed), c)), the top digit masked, their
    value read as the Montgomery form (ops/threefry.py).  Any block
    partitioning sees the same values, and `materialize()` equals
    lcpc_tpu's SeededCoeffSource(spec, length, seed, chunk).materialize().
    Blocks come as 16-bit limbs (`block`, what the encode reads), packed
    words (`block_packed`, what prove's contractions read) or digit planes
    (`block_digits`), each one generator launch on a CUDA device; nothing
    stays resident."""

    def __init__(self, spec: FieldSpec, length: int, seed: int = 0, chunk: int = 1 << 18,
                 device=None):
        if length < 1 or chunk < 1:
            raise ValueError(f"SeededCoeffSource: length and chunk must be >= 1, got "
                             f"{length}, {chunk}")
        self.spec = spec
        self.length = length
        self.seed = seed
        self.key = threefry.prng_key(seed)
        self.chunk = chunk
        self.w7 = (spec.num_bits + 6) // 7
        self.device = resolve_device(device)

    def _rows(self, r0: int, r1: int, form: str) -> torch.Tensor:
        npr = self.n_per_row
        span = threefry.seeded_digits(self.spec, self.key, r0 * npr, r1 * npr, self.length,
                                      self.chunk, form=form, device=self.device)
        return span.reshape(span.shape[0], r1 - r0, npr)

    def block(self, r0: int, r1: int) -> torch.Tensor:
        return self._rows(r0, r1, "limbs")

    def block_packed(self, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) as (W/2, r1-r0, n_per_row) packed int32 words."""
        return self._rows(r0, r1, "packed")

    def block_digits(self, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) as (W7, r1-r0, n_per_row) uint8 digit planes."""
        return self._rows(r0, r1, "digits")

    def materialize(self) -> torch.Tensor:
        """The whole (W, length) limb array (small sizes: tests, checks).
        As in lcpc_tpu it sets n_per_row to length, so a commit must call
        set_dims again (commit_streaming does)."""
        self.n_per_row = self.length
        return self.block(0, 1)[:, 0, :]


def as_source(coeffs, spec: FieldSpec, packed: "bool | None" = None,
              device=None) -> CoeffSource:
    """Coerce the streaming commit's coeffs argument into a CoeffSource: a
    CoeffSource as it is, a list of canonical ints as device limbs, a numpy
    array as a HostCoeffSource, a tensor as an ArrayCoeffSource (all on
    `device`, default cuda)."""
    if isinstance(coeffs, CoeffSource):
        return coeffs
    if isinstance(coeffs, list):
        arr = torch.from_numpy(get_ops(spec).encode_host(coeffs).view(np.int32))
        return ArrayCoeffSource(arr, spec, packed=False, device=device)
    if isinstance(coeffs, np.ndarray):
        return HostCoeffSource(coeffs, spec, packed=packed, device=device)
    return ArrayCoeffSource(coeffs, spec, packed=packed, device=device)
