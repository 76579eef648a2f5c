"""Expander SpMV of one Brakedown code level: the CUDA kernel and its plain twin.

    y (n_out, R, W32) = A x,   y[c] = sum_{k in row c} vals[k] * x[cols[k]]

over Montgomery operands in the kernel's form: a ragged CSR (row_ptr, cols,
vals) sorted by output row, and field elements as W32 = W/2 packed 32-bit
words (limbs 2i | 2i+1 << 16, int32 storage), one deferred Montgomery
reduction per output.  This is the port of the TPU's only Pallas kernel
(lcpc_tpu/ops/spmv_pallas.py: spmv_mont, pallas_call at line 180) and of the
gather that feeds it (encodings/brakedown.py: _apply_mat_device).

- `RaggedCsr` holds one level's matrix and checks it once, on the host,
  when it is made (row_ptr, column range, longest row).
- `spmv_mont` is the wrapper.  On CUDA tensors it launches the hand-written
  kernel in `csrc/spmv_mont.cu` (built with nvcc for sm_90a at first use
  into build/kernels/, loaded with ctypes) or raises; on CPU tensors it runs
  `apply_mat_plain`.  `spmv_mont.launches` counts kernel launches.
- `apply_mat_plain` is the plain PyTorch version on the same operands: it
  unpacks, pads each slice of rows to its longest, gathers, and runs
  FieldOps.mul_sum_mont.  Both return the unique residue < p, so they agree
  bit for bit.
- `pack_words` / `unpack_words` convert between 16-bit limbs and the packed
  words.  A word with its top bit set is negative as int32: host code that
  reads words as numbers masks them with 0xFFFFFFFF.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from .limbs import get_ops

_NAME = "spmv_mont"
SO_PATH = cuda_build.so_path(_NAME)
NVCC_FLAGS = cuda_build.NVCC_FLAGS
MAX_LANES = 32  # lanes per (output, r): at most one warp
MAX_K = 1 << 20  # longest row the accumulator bound admits


def __getattr__(name):
    if name == "build_log":  # nvcc output (ptxas register/spill report) of the last build
        return cuda_build.build_logs.get(_NAME, "")
    raise AttributeError(name)


def build(force: bool = False) -> float:
    """Compile csrc/spmv_mont.cu into build/kernels/ if stale; returns the
    seconds spent compiling (0.0 when the library was up to date)."""
    return cuda_build.build(_NAME, force)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lcpc_spmv_mont.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.lcpc_spmv_mont.restype = ctypes.c_int


# ---- packed words ------------------------------------------------------------


def pack_words(limbs: torch.Tensor, dim: int) -> torch.Tensor:
    """16-bit limbs (W along `dim`) -> W/2 packed words along `dim`, int32.

    Word i = limb 2i | limb 2i+1 << 16.  torch shifts an int32 as its
    unsigned bit pattern, so a high limb >= 2^15 gives the word's two's-
    complement (negative) int32 value; every limb is < 2^16, so nothing is
    lost.  Works along `dim` in place, without moving the other axes."""
    pairs = limbs.unflatten(dim, (limbs.shape[dim] // 2, 2))
    return pairs.select(dim + 1, 0) | (pairs.select(dim + 1, 1) << 16)


def unpack_words(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Packed int32 words (W32 along `dim`) -> 2*W32 16-bit limbs, int32,
    written straight into the interleaved result."""
    shape = list(words.shape)
    shape.insert(dim + 1, 2)
    out = torch.empty(shape, dtype=torch.int32, device=words.device)
    torch.bitwise_and(words, 0xFFFF, out=out.select(dim + 1, 0))
    # the arithmetic shift's sign bits are masked off
    torch.bitwise_and(words >> 16, 0xFFFF, out=out.select(dim + 1, 1))
    return out.flatten(dim, dim + 1)


# ---- constants and launch shape -----------------------------------------------


def max_multiple(spec: FieldSpec, k: int) -> int:
    """Bound on the reduced slot-sum in multiples of p (spmv_pallas.py:220)."""
    return max(2, (k * spec.p) // spec.R + 3)


def kernel_consts(spec: FieldSpec, k: int) -> np.ndarray:
    """The kernel's constant block: p words | n0 | n_mult | multiples of p.

    The multiples are the reference's conditional-subtract chain
    (limbs.py: _cond_sub_chain): power-of-two multiples of p, largest first,
    each W32+1 32-bit words, covering rows of up to k nonzeros."""
    w32 = spec.w16 // 2
    words = lambda v, n: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]
    m = 1
    while m * 2 < max_multiple(spec, k):
        m *= 2
    mults = []
    while m >= 1:
        mults += words(m * spec.p, w32 + 1)
        m //= 2
    n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    n_mult = len(mults) // (w32 + 1)
    return np.array(words(spec.p, w32) + [n0, n_mult] + mults, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _consts_on(spec: FieldSpec, k: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_consts(spec, k).view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_lanes(n_out: int, r: int, nnz: int, n_sm: int) -> int:
    """Lanes per (output, r) pair: a power of two <= 32.

    Doubled while the launch holds fewer than two waves of threads (a wave
    is the kernel's residency, four 128-thread blocks a multiprocessor) and
    each lane keeps four nonzeros of an average row -- or, while the whole
    launch still fits in one wave, one nonzero.  Big levels at r = 36 keep
    one lane (the multiply-adds bind them, and a split only adds the
    shuffle reduction); r = 2 and the small levels split their rows to
    shorten each lane's dependent loads (scripts/sweep_spmv_lanes.py times
    every split)."""
    wave = 512 * n_sm
    avg = nnz / max(1, n_out)
    pairs = n_out * r
    s = 1
    while s < MAX_LANES and pairs * s < 2 * wave and (
            8 * s <= avg or (2 * s * pairs <= wave and 2 * s <= avg)):
        s *= 2
    return s


# ---- the matrix -----------------------------------------------------------------


class RaggedCsr:
    """One level in the kernel's form, checked once when it is made: row_ptr
    (n_out+1,), cols (nnz,) input indices in [0, n_in) and vals (nnz, W32)
    packed Montgomery words, all contiguous int32 on one device, rows sorted
    by output.  kmax is the longest row (at least 1); the kernel's subtract
    chain is sized from it.  Only a checked matrix reaches the kernel, whose
    CSR it does not read back; its tensors are not to be changed later."""

    def __init__(self, n_in: int, row_ptr: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, device=None):
        for name, t in (("row_ptr", row_ptr), ("cols", cols), ("vals", vals)):
            if t.dtype != torch.int32:
                raise TypeError(f"spmv_mont: {name} must be int32, got {t.dtype}")
        if row_ptr.dim() != 1 or row_ptr.shape[0] < 1:
            raise ValueError(f"spmv_mont: row_ptr must be (n_out+1,), got {tuple(row_ptr.shape)}")
        if cols.dim() != 1:
            raise ValueError(f"spmv_mont: cols must be (nnz,), got {tuple(cols.shape)}")
        if vals.dim() != 2 or vals.shape[0] != cols.shape[0]:
            raise ValueError(f"spmv_mont: vals must be ({cols.shape[0]}, W32), "
                             f"got {tuple(vals.shape)}")
        rp = row_ptr.cpu().long()
        lens = rp[1:] - rp[:-1]
        if int(rp[0]) != 0 or int(rp[-1]) != cols.shape[0] or bool((lens < 0).any()):
            raise ValueError("spmv_mont: row_ptr must rise from 0 to nnz")
        self.kmax = max(1, int(lens.max())) if lens.numel() else 1
        if self.kmax > MAX_K:
            raise ValueError(f"spmv_mont: a row of {self.kmax} nonzeros exceeds the "
                             f"accumulator bound of {MAX_K}")
        c = cols.cpu()
        if c.numel() and (int(c.min()) < 0 or int(c.max()) >= n_in):
            raise ValueError(f"spmv_mont: cols outside [0, {n_in})")
        device = row_ptr.device if device is None else torch.device(device)
        self.row_ptr, self.cols, self.vals = (
            t.to(device).contiguous() for t in (row_ptr, cols, vals))
        self.n_in = n_in
        self.n_out = row_ptr.shape[0] - 1
        self.nnz = cols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device


# ---- the plain version ---------------------------------------------------------


def apply_mat_plain(spec: FieldSpec, x: torch.Tensor, mat: RaggedCsr) -> torch.Tensor:
    """Plain PyTorch SpMV on the kernel's operands (any device).

    Unpacks to 16-bit limbs, pads each slice of output rows to its longest
    row (pad slots: input 0, value 0), gathers, runs FieldOps.mul_sum_mont
    and packs the (n_out, R, W32) result.  The slices keep the gathered
    (K, W, slice, R) operand bounded; an empty row gives 0."""
    ops = get_ops(spec)
    _, r, w32 = x.shape
    out = x.new_zeros((mat.n_out, r, w32))
    if mat.n_out == 0 or mat.nnz == 0:
        return out
    xl = unpack_words(x, 2)          # (n_in, R, W)
    vl = unpack_words(mat.vals, 1)   # (nnz, W)
    cl = mat.cols.long()
    rp = mat.row_ptr.long()
    lens = rp[1:] - rp[:-1]
    step = max(1, (1 << 26) // (mat.kmax * 2 * w32 * r))
    for c0 in range(0, mat.n_out, step):
        c1 = min(mat.n_out, c0 + step)
        kk = max(1, int(lens[c0:c1].max()))
        slot = torch.arange(kk, device=x.device)
        live = slot < lens[c0:c1, None]                                 # (c, kk)
        idx = torch.where(live, rp[c0:c1, None] + slot, 0)
        g = xl.index_select(0, cl[idx].reshape(-1)).reshape(c1 - c0, kk, r, 2 * w32)
        v = vl[idx] * live[..., None]                                   # (c, kk, W)
        y = ops.mul_sum_mont(v.permute(1, 2, 0)[..., None],            # (kk, W, c, 1)
                             g.permute(1, 3, 0, 2))                     # (kk, W, c, R)
        out[c0:c1] = pack_words(y, 0).permute(1, 2, 0)                  # (c, R, W32)
    return out


# ---- the wrapper -----------------------------------------------------------------


def _check(spec: FieldSpec, x, mat, out):
    w32 = spec.w16 // 2
    if not isinstance(mat, RaggedCsr):
        raise TypeError(f"spmv_mont: mat must be a RaggedCsr, got {type(mat).__name__}")
    named = [("x", x)] + ([("out", out)] if out is not None else [])
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"spmv_mont: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spmv_mont: {name} must be contiguous")
    for name, dev in (("out", out.device if out is not None else x.device),
                      ("mat", mat.device)):
        if dev != x.device:
            raise ValueError(f"spmv_mont: {name} on {dev}, x on {x.device}")
    if x.dim() != 3 or x.shape[0] != mat.n_in or x.shape[2] != w32:
        raise ValueError(f"spmv_mont: x must be ({mat.n_in}, R, {w32}), got {tuple(x.shape)}")
    if mat.vals.shape[1] != w32:
        raise ValueError(f"spmv_mont: vals hold {mat.vals.shape[1]} words, {spec.name} {w32}")
    want = (mat.n_out, x.shape[1], w32)
    if out is not None and tuple(out.shape) != want:
        raise ValueError(f"spmv_mont: out must be {want}, got {tuple(out.shape)}")


def spmv_mont(spec: FieldSpec, x: torch.Tensor, mat: RaggedCsr,
              out: torch.Tensor | None = None, _lanes: int | None = None) -> torch.Tensor:
    """y (mat.n_out, R, W32) = mat @ x for packed x (mat.n_in, R, W32) int32.
    Writes into `out` when given.  `_lanes` is a test and tuning hook: it
    overrides the split of each row that `split_lanes` picks.

    CUDA tensors launch the kernel (csrc/spmv_mont.cu) or raise; CPU tensors
    take apply_mat_plain.  Any other device raises."""
    _check(spec, x, mat, out)
    if x.device.type == "cpu":
        y = apply_mat_plain(spec, x, mat)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_mont: unsupported device {x.device}")
    r, w32 = x.shape[1], x.shape[2]
    lanes = _lanes if _lanes is not None else split_lanes(
        mat.n_out, r, mat.nnz, _sm_count(x.device))
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"spmv_mont: lanes={lanes} is not a power of two <= 32")
    y = out if out is not None else torch.empty(
        (mat.n_out, r, w32), dtype=torch.int32, device=x.device)
    align = 16 if w32 % 4 == 0 else 8
    for name, t in (("x", x), ("vals", mat.vals), ("out", y)):
        if t.data_ptr() % align:
            raise ValueError(f"spmv_mont: {name} is not {align}-byte aligned")
    if mat.n_out * r == 0:
        return y
    lib = cuda_build.load(_NAME, _bind)
    consts = _consts_on(spec, mat.kmax, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lcpc_spmv_mont(x.data_ptr(), mat.row_ptr.data_ptr(), mat.cols.data_ptr(),
                             mat.vals.data_ptr(), y.data_ptr(), consts.data_ptr(), w32,
                             mat.n_out, r, lanes.bit_length() - 1, x.device.index or 0,
                             stream)
    if err != 0:
        raise RuntimeError(f"spmv_mont launch failed: cudaError_t {err}")
    spmv_mont.launches += 1
    return y


spmv_mont.launches = 0
