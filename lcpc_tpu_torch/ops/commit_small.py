"""The small commit as one kernel launch: the wrapper of csrc/commit_small.cu,
its plain version, and the shapes both read.

`commit_small(enc, digest, arr)` takes the (W, length) Montgomery limbs of
a commit on the card to (mat, comm, flat): the (W, n_rows, n_per_row)
coefficient matrix (a view of arr when no row is short, else padded by the
kernel), the (W, n_rows, n_cols) codeword limbs and the (8, 2 np2 - 1)
int64 Merkle array, under BLAKE3 or SHA-256, for an encoding whose
`device_tables()` gives the kernel's tables: `NttTables` (Ligero: the NTT
passes of `fused_passes`) or `LevelTable` (Brakedown CODE3: its level
table).  It allocates the outputs (views of one tensor) and one scratch
tensor, launches the kernel once, cooperatively (every block resident), and
counts the launch in `commit_small.launches`; it copies nothing and does
not synchronize.  It raises on a tensor that is not on the encoding's CUDA
device, on an encoding without those tables, and when the launch fails.
core/protocol.py's `_commit_fused_fn` calls it.

`commit_small_plain(enc, digest, arr)` is its plain version: the same
function through the stages' plain versions (`encode_rows_words_plain`, the
digest's `hash_word_columns_plain` and `merkle_tree_plain`) on arr's
device.  On CPU tensors it is what `_commit_staged` computes; the tests and
chip_smoke.py hold the kernel to it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils import cuda_build
from ..utils.device import with_index
from . import launch_count
from .blake3 import CHUNK_WORDS, PREFIX_WORDS
from .ntt import LOG_T, NttPass, plan_passes

_NAME = "commit_small"
_ALIGN = 16         # bytes: each scratch region starts on a 16-byte boundary
TILE_LOG = 9        # NTT tiles of 512 elements: a butterfly a thread of 256 a stage


@dataclasses.dataclass(frozen=True)
class NttTables:
    """The Ligero kernel's tables on the card: the NTT plan's (n - 1, W32)
    twiddles and its constants (NttPlan.kernel_table)."""

    tw: torch.Tensor
    consts: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LevelTable:
    """The Brakedown kernel's tables on the card: `table` (levels, 9) int64,
    a row a level of the code (csrc/commit_small.cu's Level: input and
    output positions in the (positions, R, W32) word buffer, outputs,
    nonzeros, 1 where its outputs are codeword columns, then the device
    addresses of its row_ptr, cols, vals and SpMV constants); the buffer's
    `positions`; the widest level's outputs `max_out`; and `consts`, which
    keeps the constant blocks the table points at alive."""

    table: torch.Tensor
    positions: int
    max_out: int
    consts: tuple


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def fused_passes(log_n: int, w32: int) -> tuple[NttPass, ...]:
    """The NTT passes the kernel runs at n = 2^log_n: plan_passes with the
    last pass over chunks of 2^TILE_LOG elements and the head passes' tiles
    grown to as many (T = 2^log_t consecutive residues raised until a head
    pass of all the head stages fills one), so that each of a block's 256
    threads takes one butterfly a stage: at these sizes a thread's chain of
    dependent products sets the pace.  The same transform as every plan."""
    lc = min(log_n, TILE_LOG)
    log_t = min(lc, max(LOG_T, TILE_LOG - (log_n - lc)))
    return plan_passes(log_n, w32, log_chunk=TILE_LOG, log_t=log_t,
                       max_tile_bytes=(4 * w32) << TILE_LOG)


@dataclasses.dataclass(frozen=True)
class ScratchLayout:
    """Byte offsets of the kernel's intermediates in one scratch tensor
    (None where the commit needs none): the NTT's (R, n, W32) or the code's
    (positions, R, W32) word buffer, the (R W32, n_cols) hash words, the
    (n_chunks, 8, n_cols) BLAKE3 chunk CVs of columns longer than a chunk,
    the (8, n_cols) int64 leaves; `nbytes` in all."""

    buf: "int | None"
    words: int
    cvs: "int | None"
    leaves: int
    nbytes: int


def scratch_layout(buf_words: int, n_rows: int, w32: int, n_cols: int,
                   digest_name: str) -> ScratchLayout:
    """The layout for a buffer of buf_words 32-bit words (0: none) and a
    codeword of n_rows x n_cols elements of w32 words."""
    off = 0

    def take(nbytes):
        nonlocal off
        at = off
        off += -(-nbytes // _ALIGN) * _ALIGN
        return at

    buf = take(4 * buf_words) if buf_words else None
    words = take(4 * n_rows * w32 * n_cols)
    n_chunks = -(-(PREFIX_WORDS + n_rows * w32) // CHUNK_WORDS)
    cvs = take(4 * 8 * n_chunks * n_cols) if digest_name == "blake3" and n_chunks > 1 else None
    leaves = take(8 * 8 * n_cols)
    return ScratchLayout(buf, words, cvs, leaves, off)


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lcpc_commit_small_ligero.argtypes = [p, ll, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                             i, i, i, p]
    lib.lcpc_commit_small_sdig.argtypes = [p, ll, p, p, p, p, p, p, p, p, i, ll, i, i, i, i, i,
                                           i, p]
    for fn in (lib.lcpc_commit_small_ligero, lib.lcpc_commit_small_sdig):
        fn.restype = ctypes.c_int


_DIGEST_CODE = {"blake3": 0, "sha256": 1}


def _check(enc, digest, arr: torch.Tensor) -> None:
    w = enc.spec.w16
    if digest.name not in _DIGEST_CODE:
        raise ValueError(f"commit_small: no kernel for the digest {digest.name!r}")
    if arr.dtype != torch.int32:
        raise TypeError(f"commit_small: arr must be int32, got {arr.dtype}")
    if arr.dim() != 2 or arr.shape[0] != w or arr.shape[1] < 1:
        raise ValueError(f"commit_small: arr must be ({w}, N >= 1) limbs, got "
                         f"{tuple(arr.shape)}")
    if arr.device.type != "cuda":
        raise ValueError(f"commit_small: the kernel needs a CUDA tensor, got {arr.device}")
    if with_index(enc.device) != arr.device:
        raise ValueError(f"commit_small: arr on {arr.device}, the encoding on {enc.device}")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What a commit's shape fixes: the NTT passes as the C int array (None
    for Brakedown), their count and log2 n_cols; the outputs' places in
    one int32 tensor (comm at 0, the int64 Merkle array at `flat`, the
    padded matrix at `mat` or None), its words; the scratch layout."""

    passes: object
    n_passes: int
    log_n: int
    flat: int
    mat: "int | None"
    out_words: int
    scratch: ScratchLayout


@functools.lru_cache(maxsize=256)
def _launch_plan(ligero: bool, n_rows: int, npr: int, n_cols: int, w32: int,
                 digest_name: str, positions: int, padded: bool) -> LaunchPlan:
    """The plan of a commit's shape; positions is the code's buffer length
    (Brakedown) or 0 (Ligero)."""
    spec, n_passes, log_n = None, 0, 0
    if ligero:
        log_n = n_cols.bit_length() - 1
        passes = fused_passes(log_n, w32)
        spec = (ctypes.c_int * (3 * len(passes)))(
            *[v for ps in passes for v in (ps.hi, ps.lo, ps.log_t)])
        n_passes = len(passes)
        buf_words = n_rows * n_cols * w32 if n_passes > 1 else 0
    else:
        buf_words = positions * n_rows * w32
    align = _ALIGN // 4
    comm_words = 2 * w32 * n_rows * n_cols
    flat = -(-comm_words // align) * align
    end = flat + 2 * 8 * (2 * _next_pow2(n_cols) - 1)
    mat = -(-end // align) * align if padded else None
    if padded:
        end = mat + 2 * w32 * n_rows * npr
    return LaunchPlan(spec, n_passes, log_n, flat, mat, end,
                      scratch_layout(buf_words, n_rows, w32, n_cols, digest_name))


def commit_small(enc, digest, arr: torch.Tensor):
    """(W, length) Montgomery limbs on the encoding's CUDA device -> (mat,
    comm, flat) by one launch of csrc/commit_small.cu (module docstring).
    The outputs are views of one allocation (the commit owns them all), the
    intermediates one more."""
    _check(enc, digest, arr)
    tables = enc.device_tables()
    ligero = isinstance(tables, NttTables)
    if not ligero and not isinstance(tables, LevelTable):
        raise TypeError(f"commit_small: no kernel for {type(enc).__name__}")
    arr = arr.contiguous()
    w, length = arr.shape
    w32 = w // 2
    n_rows, npr, n_cols = enc.get_dims(length)
    padded = n_rows * npr > length
    plan = _launch_plan(ligero, n_rows, npr, n_cols, w32, digest.name,
                        0 if ligero else tables.positions, padded)
    lay = plan.scratch
    out = arr.new_empty((plan.out_words,))
    comm = out[: w * n_rows * n_cols].view(w, n_rows, n_cols)
    np2 = _next_pow2(n_cols)
    flat = out[plan.flat : plan.flat + 16 * (2 * np2 - 1)].view(torch.int64).view(8, 2 * np2 - 1)
    mat = (out[plan.mat : plan.out_words].view(w, n_rows, npr) if padded
           else arr.view(w, n_rows, npr))
    scratch = arr.new_empty((lay.nbytes // 4,))
    base = scratch.data_ptr()
    lib = cuda_build.load(_NAME, _bind)
    dev = arr.device
    # the current stream's handle, as torch.cuda.current_stream(dev).cuda_stream
    # gives it, without making a Stream object (a few us of a ~50 us host path)
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    head = (arr.data_ptr(), length, mat.data_ptr() if padded else None, comm.data_ptr(),
            flat.data_ptr(), None if lay.buf is None else base + lay.buf, base + lay.words,
            None if lay.cvs is None else base + lay.cvs, base + lay.leaves)
    if ligero:
        err = lib.lcpc_commit_small_ligero(
            *head, tables.tw.data_ptr(), tables.consts.data_ptr(), plan.passes, plan.n_passes,
            w32, _DIGEST_CODE[digest.name], n_rows, plan.log_n, npr, dev.index or 0, stream)
    else:
        err = lib.lcpc_commit_small_sdig(
            *head, tables.table.data_ptr(), tables.table.shape[0], tables.max_out, w32,
            _DIGEST_CODE[digest.name], n_rows, npr, n_cols, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"commit_small launch failed: cudaError_t {err}")
    commit_small.launches += 1
    return mat, comm, flat


launch_count.counted(commit_small)


def commit_small_plain(enc, digest, arr: torch.Tensor):
    """The kernel's plain version on arr's device: (W, length) limbs ->
    (mat, comm, flat) through the stages' plain versions."""
    w, length = arr.shape
    n_rows, npr, n_cols = enc.get_dims(length)
    pad = n_rows * npr - length
    mat = (torch.nn.functional.pad(arr, (0, pad)) if pad else arr).reshape(w, n_rows, npr)
    comm, words = enc.encode_rows_words_plain(mat)
    flat = digest.merkle_tree_plain(digest.hash_word_columns_plain(words), _next_pow2(n_cols))
    return mat, comm, flat
