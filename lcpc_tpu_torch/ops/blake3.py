"""BLAKE3: host reference, the column-hash and Merkle kernels, and their plain twins.

Implements the reference's column-hash convention
(lcpc-2d/src/lib.rs:706-745): each column digest is
blake3(32 zero bytes || canonical LE repr of column elements, row-major down
the column), and Merkle nodes are blake3(left_digest || right_digest)
(lib.rs:762-785).

- `blake3(data)` is the plain host hash (32-byte output), the slow and
  obviously correct twin (port of lcpc_tpu/ops/blake3_ref.py).
- The wrappers of the CUDA kernels in `csrc/blake3_cols.cu` (built with nvcc
  for sm_90a at first use, loaded with ctypes), each one launch, counted in
  its `.launches`: `blake3_chunks` hashes whole 1 KiB chunks of every
  column's stream (an optional carry buffer, then the words) into chunk
  CVs; `merge_chunk_cvs` merges each column's chunk CVs into its digest;
  `merkle_tree` builds the whole Merkle array over the column digests;
  `merkle_walk` walks the verifier's opened columns up to the root.  On
  CUDA tensors they launch the kernel or raise; on CPU tensors they run
  their plain PyTorch versions `blake3_chunks_plain`, `merge_chunk_cvs_plain`,
  `merkle_tree_plain` and `merkle_walk_plain`, built from the vectorized
  compression `_compress_t` (`blake3_parents_plain` for parent nodes).
- `hash_word_columns` is the digest entry point built on them (port of
  lcpc_tpu/ops/blake3_jax.py): by `cols_route`, at few columns (verify's
  opened ones) one launch of the few-column kernel from words to digests,
  else (the commits) `blake3_chunks` and the chunk tree; on CPU tensors
  `hash_word_columns_plain` (the wide route through the plain versions);
  `hash_word_columns_few_plain` is the few route's order, the reference
  the tests hold the kernel to, and `merkle_parent_plain` and
  `merkle_layer_plain` (lcpc_tpu's `merkle_parent` and `merkle_layer`)
  are the steps of the plain trees, on any device;
  `merkle_parent_quad_plain` is the walk kernel's parent in its quad
  layout (a lane a column of the state), the model the tests hold to
  `merkle_parent_plain`.  Column words are u32 values as int32
  storage (the layout `encode_rows_words` returns) or as int64; digests are
  (8, n) int64 tensors holding u32 values.
- `hash_word_columns_sequential` is the block-by-block plain version (one
  compression over all columns at a time, the chunk tree merged after);
  `merge_chunk_cvs_stack_plain` is the chunk tree in the CV-stack order of
  the thread-per-column kernel; the tests hold the plain versions to them
  and to the host hash.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ..utils import cuda_build
from . import launch_count, merkle
from .launch_count import LaunchCount

IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024
CHUNK_WORDS = CHUNK_LEN // 4
PREFIX_WORDS = 8  # the column hash's 32 zero bytes

_MASK = 0xFFFFFFFF
_NAME = "blake3_cols"


# ---------------------------------------------------------------------------
# host reference
# ---------------------------------------------------------------------------


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def compress(cv, block_words, counter, block_len, flags):
    """BLAKE3 compression; returns all 16 output words."""
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    out = [0] * 16
    for i in range(8):
        out[i] = state[i] ^ state[i + 8]
        out[i + 8] = state[i + 8] ^ cv[i]
    return out


def _block_words(block: bytes) -> list[int]:
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", block))


def _chunk_output(chunk: bytes, counter: int):
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    cv = list(IV)
    for i, blk in enumerate(blocks[:-1]):
        flags = CHUNK_START if i == 0 else 0
        cv = compress(cv, _block_words(blk), counter, BLOCK_LEN, flags)[:8]
    last = blocks[-1]
    flags = CHUNK_END | (CHUNK_START if len(blocks) == 1 else 0)
    return cv, _block_words(last), len(last), flags


def _chunk_cv(chunk: bytes, counter: int) -> list[int]:
    cv, words, blen, flags = _chunk_output(chunk, counter)
    return compress(cv, words, counter, blen, flags)[:8]


def _left_len(n_chunks: int) -> int:
    """Left subtree = largest power of two strictly less than n_chunks."""
    p = 1
    while p * 2 < n_chunks:
        p *= 2
    return p


def blake3(data: bytes) -> bytes:
    """Plain BLAKE3 hash, 32-byte output."""
    chunks = [data[i : i + CHUNK_LEN] for i in range(0, len(data), CHUNK_LEN)]
    if not chunks:
        chunks = [b""]

    if len(chunks) == 1:
        cv, words, blen, flags = _chunk_output(chunks[0], 0)
        out = compress(cv, words, 0, blen, flags | ROOT)
        return struct.pack("<8I", *out[:8])

    def subtree(lo: int, hi: int) -> list[int]:
        if hi - lo == 1:
            return _chunk_cv(chunks[lo], lo)
        mid = lo + _left_len(hi - lo)
        left = subtree(lo, mid)
        right = subtree(mid, hi)
        return compress(list(IV), left + right, 0, BLOCK_LEN, PARENT)[:8]

    mid = _left_len(len(chunks))
    left = subtree(0, mid)
    right = subtree(mid, len(chunks))
    out = compress(list(IV), left + right, 0, BLOCK_LEN, PARENT | ROOT)
    return struct.pack("<8I", *out[:8])


# ---------------------------------------------------------------------------
# torch compression (vectorized over any batch)
# ---------------------------------------------------------------------------

# per round: message words feeding the column step, then the diagonal step
_COL_X, _COL_Y = [0, 2, 4, 6], [1, 3, 5, 7]
_DIA_X, _DIA_Y = [8, 10, 12, 14], [9, 11, 13, 15]
_MSG_SCHEDULE = []
_perm = list(range(16))
for _r in range(7):
    _MSG_SCHEDULE.append(list(_perm))
    _perm = [_perm[p] for p in MSG_PERMUTATION]


def _rotr_t(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g4(a, b, c, d, mx, my):
    """Four G functions at once; each argument is (4, ...batch) int64."""
    a = (a + b + mx) & _MASK
    d = _rotr_t(d ^ a, 16)
    c = (c + d) & _MASK
    b = _rotr_t(b ^ c, 12)
    a = (a + b + my) & _MASK
    d = _rotr_t(d ^ a, 8)
    c = (c + d) & _MASK
    b = _rotr_t(b ^ c, 7)
    return a, b, c, d


def _compress_t(cv: torch.Tensor, m: torch.Tensor, counter, block_len,
                flags) -> torch.Tensor:
    """Vectorized compression: cv (8, ...), m (16, ...) int64 u32 words;
    counter (< 2^32)/block_len/flags are ints or tensors broadcastable to
    the batch.  Returns the 8-word output CV."""
    batch = cv.shape[1:]
    a, b = cv[0:4], cv[4:8]
    c = torch.tensor(IV[0:4], dtype=torch.int64, device=cv.device)
    c = c.reshape(4, *([1] * len(batch))).expand(4, *batch)
    d = torch.stack([torch.as_tensor(v, dtype=torch.int64, device=cv.device)
                     .expand(batch) for v in (counter, 0, block_len, flags)])
    for s in _MSG_SCHEDULE:
        a, b, c, d = _g4(a, b, c, d, m[[s[i] for i in _COL_X]],
                         m[[s[i] for i in _COL_Y]])
        # diagonals: (0,5,10,15) (1,6,11,12) (2,7,8,13) (3,4,9,14)
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g4(a, b, c, d, m[[s[i] for i in _DIA_X]],
                         m[[s[i] for i in _DIA_Y]])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return torch.cat([a ^ c, b ^ d], dim=0)


def _iv(batch, device) -> torch.Tensor:
    iv = torch.tensor(IV, dtype=torch.int64, device=device)
    return iv.reshape(8, *([1] * len(batch))).expand(8, *batch)


def _u32(words: torch.Tensor) -> torch.Tensor:
    """u32 words as int32 storage or int64 -> their values as int64."""
    return words.to(torch.int64) & _MASK


def hash_word_columns_sequential(words: torch.Tensor) -> torch.Tensor:
    """Hash each column behind the 32-zero-byte prefix, one compression over
    all columns at a time (block by block down each chunk, then the chunk
    tree): the plain reference the tests hold the kernels' plain versions to.
    words (L, C) u32 values; returns (8, C) int64."""
    words = _u32(words)
    n_cols = words.shape[1]
    total = PREFIX_WORDS + words.shape[0]
    n_blocks = max(1, (total + 15) // 16)
    n_chunks = max(1, (total + 255) // 256)
    last_len = (total % 16) * 4
    if last_len == 0:
        last_len = 64 if total > 0 else 0
    buf = words.new_zeros((n_blocks * 16, n_cols))
    buf[PREFIX_WORDS:total] = words

    cvs = []
    for ci in range(n_chunks):
        cv = _iv((n_cols,), words.device)
        for k in range(16 * ci, min(16 * ci + 16, n_blocks)):
            is_start = k % 16 == 0
            is_last = k == n_blocks - 1
            is_end = k % 16 == 15 or is_last
            flags = ((CHUNK_START if is_start else 0)
                     | (CHUNK_END if is_end else 0)
                     | (ROOT if n_chunks == 1 and is_last else 0))
            blen = last_len if is_last else 64
            cv = _compress_t(cv, buf[16 * k : 16 * k + 16], ci, blen, flags)
        cvs.append(cv)

    # merge chunk CVs pairwise, promoting an odd last one: this reproduces
    # blake3's largest-power-of-two-left tree shape
    while len(cvs) > 1:
        flags = PARENT | (ROOT if len(cvs) == 2 else 0)
        pairs = len(cvs) // 2
        left = torch.stack(cvs[0 : 2 * pairs : 2], dim=1)   # (8, pairs, C)
        right = torch.stack(cvs[1 : 2 * pairs : 2], dim=1)
        out = _compress_t(_iv((pairs, n_cols), words.device),
                          torch.cat([left, right], dim=0), 0, 64, flags)
        merged = list(out.unbind(dim=1))
        if len(cvs) % 2:
            merged.append(cvs[-1])
        cvs = merged
    return cvs[0]


# ---------------------------------------------------------------------------
# the plain chunk hash and parent nodes
# ---------------------------------------------------------------------------


def blake3_chunks_plain(words: torch.Tensor, carry, carry_len: int, chunk_base: int,
                        n_chunks: int, final_len: int = 0,
                        root: bool = False) -> torch.Tensor:
    """The chunk CVs blake3_chunks writes, chunk-parallel: (n_chunks, 8, C)
    int64 u32 values.  The stream of each column is carry[:carry_len] (zeros
    when carry is None), then words (L, C); chunk j is stream words
    [256 j, 256 j + 256), the last one final_len words when final_len > 0."""
    n_cols = words.shape[1]
    stream_len = CHUNK_WORDS * (n_chunks - 1) + (final_len or CHUNK_WORDS)
    head = (words.new_zeros((carry_len, n_cols), dtype=torch.int64) if carry is None
            else _u32(carry[:carry_len]))
    data = torch.cat([head, _u32(words[: max(0, stream_len - carry_len)])])[:stream_len]
    data = torch.nn.functional.pad(data, (0, 0, 0, n_chunks * CHUNK_WORDS - stream_len))
    data = data.reshape(n_chunks, 16, 16, n_cols).permute(1, 2, 0, 3)  # (block, word, j, C)
    lens = torch.full((n_chunks,), CHUNK_WORDS, dtype=torch.int64, device=words.device)
    if final_len:
        lens[-1] = final_len
    n_blocks = (lens + 15) // 16
    counter = (chunk_base + torch.arange(n_chunks, device=words.device))[:, None]
    cv = _iv((n_chunks, n_cols), words.device)
    for b in range(int(n_blocks.max())):
        last = n_blocks - 1 == b
        flags = (CHUNK_START if b == 0 else 0) | torch.where(
            last, CHUNK_END | (ROOT if root else 0), 0)
        blen = torch.where(last, (lens - 16 * b) * 4, 64)
        new = _compress_t(cv, data[b], counter, blen[:, None], flags[:, None])
        cv = torch.where((b < n_blocks)[None, :, None], new, cv)
    return cv.permute(1, 0, 2)


def blake3_parents_plain(left: torch.Tensor, right: torch.Tensor, n_pairs: int,
                         flags: int) -> torch.Tensor:
    """Parent nodes, the step every tree is built of: left (n_out, 8, C),
    right (>= n_pairs, 8, C) -> (n_out, 8, C) int64 u32 values, compress(IV, left || right) for
    the first n_pairs nodes and left as it is (a promoted node) after."""
    out = _u32(left).clone()
    if n_pairs:
        lp = _u32(left[:n_pairs]).permute(1, 0, 2)   # (8, n_pairs, C)
        rp = _u32(right[:n_pairs]).permute(1, 0, 2)
        out[:n_pairs] = _compress_t(_iv(lp.shape[1:], left.device), torch.cat([lp, rp]),
                                    0, 64, flags).permute(1, 0, 2)
    return out


# ---------------------------------------------------------------------------
# the chunk-hash kernel's wrapper
# ---------------------------------------------------------------------------


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lcpc_blake3_chunks.argtypes = [p, p, i, ll, i, ll, i, i, i, p, i, i, p]
    lib.lcpc_blake3_chunk_tree.argtypes = [p, i, i, i, i, p, i, p]
    lib.lcpc_blake3_cols_few.argtypes = [p, ll, i, p, p, p, i, p]
    lib.lcpc_blake3_merkle_tree.argtypes = [p, ll, i, ll, p, p, i, p]
    lib.lcpc_blake3_merkle_walk.argtypes = [p, ll, ll, p, ll, ll, p, p, i, i, p, p, p, i, p]
    for fn in (lib.lcpc_blake3_chunks, lib.lcpc_blake3_chunk_tree, lib.lcpc_blake3_cols_few,
               lib.lcpc_blake3_merkle_tree, lib.lcpc_blake3_merkle_walk):
        fn.restype = ctypes.c_int


def _check_words(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")


def _one_device(name: str, *tensors) -> torch.device:
    """The device every operand lies on; raises when they differ."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on different devices {sorted(map(str, devs))}")
    return devs.pop()


def _plain_here(name: str, *tensors) -> bool:
    """True when the operands lie on the CPU (the plain version runs), False
    on CUDA (the kernel launches); raises for mixed or other devices."""
    device = _one_device(name, *tensors)
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return False


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _launch_args(t: torch.Tensor):
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def blake3_chunks(words: torch.Tensor, out: torch.Tensor, *, carry=None,
                  carry_len: int = PREFIX_WORDS, chunk_base: int = 0,
                  final_len: int = 0, root: bool = False) -> None:
    """Chunk CVs of out.shape[0] consecutive chunks of every column's stream
    (carry[:carry_len], zeros when carry is None, then words (L, C)) into out
    (n_chunks, 8, C), int32 storage of u32 words or int64; chunk j covers
    stream words [256 j, 256 j + 256), the last one final_len (1 .. 256)
    words when final_len > 0 (the column's final chunk); its counter is
    chunk_base + j; `root` marks a column of one chunk (its CV is the
    digest).

    CUDA tensors launch csrc/blake3_cols.cu's blake3_chunks (counted in
    blake3_chunks.launches) or raise; CPU tensors run blake3_chunks_plain."""
    _check_words("blake3_chunks words", words, (torch.int32, torch.int64))
    _check_words("blake3_chunks out", out, (torch.int32, torch.int64))
    n_chunks, n_cols = out.shape[0], words.shape[1]
    if words.dim() != 2 or out.shape[1:] != (8, n_cols) or not out.is_contiguous():
        raise ValueError(f"blake3_chunks: words (L, C) and contiguous out (n, 8, C), got "
                         f"{tuple(words.shape)} and {tuple(out.shape)}")
    if carry is not None and (carry.shape[1] != n_cols or carry.shape[0] < carry_len):
        raise ValueError(f"blake3_chunks: carry {tuple(carry.shape)} for {carry_len} words")
    if _plain_here("blake3_chunks", words, out, carry):
        res = blake3_chunks_plain(words, carry, carry_len, chunk_base, n_chunks,
                                  final_len, root)
        out.copy_(res.to(out.dtype))
        return
    if words.dtype == torch.int64:
        words = words.to(torch.int32)  # the same u32 bit patterns
    words = words.contiguous()
    if carry is not None:
        _check_words("blake3_chunks carry", carry, (torch.int32,))
        carry = carry.contiguous()
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(words)
    _check_launch("blake3_chunks", lib.lcpc_blake3_chunks(
        words.data_ptr() if words.numel() else None,
        None if carry is None else carry.data_ptr(), carry_len, words.shape[0], n_cols,
        chunk_base, n_chunks, final_len, int(root), out.data_ptr(),
        int(out.dtype == torch.int64), dev, stream))
    blake3_chunks.launches += 1


launch_count.counted(blake3_chunks)


# ---------------------------------------------------------------------------
# the trees: chunk tree, Merkle tree, path walk
# ---------------------------------------------------------------------------

# merge_chunk_cvs takes a warp per column up to here: at 4,096 columns of 65
# CVs a warp per column still beat a thread per column on the H100
WARP_TREE_MAX_COLS = 4096


def merge_chunk_cvs_plain(cvs: torch.Tensor, root: bool = True) -> torch.Tensor:
    """The chunk tree through blake3_parents_plain, level by level (adjacent
    pairs, an odd last CV promoted: BLAKE3's largest-power-of-two-left
    tree), ROOT on the last merge unless `root` is False (a subtree), on
    any device; (n >= 2, 8, C) -> (8, C) int64."""
    while cvs.shape[0] > 2:
        n = cvs.shape[0]
        cvs = blake3_parents_plain(cvs[0:n:2], cvs[1:n:2], n // 2, PARENT)
    return blake3_parents_plain(cvs[0:1], cvs[1:2], 1, PARENT | (ROOT if root else 0))[0]


def merge_chunk_cvs_stack_plain(cvs: torch.Tensor) -> torch.Tensor:
    """The chunk tree in the order of the thread-per-column kernel: BLAKE3's
    CV stack (chunk i < n - 1 pushed after merging with the top while i + 1
    has a trailing zero bit, then the last chunk folded in top down, ROOT
    last).  The same digests as merge_chunk_cvs_plain."""
    def parent(left, right, flags):
        return _compress_t(_iv(left.shape[1:], left.device), torch.cat([left, right]), 0, 64,
                           flags)

    stack = []
    for i in range(cvs.shape[0] - 1):
        cv, total = _u32(cvs[i]), i + 1
        while total & 1 == 0:
            cv, total = parent(stack.pop(), cv, PARENT), total >> 1
        stack.append(cv)
    cv = _u32(cvs[-1])
    while stack:
        left = stack.pop()
        cv = parent(left, cv, PARENT | (0 if stack else ROOT))
    return cv


def merge_chunk_cvs(cvs: torch.Tensor, *, _lanes: "int | None" = None) -> torch.Tensor:
    """Chunk CVs (n >= 2, 8, C), int32 storage or int64 -> (8, C) int64
    digests: BLAKE3's largest-power-of-two-left chunk tree.

    CUDA tensors launch csrc/blake3_cols.cu's chunk tree once (counted in
    merge_chunk_cvs.launches) or raise: a thread per column running BLAKE3's
    CV stack or, for at most WARP_TREE_MAX_COLS columns of 3 .. 512 CVs, a
    warp per column level by level; `_lanes` (1 or 32) forces one (tests,
    timing).  CPU tensors run merge_chunk_cvs_plain."""
    _check_words("merge_chunk_cvs cvs", cvs, (torch.int32, torch.int64))
    if cvs.dim() != 3 or cvs.shape[0] < 2 or cvs.shape[1] != 8:
        raise ValueError(f"merge_chunk_cvs: cvs must be (n >= 2, 8, C), got {tuple(cvs.shape)}")
    n, _, n_cols = cvs.shape
    if _plain_here("merge_chunk_cvs", cvs):
        return merge_chunk_cvs_plain(cvs)
    out = torch.empty((8, n_cols), dtype=torch.int64, device=cvs.device)
    if n_cols == 0:
        return out
    lanes = _lanes or (32 if 2 < n <= 512 and n_cols <= WARP_TREE_MAX_COLS else 1)
    cvs = cvs.contiguous()
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(cvs)
    _check_launch("merge_chunk_cvs", lib.lcpc_blake3_chunk_tree(
        cvs.data_ptr(), int(cvs.dtype == torch.int64), n, n_cols, lanes, out.data_ptr(), dev,
        stream))
    merge_chunk_cvs.launches += 1
    return out


launch_count.counted(merge_chunk_cvs)


def _chunking(n_words: int) -> tuple[int, int]:
    """(chunks, words in the last chunk) of a column of n_words behind the
    8-word prefix."""
    total = PREFIX_WORDS + n_words
    n_chunks = -(-total // CHUNK_WORDS)
    return n_chunks, total - CHUNK_WORDS * (n_chunks - 1)


def hash_word_columns_plain(words: torch.Tensor) -> torch.Tensor:
    """hash_word_columns' wide route through its kernels' plain versions
    (every chunk, then the chunk tree), on any device (what chip_smoke.py
    holds the kernels to on the card)."""
    n_chunks, final_len = _chunking(words.shape[0])
    cvs = blake3_chunks_plain(words, None, PREFIX_WORDS, 0, n_chunks, final_len,
                              root=n_chunks == 1)
    return cvs[0] if n_chunks == 1 else merge_chunk_cvs_plain(cvs)


# hash_word_columns' routes: "few" (one launch of the few-column kernel, a
# column's chain of compressions the limit) up to FEW_COLS_MAX columns of up
# to FEW_WORDS_MAX words, else "wide" (blake3_chunks, then the chunk tree:
# the card's integer pipes the limit).  FEW_COLS_MAX holds verify's opened
# columns (189 Ligero, 6,593 Brakedown) and stays under the 16,384 columns
# of the smallest staged Ligero commit (2^17 coefficients), so the commits
# keep the wide route; on an H100 the few kernel leads at every column
# count to 32,768 and loses at 65,536 of 288 words
# (scripts/time_blake3_few.py's sweep).
FEW_COLS_MAX = 8_192
FEW_WARPS = 4  # the few kernel's chunks a block (csrc/blake3_cols.cu's kFewWarps)
# the longest column it takes: the last block of a column group holds a
# 1 KiB node of every FEW_WARPS chunks in its 227 KiB of shared memory, and
# 1 KiB a warp besides (lcpc_blake3_cols_few)
FEW_WORDS_MAX = 256 * FEW_WARPS * ((227 * 1024 // 4 - FEW_WARPS * 256 - 1) // 256) - PREFIX_WORDS
ROUTES = ("few", "wide")
# the launches of the few route's kernel (the wide route's two kernels,
# blake3_chunks and the chunk tree, count their own)
COLS_KERNELS = {"few": LaunchCount()}


def cols_route(n_cols: int, n_words: int = 0) -> str:
    """The route hash_word_columns takes over n_cols columns of n_words."""
    return "few" if n_cols <= FEW_COLS_MAX and n_words <= FEW_WORDS_MAX else "wide"


def hash_word_columns_few_plain(words: torch.Tensor) -> torch.Tensor:
    """hash_word_columns' few route, the kernel's order on any device: every
    chunk's CV (blake3_chunks_plain), then each block's FEW_WARPS chunks
    merged level by level into its subtree's CV, then those merged level by
    level (merge_chunk_cvs_plain), ROOT on the final merge: what the tests
    and chip_smoke.py hold the kernel to.  Equal to hash_word_columns_plain:
    the blocks' runs are aligned powers of two."""
    n_chunks, final_len = _chunking(words.shape[0])
    cvs = blake3_chunks_plain(words, None, PREFIX_WORDS, 0, n_chunks, final_len,
                              root=n_chunks == 1)
    if n_chunks == 1:
        return cvs[0]
    if n_chunks <= FEW_WARPS:  # one block a column group
        return merge_chunk_cvs_plain(cvs)
    full, n_cols = n_chunks // FEW_WARPS, cvs.shape[2]
    # the whole runs of FEW_WARPS chunks side by side, as columns of one batch
    runs = cvs[: full * FEW_WARPS].reshape(full, FEW_WARPS, 8, n_cols).permute(1, 2, 0, 3)
    nodes = [merge_chunk_cvs_plain(runs.reshape(FEW_WARPS, 8, full * n_cols), root=False)
             .reshape(8, full, n_cols).permute(1, 0, 2)]
    tail = cvs[full * FEW_WARPS :]
    if tail.shape[0]:
        nodes.append((merge_chunk_cvs_plain(tail, root=False) if tail.shape[0] > 1
                      else _u32(tail[0]))[None])
    nodes = torch.cat(nodes)
    return merge_chunk_cvs_plain(nodes)


def hash_word_columns(words: torch.Tensor, *, _route: "str | None" = None) -> torch.Tensor:
    """Hash each column of a word matrix behind a 32-zero-byte prefix.

    words: (L, C) u32 words, int32 storage (as encode_rows_words returns
    them) or int64 values — the message of column c is 8 zero words followed
    by words[:, c] (lib.rs:706-745).  Returns (8, C) int64 digests.

    `cols_route` picks the route by the shape (`_route` forces one, for
    tests and timing): "few" (verify's opened columns), one launch of
    csrc/blake3_cols.cu's few-column kernel from words to digests (counted
    in COLS_KERNELS["few"]; its plain version, in the kernel's order,
    hash_word_columns_few_plain); "wide" (the commits), one blake3_chunks
    launch over every (column, chunk), then one chunk-tree launch
    (merge_chunk_cvs) when a column has several chunks.  CUDA tensors
    launch the route's kernels or raise; CPU tensors run
    hash_word_columns_plain, whichever the route (the routes' digests are
    the same)."""
    _check_words("hash_word_columns words", words, (torch.int32, torch.int64))
    if (words.dim() != 2 or _route not in (None, *ROUTES)
            or _route == "few" and words.shape[0] > FEW_WORDS_MAX):
        raise ValueError(f"hash_word_columns: words (L, C) and a route of {list(ROUTES)}, "
                         f"L <= {FEW_WORDS_MAX} for the few route; got {tuple(words.shape)} "
                         f"and {_route}")
    if _plain_here("hash_word_columns", words):
        return hash_word_columns_plain(words)
    n_words, n_cols = words.shape
    route = cols_route(n_cols, n_words) if _route is None else _route
    if route == "few":
        return _cols_few(words)
    n_chunks, final_len = _chunking(n_words)
    if n_chunks == 1:
        out = torch.empty((1, 8, n_cols), dtype=torch.int64, device=words.device)
        blake3_chunks(words, out, final_len=final_len, root=True)
        return out[0]
    cvs = torch.empty((n_chunks, 8, n_cols), dtype=torch.int32, device=words.device)
    blake3_chunks(words, cvs, final_len=final_len)
    return merge_chunk_cvs(cvs)


def _cols_few(words: torch.Tensor) -> torch.Tensor:
    """The few route on the card: one allocation (the digests, then the
    kernel's scratch when a column has more than FEW_WARPS chunks), one
    launch."""
    n_words, n_cols = words.shape
    out_words = 8 * n_cols  # int64 elements of the digests
    if n_cols == 0:
        return torch.empty((8, 0), dtype=torch.int64, device=words.device)
    if words.dtype == torch.int64:
        words = words.to(torch.int32)  # the same u32 bit patterns
    words = words.contiguous()
    groups = -(-_chunking(n_words)[0] // FEW_WARPS)
    buf = torch.empty(out_words + (4 * groups * n_cols if groups > 1 else 0), dtype=torch.int64,
                      device=words.device)
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(words)
    counters = (_stream_counters("few", words.device, dev, stream, -(-n_cols // 32))
                if groups > 1 else None)
    _check_launch("hash_word_columns (few)", lib.lcpc_blake3_cols_few(
        words.data_ptr() if n_words else None, n_words, n_cols, buf.data_ptr(),
        buf.data_ptr() + 8 * out_words if groups > 1 else None,
        None if counters is None else counters.data_ptr(), dev, stream))
    COLS_KERNELS["few"].launches += 1
    return buf[:out_words].view(8, n_cols)


def _nodes(d: torch.Tensor) -> torch.Tensor:
    """(8, n) digests -> the (n, 8, 1) node view blake3_parents_plain takes."""
    return d.t().unsqueeze(2)


def merkle_parent_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """parent = blake3(left_digest_bytes || right_digest_bytes), (8, n) each,
    through blake3_parents_plain, on any device; returns (8, n) int64."""
    out = blake3_parents_plain(_nodes(left), _nodes(right), left.shape[1],
                               CHUNK_START | CHUNK_END | ROOT)
    return out[:, :, 0].t()


def merkle_parent_quad_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """merkle_parent_plain in the walk kernel's quad layout (csrc/blake3.cuh
    quad_parent), on any device: the state as (n, 4) rows a, b, c, d, lane
    q on the last axis holding column q; each message word a select by lane
    (the kernel's `pick`); the diagonal step lane q's G_{q-1}, a, c, d rolled
    in from lanes q - 1, q + 1, q + 2 and back after; the output's words
    from the two lanes holding their halves.  (8, n) each -> (8, n) int64."""
    m = list(torch.cat([_u32(left), _u32(right)]).unbind(0))  # 16 x (n,)

    def pick(*ws):  # word ws[q] in lane q: (n, 4)
        return torch.stack([m[i] for i in ws], dim=-1)

    n = left.shape[1]
    iv = torch.tensor(IV, dtype=torch.int64, device=left.device)
    a, b = iv[0:4].expand(n, 4), iv[4:8].expand(n, 4)
    c = iv[0:4].expand(n, 4)
    d = torch.tensor([0, 0, BLOCK_LEN, CHUNK_START | CHUNK_END | ROOT], dtype=torch.int64,
                     device=left.device).expand(n, 4)
    for r in range(7):
        a, b, c, d = _g4(a, b, c, d, pick(0, 2, 4, 6), pick(1, 3, 5, 7))
        a, c, d = a.roll(1, -1), c.roll(-1, -1), d.roll(-2, -1)
        a, b, c, d = _g4(a, b, c, d, pick(14, 8, 10, 12), pick(15, 9, 11, 13))
        if r < 6:
            a, c, d = a.roll(-1, -1), c.roll(1, -1), d.roll(2, -1)
            m = [m[i] for i in MSG_PERMUTATION]
    # lane p holds a_{p-1}, b_p, c_{p+1}, d_{p+2}
    lo = [a[:, (i + 1) % 4] ^ c[:, (i + 3) % 4] for i in range(4)]
    hi = [b[:, i] ^ d[:, (i + 2) % 4] for i in range(4)]
    return torch.stack(lo + hi)


def merkle_layer_plain(digests: torch.Tensor) -> torch.Tensor:
    """One Merkle layer through blake3_parents_plain: (8, n), n even -> (8, n // 2)."""
    return merkle_parent_plain(digests[:, 0::2], digests[:, 1::2])


def merkle_tree_plain(leaves: torch.Tensor, n_cols_np2: int) -> torch.Tensor:
    """merkle_tree layer by layer through merkle_layer_plain, on any device."""
    return merkle.tree_by_layers(leaves, n_cols_np2, merkle_layer_plain)


_counters: dict = {}  # (use, device, stream) -> self-resetting int32 counters on the card


def _stream_counters(use: str, device: torch.device, dev: int, stream: int,
                     n: int = 1) -> torch.Tensor:
    """At least n int32 counters on the card for the kernels of one use on
    (dev, stream): 0 before each launch and again after it (each launch
    sets back what it counted), so every launch on that stream can share
    them; a longer buffer replaces a shorter one."""
    counters = _counters.get((use, dev, stream))
    if counters is None or counters.numel() < n:
        counters = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[(use, dev, stream)] = counters
    return counters


def _tree_counter(device: torch.device, dev: int, stream: int) -> torch.Tensor:
    """The counter a Merkle tree launch on (dev, stream) takes, shared by
    every tree kernel on that stream (BLAKE3's and SHA-256's, merkle.cuh)."""
    return _stream_counters("tree", device, dev, stream)


def merkle_tree(leaves: torch.Tensor, n_cols_np2: int) -> torch.Tensor:
    """The commitment's Merkle array: column digests (8, n_cols) int64,
    zero digests padding them to n_cols_np2 leaves (a power of two), then
    every layer up to the root, flattened leaves first: (8, 2 n_cols_np2 - 1)
    int64 (lib.rs:665-704).

    CUDA tensors launch csrc/blake3_cols.cu's merkle_tree once (counted in
    merkle_tree.launches) or raise; CPU tensors run merkle_tree_plain."""
    _check_words("merkle_tree leaves", leaves, (torch.int64,))
    if (leaves.dim() != 2 or leaves.shape[0] != 8 or not 1 <= leaves.shape[1] <= n_cols_np2
            or n_cols_np2 & (n_cols_np2 - 1)):
        raise ValueError(f"merkle_tree: leaves (8, 1 .. {n_cols_np2}) for a power-of-two "
                         f"width, got {tuple(leaves.shape)}")
    if _plain_here("merkle_tree", leaves):
        return merkle_tree_plain(leaves, n_cols_np2)
    if leaves.stride(1) != 1:
        leaves = leaves.contiguous()
    out = torch.empty((8, 2 * n_cols_np2 - 1), dtype=torch.int64, device=leaves.device)
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(leaves)
    _check_launch("merkle_tree", lib.lcpc_blake3_merkle_tree(
        leaves.data_ptr(), leaves.stride(0), leaves.shape[1], n_cols_np2, out.data_ptr(),
        _tree_counter(leaves.device, dev, stream).data_ptr(), dev, stream))
    merkle_tree.launches += 1
    return out


launch_count.counted(merkle_tree)


def merkle_walk_plain(digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """merkle_walk level by level through merkle_parent_plain, on any device."""
    return merkle.walk_by_parents(_u32(digs), _u32(uniq_sibs), inv, idx, merkle_parent_plain)


def _walk(name: str, entry, plain, counter, digs: torch.Tensor, uniq_sibs: torch.Tensor,
         inv: torch.Tensor, idx: torch.Tensor, root, flag):
    """Both digests' walk wrappers: the checks, the plain version `plain`
    on CPU tensors, else one launch of the kernel behind `entry()` (a
    library's walk entry point) counted in counter.launches.  Without root
    returns the (8, k) roots; with root (8,) int64 clears flag ((1,) int32)
    where a path reaches another node, and returns None."""
    for nm, t in (("digs", digs), ("uniq_sibs", uniq_sibs), ("inv", inv), ("idx", idx),
                  ("root", root)):
        if t is not None:
            _check_words(f"{name} {nm}", t, (torch.int64,))
    if flag is not None:
        _check_words(f"{name} flag", flag, (torch.int32,))
    k = digs.shape[1] if digs.dim() == 2 else -1
    if (digs.shape[0] != 8 or uniq_sibs.dim() != 2 or uniq_sibs.shape[0] != 8
            or inv.dim() != 2 or inv.shape[1] != k or tuple(idx.shape) != (k,)
            or (root is None) != (flag is None)
            or root is not None and (tuple(root.shape) != (8,) or tuple(flag.shape) != (1,))):
        raise ValueError(f"{name}: digs (8, k), uniq_sibs (8, U), inv (L, k), idx (k,), and "
                         f"both or neither of root (8,) and flag (1,); got {tuple(digs.shape)}, "
                         f"{tuple(uniq_sibs.shape)}, {tuple(inv.shape)}, {tuple(idx.shape)}, "
                         f"{None if root is None else tuple(root.shape)}, "
                         f"{None if flag is None else tuple(flag.shape)}")
    if _plain_here(name, digs, uniq_sibs, inv, idx, root, flag):
        roots = plain(digs, uniq_sibs, inv, idx)
        if root is None:
            return roots
        flag.mul_((roots == _u32(root)[:, None]).all().to(flag.dtype))
        return None
    out = torch.empty((8, k), dtype=torch.int64, device=digs.device) if root is None else None
    if k == 0:
        return out
    levels = inv.shape[0]
    inv, idx = inv.contiguous(), idx.contiguous()
    dev, stream = _launch_args(digs)
    _check_launch(name, entry()(
        digs.data_ptr(), *digs.stride(), uniq_sibs.data_ptr() if levels else None,
        *uniq_sibs.stride(), inv.data_ptr() if levels else None, idx.data_ptr(), k, levels,
        None if out is None else out.data_ptr(),
        None if root is None else root.contiguous().data_ptr(),
        None if flag is None else flag.data_ptr(), dev, stream))
    counter.launches += 1
    return out


def merkle_walk(digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                idx: torch.Tensor, *, root=None, flag=None):
    """The verifier's Merkle path walk (lib.rs:955-982): from the opened
    columns' digests digs (8, k), level l's sibling of column j is
    uniq_sibs[:, inv[l, j]] (uniq_sibs (8, U), inv (L, k), every entry < U),
    on the left when bit l of idx[j] is set (idx (k,), the columns'
    indices).  All int64; returns the (8, k) int64 roots the paths reach,
    or, given the commitment's root (8,), clears flag ((1,) int32, a view
    of the verifier's state) where one differs and returns None.

    CUDA tensors launch csrc/blake3_cols.cu's merkle_walk_quad_kernel once
    (a quad of lanes a column; counted in merkle_walk.launches) or raise;
    CPU tensors run merkle_walk_plain."""
    return _walk("merkle_walk", lambda: cuda_build.load(_NAME, _bind).lcpc_blake3_merkle_walk,
                 merkle_walk_plain, merkle_walk, digs, uniq_sibs, inv, idx, root, flag)


launch_count.counted(merkle_walk)


def digests_to_bytes(digests) -> np.ndarray:
    """(8, n) u32 words (tensor or array) -> (n, 32) uint8 (little-endian)."""
    if isinstance(digests, torch.Tensor):
        digests = digests.cpu().numpy()
    d = np.asarray(digests)
    return np.ascontiguousarray(d.T.astype("<u4")).view(np.uint8).reshape(d.shape[1], 32)


def bytes_to_digests(b: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 -> (8, n) uint32."""
    b = np.ascontiguousarray(b, dtype=np.uint8)
    return b.view("<u4").reshape(-1, 8).T.astype(np.uint32)
