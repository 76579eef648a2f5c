"""SHA-256: the column-hash and Merkle kernels and their plain twins, the
second digest behind the generic hash interface (the reference is generic
over `D: Digest`, lcpc-2d/src/lib.rs:34-58).  Port of
lcpc_tpu/ops/sha256_jax.py and of lcpc_tpu/core/streaming.py's SHA-256
update and finalize.

- The wrappers of the CUDA kernels in `csrc/sha256_cols.cu` (built with nvcc
  for sm_90a at first use, loaded with ctypes), each one launch, counted in
  its `.launches`: `sha256_cols` hashes every column's stream (an optional
  carry of fewer than 16 words, then the words) from a chaining value, and
  either keeps the state (a streaming update) or ends the message (the
  digests), by one of two kernels that `cols_route` picks by the column
  count (each launch also counted in COLS_KERNELS[its name].launches);
  `merkle_tree` builds the whole Merkle array over the column digests;
  `merkle_walk` walks the verifier's opened columns up to the root.
  `hash_word_columns` is the digest entry built on `sha256_cols`.
  On CUDA tensors they launch the kernel or raise; on CPU tensors they run
  the plain PyTorch versions `sha256_update_plain` / `sha256_finalize_plain`,
  `hash_word_columns_plain`, `merkle_tree_plain` and `merkle_walk_plain`.
- The plain versions vectorize every 64-byte block compression (`_compress`)
  as 32-bit add/xor/rotate tensor ops over the column axis, block after
  block, on words held as u32 values in int64 tensors (adds masked with
  0xFFFFFFFF); they call no kernel.
- SHA-256 reads big-endian words, so the little-endian column words are
  byte-swapped first and the digest words swapped back: a digest is (8, C)
  int64 LE words of the big-endian digest bytes, the convention the rest of
  the pipeline uses.
"""

from __future__ import annotations

import ctypes
import hashlib

import torch

from ..utils import cuda_build
from . import launch_count, merkle
from .launch_count import LaunchCount
from .blake3 import (_check_launch, _check_words, _launch_args, _plain_here, _tree_counter,
                     _u32, _walk)

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_H0 = (
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
)

PREFIX_WORDS = 8  # the column hash's 32 zero bytes
BLOCK_WORDS = 16
_MASK = 0xFFFFFFFF
_NAME = "sha256_cols"
# sha256_cols's kernels: "few" (32 columns a block, the message schedule in
# warps of their own) up to FEW_COLS_MAX columns, "wide" (a thread a column,
# the schedule inline) past it: the crossover measured on an H100
# (scripts/time_sha256.py's sweep of both kernels: "few" ahead at 8,192
# columns of 288 and of 2,048 words, behind at 10,240 of 288)
FEW_COLS_MAX = 8_192


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def _compress(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression, vectorized over the batch axes.

    h: (8, ...batch) and m: (16, ...batch) big-endian words (int64 holding
    u32).  Returns the chained (8, ...batch) state."""
    w = list(m.unbind(0))
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _MASK)
    a, b, c, d, e, f, g, hh = h.unbind(0)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)  # ~e is negative in int64; & g keeps 32 bits
        t1 = (hh + s1 + ch + _K[t] + w[t]) & _MASK
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        hh, g, f, e = g, f, e, (d + t1) & _MASK
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _MASK
    return (h + torch.stack([a, b, c, d, e, f, g, hh])) & _MASK


def _h0(n: int, device) -> torch.Tensor:
    return torch.tensor(_H0, dtype=torch.int64, device=device)[:, None].expand(8, n)


def h0_state(n_cols: int, device) -> torch.Tensor:
    """The initial chaining value of n_cols columns: (8, n_cols) int32
    storage of u32 words, the state sha256_cols updates."""
    return _h0(n_cols, device).to(torch.int32)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def hash_word_columns_plain(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each column of an LE word matrix behind the 8-word zero
    prefix, the whole padded message block by block, on any device.

    words: (L, C) u32 words, int32 storage or int64 values; the message of
    column c is 8 zero words, then words[:, c] (lib.rs:706-745).  Returns
    (8, C) int64 digests in LE words."""
    words = _u32(words)
    total = PREFIX_WORDS + words.shape[0]
    n_cols = words.shape[1]
    # padding in whole words (the message is word-aligned): 0x80000000, zero
    # words, then the 64-bit big-endian bit length
    n_blocks = (total + 3 + 15) // 16
    be = words.new_zeros((n_blocks * 16, n_cols))
    be[PREFIX_WORDS:total] = _bswap32(words)
    be[total] = 0x80000000
    bits = total * 32
    be[-2] = bits >> 32
    be[-1] = bits & _MASK
    h = _h0(n_cols, words.device)
    for k in range(n_blocks):
        h = _compress(h, be[16 * k : 16 * k + 16])
    return _bswap32(h)


def sha256_update_plain(cv: torch.Tensor, carry, carry_len: int,
                        words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A streaming update on any device: the stream carry[:carry_len]
    (zeros when carry is None) || words (L, C) hashed from the chaining
    value cv (8, C) through its whole 64-byte blocks.  Returns (the new
    chaining value (8, C) int64, the new carry (16, C) int64 with the rest
    of the stream, fewer than 16 words, at its head, their count); all u32
    values."""
    n_cols = words.shape[1]
    head = (words.new_zeros((carry_len, n_cols), dtype=torch.int64) if carry is None
            else _u32(carry[:carry_len]))
    data = torch.cat([head, _u32(words)])
    n_full = data.shape[0] // BLOCK_WORDS
    be = _bswap32(data[: BLOCK_WORDS * n_full])
    h = _u32(cv)
    for b in range(n_full):
        h = _compress(h, be[16 * b : 16 * b + 16])
    rem = data.shape[0] - BLOCK_WORDS * n_full
    new_carry = data.new_zeros((BLOCK_WORDS, n_cols))
    new_carry[:rem] = data[BLOCK_WORDS * n_full :]
    return h, new_carry, rem


def sha256_finalize_plain(cv: torch.Tensor, carry, rem: int, total_words: int) -> torch.Tensor:
    """The end of a streamed message on any device: the carry's rem words
    (zeros when carry is None), the 0x80000000 word, zeros and the 64-bit
    bit length of the total_words-word message, one block when rem + 3 <=
    16, else two, from the chaining value cv (8, C).  Returns (8, C) int64
    digests (LE words)."""
    n_cols = cv.shape[1]
    n_blocks = 1 if rem + 3 <= BLOCK_WORDS else 2  # the pad word and 2 length words
    be = torch.zeros((BLOCK_WORDS * n_blocks, n_cols), dtype=torch.int64, device=cv.device)
    if carry is not None:
        be[:rem] = _bswap32(_u32(carry[:rem]))
    be[rem] = 0x80000000
    bits = total_words * 32
    be[-2] = bits >> 32
    be[-1] = bits & _MASK
    h = _u32(cv)
    for b in range(n_blocks):
        h = _compress(h, be[16 * b : 16 * b + 16])
    return _bswap32(h)


def merkle_parent_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """parent = sha256(left_digest_bytes || right_digest_bytes), (8, n) each,
    on any device; returns (8, n) int64."""
    n = left.shape[1]
    h = _compress(_h0(n, left.device), _bswap32(torch.cat([_u32(left), _u32(right)], dim=0)))
    # second block: padding and the length of the 512-bit message
    pad = torch.zeros((16, n), dtype=torch.int64, device=left.device)
    pad[0] = 0x80000000
    pad[15] = 512
    return _bswap32(_compress(h, pad))


def merkle_layer_plain(digests: torch.Tensor) -> torch.Tensor:
    """One Merkle layer over digest pairs: (8, n) with n even -> (8, n // 2)."""
    return merkle_parent_plain(digests[:, 0::2], digests[:, 1::2])


def merkle_tree_plain(leaves: torch.Tensor, n_cols_np2: int) -> torch.Tensor:
    """merkle_tree layer by layer through merkle_layer_plain, on any device."""
    return merkle.tree_by_layers(leaves, n_cols_np2, merkle_layer_plain)


def merkle_walk_plain(digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """merkle_walk level by level through merkle_parent_plain, on any device."""
    return merkle.walk_by_parents(_u32(digs), _u32(uniq_sibs), inv, idx, merkle_parent_plain)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


COLS_KERNELS = {"few": LaunchCount(), "wide": LaunchCount()}


def cols_route(n_cols: int) -> str:
    """The kernel sha256_cols launches over n_cols columns: "few" (a
    column's chain of compressions is the limit; the round warp runs them
    with the schedule done beside it) up to FEW_COLS_MAX, else "wide" (the
    card's integer pipes are the limit)."""
    return "few" if n_cols <= FEW_COLS_MAX else "wide"


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lcpc_sha256_cols.argtypes = [p, i, ll, ll, i, p, i, p, i, ll, p, i, i, p]
    lib.lcpc_sha256_merkle_tree.argtypes = [p, ll, i, ll, p, p, i, p]
    lib.lcpc_sha256_merkle_walk.argtypes = [p, ll, ll, p, ll, ll, p, p, i, i, p, p, p, i, p]
    for fn in (lib.lcpc_sha256_cols, lib.lcpc_sha256_merkle_tree, lib.lcpc_sha256_merkle_walk):
        fn.restype = ctypes.c_int


def sha256_cols(words: torch.Tensor, *, cv=None, carry=None, carry_len: int = PREFIX_WORDS,
                total_words: "int | None" = None, _route: "str | None" = None):
    """SHA-256 over every column's stream: carry[:carry_len] ((16, C) int32,
    zeros when carry is None: the 8-word prefix), then words (L, C), u32
    values as int32 storage or int64; the state is cv ((8, C) int32, the
    initial hash value when None).

    total_words None, an update: hashes the stream's whole 64-byte blocks,
    writes the new chaining value into cv and the rest of the stream
    (fewer than 16 words) into carry[:rem], in place (both required), and
    returns rem.  total_words given, a finish: ends the message of
    total_words words (the prefix and every earlier update's words
    included) with its padding and returns the (8, C) int64 digests.

    CUDA tensors launch one of csrc/sha256_cols.cu's two kernels once, the
    one `cols_route` picks (`_route` forces one, for tests and
    chip_smoke.py; counted in sha256_cols.launches and in
    COLS_KERNELS[kernel].launches), or raise; CPU tensors run
    sha256_update_plain and sha256_finalize_plain."""
    finish = total_words is not None
    _check_words("sha256_cols words", words, (torch.int32, torch.int64))
    if words.dim() != 2:
        raise ValueError(f"sha256_cols: words must be (L, C), got {tuple(words.shape)}")
    n_cols = words.shape[1]
    for name, t, rows in (("cv", cv, 8), ("carry", carry, BLOCK_WORDS)):
        if t is not None:
            _check_words(f"sha256_cols {name}", t, (torch.int32,))
            if t.shape != (rows, n_cols) or not t.is_contiguous():
                raise ValueError(f"sha256_cols: {name} must be contiguous ({rows}, {n_cols}), "
                                 f"got {tuple(t.shape)}")
    if (not 0 <= carry_len <= BLOCK_WORDS or (not finish and (cv is None or carry is None))
            or (finish and total_words < carry_len + words.shape[0])
            or _route not in (None, *COLS_KERNELS)):
        raise ValueError(f"sha256_cols: carry_len 0 .. 16, an update needs cv and carry, a "
                         f"finish total_words >= carry_len + L, a kernel of {list(COLS_KERNELS)}; "
                         f"got words {tuple(words.shape)}, carry_len {carry_len}, total_words "
                         f"{total_words}, _route {_route}")
    if _plain_here("sha256_cols", words, cv, carry):
        h, new_carry, rem = sha256_update_plain(
            _h0(n_cols, words.device) if cv is None else cv, carry, carry_len, words)
        if finish:
            return sha256_finalize_plain(h, new_carry, rem, total_words)
        cv.copy_(h.to(torch.int32))
        carry.copy_(new_carry.to(torch.int32))
        return rem
    out = torch.empty((8, n_cols), dtype=torch.int64, device=words.device) if finish else None
    rem = (carry_len + words.shape[0]) % BLOCK_WORDS
    if n_cols == 0:
        return out if finish else rem
    if words.stride(1) != 1 or (words.shape[0] > 1 and words.stride(0) < n_cols):
        words = words.contiguous()
    kernel = cols_route(n_cols) if _route is None else _route
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(words)
    _check_launch("sha256_cols", lib.lcpc_sha256_cols(
        words.data_ptr() if words.numel() else None, int(words.dtype == torch.int64),
        words.stride(0), words.shape[0], n_cols, None if carry is None else carry.data_ptr(),
        carry_len, None if cv is None else cv.data_ptr(), int(finish), total_words or 0,
        None if out is None else out.data_ptr(), int(kernel == "few"), dev, stream))
    sha256_cols.launches += 1
    COLS_KERNELS[kernel].launches += 1
    return out if finish else rem


launch_count.counted(sha256_cols)


def hash_word_columns(words: torch.Tensor) -> torch.Tensor:
    """Hash each column of a word matrix behind a 32-zero-byte prefix.

    words: (L, C) u32 words, int32 storage (as encode_rows_words returns
    them) or int64 values — the message of column c is 8 zero words followed
    by words[:, c] (lib.rs:706-745).  Returns (8, C) int64 digests (LE
    words).  CUDA tensors: one sha256_cols launch; CPU tensors:
    hash_word_columns_plain."""
    _check_words("hash_word_columns words", words, (torch.int32, torch.int64))
    if words.dim() != 2:
        raise ValueError(f"hash_word_columns: words must be (L, C), got {tuple(words.shape)}")
    if _plain_here("hash_word_columns", words):
        return hash_word_columns_plain(words)
    return sha256_cols(words, total_words=PREFIX_WORDS + words.shape[0])


def merkle_tree(leaves: torch.Tensor, n_cols_np2: int) -> torch.Tensor:
    """The commitment's Merkle array: column digests (8, n_cols) int64,
    zero digests padding them to n_cols_np2 leaves (a power of two), then
    every layer up to the root, flattened leaves first: (8, 2 n_cols_np2 - 1)
    int64 (lib.rs:665-704).

    CUDA tensors launch csrc/sha256_cols.cu's merkle_tree once (counted in
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
    _check_launch("merkle_tree", lib.lcpc_sha256_merkle_tree(
        leaves.data_ptr(), leaves.stride(0), leaves.shape[1], n_cols_np2, out.data_ptr(),
        _tree_counter(leaves.device, dev, stream).data_ptr(), dev, stream))
    merkle_tree.launches += 1
    return out


launch_count.counted(merkle_tree)


def merkle_walk(digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                idx: torch.Tensor, *, root=None, flag=None):
    """The verifier's Merkle path walk (lib.rs:955-982), SHA-256 parents:
    from the opened columns' digests digs (8, k), level l's sibling of
    column j is uniq_sibs[:, inv[l, j]] (uniq_sibs (8, U), inv (L, k), every
    entry < U), on the left when bit l of idx[j] is set (idx (k,), the
    columns' indices).  All int64; returns the (8, k) int64 roots the paths
    reach, or, given the commitment's root (8,), clears flag ((1,) int32, a
    view of the verifier's state) where one differs and returns None.

    CUDA tensors launch csrc/sha256_cols.cu's walk once (a round warp and a
    schedule warp for 32 columns; counted in merkle_walk.launches) or raise;
    CPU tensors run merkle_walk_plain."""
    return _walk("merkle_walk", lambda: cuda_build.load(_NAME, _bind).lcpc_sha256_merkle_walk,
                 merkle_walk_plain, merkle_walk, digs, uniq_sibs, inv, idx, root, flag)


launch_count.counted(merkle_walk)


def digest_host(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
