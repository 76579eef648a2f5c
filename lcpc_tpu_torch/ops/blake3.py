"""BLAKE3: host reference and vectorized torch column hashing / Merkle layers.

Implements the reference's column-hash convention
(lcpc-2d/src/lib.rs:706-745): each column digest is
blake3(32 zero bytes || canonical LE repr of column elements, row-major down
the column), and Merkle nodes are blake3(left_digest || right_digest)
(lib.rs:762-785).

- `blake3(data)` is the plain host hash (32-byte output), the slow and
  obviously correct twin (port of lcpc_tpu/ops/blake3_ref.py).
- `hash_word_columns`, `merkle_layer`, `merkle_parent` run the compression
  vectorized over columns on any torch device (port of
  lcpc_tpu/ops/blake3_jax.py).  Words are u32 values held in int64 tensors:
  adds are masked with 0xFFFFFFFF and rotations are shift/or/mask in int64.
  One G step updates the four columns (or four diagonals) of the state at
  once, so a compression is ~100 tensor ops, not ~700.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

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

_MASK = 0xFFFFFFFF


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
# torch (vectorized over columns)
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
    counter/block_len/flags are ints or tensors broadcastable to the batch.
    Returns the 8-word output CV."""
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


def _iv(n_cols: int, device) -> torch.Tensor:
    return torch.tensor(IV, dtype=torch.int64, device=device)[:, None].expand(8, n_cols)


def hash_word_columns(words: torch.Tensor) -> torch.Tensor:
    """Hash each column of a word matrix behind a 32-zero-byte prefix.

    words: (L, C) u32 values (int64) — per-column message words (LE).  The
    message of column c is 8 zero words followed by words[:, c]
    (lib.rs:706-745).  Returns (8, C) int64 digests."""
    prefix_words = 8
    words = words.to(torch.int64)
    n_cols = words.shape[1]
    total = prefix_words + words.shape[0]
    n_blocks = max(1, (total + 15) // 16)
    n_chunks = max(1, (total + 255) // 256)
    last_len = (total % 16) * 4
    if last_len == 0:
        last_len = 64 if total > 0 else 0
    buf = words.new_zeros((n_blocks * 16, n_cols))
    buf[prefix_words:total] = words

    cvs = []
    for ci in range(n_chunks):
        cv = _iv(n_cols, words.device)
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
        out = _compress_t(_iv(n_cols, words.device)[:, None].expand(8, pairs, n_cols),
                          torch.cat([left, right], dim=0), 0, 64, flags)
        merged = list(out.unbind(dim=1))
        if len(cvs) % 2:
            merged.append(cvs[-1])
        cvs = merged
    return cvs[0]


def merkle_parent(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """parent = blake3(left_digest_bytes || right_digest_bytes), (8, n) each."""
    return _compress_t(_iv(left.shape[1], left.device),
                       torch.cat([left, right], dim=0), 0, 64,
                       CHUNK_START | CHUNK_END | ROOT)


def merkle_layer(digests: torch.Tensor) -> torch.Tensor:
    """One Merkle layer: (8, n) with n even -> (8, n // 2)."""
    return merkle_parent(digests[:, 0::2], digests[:, 1::2])


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
