"""SHA-256: vectorized torch column hashing and Merkle layers, the second
digest behind the generic hash interface (the reference is generic over
`D: Digest`, lcpc-2d/src/lib.rs:34-58).  Port of lcpc_tpu/ops/sha256_jax.py.

Columns are independent streams, so every 64-byte block compression runs as
32-bit add/xor/rotate tensor ops vectorized over the column axis, block
after block.  Words are u32 values held in int64 tensors (adds masked with
0xFFFFFFFF), as in ops/blake3.py.  SHA-256 reads big-endian words, so the
little-endian column words are byte-swapped first and the digest words
swapped back: a digest is (8, C) LE words of the big-endian digest bytes,
the convention the rest of the pipeline uses.
"""

from __future__ import annotations

import hashlib

import torch

from . import merkle

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

_MASK = 0xFFFFFFFF


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


def hash_word_columns(words: torch.Tensor, prefix_words: int = 8) -> torch.Tensor:
    """SHA-256 of each column of an LE word matrix behind a zero prefix.

    words: (L, C) u32 words, int32 storage or int64 values; the message of
    column c is `prefix_words` zero words, then words[:, c]
    (lib.rs:706-745).  Returns (8, C) int64 digests in LE words."""
    words = words.to(torch.int64) & _MASK
    total = prefix_words + words.shape[0]
    n_cols = words.shape[1]
    # padding in whole words (the message is word-aligned): 0x80000000, zero
    # words, then the 64-bit big-endian bit length
    n_blocks = (total + 3 + 15) // 16
    be = words.new_zeros((n_blocks * 16, n_cols))
    be[prefix_words:total] = _bswap32(words)
    be[total] = 0x80000000
    bits = total * 32
    be[-2] = bits >> 32
    be[-1] = bits & _MASK
    h = _h0(n_cols, words.device)
    for k in range(n_blocks):
        h = _compress(h, be[16 * k : 16 * k + 16])
    return _bswap32(h)


def merkle_parent(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """parent = sha256(left_digest_bytes || right_digest_bytes), (8, n) each."""
    n = left.shape[1]
    h = _compress(_h0(n, left.device), _bswap32(torch.cat([left, right], dim=0)))
    # second block: padding and the length of the 512-bit message
    pad = left.new_zeros((16, n))
    pad[0] = 0x80000000
    pad[15] = 512
    return _bswap32(_compress(h, pad))


def merkle_layer(digests: torch.Tensor) -> torch.Tensor:
    """One Merkle layer over digest pairs: (8, n) with n even -> (8, n // 2)."""
    return merkle_parent(digests[:, 0::2], digests[:, 1::2])


def merkle_tree(leaves: torch.Tensor, n_cols_np2: int) -> torch.Tensor:
    """Leaves zero-padded to n_cols_np2, then every layer, leaves first:
    (8, 2 n_cols_np2 - 1) int64."""
    return merkle.tree_by_layers(leaves, n_cols_np2, merkle_layer)


def merkle_walk(digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """The verifier's path walk (ops/merkle.py: walk_by_parents)."""
    return merkle.walk_by_parents(digs, uniq_sibs, inv, idx, merkle_parent)


def digest_host(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
