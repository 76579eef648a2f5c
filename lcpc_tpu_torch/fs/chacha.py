"""rand_chacha 0.3-compatible ChaCha20 RNG (host, numpy-vectorized blocks).

Replicates the exact output stream of `rand_chacha::ChaCha20Rng` as used by
the reference for Fiat-Shamir expansion (lcpc-2d/src/lib.rs:870-877,903-911,
1073-1080) and expander-matrix generation (lcpc-brakedown-pc/src/matgen.rs:43-44):

- state layout: constants | key(8 words) | 64-bit block counter (words 12-13)
  | 64-bit stream aka nonce (words 14-15), all little-endian u32;
- rand_core 0.6 `BlockRng` semantics: results buffer of 64 u32 words
  (4 ChaCha blocks per refill), `next_u64` = (hi << 32) | lo from two
  consecutive words with the documented edge-case handling;
- `seed_from_u64` uses rand_core 0.6's PCG32-based seed expansion;
- `set_stream` changes the nonce and recomputes any partially-consumed buffer
  at the same block position.

Validated against `cryptography`'s ChaCha20 (RFC layout) in tests/test_fs.py.
"""

from __future__ import annotations

import numpy as np

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)

_BUF_WORDS = 64  # rand_core BlockRng buffer: 4 ChaCha blocks


def _rotl32(x: np.ndarray, n: int) -> np.ndarray:
    return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))).astype(np.uint32)


def chacha20_blocks(key_words: np.ndarray, counter0: int, nonce_words: np.ndarray,
                    n_blocks: int) -> np.ndarray:
    """Generate `n_blocks` consecutive ChaCha20 keystream blocks.

    Returns shape (n_blocks, 16) uint32 (words in output order).  Counter is
    64-bit over words 12-13 (rand_chacha layout), wrapping mod 2^64.
    """
    ctrs = (counter0 + np.arange(n_blocks, dtype=np.uint64)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    state = np.empty((16, n_blocks), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = key_words[:, None]
    state[12] = (ctrs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[13] = (ctrs >> np.uint64(32)).astype(np.uint32)
    state[14] = nonce_words[0]
    state[15] = nonce_words[1]

    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(10):  # 20 rounds = 10 double rounds
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    x += state
    return x.T.copy()  # (n_blocks, 16)


class ChaCha20Rng:
    """Drop-in replica of rand_chacha::ChaCha20Rng's output stream."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        self.nonce = np.zeros(2, dtype=np.uint32)
        self.counter = 0  # block counter of the NEXT refill
        self.buf = np.empty(0, dtype=np.uint32)
        self.index = 0  # consumed words within buf

    # -- construction ----------------------------------------------------------
    @classmethod
    def seed_from_u64(cls, state: int) -> "ChaCha20Rng":
        """rand_core 0.6 SeedableRng::seed_from_u64 (PCG32 expansion)."""
        mul = 6364136223846793005
        inc = 11634580027462260723
        mask64 = (1 << 64) - 1
        seed = bytearray()
        for _ in range(8):
            state = (state * mul + inc) & mask64
            xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
            rot = state >> 59
            x = ((xorshifted >> rot) | (xorshifted << (32 - rot & 31))) & 0xFFFFFFFF
            # rotate_right(rot): for rot == 0 the above would mangle; handle exactly
            if rot == 0:
                x = xorshifted
            seed += x.to_bytes(4, "little")
        return cls(bytes(seed))

    def set_stream(self, stream: int) -> None:
        self.nonce = np.array(
            [stream & 0xFFFFFFFF, (stream >> 32) & 0xFFFFFFFF], dtype=np.uint32
        )
        if self.index < len(self.buf):
            # recompute the partially-consumed buffer with the new stream,
            # preserving the word position (rand_chacha set_stream semantics)
            gen_counter = self.counter - len(self.buf) // 16
            blocks = chacha20_blocks(self.key, gen_counter, self.nonce, len(self.buf) // 16)
            self.buf = blocks.reshape(-1)

    # -- BlockRng --------------------------------------------------------------
    def _refill(self, n_words: int = _BUF_WORDS) -> None:
        n_blocks = n_words // 16
        blocks = chacha20_blocks(self.key, self.counter, self.nonce, n_blocks)
        self.counter = (self.counter + n_blocks) & ((1 << 64) - 1)
        self.buf = blocks.reshape(-1)
        self.index = 0

    def next_u64(self) -> int:
        length = len(self.buf)
        if self.index < length - 1:
            lo = int(self.buf[self.index])
            hi = int(self.buf[self.index + 1])
            self.index += 2
        elif self.index >= length:
            self._refill()
            lo = int(self.buf[0])
            hi = int(self.buf[1])
            self.index = 2
        else:  # exactly one word left
            lo = int(self.buf[self.index])
            self._refill()
            hi = int(self.buf[0])
            self.index = 1
        return (hi << 32) | lo

    def next_u64_array(self, n: int) -> np.ndarray:
        """Bulk-draw n u64s (same stream as n calls to next_u64).

        Requires the current index to be even (always true when the RNG has
        only ever been consumed via next_u64, as in the reference protocol).
        """
        assert self.index % 2 == 0, "bulk draw requires word-pair alignment"
        need_words = 2 * n
        parts = []
        avail = len(self.buf) - self.index
        take = min(avail, need_words)
        if take:
            parts.append(self.buf[self.index : self.index + take])
            self.index += take
            need_words -= take
        if need_words:
            # generate the bulk directly in 64-word multiples
            gen_words = (need_words + _BUF_WORDS - 1) // _BUF_WORDS * _BUF_WORDS
            self._refill(gen_words)
            parts.append(self.buf[:need_words])
            self.index = need_words
        words = np.concatenate(parts) if len(parts) > 1 else parts[0]
        words = words.astype(np.uint64)
        return words[0::2] | (words[1::2] << np.uint64(32))

    def rewind_u64(self, n: int) -> None:
        """Step the stream back by n u64 draws (used after bulk over-draws).

        Only rewinds within the current buffer plus past full blocks: if the
        target position predates the buffer, the needed blocks are recomputed
        from the block counter (ChaCha blocks are pure functions of
        key/counter/nonce, so this is exact).
        """
        back = 2 * n
        if back <= self.index:
            self.index -= back
            return
        # absolute word position of buf[0] within the stream
        buf_blocks = len(self.buf) // 16
        start_block = self.counter - buf_blocks
        abs_pos = start_block * 16 + self.index - back
        assert abs_pos >= 0
        new_block = abs_pos // 16
        blocks = chacha20_blocks(self.key, new_block, self.nonce, max(buf_blocks, 1))
        self.counter = (new_block + max(buf_blocks, 1)) & ((1 << 64) - 1)
        self.buf = blocks.reshape(-1)
        self.index = abs_pos - new_block * 16
