"""The port's SHA-256 (ops/sha256.py): the vectorized torch column hash and
Merkle layer against hashlib and against lcpc_tpu's device hash
(ops/sha256_jax.py), on ragged column counts and several block counts, and
the digest registry."""

import hashlib

import numpy as np
import pytest
import torch

from lcpc_tpu.ops import sha256_jax
from lcpc_tpu_torch.ops import digest, sha256
from lcpc_tpu_torch.ops.blake3 import digests_to_bytes


def _words(n_words, n_cols, seed):
    w = np.random.default_rng(seed).integers(0, 1 << 32, (n_words, n_cols), dtype=np.uint64)
    w = w.astype(np.uint32)
    w[0, 0] = 0xFFFFFFFF  # every byte set
    return w


# one block (1, 7 words), the padding's block boundary (5 + 8 = 13 words
# leave exactly 3 for 0x80 and the length), two blocks (8, 56), many blocks
# (600 words: a 2^23 Ligero column's 2056 words run the same loop longer)
@pytest.mark.parametrize("n_words,n_cols", [(1, 3), (7, 5), (5, 2), (8, 4), (56, 130),
                                            (120, 7), (600, 3)])
def test_columns_vs_hashlib(n_words, n_cols):
    words = _words(n_words, n_cols, seed=n_words)
    got = digests_to_bytes(sha256.hash_word_columns(torch.from_numpy(words.astype(np.int64))))
    for c in range(n_cols):
        want = hashlib.sha256(bytes(32) + words[:, c].astype("<u4").tobytes()).digest()
        assert bytes(got[c]) == want, (n_words, c)


@pytest.mark.parametrize("n_words,n_cols", [(56, 130), (120, 7)])
def test_columns_match_reference(n_words, n_cols):
    words = _words(n_words, n_cols, seed=7 * n_words)
    ours = sha256.hash_word_columns(torch.from_numpy(words.astype(np.int64))).numpy()
    assert np.array_equal(ours, np.asarray(sha256_jax.hash_word_columns(words)))


def test_merkle_layer_vs_hashlib_and_reference():
    digs = _words(8, 6, seed=43)
    out = sha256.merkle_layer(torch.from_numpy(digs.astype(np.int64)))
    assert np.array_equal(out.numpy(), np.asarray(sha256_jax.merkle_layer(digs)))
    lb, ob = digests_to_bytes(digs), digests_to_bytes(out)
    for i in range(3):
        assert bytes(ob[i]) == hashlib.sha256(bytes(lb[2 * i]) + bytes(lb[2 * i + 1])).digest()


def test_merkle_parent_of_one_pair():
    left, right = _words(8, 1, seed=1), _words(8, 1, seed=2)
    got = sha256.merkle_parent(torch.from_numpy(left.astype(np.int64)),
                               torch.from_numpy(right.astype(np.int64)))
    want = hashlib.sha256(left.astype("<u4").tobytes() + right.astype("<u4").tobytes())
    assert bytes(digests_to_bytes(got)[0]) == want.digest()


def test_digest_registry():
    assert digest.DIGESTS_BY_NAME["blake3"] is digest.BLAKE3
    assert digest.DIGESTS_BY_NAME["sha256"] is digest.SHA256
    assert digest.SHA256.host(b"abc") == hashlib.sha256(b"abc").digest()
    assert digest.BLAKE3.host(b"abc") != digest.SHA256.host(b"abc")
    assert digest.SHA256.merkle_layer is sha256.merkle_layer
