"""The port's BLAKE3: published vectors (pinned in tests/test_blake3.py), the
vectorized torch column hash and Merkle layer against the host hash, and
equality with lcpc_tpu's device hash."""

import numpy as np
import pytest
import torch

from lcpc_tpu.ops import blake3_jax
from lcpc_tpu_torch.ops.blake3 import (
    blake3,
    bytes_to_digests,
    digests_to_bytes,
    hash_word_columns,
    merkle_layer,
)


def test_known_vectors():
    assert (
        blake3(b"").hex()
        == "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
    )
    assert (
        blake3(b"abc").hex()
        == "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85"
    )


# sub-block, block boundary, multi-block, multi-chunk, odd chunk counts (the
# tree merge with promotion)
@pytest.mark.parametrize("n_words", [1, 8, 248, 760, 2040])
def test_columns_vs_host(n_words):
    words = np.random.default_rng(n_words).integers(
        0, 2**32, size=(n_words, 3), dtype=np.uint32)
    got = digests_to_bytes(hash_word_columns(torch.from_numpy(words.astype(np.int64))))
    for c in range(3):
        want = blake3(bytes(32) + words[:, c].astype("<u4").tobytes())
        assert bytes(got[c]) == want, (n_words, c)


def test_columns_match_reference():
    words = np.random.default_rng(0).integers(0, 2**32, size=(296, 6), dtype=np.uint32)
    ours = hash_word_columns(torch.from_numpy(words.astype(np.int64))).numpy()
    assert np.array_equal(ours, np.asarray(blake3_jax.hash_word_columns(words)))


def test_merkle_layer_vs_host_and_roundtrip():
    leaves = np.random.default_rng(1).integers(0, 2**32, size=(8, 6), dtype=np.uint32)
    out = merkle_layer(torch.from_numpy(leaves.astype(np.int64)))
    lb, ob = digests_to_bytes(leaves), digests_to_bytes(out)
    for i in range(3):
        assert bytes(ob[i]) == blake3(bytes(lb[2 * i]) + bytes(lb[2 * i + 1]))
    assert np.array_equal(bytes_to_digests(lb), leaves)
