"""The port's BLAKE3: published vectors (pinned in tests/test_blake3.py), the
kernels' plain versions (chunk-parallel column hash, chunk tree, Merkle
tree, parent nodes), the sequential plain twin, the CV-stack order and the
streaming carry against the host hash, and equality with lcpc_tpu's device
hash and Merkle layers.  Tolerance 0: exact hashing."""

import numpy as np
import pytest
import torch

from lcpc_tpu.ops import blake3_jax
from lcpc_tpu_torch.core.streaming import StreamingColumnHasher
from lcpc_tpu_torch.ops import blake3 as b3
from lcpc_tpu_torch.ops import merkle
from lcpc_tpu_torch.ops.blake3 import (
    blake3,
    bytes_to_digests,
    digests_to_bytes,
    hash_word_columns,
)

torch.set_num_threads(1)  # the xdist workers share the cores


def test_known_vectors():
    assert (
        blake3(b"").hex()
        == "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
    )
    assert (
        blake3(b"abc").hex()
        == "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85"
    )


def _host_digests(words):
    return [blake3(bytes(32) + words[:, c].astype("<u4").tobytes())
            for c in range(words.shape[1])]


# sub-block, block boundary, multi-block, multi-chunk, odd chunk counts (the
# tree merge with promotion), and 504 + 8 = two whole chunks
@pytest.mark.parametrize("fn", [hash_word_columns, b3.hash_word_columns_plain,
                                b3.hash_word_columns_sequential],
                         ids=["wrappers", "plain", "sequential"])
@pytest.mark.parametrize("n_words", [1, 8, 248, 504, 760, 2040])
def test_columns_vs_host(n_words, fn):
    words = np.random.default_rng(n_words).integers(
        0, 2**32, size=(n_words, 3), dtype=np.uint32)
    got = digests_to_bytes(fn(torch.from_numpy(words.astype(np.int64))))
    for c, want in enumerate(_host_digests(words)):
        assert bytes(got[c]) == want, (n_words, c)


def test_columns_match_reference():
    words = np.random.default_rng(0).integers(0, 2**32, size=(296, 6), dtype=np.uint32)
    ours = hash_word_columns(torch.from_numpy(words.astype(np.int64))).numpy()
    assert np.array_equal(ours, np.asarray(blake3_jax.hash_word_columns(words)))


@pytest.mark.parametrize("n_words", [8, 760])
def test_int32_storage_words(n_words):
    # words with the top bit set are negative as int32 storage (the layout
    # encode_rows_words returns): both entry points read their u32 bits
    words = np.random.default_rng(7).integers(2**31, 2**32, size=(n_words, 4), dtype=np.uint32)
    as_i32 = torch.from_numpy(words.view(np.int32))
    assert (as_i32 < 0).all()
    got = hash_word_columns(as_i32)
    assert got.dtype == torch.int64
    assert torch.equal(got, hash_word_columns(torch.from_numpy(words.astype(np.int64))))
    assert torch.equal(got, b3.hash_word_columns_sequential(as_i32))
    assert [bytes(d) for d in digests_to_bytes(got)] == _host_digests(words)


# (update lengths, in words): carries of 0, 8 and 255 words between
# updates, blocks shorter than a chunk, and streams whose last update leaves
# exactly one whole final chunk (held back for finalize)
_SPLITS = [(248, 256, 256), (256, 256, 256), (247, 257), (500, 4, 3), (504,), (1, 1, 502),
           (120, 136, 248), (1000, 528)]


@pytest.mark.parametrize("lens", _SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_streaming_updates_equal_one_shot(lens):
    words = np.random.default_rng(sum(lens)).integers(
        0, 2**32, size=(sum(lens), 5), dtype=np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    h = StreamingColumnHasher(5, 8 + t.shape[0], "cpu")
    carries, r0 = [], 0
    for n in lens:
        h.update(t[r0 : r0 + n])
        carries.append(h.buf_len)
        r0 += n
    got = h.finalize()
    assert torch.equal(got, hash_word_columns(t))
    assert [bytes(d) for d in digests_to_bytes(got)] == _host_digests(words)
    assert 0 < carries[-1] <= 256


def test_chunks_plain_carry_and_counter():
    # chunks 3 and 4 of a stream, fed as a 40-word carry and the words
    # after it, equal the same chunks of the one-shot stream
    words = np.random.default_rng(3).integers(0, 2**32, size=(1300, 2), dtype=np.uint32)
    t = torch.from_numpy(words.astype(np.int64))
    stream = torch.cat([torch.zeros((8, 2), dtype=torch.int64), t])  # the 8-word prefix
    whole = b3.blake3_chunks_plain(stream, None, 0, 0, 6, final_len=1308 - 5 * 256)
    carry = stream[768:808]
    part = b3.blake3_chunks_plain(stream[808:], carry, 40, 3, 2)
    assert torch.equal(part, whole[3:5])
    out = torch.empty((2, 8, 2), dtype=torch.int32)
    b3.blake3_chunks(stream[808:], out, carry=carry.to(torch.int32), carry_len=40,
                     chunk_base=3)
    assert torch.equal(b3._u32(out), whole[3:5])
    assert b3.blake3_chunks.launches == 0 and b3.merge_chunk_cvs.launches == 0


def test_parents_plain_promotes_odd_node():
    cvs = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2**32, size=(5, 8, 3), dtype=np.uint32).astype(np.int64))
    out = b3.blake3_parents_plain(cvs[0::2], cvs[1::2], 2, b3.PARENT)
    assert out.shape == (3, 8, 3) and torch.equal(out[2], cvs[4])
    for i in range(2):
        for c in range(3):
            want = b3.compress(list(b3.IV), cvs[2 * i, :, c].tolist() + cvs[2 * i + 1, :, c]
                               .tolist(), 0, 64, b3.PARENT)[:8]
            assert out[i, :, c].tolist() == want


def test_wrappers_refuse_other_devices():
    # no fallback: a tensor on a device without the kernel raises
    words = torch.zeros((16, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        b3.blake3_chunks(words, torch.empty((1, 8, 2), dtype=torch.int32, device="meta"),
                         final_len=24)
    meta = dict(dtype=torch.int64, device="meta")
    digs = torch.zeros((8, 3), **meta)
    for call in (lambda: b3.merge_chunk_cvs(torch.zeros((3, 8, 2), **meta)),
                 lambda: b3.merkle_tree(digs, 4),
                 lambda: b3.merkle_walk(digs, digs, torch.zeros((2, 3), **meta),
                                        torch.zeros(3, **meta))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(TypeError):
        hash_word_columns(torch.zeros((16, 2), dtype=torch.float32))


def test_wrappers_refuse_mixed_devices():
    # every operand on one device: no host run over a device buffer
    words = torch.zeros((16, 2), dtype=torch.int32)
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        b3.blake3_chunks(words, torch.empty((1, 8, 2), **meta), final_len=24)
    with pytest.raises(ValueError, match="different devices"):
        b3.blake3_chunks(words, torch.empty((1, 8, 2), dtype=torch.int32),
                         carry=torch.zeros((8, 2), **meta), final_len=24)
    digs = torch.zeros((8, 3), dtype=torch.int64)
    inv, idx = torch.zeros((2, 3), dtype=torch.int64), torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="different devices"):
        b3.merkle_walk(digs, digs, inv, idx.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        b3.merkle_walk(digs, digs.to("meta"), inv, idx)


def test_tree_wrappers_refuse_wrong_types_and_shapes():
    digs = torch.zeros((8, 3), dtype=torch.int64)
    inv, idx = torch.zeros((2, 3), dtype=torch.int64), torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        b3.merge_chunk_cvs(torch.zeros((3, 8, 2), dtype=torch.float32))
    with pytest.raises(ValueError):
        b3.merge_chunk_cvs(torch.zeros((1, 8, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        b3.merkle_tree(digs.to(torch.int32), 4)
    with pytest.raises(ValueError):
        b3.merkle_tree(digs, 2)  # fewer leaves than digests
    with pytest.raises(ValueError):
        b3.merkle_tree(digs, 6)  # not a power of two
    with pytest.raises(TypeError):
        b3.merkle_walk(digs, digs, inv.to(torch.int32), idx)
    with pytest.raises(ValueError):
        b3.merkle_walk(digs, digs, inv[:, :2], idx)


def _walk_layer(digests):
    """One Merkle layer through the walk wrapper: one level, every sibling
    on the right."""
    n = digests.shape[1] // 2
    return b3.merkle_walk(digests[:, 0::2], digests[:, 1::2], torch.arange(n)[None],
                          torch.zeros(n, dtype=torch.int64))


@pytest.mark.parametrize("fn", [_walk_layer, b3.merkle_layer_plain], ids=["wrapper", "plain"])
def test_merkle_layer_vs_host_and_roundtrip(fn):
    leaves = np.random.default_rng(1).integers(0, 2**32, size=(8, 6), dtype=np.uint32)
    out = fn(torch.from_numpy(leaves.astype(np.int64)))
    lb, ob = digests_to_bytes(leaves), digests_to_bytes(out)
    for i in range(3):
        assert bytes(ob[i]) == blake3(bytes(lb[2 * i]) + bytes(lb[2 * i + 1]))
    assert np.array_equal(bytes_to_digests(lb), leaves)


def _host_chunk_tree(cvs, lo, hi, flags):
    """BLAKE3's chunk tree over host CVs cvs[lo:hi], by its definition: the
    left subtree takes the largest power of two of chunks below hi - lo."""
    if hi - lo == 1:
        return cvs[lo]
    mid = lo + b3._left_len(hi - lo)
    return b3.compress(list(b3.IV), _host_chunk_tree(cvs, lo, mid, b3.PARENT)
                       + _host_chunk_tree(cvs, mid, hi, b3.PARENT), 0, 64, flags)[:8]


def test_chunk_tree_stack_order():
    # the thread-per-column kernel's CV stack, the level order and the warp
    # kernel's pairing with promotion, and the definition: one tree, for
    # every count of 2 .. 70 CVs
    for n in range(2, 71):
        cvs = np.random.default_rng(n).integers(0, 2**32, size=(n, 8, 2), dtype=np.uint32)
        t = torch.from_numpy(cvs.view(np.int32))
        stack = b3.merge_chunk_cvs_stack_plain(t)
        assert stack.dtype == torch.int64
        assert torch.equal(stack, b3.merge_chunk_cvs_plain(t)), n
        assert torch.equal(stack, b3.merge_chunk_cvs(torch.from_numpy(cvs.astype(np.int64)))), n
        want = _host_chunk_tree([cvs[i, :, 1].tolist() for i in range(n)], 0, n,
                                b3.PARENT | b3.ROOT)
        assert stack[:, 1].tolist() == want, n


@pytest.mark.parametrize("n_cols,np2", [(1, 1), (5, 8), (64, 64)])
def test_merkle_tree_vs_reference_layers(n_cols, np2):
    leaves = np.random.default_rng(n_cols).integers(0, 2**32, size=(8, n_cols),
                                                    dtype=np.uint32)
    got = b3.merkle_tree(torch.from_numpy(leaves.astype(np.int64)), np2)
    assert got.shape == (8, 2 * np2 - 1) and got.dtype == torch.int64
    # lcpc_tpu's commit: zero digests pad the leaves, then merkle_layer
    # until one node is left, concatenated leaves first (protocol.py:322-333)
    layers = [np.pad(leaves, ((0, 0), (0, np2 - n_cols)))]
    while layers[-1].shape[1] > 1:
        layers.append(np.asarray(blake3_jax.merkle_layer(layers[-1])))
    assert np.array_equal(got.numpy(), np.concatenate([np.asarray(x) for x in layers], axis=1))
    assert not got[:, n_cols:np2].any()
    # the port's composition before the one-launch tree: pad, layer loop, cat
    assert torch.equal(got, merkle.tree_by_layers(torch.from_numpy(leaves.astype(np.int64)),
                                                  np2, b3.merkle_layer_plain))
    if np2 > 1:
        nodes = digests_to_bytes(got)
        assert bytes(nodes[-1]) == blake3(bytes(nodes[-3]) + bytes(nodes[-2]))

