"""The port's BLAKE3: published vectors (pinned in tests/test_blake3.py), the
kernels' plain versions (chunk-parallel column hash, chunk tree, Merkle
tree, parent nodes, the few-column route), the sequential plain twin, the
CV-stack order and the streaming carry against the host hash, equality with
lcpc_tpu's device hash and Merkle layers, and a model of the few-column
kernel's grid.  Tolerance 0: exact hashing."""

import os
import re

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
    # the few route's plain version (verify's columns) against lcpc_tpu at
    # one chunk with ROOT (248 + 8 words) and nine chunks (more than a
    # block's FEW_WARPS, a last chunk of 8 words), against the host hash at
    # two chunks, two whole chunks and eight whole chunks; on CPU tensors
    # hash_word_columns (either route) runs the wide route's plain version
    for n_words in (248, 249, 504, 2040, 2048):
        words = np.random.default_rng(n_words).integers(0, 2**32, size=(n_words, 33),
                                                        dtype=np.uint32)
        t = torch.from_numpy(words.view(np.int32))
        few = b3.hash_word_columns_few_plain(t)
        if n_words in (248, 2048):
            assert np.array_equal(few.numpy(), np.asarray(blake3_jax.hash_word_columns(words)))
        else:
            assert [bytes(d) for d in digests_to_bytes(few)] == _host_digests(words), n_words
        assert torch.equal(hash_word_columns(t), few)
        assert torch.equal(hash_word_columns(t, _route="few"), few)

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
    # the walk kernel's parent in its quad layout (a lane a column of the
    # state, the diagonals rolled across the lanes) is the same node, on
    # random words, all-0xFFFFFFFF words and words with the top bit set
    rng = np.random.default_rng(5)
    top = rng.integers(0, 2**31, size=(16, 4), dtype=np.uint32) | np.uint32(1 << 31)
    for words in (rng.integers(0, 2**32, size=(16, 4), dtype=np.uint32),
                  np.full((16, 4), 0xFFFFFFFF, dtype=np.uint32), top):
        t = torch.from_numpy(words.astype(np.int64))
        quad = b3.merkle_parent_quad_plain(t[:8], t[8:])
        assert torch.equal(quad, b3.merkle_parent_plain(t[:8], t[8:]))
        got = digests_to_bytes(quad)
        for c in range(4):
            assert bytes(got[c]) == blake3(words[:, c].astype("<u4").tobytes())


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
    for route in ("few", "wide"):  # the column hash by either route: no host run of a card's words
        with pytest.raises(ValueError, match="unsupported device"):
            hash_word_columns(words, _route=route)


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
    # the column hash: u32 words as int32 or int64 only, (L, C) only, a
    # route of ROUTES only (one operand: no devices to mix)
    for bad in (torch.zeros((16, 2), dtype=torch.float64), torch.zeros((16, 2), dtype=torch.int16)):
        with pytest.raises(TypeError):
            hash_word_columns(bad, _route="few")
    for bad in (torch.zeros(16, dtype=torch.int32), torch.zeros((2, 16, 2), dtype=torch.int32)):
        with pytest.raises(ValueError):
            hash_word_columns(bad)
    with pytest.raises(ValueError):
        hash_word_columns(torch.zeros((16, 2), dtype=torch.int32), _route="narrow")
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



def _b3_tree(lo, hi, root):
    """BLAKE3's chunk tree over chunks [lo, hi) by its definition: the left
    subtree the largest power of two of chunks below hi - lo; (kind, ...,
    ROOT flag) nodes."""
    if hi - lo == 1:
        return ("C", lo, root)
    mid = lo + b3._left_len(hi - lo)
    return ("P", _b3_tree(lo, mid, False), _b3_tree(mid, hi, False), root)


def _few_merge(cv, m, root):
    """csrc/blake3_cols.cu's merge_warps over the nodes of warps 0 .. m-1:
    at level h, warp w (a multiple of 2h) takes the node warp w + h wrote
    at that level; ROOT on the last merge when root."""
    h = 1
    while h < m:
        slots = {w: cv[w] for w in range(m) if w & (2 * h - 1) == h}
        for w in range(m):
            if w & (2 * h - 1) == 0 and w + h < m:
                assert cv[w] is not None and slots[w + h] is not None
                cv[w] = ("P", cv[w], slots[w + h], root and 2 * h >= m)
        h *= 2
    return cv[0]


def _few_merge_nodes(nodes, n_warps):
    """csrc/blake3_cols.cu's merge_nodes: the last block's n >= 2 nodes,
    level by level in place, a pair a warp in rounds (each round's nodes
    read before it writes any), an odd last node promoted; ROOT on the last
    merge."""
    nodes, n = list(nodes), len(nodes)
    while n > 2:
        pairs = n // 2
        for base in range(0, pairs, n_warps):
            got = {i: ("P", nodes[2 * i], nodes[2 * i + 1], False)
                   for i in range(base, min(base + n_warps, pairs))}
            for i, node in got.items():
                nodes[i] = node
        if n % 2:
            nodes[pairs] = nodes[n - 1]
        n = (n + 1) // 2
    return ("P", nodes[0], nodes[1], True)


def _few_grid_model(n_cols, n_words, warps, stages, rng):
    """The few-column kernel's grid in numpy, blocks in a random order (they
    run in none), with lcpc_blake3_cols_few's sizes: each warp's ring of
    `stages` message blocks (block b read from stage b % stages after the
    wait for all but the newest stages - 1 groups: it must have landed and
    not been overwritten), each words row a column loaded once, each (column,
    chunk) CV written once before its merge, the blocks' subtrees through
    scratch and the counter, the last block's merge of them.  Returns (the
    digests' trees by column group, the counters after)."""
    total = 8 + n_words
    n_chunks = -(-total // 256)
    final_len = total - 256 * (n_chunks - 1)
    n_groups, n_warps, n_gx = -(-n_chunks // warps), min(n_chunks, warps), -(-n_cols // 32)
    reads = np.zeros((n_words, n_gx), dtype=np.int64)  # a column group's lanes read alike
    written = np.zeros((n_chunks, n_gx), dtype=np.int64)
    counters, scratch, out = np.zeros(n_gx, dtype=np.int64), {}, {}
    blocks = [(x, y) for x in range(n_gx) for y in range(n_groups)]
    for i in rng.permutation(len(blocks)):
        x, y = blocks[i]
        m = min(n_warps, n_chunks - y * warps)
        cv = [None] * n_warps
        for w in range(m):
            j = y * warps + w
            length = final_len if j == n_chunks - 1 else 256
            n_blocks = (length + 15) >> 4
            stage, groups = [None] * stages, []

            def issue(b):
                stage[b % stages] = b
                rows = 256 * j + 16 * b - 8 + np.arange(16)
                rows = rows[(16 * b + np.arange(16) < length) & (rows >= 0)]
                reads[rows, x] += 1
                groups.append([b])

            for b in range(stages - 1):
                issue(b) if b < n_blocks else groups.append([])
            for b in range(n_blocks):
                issue(b + stages - 1) if b + stages - 1 < n_blocks else groups.append([])
                landed = {blk for g in groups[: len(groups) - (stages - 1)] for blk in g}
                assert b in landed and stage[b % stages] == b, (j, b)
            written[j, x] += 1
            cv[w] = ("C", j, n_chunks == 1)
        node = _few_merge(cv, m, n_groups == 1)
        if n_groups > 1:
            scratch[(x, y)] = node
            counters[x] += 1
            if counters[x] < n_groups:
                continue
            node = _few_merge_nodes([scratch[(x, g)] for g in range(n_groups)], n_warps)
            counters[x] = 0
        assert x not in out
        out[x] = node
    assert (reads == 1).all() and (written == 1).all()
    return out, counters


def test_few_route():
    """The few-column route: cols_route's choice (verify's columns on it, the
    commits' off it); the plain version against the host hash at 17 chunks
    (an odd count: promotion, two blocks' runs); and a numpy model of the kernel's grid, its constants parsed from
    csrc/blake3_cols.cu: every words row read once, every (column, chunk)
    CV written once before its merge, the tree BLAKE3's with ROOT once at
    the top, the counters back at 0.  Update the model with the kernel's
    index arithmetic."""
    for n_cols in (1, 31, 32, 33, 189, 6_593, b3.FEW_COLS_MAX):
        assert b3.cols_route(n_cols) == "few"
    assert b3.cols_route(b3.FEW_COLS_MAX + 1) == "wide"
    assert b3.cols_route(16_384) == "wide"  # the smallest staged commit's columns
    assert b3.cols_route(189, b3.FEW_WORDS_MAX) == "few"
    assert b3.cols_route(189, b3.FEW_WORDS_MAX + 1) == "wide"
    words = np.random.default_rng(4104).integers(0, 2**32, size=(4104, 2), dtype=np.uint32)
    got = b3.hash_word_columns_few_plain(torch.from_numpy(words.view(np.int32)))
    assert [bytes(d) for d in digests_to_bytes(got)] == _host_digests(words)

    src = open(os.path.join(os.path.dirname(b3.__file__), os.pardir, "csrc",
                            "blake3_cols.cu")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    warps, stages = const["kFewWarps"], const["kFewStages"]
    assert warps == b3.FEW_WARPS and warps & (warps - 1) == 0  # aligned runs: one tree
    assert "constexpr int kFewRing = kFewStages * 16 * 32;" in src
    assert "constexpr int kFewSlot = 8 * 32;" in src
    assert "constexpr int kFewSmemMax = 227 * 1024;" in src  # an H100 block's 232,448 bytes
    assert "const long long smem = 4 * (ring_words + n_warps * kFewSlot + 1);" in src

    def smem(n_words):  # lcpc_blake3_cols_few's bytes: the rings or the top's nodes, slots
        n_chunks = -(-(8 + n_words) // 256)
        n_groups, n_warps = -(-n_chunks // warps), min(n_chunks, warps)
        ring = max(n_warps * stages * 16 * 32, n_groups * 256 if n_groups > 1 else 0)
        return 4 * (ring + n_warps * 256 + 1)

    assert smem(b3.FEW_WORDS_MAX) <= 227 * 1024 < smem(b3.FEW_WORDS_MAX + 256 * warps)
    rng = np.random.default_rng(19)
    # one chunk (ROOT on it), 2, 4, 5, 9, 16, 17, 65 chunks and FEW_WORDS_MAX's
    for n_cols, n_words in ((40, 0), (40, 8), (40, 247), (40, 248), (40, 1016), (40, 1017),
                            (40, 2048), (40, 4088), (40, 4089), (40, 16_384),
                            (3, b3.FEW_WORDS_MAX)):
        total = 8 + n_words
        n_chunks = -(-total // 256)
        out, counters = _few_grid_model(n_cols, n_words, warps, stages, rng)
        assert sorted(out) == list(range(-(-n_cols // 32))), n_words
        assert all(t == _b3_tree(0, n_chunks, True) for t in out.values()), n_words
        assert not counters.any()
