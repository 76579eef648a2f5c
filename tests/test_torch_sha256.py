"""The port's SHA-256 (ops/sha256.py): the plain versions of the kernels of
csrc/sha256_cols.cu (the column hash, one-shot and as streaming updates and
finalizes; the Merkle parent, tree and walk) against hashlib and against
lcpc_tpu's device hash (ops/sha256_jax.py), on ragged column counts and
several block counts, the kernels' constant tables, the wrappers' refusals,
and the digest registry."""

import hashlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from lcpc_tpu.ops import sha256_jax
from lcpc_tpu_torch.ops import blake3 as b3
from lcpc_tpu_torch.ops import digest, sha256
from lcpc_tpu_torch.ops.blake3 import digests_to_bytes

torch.set_num_threads(1)  # the xdist workers share the cores


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
    # hash_word_columns (the one-shot plain version on the CPU) and the
    # kernel wrapper sha256_cols's plain path (update, then finalize: int32
    # storage, the words also fed as two updates split at every offset of a
    # block and one more) give hashlib's digests
    words = _words(n_words, n_cols, seed=n_words)
    got = digests_to_bytes(sha256.hash_word_columns(torch.from_numpy(words.astype(np.int64))))
    for c in range(n_cols):
        want = hashlib.sha256(bytes(32) + words[:, c].astype("<u4").tobytes()).digest()
        assert bytes(got[c]) == want, (n_words, c)
    w32 = torch.from_numpy(words.view(np.int32))
    total = sha256.PREFIX_WORDS + n_words
    assert np.array_equal(digests_to_bytes(sha256.sha256_cols(w32, total_words=total)), got)
    for cut in sorted({0, 1, 7, 8, 9, n_words // 2, n_words} & set(range(n_words + 1))):
        cv = sha256.h0_state(n_cols, "cpu")
        carry = torch.zeros((16, n_cols), dtype=torch.int32)
        rem = sha256.sha256_cols(w32[:cut], cv=cv, carry=carry)
        assert rem == (sha256.PREFIX_WORDS + cut) % 16
        out = sha256.sha256_cols(w32[cut:], cv=cv, carry=carry, carry_len=rem,
                                 total_words=total)
        assert np.array_equal(digests_to_bytes(out), got), (n_words, cut)


@pytest.mark.parametrize("n_words,n_cols", [(56, 130), (120, 7)])
def test_columns_match_reference(n_words, n_cols):
    words = _words(n_words, n_cols, seed=7 * n_words)
    ours = sha256.hash_word_columns_plain(torch.from_numpy(words.astype(np.int64))).numpy()
    assert np.array_equal(ours, np.asarray(sha256_jax.hash_word_columns(words)))
    # the streamed message's end at every rem, the padding's block boundary
    # (rem + 3 = 16) on each side: sha256_finalize_plain from the chaining
    # value of the whole blocks against the one-shot plain hash
    for rem in range(16):
        n = 16 + rem - sha256.PREFIX_WORDS
        w = torch.from_numpy(words[:n].astype(np.int64))
        cv, carry, got_rem = sha256.sha256_update_plain(sha256.h0_state(n_cols, "cpu"), None,
                                                        sha256.PREFIX_WORDS, w)
        assert got_rem == rem
        assert torch.equal(sha256.sha256_finalize_plain(cv, carry, rem, 16 + rem),
                           sha256.hash_word_columns_plain(w)), rem


# the few-column kernel's route: verify's opened columns (189 Ligero, 6,593
# Brakedown) and the edges of its 32-column blocks go to "few", the commits'
# 131,072 and 357,699 columns to "wide", the crossover on both sides
@pytest.mark.parametrize("n_cols,route", [
    (1, "few"), (31, "few"), (32, "few"), (33, "few"), (189, "few"), (6_593, "few"),
    (sha256.FEW_COLS_MAX, "few"), (sha256.FEW_COLS_MAX + 1, "wide"), (131_072, "wide"),
    (357_699, "wide")])
def test_cols_route(n_cols, route):
    assert sha256.cols_route(n_cols) == route
    # on CPU tensors both kernels' wrappers run the plain version: the route
    # forced either way gives the same digests and refuses an unknown kernel
    w = torch.from_numpy(_words(3, min(n_cols, 40), seed=n_cols % 97).view(np.int32))
    want = sha256.hash_word_columns_plain(w)
    for forced in sha256.COLS_KERNELS:
        assert torch.equal(sha256.sha256_cols(w, total_words=11, _route=forced), want)
    with pytest.raises(ValueError):
        sha256.sha256_cols(w, total_words=11, _route="narrow")


# few-column shapes as verify hashes them (the 8-word prefix, then the
# column): the last block ends where the padding just fits (8 + L = 13 mod
# 16: 0x80000000 and the length fill it) or just does not (14: a second
# final block), at 1, 31, 32, 33 and 189 columns
@pytest.mark.parametrize("n_cols,n_words", [(1, 5), (31, 6), (32, 21), (33, 22), (189, 37),
                                            (189, 120)])
def test_few_column_shapes_vs_hashlib_and_reference(n_cols, n_words):
    words = _words(n_words, n_cols, seed=1000 + n_words)
    got = sha256.hash_word_columns_plain(torch.from_numpy(words.astype(np.int64)))
    b = digests_to_bytes(got)
    for c in range(n_cols):
        want = hashlib.sha256(bytes(32) + words[:, c].astype("<u4").tobytes()).digest()
        assert bytes(b[c]) == want, (n_words, c)
    assert np.array_equal(got.numpy(), np.asarray(sha256_jax.hash_word_columns(words)))


def _csrc(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "lcpc_tpu_torch", "csrc", name)
    with open(path) as f:
        return f.read()


def _cuh_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# csrc/merkle.cuh's tree (which only the card runs), modelled from its
# source: launch_tree's blocks, each building the subtree of kTreeLeaves
# leaves (all of them in a smaller tree), level 1 from the leaves and the
# levels above it in a shared-memory level of kTreeNodes nodes, then the
# last block's levels above the subtree roots, through L2 while a level is
# wider than shared memory.  Every node of the flat leaves-first array is
# written once, after both of its children, and every level a block holds
# fits its shared memory.
@pytest.mark.parametrize("log_lo,log_hi", [(0, 8), (8, 14), (14, 22)])
def test_merkle_tree_split_model(log_lo, log_hi):
    cuh = _csrc("merkle.cuh")
    assert "constexpr int kTreeNodes = 2 * kTreeThreads;" in cuh
    assert "constexpr int kTreeLeaves = 2 * kTreeNodes;" in cuh
    nodes = 2 * _cuh_const(cuh, "kTreeThreads")
    log_leaves = (2 * nodes).bit_length() - 1
    for log_np2 in range(log_lo, log_hi):
        np2 = 1 << log_np2
        offset = lambda lvl: 2 * np2 - 2 * (np2 >> lvl)  # noqa: E731
        done = np.zeros(2 * np2 - 1, dtype=np.int64)

        def build(lvl, idx):  # level lvl's nodes idx from their children
            assert (done[offset(lvl - 1) + 2 * idx] == 1).all()
            assert (done[offset(lvl - 1) + 2 * idx + 1] == 1).all()
            done[offset(lvl) + idx] += 1

        def merge(n, lvl, first):  # merge_in_smem: n nodes of level lvl to one
            assert n <= nodes
            while n > 1:
                n, lvl, first = n // 2, lvl + 1, first // 2
                build(lvl, first + np.arange(n))

        if np2 == 1:  # the leaf is the root
            done[0] += 1
        log_sub = min(log_np2, log_leaves)
        blocks = np2 >> log_sub
        pairs = 1 << max(log_sub - 1, 0)
        for b in range(blocks if np2 > 1 else 0):
            first = b * pairs
            leaf = 2 * (first + np.arange(pairs))
            assert not done[leaf].any() and not done[leaf + 1].any()
            done[leaf] += 1  # the leaves, copied on the way
            done[leaf + 1] += 1
            build(1, first + np.arange(pairs))
            merge(pairs, 1, first)
        if blocks > 1:  # the last block, after every subtree
            lvl, n = log_sub, blocks
            while n > nodes:
                build(lvl + 1, np.arange(n // 2))
                n, lvl = n // 2, lvl + 1
            merge(n, lvl, 0)
        assert (done == 1).all(), log_np2


def _kernel_bench():
    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import kernel_bench
    return kernel_bench


_ROUND = ["SHF.R.W.U32 R5, R4, 0x6, R4", "SHF.R.W.U32 R6, R4, 0xb, R4",
          "LOP3.LUT R7, R5, R6, R8, 0x96, !PT", "IADD3 R4, R7, R10, R11"]


# scripts/kernel_bench.sass_chain, which reads the SHA-256 kernels' critical
# paths off their SASS on the card: a loop body's longest read-after-write
# chain, carried from one trip to the next, loads ready at the start,
# stores and branches off it, the longer of two chains
@pytest.mark.parametrize("body,cycles,ops", [
    (_ROUND + ["BRA 0x0"], 12.0, {"SHF.R.W.U32": 1, "LOP3.LUT": 1, "IADD3": 1}),
    (_ROUND[:3] + ["LDS.128 R12, [R3+0x10]", "IADD3 R9, R7, R10, R11",
                   "IMAD.IADD R4, R9, 0x1, R12", "STS [R3], R4"],
     16.0, {"SHF.R.W.U32": 1, "LOP3.LUT": 1, "IADD3": 1, "IMAD.IADD": 1}),
    (_ROUND + ["LOP3.LUT R20, R20, R21, RZ, 0x3c, !PT"], 12.0,
     {"SHF.R.W.U32": 1, "LOP3.LUT": 1, "IADD3": 1}),
])
def test_sass_chain(body, cycles, ops):
    assert _kernel_bench().sass_chain(body, lambda op: 4.0) == (cycles, ops)


def test_merkle_layer_vs_hashlib_and_reference():
    digs = _words(8, 6, seed=43)
    out = sha256.merkle_layer_plain(torch.from_numpy(digs.astype(np.int64)))
    assert np.array_equal(out.numpy(), np.asarray(sha256_jax.merkle_layer(digs)))
    lb, ob = digests_to_bytes(digs), digests_to_bytes(out)
    for i in range(3):
        assert bytes(ob[i]) == hashlib.sha256(bytes(lb[2 * i]) + bytes(lb[2 * i + 1])).digest()


def _cu_table(src, name):
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", src, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]


def test_merkle_parent_of_one_pair():
    left, right = _words(8, 1, seed=1), _words(8, 1, seed=2)
    got = sha256.merkle_parent_plain(torch.from_numpy(left.astype(np.int64)),
                                     torch.from_numpy(right.astype(np.int64)))
    want = hashlib.sha256(left.astype("<u4").tobytes() + right.astype("<u4").tobytes())
    assert bytes(digests_to_bytes(got)[0]) == want.digest()
    # the kernels' constant tables (csrc/sha256.cuh, which sha256_cols.cu and
    # commit_small.cu include and only the card runs): the initial hash
    # value, K, and W + K of a parent's padding block (0x80000000, zeros, the
    # bit length 512), its schedule run here
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "lcpc_tpu_torch", "csrc", "sha256.cuh")
    with open(path) as f:
        src = f.read()
    assert _cu_table(src, "kH0") == list(sha256._H0)
    assert _cu_table(src, "kK") == list(sha256._K)
    rot = lambda x, n: ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF  # noqa: E731
    w = [0x80000000] + [0] * 14 + [512]
    for t in range(16, 64):
        s0 = rot(w[t - 15], 7) ^ rot(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rot(w[t - 2], 17) ^ rot(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & 0xFFFFFFFF)
    assert _cu_table(src, "kPadWK") == [(a + b) & 0xFFFFFFFF for a, b in zip(w, sha256._K)]


def test_merkle_tree_and_walk():
    # SHA-256's tree and walk behind the digest plug point: the layer and
    # parent loops, against hashlib
    digs = _words(8, 3, seed=44)
    flat = digest.SHA256.merkle_tree(torch.from_numpy(digs.astype(np.int64)), 4)
    b = digests_to_bytes(flat)
    assert flat.shape == (8, 7) and not flat[:, 3].any()
    h = lambda x, y: hashlib.sha256(bytes(x) + bytes(y)).digest()
    assert bytes(b[4]) == h(b[0], b[1]) and bytes(b[6]) == h(b[4], b[5])
    idx = torch.tensor([2, 1], dtype=torch.int64)
    sibs = flat[:, [3, 0, 4, 5]]  # level 0: leaf 3 (for 2), leaf 0 (for 1); level 1
    inv = torch.tensor([[0, 1], [2, 3]], dtype=torch.int64)
    got = digest.SHA256.merkle_walk(flat[:, [2, 1]], sibs, inv, idx)
    assert torch.equal(got, flat[:, [6, 6]])
    # one leaf is its own root; the plain walk of 0 levels returns the leaves
    one = torch.from_numpy(digs[:, :1].astype(np.int64))
    assert torch.equal(sha256.merkle_tree_plain(one, 1), one)
    assert torch.equal(sha256.merkle_walk_plain(flat[:, :2], sibs, inv[:0], idx), flat[:, :2])

    # the wrappers' refusals: another device (meta), mixed devices, wrong
    # dtypes and shapes
    meta = torch.empty((8, 4), dtype=torch.int64, device="meta")
    w = torch.zeros((5, 4), dtype=torch.int32)
    cv, carry = sha256.h0_state(4, "cpu"), torch.zeros((16, 4), dtype=torch.int32)
    for call in (lambda: sha256.hash_word_columns(meta),
                 lambda: sha256.merkle_tree(meta, 4),
                 lambda: sha256.merkle_walk(meta[:, :2], meta, inv.to("meta"), idx.to("meta")),
                 lambda: sha256.sha256_cols(w.to("meta"), total_words=13)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    for call in (lambda: sha256.sha256_cols(w, cv=cv.to("meta"), carry=carry),
                 lambda: sha256.merkle_walk(flat[:, [2, 1]], sibs.to("meta"), inv, idx)):
        with pytest.raises(ValueError, match="different devices"):
            call()
    for call in (lambda: sha256.hash_word_columns(w.to(torch.int16)),
                 lambda: sha256.sha256_cols(w, cv=cv.long(), carry=carry),
                 lambda: sha256.merkle_tree(flat[:, :3].to(torch.int32), 4),
                 lambda: sha256.merkle_walk(flat[:, [2, 1]], sibs, inv.int(), idx)):
        with pytest.raises(TypeError):
            call()
    for call in (lambda: sha256.hash_word_columns(w[0]),
                 lambda: sha256.sha256_cols(w, cv=cv),  # an update needs the carry
                 lambda: sha256.sha256_cols(w, cv=cv[:, :3].contiguous(), carry=carry),
                 lambda: sha256.sha256_cols(w, carry_len=17, total_words=30),
                 lambda: sha256.sha256_cols(w, total_words=12),  # shorter than its stream
                 lambda: sha256.merkle_tree(flat[:, :3], 3),
                 lambda: sha256.merkle_walk(flat[:, [2, 1]], sibs, inv[:, :1], idx)):
        with pytest.raises(ValueError):
            call()


def test_digest_registry():
    assert digest.DIGESTS_BY_NAME["blake3"] is digest.BLAKE3
    assert digest.DIGESTS_BY_NAME["sha256"] is digest.SHA256
    assert digest.SHA256.host(b"abc") == hashlib.sha256(b"abc").digest()
    assert digest.BLAKE3.host(b"abc") != digest.SHA256.host(b"abc")
    assert digest.SHA256.hash_word_columns is sha256.hash_word_columns
    assert digest.SHA256.merkle_tree is sha256.merkle_tree
    assert digest.SHA256.merkle_walk is sha256.merkle_walk
    assert digest.BLAKE3.merkle_tree is b3.merkle_tree
    assert digest.BLAKE3.merkle_walk is b3.merkle_walk
