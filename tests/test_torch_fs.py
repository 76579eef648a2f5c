"""The port's Fiat-Shamir substrate: the published vectors pinned in
tests/test_fs.py, plus stream-for-stream equality with lcpc_tpu."""

import hashlib

import numpy as np
import pytest

import lcpc_tpu.fs.chacha as j_chacha
import lcpc_tpu.fs.merlin as j_merlin
import lcpc_tpu.fs.sampling as j_sampling
from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu_torch.fields import ALL_FIELDS
from lcpc_tpu_torch.fs.chacha import ChaCha20Rng, chacha20_blocks
from lcpc_tpu_torch.fs.keccak import keccak_f1600_bytes
from lcpc_tpu_torch.fs.merlin import Strobe128, Transcript
from lcpc_tpu_torch.fs.sampling import (
    UniformUsize,
    field_random_scalar,
    field_random_vec,
    uniform_indices,
)


def _sha3_256(msg: bytes) -> bytes:
    rate = 136
    st = bytearray(200)
    m = bytearray(msg)
    m.append(0x06)
    while len(m) % rate:
        m.append(0)
    m[-1] |= 0x80
    for off in range(0, len(m), rate):
        for i in range(rate):
            st[i] ^= m[off + i]
        keccak_f1600_bytes(st)
    return bytes(st[:32])


def test_keccak_vs_hashlib():
    for m in [b"", b"abc", b"x" * 200, bytes(range(256)), b"q" * 136]:
        assert _sha3_256(m) == hashlib.sha3_256(m).digest()


def test_chacha_zero_key_classic_vector():
    z = chacha20_blocks(
        np.zeros(8, dtype=np.uint32), 0, np.zeros(2, dtype=np.uint32), 1
    )[0]
    assert int(z[0]) == 0xADE0B876 and int(z[1]) == 0x903DF1A0


def test_chacha_block_vs_cryptography():
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    key = bytes(range(32))
    keyw = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    for ctr, stream in [(0, 0), (5, 0xDEADBEEFCAFEBABE), (2**33, 7)]:
        nonce16 = ctr.to_bytes(8, "little") + stream.to_bytes(8, "little")
        ks = Cipher(algorithms.ChaCha20(key, nonce16), mode=None).encryptor().update(
            bytes(64))
        ours = chacha20_blocks(
            keyw, ctr, np.array([stream & 0xFFFFFFFF, stream >> 32], dtype=np.uint32), 1)
        assert ours.reshape(-1).astype("<u4").tobytes() == ks


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_merlin_published_vector(native):
    if native:
        t = Transcript(b"test protocol")
    else:
        t = Transcript.__new__(Transcript)
        t._lib = None
        t.strobe = Strobe128(b"Merlin v1.0")
        t.append_message(b"dom-sep", b"test protocol")
    t.append_message(b"some label", b"some data")
    assert (
        t.challenge_bytes(b"challenge", 32).hex()
        == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_transcript_matches_reference():
    rows = np.random.default_rng(3).integers(0, 256, size=(40, 32), dtype=np.uint8)
    ours, theirs = Transcript(b"twin"), j_merlin.Transcript(b"twin")
    for t in (ours, theirs):
        t.append_message(b"polycommit", bytes(range(32)))
        t.append_elements(b"$l//PR", rows)
    for label in (b"$l//DT", b"$l//CO"):
        assert ours.challenge_bytes(label, 32) == theirs.challenge_bytes(label, 32)


def test_chacha_streams_match_reference():
    ours, theirs = ChaCha20Rng.seed_from_u64(9), j_chacha.ChaCha20Rng.seed_from_u64(9)
    ours.set_stream(4)
    theirs.set_stream(4)
    assert [ours.next_u64() for _ in range(37)] == [theirs.next_u64() for _ in range(37)]
    assert np.array_equal(ours.next_u64_array(100), theirs.next_u64_array(100))


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_field_random_vec_matches_reference_and_scalar(spec):
    jspec = J_FIELDS[spec.name]
    got = field_random_vec(spec, ChaCha20Rng.seed_from_u64(42), 50)
    assert got == j_sampling.field_random_vec(
        jspec, j_chacha.ChaCha20Rng.seed_from_u64(42), 50)
    r2 = ChaCha20Rng.seed_from_u64(42)
    assert got == [field_random_scalar(spec, r2) for _ in range(50)]


def test_uniform_indices_match_reference_with_rejections():
    # n just above 2^63: the Lemire rejection zone covers ~half of u64, so the
    # rewind path of the vectorized sampler fires
    for n in ((1 << 63) + 12345, 65536, 357699):
        ours = uniform_indices(n, ChaCha20Rng.seed_from_u64(1234), 64)
        theirs = j_sampling.uniform_indices(
            n, j_chacha.ChaCha20Rng.seed_from_u64(1234), 64)
        serial_rng = ChaCha20Rng.seed_from_u64(1234)
        dist = UniformUsize(n)
        assert ours == theirs == [dist.sample(serial_rng) for _ in range(64)]
