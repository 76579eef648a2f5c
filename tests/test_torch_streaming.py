"""The streaming commit (lcpc_tpu_torch.core.streaming) and its coefficient
sources (core/coeffs.py) on the CPU: roots and proof bytes equal to the
port's in-memory commit and prove, which tests/test_torch_ligero.py and
tests/test_torch_protocol.py hold to lcpc_tpu, for every source, spill mode
and row-block case; one test against lcpc_tpu's own streaming path.
Tolerance 0 everywhere: exact field arithmetic and hashing."""

import random

import numpy as np
import pytest
import torch

import lcpc_tpu_torch as P
from lcpc_tpu_torch.core import coeffs as coeffs_mod
from lcpc_tpu_torch.core import streaming
from lcpc_tpu_torch.ops.limbs import get_ops
from lcpc_tpu_torch.utils import hbm
from lcpc_tpu_torch.utils.tensors import seeded_values

torch.set_num_threads(1)  # the xdist workers share the cores


def _tr(pkg, enc, root):
    tr = pkg.Transcript(b"lcpc port streaming")
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    return tr


class Case:
    """One ft63 instance, committed and proved in memory (the reference)."""

    def __init__(self, enc, length, seed):
        spec = self.spec = enc.spec
        self.enc = enc
        vals = seeded_values(spec.p, spec.w16, length + 1, seed)
        self.coeffs, self.x = vals[:-1], vals[-1]
        self.limbs = get_ops(spec).encode_host(self.coeffs)           # (W, N) uint32
        self.packed = (self.limbs[0::2] | (self.limbs[1::2] << 16)).astype(np.uint32)
        comm = P.commit(self.coeffs, enc)
        self.root, self.dims = comm.get_root(), (comm.n_rows, comm.n_per_row, comm.n_cols)
        self.outer, self.inner = P.univariate_tensors(spec, self.x, comm.n_per_row,
                                                      comm.n_rows)
        self.proof = P.wire.serialize_proof(spec, comm.prove(self.outer, _tr(P, enc, self.root)))

    def source(self, kind):
        return {"list": lambda: self.coeffs,
                "tensor": lambda: torch.from_numpy(self.limbs.view(np.int32)),
                "packed": lambda: torch.from_numpy(self.packed.view(np.int32)),
                "host": lambda: self.limbs,
                "host-packed": lambda: self.packed}[kind]()

    def check(self, cs):
        """cs's root and proof bytes equal the in-memory ones; the proof
        verifies with the evaluation."""
        assert cs.get_root() == self.root
        assert (cs.n_rows, cs.n_per_row, cs.n_cols) == self.dims
        proof = cs.prove(self.outer, _tr(P, self.enc, self.root))
        assert P.wire.serialize_proof(self.spec, proof) == self.proof
        assert proof.verify(self.root, self.outer, self.inner, self.enc,
                            _tr(P, self.enc, self.root)) == P.univariate_eval(
            self.spec, self.coeffs, self.x)


@pytest.fixture(scope="module")
def ligero():
    # 300 rows of 16 (2 words each): 608-word columns, 3 chunks; a 256-word
    # boundary every 128 rows
    return Case(P.LigeroEncoding.new_from_dims(P.FT63, 16, 64, 1, 4, device="cpu"),
                16 * 300 - 5, seed=5)


@pytest.fixture(scope="module")
def brakedown():
    # 130 rows of 64 coefficients, 98 columns (the first 64 systematic)
    return Case(P.SdigEncoding(P.FT63, 64, seed=3, device="cpu"), 64 * 130 - 7, seed=6)


# (source, spill, row_block): every source under every spill mode; blocks on
# the 256-word boundary (128, 256, auto) and off it (8, 40 -> 32, 64, 100 ->
# 64: carries that cycle)
_LIGERO = [
    ("tensor", "device", 128), ("tensor", "auto", None), ("tensor", "host", 8),
    ("tensor", "none", 64),
    ("packed", "device", 40), ("packed", "auto", 256), ("packed", "host", 128),
    ("packed", "none", None),
    ("host", "device", 100), ("host", "auto", 128), ("host", "host", None),
    ("host", "none", 8),
    ("host-packed", "auto", 64), ("host-packed", "none", 128),
    ("list", "auto", 128), ("list", "host", 40),
]


@pytest.mark.parametrize("kind,spill,row_block", _LIGERO,
                         ids=["-".join(map(str, c)) for c in _LIGERO])
def test_ligero_streaming_equals_in_memory(ligero, kind, spill, row_block):
    cs = P.commit_streaming(ligero.source(kind), ligero.enc, row_block=row_block,
                            spill=spill)
    assert isinstance(cs.source, coeffs_mod.HostCoeffSource) == kind.startswith("host")
    assert cs.packed == kind.endswith("packed")
    assert (cs.words_dev is not None) == (spill in ("device", "auto"))
    assert (cs.words_host is not None) == (spill == "host")
    ligero.check(cs)


_BRAKEDOWN = [("tensor", "auto"), ("tensor", "device"), ("tensor", "none"),
              ("packed", "auto"), ("packed", "host"), ("packed", "none"),
              ("host", "auto"), ("host", "device")]


@pytest.mark.parametrize("kind,spill", _BRAKEDOWN, ids=["-".join(c) for c in _BRAKEDOWN])
def test_brakedown_streaming_equals_in_memory(brakedown, kind, spill):
    cs = P.commit_streaming(brakedown.source(kind), brakedown.enc, row_block=32, spill=spill)
    assert cs.words_off == 0
    brakedown.check(cs)


@pytest.mark.parametrize("kind", ["tensor", "packed"])
def test_brakedown_tail_keep(brakedown, kind, monkeypatch):
    # a keep budget between the tail's bytes and the whole codeword's keeps
    # only the non-systematic columns; prove takes the others from the
    # coefficients
    n_rows, npr, n_cols = brakedown.dims
    full, tail = n_rows * 2 * n_cols * 4, n_rows * 2 * (n_cols - npr) * 4
    monkeypatch.setattr(hbm, "keep_bytes_budget", lambda device=None: (full + tail) // 2)
    cs = P.commit_streaming(brakedown.source(kind), brakedown.enc, row_block=64)
    assert cs.words_off == npr == brakedown.enc.systematic_prefix
    assert cs.words_dev.shape == (n_rows * 2, n_cols - npr)
    brakedown.check(cs)


class _Blocks(coeffs_mod.CoeffSource):
    """A source that is neither array- nor host-backed: prove collapses its
    blocks and takes systematic columns from them."""

    def __init__(self, inner):
        self.inner, self.spec, self.length = inner, inner.spec, inner.length
        self.device, self.packed = inner.device, False

    def set_dims(self, n_rows, n_per_row):
        super().set_dims(n_rows, n_per_row)
        self.inner.set_dims(n_rows, n_per_row)

    def block(self, r0, r1):
        return self.inner.block(r0, r1)


def test_source_blocks_collapse_and_tail_keep(brakedown, monkeypatch):
    n_rows, npr, n_cols = brakedown.dims
    monkeypatch.setattr(hbm, "keep_bytes_budget",
                        lambda device=None: n_rows * 2 * (n_cols - npr) * 4)
    src = _Blocks(coeffs_mod.as_source(brakedown.source("packed"), P.FT63, device="cpu"))
    cs = P.commit_streaming(src, brakedown.enc, row_block=16)
    assert cs.coeffs is None and cs.words_off == npr
    brakedown.check(cs)


def test_row_block_sizing(ligero, monkeypatch):
    # the auto row block: the stream budget, or what the resident arrays
    # leave of the usable bytes (at least 512 MiB), over the encoding's own
    # per-row footprint, rounded down to the 256-word boundary (32 rows at
    # ft255); requested blocks under the boundary fall to a power of two
    small = ligero.enc
    assert small.stream_bytes_per_row() == 4 * small.spec.w16 * (small.n_per_row + small.n_cols)
    assert P.LcEncoding.stream_bytes_per_row(small) == 4 * small.spec.w16 * (
        small.n_per_row + 3 * small.n_cols)
    enc = P.LigeroEncoding.new_from_dims(P.FT255, 1 << 16, 1 << 18, 1, 4, device="cpu")
    per_row = enc.stream_bytes_per_row()
    assert hbm.usable_hbm_bytes("cpu") == 10 << 30
    monkeypatch.setattr(hbm, "stream_bytes", lambda device=None: 100 * per_row)
    assert streaming._row_block_for(enc, 2048, None) == 96
    assert streaming._row_block_for(enc, 64, None) == 64
    monkeypatch.setattr(hbm, "stream_bytes", lambda device=None: 10 << 30)
    assert streaming._row_block_for(enc, 2048, None, resident_bytes=8 << 30) == 96
    with pytest.warns(UserWarning, match="resident arrays"):
        assert streaming._row_block_for(enc, 2048, None, resident_bytes=(10 << 30) - 1) == 32
    assert streaming._row_block_for(enc, 2048, 40) == 32
    assert streaming._row_block_for(small, 300, 40) == 32  # 128-row boundary at ft63


def test_sha256_has_no_streaming_hasher(ligero):
    """SHA-256 streams now (StreamingSha256Hasher; the name is the test's
    history): a SHA-256 commit_streaming and its proof equal lcpc_tpu's
    bytes at ft63 and the port's in-memory SHA-256 commit, each package
    verifies the other's proof; a bad `spill` is still refused.  The
    hasher's plain update and finalize (sha256_cols on CPU tensors) equal
    lcpc_tpu's StreamingSha256Hasher state by state, with carries of 0, 8
    and 15 words, blocks of 1, 7, 8, 9 and 1,792 words, and finalizes at
    rem 12, 13 and 14 (one final block, then two); its resident bytes are
    its 24 state words a column, not BLAKE3's chunk CVs."""
    import jax.numpy as jnp

    import lcpc_tpu as J
    from lcpc_tpu.core import streaming as jstreaming
    from lcpc_tpu.core import wire as jwire
    from lcpc_tpu.ops.digest import SHA256 as JSHA256

    rng = np.random.default_rng(11)
    lens = [8, 1792, 7, 8, 9, 1]  # carries before each: 8, 0, 0, 7, 15, 8
    for tail, rem_want in ((3, 12), (4, 13), (5, 14)):
        total = 8 + sum(lens) + tail
        w = rng.integers(0, 1 << 32, (total - 8, 3), dtype=np.uint64).astype(np.uint32)
        w[0] = 0xFFFFFFFF  # top bits set
        jh = jstreaming.StreamingSha256Hasher(3, total)
        ph = streaming.StreamingSha256Hasher(3, total, "cpu")
        r0, carries = 0, []
        for n in lens + [tail]:
            carries.append(ph.buf_len)
            jh.update(jnp.asarray(w[r0 : r0 + n]))
            ph.update(torch.from_numpy(w[r0 : r0 + n].view(np.int32)))
            r0 += n
            assert np.array_equal(np.asarray(jh.h), ph.h.numpy().view(np.uint32)), n
        assert carries == [8, 0, 0, 7, 15, 8, 9] and ph.buf_len == rem_want
        got = ph.finalize()
        assert np.array_equal(got.numpy(), np.asarray(jh.finalize()))
        assert torch.equal(got, P.SHA256.hash_word_columns(torch.from_numpy(w.view(np.int32))))
    assert streaming.StreamingSha256Hasher.resident_bytes(1 << 19, 16_392) == 96 << 19

    jenc = J.LigeroEncoding.new_from_dims(J.FT63, 16, 64, 1, 4)
    jcs = jstreaming.commit_streaming(ligero.coeffs, jenc, row_block=128, digest=JSHA256)
    cs = P.commit_streaming(ligero.coeffs, ligero.enc, row_block=40, digest=P.SHA256)
    root = cs.get_root()
    assert root == jcs.get_root() == P.commit(ligero.coeffs, ligero.enc,
                                              digest=P.SHA256).get_root()
    data = P.wire.serialize_proof(P.FT63, cs.prove(ligero.outer, _tr(P, ligero.enc, root)))
    assert data == jwire.serialize_proof(J.FT63, jcs.prove(ligero.outer, _tr(J, jenc, root)))
    want = P.univariate_eval(P.FT63, ligero.coeffs, ligero.x)
    assert jwire.deserialize_proof(J.FT63, data).verify(
        root, ligero.outer, ligero.inner, jenc, _tr(J, jenc, root), digest=JSHA256) == want
    assert P.wire.deserialize_proof(P.FT63, data).verify(
        root, ligero.outer, ligero.inner, ligero.enc, _tr(P, ligero.enc, root),
        digest=P.SHA256) == want
    with pytest.raises(ValueError, match="spill"):
        P.commit_streaming(ligero.coeffs, ligero.enc, spill="disk")


def test_open_by_eval_equals_reencode(monkeypatch):
    """ft127, no words kept: prove collapses through MxuCollapse and opens
    by evaluating the columns (_open_by_eval, prove-sized blocks over a
    seeded source's packed words); the columns equal _open_by_reencode's,
    and the proof bytes equal the in-memory prove's."""
    spec = P.FT127
    enc = P.LigeroEncoding.new_from_dims(spec, 16, 64, 1, 4, device="cpu")
    src = P.SeededCoeffSource(spec, 16 * 150 - 3, seed=31, chunk=256, device="cpu")
    coeffs = get_ops(spec).decode_host(P.SeededCoeffSource(
        spec, src.length, seed=31, chunk=256, device="cpu").materialize())
    comm = P.commit(coeffs, enc)
    root = comm.get_root()
    outer, inner = P.univariate_tensors(spec, 12345, 16, comm.n_rows)
    want = P.wire.serialize_proof(spec, comm.prove(outer, _tr(P, enc, root)))
    cs = P.commit_streaming(src, enc, row_block=64, spill="none")
    assert cs.get_root() == root and cs.words_dev is None and cs.words_host is None
    cols = [0, 63, 7, 7, 40]
    assert torch.equal(streaming._open_by_eval(cs, cols), streaming._open_by_reencode(cs, cols))
    monkeypatch.setattr(hbm, "usable_hbm_bytes", lambda device=None: (1 << 30) + 200_000)
    assert 8 <= streaming._prove_row_block(cs, 2 * spec.w16) < cs.n_rows  # several blocks
    calls = []
    for name in ("_open_by_eval", "_open_by_reencode"):
        fn = getattr(streaming, name)
        monkeypatch.setattr(streaming, name, lambda c, k, fn=fn, name=name: (
            calls.append(name), fn(c, k))[1])
    proof = cs.prove(outer, _tr(P, enc, root))
    assert calls == ["_open_by_eval"]
    assert P.wire.serialize_proof(spec, proof) == want
    assert proof.verify(root, outer, inner, enc, _tr(P, enc, root)) == P.univariate_eval(
        spec, coeffs, 12345)


def test_single_chunk_columns_are_refused():
    # 60 rows of 2 words: one chunk per column (parity with lcpc_tpu)
    enc = P.LigeroEncoding.new_from_dims(P.FT63, 16, 64, 1, 4, device="cpu")
    with pytest.raises(AssertionError, match="multi-chunk"):
        P.commit_streaming(seeded_values(P.FT63.p, 4, 16 * 60, 1), enc)


def test_sources_default_to_cuda_and_check_layout():
    limbs = np.zeros((4, 10), np.uint32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.HostCoeffSource(limbs, P.FT63)
    src = P.as_source(limbs[:2], P.FT63, device="cpu")
    assert isinstance(src, P.HostCoeffSource) and src.packed
    with pytest.raises(ValueError):
        P.as_source(limbs[:3], P.FT63, device="cpu")
    arr = torch.zeros((4, 10), dtype=torch.int32)
    if torch.cuda.is_available():
        assert P.as_source(arr, P.FT63).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.as_source(arr, P.FT63)
    t = P.as_source(arr, P.FT63, device="cpu")
    assert isinstance(t, P.ArrayCoeffSource) and not t.packed and t.device.type == "cpu"
    t.set_dims(2, 5)
    assert t.raw_block(1, 2).shape == (4, 1, 5)


def test_source_on_another_device_is_refused(ligero):
    # a ready-made source whose blocks lie elsewhere than the encoding runs
    src = P.ArrayCoeffSource(torch.from_numpy(ligero.limbs.view(np.int32)), P.FT63,
                             device="meta")
    with pytest.raises(ValueError, match="lie on meta"):
        P.commit_streaming(src, ligero.enc)


def test_matches_reference_streaming_and_cross_verifies():
    """lcpc_tpu's commit_streaming / prove_streaming on the same inputs
    (its tests/test_streaming.py shape): equal roots and proof bytes, and
    each package verifies the other's proof."""
    import lcpc_tpu as J
    from lcpc_tpu.core import streaming as jstreaming
    from lcpc_tpu.core import wire as jwire
    from lcpc_tpu.fields import FT63 as JFT63

    rng = random.Random(77)
    length = 64 * 700 - 13
    coeffs = [rng.randrange(JFT63.p) for _ in range(length)]
    x = rng.randrange(JFT63.p)
    jenc = J.LigeroEncoding.new_from_dims(JFT63, 64, 128)
    enc = P.LigeroEncoding.new_from_dims(P.FT63, 64, 128, device="cpu")
    jcs = jstreaming.commit_streaming(coeffs, jenc, row_block=128)
    cs = P.commit_streaming(coeffs, enc, row_block=128)
    root = cs.get_root()
    assert root == jcs.get_root()
    outer, inner = P.univariate_tensors(P.FT63, x, cs.n_per_row, cs.n_rows)
    data = P.wire.serialize_proof(P.FT63, cs.prove(outer, _tr(P, enc, root)))
    jdata = jwire.serialize_proof(JFT63, jcs.prove(outer, _tr(J, jenc, root)))
    assert data == jdata
    want = P.univariate_eval(P.FT63, coeffs, x)
    assert jwire.deserialize_proof(JFT63, data).verify(
        root, outer, inner, jenc, _tr(J, jenc, root)) == want
    assert P.wire.deserialize_proof(P.FT63, jdata).verify(
        root, outer, inner, enc, _tr(P, enc, root)) == want
