"""The Ligero slice as a whole: dims, encode_rows and commit -> prove ->
verify in the port (device="cpu", plain PyTorch) against lcpc_tpu, through
the wire bytes, with BLAKE3 and with SHA-256.

- ft63 runs lcpc_tpu's device path under JAX (commit, prove, verify) and
  cross-verifies in both directions;
- ft255 is the golden instance (tests/data/torch_golden_ligero.json, written
  by scripts/make_torch_golden.py from lcpc_tpu's device path).  In the
  suite it is reproduced through lcpc_tpu's serial twin
  (core/reference_impl.py; its hashes are BLAKE3, so the SHA-256 tree is
  rebuilt here with hashlib over the twin's codeword): lcpc_tpu's jitted
  ft255 graphs compile for minutes on XLA:CPU.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

import lcpc_tpu as J
from lcpc_tpu.core import reference_impl as ref
from lcpc_tpu.core import wire as jwire
from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops.digest import DIGESTS_BY_NAME as J_DIGESTS
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
import lcpc_tpu_torch as P
from lcpc_tpu.ops import mxu_ntt as jmxu
from lcpc_tpu_torch.encodings import ligero
from lcpc_tpu_torch.encodings.ligero import LigeroEncoding
from lcpc_tpu_torch.ops import mxu_ntt
from lcpc_tpu_torch.ops.limbs import get_ops, limbs_to_device, pack_row_words
from lcpc_tpu_torch.utils.tensors import seeded_values

torch.set_num_threads(1)  # the xdist workers share the cores

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_golden_ligero.json")
DIGESTS = ["blake3", "sha256"]


def _jspec(spec):
    return J_FIELDS[spec.name]


# ---------------------------------------------------------------------------
# dims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", P.ALL_FIELDS, ids=lambda s: s.name)
@pytest.mark.parametrize("rho", [(1, 2), (1, 4)], ids=["1/2", "1/4"])
def test_dims_match_reference(spec, rho):
    # the lengths of tests/test_multilinear.py's fuzz, and lengths past the
    # 2-adicity cap (None)
    rng = random.Random(808)
    lengths = [rng.randrange(2, 1 << 20) for _ in range(128)] + [1 << 60, 1 << 80, 1 << 100]
    nones = 0
    for length in lengths:
        ours = LigeroEncoding._get_dims(spec, length, *rho)
        assert ours == J.LigeroEncoding._get_dims(_jspec(spec), length, *rho), length
        if ours is None:
            nones += 1
            continue
        n_cols = ours[2]
        assert (LigeroEncoding._n_degree_tests_static(spec, n_cols)
                == J.LigeroEncoding._n_degree_tests_static(_jspec(spec), n_cols))
    assert nones >= 1
    assert LigeroEncoding.n_col_opens_static(*rho) == J.LigeroEncoding.n_col_opens_static(*rho)


def test_constructors_match_reference(monkeypatch):
    for spec in (P.FT63, P.FT255):
        js = _jspec(spec)
        pairs = [(LigeroEncoding.new(spec, 1000, 1, 4, device="cpu"),
                  J.LigeroEncoding.new(js, 1000, 1, 4)),
                 (LigeroEncoding.new_ml(spec, 12, device="cpu"), J.LigeroEncoding.new_ml(js, 12)),
                 (LigeroEncoding.new_from_dims(spec, 64, 256, 1, 4, device="cpu"),
                  J.LigeroEncoding.new_from_dims(js, 64, 256, 1, 4))]
        for ours, theirs in pairs:
            assert (ours.n_per_row, ours.n_cols, ours.get_n_col_opens(),
                    ours.get_n_degree_tests(), ours.rho) == (
                theirs.n_per_row, theirs.n_cols, theirs.get_n_col_opens(),
                theirs.get_n_degree_tests(), theirs.rho)
            assert ours.get_dims(3000) == theirs.get_dims(3000)
            assert ours.dims_ok(ours.n_per_row, ours.n_cols)
            assert not ours.dims_ok(ours.n_per_row, 2 * ours.n_cols)
    with pytest.raises(ValueError):
        LigeroEncoding(P.FT63, 64, 96, device="cpu")  # n_cols not a power of two
    # the four-step transform's gate: lcpc_tpu's at its own test's points, and
    # ntt_route (lcpc_tpu's _pick_ntt) by MXU_NTT
    for spec in P.ALL_FIELDS:
        assert mxu_ntt.conv_cap(spec) == jmxu.conv_cap(_jspec(spec))
    for spec, n, in_len in ((P.FT255, 1 << 20, None), (P.FT255, 1 << 22, None),
                            (P.FT255, 1 << 23, None), (P.FT63, 1 << 26, None),
                            (P.FT63, 1 << 27, None), (P.FT255, 1 << 23, 1 << 21),
                            (P.FT255, 1 << 24, 1 << 22), (P.FT255, 1 << 17, 1 << 15),
                            (P.FT63, 2, None), (P.FT63, 64, 2)):
        assert mxu_ntt.mxu_supported(spec, n, in_len) == \
            jmxu.mxu_supported(_jspec(spec), n, in_len), (spec.name, n, in_len)
    assert ligero.MXU_NTT is False
    assert ligero.ntt_route(P.FT255, 1 << 17, 1 << 15) == "ladder"
    for flag, want in ((True, ("mxu", "mxu", "ladder", "mxu")),
                       (False, ("ladder",) * 4)):
        monkeypatch.setattr(ligero, "MXU_NTT", flag)
        assert (ligero.ntt_route(P.FT255, 1 << 17, 1 << 15),
                ligero.ntt_route(P.FT255, 1 << 22, 1 << 22),
                ligero.ntt_route(P.FT255, 1 << 23, None),
                ligero.ntt_route(P.FT255, 1 << 23, 1 << 21)) == want


# ---------------------------------------------------------------------------
# encode_rows
# ---------------------------------------------------------------------------


def _rows(spec, n_rows, npr, seed):
    vals = seeded_values(spec.p, spec.w16, n_rows * npr, seed)
    rows = [vals[i * npr:(i + 1) * npr] for i in range(n_rows)]
    rows[0] = [spec.p - 1] * npr
    jops = j_get_ops(_jspec(spec))
    return rows, np.stack([jops.encode_host(r) for r in rows], axis=1)  # (W, R, npr)


def test_encode_rows_matches_reference_ft63():
    spec = P.FT63
    _, x = _rows(spec, 5, 64, seed=11)
    want = np.asarray(J.LigeroEncoding.new_from_dims(_jspec(spec), 64, 256, 1, 4)
                      .encode_rows(x))
    enc = LigeroEncoding.new_from_dims(spec, 64, 256, 1, 4, device="cpu")
    got = enc.encode_rows(limbs_to_device(x, "cpu"))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the four-step transform's plain version against lcpc_tpu's MxuNtt and
    # its canonical variant, at the shapes tests/test_mxu_ntt.py compiles
    # (two rows; n = 16 and 256, (256, 64) and (128, full) both ways)
    js = _jspec(spec)
    for n, in_len in ((16, None), (256, None), (256, 64), (128, None)):
        xj = _rows(spec, 2, in_len or n, seed=n)[1]
        xt = torch.from_numpy(xj.astype(np.int32))
        ours = mxu_ntt.get_mxu_ntt(spec, n, in_len)
        assert np.array_equal(ours(xt).numpy(), np.asarray(jmxu.get_mxu_ntt(js, n, in_len)(xj)))
        if n != 16 and (n, in_len) != (256, None):
            canon = np.asarray(jmxu.get_mxu_ntt_canonical(js, n, in_len)(xj))
            mine = mxu_ntt.get_mxu_ntt_canonical(spec, n, in_len)
            assert np.array_equal(mxu_ntt.mxu_ntt_plain(mine, xt).numpy(), canon)
            assert torch.equal(ours(xt, output="words"),
                               pack_row_words(torch.from_numpy(canon.astype(np.int32))))


def test_encode_rows_matches_host_twin_ft255():
    spec = P.FT255
    rows, x = _rows(spec, 3, 256, seed=12)
    jenc = J.LigeroEncoding.new_from_dims(_jspec(spec), 256, 1024, 1, 4)
    enc = LigeroEncoding.new_from_dims(spec, 256, 1024, 1, 4, device="cpu")
    got = enc.encode_rows(limbs_to_device(x, "cpu"))
    jops = j_get_ops(_jspec(spec))
    for r, row in enumerate(rows):
        assert jops.decode_host(got[:, r].numpy()) == jenc.encode_row_host(row)
        assert enc.encode_row_host(row) == jenc.encode_row_host(row)


@pytest.mark.parametrize("spec", [P.FT63, P.FT255], ids=lambda s: s.name)
def test_default_encode_rows_words_matches_ligero(spec):
    # the LcEncoding default (encode_rows, from_mont, pack) and Ligero's
    # override (the NTT's words) give the same limbs and words, and the words
    # are the codeword's canonical values (tests/test_torch_ntt.py holds them
    # to lcpc_tpu's _canon_pack_fn)
    _, x = _rows(spec, 3, 64, seed=13)
    enc = LigeroEncoding.new_from_dims(spec, 64, 256, 1, 4, device="cpu")
    rows = limbs_to_device(x, "cpu")
    limbs, words = enc.encode_rows_words(rows)
    d_limbs, d_words = P.LcEncoding.encode_rows_words(enc, rows)
    assert torch.equal(limbs, d_limbs) and torch.equal(words, d_words)
    assert torch.equal(limbs, enc.encode_rows(rows))
    # word r*W/2 + i of column c: the canonical value's LE u32 words
    u = words.numpy().view(np.uint32)
    w32 = spec.w16 // 2
    for r in range(3):
        got = [sum(int(u[w32 * r + i, c]) << (32 * i) for i in range(w32)) for c in range(256)]
        assert got == get_ops(spec).decode_host(limbs[:, r])


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------


def _transcript(T, label, enc, root):
    tr = T(label)
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    return tr


def _host_tree(comm_rows, spec, host):
    """Leaves-first Merkle array over the columns of a canonical codeword
    (lcpc-2d/src/lib.rs:706-785) with a host digest."""
    n_cols = len(comm_rows[0])
    np2 = 1 << (n_cols - 1).bit_length()
    hashes = [host(bytes(32) + b"".join(spec.to_repr(row[c]) for row in comm_rows))
              for c in range(n_cols)] + [bytes(32)] * (np2 - n_cols)
    layer = hashes
    while len(layer) > 1:
        layer = [host(layer[2 * i] + layer[2 * i + 1]) for i in range(len(layer) // 2)]
        hashes = hashes + layer
    return hashes


class Case:
    """One Ligero rho = 1/4 instance run through both packages with one digest."""

    def __init__(self, spec, length, coeff_seed, label, digest, jax_device_path):
        self.spec, self.jspec, self.label = spec, _jspec(spec), label
        vals = seeded_values(spec.p, spec.w16, length + 1, coeff_seed)
        self.coeffs, self.x = vals[:-1], vals[-1]
        self.digest, self.jdigest = P.DIGESTS_BY_NAME[digest], J_DIGESTS[digest]
        self.enc = LigeroEncoding.new(spec, length, 1, 4, device="cpu")
        self.jenc = J.LigeroEncoding.new(self.jspec, length, 1, 4)

        self.comm = P.commit(self.coeffs, self.enc, digest=self.digest)
        self.root = self.comm.get_root()
        self.outer, self.inner = P.univariate_tensors(
            spec, self.x, self.comm.n_per_row, self.comm.n_rows)
        self.proof = self.comm.prove(self.outer, self.tr(P, self.root))
        self.proof_bytes = P.wire.serialize_proof(spec, self.proof)

        if jax_device_path:
            self.jcomm = J.commit(self.coeffs, self.jenc, digest=self.jdigest)
            self.jroot = self.jcomm.get_root()
            jproof = self.jcomm.prove(self.outer, self.tr(J, self.jroot))
        else:
            rc = ref.ref_commit(self.coeffs, self.jenc)
            if digest != "blake3":
                rc.hashes = _host_tree(rc.comm, self.jspec, self.jdigest.host)
            self.jroot = rc.get_root()
            rp = ref.ref_prove(rc, self.outer, self.jenc, self.tr(J, self.jroot))
            jops = j_get_ops(self.jspec)
            jproof = J.LcEvalProof(
                rp.n_cols, p_eval=rp.p_eval, p_random_vec=rp.p_random_vec,
                columns=[J.core.protocol.LcColumn(col_mont=jops.encode_host(c.col),
                                                  path=c.path) for c in rp.columns])
        self.jproof_bytes = jwire.serialize_proof(self.jspec, jproof)

    def tr(self, pkg, root):
        enc = self.enc if pkg is P else self.jenc
        return _transcript(pkg.Transcript, self.label, enc, root)

    def want(self):
        return P.univariate_eval(self.spec, self.coeffs, self.x)

    def port_verify(self, data, root=None, outer=None, digest=None):
        root = self.root if root is None else root
        pf = P.wire.deserialize_proof(self.spec, data)
        return pf.verify(root, self.outer if outer is None else outer, self.inner,
                         self.enc, self.tr(P, root), digest or self.digest)

    def jax_verify(self, data, root=None):
        root = self.jroot if root is None else root
        pf = jwire.deserialize_proof(self.jspec, data)
        return pf.verify(root, self.outer, self.inner, self.jenc, self.tr(J, root),
                         self.jdigest)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


_CASES = {}


def _case(key, make):
    if key not in _CASES:
        _CASES[key] = make()
    return _CASES[key]


@pytest.fixture(params=DIGESTS)
def ft63(request):
    return _case(("ft63", request.param), lambda: Case(
        P.FT63, 1000, 7, b"lcpc port ligero twin", request.param, jax_device_path=True))


def _ft255(digest, golden):
    return _case(("ft255", digest), lambda: Case(
        P.FT255, golden["length"], golden["coeff_seed"], golden["transcript"][0].encode(),
        digest, jax_device_path=False))


@pytest.fixture(params=DIGESTS)
def ft255(request, golden):
    return _ft255(request.param, golden)


def test_root_and_proof_bytes_identical_ft63(ft63, monkeypatch):
    assert (ft63.comm.n_rows, ft63.comm.n_per_row, ft63.comm.n_cols) == (4, 256, 1024)
    assert ft63.root == ft63.jroot
    assert ft63.proof_bytes == ft63.jproof_bytes
    # through the four-step transform (lcpc_tpu's LCPC_MXU_NTT=1): commit,
    # prove and verify's encode give the ladder's bytes, lcpc_tpu verifies
    monkeypatch.setattr(ligero, "MXU_NTT", True)
    assert ligero.ntt_route(P.FT63, 1024, 256) == "mxu"
    comm = P.commit(ft63.coeffs, ft63.enc, digest=ft63.digest)
    assert comm.get_root() == ft63.root
    data = P.wire.serialize_proof(ft63.spec, comm.prove(ft63.outer, ft63.tr(P, ft63.root)))
    assert data == ft63.proof_bytes
    assert ft63.port_verify(data) == ft63.want() == ft63.jax_verify(data, root=ft63.root)


def test_port_verifies_reference_proof_ft63(ft63):
    assert ft63.port_verify(ft63.jproof_bytes, root=ft63.jroot) == ft63.want()


def test_reference_verifies_port_proof_ft63(ft63):
    assert ft63.jax_verify(ft63.proof_bytes, root=ft63.root) == ft63.want()


def test_mismatched_digest_fails_the_path(ft63):
    other = P.SHA256 if ft63.digest is P.BLAKE3 else P.BLAKE3
    with pytest.raises(P.VerifierError) as e:
        ft63.port_verify(ft63.proof_bytes, digest=other)
    assert e.value.kind == "ColumnPath"


def _tampered(case, what):
    pf = P.wire.deserialize_proof(case.spec, case.proof_bytes)
    if what == "column":
        pf.columns[0].col_mont[0, 0] ^= 1
    elif what == "path":
        pf.columns[3].path[1] = bytes(32)
    elif what == "count":
        pf.columns = pf.columns[:-1]
    elif what == "short_row":  # valid input: zero-padded and encoded on the host
        pf.p_random_vec[0] = pf.p_random_vec[0][:-1]
    return P.wire.serialize_proof(case.spec, pf)


@pytest.mark.parametrize("what,kind", [("column", "ColumnDegree"),
                                       ("path", "ColumnPath"),
                                       ("count", "NumColOpens"),
                                       ("short_row", "ColumnDegree")])
def test_tampered_proof_kinds_match_reference_ft63(ft63, what, kind):
    data = _tampered(ft63, what)
    with pytest.raises(P.VerifierError) as ours:
        ft63.port_verify(data)
    with pytest.raises(J.VerifierError) as theirs:
        ft63.jax_verify(data)
    assert ours.value.kind == theirs.value.kind == kind


def test_golden_fixture_ft255(ft255, golden):
    want = golden["digests"][ft255.digest.name]
    assert (ft255.comm.n_rows, ft255.comm.n_per_row, ft255.comm.n_cols) == (
        golden["n_rows"], golden["n_per_row"], golden["n_cols"])
    assert ft255.root.hex() == ft255.jroot.hex() == want["root"]
    assert len(ft255.proof_bytes) == want["proof_bytes"]
    assert hashlib.sha256(ft255.proof_bytes).hexdigest() == want["proof_sha256"]
    assert hashlib.sha256(ft255.jproof_bytes).hexdigest() == want["proof_sha256"]
    assert hex(ft255.want()) == golden["eval"]


def test_port_verifies_reference_proof_ft255(ft255):
    assert ft255.port_verify(ft255.jproof_bytes, root=ft255.jroot) == ft255.want()


def test_serial_twin_verifies_port_proof_ft255(golden):
    # lcpc_tpu's serial verifier hashes with BLAKE3 only
    ft255 = _ft255("blake3", golden)
    pf = jwire.deserialize_proof(ft255.jspec, ft255.proof_bytes)
    jops = j_get_ops(ft255.jspec)
    rp = ref.RefProof(pf.n_cols, pf.p_eval, pf.p_random_vec, [
        ref.RefColumn(col=jops.decode_host(c.col_mont), path=c.path) for c in pf.columns])
    got = ref.ref_verify(ft255.root, ft255.outer, ft255.inner, rp, ft255.jenc,
                         ft255.tr(J, ft255.root))
    assert got == ft255.want()


@pytest.mark.parametrize("what,kind", [("column", "ColumnDegree"), ("path", "ColumnPath")])
def test_tampered_proof_kinds_ft255(ft255, what, kind):
    with pytest.raises(P.VerifierError) as ours:
        ft255.port_verify(_tampered(ft255, what))
    assert ours.value.kind == kind


@pytest.mark.parametrize("digest", DIGESTS)
def test_multi_chunk_columns_match_host(digest):
    # 300 rows of ft63: a column is 8 + 600 words (2432 bytes), three BLAKE3
    # chunks (the tree merge promotes the odd one) and 39 SHA-256 blocks
    spec = P.FT63
    vals = seeded_values(spec.p, spec.w16, 300 * 4, 31)
    enc = LigeroEncoding.new_from_dims(spec, 4, 16, 1, 4, device="cpu")
    comm = P.commit(vals, enc, digest=P.DIGESTS_BY_NAME[digest])
    assert comm.n_rows == 300
    jenc = J.LigeroEncoding.new_from_dims(_jspec(spec), 4, 16, 1, 4)
    rc = ref.ref_commit(vals, jenc)
    hashes = _host_tree(rc.comm, _jspec(spec), J_DIGESTS[digest].host)
    assert comm.get_root() == hashes[-1]
    assert [bytes(h) for h in comm.hashes] == hashes
    if digest == "blake3":
        assert comm.get_root() == rc.get_root()
