"""The slice as a whole: Brakedown commit -> prove -> verify in the port
(device="cpu", plain PyTorch) against lcpc_tpu, through the wire bytes.

- ft63 runs lcpc_tpu's device path under JAX (commit, prove, verify);
- ft255 is the golden instance (tests/data/torch_golden_sdig.json, written by
  scripts/make_torch_golden.py from lcpc_tpu's device path).  In the suite it
  is reproduced, and the port's proof verified, by lcpc_tpu's serial twin
  (core/reference_impl.py): lcpc_tpu's jitted ft255 commit compiles for ~80 s
  and its verify for over 5 minutes on XLA:CPU.
"""

import hashlib
import json
import os

import numpy as np
import pytest

import lcpc_tpu as J
from lcpc_tpu.core import reference_impl as ref
from lcpc_tpu.core import wire as jwire
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
import lcpc_tpu_torch as P
from lcpc_tpu_torch import convert
from lcpc_tpu_torch.utils.tensors import seeded_values

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_golden_sdig.json")


def _transcript(T, label, enc, root):
    tr = T(label)
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    return tr


class Case:
    """One instance run through both packages."""

    def __init__(self, name, n_per_row, n_rows, matrix_seed, coeff_seed, label,
                 jax_device_path):
        self.name, self.label = name, label
        self.spec = getattr(P, name.upper())
        self.jspec = getattr(J, name.upper())
        vals = seeded_values(self.spec.p, self.spec.w16, n_per_row * n_rows + 1,
                             coeff_seed)
        self.coeffs, self.x = vals[:-1], vals[-1]
        self.enc = P.SdigEncoding(self.spec, n_per_row, seed=matrix_seed, device="cpu")
        self.jenc = J.SdigEncoding(self.jspec, n_per_row, seed=matrix_seed)

        self.comm = P.commit(self.coeffs, self.enc)
        self.root = self.comm.get_root()
        self.outer, self.inner = P.univariate_tensors(
            self.spec, self.x, n_per_row, self.comm.n_rows)
        self.proof = self.comm.prove(self.outer, self.tr(P, self.enc, self.root))
        self.proof_bytes = P.wire.serialize_proof(self.spec, self.proof)

        self.jax_device_path = jax_device_path
        if jax_device_path:
            self.jcomm = J.commit(self.coeffs, self.jenc)
            self.jroot = self.jcomm.get_root()
            jproof = self.jcomm.prove(self.outer, self.tr(J, self.jenc, self.jroot))
        else:
            rc = ref.ref_commit(self.coeffs, self.jenc)
            self.jroot = rc.get_root()
            rp = ref.ref_prove(rc, self.outer, self.jenc,
                               self.tr(J, self.jenc, self.jroot))
            jops = j_get_ops(self.jspec)
            jproof = J.LcEvalProof(
                rp.n_cols, p_eval=rp.p_eval, p_random_vec=rp.p_random_vec,
                columns=[J.core.protocol.LcColumn(col_mont=jops.encode_host(c.col),
                                                  path=c.path) for c in rp.columns])
        self.jproof_bytes = jwire.serialize_proof(self.jspec, jproof)

    def tr(self, pkg, enc, root):
        return _transcript(pkg.Transcript, self.label, enc, root)

    def want(self):
        return P.univariate_eval(self.spec, self.coeffs, self.x)

    def port_verify(self, data, root=None, outer=None):
        root = self.root if root is None else root
        pf = P.wire.deserialize_proof(self.spec, data)
        return pf.verify(root, self.outer if outer is None else outer, self.inner,
                         self.enc, self.tr(P, self.enc, root))

    def jax_verify(self, data, root=None, outer=None):
        root = self.jroot if root is None else root
        pf = jwire.deserialize_proof(self.jspec, data)
        return pf.verify(root, self.outer if outer is None else outer, self.inner,
                         self.jenc, self.tr(J, self.jenc, root))


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ft63():
    return Case("ft63", 64, 8, 0, 7, b"lcpc port twin", jax_device_path=True)


@pytest.fixture(scope="module")
def ft255(golden):
    return Case(golden["field"], golden["n_per_row"], golden["n_rows"],
                golden["matrix_seed"], golden["coeff_seed"], golden["transcript"][0].encode(),
                jax_device_path=False)


@pytest.fixture(params=["ft63", "ft255"])
def case(request):
    return request.getfixturevalue(request.param)


def test_root_and_proof_bytes_identical(case):
    assert case.root == case.jroot
    assert case.proof_bytes == case.jproof_bytes
    assert case.comm.coeffs.device.type == "cpu"


def test_port_verifies_reference_proof(case):
    assert case.port_verify(case.jproof_bytes, root=case.jroot) == case.want()


def test_reference_verifies_port_proof_ft63(ft63):
    assert ft63.jax_verify(ft63.proof_bytes, root=ft63.root) == ft63.want()


def test_reference_verifies_port_proof_ft255(ft255):
    pf = jwire.deserialize_proof(ft255.jspec, ft255.proof_bytes)
    jops = j_get_ops(ft255.jspec)
    rp = ref.RefProof(pf.n_cols, pf.p_eval, pf.p_random_vec, [
        ref.RefColumn(col=jops.decode_host(c.col_mont), path=c.path)
        for c in pf.columns])
    got = ref.ref_verify(ft255.root, ft255.outer, ft255.inner, rp, ft255.jenc,
                         ft255.tr(J, ft255.jenc, ft255.root))
    assert got == ft255.want()


def test_golden_fixture(ft255, golden):
    assert ft255.root.hex() == golden["root"]
    assert len(ft255.proof_bytes) == golden["proof_bytes"]
    assert hashlib.sha256(ft255.proof_bytes).hexdigest() == golden["proof_sha256"]
    assert hashlib.sha256(ft255.jproof_bytes).hexdigest() == golden["proof_sha256"]
    assert hex(ft255.want()) == golden["eval"]


def _tampered(case, what):
    pf = P.wire.deserialize_proof(case.spec, case.proof_bytes)
    if what == "column":
        pf.columns[0].col_mont[0, 0] ^= 1
    elif what == "path":
        pf.columns[3].path[1] = bytes(32)
    elif what == "count":
        pf.columns = pf.columns[:-1]
    elif what == "short_row":  # valid input: zero-padded and encoded
        pf.p_random_vec[0] = pf.p_random_vec[0][:-1]
    return P.wire.serialize_proof(case.spec, pf)


@pytest.mark.parametrize("what,kind", [("column", "ColumnDegree"),
                                       ("path", "ColumnPath"),
                                       ("count", "NumColOpens"),
                                       ("short_row", "ColumnDegree")])
def test_tampered_proof_kinds_match_reference(ft63, what, kind):
    data = _tampered(ft63, what)
    with pytest.raises(P.VerifierError) as ours:
        ft63.port_verify(data)
    with pytest.raises(J.VerifierError) as theirs:
        ft63.jax_verify(data)
    assert ours.value.kind == theirs.value.kind == kind


def test_wrong_point_kinds_match_reference(ft63):
    bad = list(ft63.outer)
    bad[0] = (bad[0] + 1) % ft63.spec.p
    with pytest.raises(P.VerifierError) as ours:
        ft63.port_verify(ft63.proof_bytes, outer=bad)
    with pytest.raises(J.VerifierError) as theirs:
        ft63.jax_verify(ft63.proof_bytes, outer=bad)
    assert ours.value.kind == theirs.value.kind == "ColumnEval"


@pytest.mark.parametrize("what,kind", [("column", "ColumnDegree"),
                                       ("path", "ColumnPath")])
def test_tampered_proof_kinds_ft255(ft255, what, kind):
    with pytest.raises(P.VerifierError) as ours:
        ft255.port_verify(_tampered(ft255, what))
    assert ours.value.kind == kind


def test_commit_state_crosses_from_reference(ft63):
    jc = ft63.jcomm
    comm = convert.commit_from_numpy(np.asarray(jc.coeffs), np.asarray(jc.comm),
                                     jc.hashes, enc=ft63.enc)
    assert comm.get_root() == ft63.root
    pf = comm.prove(ft63.outer, ft63.tr(P, ft63.enc, comm.get_root()))
    assert P.wire.serialize_proof(ft63.spec, pf) == ft63.proof_bytes


def test_commit_wire_matches_reference(ft63):
    data = P.wire.serialize_commit(ft63.spec, ft63.comm)
    assert data == jwire.serialize_commit(ft63.jspec, ft63.jcomm)
    back = P.wire.deserialize_commit(ft63.spec, data, ft63.enc)
    assert back.get_root() == ft63.root
    assert P.wire.serialize_root(ft63.root) == jwire.serialize_root(ft63.jroot)
    assert P.wire.deserialize_root(P.wire.serialize_root(ft63.root)) == ft63.root
    assert P.wire.proof_size_bytes(ft63.spec, ft63.proof) == len(ft63.proof_bytes)


@pytest.mark.parametrize("cut", ["truncated", "trailing"])
def test_malformed_wire_bytes_raise(ft255, cut):
    data = ft255.proof_bytes[:-7] if cut == "truncated" else ft255.proof_bytes + b"\0"
    with pytest.raises(ValueError):
        P.wire.deserialize_proof(ft255.spec, data)
    with pytest.raises(ValueError):
        P.wire.deserialize_root(P.wire.serialize_root(ft255.root)[:-1])
