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

import jax
import numpy as np
import pytest
import torch

import lcpc_tpu as J
from lcpc_tpu.core import reference_impl as ref
from lcpc_tpu.core import wire as jwire
from lcpc_tpu.core.protocol import merkle_paths as j_merkle_paths
from lcpc_tpu.ops import blake3_jax
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
import lcpc_tpu_torch as P
from lcpc_tpu_torch import convert
from lcpc_tpu_torch.ops import blake3 as b3
from lcpc_tpu_torch.utils.tensors import seeded_values

torch.set_num_threads(1)  # the xdist workers share the cores

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


_j_merkle_parent = jax.jit(blake3_jax.merkle_parent)  # one executable for every level


@pytest.mark.parametrize("dedup", ["position", "value"])
def test_merkle_walk_vs_reference_paths(dedup):
    # the verifier's sibling table, built as verify builds it, from the
    # paths lcpc_tpu's merkle_paths opens (protocol.py:528); opened columns
    # repeat; one walk reaches the root from every column
    rng = np.random.default_rng(12)
    n_cols, np2, path_len = 13, 16, 4
    leaves = torch.from_numpy(rng.integers(0, 2**32, size=(8, n_cols), dtype=np.uint32)
                              .astype(np.int64))
    flat = b3.merkle_tree(leaves, np2)
    cols = [int(c) for c in rng.integers(0, n_cols, size=9)] + [4, 4, n_cols - 1]
    paths = j_merkle_paths(b3.digests_to_bytes(flat), n_cols, cols)
    nodes = np.frombuffer(b"".join(h for p in paths for h in p), np.uint8).reshape(-1, 32)
    if dedup == "position":
        pos = P.core.protocol.path_node_indices(n_cols, cols).reshape(-1)
        _, first, inv = np.unique(pos, return_index=True, return_inverse=True)
        uniq = nodes[first]
    else:
        uniq_v, inv = np.unique(nodes.view([("v", "V32")]).reshape(-1), return_inverse=True)
        uniq = np.ascontiguousarray(uniq_v.view(np.uint8)).reshape(-1, 32)
    inv = torch.from_numpy(np.ascontiguousarray(inv.reshape(len(cols), path_len).T)
                           .astype(np.int64))
    sibs = torch.from_numpy(b3.bytes_to_digests(uniq).astype(np.int64))
    idx = torch.tensor(cols, dtype=torch.int64)
    digs = flat.index_select(1, idx)
    got = b3.merkle_walk(digs, sibs, inv, idx)
    assert torch.equal(got, flat[:, -1:].expand(8, len(cols)))
    # the per-level loop it replaces, through the plain parent and through
    # lcpc_tpu's merkle_parent
    loop, jloop = digs, digs.numpy().astype(np.uint32)
    for lvl in range(path_len):
        s = sibs.index_select(1, inv[lvl])
        right = ((idx >> lvl) & 1).bool()
        loop = b3.merkle_parent_plain(torch.where(right, s, loop), torch.where(right, loop, s))
        sj, rj = s.numpy().astype(np.uint32), right.numpy()
        jloop = np.asarray(_j_merkle_parent(np.where(rj, sj, jloop), np.where(rj, jloop, sj)))
    assert torch.equal(got, loop) and np.array_equal(got.numpy(), jloop)
    # the verifier's form: the root compared in the walk, the flag kept
    root = flat[:, -1].clone()
    flag = torch.ones(1, dtype=torch.int32)
    assert b3.merkle_walk(digs, sibs, inv, idx, root=root, flag=flag) is None
    assert int(flag) == 1
    # a wrong sibling at the first, a middle and the last level no longer
    # reaches the root, in either form
    for lvl in (0, 2, path_len - 1):
        at = int(inv[lvl, 0])
        sibs[0, at] ^= 1
        assert not torch.equal(b3.merkle_walk(digs, sibs, inv, idx)[:, 0], flat[:, -1])
        b3.merkle_walk(digs, sibs, inv, idx, root=root, flag=flag)
        assert int(flag) == 0, lvl
        sibs[0, at] ^= 1
        flag.fill_(1)
    # and a wrong digest
    digs[3, 0] ^= 1 << 31
    b3.merkle_walk(digs, sibs, inv, idx, root=root, flag=flag)
    assert int(flag) == 0


def test_verify_columns_route_accepts_and_rejects_alike(monkeypatch):
    """Ligero ft127 (a field the direct verifier serves): verify's columns
    route (the proof rows evaluated at the opened columns alone,
    _verify_core_cols, taken here by lowering lcpc_tpu's 2^17-column gate)
    and the encode route return the same evaluation on the honest proof and
    the same VerifierError kind on each tampered one, unreduced column
    words included."""
    from lcpc_tpu_torch.core import protocol

    spec = P.FT127
    enc = P.LigeroEncoding.new_from_dims(spec, 32, 128, 1, 4, device="cpu")
    vals = seeded_values(spec.p, spec.w16, 32 * 40 + 1, 17)
    coeffs, x = vals[:-1], vals[-1]
    comm = P.commit(coeffs, enc)
    root = comm.get_root()
    outer, inner = P.univariate_tensors(spec, x, 32, comm.n_rows)
    tr = lambda: _transcript(P.Transcript, b"lcpc port columns", enc, root)  # noqa: E731
    data = P.wire.serialize_proof(spec, comm.prove(outer, tr()))
    cols_calls = []
    core_cols = protocol._verify_core_cols
    monkeypatch.setattr(protocol, "_verify_core_cols",
                        lambda *a: (cols_calls.append(1), core_cols(*a))[1])

    def flip(pf):
        pf.columns[0].col_mont[0, 0] ^= 1

    def unreduced(pf):
        pf.columns[3].col_mont[:, :] = 0xFFFF

    def path(pf):
        pf.columns[5].path[2] = bytes(32)

    def p_eval(pf):
        pf.p_eval[0] = (pf.p_eval[0] + 1) % spec.p

    def p_random(pf):
        pf.p_random_vec[0][7] = (pf.p_random_vec[0][7] + 1) % spec.p

    results = {}
    for name, mutate in (("honest", lambda pf: None), ("flip", flip), ("unreduced", unreduced),
                         ("path", path), ("p_eval", p_eval), ("p_random", p_random)):
        got = []
        for gate in (0, 1 << 30):
            monkeypatch.setattr(protocol, "VERIFY_COLS_MIN", gate)
            pf = P.wire.deserialize_proof(spec, data)
            mutate(pf)
            n = len(cols_calls)
            try:
                got.append(pf.verify(root, outer, inner, enc, tr()))
            except P.VerifierError as e:
                got.append(e.kind)
            assert len(cols_calls) - n == (1 if gate == 0 else 0)
        assert got[0] == got[1], name
        results[name] = got[0]
    assert results["honest"] == P.univariate_eval(spec, coeffs, x)
    assert results["flip"] == results["unreduced"] == "ColumnDegree"
    assert results["path"] == "ColumnPath"
    assert results["p_eval"] != results["honest"] and results["p_random"] != results["honest"]


def test_multilinear_tensors_and_eval_match_reference():
    """multilinear_tensors / multilinear_eval against lcpc_tpu's, and the
    2-D evaluation <outer (x) inner, coeffs> equals multilinear_eval."""
    spec, jspec = P.FT63, J.FT63
    vals = seeded_values(spec.p, spec.w16, 64 + 6, 21)
    coeffs, point = vals[:64], vals[64:]
    outer, inner = P.multilinear_tensors(spec, point, 8, 8)
    assert (outer, inner) == J.multilinear_tensors(jspec, point, 8, 8)
    value = P.multilinear_eval(spec, coeffs, point)
    assert value == J.multilinear_eval(jspec, coeffs, point)
    assert value == sum(outer[r] * inner[c] * coeffs[8 * r + c]
                        for r in range(8) for c in range(8)) % spec.p
    with pytest.raises(ValueError):
        P.multilinear_tensors(spec, point, 16, 8)
