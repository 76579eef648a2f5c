"""The port's sharded paths (lcpc_tpu_torch/parallel) on the CPU: gloo ranks
at world sizes 2 and 4, each a process of tests/torch_parallel_ranks.py
(device="cpu", torch.set_num_threads(1)), one spawn for each world size
serving every case.  What the cases compare with (the spawns' results,
lcpc_tpu's bytes, the port's single-device bytes) is computed once a test
run: the first xdist worker to need it computes it under a file lock in
$TMPDIR, the others read its pickle.

- The seven regimes of MULTICHIP_r05.json at ft63, one case a rank: its
  root, Merkle array and proof bytes equal lcpc_tpu's device path and its
  parallel path on the 8-device virtual CPU mesh (tests/conftest.py); the
  proof verifies under the port's verify and lcpc_tpu's
  (cross-verification both ways).
- Edge cases at ft63 and ft255, one case a rank (rows that do not divide
  the ranks, Brakedown's ragged columns, fewer rows than ranks where
  "auto" picks the wide strategy, streaming row blocks): bytes equal the
  port's single-device commit and prove, and the serial twin's (the port's
  core/reference_impl.py, held to lcpc_tpu's ref_commit, ref_prove and
  ref_verify); no lcpc_tpu ft255 jit.
- DistNtt's limbs and words in every field against the port's
  ntt_forward_plain (and lcpc_tpu's DistNtt at ft63 on 4 devices); the
  sharded collapse on values near p and on all-0xFFFF limbs against Python
  ints (and lcpc_tpu's at ft63).
- encode_rows_lowmem against encode_rows; the NTT plans' twiddle tables and
  mont_powers against the host powers; the meshes; the refusals.
Tolerance 0 everywhere: exact field arithmetic and hashing.
"""

import fcntl
import functools
import os
import pickle
import subprocess
import sys
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

import lcpc_tpu as J
from lcpc_tpu.core import reference_impl as jref
from lcpc_tpu.core import wire as jwire
from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops.digest import DIGESTS_BY_NAME as J_DIGESTS
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu.parallel import mesh_protocol as jmp
from lcpc_tpu.parallel import mesh_streaming as jms
from lcpc_tpu.parallel.dist_ntt import DistNtt as JDistNtt
import lcpc_tpu_torch as P
from lcpc_tpu_torch.core import reference_impl as ref
from lcpc_tpu_torch.ops import ntt
from lcpc_tpu_torch.ops.limbs import get_ops, pack_row_words
from lcpc_tpu_torch.ops.spmv import pack_words
from lcpc_tpu_torch.parallel import mesh_protocol, mesh_streaming, multihost
from lcpc_tpu_torch.parallel.comm import Comm
from lcpc_tpu_torch.parallel.dist_ntt import DistNtt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

torch.set_num_threads(1)  # the xdist workers share the cores

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RANKS = [(w, r) for w in WORLDS for r in range(w)]


# ---- what the cases share: computed once a test run --------------------------------


def _shared(key: str, make):
    """make()'s value, computed by the first process of this test run that
    asks for `key` (under a file lock) and read from its pickle by the rest."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", f"pid{os.getpid()}")
    d = os.path.join(tempfile.gettempdir(), f"lcpc_torch_parallel_{run}")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{key}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            with open(path + ".tmp", "wb") as f:
                pickle.dump(make(), f)
            os.replace(path + ".tmp", path)
    with open(path, "rb") as f:
        return pickle.load(f)


def _spawn(world: int) -> list:
    """Run `world` gloo ranks to their end; their results, by rank."""
    port = multihost.free_port()
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
               LOCAL_WORLD_SIZE=str(world // 2))  # make_hybrid_mesh: 2 hosts
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.pkl") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, R.__file__, str(world), str(r), str(port),
                                   out], env=env, stderr=subprocess.PIPE, text=True)
                 for r, out in enumerate(outs)]
        try:
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    return results


@functools.lru_cache(maxsize=None)
def ranks(world: int) -> list:
    """Every rank's results at `world` ranks (one spawn a test run)."""
    return _shared(f"world{world}", lambda: _spawn(world))


def _bytes(rec) -> tuple:
    return rec["root"], rec["hashes"], rec["proof"]


# ---- the two packages on one case ---------------------------------------------------


class Both:
    """One case in both packages: the port's encoding on the CPU, lcpc_tpu's,
    the inputs and the evaluation."""

    def __init__(self, case):
        self.case = case
        self.spec, self.jspec = R.field(P, case.field), J_FIELDS[case.field]
        self.enc = R.make_enc(P, self.spec, case.enc, device="cpu")
        self.jenc = R.make_enc(J, self.jspec, case.enc)
        self.coeffs, self.x, self.outer, self.inner = R.inputs(P, self.spec, case, self.enc)
        self.digest, self.jdigest = P.DIGESTS_BY_NAME[case.digest], J_DIGESTS[case.digest]
        self.want = P.univariate_eval(self.spec, self.coeffs, self.x)

    def port_single(self) -> tuple:
        """(root, Merkle array digest, proof bytes) of the port's single-device path."""
        comm = P.commit(self.coeffs, self.enc, digest=self.digest)
        proof = comm.prove(self.outer, R.transcript(P, self.enc, comm.get_root()))
        return (comm.get_root(), R.hashes_digest(comm.hashes),
                P.wire.serialize_proof(self.spec, proof))

    def jax_bytes(self) -> dict:
        """lcpc_tpu's (root, Merkle array digest, proof bytes): its device
        path and its parallel path on the 8-device virtual CPU mesh."""
        case, out = self.case, {}
        serial = J.commit(self.coeffs, self.jenc, digest=self.jdigest)
        mesh = jmp.make_mesh(jax.devices()[:8])
        if case.path == "streaming":
            sh = jms.sharded_commit_streaming(self.coeffs, self.jenc, mesh,
                                              row_block=case.row_block, digest=self.jdigest)
        else:
            sh = jmp.sharded_commit(self.coeffs, self.jenc, mesh, digest=self.jdigest,
                                    strategy=case.strategy)
        for key, comm in (("serial", serial), ("mesh", sh)):
            root = comm.get_root()
            proof = comm.prove(self.outer, R.transcript(J, self.jenc, root))
            out[key] = (root, R.hashes_digest(np.asarray(comm.hashes)),
                        jwire.serialize_proof(self.jspec, proof))
        return out

    def port_verify(self, root, data) -> int:
        pf = P.wire.deserialize_proof(self.spec, data)
        return pf.verify(root, self.outer, self.inner, self.enc,
                         R.transcript(P, self.enc, root), self.digest)

    def jax_verify(self, root, data) -> int:
        pf = jwire.deserialize_proof(self.jspec, data)
        return pf.verify(root, self.outer, self.inner, self.jenc,
                         R.transcript(J, self.jenc, root), self.jdigest)


@functools.lru_cache(maxsize=None)
def _regime(name: str) -> Both:
    return Both(R.REGIMES[name])


@functools.lru_cache(maxsize=None)
def _jax(name: str) -> dict:
    return _shared(f"jax-{name}", _regime(name).jax_bytes)


# ---- the regimes --------------------------------------------------------------------


@pytest.mark.parametrize("world,rank", RANKS, ids=[f"w{w}r{r}" for w, r in RANKS])
@pytest.mark.parametrize("name", list(R.REGIMES))
def test_regime_bytes_equal_lcpc_tpu(name, world, rank):
    got = ranks(world)[rank]["cases"][name]
    want = _jax(name)
    assert _bytes(got) == want["serial"] == want["mesh"]
    assert got["strategy"] == ("wide" if name == "ligero-wide" else "rows")
    if R.REGIMES[name].path == "streaming":  # several row blocks streamed
        assert got["row_block"] % world == 0 and got["row_block"] < got["n_rows"]
    if rank == 0:
        b = _regime(name)
        assert b.port_verify(got["root"], got["proof"]) == b.want


@pytest.mark.parametrize("name", ["ligero", "brakedown"])
def test_cross_verification(name):
    # the port's sharded proof under lcpc_tpu's verify, lcpc_tpu's sharded
    # proof under the port's
    b = _regime(name)
    got = ranks(2)[0]["cases"][name]
    assert b.jax_verify(got["root"], got["proof"]) == b.want
    root, _, data = _jax(name)["mesh"]
    assert b.port_verify(root, data) == b.want


# ---- edge cases against the port's single-device path and the serial twins -------------


def _ref_proofs_equal(a, b) -> bool:
    """Two RefProofs (of the two packages' serial twins) hold the same values."""
    return (a.n_cols == b.n_cols and a.p_eval == b.p_eval and a.p_random_vec == b.p_random_vec
            and [(c.col, c.path) for c in a.columns] == [(c.col, c.path) for c in b.columns])


def _twin_check(b: Both, root: bytes, data: bytes) -> None:
    """The serial twins (BLAKE3): the port's against lcpc_tpu's, and the
    port's sharded root and proof against them."""
    rc, jrc = ref.ref_commit(b.coeffs, b.enc), jref.ref_commit(b.coeffs, b.jenc)
    assert rc.hashes == jrc.hashes and rc.get_root() == root
    rp = ref.ref_prove(rc, b.outer, b.enc, R.transcript(P, b.enc, root))
    jrp = jref.ref_prove(jrc, b.outer, b.jenc, R.transcript(J, b.jenc, root))
    assert _ref_proofs_equal(rp, jrp)
    pf = P.wire.deserialize_proof(b.spec, data)
    ops = get_ops(b.spec)
    assert pf.p_eval == rp.p_eval and pf.p_random_vec == rp.p_random_vec
    assert [ops.decode_host(c.col_mont) for c in pf.columns] == [c.col for c in rp.columns]
    assert [c.path for c in pf.columns] == [c.path for c in rp.columns]
    assert ref.ref_verify(root, b.outer, b.inner, rp, b.enc,
                          R.transcript(P, b.enc, root)) == b.want
    assert jref.ref_verify(root, b.outer, b.inner, jrp, b.jenc,
                           R.transcript(J, b.jenc, root)) == b.want


@functools.lru_cache(maxsize=None)
def _edge(name: str, world: int) -> Both:
    return Both(R.edges(world)[name])


@functools.lru_cache(maxsize=None)
def _edge_single(name: str, world: int) -> tuple:
    return _shared(f"single-{name}-{world}", _edge(name, world).port_single)


@pytest.mark.parametrize("world,rank", RANKS, ids=[f"w{w}r{r}" for w, r in RANKS])
@pytest.mark.parametrize("name", list(R.edges(2)))
def test_edge_bytes_equal_single_device_and_serial_twin(name, world, rank):
    got = ranks(world)[rank]["cases"][name]
    assert _bytes(got) == _edge_single(name, world)
    wide = name == "auto-wide" or (name == "ft255-ligero" and world == 4)
    assert got["strategy"] == ("wide" if wide else "rows")
    if rank == 0:
        b = _edge(name, world)
        _twin_check(b, got["root"], got["proof"])
        assert b.port_verify(got["root"], got["proof"]) == b.want


# ---- DistNtt and the sharded collapse ------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fname", list(R.DIST_NTT))
def test_dist_ntt_limbs(fname, world):
    _, n, rows, seed = R.DIST_NTT[fname]
    spec = R.field(P, fname)
    x = R.seeded_limbs(spec, (rows, n), seed)  # (W, rows, n)
    got = [r["dist_ntt"][fname] for r in ranks(world)]
    limbs = np.concatenate([g["limbs"] for g in got], axis=2).reshape(spec.w16, rows, n)
    words = np.concatenate([g["words"] for g in got], axis=1)
    plan = ntt.get_ntt(spec, n)
    xt = torch.from_numpy(x.astype(np.int32))
    assert np.array_equal(limbs, ntt.ntt_forward_plain(plan, xt).numpy())
    assert np.array_equal(words, ntt.ntt_forward(plan, xt, output="words").numpy())
    ops = get_ops(spec)
    rows_ints = np.asarray(ops.decode_host(x), dtype=object).reshape(rows, n).tolist()
    assert np.asarray(ops.decode_host(limbs), dtype=object).reshape(rows, n).tolist() == \
        [ntt.ntt_host(spec, r) for r in rows_ints]
    if fname == "ft63":  # lcpc_tpu's DistNtt on 4 devices (tests/test_parallel.py's mesh)
        mesh = jmp.make_mesh(jax.devices()[:4], axis="c")
        jdn = JDistNtt(J_FIELDS[fname], n, mesh, axis="c")
        jgot = np.asarray(jdn(jdn.shard_input(x))).reshape(spec.w16, rows, n)
        assert np.array_equal(limbs.astype(np.uint32), jgot)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(R.COLLAPSE))
def test_sharded_collapse_is_modular(kind, world):
    fname, rows, cols, t, operands = R.COLLAPSE[kind]
    spec = R.field(P, fname)
    mat, ts = R.collapse_operands(spec, rows, cols, t, operands)
    got = [r["collapse"][kind] for r in ranks(world)]
    for g in got[1:]:
        assert np.array_equal(g, got[0])
    words = got[0]  # (T, cols, W/2) canonical words
    vals = np.asarray(get_ops(spec).decode_host(mat, from_mont=False),
                      dtype=object).reshape(rows, cols)
    r_inv = pow(spec.R, -1, spec.p)
    for j in range(t):
        want = [sum(ts[j][r] * int(vals[r, c]) for r in range(rows)) * r_inv % spec.p
                for c in range(cols)]
        have = [int.from_bytes(words[j, c].astype("<u4").tobytes(), "little")
                for c in range(cols)]
        assert have == want
    if kind == "near-p":  # lcpc_tpu's sharded collapse (tests/test_parallel.py's shapes)
        from jax.sharding import NamedSharding, PartitionSpec as JP

        jspec = J_FIELDS[fname]
        jenc = J.LigeroEncoding.new_from_dims(jspec, cols, 2 * cols)
        mesh = jmp.make_mesh(jax.devices()[:4], axis="r")
        jts = j_get_ops(jspec).encode_host(ts[0])[:, None, :]
        mat_sh = jax.device_put(mat, NamedSharding(mesh, JP(None, "r", None)))
        ts_sh = jax.device_put(jts, NamedSharding(mesh, JP(None, None, "r")))
        jwords = np.asarray(jmp._build_collapse_fn(jenc, mesh)(ts_sh, mat_sh))
        assert np.array_equal(jwords, words)


# ---- encode_rows_lowmem, the twiddle tables, the meshes, the refusals -------------------


@pytest.mark.parametrize("enc_kind", ["ligero", "sdig"])
@pytest.mark.parametrize("spec", P.ALL_FIELDS, ids=lambda s: s.name)
def test_encode_rows_lowmem_equals_encode_rows(spec, enc_kind):
    desc = ("ligero", 16, 64, 1, 4) if enc_kind == "ligero" else ("sdig", 64, 3)
    enc = R.make_enc(P, spec, desc, device="cpu")
    rows = torch.from_numpy(R.seeded_limbs(spec, (5, enc.n_per_row), 7).astype(np.int32))
    rows[:, 0] = torch.from_numpy(get_ops(spec).encode_host([spec.p - 1] * enc.n_per_row)
                                  .astype(np.int32))
    limbs = enc.encode_rows(rows)
    canon = get_ops(spec).from_mont_plain(limbs)
    assert torch.equal(enc.encode_rows_lowmem(rows), limbs)
    assert torch.equal(enc.encode_rows_lowmem(rows, canonical=True), canon)
    packed = enc.encode_rows_lowmem(rows, post=pack_row_words, canonical=True)
    assert torch.equal(packed, pack_row_words(canon))
    assert torch.equal(packed, enc.encode_rows_words(rows)[1])
    tail = lambda t: t[:, :, -3:]  # noqa: E731
    assert torch.equal(enc.encode_rows_lowmem(rows, post=tail), limbs[:, :, -3:])


@pytest.mark.parametrize("spec", P.ALL_FIELDS, ids=lambda s: s.name)
def test_twiddle_tables_built_by_doubling(spec):
    # the kernel's table (mont_powers through the mont_map plain version
    # here, the kernel on the card) equals the host powers for n <= 2^12
    w32 = spec.w16 // 2
    for log_n in range(1, 13):
        plan = ntt.NttPlan(spec, 1 << log_n)
        tw, _ = plan.kernel_table("cpu")
        host = np.concatenate(plan.stage_twiddles[::-1], axis=1)  # m = 1, 2, .., n/2
        want = pack_words(torch.from_numpy(host.astype(np.int32)), 0).T
        assert tw.shape == ((1 << log_n) - 1, w32) and torch.equal(tw, want), log_n
    # DistNtt's rows: powers of several bases from an offset
    bases, m, off = [3, spec.p - 2, pow(7, 11, spec.p)], 37, 5
    got = ntt.mont_powers(spec, bases, m, "cpu", offset=off)
    want = [[spec.to_mont(pow(b, off + j, spec.p)) for j in range(m)] for b in bases]
    words = got.numpy().astype(np.int64) & 0xFFFFFFFF
    have = [[sum(int(words[i, k, j]) << (32 * i) for i in range(w32)) for j in range(m)]
            for k in range(len(bases))]
    assert have == want


@pytest.mark.parametrize("world", WORLDS)
def test_meshes(world):
    # every rank: a gloo group, the 1-D mesh, the (hosts, local) mesh with
    # LOCAL_WORLD_SIZE = world / 2, and collectives called on every path
    per_host = world // 2
    for r in ranks(world):
        assert r["backend"] == "gloo" and r["mesh"] == (world,) and r["hybrid"] == (2, per_host)
        host = r["rank"] // per_host
        assert r["hybrid_groups"]["r"] == list(range(host * per_host, (host + 1) * per_host))
        assert r["hybrid_groups"]["h"] == list(range(r["rank"] % per_host, world, per_host))
        assert r["comm_calls"]["exchange"] > 0 and r["comm_calls"]["gather"] > 0


_LIG = functools.partial(R.make_enc, P, P.FT63, ("ligero", 16, 64), device="cpu")
_REFUSALS = {
    # no GPU: the default device raises; nothing falls back to the CPU
    "initialize-without-gpu": (RuntimeError, lambda: multihost.initialize()),
    "nccl-on-cpu": (ValueError, lambda: multihost.initialize(device="cpu", backend="nccl")),
    "comm-before-initialize": (RuntimeError, lambda: Comm()),
    "unknown-strategy": (ValueError, lambda: mesh_protocol._pick_wide(_LIG(), "cols", 4, 2)),
    "wide-brakedown": (ValueError, lambda: mesh_protocol._pick_wide(
        R.make_enc(P, P.FT63, ("sdig", 64, 3), device="cpu"), "wide", 1, 2)),
    "wide-indivisible": (ValueError, lambda: mesh_protocol._pick_wide(_LIG(), "wide", 1, 3)),
    "dist-ntt-size": (ValueError, lambda: DistNtt(P.FT63, 2, device="cpu")),
    "shard-indivisible": (ValueError, lambda: multihost.local_shard(torch.zeros(5), 0, 0, 2)),
    "streaming-digest": (ValueError, lambda: mesh_streaming.sharded_commit_streaming(
        [1, 2, 3], _LIG(), digest=types.SimpleNamespace(name="md5"))),
}


@pytest.mark.parametrize("name", list(_REFUSALS))
def test_refusals(name):
    exc, call = _REFUSALS[name]
    with pytest.raises(exc):
        call()
