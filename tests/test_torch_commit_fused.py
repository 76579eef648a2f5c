"""The small commit's routes (core/protocol.py: `_commit_fused_fn`, one
launch of csrc/commit_small.cu, against `_commit_staged`) and the inverse
NTT's FFT identity, in the port on the CPU against lcpc_tpu.

- small commits byte-equal to lcpc_tpu's `commit` on both sides of its gate
  (its `_commit_fused_fn` below `_FUSED_COMMIT_MAX`, its staged path above,
  the gate lowered to reach it), Ligero and Brakedown at ft63, BLAKE3 and
  SHA-256; the port's CPU commits stay on the staged plain path whatever
  its gate says, and the kernel's plain version (ops/commit_small.py's
  commit_small_plain) gives lcpc_tpu's bytes on both sides too;
- the kernel route's Python side: each encoding's gate picks the route
  (the limbs stood in for a card's), the wrapper's refusals (a CPU, meta or
  other card's tensor, no coefficients), the NTT passes the kernel runs
  against the plain ladder's pass arithmetic, Brakedown's level table
  against encode_rows' levels, the scratch layout.  The kernel itself runs
  only on the card (chip_smoke.py phase 18);
- the reference's FFT-consistency identity (lcpc-2d/src/tests.rs:194-236;
  lcpc_tpu's tests/test_ntt.py::test_fft_consistency_identity) in the port:
  the encoded matrix collapsed by the outer tensor (mont_dot's plain
  version) and inverse-transformed gives the collapsed coefficient rows,
  zeros above n_per_row.
Tolerance 0 throughout: exact field arithmetic and hashes."""

import numpy as np
import pytest
import torch

import lcpc_tpu as J
from lcpc_tpu.core import protocol as jproto
from lcpc_tpu.ops.digest import DIGESTS_BY_NAME as J_DIGESTS
import lcpc_tpu_torch as P
from lcpc_tpu_torch.core import protocol as proto
from lcpc_tpu_torch.ops import commit_small, ntt
from lcpc_tpu_torch.ops.limbs import get_ops
from lcpc_tpu_torch.ops.mont_dot import mont_dot
from lcpc_tpu_torch.ops.spmv import unpack_words
from lcpc_tpu_torch.utils.tensors import seeded_values

torch.set_num_threads(1)  # the xdist workers share the cores


def _encodings(name):
    """(port encoding on the CPU, lcpc_tpu's, coefficient count): Ligero
    rho = 1/4 at 300 coefficients, Brakedown 64 x 8 less 3 (a padded row)."""
    if name == "ligero":
        return (P.LigeroEncoding.new(P.FT63, 300, 1, 4, device="cpu"),
                J.LigeroEncoding.new(J.FT63, 300, 1, 4), 300)
    return (P.SdigEncoding(P.FT63, 64, seed=3, device="cpu"),
            J.SdigEncoding(J.FT63, 64, seed=3), 64 * 8 - 3)


@pytest.mark.parametrize("name", ["ligero", "sdig"])
def test_small_commit_matches_reference_both_sides_of_gate(name, monkeypatch):
    enc, jenc, length = _encodings(name)
    coeffs = seeded_values(P.FT63.p, P.FT63.w16, length, 11)

    def no_kernel(*a):
        raise AssertionError("a CPU commit reached the kernel route")

    monkeypatch.setattr(proto, "_commit_fused_fn", no_kernel)
    n_rows, _, n_cols = enc.get_dims(length)
    assert n_rows * n_cols <= jproto._FUSED_COMMIT_MAX  # lcpc_tpu fuses this size
    for digest in ("blake3", "sha256"):
        comms = []
        for gate in (1 << 40, 0):  # under both packages' gates, then over them
            monkeypatch.setattr(proto, "_FUSED_COMMIT_MAX",
                                {k: gate for k in ("LigeroEncoding", "SdigEncoding")})
            monkeypatch.setattr(jproto, "_FUSED_COMMIT_MAX", gate)
            comm = P.commit(coeffs, enc, digest=P.DIGESTS_BY_NAME[digest])
            jcomm = J.commit(coeffs, jenc, digest=J_DIGESTS[digest])
            assert comm.get_root() == jcomm.get_root(), (digest, gate)
            mat, cw, flat = commit_small.commit_small_plain(
                enc, P.DIGESTS_BY_NAME[digest], proto.coeff_limbs(coeffs, enc))
            for mine, plain, theirs in ((comm.hashes_dev, flat, jcomm.hashes_dev),
                                        (comm.comm, cw, jcomm.comm),
                                        (comm.coeffs, mat, jcomm.coeffs)):
                for got in (mine, plain):
                    assert np.array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                                          np.asarray(theirs).astype(np.int64)), (digest, gate)
            comms.append(comm)
        assert comms[0].get_root() == comms[1].get_root()


class _CudaLimbs:
    """Stands for (W, N) int32 limbs on a card in the route's choice and the
    wrapper's checks; `t` is the CPU tensor it stands for."""

    def __init__(self, t, device="cuda:0"):
        self.t, self.shape, self.dtype = t, t.shape, t.dtype
        self.device = torch.device(device)

    def dim(self):
        return self.t.dim()


def test_commit_small_route_and_plain(monkeypatch):
    # the gates: lcpc_tpu's 2^22 the ceiling, every encoding with a kernel listed
    assert set(proto._FUSED_COMMIT_MAX) == {"LigeroEncoding", "SdigEncoding"}
    assert all(0 < v <= jproto._FUSED_COMMIT_MAX for v in proto._FUSED_COMMIT_MAX.values())
    routes = []

    def fused_fn(enc, digest):
        def run(arr):
            routes.append("fused")
            return commit_small.commit_small_plain(enc, digest, arr.t)
        return run

    def staged(enc, digest, arr):
        routes.append("staged")
        return staged0(enc, digest, arr.t if isinstance(arr, _CudaLimbs) else arr)

    staged0 = proto._commit_staged
    monkeypatch.setattr(proto, "_commit_fused_fn", fused_fn)
    monkeypatch.setattr(proto, "_commit_staged", staged)
    for name in ("ligero", "sdig"):
        enc, _, length = _encodings(name)
        coeffs = seeded_values(P.FT63.p, P.FT63.w16, length, 5)
        arr = proto.coeff_limbs(coeffs, enc)
        n_rows, _, n_cols = enc.get_dims(length)
        for gate, want in ((n_rows * n_cols, "fused"), (n_rows * n_cols - 1, "staged")):
            monkeypatch.setattr(proto, "_FUSED_COMMIT_MAX", {type(enc).__name__: gate})
            with monkeypatch.context() as m:  # the limbs as if on the card
                m.setattr(proto, "coeff_limbs", lambda c, e: _CudaLimbs(arr))
                routes.clear()
                got = P.commit(coeffs, enc)
            assert routes == [want], (name, gate, routes)
            routes.clear()
            cpu = P.commit(coeffs, enc)  # a CPU commit: staged whatever the gate
            assert routes == ["staged"]
            assert got.get_root() == cpu.get_root() and torch.equal(got.comm, cpu.comm)
    monkeypatch.undo()
    # the wrapper: a CUDA tensor on the encoding's device or it raises
    enc = _encodings("ligero")[0]
    arr = proto.coeff_limbs(seeded_values(P.FT63.p, P.FT63.w16, 300, 6), enc)
    for bad, match in ((arr, "CUDA tensor"), (arr.to("meta"), "CUDA tensor"),
                       (_CudaLimbs(arr), "the encoding on cpu")):
        with pytest.raises(ValueError, match=match):
            proto._commit_fused_fn(enc, P.BLAKE3)(bad)
    far = P.LigeroEncoding.new(P.FT63, 300, 1, 4, device="cuda:1")
    with pytest.raises(ValueError, match="arr on cuda:0, the encoding on cuda:1"):
        proto._commit_fused_fn(far, P.BLAKE3)(_CudaLimbs(arr))
    with pytest.raises(ValueError, match="N >= 1"):
        proto._commit_fused_fn(far, P.BLAKE3)(_CudaLimbs(arr[:, :0], "cuda:1"))
    assert commit_small.commit_small.launches == 0
    # the NTT passes the kernel runs: every stage once, in order, each pass
    # a transform step the plain ladder takes pass by pass (its index
    # arithmetic: ntt_forward_passes_plain), tiles of at most 2^9 elements
    tl = commit_small.TILE_LOG
    for log_n in range(1, 24):
        passes = commit_small.fused_passes(log_n, 8)
        assert [s for ps in passes for s in range(ps.hi, ps.lo - 1, -1)] == \
            list(range(log_n - 1, -1, -1))
        assert all(ps.log_tile <= tl for ps in passes) and len(passes) <= 4
        assert min(log_n, tl) == passes[-1].log_tile
    for log_n in (3, 10, 12):
        spec = P.FT63
        kw = dict(log_chunk=tl, log_t=commit_small.fused_passes(log_n, 2)[0].log_t,
                  max_tile_bytes=(4 * 2) << tl)
        plan = ntt.NttPlan(spec, 1 << log_n, **kw)
        assert plan.passes == commit_small.fused_passes(log_n, 2)
        x = torch.from_numpy(get_ops(spec).encode_host(
            seeded_values(spec.p, spec.w16, 3 << log_n, log_n)).astype(np.int32))
        x = x.reshape(spec.w16, 3, 1 << log_n)[:, :, : (1 << log_n) - 5]
        assert torch.equal(ntt.ntt_forward_passes_plain(plan, x), ntt.ntt_forward_plain(plan, x))
    # Brakedown's level table: encode_rows' levels in order, each codeword
    # column written by one level (or the coefficients), the base case's
    # input past the codeword
    enc = _encodings("sdig")[0]
    tables = enc.device_tables()
    assert isinstance(tables, commit_small.LevelTable)
    table, positions, max_out = tables.table, tables.positions, tables.max_out
    assert enc.device_tables().table is table  # built once
    assert isinstance(_encodings("ligero")[0].device_tables(), commit_small.NttTables)
    pre, post, rs = enc.device_mats()
    levels = enc._levels(pre, post, rs)
    assert table[:, :5].tolist() == [[i, o, dm.n_out, dm.nnz, int(c)] for i, o, dm, c in levels]
    assert positions == enc.n_cols + pre[-1].n_out and max_out == int(table[:, 2].max())
    cover = np.zeros(positions, dtype=np.int64)
    cover[: enc.n_per_row] = 1
    for _, out, dm, _ in levels:
        cover[out : out + dm.n_out] += 1
    assert (cover == 1).all()
    assert [c for *_, c in levels].count(False) == 1 and levels[len(pre)][0] == enc.n_cols
    # the scratch layout: 16-byte aligned regions, chunk CVs only for BLAKE3
    # columns longer than a chunk
    lay = commit_small.scratch_layout(100, 32, 8, 1000, "blake3")  # 8 + 256 words
    assert lay.cvs is not None and all(v % 16 == 0 for v in (lay.words, lay.cvs, lay.leaves))
    assert lay.nbytes >= lay.leaves + 8 * 8 * 1000
    assert commit_small.scratch_layout(0, 32, 8, 1000, "sha256").cvs is None
    assert commit_small.scratch_layout(0, 31, 8, 1000, "blake3").cvs is None  # 8 + 248 words
    # the outputs in one allocation: comm, the int64 Merkle array, the padded
    # matrix, each on a 16-byte boundary, none overlapping
    for padded in (False, True):
        plan = commit_small._launch_plan(True, 3, 128, 512, 2, "blake3", 0, padded)
        assert plan.flat % 4 == 0 and plan.flat >= 4 * 3 * 512
        end = plan.flat + 16 * (2 * 512 - 1)
        assert (plan.mat is None) != padded and plan.out_words == (
            plan.mat + 4 * 3 * 128 if padded else end)
        assert not padded or (plan.mat % 4 == 0 and plan.mat >= end)


def test_fft_consistency_identity_ft63():
    spec = P.FT63
    ops = get_ops(spec)
    length = 300
    coeffs = seeded_values(spec.p, spec.w16, length + 1, 34)
    x, coeffs = coeffs[-1], coeffs[:-1]
    enc = P.LigeroEncoding.new(spec, length, device="cpu")
    comm = P.commit(coeffs, enc)
    outer, inner = P.univariate_tensors(spec, x, comm.n_per_row, comm.n_rows)
    outer_mont = torch.from_numpy(ops.encode_host(outer).astype(np.int32))[:, None, :]
    # the coefficient rows collapsed: their evaluation at x is the polynomial's
    flat = unpack_words(mont_dot(spec, outer_mont, comm.coeffs, "mont", x_form="limbs",
                                 y_form="limbs"), 0)
    flat_ints = ops.decode_host(flat[:, 0].numpy())
    assert sum(c * r for c, r in zip(flat_ints, inner)) % spec.p == \
        P.univariate_eval(spec, coeffs, x)
    # the encoded rows collapsed and inverse-transformed: the same, then zeros
    enc_flat = unpack_words(mont_dot(spec, outer_mont, comm.comm, "mont", x_form="limbs",
                                     y_form="limbs"), 0)
    plan = ntt.get_intt(spec, comm.n_cols)
    back = ntt.intt_inverse(plan, enc_flat)
    assert torch.equal(back, ntt.intt_inverse_passes_plain(plan, enc_flat))
    poly = ops.decode_host(back[:, 0].numpy())
    assert poly[: comm.n_per_row] == flat_ints
    assert not any(poly[comm.n_per_row :])
