"""The small commit's routes (core/protocol.py: `_commit_fused_fn`, the
CUDA-graph replay, against `_commit_staged`) and the inverse NTT's FFT
identity, in the port on the CPU against lcpc_tpu.

- small commits byte-equal to lcpc_tpu's `commit` on both sides of its gate
  (its `_commit_fused_fn` below `_FUSED_COMMIT_MAX`, its staged path above,
  the gate lowered to reach it), Ligero and Brakedown at ft63, BLAKE3 and
  SHA-256; the port's CPU commits stay on the staged plain path whatever
  its gate says;
- the graph route's Python side (a shape staged until its capture_at-th
  commit, which captures, copies in and out, launch counts, the tree
  counter, the cache's bound and its entries freed with the encoding) with
  torch.cuda's streams, events and graphs stubbed: a stub graph reruns the
  captured stages at replay.  The graph itself runs only on the card (chip_smoke.py phase 18);
- the reference's FFT-consistency identity (lcpc-2d/src/tests.rs:194-236;
  lcpc_tpu's tests/test_ntt.py::test_fft_consistency_identity) in the port:
  the encoded matrix collapsed by the outer tensor (mont_dot's plain
  version) and inverse-transformed gives the collapsed coefficient rows,
  zeros above n_per_row.
Tolerance 0 throughout: exact field arithmetic and hashes."""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

import lcpc_tpu as J
from lcpc_tpu.core import protocol as jproto
from lcpc_tpu.ops.digest import DIGESTS_BY_NAME as J_DIGESTS
import lcpc_tpu_torch as P
from lcpc_tpu_torch.core import protocol as proto
from lcpc_tpu_torch.ops import blake3, launch_count, ntt
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

    def no_graph(*a):
        raise AssertionError("a CPU commit reached the CUDA-graph route")

    monkeypatch.setattr(proto, "_commit_fused_fn", no_graph)
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
            for mine, theirs in ((comm.hashes_dev, jcomm.hashes_dev), (comm.comm, jcomm.comm),
                                 (comm.coeffs, jcomm.coeffs)):
                assert np.array_equal(mine.numpy().astype(np.int64) & 0xFFFFFFFF,
                                      np.asarray(theirs).astype(np.int64)), (digest, gate)
            comms.append(comm)
        assert comms[0].get_root() == comms[1].get_root()


class _Stream:
    cuda_stream = 0x5EED

    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _Event:
    def record(self):
        pass


class _Graph:
    """Records nothing at capture; replay reruns the stages it is given."""

    def __init__(self):
        self.body = None
        self.capturing = False

    def capture_begin(self):
        self.capturing = True

    def capture_end(self):
        self.capturing = False

    def replay(self):
        self.body()


def test_commit_graph_cache_and_ownership(monkeypatch):
    # the launch counts' bookkeeping: taken off at capture, added at replay
    monkeypatch.setattr(launch_count, "COUNTERS", [])
    k = launch_count.LaunchCount()
    k.launches = 5
    with launch_count.captured() as counts:
        k.launches += 3
    assert k.launches == 5 and counts == {k: 3}
    launch_count.replayed(counts)
    launch_count.replayed(counts)
    assert k.launches == 11
    # torch.cuda's capture stubbed: _CommitGraph runs on CPU tensors, its
    # stub graph replaying the stages into the static outputs
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    init = proto._CommitGraph.__init__
    seen_counters = []

    def capture(self, enc, digest, length):
        core = proto._commit_core

        def core_in_capture(*a):
            assert self.graph.capturing  # the stages run between begin and end
            assert blake3._tree_counters[(0, _Stream.cuda_stream)] is self.counter
            return core(*a)

        monkeypatch.setattr(proto, "_commit_core", core_in_capture)
        init(self, enc, digest, length)
        monkeypatch.setattr(proto, "_commit_core", core)
        assert (0, _Stream.cuda_stream) not in blake3._tree_counters  # restored
        assert self.kernels == {}  # CPU tensors launch nothing
        seen_counters.append(self.counter)
        wenc, mat = weakref.ref(enc), self.inp.view(self.mat_shape)

        def body():
            comm, flat = core(wenc(), digest, mat)
            self.comm.copy_(comm)
            self.flat.copy_(flat)
        self.graph.body = body

    monkeypatch.setattr(proto._CommitGraph, "__init__", capture)
    cache = proto._GraphCache(3)

    def fused(enc, digest, arr, capture_at=2):
        graph = cache.get(enc, digest, arr.shape[1], capture_at)
        return proto._commit_staged(enc, digest, arr) if graph is None else graph.run(arr)

    encs = [_encodings("ligero")[0], _encodings("sdig")[0]]
    refs = [weakref.ref(e) for e in encs]
    for enc in encs:
        for digest in (P.BLAKE3, P.SHA256):
            length = enc.n_per_row * 2 - 1
            arr = [proto.coeff_limbs(seeded_values(P.FT63.p, P.FT63.w16, length, s), enc)
                   for s in (1, 2)]
            replays, copies = proto._commit_fused_fn.launches, proto._commit_fused_fn.copies
            first = fused(enc, digest, arr[0])  # noted, staged: no graph yet
            assert proto._commit_fused_fn.launches == replays and len(seen_counters) < 4
            captured_before = len(seen_counters)
            second = fused(enc, digest, arr[1])  # captured, then replayed
            assert len(seen_counters) == captured_before + 1
            kept = [t.clone() for t in second]
            third = fused(enc, digest, arr[0])  # the same graph, replayed again
            assert proto._commit_fused_fn.launches - replays == 2
            assert proto._commit_fused_fn.copies - copies == 2 * 4  # in, mat, comm, flat
            for want, got, owned in zip(proto._commit_staged(enc, digest, arr[1]), second, kept):
                assert torch.equal(want, got) and torch.equal(got, owned)  # not overwritten
            for want, got, staged in zip(proto._commit_staged(enc, digest, arr[0]), third, first):
                assert torch.equal(want, got) and torch.equal(want, staged)
            assert len(cache) <= 3 and len(cache._counts) <= 3
    assert len(seen_counters) == 4 and all(int(c) == 0 for c in seen_counters)
    del encs, enc
    gc.collect()
    assert all(r() is None for r in refs)
    assert len(cache) == 0 and not cache._counts  # entries freed with the encodings
    # a later capture: the commits before the capture_at-th run staged
    enc = _encodings("ligero")[0]
    arr = proto.coeff_limbs(seeded_values(P.FT63.p, P.FT63.w16, 300, 5), enc)
    replays = proto._commit_fused_fn.launches
    outs = [fused(enc, P.BLAKE3, arr, capture_at=4) for _ in range(5)]
    assert len(seen_counters) == 5 and proto._commit_fused_fn.launches - replays == 2
    assert all(torch.equal(a, b) for out in outs[1:] for a, b in zip(out, outs[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        proto._commit_fused_fn(_encodings("ligero")[0], P.BLAKE3)(torch.zeros((4, 8),
                                                                               dtype=torch.int32))


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
