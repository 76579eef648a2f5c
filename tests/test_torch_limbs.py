"""The port's FieldOps (torch, int32 limbs / int64 arithmetic), bit for bit:
against exact Python-int field arithmetic for all four fields, and against
lcpc_tpu's FieldOps (JAX) on the same limbs.  Inputs include values next to p
and all-0xFFFF limb patterns inside each op's input bounds.

The JAX comparison runs at ft63: lcpc_tpu's jitted limb graphs take minutes
of XLA:CPU compile at the wide fields (measured: 99 s for sum/dot at ft255),
while the port's ops are held to the field definition at every width."""

import numpy as np
import pytest
import torch

from lcpc_tpu.core import protocol as jproto
from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu_torch.fields import ALL_FIELDS, FT63
from lcpc_tpu_torch.ops.limbs import get_ops, limbs_to_device, pack_row_words
from lcpc_tpu_torch.ops.mont_map import (map_route, mont_addsub_map_plain, mont_mul_map,
                                          mont_mul_map_plain)
from lcpc_tpu_torch.ops.spmv import pack_words, unpack_words

torch.set_num_threads(1)  # the xdist workers share the cores


def _values(spec, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(spec.repr_bytes), "little") % spec.p
            for _ in range(n)]
    vals[:4] = [spec.p - 1, spec.p - 2, 0, 1]
    return vals


def _t(arr):
    return limbs_to_device(arr, "cpu")


@pytest.fixture(scope="module", params=ALL_FIELDS, ids=lambda s: s.name)
def field(request):
    spec = request.param
    ops = get_ops(spec)
    va, vb = _values(spec, 24, 1), list(reversed(_values(spec, 24, 2)))
    return spec, ops, va, vb


def _raw(ops, t):
    """Limb tensor -> ints of the limb value (no Montgomery conversion)."""
    return ops.decode_host(t, from_mont=False)


def _words_ints(t, w32):
    """(W/2, ...) int32 words -> ints, element by element."""
    u = t.reshape(w32, -1).numpy().astype(np.uint32).astype(object)
    return [sum(int(u[i, j]) << (32 * i) for i in range(w32)) for j in range(u.shape[1])]


def test_elementwise_ops_match_field(field):
    spec, ops, va, vb = field
    p, rinv = spec.p, spec.Rinv
    a, b = _t(ops.encode_host(va, to_mont=False)), _t(ops.encode_host(vb, to_mont=False))
    assert _raw(ops, ops.add(a, b)) == [(x + y) % p for x, y in zip(va, vb)]
    assert _raw(ops, ops.sub(a, b)) == [(x - y) % p for x, y in zip(va, vb)]
    assert _raw(ops, ops.neg(a)) == [(-x) % p for x in va]
    assert _raw(ops, ops.mul(a, b)) == [x * y * rinv % p for x, y in zip(va, vb)]
    assert _raw(ops, ops.from_mont(a)) == [x * rinv % p for x in va]
    # to_mont and from_mont take any value < 2^(16W): all-0xFFFF limbs, p,
    # 2p and p - 1
    big = [(1 << (16 * spec.w16)) - 1, p, 2 * p, p - 1] + va
    bt = _t(ops.encode_host(big, to_mont=False))
    assert _raw(ops, ops.to_mont(bt)) == [x * spec.R % p for x in big]
    assert _raw(ops, ops.from_mont(bt)) == [x * rinv % p for x in big]
    # the mont_map plain versions in every form: limbs / words / hash words
    # in and out, broadcast and non-contiguous operands
    w32 = spec.w16 // 2
    bw = pack_words(bt, 0)                                    # (W/2, 28) words
    grid = bt.reshape(spec.w16, 4, 7)                         # (W, R, C)
    hw = pack_row_words(grid)                                 # (R*W/2, C) hash words
    want_to = [x * spec.R % p for x in big]
    want_from = [x * rinv % p for x in big]
    for x, form in ((bt, "limbs"), (bw, "words")):
        for op, want in (("to_mont", want_to), ("from_mont", want_from)):
            assert _words_ints(mont_mul_map_plain(spec, x, op=op, in_form=form,
                                                  out_form="words"), w32) == want, (op, form)
    assert _words_ints(mont_mul_map_plain(spec, hw, op="to_mont", in_form="hash",
                                          out_form="words"), w32) == want_to
    got = mont_mul_map_plain(spec, grid, op="from_mont", out_form="hash")  # canon_words
    assert torch.equal(got, ops.canon_words(grid))
    assert torch.equal(got, pack_row_words(_t(ops.encode_host(want_from, to_mont=False))
                                           .reshape(spec.w16, 4, 7)))
    assert torch.equal(mont_mul_map_plain(spec, hw, op="from_mont", in_form="hash",
                                          out_form="limbs"), ops.from_mont(grid))
    aw, bw2 = pack_words(a, 0), pack_words(b, 0).T.contiguous().T  # b words column-major
    assert _words_ints(mont_mul_map_plain(spec, aw, bw2, op="mul",
                                          in_form="words", out_form="words"),
                       w32) == [x * y * rinv % p for x, y in zip(va, vb)]
    for op, want in (("add", [(x + y) % p for x, y in zip(va, vb)]),
                     ("sub", [(x - y) % p for x, y in zip(va, vb)])):
        assert _words_ints(mont_addsub_map_plain(spec, aw, bw2, op=op, in_form="words",
                                                 out_form="words"), w32) == want, op
    c = ops.encode_host([vb[5]])[:, 0]  # a broadcast constant, Montgomery form
    a3 = a.reshape(spec.w16, 4, 6)[:, :, 1::2]               # non-contiguous
    want = [x * spec.to_mont(vb[5]) * rinv % p
            for x in np.array(va, dtype=object).reshape(4, 6)[:, 1::2].ravel()]
    assert _raw(ops, ops.mul_const(a3, c)) == want
    assert torch.equal(ops.mul_const_plain(a3, c), ops.mul_const(a3, c))
    for name in ("add", "sub", "mul"):
        assert torch.equal(getattr(ops, name + "_plain")(a, b), getattr(ops, name)(a, b)), name
    for name in ("neg", "to_mont", "from_mont"):
        assert torch.equal(getattr(ops, name + "_plain")(bt), getattr(ops, name)(bt)), name
    empty = a[:, :0]
    assert mont_mul_map_plain(spec, empty, empty).shape == (spec.w16, 0)
    # out=: the words written into a strided view (Brakedown's verify rows
    # into its level buffer: (positions, R, W/2) seen as (W/2, R, positions)),
    # the rest of the buffer untouched; a wrong shape, dtype or form refused
    rows = bw.reshape(w32, 4, 7)
    buf = torch.full((9, 4, w32), -7, dtype=torch.int32)
    view = buf[:7].permute(2, 1, 0)
    got = mont_mul_map(spec, rows, op="to_mont", in_form="words", out_form="words", out=view)
    assert got.data_ptr() == buf.data_ptr() and (buf[7:] == -7).all()
    assert torch.equal(view, mont_mul_map_plain(spec, rows, op="to_mont", in_form="words",
                                                out_form="words"))
    for bad, form in ((view[:, :, :6], "words"), (view.to(torch.int64), "words"),
                      (view, "hash")):
        with pytest.raises(ValueError):
            mont_mul_map(spec, rows, op="to_mont", in_form="words", out_form=form, out=bad)
    # the route on a card (map_route, strides and data pointers alone):
    # verify's proof rows (R, k, W/2) read whole and written whole into the
    # level buffer or into proof rows; a limb-major or new words output,
    # limb-major, hash-word and 4-byte-offset inputs take the strided kernel
    proof = bw.T.contiguous().reshape(4, 7, w32)               # (R, k, W/2) words
    kw = dict(op="to_mont", in_form="words", out_form="words")
    buf = torch.zeros((9, 4, w32), dtype=torch.int32)
    assert map_route(spec, proof.permute(2, 0, 1), out=buf[:7].permute(2, 1, 0), **kw) == "vector"
    assert map_route(spec, proof.permute(2, 0, 1), out=torch.empty_like(proof).permute(2, 0, 1),
                     **kw) == "vector"
    assert map_route(spec, proof.permute(2, 0, 1), **kw) == "strided"  # core/protocol.py's
    assert map_route(spec, proof.permute(2, 0, 1), op="to_mont", in_form="words") == "strided"
    assert map_route(spec, grid, op="to_mont", out_form="words") == "strided"
    assert map_route(spec, hw, op="to_mont", in_form="hash", out_form="words") == "strided"
    flat = torch.zeros(proof.numel() + 1, dtype=torch.int32)
    off = flat[1:].view(proof.shape)
    off.copy_(proof)
    assert map_route(spec, off.permute(2, 0, 1), **kw) == "strided"
    assert map_route(spec, rows, out=view, **kw) == "strided"  # words at a row stride of 28
    # the plain result of the out= write into the level buffer is to_mont's
    mont_mul_map(spec, proof.permute(2, 0, 1), out=buf[:7].permute(2, 1, 0), **kw)
    assert torch.equal(unpack_words(buf[:7].permute(2, 1, 0), 0),
                       ops.to_mont(unpack_words(proof.permute(2, 0, 1), 0)))
    assert not buf[7:].any()


def test_reductions_match_field(field):
    spec, ops, va, vb = field
    p, rinv = spec.p, spec.Rinv
    a = _t(ops.encode_host(va, to_mont=False)).reshape(spec.w16, 4, 6)
    b = _t(ops.encode_host(vb, to_mont=False)).reshape(spec.w16, 4, 6)
    A, B = np.array(va, dtype=object).reshape(4, 6), np.array(vb, dtype=object).reshape(4, 6)
    assert _raw(ops, ops.sum(a, axis=2)) == [sum(r) % p for r in A]
    assert _raw(ops, ops.dot_mont(a, b, axis=1)) == [
        sum(A[:, j] * B[:, j]) * rinv % p for j in range(6)]
    # mul_sum_mont over K = 4 slots (all p-1 on one side: largest column sums)
    pm1 = _t(ops.encode_host([p - 1] * 24, to_mont=False)).reshape(spec.w16, 4, 6)
    got = ops.mul_sum_mont(a.permute(1, 0, 2), pm1.permute(1, 0, 2))
    assert _raw(ops, got) == [sum(A[:, j]) * (p - 1) * rinv % p for j in range(6)]
    # collapse: canonical Σ_r ts[t, r] * mat[r, c] * R^-2
    ts, mat = a[:, :2, :3], b[:, :3, :]
    want = [sum(A[t, r] * B[r, c] for r in range(3)) * rinv * rinv % p
            for t in range(2) for c in range(6)]
    assert _raw(ops, ops.collapse_canon(ts, mat)) == want
    words = ops.collapse_words(ts, mat).numpy().astype("<u4")  # (T, C, W/2)
    assert [int.from_bytes(w.tobytes(), "little")
            for w in words.reshape(12, -1)] == want


def test_ops_match_reference_ft63():
    spec = FT63
    ops, jops = get_ops(spec), j_get_ops(J_FIELDS[spec.name])
    a = jops.encode_host(_values(spec, 24, 1))
    b = jops.encode_host(list(reversed(_values(spec, 24, 2))))
    for name in ("add", "sub", "mul"):
        want = np.asarray(getattr(jops, name)(a, b))
        assert np.array_equal(getattr(ops, name)(_t(a), _t(b)).numpy(), want), name
    for name in ("neg", "to_mont", "from_mont"):
        want = np.asarray(getattr(jops, name)(a))
        assert np.array_equal(getattr(ops, name)(_t(a)).numpy(), want), name
    # the fused from_mont + pack (lcpc_tpu's _canon_pack_fn) and to_mont of
    # packed words, through the mont_map plain versions
    g = a.reshape(spec.w16, 4, 6)
    want = np.asarray(jproto._canon_pack_fn(jops)(g)).astype(np.uint32)
    assert np.array_equal(ops.canon_words(_t(g)).numpy().astype(np.uint32), want)
    words = pack_words(_t(a), 0)
    assert np.array_equal(mont_mul_map_plain(spec, words, op="to_mont", in_form="words").numpy(),
                          np.asarray(jops.to_mont(a)))
    a3, b3 = a.reshape(spec.w16, 4, 6), b.reshape(spec.w16, 4, 6)
    assert np.array_equal(ops.dot_mont(_t(a3), _t(b3), axis=1).numpy(),
                          np.asarray(jops.dot_mont(a3, b3, axis=1)))
    k3, k3b = np.moveaxis(a3, 1, 0), np.moveaxis(b3, 1, 0)
    assert np.array_equal(ops.mul_sum_mont(_t(k3), _t(k3b)).numpy(),
                          np.asarray(jops.mul_sum_mont(k3, k3b)))
    ts, mat = a3[:, :2, :3], b3[:, :3, :]
    assert np.array_equal(ops.collapse_words(_t(ts), _t(mat)).numpy().astype(np.uint32),
                          np.asarray(jops.collapse_words(ts, mat)))


def test_host_codecs(field):
    spec, ops, va, _ = field
    enc = ops.encode_host(va)
    assert ops.decode_host(_t(enc)) == va
    assert np.array_equal(enc, j_get_ops(J_FIELDS[spec.name]).encode_host(va))
    words = ops.encode_repr_words(va)
    assert [int.from_bytes(w.astype("<u4").tobytes(), "little") for w in words] == va
