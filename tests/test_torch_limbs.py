"""The port's FieldOps (torch, int32 limbs / int64 arithmetic), bit for bit:
against exact Python-int field arithmetic for all four fields, and against
lcpc_tpu's FieldOps (JAX) on the same limbs.  Inputs include values next to p
and all-0xFFFF limb patterns inside each op's input bounds.

The JAX comparison runs at ft63: lcpc_tpu's jitted limb graphs take minutes
of XLA:CPU compile at the wide fields (measured: 99 s for sum/dot at ft255),
while the port's ops are held to the field definition at every width."""

import numpy as np
import pytest

from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu_torch.fields import ALL_FIELDS, FT63
from lcpc_tpu_torch.ops.limbs import get_ops, limbs_to_device


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


def test_elementwise_ops_match_field(field):
    spec, ops, va, vb = field
    p, rinv = spec.p, spec.Rinv
    a, b = _t(ops.encode_host(va, to_mont=False)), _t(ops.encode_host(vb, to_mont=False))
    assert _raw(ops, ops.add(a, b)) == [(x + y) % p for x, y in zip(va, vb)]
    assert _raw(ops, ops.sub(a, b)) == [(x - y) % p for x, y in zip(va, vb)]
    assert _raw(ops, ops.neg(a)) == [(-x) % p for x in va]
    assert _raw(ops, ops.mul(a, b)) == [x * y * rinv % p for x, y in zip(va, vb)]
    assert _raw(ops, ops.from_mont(a)) == [x * rinv % p for x in va]
    # to_mont takes any value < 2^(16W): include the all-0xFFFF pattern
    big = [(1 << (16 * spec.w16)) - 1] + va
    got = ops.to_mont(_t(ops.encode_host(big, to_mont=False)))
    assert _raw(ops, got) == [x * spec.R % p for x in big]


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
