"""The expander SpMV (ops/spmv.py): the plain PyTorch version against
lcpc_tpu's Pallas kernel run in interpret mode (ft63, the JAX package's own
CPU route) and against lcpc_tpu's FieldOps.mul_sum_mont (ft255, where the
interpreted kernel alone costs ~14 s), plus the wrapper's contract on CPU
tensors.  The CUDA kernel itself runs only on the GPU: chip_smoke.py holds it
against apply_mat_plain there, bit for bit."""

import numpy as np
import pytest
import torch

from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops import spmv_pallas
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu_torch.fields import FT63, FT255
from lcpc_tpu_torch.ops import spmv
from lcpc_tpu_torch.ops.limbs import limbs_to_device


def _level(spec, n_in, n_out, k, r, seed, all_pm1=False):
    """Random padded-CSR level + input, as host uint32 limb arrays."""
    rng = np.random.default_rng(seed)
    jops = j_get_ops(J_FIELDS[spec.name])
    rand = lambda n: [int.from_bytes(rng.bytes(spec.repr_bytes), "little") % spec.p
                      for _ in range(n)]
    cols = rng.integers(0, n_in, size=(k, n_out)).astype(np.int32)
    vals = jops.encode_host([spec.p - 1] * (k * n_out) if all_pm1 else rand(k * n_out))
    vals = np.ascontiguousarray(vals.reshape(spec.w16, k, n_out).transpose(1, 0, 2))
    x = jops.encode_host([spec.p - 1] * (n_in * r) if all_pm1 else rand(n_in * r))
    x = np.ascontiguousarray(x.reshape(spec.w16, n_in, r).transpose(1, 0, 2))
    if not all_pm1:
        vals[-2:, :, ::3] = 0  # zero pad slots, as _csr_pad leaves them
        cols[-2:, ::3] = 0
    return x, cols, vals  # (n_in, W, R), (K, n_out), (K, W, n_out)


def _gathered(x, cols):
    """(K, W, R, n_out): the operand block the reference kernel takes."""
    return np.ascontiguousarray(x[cols].transpose(0, 2, 3, 1))


def _plain(spec, x, cols, vals):
    return spmv.apply_mat_plain(spec, limbs_to_device(x, "cpu"),
                                torch.from_numpy(cols), limbs_to_device(vals, "cpu"))


def test_plain_matches_pallas_interpret_ft63():
    spec, k, r, n = FT63, 16, 8, 256
    x, cols, vals = _level(spec, 300, n, k, r, seed=0)
    want = np.asarray(spmv_pallas.spmv_mont(J_FIELDS[spec.name], vals,
                                            _gathered(x, cols), n))
    got = _plain(spec, x, cols, vals).numpy()            # (n_out, W, R)
    assert np.array_equal(got, want.transpose(2, 0, 1))


@pytest.mark.parametrize("spec,k,all_pm1", [(FT255, 9, False), (FT63, 96, True)],
                         ids=["ft255", "ft63-pm1-k96"])
def test_plain_matches_mul_sum_mont(spec, k, all_pm1):
    # every value p-1 at K = 96 (the largest 2^23 kmax, padded) is the
    # worst case of the lazy column bound and of the subtract chain
    r, n = 3, 20
    x, cols, vals = _level(spec, 40, n, k, r, seed=1, all_pm1=all_pm1)
    g = _gathered(x, cols)                                # (K, W, R, n)
    v = np.broadcast_to(vals[:, :, None, :], g.shape)
    want = np.asarray(j_get_ops(J_FIELDS[spec.name]).mul_sum_mont(v, g))  # (W, R, n)
    got = _plain(spec, x, cols, vals).numpy()
    assert np.array_equal(got, want.transpose(2, 0, 1))


def test_wrapper_on_cpu_takes_plain_without_counting():
    spec = FT63
    x, cols, vals = _level(spec, 30, 12, 5, 2, seed=2)
    before = spmv.spmv_mont.launches
    got = spmv.spmv_mont(spec, limbs_to_device(x, "cpu"), torch.from_numpy(cols),
                         limbs_to_device(vals, "cpu"))
    assert spmv.spmv_mont.launches == before
    assert torch.equal(got, _plain(spec, x, cols, vals))


def test_wrapper_rejects_bad_operands():
    spec = FT63
    x, cols, vals = _level(spec, 30, 12, 5, 2, seed=3)
    xt, ct, vt = limbs_to_device(x, "cpu"), torch.from_numpy(cols), limbs_to_device(vals, "cpu")
    with pytest.raises(TypeError):
        spmv.spmv_mont(spec, xt.long(), ct, vt)
    with pytest.raises(ValueError):
        spmv.spmv_mont(spec, xt, ct, vt[:, :, :-1])
    with pytest.raises(ValueError):
        spmv.spmv_mont(spec, xt.transpose(1, 2), ct, vt)
    with pytest.raises(ValueError):
        spmv.spmv_mont(FT255, xt, ct, vt)


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_kernel_consts_chain_covers_bound(spec):
    # the kernel's subtract chain: descending power-of-two multiples of p
    # whose doubled head covers the reference's max_mult bound
    k = 96
    c = spmv.kernel_consts(spec, k)
    w32 = spec.w16 // 2
    assert int.from_bytes(c[:w32].astype("<u4").tobytes(), "little") == spec.p
    assert (int(c[w32]) * spec.p) % (1 << 32) == (1 << 32) - 1
    n_mult = int(c[w32 + 1])
    mults = c[w32 + 2 :].reshape(n_mult, w32 + 1)
    vals = [int.from_bytes(m.astype("<u4").tobytes(), "little") for m in mults]
    assert vals == [spec.p << i for i in range(n_mult - 1, -1, -1)]
    assert 2 * vals[0] >= spmv.max_multiple(spec, k) * spec.p
