"""The expander SpMV (ops/spmv.py): the plain PyTorch version on the kernel's
ragged, packed operands against lcpc_tpu's Pallas kernel run in interpret
mode on the padded form of the same level (ft63, the JAX package's own CPU
route) and against lcpc_tpu's FieldOps.mul_sum_mont (ft255, where the
interpreted kernel alone costs ~14 s), plus the packed-word helpers and the
wrapper's contract on CPU tensors.  The CUDA kernel itself runs only on the
GPU: chip_smoke.py holds it against apply_mat_plain there, bit for bit.
Tolerance is 0 throughout: exact field arithmetic."""

import numpy as np
import pytest
import torch

import lcpc_tpu.encodings.brakedown as jbd
from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops import spmv_pallas
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu_torch.encodings import brakedown as bd
from lcpc_tpu_torch.fields import FT63, FT255
from lcpc_tpu_torch.fs.chacha import ChaCha20Rng
from lcpc_tpu_torch.ops import spmv


def _rand(spec, rng, n):
    return [int.from_bytes(rng.bytes(spec.repr_bytes), "little") % spec.p for _ in range(n)]


def _level(spec, n_in, n_out, k, r, seed, all_pm1=False):
    """Random padded-CSR level + input, as host uint32 limb arrays, and the
    mask of its live (non-pad) slots."""
    rng = np.random.default_rng(seed)
    jops = j_get_ops(J_FIELDS[spec.name])
    cols = rng.integers(0, n_in, size=(k, n_out)).astype(np.int32)
    vals = jops.encode_host([spec.p - 1] * (k * n_out) if all_pm1 else _rand(spec, rng, k * n_out))
    vals = np.ascontiguousarray(vals.reshape(spec.w16, k, n_out).transpose(1, 0, 2))
    x = jops.encode_host([spec.p - 1] * (n_in * r) if all_pm1 else _rand(spec, rng, n_in * r))
    x = np.ascontiguousarray(x.reshape(spec.w16, n_in, r).transpose(1, 0, 2))
    live = np.ones((k, n_out), dtype=bool)
    if not all_pm1:
        live[-2:, ::3] = False
        vals *= live[:, None, :]  # zero pad slots, as _csr_pad leaves them
        cols[~live] = 0
    return x, cols, vals, live  # (n_in, W, R), (K, n_out), (K, W, n_out), (K, n_out)


def _packed(limbs, dim):
    return spmv.pack_words(torch.from_numpy(np.ascontiguousarray(limbs).astype(np.int32)), dim)


def _packed_x(x):
    """(n_in, W, R) limbs -> the kernel's packed x (n_in, R, W32)."""
    return _packed(x, 1).permute(0, 2, 1).contiguous()


def _csr_parts(cols, vals, live):
    """row_ptr, cols, vals (packed) of the live slots of a padded level,
    rows in output order, as int32 tensors."""
    row_ptr = np.zeros(cols.shape[1] + 1, dtype=np.int32)
    np.cumsum(live.sum(axis=0), out=row_ptr[1:])
    rcols = cols.T[live.T]                                # (nnz,)
    rvals = vals.transpose(2, 0, 1)[live.T]               # (nnz, W)
    return (torch.from_numpy(row_ptr), torch.from_numpy(np.ascontiguousarray(rcols)),
            _packed(rvals, 1))


def _ragged(x, cols, vals, live):
    """The kernel's operands for a padded level: packed x (n_in, R, W32) and
    the checked ragged CSR of its live slots."""
    return _packed_x(x), spmv.RaggedCsr(x.shape[0], *_csr_parts(cols, vals, live))


def _limbs_out(y):
    """(n_out, R, W32) packed words -> (n_out, W, R) limbs."""
    return spmv.unpack_words(y, 2).permute(0, 2, 1).numpy()


def _gathered(x, cols):
    """(K, W, R, n_out): the operand block the reference kernel takes."""
    return np.ascontiguousarray(x[cols].transpose(0, 2, 3, 1))


def _plain(spec, x, cols, vals, live):
    return _limbs_out(spmv.apply_mat_plain(spec, *_ragged(x, cols, vals, live)))


def test_plain_matches_pallas_interpret_ft63():
    spec, k, r, n = FT63, 16, 8, 256
    x, cols, vals, live = _level(spec, 300, n, k, r, seed=0)
    want = np.asarray(spmv_pallas.spmv_mont(J_FIELDS[spec.name], vals,
                                            _gathered(x, cols), n))
    got = _plain(spec, x, cols, vals, live)              # (n_out, W, R)
    assert np.array_equal(got, want.transpose(2, 0, 1))


def _sparse_level(spec, n_in, n_out, d, k_pad, seed):
    """A generated code matrix: the port's SparseMat and the reference's
    padded form of the same level, padded to k_pad slots."""
    rng = ChaCha20Rng.seed_from_u64(seed)
    mat = bd.gen_code(spec, n_in, n_out, d, rng)
    jmat = jbd.SparseMat(J_FIELDS[spec.name], mat.n_out, mat.n_in, mat.col_ptr,
                         mat.row_idx, mat.vals_mont)
    pcols, pvals = jbd._csr_pad(jmat)                     # (n_out, kmax), (n_out, kmax, W)
    kmax = pcols.shape[1]
    assert kmax <= k_pad
    cols = np.zeros((k_pad, n_out), dtype=np.int32)
    cols[:kmax] = pcols.T
    vals = np.zeros((k_pad, spec.w16, n_out), dtype=np.uint32)
    vals[:kmax] = pvals.transpose(1, 2, 0)
    return mat, cols, vals


def _ragged_from_sparse(mat, x):
    return _packed_x(x), bd._DeviceMat.from_sparse(mat, "cpu")


def test_ragged_sparse_level_matches_pallas_interpret_ft63():
    # same (K, R, n_out) = (16, 8, 256) as above: the interpreted kernel's
    # compiled graph is reused
    spec, r, n = FT63, 8, 256
    mat, cols, vals = _sparse_level(spec, 300, n, 5, 16, seed=11)
    x, _, _, _ = _level(spec, 300, n, 1, r, seed=12)
    want = np.asarray(spmv_pallas.spmv_mont(J_FIELDS[spec.name], vals,
                                            _gathered(x, cols), n))
    got = _limbs_out(spmv.apply_mat_plain(spec, *_ragged_from_sparse(mat, x)))
    assert np.array_equal(got, want.transpose(2, 0, 1))


def test_ragged_sparse_level_matches_mul_sum_mont_ft255():
    # (K, R, n_out) = (9, 3, 20) as in test_plain_matches_mul_sum_mont[ft255]
    spec, r, n = FT255, 3, 20
    mat, cols, vals = _sparse_level(spec, 30, n, 3, 9, seed=13)
    x, _, _, _ = _level(spec, 30, n, 1, r, seed=14)
    g = _gathered(x, cols)                                # (K, W, R, n)
    v = np.broadcast_to(vals[:, :, None, :], g.shape)
    want = np.asarray(j_get_ops(J_FIELDS[spec.name]).mul_sum_mont(v, g))  # (W, R, n)
    got = _limbs_out(spmv.apply_mat_plain(spec, *_ragged_from_sparse(mat, x)))
    assert np.array_equal(got, want.transpose(2, 0, 1))


@pytest.mark.parametrize("spec,k,all_pm1", [(FT255, 9, False), (FT63, 96, True)],
                         ids=["ft255", "ft63-pm1-k96"])
def test_plain_matches_mul_sum_mont(spec, k, all_pm1):
    # every value p-1 at K = 96 (the largest 2^23 kmax, padded) is the
    # worst case of the lazy column bound and of the subtract chain
    r, n = 3, 20
    x, cols, vals, live = _level(spec, 40, n, k, r, seed=1, all_pm1=all_pm1)
    g = _gathered(x, cols)                                # (K, W, R, n)
    v = np.broadcast_to(vals[:, :, None, :], g.shape)
    want = np.asarray(j_get_ops(J_FIELDS[spec.name]).mul_sum_mont(v, g))  # (W, R, n)
    got = _plain(spec, x, cols, vals, live)
    assert np.array_equal(got, want.transpose(2, 0, 1))


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_ragged_edge_rows_match_host_arithmetic(spec):
    # an empty row, a row of K = 96 nonzeros all p-1 over inputs all p-1,
    # and rows of mixed length (1, 37, 96 random), against Python ints
    rng = np.random.default_rng(7)
    jops = j_get_ops(J_FIELDS[spec.name])
    r, n_in, lens = 2, 200, [0, 96, 1, 37, 96]
    xs = [spec.p - 1] * (n_in * r // 2) + _rand(spec, rng, n_in * r // 2)
    x = np.ascontiguousarray(jops.encode_host(xs).reshape(spec.w16, n_in, r).transpose(1, 0, 2))
    cols = np.concatenate([np.arange(96) if i == 1 else rng.integers(0, n_in, n)
                           for i, n in enumerate(lens)]).astype(np.int32)
    vs = [spec.p - 1] * 96 + _rand(spec, rng, sum(lens) - 96)
    row_ptr = np.cumsum([0] + lens).astype(np.int32)
    mat = spmv.RaggedCsr(n_in, torch.from_numpy(row_ptr), torch.from_numpy(cols),
                         _packed(jops.encode_host(vs).T, 1))
    assert (mat.nnz, mat.kmax) == (sum(lens), 96)
    got = spmv.apply_mat_plain(spec, _packed_x(x), mat)
    out = jops.decode_host(_limbs_out(got).transpose(1, 0, 2))  # (W, n_out, R) order
    want = [sum(vs[k] * xs[int(cols[k]) * r + j]
                for k in range(row_ptr[c], row_ptr[c + 1])) % spec.p
            for c in range(len(lens)) for j in range(r)]
    assert out == want
    assert out[0] == out[1] == 0 and out[2] == (spec.p - 1) ** 2 * 96 % spec.p


def test_pack_unpack_round_trip():
    # all-0xFFFF limbs (every word's top bit set: negative as int32) and
    # values near p, along each axis the port packs
    jops = j_get_ops(J_FIELDS[FT255.name])
    vals = [FT255.p - 1, FT255.p - 2, FT255.p >> 1, 1 << 255, 0, 1]
    limbs = np.concatenate([np.full((16, 2), 0xFFFF, dtype=np.uint32),
                            jops.encode_host(vals, to_mont=False)], axis=1)  # (W, 8)
    words = _packed(limbs, 0)                             # (W32, 8)
    assert words.dtype == torch.int32 and int(words.min()) < 0
    raw = b"".join(int(v).to_bytes(32, "little") for v in [(1 << 256) - 1] * 2 + vals)
    want = np.frombuffer(raw, dtype="<u4").reshape(8, 8).T
    assert np.array_equal(words.numpy().astype(np.int64) & 0xFFFFFFFF, want)
    assert np.array_equal(spmv.unpack_words(words, 0).numpy(), limbs)
    cube = torch.from_numpy(limbs.T.reshape(2, 4, 16).astype(np.int32))  # W last
    assert torch.equal(spmv.unpack_words(spmv.pack_words(cube, 2), 2), cube)


def test_wrapper_on_cpu_takes_plain_without_counting():
    spec = FT63
    x, cols, vals, live = _level(spec, 30, 12, 5, 2, seed=2)
    ops = _ragged(x, cols, vals, live)
    before = spmv.spmv_mont.launches
    got = spmv.spmv_mont(spec, *ops)
    assert spmv.spmv_mont.launches == before
    assert torch.equal(got, spmv.apply_mat_plain(spec, *ops))
    out = torch.full_like(got, -1)
    assert spmv.spmv_mont(spec, *ops, out=out) is out
    assert torch.equal(out, got)


def test_wrapper_rejects_bad_operands():
    spec = FT63
    x, cols, vals, live = _level(spec, 30, 12, 5, 2, seed=3)
    xt, mat = _ragged(x, cols, vals, live)
    rp, ct, vt = _csr_parts(cols, vals, live)
    with pytest.raises(TypeError):
        spmv.spmv_mont(spec, xt.long(), mat)
    with pytest.raises(TypeError):
        spmv.spmv_mont(spec, xt, (rp, ct, vt))              # an unchecked CSR
    with pytest.raises(ValueError):
        spmv.RaggedCsr(30, rp, ct, vt[:-1])
    with pytest.raises(TypeError):
        spmv.RaggedCsr(30, rp, ct, vt.long())
    with pytest.raises(ValueError):
        spmv.spmv_mont(spec, xt.transpose(0, 1), mat)
    with pytest.raises(ValueError):
        spmv.spmv_mont(spec, xt[:-1].contiguous(), mat)     # n_in != mat.n_in
    with pytest.raises(ValueError):
        spmv.spmv_mont(FT255, xt, mat)
    with pytest.raises(ValueError):
        spmv.spmv_mont(spec, xt, mat, out=torch.empty((11, 2, 2), dtype=torch.int32))


def test_wrapper_rejects_bad_row_ptr():
    spec = FT63
    x, cols, vals, live = _level(spec, 30, 12, 5, 2, seed=4)
    # the matrix is checked once when it is made, on any device: a bad CSR
    # never reaches the kernel, whose launch reads no row_ptr back
    xt = _packed_x(x)
    rp, ct, vt = _csr_parts(cols, vals, live)
    mat = spmv.RaggedCsr(30, rp, ct, vt)                   # the good operands pass
    assert mat.kmax == 5 and mat.n_out == 12
    spmv.spmv_mont(spec, xt, mat)
    shifted = rp + 1                                       # does not start at 0
    falling = rp.clone()
    falling[3] = falling[4] + 1                            # a row of negative length
    short = rp.clone()
    short[-1] -= 1                                         # does not end at nnz
    for bad in (shifted, falling, short):
        with pytest.raises(ValueError, match="row_ptr"):
            spmv.RaggedCsr(30, bad, ct, vt)
    with pytest.raises(ValueError, match="cols"):
        spmv.RaggedCsr(30, rp, ct + 30, vt)
    with pytest.raises(ValueError, match="cols"):
        spmv.RaggedCsr(30, rp, ct - 30, vt)
    with pytest.raises(TypeError):
        spmv.RaggedCsr(30, rp.long(), ct, vt)
    with pytest.raises(ValueError):
        spmv.RaggedCsr(30, rp[None], ct, vt)
    long_rows = torch.zeros(3, dtype=torch.int32)
    long_rows[1:] = spmv.MAX_K + 1                         # one row past the bound
    with pytest.raises(ValueError, match="accumulator bound"):
        spmv.RaggedCsr(1, long_rows, torch.zeros(spmv.MAX_K + 1, dtype=torch.int32),
                       torch.zeros((spmv.MAX_K + 1, 1), dtype=torch.int32))


def test_split_lanes():
    # 2^23 ft255 shapes on 132 SMs: the big levels at r = 36 keep one lane
    # per output; the same levels at r = 2 and the small levels split their
    # rows; a lane keeps four nonzeros of an average row unless the launch
    # fits in one wave
    assert spmv.split_lanes(41861, 36, 1881384, 132) == 1
    assert spmv.split_lanes(41861, 2, 1881384, 132) == 2
    assert spmv.split_lanes(1327, 36, 1327 * 28, 132) == 4
    assert spmv.split_lanes(13, 36, 13 * 8, 132) == 8
    assert spmv.split_lanes(5, 2, 5 * 500, 132) == 32
    assert spmv.split_lanes(10, 2, 0, 132) == 1
    for n_out, r, nnz in ((7452, 2, 334888), (58855, 36, 1464433), (8, 2, 301)):
        s = spmv.split_lanes(n_out, r, nnz, 132)
        assert s in (1, 2, 4, 8, 16, 32) and s <= max(1, nnz / n_out)


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
