"""The port's Brakedown encoding against lcpc_tpu's: code dims, seeded matrix
generation (native and Python samplers), and encode_rows bit for bit."""

import ctypes
import random

import numpy as np
import pytest
import torch

import lcpc_tpu.encodings.brakedown as jbd
from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.fs.chacha import ChaCha20Rng as JChaCha
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu.utils import native as j_native
from lcpc_tpu_torch import convert
from lcpc_tpu_torch.encodings import brakedown as bd
from lcpc_tpu_torch.fields import FT63, FT255
from lcpc_tpu_torch.fs.chacha import ChaCha20Rng
from lcpc_tpu_torch.ops import blake3, mont_dot, mont_map, mxu_ntt, ntt, sha256, spmv
from lcpc_tpu_torch.ops.limbs import get_ops, limbs_to_device
from lcpc_tpu_torch.utils import native

torch.set_num_threads(1)  # the xdist workers share the cores


def _jspec(spec):
    return J_FIELDS[spec.name]


@pytest.mark.parametrize("code", bd.ALL_CODES, ids=lambda c: c.name)
def test_code_dims_match_reference(code):
    jcode = jbd.CodeSpec(*[getattr(code, f) for f in
                           ("name", "an", "ad", "bn", "bd", "rn", "rd", "baselen")])
    for n in (50, 2965, 235173):
        for spec in (FT63, FT255):
            assert bd.get_code_dims(code, n, float(spec.flog2)) == jbd.get_code_dims(
                jcode, n, float(spec.flog2))


def test_constructor_dims_match_reference():
    for length in (1000, 4000, 1 << 13):
        for spec in (FT63, FT255):
            ours = bd.SdigEncoding.new(spec, length, seed=1, device="cpu")
            theirs = jbd.SdigEncoding.new(_jspec(spec), length, seed=1)
            assert (ours.n_per_row, ours.n_cols, ours.get_n_col_opens(),
                    ours.get_n_degree_tests()) == (
                theirs.n_per_row, theirs.n_cols, theirs.get_n_col_opens(),
                theirs.get_n_degree_tests())


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_generate_matches_reference(spec):
    ours = bd.generate(spec, bd.CODE3, 300, 7)
    theirs = jbd.generate(_jspec(spec), jbd.CODE3, 300, 7)
    for a, b in zip(ours[0] + ours[1], theirs[0] + theirs[1]):
        assert (a.n_in, a.n_out) == (b.n_in, b.n_out)
        assert np.array_equal(a.col_ptr, b.col_ptr)
        assert np.array_equal(a.row_idx, b.row_idx)
        assert np.array_equal(a.vals_mont, b.vals_mont)


def test_samplers_match_reference_across_paths():
    """Port Python sampler == reference native sampler, and port native ==
    reference Python, over the two gen_code calls sharing one stream."""
    lib, jlib = native.get_lib(), j_native.get_lib()
    assert lib is not None and jlib is not None
    for spec, shapes in [(FT63, [(37, 120, 5), (11, 40, 7)]),
                         (FT255, [(23, 64, 4), (9, 30, 3)])]:
        key = np.frombuffer(ChaCha20Rng.seed_from_u64(1234).key.tobytes(),
                            dtype=np.uint8).copy()
        rng = ChaCha20Rng.seed_from_u64(1234)
        rng.set_stream(5)
        jrng = JChaCha.seed_from_u64(1234)
        jrng.set_stream(5)
        st = ctypes.create_string_buffer(native.RNG_STATE_BYTES)
        lib.lcpc_rng_init(st, key.ctypes.data, ctypes.c_uint64(5))
        jst = ctypes.create_string_buffer(j_native.RNG_STATE_BYTES)
        jlib.lcpc_rng_init(jst, key.ctypes.data, ctypes.c_uint64(5))
        for n, m, d in shapes:
            pairs = [
                (bd.gen_code(spec, n, m, d, rng),
                 jbd.gen_code_native(jlib, jst, _jspec(spec), n, m, d)),
            ]
            pairs.append((bd.gen_code_native(lib, st, spec, n, m, d),
                          jbd.gen_code(_jspec(spec), n, m, d, jrng)))
            for a, b in pairs:
                assert np.array_equal(a.row_idx, b.row_idx)
                assert np.array_equal(a.vals_mont, b.vals_mont)


def _rows(spec, n_rows, npr, seed):
    rng = random.Random(seed)
    rows = [[rng.randrange(spec.p) for _ in range(npr)] for _ in range(n_rows)]
    rows[0][:2] = [spec.p - 1, 0]
    jops = j_get_ops(_jspec(spec))
    return rows, np.stack([jops.encode_host(r) for r in rows], axis=1)  # (W, R, npr)


def test_encode_rows_matches_pallas_route_ft63(monkeypatch):
    # >= 8 rows with LCPC_PALLAS_SPMV=1: lcpc_tpu runs its Pallas kernel
    # (interpret mode on the CPU) on every level
    monkeypatch.setenv("LCPC_PALLAS_SPMV", "1")
    spec, npr = FT63, 64
    _, x = _rows(spec, 8, npr, seed=5)
    jenc = jbd.SdigEncoding(_jspec(spec), npr, seed=3)
    want = np.asarray(jenc.encode_rows(x))
    enc = bd.SdigEncoding(spec, npr, seed=3, device="cpu")
    got = enc.encode_rows(limbs_to_device(x, "cpu"))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_encode_rows_matches_host_twin_ft255():
    # lcpc_tpu's XLA encode ladder takes 40-80 s of XLA:CPU compile at ft255,
    # so the ft255 row encode is held to lcpc_tpu's host twin instead (the
    # reference its own device encode is tested against)
    spec, npr = FT255, 64
    rows, x = _rows(spec, 8, npr, seed=6)
    jenc = jbd.SdigEncoding(_jspec(spec), npr, seed=0)
    enc = bd.SdigEncoding(spec, npr, seed=0, device="cpu")
    got = enc.encode_rows(limbs_to_device(x, "cpu"))
    jops = j_get_ops(_jspec(spec))
    for r in range(len(rows)):
        assert jops.decode_host(got[:, r].numpy()) == jenc.encode_row_host(rows[r])
    assert jops.decode_host(got[:, 0, :npr].numpy()) == rows[0]  # systematic


def test_converted_matrices_equal_generated():
    spec = FT255
    jpre, jpost = jbd.generate(_jspec(spec), jbd.CODE3, 120, 2)
    pre, post = bd.generate(spec, bd.CODE3, 120, 2)
    for m, jm in zip(pre + post, jpre + jpost):
        c = convert.sparse_mats_from_numpy(jm.col_ptr, jm.row_idx, jm.vals_mont,
                                           spec=spec, n_out=jm.n_out, n_in=jm.n_in)
        for a, b in zip(bd._csr_ragged(c), bd._csr_ragged(m)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_csr_ragged_holds_the_padded_rows(spec):
    # the kernel's ragged rows are the live slots of lcpc_tpu's padded CSR,
    # in the same order, with the limb pairs packed into 32-bit words
    for m in sum(bd.generate(spec, bd.CODE3, 300, 4), []):
        jm = jbd.SparseMat(_jspec(spec), m.n_out, m.n_in, m.col_ptr, m.row_idx,
                           m.vals_mont)
        pcols, pvals = jbd._csr_pad(jm)                   # (n_out, kmax), (.., W)
        row_ptr, cols, vals = bd._csr_ragged(m)
        lens = np.diff(row_ptr)
        live = np.arange(pcols.shape[1])[None, :] < lens[:, None]
        assert row_ptr[0] == 0 and row_ptr[-1] == m.row_idx.shape[0]
        assert lens.max() == pcols.shape[1]
        assert np.array_equal(cols, pcols[live])
        assert np.array_equal(vals, pvals[live][:, 0::2] | (pvals[live][:, 1::2] << 16))


def test_vandermonde_level_is_the_rs_code():
    # the RS base case as a full ragged level reproduces reed_solomon_host
    spec = FT255
    dm = bd._DeviceMat.vandermonde(spec, 8, 13, "cpu")
    assert (dm.n_in, dm.n_out, dm.nnz, dm.kmax) == (8, 13, 104, 8)
    rng = random.Random(9)
    xi = [spec.p - 1, 0] + [rng.randrange(spec.p) for _ in range(6)]
    jops = j_get_ops(_jspec(spec))
    x = torch.from_numpy(jops.encode_host(xi).T.astype(np.int32))[:, None, :]
    y = spmv.spmv_mont(spec, spmv.pack_words(x, 2).contiguous(), dm)
    got = jops.decode_host(spmv.unpack_words(y, 2)[:, 0, :].T.numpy())
    assert got == bd.reed_solomon_host(spec, xi, 13)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bd.SdigEncoding(FT63, 50, seed=0)
    assert bd.SdigEncoding(FT63, 50, seed=0, device="cpu").device.type == "cpu"
    # the field-op wrappers raise on a device that is neither a card nor the CPU
    meta = torch.empty((FT63.w16, 3), dtype=torch.int32, device="meta")
    for fn, op in ((mont_map.mont_mul_map, "to_mont"), (mont_map.mont_addsub_map, "neg")):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(FT63, meta, op=op)

    # the other kernels' plain versions launch no kernel: with every kernel
    # wrapper raising they still run
    def kernel(*args, **kwargs):
        raise AssertionError("a plain version reached a kernel wrapper")

    for mod, name in ((mont_map, "mont_mul_map"), (mont_map, "mont_addsub_map"),
                      (spmv, "spmv_mont"), (ntt, "ntt_forward"), (ntt, "intt_inverse"),
                      (mont_dot, "mont_dot"),
                      (mont_dot, "power_table"), (sha256, "sha256_cols"),
                      (sha256, "hash_word_columns"), (sha256, "merkle_tree"),
                      (sha256, "merkle_walk"), (blake3, "blake3_chunks"),
                      (blake3, "merge_chunk_cvs"), (blake3, "_cols_few"),
                      (blake3, "merkle_tree"), (blake3, "merkle_walk"),
                      (mxu_ntt, "mxu_dft")):
        monkeypatch.setattr(mod, name, kernel)
    ops, rng = get_ops(FT63), np.random.default_rng(3)
    x = limbs_to_device(ops.encode_host([int(v) for v in rng.integers(0, 1 << 62, 2 * 8)]),
                        "cpu").reshape(FT63.w16, 2, 8)
    y = ntt.ntt_forward_plain(ntt.get_ntt(FT63, 8), x)
    ops.from_mont_plain(y)
    four = mxu_ntt.get_mxu_ntt(FT63, 8)
    assert torch.equal(mxu_ntt.mxu_ntt_plain(four, x), y)
    words = spmv.pack_words(x, 0).permute(1, 2, 0)  # (2, 8, 2) words in
    mxu_ntt.mxu_ntt_plain(four, words, output="both", input="words")
    for back in (ntt.intt_inverse_plain(ntt.get_intt(FT63, 8), y),
                 ntt.intt_inverse_passes_plain(ntt.get_intt(FT63, 8), y)):
        assert torch.equal(back, x)
    mont_dot.mont_dot_plain(FT63, x, y.permute(0, 2, 1), "mont", x_form="limbs", y_form="limbs")
    mont_dot.power_table_plain(FT63, spmv.pack_words(x[:, 0], 0), 5)
    ops.mul_sum_mont(x.permute(1, 0, 2), y[:, :, :8].permute(1, 0, 2))
    words = spmv.pack_words(x.reshape(FT63.w16, 16), 0)  # (2, 16) int32 words
    digs = sha256.hash_word_columns_plain(words)
    cv, carry, rem = sha256.sha256_update_plain(sha256.h0_state(16, "cpu"), None, 8, words)
    assert torch.equal(sha256.sha256_finalize_plain(cv, carry, rem, 10), digs)
    assert torch.equal(blake3.hash_word_columns_few_plain(words),
                       blake3.hash_word_columns_plain(words))
    for mod in (sha256, blake3):
        flat = mod.merkle_tree_plain(mod.hash_word_columns_plain(words), 16)
        walked = mod.merkle_walk_plain(flat[:, :2], flat[:, 2:3].expand(8, 2).contiguous(),
                                       torch.zeros((1, 2), dtype=torch.int64),
                                       torch.tensor([0, 1]))
        assert walked.shape == (8, 2) and flat.shape == (8, 31)
