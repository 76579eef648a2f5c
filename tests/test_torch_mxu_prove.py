"""The prover's contractions (lcpc_tpu_torch.ops.mxu_prove, ops/mont_dot.py)
on the CPU, where they run the kernels' plain versions: MxuCollapse against
FieldOps.collapse_words and lcpc_tpu's MxuCollapse, MxuColumnEval (its power
table as digit planes) against the columns of
LcEncoding.encode_rows, lcpc_tpu's MxuColumnEval and Horner over Python
ints, and mont_dot / power_table against Python ints; the digit-plane
layout and the tensor-core kernels' arithmetic (mont_dot_planes_plain and
mont_dot_thin_tc_plain, their folds and the s32 limit) against
mont_dot_plain and Python ints; the launches' K splits and the routes.
Tolerance 0 everywhere: exact field arithmetic."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcpc_tpu_torch as P
from lcpc_tpu_torch.ops import mxu_prove as M
from lcpc_tpu_torch.ops.limbs import get_ops, limbs_to_device
from lcpc_tpu_torch.ops import mont_dot as MD
from lcpc_tpu_torch.ops.mont_dot import mont_dot, mont_dot_plain, power_table
from lcpc_tpu_torch.ops.ntt import bit_reverse_indices
from lcpc_tpu_torch.ops.spmv import pack_words, unpack_words

torch.set_num_threads(1)  # the xdist workers share the cores


def _limbs(spec, vals, shape):
    return limbs_to_device(get_ops(spec).encode_host(vals), "cpu").reshape(spec.w16, *shape)


def test_route_by_field():
    assert [M.mxu_prove_enabled(s) for s in P.ALL_FIELDS] == [False, True, True, True]


def test_collapse_equals_collapse_words_and_reference(monkeypatch):
    """MxuCollapse at ft63 and ft127, whole and by row blocks of both
    layouts, equals collapse_words and lcpc_tpu's MxuCollapse."""
    import lcpc_tpu as J
    from lcpc_tpu.ops import mxu_prove as JM

    monkeypatch.setenv("LCPC_MXU_PROVE", "1")  # lcpc_tpu's own switch, for its side only
    for name in ("FT63", "FT127"):
        spec = getattr(P, name)
        rnd = random.Random(11)
        R, C = 40, 24
        mat = _limbs(spec, [rnd.randrange(spec.p) for _ in range(R * C)], (R, C))
        mat[:, 0, 0] = torch.tensor(get_ops(spec).encode_host([spec.p - 1])[:, 0])
        ts_ints = [[rnd.randrange(spec.p) for _ in range(R)] for _ in range(2)]
        ts = limbs_to_device(np.stack([get_ops(spec).encode_host(t) for t in ts_ints], 1), "cpu")
        want = get_ops(spec).collapse_words(ts, mat)
        assert torch.equal(M.MxuCollapse(spec, R)(ts_ints, mat), want)
        packed = pack_words(mat, 0)
        for form, src in (("packed", packed), ("limbs", mat)):
            got = M.MxuCollapse(spec, R, in_form=form).collapse_source(
                ts_ints, lambda r0, r1: src[:, r0:r1], R, 16)
            assert torch.equal(got, want)
        jwant = JM.MxuCollapse(getattr(J, name), R)(ts_ints, jnp.asarray(mat.numpy().astype(
            np.uint32)))
        np.testing.assert_array_equal(want.numpy(), np.asarray(jwant).astype(np.int64))


def test_column_eval_equals_encode_gather_and_reference():
    """ft63: MxuColumnEval of a block (repeated and edge columns, two sets)
    equals the same columns of encode_rows and lcpc_tpu's MxuColumnEval,
    its power table as digit planes."""
    import lcpc_tpu as J
    from lcpc_tpu.ops import mxu_prove as JM

    spec = P.FT63
    rnd = random.Random(3)
    enc = P.LigeroEncoding.new_from_dims(spec, 40, 128, 1, 4, device="cpu")
    blk = _limbs(spec, [rnd.randrange(spec.p) for _ in range(6 * 40)], (6, 40))
    cols = [0, 127, 5, 64, 5, 99]
    want = pack_words(enc.encode_rows(blk)[:, :, cols], 0).to(torch.int64) & 0xFFFFFFFF
    for cs in (cols, [127, 1, 1, 126, 63, 32, 0, 77, 100]):
        ev = M.MxuColumnEval(enc)
        ev.set_columns(cs)
        assert ev.table_bytes == len(cs) * 8 * 128
        want_cs = pack_words(enc.encode_rows(blk)[:, :, cs], 0).to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(ev.eval_block(blk), want_cs)
        assert torch.equal(ev.eval_block(pack_words(blk, 0), in_form="packed"), want_cs)
    jev = JM.MxuColumnEval(J.LigeroEncoding.new_from_dims(J.FT63, 40, 128, 1, 4))
    jev.set_columns(cols)
    jgot = jev.eval_block(jnp.asarray(blk.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(jgot).astype(np.int64), want.numpy())


def test_column_eval_ft255_equals_horner():
    """ft255: the opened columns are the rows at w^bitrev(c), by Horner over
    Python ints (no JAX compile of an ft255 graph), one column set and
    another with a repeated column."""
    spec = P.FT255
    ops = get_ops(spec)
    rnd = random.Random(4)
    n_cols, npr, rows = 64, 24, 3
    enc = P.LigeroEncoding.new_from_dims(spec, npr, n_cols, 1, 4, device="cpu")
    vals = [[rnd.randrange(spec.p) for _ in range(npr)] for _ in range(rows)]
    blk = _limbs(spec, [v for r in vals for v in r], (rows, npr))
    w = spec.root_for_log_len(6)
    rev = bit_reverse_indices(n_cols)
    for cols in ([1, 63, 17], [0, 40, 40, 5]):
        ev = M.MxuColumnEval(enc)
        ev.set_columns(cols)
        got = unpack_words(ev.eval_block(blk).to(torch.int32), 0)  # (W, rows, k) Montgomery
        for r in range(rows):
            for j, c in enumerate(cols):
                want = P.univariate_eval(spec, vals[r], pow(w, int(rev[c]), spec.p))
                assert ops.decode_host(got[:, r, j]) == [want]


def test_mont_dot_and_power_table_against_ints():
    """mont_dot_plain on unreduced operands (every limb 0xFFFF, values up to
    R - 1, as an untrusted proof may hold) is sum x y R^-2 mod p; "mont" is
    sum x y R^-1; `out` takes a strided view; power_table is g^m."""
    for spec in (P.FT63, P.FT191):
        ops = get_ops(spec)
        p, r_inv = spec.p, pow(spec.R, -1, spec.p)
        rnd = random.Random(6)
        x = torch.full((spec.w16, 2, 9), 0xFFFF, dtype=torch.int32)
        y = _limbs(spec, [rnd.randrange(p) for _ in range(9 * 5)], (9, 5))
        xi = [[spec.R - 1] * 9] * 2
        yi = [ops.decode_host(y[:, k], from_mont=False) for k in range(9)]
        for out_form, shift in (("canonical", 2), ("mont", 1)):
            got = mont_dot(spec, x, y, out_form, x_form="limbs", y_form="limbs")
            for a in range(2):
                for b in range(5):
                    s = sum(xi[a][k] * yi[k][b] for k in range(9)) * pow(r_inv, shift, p) % p
                    assert ops.decode_host(unpack_words(got[:, a, b : b + 1], 0),
                                           from_mont=False) == [s]
        buf = torch.zeros((spec.w16 // 2, 5, 2), dtype=torch.int32)
        mont_dot(spec, pack_words(x, 0), pack_words(y, 0), out=buf.permute(0, 2, 1))
        assert torch.equal(buf.permute(0, 2, 1),
                           mont_dot_plain(spec, pack_words(x, 0), pack_words(y, 0)))
        gs = [rnd.randrange(p) for _ in range(3)]
        table = unpack_words(MD.planes_to_words(power_table(
            spec, pack_words(_limbs(spec, gs, (3,)), 0), 70), 70), 0)
        assert ops.decode_host(table) == [pow(g, m, p) for m in range(70) for g in gs]


def _host_dot(spec, xi, yi, shift):
    """sum_k x[a][k] y[k][b] R^-shift mod p over Python ints, (A, B)."""
    p, r_inv = spec.p, pow(spec.R, -1, spec.p)
    return [[sum(xa[k] * yi[k][b] for k in range(len(xa))) * pow(r_inv, shift, p) % p
             for b in range(len(yi[0]))] for xa in xi]


def _words_ints(spec, words):
    """(W/2, A, B) int32 words -> (A, B) Python ints."""
    w = (words.to(torch.int64) & 0xFFFFFFFF).tolist()
    return [[sum(w[i][a][b] << (32 * i) for i in range(len(w))) for b in range(len(w[0][0]))]
            for a in range(len(w[0]))]


def test_plane_product_against_plain_and_ints():
    """mont_dot_planes_plain (the tile kernel's arithmetic: u8 digit
    planes, a fold every `fold` k-steps) and mont_dot_thin_tc_plain (the
    thin tensor-core kernel's: y's digit rows against x's planes, K ranges
    of `k_split`, the fold by digit rounds) equal mont_dot_plain and Python
    ints in every field, on random operands and on all-0xFF bytes (every
    value R - 1, as an unreduced operand may be) across fold boundaries;
    to_planes and planes_to_words invert each other."""
    for spec in P.ALL_FIELDS:
        _plane_product_case(spec)
        _thin_tc_case(spec)


def _thin_tc_case(spec):
    """The thin tensor-core model: A = 1 and 2, ragged K and B, y packed and
    as limbs read through a Brakedown-like odd row stride, both outputs,
    one K range and several; all-0xFFFFFFFF words and all-0xFFFF limbs."""
    rnd = random.Random(10)
    K, B = 37, 19
    big = _limbs(spec, [rnd.randrange(spec.p) for _ in range(K * (B + 2))], (K, B + 2))
    for A in (1, 2):
        x = _limbs(spec, [rnd.randrange(spec.p) for _ in range(A * K)], (A, K))
        xi = _words_ints(spec, pack_words(x, 0))
        for y_form, y in (("limbs", big[:, :, :B]), ("packed", pack_words(big, 0)[:, :, 1:])):
            assert y.stride(1) % 2 == 1 and not MD.thin_tc_tma(y)  # read a word at a time
            yi = _words_ints(spec, pack_words(y, 0) if y_form == "limbs" else y)
            for out_form, shift in (("canonical", 2), ("mont", 1)):
                want = mont_dot_plain(spec, x, y, out_form, x_form="limbs", y_form=y_form)
                assert _words_ints(spec, want) == _host_dot(spec, xi, yi, shift)
                for k_split in (16, K, None):
                    got = MD.mont_dot_thin_tc_plain(spec, x, y, out_form, x_form="limbs",
                                                    y_form=y_form, k_split=k_split)
                    assert torch.equal(got, want)
    ones_x = torch.full((spec.w16 // 2, 2, 300), -1, dtype=torch.int32)
    for y_form, ones_y in (("packed", torch.full((spec.w16 // 2, 300, 5), -1, dtype=torch.int32)),
                           ("limbs", torch.full((spec.w16, 300, 5), 0xFFFF, dtype=torch.int32))):
        for out_form in MD.OUT_FORMS:
            want = mont_dot_plain(spec, ones_x, ones_y, out_form, y_form=y_form)
            assert _words_ints(spec, want) == _host_dot(
                spec, [[spec.R - 1] * 300] * 2, [[spec.R - 1] * 5] * 300, 2 if out_form ==
                "canonical" else 1)
            for k_split in (128, None):
                assert torch.equal(MD.mont_dot_thin_tc_plain(
                    spec, ones_x, ones_y, out_form, y_form=y_form, k_split=k_split), want)


def _plane_product_case(spec):
    ops = get_ops(spec)
    rnd = random.Random(8)
    A, K, B = 3, 11, 4
    x = _limbs(spec, [rnd.randrange(spec.p) for _ in range(A * K)], (A, K))
    y = pack_words(_limbs(spec, [rnd.randrange(spec.p) for _ in range(K * B)], (K, B)), 0)
    planes = MD.to_planes(spec, y)
    assert planes.shape == (1, B, 2 * spec.w16, MD.TC_KT) and not planes[..., K:].any()
    assert torch.equal(MD.planes_to_words(planes, K), y)
    ones_x = torch.full((spec.w16, A, K), 0xFFFF, dtype=torch.int32)
    ones_y = torch.full((1, B, 2 * spec.w16, MD.TC_KT), 0xFF, dtype=torch.uint8)
    ones_y[..., K:] = 0
    for xx, yy in ((x, planes), (ones_x, ones_y)):
        xi = [[v for v in r] for r in _words_ints(spec, pack_words(xx, 0))]
        yi = _words_ints(spec, MD.planes_to_words(yy, K))
        for out_form, shift in (("canonical", 2), ("mont", 1)):
            want = mont_dot_plain(spec, xx, yy, out_form, x_form="limbs", y_form="planes")
            assert _words_ints(spec, want) == _host_dot(spec, xi, yi, shift)
            for fold in (3, 4, MD.FOLD_K):
                got = MD.mont_dot_planes_plain(spec, xx, yy, out_form, x_form="limbs", fold=fold)
                assert torch.equal(got, want)
    assert ops.w == spec.w16


def test_plane_product_s32_limit():
    """The s32 accumulator's limit: all-0xFF bytes over 2^15 k-steps stay
    below 2^31 (2^15 255^2 = 2,130,739,200), over 33,026 they pass it; at
    K = 2^15 + 1 the fold at 2^15 gives mont_dot_plain's result.  The
    tensor-core launch's K ranges (tc_split) keep to the limit: each at
    most FOLD_K and a multiple of the stage's 128 k-steps, together
    covering K with none empty, split no further than FOLD_K once the
    blocks fill the card twice over.  The thin tensor-core launch's
    (thin_tc_split) fit its shared memory and cover K; `route` picks the
    kernel."""
    spec = P.FT63
    d = 2 * spec.w16
    K = MD.FOLD_K + 1
    x = torch.full((spec.w16, 1, K), 0xFFFF, dtype=torch.int32)
    y = MD.to_planes(spec, torch.full((spec.w16 // 2, K, 1), -1, dtype=torch.int32))
    got = MD.mont_dot_planes_plain(spec, x, y, x_form="limbs")
    assert torch.equal(got, mont_dot_plain(spec, x, y, x_form="limbs", y_form="planes"))
    assert MD.FOLD_K * 255 * 255 < 2**31 <= 33_026 * 255 * 255
    x2 = torch.full((spec.w16, 1, 33_026), 0xFFFF, dtype=torch.int32)
    y2 = torch.full((MD.plane_tiles(33_026), 1, d, MD.TC_KT), 0xFF, dtype=torch.uint8)
    with pytest.raises(OverflowError):
        MD.mont_dot_planes_plain(spec, x2, y2, x_form="limbs", fold=33_026)
    for A, K, B in ((2048, 1 << 18, 189), (64, 1 << 18, 189), (3, 70, 5), (64, MD.FOLD_K, 136),
                    (64, MD.FOLD_K + 1, 136), (37, 1, 190)):
        for field in P.ALL_FIELDS:
            k_split, n = MD.tc_split(field, A, K, B, 132)
            assert k_split % MD.TC_KT == 0 and k_split <= MD.FOLD_K
            assert n * k_split >= K > (n - 1) * k_split
            d = 2 * field.w16
            blocks = -(-A // (2 * (64 // d))) * -(-B // (256 // d))
            if blocks * -(-K // MD.FOLD_K) >= 2 * 132:
                assert n == -(-K // MD.FOLD_K)
    # the thin tensor-core kernel: its shared memory (x's planes for the
    # range, y's stages, the fold's staging) fits, a range keeps to the s32
    # limit, the prover's collapses take one range and fill the card
    for limbs in (False, True):
        cap = MD.thin_tc_cap(limbs)
        ring = MD.TT_STAGES * MD.TT_STAGE * (2 if limbs else 1)
        assert 1024 + 64 * cap + ring + MD.TT_STAGING <= MD.SMEM_MAX
        assert cap % MD.TC_KT == 0 and cap * 255 * 255 < 2**31
        assert cap == (2048 if not limbs else 1024)
    x2 = torch.full((spec.w16 // 2, 1, 33_026), -1, dtype=torch.int32)
    with pytest.raises(OverflowError):
        MD.mont_dot_thin_tc_plain(spec, x2, x2.permute(0, 2, 1), k_split=33_026)
    # the fold's 32-bit anti-diagonal sums: D 2^27 at TT_MAX_K, 2^33 at 2^15
    f255 = P.FT255
    x3 = torch.full((f255.w16 // 2, 1, MD.FOLD_K), -1, dtype=torch.int32)
    MD.mont_dot_thin_tc_plain(f255, x3[:, :, : MD.TT_MAX_K], x3[:, :, : MD.TT_MAX_K].permute(
        0, 2, 1))
    with pytest.raises(OverflowError):
        MD.mont_dot_thin_tc_plain(f255, x3, x3.permute(0, 2, 1), k_split=MD.FOLD_K)
    for field in P.ALL_FIELDS:
        for limbs, K, B in ((False, 2048, 1 << 18), (False, 2048, 1 << 17), (True, 256, 1 << 15),
                            (True, 36, 235_173), (False, 1 << 18, 189), (True, 2049, 70),
                            (False, 1, 1)):
            k_split, n, grid_x = MD.thin_tc_split(field, limbs, K, B, 132)
            assert k_split <= MD.thin_tc_cap(limbs) and n * k_split >= K > (n - 1) * k_split
            tiles = -(-B // (2 * (64 // (field.w16 // 2))))
            assert 1 <= grid_x <= tiles and (grid_x * n >= 132 or grid_x == tiles)
            if B >= 1 << 15:
                assert (n, grid_x) == (-(-K // MD.thin_tc_cap(limbs)), 132)
    # routes: the tile kernel for planes or more than two rows; the thin
    # tensor-core kernel for the Ligero collapses and column checks; the
    # CUDA cores for the sums of partials, Brakedown's collapse and dots of
    # one column
    assert MD.route(3, 70, 5, "packed") == MD.route(2, 2048, 189, "planes") == "tile"
    for A, K, B, y_form in ((2, 2048, 1 << 18, "packed"), (2, 256, 1 << 15, "limbs"),
                            (2, 256, 189, "packed"), (2, 2048, 189, "packed"),
                            (2, 36, 4096, "packed")):
        assert MD.route(A, K, B, y_form) == "thin_tc"
    for A, K, B, y_form in ((1, 5, 1 << 18, "packed"), (1, 1 << 15, 1, "limbs"),
                            (2, 36, 235_173, "limbs"), (2, 8, 189, "packed")):
        assert MD.route(A, K, B, y_form) == "thin"


def test_power_table_planes_against_ints():
    """power_table's planes in every field: byte d of g_j^m (Montgomery) at
    [m // 128, j, d, m % 128], zero past K, and the plain ladders' words
    laid out by to_planes."""
    for spec in P.ALL_FIELDS:
        _power_table_planes_case(spec)


def _power_table_planes_case(spec):
    ops = get_ops(spec)
    rnd = random.Random(9)
    gs = [rnd.randrange(spec.p) for _ in range(3)]
    g = pack_words(_limbs(spec, gs, (3,)), 0)
    K = 133
    planes = power_table(spec, g, K)
    assert planes.shape == (2, 3, 2 * spec.w16, MD.TC_KT) and planes.dtype == torch.uint8
    assert not planes[1, ..., K - MD.TC_KT:].any()
    assert torch.equal(planes, MD.to_planes(spec, MD.power_table_plain(spec, g, K, "words")))
    table = unpack_words(MD.planes_to_words(planes, K), 0)  # (W, K, 3) Montgomery limbs
    assert ops.decode_host(table) == [pow(g_, m, spec.p) for m in range(K) for g_ in gs]
    with pytest.raises(ValueError):
        MD.power_table_plain(spec, g, K, "bytes")
    with pytest.raises(ValueError):
        power_table(spec, g, 0)
