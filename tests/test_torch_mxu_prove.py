"""The prover's contractions (lcpc_tpu_torch.ops.mxu_prove, ops/mont_dot.py)
on the CPU, where they run the kernels' plain versions: MxuCollapse against
FieldOps.collapse_words and lcpc_tpu's MxuCollapse, MxuColumnEval against
the columns of LcEncoding.encode_rows, lcpc_tpu's MxuColumnEval and Horner
over Python ints, and mont_dot / power_table against Python ints.
Tolerance 0 everywhere: exact field arithmetic."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcpc_tpu_torch as P
from lcpc_tpu_torch.ops import mxu_prove as M
from lcpc_tpu_torch.ops.limbs import get_ops, limbs_to_device
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
    """ft63: MxuColumnEval of a block (repeated and edge columns) equals the
    same columns of encode_rows and lcpc_tpu's MxuColumnEval."""
    import lcpc_tpu as J
    from lcpc_tpu.ops import mxu_prove as JM

    spec = P.FT63
    rnd = random.Random(3)
    enc = P.LigeroEncoding.new_from_dims(spec, 40, 128, 1, 4, device="cpu")
    blk = _limbs(spec, [rnd.randrange(spec.p) for _ in range(6 * 40)], (6, 40))
    cols = [0, 127, 5, 64, 5, 99]
    ev = M.MxuColumnEval(enc)
    ev.set_columns(cols)
    want = pack_words(enc.encode_rows(blk)[:, :, cols], 0).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(ev.eval_block(blk), want)
    assert torch.equal(ev.eval_block(pack_words(blk, 0), in_form="packed"), want)
    jev = JM.MxuColumnEval(J.LigeroEncoding.new_from_dims(J.FT63, 40, 128, 1, 4))
    jev.set_columns(cols)
    jgot = jev.eval_block(jnp.asarray(blk.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(jgot).astype(np.int64), want.numpy())


def test_column_eval_ft255_equals_horner():
    """ft255: the opened columns are the rows at w^bitrev(c), by Horner over
    Python ints (no JAX compile of an ft255 graph)."""
    spec = P.FT255
    ops = get_ops(spec)
    rnd = random.Random(4)
    n_cols, npr, rows = 64, 24, 3
    enc = P.LigeroEncoding.new_from_dims(spec, npr, n_cols, 1, 4, device="cpu")
    vals = [[rnd.randrange(spec.p) for _ in range(npr)] for _ in range(rows)]
    blk = _limbs(spec, [v for r in vals for v in r], (rows, npr))
    cols = [1, 63, 17]
    ev = M.MxuColumnEval(enc)
    ev.set_columns(cols)
    got = unpack_words(ev.eval_block(blk).to(torch.int32), 0)  # (W, rows, k) Montgomery
    w = spec.root_for_log_len(6)
    rev = bit_reverse_indices(n_cols)
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
        table = unpack_words(power_table(spec, pack_words(_limbs(spec, gs, (3,)), 0), 70), 0)
        assert ops.decode_host(table) == [pow(g, m, p) for m in range(70) for g in gs]
