"""The port's NTT (ops/ntt.py) against lcpc_tpu's: host twins and fixed
vectors in all four fields, the twiddle tables carried across as numpy, the
plain PyTorch ladder against lcpc_tpu's jitted ladder at ft63 (its ft255
graph compiles for minutes on XLA:CPU) and against the host twin at ft255,
the inverse, the kernel's twiddle table, its pass plan and the pass-grouped
plain ladder (the kernel's tile and butterfly index arithmetic), the hash
words of its last pass, and the wrapper's contract on CPU tensors.  The
four-step transform (ops/mxu_ntt.py): its plan tables against lcpc_tpu's
MxuNttPlan, its plain version against the host twin at ft255, its wrapper's
contract.  The CUDA kernels themselves run only on the GPU: chip_smoke.py
holds them against ntt_forward_plain and mxu_ntt_plain there, limb for limb
and word for word.
Tolerance is 0 throughout: exact field arithmetic."""

import random

import numpy as np
import pytest
import torch

from lcpc_tpu.fields import FIELDS_BY_NAME as J_FIELDS
from lcpc_tpu.ops import mxu_ntt as jmxu
from lcpc_tpu.ops import ntt as jntt
from lcpc_tpu.core import protocol as jproto
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
from lcpc_tpu_torch.encodings.ligero import LigeroEncoding
from lcpc_tpu_torch.fields import ALL_FIELDS, FT63, FT255
from lcpc_tpu_torch.ops import mxu_ntt, ntt
from lcpc_tpu_torch.ops.limbs import get_ops, pack_row_words

torch.set_num_threads(1)  # the xdist workers share the cores


def _vals(spec, n, seed):
    """n values from a numpy seed, with p-1, 0 and 1 at the front."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(n, spec.w16))
    vals = [int.from_bytes(r.astype("<u2").tobytes(), "little") % spec.p for r in limbs]
    vals[:3] = [spec.p - 1, 0, 1][: n]
    return vals[:n]


def _limbs(spec, rows):
    """Rows of canonical ints -> (W, R, n) int32 Montgomery limbs (CPU)."""
    ops = get_ops(spec)
    return torch.from_numpy(np.stack([ops.encode_host(r) for r in rows], axis=1)
                            .astype(np.int32))


def _decode(spec, x):
    """(W, R, n) Montgomery limbs -> rows of canonical ints."""
    ops = get_ops(spec)
    return [ops.decode_host(x[:, r].numpy()) for r in range(x.shape[1])]


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_field_ntt_constants_match_reference(spec):
    js = J_FIELDS[spec.name]
    assert (spec.s, spec.t_odd, spec.root_of_unity) == (js.s, js.t_odd, js.root_of_unity)
    for log_len in (0, 1, 5, spec.s):
        assert spec.root_for_log_len(log_len) == js.root_for_log_len(log_len)


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_host_twins_match_reference(spec):
    js = J_FIELDS[spec.name]
    for n in (2, 16, 64):
        xs = _vals(spec, n, seed=n)
        assert ntt.ntt_host(spec, xs) == jntt.ntt_host(js, xs)
        assert ntt.intt_host(spec, xs) == jntt.intt_host(js, xs)
        assert np.array_equal(ntt.bit_reverse_indices(n), jntt.bit_reverse_indices(n))
    xs = _vals(spec, 16, seed=3)
    want = jntt.ntt_reference_host(js, xs)
    assert ntt.ntt_reference_host(spec, xs) == want == ntt.ntt_host(spec, xs)
    assert ntt.intt_host(spec, ntt.ntt_host(spec, xs)) == xs


def test_fft_io_fixed_vectors():
    """The fixed vectors of tests/test_ntt.py (fffft's fft_io contract)."""
    assert FT63.root_of_unity == 4256681863234029612
    assert FT63.s == 41 and FT63.t_odd == 2320443
    assert ntt.ntt_host(FT63, list(range(1, 17))) == [
        136, 5102708120182849529, 2880931767225701037, 2221776352957148484,
        2430371459602828169, 3331492074848573905, 1771216045334275616,
        2672336660580021352, 3124238125812841050, 1736504793392815288,
        1770817141808650094, 4892167007888497716, 210541112294351805,
        3331890978374199427, 3366203326790034233, 1978469994370008471,
    ]
    assert FT255.root_of_unity == 0x5425e2a66fd9cbf775273db316b7e0c89a2e5ce2899cbfc2748b4ceb2108eb11
    want = [
        0x24,
        0x663c799b6e4d2900fda9df04b9575969ef73c79086595f3002a4f1fffffffffd,
        0x249de590a68a80f70186ead732f51337de45943ab5d813646a16630ba830d2b0,
        0x419e940ac7c2a809fc22f42d86624632112e3355d0814bcb988e8ef457cf2d49,
        0x66373e0b48b580f3ad6c466661ddb1ac7b896558b34512c8697a7b554f766e1d,
        0x494106b172aca9fb534b6e4cbd63ce2d30758aad3ec473306d573cc200eb3744,
        0x1cfb72e9fba07f05aa5e70b7fbf38b3cbefe3ce34794ebff954db53dff14c8b5,
        0x53b902597a80d503d989e5779a7bd73ea6237d3144c67992a76aab08991dc,
    ]
    assert ntt.ntt_host(FT255, list(range(1, 9))) == want
    # the plain ladder on the same vector
    y = ntt.ntt_forward_plain(ntt.get_ntt(FT255, 8), _limbs(FT255, [list(range(1, 9))]))
    assert _decode(FT255, y) == [want]


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [2, 8, 256, 4096])
def test_plan_tables_match_reference(spec, n):
    js = J_FIELDS[spec.name]
    ours, theirs = ntt.NttPlan(spec, n), jntt.NttPlan(js, n)
    assert len(ours.stage_twiddles) == len(theirs.stage_twiddles) == ours.log_n
    for a, b in zip(ours.stage_twiddles, theirs.stage_twiddles):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    iours, itheirs = ntt.InttPlan(spec, n), jntt.InttPlan(js, n)
    for a, b in zip(iours.stage_twiddles, itheirs.stage_twiddles, strict=True):
        assert np.array_equal(a, b)
    assert np.array_equal(iours.n_inv_limbs, itheirs.n_inv_limbs)


@pytest.mark.parametrize("n", [2, 8, 64, 256, 1024])
@pytest.mark.parametrize("r", [1, 3])
def test_plain_matches_reference_ladder_ft63(n, r):
    # the sizes cross lcpc_tpu's TAIL_C = 128 and the kernel's chunk C = 1024
    spec = FT63
    rows = [_vals(spec, n, seed=100 * n + i) for i in range(r)]
    x = _limbs(spec, rows)
    want = np.asarray(jntt.get_ntt(J_FIELDS[spec.name], n)(x.numpy().astype(np.uint32)))
    got = ntt.ntt_forward_plain(ntt.get_ntt(spec, n), x)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 4, 32, 2048])
def test_plain_matches_host_ft255(n):
    # all p-1, a delta, values just below p and random rows
    spec = FT255
    near = [(spec.p - 1 - i) for i in range(n)]
    delta = [0] * n
    delta[n // 2] = 1
    rows = [[spec.p - 1] * n, delta, near, _vals(spec, n, seed=n)]
    got = _decode(spec, ntt.ntt_forward_plain(ntt.get_ntt(spec, n), _limbs(spec, rows)))
    want = [ntt.ntt_host(spec, row) for row in rows]
    assert got == want
    # the four-step transform's plain version (n >= 4), full and from n/4
    # inputs (the rest zero-padded), its words by the canonical plan
    for in_len in (n, n // 4) if n >= 4 else ():
        part = [row[:in_len] for row in rows]
        mx = mxu_ntt.get_mxu_ntt(spec, n, in_len)
        limbs = mxu_ntt.mxu_ntt_plain(mx, _limbs(spec, part))
        assert _decode(spec, limbs) == [ntt.ntt_host(spec, row + [0] * (n - in_len))
                                        for row in part]
        words = mxu_ntt.mxu_ntt_plain(mx.for_mode("words", "limbs"), _limbs(spec, part),
                                      output="words")
        assert torch.equal(words, pack_row_words(get_ops(spec).from_mont(limbs)))


def test_plain_matches_host_2_18_ft63():
    # the largest size the kernel is held to on the card (chip_smoke.py)
    spec, n = FT63, 1 << 18
    row = _vals(spec, n, seed=18)
    got = _decode(spec, ntt.ntt_forward_plain(ntt.get_ntt(spec, n), _limbs(spec, [row])))
    assert got == [ntt.ntt_host(spec, row)]


def test_plain_zero_pads_short_rows():
    spec = FT255
    rows = [_vals(spec, 40, seed=4), [spec.p - 1] * 40]
    got = _decode(spec, ntt.ntt_forward_plain(ntt.get_ntt(spec, 64), _limbs(spec, rows)))
    assert got == [ntt.ntt_host(spec, row + [0] * 24) for row in rows]


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_intt_inverse_round_trips(spec):
    n = 256
    rows = [_vals(spec, n, seed=9), [spec.p - 1] * n]
    x = _limbs(spec, rows)
    y = ntt.ntt_forward_plain(ntt.get_ntt(spec, n), x)
    back = ntt.intt_inverse(ntt.get_intt(spec, n), y)
    assert torch.equal(back, x)
    assert _decode(spec, back)[0] == ntt.intt_host(spec, ntt.ntt_host(spec, rows[0]))


def _edge_rows(spec, n, seed):
    """A random row, zeros, all p - 1, and values near p."""
    near = [spec.p - 1 - (i % 7) for i in range(n)]
    return [_vals(spec, n, seed), [0] * n, [spec.p - 1] * n, near]


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_intt_inverse_matches_reference(spec):
    # the plain ladder against lcpc_tpu's jitted BatchedIntt (ft63) or the
    # host twin (ft255), the kernel's passes and rounds (plain model: radix-4
    # rounds, a one-stage first round where a pass's stage count is odd, a
    # one-stage pass, n^-1 in the last stage's table) against the plain
    # ladder for the default plan and a three-pass one, the wrapper on CPU
    # tensors, and its refusals
    three = dict(log_chunk=6, log_t=2, max_tile_bytes=64 * spec.w16)  # 6 + 3 + 2 stages
    one = dict(log_chunk=3, log_t=1, max_tile_bytes=8 * spec.w16)    # 3 + 1 + 1 stages
    for n, kw in ((2, {}), (8, {}), (32, one), (64, {}), (2048, three)):
        plan = ntt.InttPlan(spec, n, **kw)
        rows = _edge_rows(spec, n, seed=n)
        x = _limbs(spec, rows)
        got = ntt.intt_inverse_plain(plan, x)
        if spec is FT63:
            want = np.asarray(jntt.get_intt(J_FIELDS[spec.name], n)(
                x.numpy().astype(np.uint32)))
            assert np.array_equal(got.numpy(), want.astype(np.int32)), n
        elif n <= 64:
            assert _decode(spec, got) == [ntt.intt_host(spec, r) for r in rows], n
        assert torch.equal(ntt.intt_inverse_passes_plain(plan, x), got), n
        before = ntt.intt_inverse.launches
        assert torch.equal(ntt.intt_inverse(plan, x), got)
        assert ntt.intt_inverse.launches == before
    assert len(plan.passes) == 3 and plan.launches_per_call == 3
    one_stage = ntt.InttPlan(spec, 32, **one).passes
    assert [ps.hi - ps.lo for ps in one_stage] == [2, 0, 0]  # odd, then one stage twice
    with pytest.raises(TypeError):
        ntt.intt_inverse(plan, x.long())
    with pytest.raises(ValueError):
        ntt.intt_inverse(plan, x[:, :, :-1])
    with pytest.raises(ValueError, match="device"):
        ntt.intt_inverse(plan, x.to("meta"))


def test_mul_const_matches_reference():
    spec = FT255
    jops = j_get_ops(J_FIELDS[spec.name])
    x = _limbs(spec, [_vals(spec, 16, seed=1)])
    c = jops.encode_host([spec.p - 2])[:, 0]
    want = np.asarray(jops.mul_const(x.numpy().astype(np.uint32), c))
    assert np.array_equal(get_ops(spec).mul_const(x, c).numpy(), want)


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_kernel_table_layout(spec):
    # half-size m's twiddles sit at rows m-1 .. 2m-2 of the packed table,
    # low word first; consts are p's words and -p^-1 mod 2^32
    n = 64
    plan = ntt.NttPlan(spec, n)
    tw, consts = plan.kernel_table("cpu")
    w32 = spec.w16 // 2
    assert tw.shape == (n - 1, w32) and tw.dtype == torch.int32 and tw.is_contiguous()
    words = tw.numpy().astype(np.int64) & 0xFFFFFFFF
    for s in range(plan.log_n):
        m = 1 << s
        got = [int.from_bytes(words[m - 1 + j].astype("<u4").tobytes(), "little")
               for j in range(m)]
        w_2m = spec.root_for_log_len(s + 1)
        assert got == [spec.to_mont(pow(w_2m, j, spec.p)) for j in range(m)], m
    c = consts.numpy().astype(np.int64) & 0xFFFFFFFF
    assert int.from_bytes(c[:w32].astype("<u4").tobytes(), "little") == spec.p
    assert (int(c[w32]) * spec.p) % (1 << 32) == (1 << 32) - 1
    # the inverse kernel's table, derived from the forward one: w_2m^-j at
    # rows m-1 .. 2m-2 in ascending j, the last stage's times n^-1, and the
    # forward constants: lcpc_tpu's inverse twiddles
    iplan = ntt.InttPlan(spec, n)
    itw, iconsts = iplan.kernel_table("cpu")
    assert itw.shape == (n - 1, w32) and torch.equal(iconsts, consts)
    n_inv = pow(n, spec.p - 2, spec.p)
    iwords = itw.numpy().astype(np.int64) & 0xFFFFFFFF
    for s in range(plan.log_n):
        m = 1 << s
        got = [int.from_bytes(iwords[m - 1 + j].astype("<u4").tobytes(), "little")
               for j in range(m)]
        w_inv = pow(spec.root_for_log_len(s + 1), spec.p - 2, spec.p)
        scale = n_inv if m == n // 2 else 1
        assert got == [spec.to_mont(pow(w_inv, j, spec.p) * scale % spec.p)
                       for j in range(m)], m
    jstages = jntt.InttPlan(J_FIELDS[spec.name], n).stage_twiddles
    for got, want, mine in zip(ntt.inverse_stage_twiddles(iplan, itw), jstages,
                               iplan.stage_twiddles):
        assert np.array_equal(got.numpy(), want.astype(np.int32))
        assert np.array_equal(mine, want)
    # the four-step transform's tables against lcpc_tpu's MxuNttPlan (numpy,
    # no jit): tw limb for limb; each k1 / k2 entry over its package's scale
    # (the port's R^2, or R for the canonical k2; lcpc_tpu's R7 mod p, times
    # R^-1 for the canonical k2) equal to lcpc_tpu's 7-bit digits decoded
    p, r_inv = spec.p, pow(spec.R, -1, spec.p)
    for n4, in_len in ((16, None), (256, None), (4096, None), (16, 4), (256, 64), (4096, 1024)):
        ours = mxu_ntt.MxuNttPlan(spec, n4, in_len=in_len)
        canon = mxu_ntt.MxuNttPlan(spec, n4, in_len=in_len, canonical_out=True,
                                   share_from=ours)
        theirs = jmxu.MxuNttPlan(J_FIELDS[spec.name], n4, in_len=in_len)
        jcanon = jmxu.MxuNttPlan(J_FIELDS[spec.name], n4, in_len=in_len, canonical_out=True,
                                 share_from=theirs)
        assert (ours.a, ours.b, ours.a_nz) == (theirs.a, theirs.b, theirs.a_nz)
        assert np.array_equal(ours.tw, theirs.tw) and canon.tw is ours.tw
        for mine, jplan, k, scale, jscale in (
                (ours, theirs, "k1", ours.k1_scale, theirs.kscale),
                (ours, theirs, "k2", ours.k2_scale, theirs.kscale),
                (canon, jcanon, "k2", canon.k2_scale, jcanon.kscale * r_inv)):
            words = getattr(mine, k).astype(np.int64)  # (W/2, P, C)
            got = sum(words[w].astype(object) << (32 * w) for w in range(words.shape[0]))
            digits = getattr(jplan, k)[::-1].astype(np.int64)  # (W7, C, P), unflipped
            jval = sum(digits[d].astype(object) << (7 * d) for d in range(digits.shape[0]))
            s_inv, js_inv = pow(scale, -1, p), pow(jscale % p, -1, p)
            assert [[v * s_inv % p for v in row] for row in got.tolist()] == \
                [[v * js_inv % p for v in row] for row in jval.T.tolist()], (n4, in_len, k)


def test_pack_rows_round_trip():
    # the hash words of the NTT's last pass: all-0xFFFF limbs (every word
    # negative as int32), word r*W32 + i of column c, and back to limbs
    spec = FT255
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 1 << 16, (spec.w16, 3, 20)).astype(np.int32))
    x[:, 0] = 0xFFFF
    words = pack_row_words(x)
    assert words.shape == (3 * 8, 20) and words.dtype == torch.int32
    assert int(words[:8].max()) == -1
    u = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for r, c in ((0, 0), (1, 7), (2, 19)):
        limbs = [int(v) for v in x[:, r, c]]
        assert [int(v) for v in u[8 * r:8 * r + 8, c]] == [
            limbs[2 * i] | limbs[2 * i + 1] << 16 for i in range(8)]
    back = np.stack([u & 0xFFFF, u >> 16], axis=1).reshape(3, 16, 20).transpose(1, 0, 2)
    assert np.array_equal(back, x.numpy())


def test_wrapper_on_cpu_takes_plain_without_counting():
    spec = FT63
    plan = ntt.get_ntt(spec, 64)
    x = _limbs(spec, [_vals(spec, 50, seed=6)])
    before = ntt.ntt_forward.launches
    got = ntt.ntt_forward(plan, x)
    got2, words = ntt.ntt_forward(plan, x, output="both")
    assert ntt.ntt_forward.launches == before
    want = ntt.ntt_forward_plain(plan, x)
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert torch.equal(words, pack_row_words(get_ops(spec).from_mont(want)))
    with pytest.raises(ValueError, match="device"):
        ntt.ntt_forward(plan, x.to("meta"))
    assert ntt.ntt_forward.launches == before
    # the four-step transform likewise: plain on the CPU, no launch counted;
    # its kernel's wrapper refuses CPU and mixed devices
    mx, dft = mxu_ntt.get_mxu_ntt(spec, 64), mxu_ntt.mxu_dft.launches
    got3, words3 = mx(x, output="both")
    assert torch.equal(got3, want) and torch.equal(words3, words)
    assert torch.equal(mx(x, output="words"), words)
    assert mxu_ntt.mxu_dft.launches == dft
    with pytest.raises(ValueError, match="device"):
        mx(x.to("meta"))
    k1, tw, k2 = mx.plan.device_tables("cpu")
    z = torch.empty((1, mx.plan.a, mx.plan.b, 2), dtype=torch.int32)
    kw = dict(NR=mx.plan.b, NCOL=mx.plan.a, C=mx.plan.a_nz, R=1, chunk=mxu_ntt.chunk_c(spec),
              strides=x.stride(), limbs=True, k=50, sc=mx.plan.b, sq=1, tw=tw, zout=z)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_ntt.mxu_dft(spec, 1, k1, x, **kw)
    with pytest.raises(ValueError, match="operands on"):
        mxu_ntt.mxu_dft(spec, 1, k1, x.to("meta"), **kw)
    assert mxu_ntt.mxu_dft.launches == dft


def test_wrapper_rejects_bad_operands():
    plan = ntt.get_ntt(FT63, 64)
    x = _limbs(FT63, [_vals(FT63, 64, seed=7)])
    with pytest.raises(TypeError):
        ntt.ntt_forward(plan, x.long())
    with pytest.raises(ValueError):
        ntt.ntt_forward(plan, torch.zeros((4, 1, 65), dtype=torch.int32))  # k > n
    with pytest.raises(ValueError):
        ntt.ntt_forward(plan, torch.zeros((8, 1, 64), dtype=torch.int32))  # W
    with pytest.raises(ValueError):
        ntt.NttPlan(FT63, 48)
    mx = mxu_ntt.get_mxu_ntt(FT63, 64)
    for bad in (torch.zeros((4, 1, 65), dtype=torch.int32),   # k > in_len
                torch.zeros((8, 1, 64), dtype=torch.int32),   # W
                torch.zeros((1, 64, 4), dtype=torch.int32)):  # words of 4 limbs
        with pytest.raises(ValueError):
            mx(bad, input="words" if bad.shape[0] == 1 else "limbs")
    with pytest.raises(TypeError):
        mx(x.long())
    with pytest.raises(ValueError):
        mx(x, output="none")
    with pytest.raises(ValueError):  # in_len no power of two, contraction past conv_cap
        mxu_ntt.MxuNttPlan(FT63, 64, in_len=3)
    with pytest.raises(ValueError):
        mxu_ntt.MxuNttPlan(FT255, 1 << 24)
    with pytest.raises(ValueError):
        ntt.NttPlan(FT255, 1 << (FT255.s + 1))
    with pytest.raises(ValueError):  # T wider than the head passes' stride
        ntt.plan_passes(12, 8, log_chunk=3, log_t=4)
    with pytest.raises(ValueError):  # more shared memory than a block has
        ntt.plan_passes(14, 8, log_chunk=13)


def test_launch_count_per_call():
    # one launch per pass: 7 head stages in one shared-memory pass, then the
    # 1,024-element chunks; n <= 1,024 is one pass
    assert ntt.get_ntt(FT255, 1 << 17).launches_per_call == 2
    assert ntt.get_ntt(FT255, 2048).launches_per_call == 2
    assert ntt.get_ntt(FT63, 1024).launches_per_call == 1
    assert ntt.get_ntt(FT63, 2).launches_per_call == 1
    assert ntt.plan_passes(17, 8) == (ntt.NttPass(16, 10, 3), ntt.NttPass(9, 0, 0))
    assert ntt.plan_passes(20, 8) == (ntt.NttPass(19, 15, 3), ntt.NttPass(14, 10, 3),
                                      ntt.NttPass(9, 0, 0))


# ---- the kernel's pass plan and the pass-grouped plain ladder ----------------------


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_plan_passes_cover_the_ladder(spec):
    # every n from 2 to the 2-adicity cap: every stage exactly once, in
    # ladder order; shared memory within a block's; T contiguous residues
    w32 = spec.w16 // 2
    for log_n in range(1, spec.s + 1):
        passes = ntt.plan_passes(log_n, w32)
        stages = [s for ps in passes for s in range(ps.hi, ps.lo - 1, -1)]
        assert stages == list(range(log_n - 1, -1, -1)), log_n
        assert passes[-1].lo == 0 and passes[-1].log_t == 0
        assert passes[-1].log_tile == min(log_n, ntt.LOG_CHUNK)
        # the inverse: the same passes reversed, stages ascending, the first
        # a contiguous chunk (it reads the limbs), the last the widest; each
        # pass's rounds cover its stages once, a radix-4 unit a thread
        inv = ntt.InttPlan(spec, 1 << log_n).passes
        assert inv == passes[::-1]
        assert [s for ps in inv for s in range(ps.lo, ps.hi + 1)] == list(range(log_n))
        assert inv[0].lo == 0 and inv[0].log_t == 0 and inv[-1].hi == log_n - 1
        for ps in inv:
            rounds = ntt.inverse_rounds(ps.hi - ps.lo + 1)
            assert [k + i for k, st in rounds for i in range(st)] == list(range(ps.hi - ps.lo + 1))
            assert all(st == 2 for _, st in rounds[1:])
        # the block sizes measured for the shipped plans: at n = 2^17 both
        # passes' 1,024-element tiles take 256 threads at verify's 2 rows
        # (256 tiles) and 128 at 256 rows (32,768 tiles); n = 2 one thread
        if log_n in (1, 17):
            want = [(1, 1)] if log_n == 1 else [(256, 128)] * 2
            assert [(ps.inverse_threads(256), ps.inverse_threads(1 << 15)) for ps in inv] == want
        assert len(passes) <= 1 + -(-max(0, log_n - ntt.LOG_CHUNK) // 8)
        for ps in passes:
            assert ps.smem_bytes(w32) <= 232448
            assert ps.log_t <= ps.lo and ps.log_tile <= log_n
            assert 32 <= ps.threads(1 << 20) <= 256 and 32 <= ps.threads(1) <= 256
            if log_n <= 16:  # the tiles of a row partition it
                idx = ps.tile_indices(log_n)
                assert np.array_equal(np.sort(idx.ravel()), np.arange(1 << log_n))
                # T consecutive residues per group row
                t_n = 1 << ps.log_t
                assert np.all(np.diff(idx.reshape(-1, t_n), axis=1) == 1)


_FORCED_3 = dict(log_chunk=8, max_tile_bytes=512)  # ft63 n = 4096: 2 + 2 + 8 stages


@pytest.mark.parametrize("n,kw", [(2, {}), (64, {}), (1024, {}), (4096, {}), (4096, _FORCED_3)],
                         ids=["2", "64", "1024", "4096", "4096-3-passes"])
def test_passes_plain_matches_reference_ladder_ft63(n, kw):
    spec = FT63
    plan = ntt.NttPlan(spec, n, **kw)
    if kw:
        assert len(plan.passes) == 3
    # three rows: the reference ladder's shapes of test_plain_matches_reference_ladder_ft63
    rows = [_vals(spec, n, seed=300 + n), [0] * n, [spec.p - 1] * n]
    x = _limbs(spec, rows)
    want = np.asarray(jntt.get_ntt(J_FIELDS[spec.name], n)(x.numpy().astype(np.uint32)))
    got = ntt.ntt_forward_passes_plain(plan, x)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, ntt.ntt_forward_plain(plan, x))


@pytest.mark.parametrize("n,kw", [(2, {}), (2048, {}), (2048, dict(log_chunk=6, log_t=2,
                                                                    max_tile_bytes=1024))],
                         ids=["2", "2048", "2048-3-passes"])
def test_passes_plain_matches_host_ft255(n, kw):
    # rows of 0, of p-1, a delta, random, and short rows zero-padded
    spec = FT255
    plan = ntt.NttPlan(spec, n, **kw)
    delta = [0] * n
    delta[n // 2] = 1
    full = [[0] * n, [spec.p - 1] * n, delta, _vals(spec, n, seed=n + 1)]
    got = _decode(spec, ntt.ntt_forward_passes_plain(plan, _limbs(spec, full)))
    assert got == [ntt.ntt_host(spec, row) for row in full]
    k = max(1, n // 4)
    short = [_vals(spec, k, seed=n + 2), [spec.p - 1] * k]
    got = _decode(spec, ntt.ntt_forward_passes_plain(plan, _limbs(spec, short)))
    assert got == [ntt.ntt_host(spec, row + [0] * (n - k)) for row in short]


@pytest.mark.parametrize("n", [64, 1024])
def test_words_match_reference_canon_pack_ft63(n):
    # short rows (zero-padded), p-1 and a delta; three rows, so the reference
    # ladder reuses the shapes compiled above
    spec = FT63
    js = J_FIELDS[spec.name]
    k = n * 3 // 4
    delta = [0] * k
    delta[1] = 1
    x = _limbs(spec, [_vals(spec, k, seed=400 + n), [spec.p - 1] * (n // 2) + [0] * (k - n // 2),
                      delta])
    y = np.asarray(jntt.get_ntt(js, n)(np.pad(x.numpy(), ((0, 0), (0, 0), (0, n - k)))
                                       .astype(np.uint32)))
    want = np.asarray(jproto._canon_pack_fn(j_get_ops(js))(y)).astype(np.uint32)
    limbs, words = ntt.ntt_forward(ntt.get_ntt(spec, n), x, output="both")
    assert np.array_equal(limbs.numpy(), y)
    assert words.shape == (3 * 2, n) and words.dtype == torch.int32
    assert np.array_equal(words.numpy().view(np.uint32), want)


def test_words_match_host_ft255():
    # the canonical value of column c of row r is words r*8 .. r*8+7, LE;
    # values near p have words with the top bit set
    spec, n = FT255, 256
    rows = [_vals(spec, n, seed=41), [spec.p - 1] * 100]
    _, words = ntt.ntt_forward(ntt.get_ntt(spec, n), _limbs(spec, [rows[0], rows[1] + [0] * 156]),
                               output="both")
    u = words.numpy().astype(np.int64) & 0xFFFFFFFF
    assert int(words.min()) < 0
    for r, row in enumerate(rows):
        want = ntt.ntt_host(spec, row + [0] * (n - len(row)))
        got = [sum(int(u[8 * r + i, c]) << (32 * i) for i in range(8)) for c in range(n)]
        assert got == want


@pytest.mark.parametrize("spec", ALL_FIELDS, ids=lambda s: s.name)
def test_words_only_last_pass(spec):
    # output="words": the words alone, equal to the words written beside the
    # limbs (the streaming commit's encode, Ligero's encode_rows_words_only)
    n = 256
    plan = ntt.get_ntt(spec, n)
    x = _limbs(spec, [_vals(spec, 200, seed=50), [spec.p - 1] * 200])
    limbs, words = ntt.ntt_forward(plan, x, output="both")
    only = ntt.ntt_forward(plan, x, output="words")
    assert torch.equal(only, words)
    enc = LigeroEncoding.new_from_dims(spec, 200, n, 1, 2, device="cpu")
    assert torch.equal(enc.encode_rows_words_only(x), words)
    with pytest.raises(ValueError, match="output must be"):
        ntt.ntt_forward(plan, x, output="none")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LigeroEncoding.new(FT255, 1000, 1, 4)
    enc = LigeroEncoding.new(FT255, 1000, 1, 4, device="cpu")
    assert enc.device.type == "cpu"
    rows = [random.Random(8).randrange(FT255.p) for _ in range(enc.n_per_row)]
    assert _decode(FT255, enc.encode_rows(_limbs(FT255, [rows]))) == [enc.encode_row_host(rows)]
