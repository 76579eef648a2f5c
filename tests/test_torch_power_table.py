"""The power table's host side on the CPU: MxuColumnEval's points
(`column_points`, bit-reversing only the opened columns) against lcpc_tpu's
`bit_reverse_indices` over every column, and a plain model of
csrc/power_table.cu's index arithmetic (its grid split, its per-point
tables and each warp's runs of tiles, the kernel's constants read from the
source) showing that every entry (m, j) of the padded table is written
exactly once, with the exponent m = lo + hi, and that every table entry a
used lane reads was built.  Tolerance 0: exact ints."""

import os
import random
import re

import numpy as np
import pytest
import torch

import lcpc_tpu_torch as P
from lcpc_tpu.ops.ntt import bit_reverse_indices as ref_bit_reverse_indices
from lcpc_tpu_torch.ops import mont_dot as MD
from lcpc_tpu_torch.ops import mxu_prove as M
from lcpc_tpu_torch.ops.limbs import get_ops
from lcpc_tpu_torch.ops.spmv import unpack_words

torch.set_num_threads(1)  # the xdist workers share the cores

_SRC = os.path.join(os.path.dirname(P.__file__), "csrc", "power_table.cu")


@pytest.mark.parametrize("name", ["FT63", "FT255"])
def test_column_points_against_bit_reverse_indices(name):
    """g_j = w^bitrev(c_j) from the opened indices alone equals the same
    point through lcpc_tpu's full bit-reversal, at n_cols = 2 .. 2^20, for
    random opened columns with 0 and n - 1 among them; set_columns' table
    holds those points at m = 1."""
    spec = getattr(P, name)
    rnd = random.Random(13)
    for log_n in range(1, 21):
        n = 1 << log_n
        cols = [0, n - 1] + [rnd.randrange(n) for _ in range(20)]
        rev = ref_bit_reverse_indices(n)
        w = spec.root_for_log_len(log_n)
        assert M.column_points(spec, n, cols) == [pow(w, int(rev[c]), spec.p) for c in cols]
    enc = P.LigeroEncoding.new_from_dims(spec, 40, 128, 1, 4, device="cpu")
    cols = [0, 127, 3, 64, 3]
    ev = M.MxuColumnEval(enc)
    ev.set_columns(cols)
    words = unpack_words(MD.planes_to_words(ev._table, enc.n_per_row), 0)  # (W, K, k)
    assert get_ops(spec).decode_host(words[:, 1]) == M.column_points(spec, 128, cols)


def _kernel_constants():
    text = open(_SRC).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def _digit_tables(kt):
    n, c = 0, (kt - 1) >> 5
    while c:
        n, c = n + 1, c >> 5
    return n


def _model_writes(K, k, n_blocks, c):
    """The kernel's index arithmetic in plain Python: returns the (KT *
    kTile, k) count of writes, asserting as it goes that each entry's lo
    and hi exponents sum to m and that each table entry read was built."""
    tile, run, warps, pts = c["kTile"], c["kRun"], c["kWarps"], c["kPts"]
    kt = -(-K // tile)
    total = k * kt
    ndig = _digit_tables(kt)
    n_mid = min(c["kMid"], kt)
    built = [c["kDigit"] if d + 1 < ndig else min(c["kDigit"], ((kt - 1) >> (5 * (d + 1))) + 1)
             for d in range(ndig)]
    lanes = np.arange(32)
    # lo: lane l reads the entry stored at 32 q + l, which holds e = 4 l + q
    lo_exp = np.array([[4 * lane + q for lane in range(32)] for q in range(4)])
    writes = np.zeros((kt * tile, k), dtype=np.int32)
    for b in range(n_blocks):
        ua, ub = total * b // n_blocks, total * (b + 1) // n_blocks
        if ua >= ub:
            continue
        jp = ua // kt
        n_pts = (ub - 1) // kt - jp + 1
        assert n_pts <= pts  # the tables a block holds
        for w in range(warps):
            u, w1 = ua + (ub - ua) * w // warps, ua + (ub - ua) * (w + 1) // warps
            while u < w1:
                j, t = divmod(u, kt)
                assert 0 <= j - jp < n_pts
                n = min(run, w1 - u, kt - t)
                mid = t % 32 + lanes
                assert mid.max() < c["kMid"]
                assert (mid[:n] < n_mid).all()  # the used lanes read built entries
                hi = tile * mid
                cc, d = t >> 5, 0
                while cc:
                    if cc & 31:
                        assert (cc & 31) < built[d]
                        hi = hi + 4096 * 32 ** d * (cc & 31)
                    cc, d = cc >> 5, d + 1
                for s in range(n):
                    tt = t + s
                    assert hi[s] == tile * tt
                    m = tile * tt + 4 * lanes[None, :] + np.arange(4)[:, None]  # (q, lane)
                    assert (hi[s] + lo_exp == m).all()
                    np.add.at(writes[:, j], m.reshape(-1), 1)
                u += n
    return writes


@pytest.mark.parametrize("K,k,n_blocks", [
    (1, 1, 1), (127, 6, 7), (129, 33, 264), (4_097, 189, 264), (40_000, 9, 264),
    (262_144, 3, 528)])
def test_power_table_plan_writes_each_entry_once(K, k, n_blocks):
    """Every (m, j) of the (KT * 128, k) table written once, under the
    launch's own grid for n_blocks resident blocks and under other grids
    the kernel takes; K from 1 to the 2^29 prove's 262,144 (two digit
    tables)."""
    c = _kernel_constants()
    assert {"kTile", "kRun", "kWarps", "kPts", "kMid", "kDigit", "kLo"} <= set(c)
    assert c["kTile"] == MD.TC_KT and c["kLo"] == c["kTile"]
    kt = -(-K // c["kTile"])
    total = k * kt
    # the launch's grid (csrc/power_table.cu: launch): one wave of
    # n_blocks, at most a tile a warp, at least enough blocks that none
    # spans more than kPts points
    need = -(-total // ((c["kPts"] - 1) * kt))
    launch = max(need, min(n_blocks, -(-total // c["kWarps"])))
    for nb in sorted({launch, need, max(need, launch // 3), launch + 5}):
        writes = _model_writes(K, k, nb, c)
        assert (writes == 1).all(), (nb, int(writes.min()), int(writes.max()))
    # the hi decomposition at every digit count up to K = 2^30 (KT = 2^23):
    # mid[t % 32 + l] times the digit tables' entries of t / 32
    for t in [0, 31, 32, 1023, 1024, 32_767, 32_768, (1 << 20) + 5, (1 << 23) - 1]:
        cc, d, e = t >> 5, 0, c["kTile"] * (t % 32)
        while cc:
            e, cc, d = e + 4096 * 32 ** d * (cc & 31), cc >> 5, d + 1
        assert e == c["kTile"] * t and d == _digit_tables(t + 1) <= 4
