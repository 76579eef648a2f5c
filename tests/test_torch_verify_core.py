"""The verifier's fused core and the prover's one-launch opening
(lcpc_tpu_torch/ops/verify_core.py) against lcpc_tpu, tolerance 0 (exact
field arithmetic).

- ft63, BLAKE3 and SHA-256: verify_check and verify_walk (on CPU tensors:
  verify_check_plain and the digests' merkle_walk_plain) against lcpc_tpu's
  `_verify_core_fn` (the encoded rows at the opened columns) and
  `_verify_core_cols_fn` (the rows at the columns), fed `_eval_dot_fn`'s
  evaluation, on an honest instance and four tampers: a column word, an
  encoded row at an opened column, a sibling digest, the root.  The flags
  and the evaluation are equal.  gather_open_plain against `_gather_open`
  and `streaming._gather_canon_fn`.
- ft255 through Python ints (lcpc_tpu's ft255 graphs compile for minutes on
  XLA:CPU): the check, the evaluation, the hash words and the opening, with
  all-0xFFFF limbs, values near p and words with the top bit set.
- the wrappers' refusals: meta tensors, mixed devices, dtypes, shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcpc_tpu as J
from lcpc_tpu.core import protocol as jprotocol
from lcpc_tpu.core import streaming as jstreaming
from lcpc_tpu.ops import digest as jdigest
from lcpc_tpu.ops.limbs import get_ops as j_get_ops
import lcpc_tpu_torch as P
from lcpc_tpu_torch.core.protocol import path_node_indices
from lcpc_tpu_torch.ops import verify_core as vc
from lcpc_tpu_torch.utils.tensors import seeded_values

torch.set_num_threads(1)  # the xdist workers share the cores

TAMPERS = ("honest", "column word", "encoded row", "sibling", "root")


def _words(v: int, n: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


class Instance:
    """A verify core's inputs at `spec` whose checks all pass: T tensors of
    R rows, k opened columns of an n_cols-column codeword (a column opened
    twice, column 1 all-ones words: any value below R is a column word),
    the encoded rows holding to_mont of each column's sums at the opened
    columns, p_eval and inner of npr, and a Merkle tree (the port's digest,
    plain) over random leaves with the opened columns' digests at idx."""

    def __init__(self, spec, digest, seed, T=4, R=6, n_cols=16, idx=(3, 9, 3, 14, 0), npr=7,
                 col_values=None):
        self.spec, self.digest, self.T, self.R = spec, digest, T, R
        p, w32 = spec.p, spec.w16 // 2
        self.Rm = 1 << (32 * w32)
        self.rinv = pow(self.Rm, -1, p)
        k = len(idx)
        vals = iter(seeded_values(p, spec.w16, T * R + R * k + 2 * npr + T * n_cols, seed))
        self.t = [[next(vals) for _ in range(R)] for _ in range(T)]
        if col_values is None:  # raw Montgomery words: x R mod p of random x
            col_values = [[next(vals) * self.Rm % p for _ in range(k)] for _ in range(R)]
            for r in range(R):
                col_values[r][1] = self.Rm - 1
                if k > 2 and idx[2] == idx[0]:  # one column, one value
                    col_values[r][2] = col_values[r][0]
        self.X = col_values
        self.pe = [next(vals) for _ in range(npr)]
        self.inner = [next(vals) for _ in range(npr)]
        self.idx = np.asarray(idx, dtype=np.int64)
        got = [[sum(self.t[t][r] * self.X[r][j] for r in range(R)) * self.rinv % p
                for j in range(k)] for t in range(T)]
        self.want_mont = [[g * self.Rm % p for g in row] for row in got]
        rows = [[next(vals) * self.Rm % p for _ in range(n_cols)] for _ in range(T)]
        for t in range(T):
            for j, c in enumerate(idx):
                rows[t][c] = self.want_mont[t][j]
        self.enc_words = np.array([[_words(v, w32) for v in row] for row in rows],
                                  dtype=np.uint32).transpose(2, 0, 1)  # (W/2, T, n_cols)
        self.want_w = np.array([[_words(v, w32) for v in row] for row in self.want_mont],
                               dtype=np.uint32).transpose(2, 0, 1)  # (W/2, T, k)
        self.ts_w = np.array([[_words(v * self.Rm % p, w32) for v in row] for row in self.t],
                             dtype=np.uint32).transpose(2, 0, 1)  # (W/2, T, R)
        self.col_w = np.array([[_words(v, w32) for v in row] for row in self.X],
                              dtype=np.uint32).transpose(2, 0, 1)  # (W/2, R, k)
        self.pe_w = np.array([_words(v, w32) for v in self.pe], dtype=np.uint32)  # (npr, W/2)
        self.inner_w = np.array([_words(v, w32) for v in self.inner], dtype=np.uint32)
        self.eval = sum(a * b for a, b in zip(self.pe, self.inner)) % p
        # the opened columns' canonical hash words, (R W/2, k)
        self.hash_words = np.array([[_words(self.X[r][j] * self.rinv % p, w32)[i]
                                     for j in range(k)] for r in range(R) for i in range(w32)],
                                   dtype=np.uint32)
        leaves = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 1 << 32, (8, n_cols), dtype=np.int64))
        leaves[:, torch.from_numpy(self.idx)] = digest.hash_word_columns(
            torch.from_numpy(self.hash_words.astype(np.int64)))
        np2 = 1 << (n_cols - 1).bit_length()
        self.tree = digest.merkle_tree(leaves, np2).numpy()
        self.root = self.tree[:, -1].copy()
        pos = path_node_indices(n_cols, idx)
        uniq, inv = np.unique(pos.reshape(-1), return_inverse=True)
        self.uniq = uniq.astype(np.int64)
        self.sibs = self.tree[:, uniq]
        self.inv = np.ascontiguousarray(inv.reshape(k, -1).T).astype(np.int64)

    def tampered(self, what):
        """(col_w, enc_words, want_w, sibs, root) with one tamper applied."""
        col_w, enc, want_w = self.col_w.copy(), self.enc_words.copy(), self.want_w.copy()
        sibs, root = self.sibs.copy(), self.root.copy()
        if what == "column word":
            col_w[0, 0, 3] ^= 1
        elif what == "encoded row":
            enc[0, 0, self.idx[1]] ^= 1
            want_w[0, 0, 1] ^= 1
        elif what == "sibling":
            sibs[0, self.inv[0, 4]] ^= 1
        elif what == "root":
            root[0] ^= 1
        return col_w, enc, want_w, sibs, root


def _limbs(words: np.ndarray) -> np.ndarray:
    """(W/2, ...) u32 words -> (W, ...) u32 16-bit limbs."""
    out = np.empty((2 * words.shape[0], *words.shape[1:]), dtype=np.uint32)
    out[0::2], out[1::2] = words & 0xFFFF, words >> 16
    return out


def _t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


def _port(inst, what, want_cols):
    """The port's core on CPU tensors: (T row flags + path flag, evaluation),
    with verify_check_plain's and verify_walk_plain's answers held to them."""
    spec, T = inst.spec, inst.T
    col_w, enc, want_w, sibs, root = inst.tampered(what)
    want = _t32(want_w) if want_cols else _t32(_limbs(enc))
    args = (_t32(inst.ts_w), _t32(col_w), want, torch.from_numpy(inst.idx))
    ev_args = dict(p_eval=_t32(inst.pe_w), inner=_t32(inst.inner_w))
    state = torch.from_numpy(vc.state_init(spec, T))
    words = vc.verify_check(spec, state, *args, want_cols=want_cols, **ev_args)
    digs = inst.digest.hash_word_columns(words)
    sibs_t, inv_t = torch.from_numpy(sibs.astype(np.int64)), torch.from_numpy(inst.inv)
    root_t = torch.from_numpy(root.astype(np.int64))
    vc.verify_walk(inst.digest, state, T, digs, sibs_t, inv_t, args[3], root_t)
    flags, value = vc.read_state(spec, state.numpy(), T)
    ok, ev, pwords = vc.verify_check_plain(spec, *args, want_cols=want_cols, **ev_args)
    assert flags[:T].tolist() == ok.tolist() and torch.equal(words, pwords)
    assert _int(ev.numpy().view(np.uint32)) == value
    assert bool(vc.verify_walk_plain(inst.digest, digs, sibs_t, inv_t, args[3], root_t)) \
        == flags[T]
    return flags.tolist(), value


def _reference(inst, what, want_cols, jd):
    """lcpc_tpu's core on the same inputs, fed _eval_dot_fn's evaluation."""
    jops = j_get_ops(J.FT63)
    col_w, enc, want_w, sibs, root = inst.tampered(what)
    rows_w = jnp.asarray(inst.pe_w[None])  # p_eval is the last (only) row
    eval_w = jprotocol._eval_dot_fn(jops)(rows_w, jnp.asarray(inst.inner_w))
    bits = ((inst.idx[None, :] >> np.arange(inst.inv.shape[0])[:, None]) & 1).astype(bool)
    common = (jnp.asarray(_limbs(inst.ts_w)), jnp.asarray(col_w))
    tail = (jnp.asarray(sibs.astype(np.uint32)), jnp.asarray(inst.inv.astype(np.int32)),
            jnp.asarray(bits), jnp.asarray(root.astype(np.uint32)), eval_w)
    if want_cols:
        flags = jprotocol._verify_core_cols_fn(jops, jd)(jnp.asarray(want_w), *common, *tail)
    else:
        flags = jprotocol._verify_core_fn(jops, jd)(
            jnp.asarray(_limbs(enc)), *common, jnp.asarray(inst.idx.astype(np.int32)), *tail)
    flags = np.asarray(flags)
    T = inst.T
    value = int.from_bytes(flags[T + 2 :].astype("<u2").tobytes(), "little")
    return [bool(v) for v in flags[: T + 1]], value


@pytest.mark.parametrize("digest_name,want_cols", [("blake3", False), ("blake3", True),
                                                   ("sha256", False), ("sha256", True)])
def test_core_matches_reference_ft63(digest_name, want_cols):
    digest = P.DIGESTS_BY_NAME[digest_name]
    jd = jdigest.BLAKE3 if digest_name == "blake3" else jdigest.SHA256
    inst = Instance(P.FT63, digest, seed=7)
    results = {}
    for what in TAMPERS:
        got = _port(inst, what, want_cols)
        assert got == _reference(inst, what, want_cols, jd), what
        results[what] = got
    T = inst.T
    assert results["honest"] == ([True] * (T + 1), inst.eval)
    assert results["column word"][0] == [False] * (T + 1)  # every row and the path
    assert results["encoded row"][0] == [False] + [True] * T
    assert results["sibling"][0] == results["root"][0] == [True] * T + [False]
    if digest_name == "blake3" and not want_cols:
        # verify's rows: the proof rows' canonical words (any value below R,
        # all-ones and top-bit words among them) to Montgomery form and
        # encoded, by the port's words-in route (encode_canon_rows: on CPU
        # tensors mont_mul_map_plain then the plain encode; Brakedown's
        # conversion written into the level buffer) against lcpc_tpu's
        # to_mont and encode as its host twins compute them (encode_host's
        # to_mont of encode_row_host's codeword: the encode is linear; its
        # jitted _rows_encode_fn recompiles for 3-9 s on XLA:CPU)
        jops = j_get_ops(J.FT63)
        for ours, theirs in ((P.LigeroEncoding.new_from_dims(P.FT63, 16, 64, 1, 4, device="cpu"),
                              J.LigeroEncoding.new_from_dims(J.FT63, 16, 64, 1, 4)),
                             (P.SdigEncoding(P.FT63, 64, seed=3, device="cpu"),
                              J.SdigEncoding(J.FT63, 64, seed=3))):
            rows = np.random.default_rng(3).integers(0, 1 << 32, (2, ours.n_per_row, 2),
                                                     dtype=np.uint32)
            rows[0, :3] = 0xFFFFFFFF
            rows[1, :3] |= np.uint32(1 << 31)
            got = P.core.protocol._rows_encode(ours, _t32(rows)).numpy().astype(np.uint32)
            ints = [[_int(e) % J.FT63.p for e in row] for row in rows]
            want = np.stack([jops.encode_host(theirs.encode_row_host(v)) for v in ints], axis=1)
            assert np.array_equal(got, want), type(ours).__name__


@pytest.mark.parametrize("form", ["limbs", "canon", "words", "mixed"])
def test_gather_matches_reference_ft63(form):
    """gather_open_plain against lcpc_tpu's _gather_open (the codeword's
    limbs) and streaming._gather_canon_fn (the kept canonical words), both
    at once for a tail keep (columns below off from the limbs, the rest
    from the kept words), and int64 u32 words picked as they are; the
    opened columns unsorted, with repeats.  The wrapper on CPU tensors is
    the plain version by the kernel's plan (gather_plan), given or made."""
    spec = P.FT63
    w32, R, n_cols = spec.w16 // 2, 5, 32
    rng = np.random.default_rng(11)
    cols = [7, 30, 7, 0, 19, 30, 7]
    off = 16 if form == "mixed" else n_cols
    hashes = rng.integers(0, 1 << 32, (8, 2 * n_cols - 1), dtype=np.int64)
    uniq = np.unique(path_node_indices(n_cols, cols)).astype(np.int64)
    idx = torch.tensor(cols, dtype=torch.int64)
    j_cols, j_uniq = jnp.asarray(np.asarray(cols, np.int32)), jnp.asarray(uniq.astype(np.int32))
    j_hashes = jnp.asarray(hashes.astype(np.uint32))
    comm = rng.integers(0, 1 << 16, (spec.w16, R, n_cols)).astype(np.uint32)
    comm[:, :, 30] = 0xFFFF  # unreduced: packed as it is
    vals = seeded_values(spec.p, spec.w16, R * n_cols, 12)
    words = np.array([[_words(vals[r * n_cols + c], w32)[i] for c in range(n_cols)]
                      for r in range(R) for i in range(w32)], dtype=np.uint32)
    jl, jd = jprotocol._gather_open(jnp.asarray(comm), j_hashes, j_cols, j_uniq)
    jc, _ = jstreaming._gather_canon_fn(j_get_ops(J.FT63))(jnp.asarray(words), j_hashes, j_cols,
                                                         j_uniq)
    if form == "limbs":
        kw, jw = dict(mont=_t32(comm), off=n_cols), np.asarray(jl)
    elif form == "canon":
        kw, jw, off = dict(canon=_t32(words)), np.asarray(jc), 0
    elif form == "words":  # int64 u32 words, the columns made apart (the 2^29 opening)
        packed = (comm[0::2] | (comm[1::2] << np.uint32(16))).astype(np.int64)
        kw, jw = dict(mont=torch.from_numpy(packed), mont_form="words", off=n_cols), \
            np.asarray(jl)
    else:  # the tail keep: the kept words hold columns off .. n_cols - 1
        kw = dict(mont=_t32(comm), off=off, canon=_t32(words[:, off:]))
        jw = np.where(np.asarray(cols) < off, np.asarray(jl), np.asarray(jc))
    args = (spec, idx, R)
    kw.update(hashes=torch.from_numpy(hashes), uniq=torch.from_numpy(uniq))
    plan = vc.gather_plan(cols, off)
    assert (plan.n_unique, plan.n_mont) == (4, 4 if off == n_cols else 2 if off else 0)
    got = vc.gather_open(*args, **kw)
    assert torch.equal(got, vc.gather_open(*args, plan=plan, **kw))
    assert torch.equal(got, vc.gather_open_plain(*args, plan=plan, **kw))
    got = got.numpy().view(np.uint32)
    n = w32 * R * len(cols)
    assert np.array_equal(got[:n].reshape(w32, R, len(cols)), jw)
    assert np.array_equal(got[n:].reshape(8, -1), np.asarray(jd))


@pytest.mark.parametrize("cols,off", [([], 0), ([5], 0), ([9, 2, 9, 40, 2, 9, 0], 9),
                                      ([3, 3, 3, 3], 4), (list(range(6)), 6),
                                      (list(np.random.default_rng(5).integers(0, 357_699, 6_593)),
                                       200_000)])
def test_gather_plan(cols, off):
    """The gather's host plan: the unique columns ascending, each one's run
    of slots (every slot once, in transcript order within a run), the
    columns below off counted; its table's layout is what gather_open_kernel
    reads (csrc/verify_core.cu)."""
    table, U, n_mont = vc.plan_host(cols, off)
    idx = np.asarray(cols, dtype=np.int64)
    k = idx.size
    assert table.dtype == np.int32 and table.shape == (4 * U + k,)
    head, perm = table[: 4 * U].reshape(U, 4), table[4 * U :]
    ucols, first, starts, runs = head.T
    assert np.array_equal(ucols, np.unique(idx)) and U == np.unique(idx).size
    assert np.array_equal(starts, np.cumsum(runs) - runs) and runs.sum() == k
    assert np.array_equal(np.sort(perm), np.arange(k))
    for i in range(U):
        run = perm[starts[i] : starts[i] + runs[i]]
        assert run[0] == first[i] and np.all(idx[run] == ucols[i]) and np.all(np.diff(run) > 0)
    assert n_mont == int(np.sum(ucols < off))
    # the kernel's tasks (Montgomery source: 256 columns a warp; canonical:
    # 64) cover each unique column once
    tm, tc = vc.GATHER_TASK_COLS
    seen = [i for c in range(-(-n_mont // tm)) for i in range(c * tm, min(n_mont, c * tm + tm))]
    seen += [n_mont + i for c in range(-(-(U - n_mont) // tc))
             for i in range(c * tc, min(U - n_mont, c * tc + tc))]
    assert seen == list(range(U))


@pytest.mark.parametrize("R,k,npr,splits", [(1, 189, 0, 1), (37, 189, 4_096, 2),
                                            (128, 189, 7, 8), (256, 189, 32_768, 16),
                                            (36, 6_593, 235_173, 1), (2_048, 189, 262_144, 16),
                                            (100, 189, 1, 6), (300, 1_000, 9, 5)])
def test_cluster_plan_and_state(R, k, npr, splits):
    """verify_check's launch plan on a 132-SM card: the rows of each
    32-column group split over a cluster of at most 16 blocks, every block
    some rows and every row one block (R = 1, R not divisible by the split,
    splits of 1, 2, 8 and 16 and between); the eval blocks in clusters of
    the same size; the shared memory within a block's in every field; and
    the state's layout (T flags, the path flag, the evaluation, the eval
    counter) through state_len, state_init and read_state."""
    got, rows = vc._split(132, R, k)
    assert got == splits and splits <= vc.CLUSTER_MAX
    assert -(-k // vc.COLS) * (splits - 1) < 132  # no more than cover every SM
    spans = [(y * rows, min(R, y * rows + rows)) for y in range(splits)]
    assert all(a < b for a, b in spans) and spans[0][0] == 0 and spans[-1][1] == R
    assert all(spans[y][1] == spans[y + 1][0] for y in range(splits - 1))
    assert splits == 1 or rows >= vc.CHUNK
    col_blocks = -(-k // vc.COLS) * splits
    for wave in (2 * 132 - 16, 2 * 132):  # the blocks a card holds, two an SM
        blocks = vc._eval_blocks(npr, splits, col_blocks, wave)
        assert blocks % splits == 0 and (npr > 0) == (blocks > 0)
        assert blocks <= max(splits, min(wave - col_blocks, -(-npr // vc.EVAL_J)))
        assert npr == 0 or blocks >= min(-(-npr // vc.EVAL_J), wave - col_blocks) - splits + 1
    for spec in P.ALL_FIELDS:
        w32, T = spec.w16 // 2, 2
        assert max(vc._check_smem(w32, T, c) for c in (False, True)) <= vc.SMEM_MAX
        n = vc.state_len(spec, T)
        assert n == T + 1 + w32 + 1
        s = vc.state_init(spec, T)
        assert s.shape == (n,) and s.tolist() == [1] * (T + 1) + [0] * (w32 + 1)
        ev = (spec.p - 1 - R) % spec.p
        s[T + 1 : T + 1 + w32] = np.array(_words(ev, w32), dtype=np.uint32).view(np.int32)
        s[1] = 0
        flags, value = vc.read_state(spec, s, T)
        assert flags.tolist() == [True, False, True] and value == ev


def test_ft255_against_ints():
    """At ft255 through Python ints: the check (honest, then one encoded
    row off by one), the evaluation, the hash words and both openings, with
    column words all ones (all-0xFFFF limbs: R - 1), p - 1, p, 2p and top
    bits set, inner and p_eval near p."""
    spec = P.FT255
    p, w32 = spec.p, spec.w16 // 2
    Rm = 1 << (32 * w32)
    R, k = 3, 4
    X = [[Rm - 1, p - 1, p, 2 * p], [(1 << 255) | 5, p - 2, 1 << 31, (1 << 255) + p],
         [0, 1, Rm - p, (p - 1) * Rm % p]]
    inst = Instance(spec, P.BLAKE3, seed=3, T=2, R=R, n_cols=8, idx=(5, 1, 6, 2), npr=3,
                    col_values=X)
    inst.pe[0] = inst.inner[0] = p - 1
    inst.pe_w[0] = inst.inner_w[0] = _words(p - 1, w32)
    inst.eval = sum(a * b for a, b in zip(inst.pe, inst.inner)) % p
    flags, value = _port(inst, "honest", False)
    assert flags == [True] * 3 and value == inst.eval
    flags, _ = _port(inst, "encoded row", False)
    assert flags == [False, True, True]
    assert flags == _port(inst, "encoded row", True)[0]
    words = vc.verify_check_plain(spec, _t32(inst.ts_w), _t32(inst.col_w),
                                  _t32(_limbs(inst.enc_words)), torch.from_numpy(inst.idx))[2]
    assert np.array_equal(words.numpy().view(np.uint32), inst.hash_words)
    # the openings: limbs packed as they are; canonical words to x R mod p
    hashes = torch.arange(8 * 15, dtype=torch.int64).reshape(8, 15) * 0x9E3779B1 % (1 << 32)
    uniq = torch.tensor([0, 3, 14], dtype=torch.int64)
    idx = torch.tensor([1, 0, 1], dtype=torch.int64)
    got = vc.gather_open(spec, idx, R, mont=_t32(_limbs(inst.col_w)), off=k, hashes=hashes,
                         uniq=uniq).numpy().view(np.uint32)
    n = w32 * R * 3
    assert np.array_equal(got[:n].reshape(w32, R, 3), inst.col_w[:, :, [1, 0, 1]])
    assert np.array_equal(got[n:].reshape(8, 3), hashes[:, uniq].numpy())
    canon = np.array([[_words(v, w32)[i] for v in (p - 1, 0, 1, p - 2)] for _ in range(R)
                      for i in range(w32)], dtype=np.uint32)
    got = vc.gather_open(spec, idx, R, canon=_t32(canon), hashes=hashes, uniq=uniq)
    got = got.numpy().view(np.uint32)[:n].reshape(w32, R, 3)
    for j, c in enumerate((1, 0, 1)):
        want = (p - 1, 0, 1, p - 2)[c] * Rm % p
        assert all(_int(got[:, r, j]) == want for r in range(R))


def test_wrappers_refuse():
    """No fallback and no guessing: meta tensors (a device without the
    kernel), mixed devices, wrong dtypes and shapes raise."""
    spec = P.FT63
    inst = Instance(spec, P.BLAKE3, seed=5, T=2, R=3, n_cols=8, idx=(1, 2), npr=2)
    ts, col, idx = _t32(inst.ts_w), _t32(inst.col_w), torch.from_numpy(inst.idx)
    enc = _t32(_limbs(inst.enc_words))
    state = torch.from_numpy(vc.state_init(spec, 2))
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        vc.verify_check(spec, meta(state), meta(ts), meta(col), meta(enc), meta(idx))
    with pytest.raises(ValueError, match="different devices"):
        vc.verify_check(spec, state, ts, col, meta(enc), idx)
    for bad in (dict(ts=ts.long()), dict(idx=idx.int()), dict(enc=enc.long())):
        a = dict(ts=ts, col=col, enc=enc, idx=idx) | bad
        with pytest.raises(TypeError):
            vc.verify_check(spec, state, a["ts"], a["col"], a["enc"], a["idx"])
    for call in (lambda: vc.verify_check(spec, state, ts, col[:, :2], enc, idx),  # rows
                 lambda: vc.verify_check(spec, state[:-1], ts, col, enc, idx),
                 lambda: vc.verify_check(spec, state, ts, col, enc[:, :1], idx),
                 lambda: vc.verify_check(spec, state, ts, col, enc, idx,
                                         p_eval=_t32(inst.pe_w)),  # inner missing
                 lambda: vc.verify_check(spec, state, ts, col, enc, idx, want_cols=True)):
        with pytest.raises(ValueError):
            call()
    digs = torch.zeros((8, 2), dtype=torch.int64)
    inv = torch.from_numpy(inst.inv)
    sibs, root = torch.from_numpy(inst.sibs.astype(np.int64)), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="unsupported device"):
        vc.verify_walk(P.SHA256, meta(state), 2, meta(digs), meta(sibs), meta(inv), meta(idx),
                       meta(root))
    with pytest.raises(ValueError, match="different devices"):
        vc.verify_walk(P.BLAKE3, state, 2, digs, sibs, inv, idx, meta(root))
    with pytest.raises(TypeError):
        vc.verify_walk(P.BLAKE3, state.long(), 2, digs, sibs, inv, idx, root)
    with pytest.raises(ValueError):
        vc.verify_walk(P.SHA256, state, 2, digs, sibs, inv, idx, root[:4])
    hashes, uniq = torch.zeros((8, 15), dtype=torch.int64), torch.tensor([0, 3])
    mont = torch.zeros((spec.w16, 3, 8), dtype=torch.int32)  # the codeword's limbs
    with pytest.raises(ValueError, match="unsupported device"):
        vc.gather_open(spec, meta(idx), 3, mont=meta(mont), off=8, hashes=meta(hashes),
                       uniq=meta(uniq))
    with pytest.raises(ValueError, match="different devices"):
        vc.gather_open(spec, idx, 3, mont=mont, off=8, hashes=meta(hashes), uniq=uniq)
    with pytest.raises(TypeError):
        vc.gather_open(spec, idx.int(), 3, mont=mont, off=8, hashes=hashes, uniq=uniq)
    for kw in (dict(mont=mont, off=0), dict(off=8), dict(mont=mont[:, :2], off=8),
               dict(mont=mont, off=8, mont_form="planes"), dict(canon=col, off=0)):
        with pytest.raises(ValueError):
            vc.gather_open(spec, idx, 3, hashes=hashes, uniq=uniq, **kw)
