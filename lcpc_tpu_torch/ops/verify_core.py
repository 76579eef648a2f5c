"""The verifier's fused core and the prover's one-launch opening: the
wrappers of csrc/verify_core.cu (and of the digests' walk in its verifier
form), and their plain PyTorch versions.

- `verify_check(spec, state, ts, col_w, want, idx, *, want_cols, p_eval,
  inner)`: the column check of lcpc_tpu/core/protocol.py:807
  `_verify_core_fn` / :767 `_verify_core_cols_fn` (the plain value of
  sum_r ts[t, r] col[r, j] against from_mont of the encoded row at the
  opened column; a mismatch clears flag t of `state`), the opened columns'
  canonical hash words (returned, for the digest's column hash), and
  :730 `_eval_dot_fn`'s evaluation sum_j inner[j] p_eval[j] into `state`:
  one launch on a CUDA tensor (counted in verify_check.launches).
- `verify_walk(digest, state, at, digs, uniq_sibs, inv, idx, root)`: the
  digest's path walk (csrc/merkle.cuh's for BLAKE3, sha256_cols.cu's for
  SHA-256) comparing every column's root with the commitment's, clearing
  state[at] where one differs (counted in the digest's merkle_walk.launches).
- `gather_open(spec, idx, n_rows, *, mont, mont_form, canon, off, hashes,
  uniq, plan)`: :547 `_gather_open` (:538 `_gather_packed`) and
  lcpc_tpu/core/streaming.py:332 `_gather_canon_fn`: the opened columns as
  packed Montgomery words and the unique path nodes, in one buffer for one
  copy to the host; one launch (gather_open.launches).  `plan`
  (`gather_plan`, made on the host) lists idx's unique columns in ascending
  order and the slots that name each: the kernel reads each column once,
  in order, and the plain version takes the same plan.

Forms, all int32 storage of u32 words unless said: ts (W/2, T, R) and
col_w (W/2, R, k) Montgomery words; want the encoded rows (W, T, n_cols)
16-bit limbs, read at the columns idx (k,) int64, or, on the columns route
(want_cols), the rows at the opened columns (W/2, T, k) Montgomery words
(int32, or int64 u32 values); p_eval and inner (npr, W/2) canonical words.

The verifier's state (int32): T row flags, the path flag, the evaluation's
W/2 canonical words and the eval counter (`state_init` makes its initial
value on the host, which rides the verifier's one host-to-device copy;
`read_state` reads it back).  The column check meets in its clusters'
shared memory and keeps no counter.

On a CUDA tensor each entry launches its kernel or raises; on a CPU tensor
it runs its plain version (`verify_check_plain`, `verify_walk_plain`,
`gather_open_plain`, built on mont_dot_plain, mont_mul_map_plain and the
digests' merkle_walk_plain); any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from . import launch_count
from .blake3 import _check_launch, _launch_args, _plain_here
from .mont_dot import _n_sm, field_consts, mont_dot_plain
from .mont_map import mont_mul_map_plain
from .spmv import pack_words

COLS = 32         # csrc/verify_core.cu kCols: opened columns a column block
WARPS = 8         # kWarps: warps a block
CHUNK = 16        # kChunk: rows a stage of a column block's ring
STAGES = 4        # kStages: the ring's stages
ACC_WORDS = 16    # kAccWords: T is taken ACC_WORDS / W32 rows a pass
CLUSTER_MAX = 16  # kMaxCluster: blocks a cluster (the non-portable size)
SMEM_MAX = 227 * 1024  # kMaxSmem: dynamic shared memory a block
EVAL_J = 512      # j a block at least in the evaluation (two a thread)
# unique columns a gather warp takes: from limbs (32 kLaneCols), from kept
# canonical words (32 kCanonCols)
GATHER_TASK_COLS = (256, 64)
_NAME = "verify_core"


def _n_groups(k: int) -> int:
    return -(-k // COLS)


def state_len(spec: FieldSpec, T: int) -> int:
    """int32 words of the verifier's state for T rows."""
    return T + 1 + spec.w16 // 2 + 1


def state_init(spec: FieldSpec, T: int) -> np.ndarray:
    """The state's value before the check: flags 1, the evaluation and the
    eval counter 0."""
    s = np.zeros(state_len(spec, T), dtype=np.int32)
    s[: T + 1] = 1
    return s


def read_state(spec: FieldSpec, state: np.ndarray, T: int) -> tuple[np.ndarray, int]:
    """(the T row flags and the path flag as bools, the evaluation)."""
    flags = np.asarray(state[: T + 1]) != 0
    w = np.asarray(state[T + 1 : T + 1 + spec.w16 // 2]).astype("<u4")
    return flags, int.from_bytes(w.tobytes(), "little")


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 storage of the same bits."""
    return t.to(torch.int32)


def _check_int(name: str, t: torch.Tensor, dtypes, shape) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")
    if len(shape) != t.dim() or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


# ---- the plain versions ---------------------------------------------------------------


def verify_check_plain(spec: FieldSpec, ts: torch.Tensor, col_w: torch.Tensor,
                       want: torch.Tensor, idx: torch.Tensor, *, want_cols: bool = False,
                       p_eval=None, inner=None):
    """The plain version of verify_check, on any device: (the T row checks
    as a bool tensor, the evaluation's (W/2,) canonical words or None, the
    (R W/2, k) canonical hash words of the opened columns)."""
    got = mont_dot_plain(spec, ts, col_w)  # (W/2, T, k) canonical
    if want_cols:
        want_m, form = _i32(want), "words"
    else:
        want_m, form = want.index_select(2, idx), "limbs"
    want_c = mont_mul_map_plain(spec, want_m, op="from_mont", in_form=form, out_form="words")
    ok = (got == want_c).all(dim=2).all(dim=0)
    words = mont_mul_map_plain(spec, col_w, op="from_mont", in_form="words", out_form="hash")
    ev = None
    if p_eval is not None:
        pe = mont_mul_map_plain(spec, p_eval.T, op="to_mont", in_form="words", out_form="words")
        inn = mont_mul_map_plain(spec, inner.T, op="to_mont", in_form="words", out_form="words")
        ev = mont_dot_plain(spec, inn[:, None, :], pe[:, :, None]).reshape(-1)
    return ok, ev, words


def verify_walk_plain(digest, digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                      idx: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """The plain version of verify_walk, on any device: do all the paths
    reach root (a bool tensor)?"""
    roots = digest.merkle_walk_plain(digs, uniq_sibs, inv, idx)
    return (roots == (root & 0xFFFFFFFF)[:, None]).all()


class GatherPlan(NamedTuple):
    """gather_open's plan of the opened columns idx (k,): `table`, int32
    (4 n_unique + k,), for each unique column in ascending order four words
    (the column, its first slot, the start of its run of slots in what
    follows, the run's length), then the k slots j in column order (stable);
    the first n_mont columns lie below the sources' `off`.  The kernel reads
    a column's four words in one 16-byte load: the table starts 16-byte
    aligned."""
    table: torch.Tensor
    n_unique: int
    n_mont: int


def plan_host(idx, off: int = 0) -> tuple[np.ndarray, int, int]:
    """(table, n_unique, n_mont) of GatherPlan on the host, from the opened
    columns idx (any int sequence, unsorted, with repeats): an argsort of
    at most a few thousand ints."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    perm = np.argsort(idx, kind="stable")
    ucols, starts, counts = np.unique(idx[perm], return_index=True, return_counts=True)
    head = np.stack([ucols, perm[starts], starts, counts], axis=1).reshape(-1)
    table = np.concatenate([head, perm]).astype(np.int32)
    return table, int(ucols.size), int(np.searchsorted(ucols, off))


def gather_plan(idx, off: int = 0, device="cpu") -> GatherPlan:
    """The GatherPlan of idx (a host sequence or array) with its table on
    `device`."""
    table, n_unique, n_mont = plan_host(idx, off)
    return GatherPlan(torch.as_tensor(table, device=device), n_unique, n_mont)


def gather_open_plain(spec: FieldSpec, idx: torch.Tensor, n_rows: int, *, mont=None,
                      mont_form: str = "limbs", canon=None, off: int = 0,
                      hashes: torch.Tensor, uniq: torch.Tensor,
                      plan: "GatherPlan | None" = None) -> torch.Tensor:
    """The plain version of gather_open, on any device, by the kernel's
    plan: each unique column read once (below off from mont, the rest from
    canon), then put into every slot that names it."""
    w32 = spec.w16 // 2
    if plan is None:
        plan = gather_plan(idx.cpu().numpy(), off, idx.device)
    U, n_mont = plan.n_unique, plan.n_mont
    tab = plan.table.to(torch.int64)
    head, perm = tab[: 4 * U].reshape(U, 4), tab[4 * U :]
    ucols, runs = head[:, 0], head[:, 3]
    vals = torch.zeros((w32, n_rows, U), dtype=torch.int32, device=idx.device)
    if n_mont:
        m = mont.index_select(2, ucols[:n_mont])
        vals[:, :, :n_mont] = pack_words(m, 0) if mont_form == "limbs" else _i32(m)
    if U > n_mont:
        c = canon.index_select(1, ucols[n_mont:] - off)
        vals[:, :, n_mont:] = mont_mul_map_plain(spec, c, op="to_mont", in_form="hash",
                                                 out_form="words")
    cols = torch.empty((w32, n_rows, perm.numel()), dtype=torch.int32, device=idx.device)
    cols[:, :, perm] = vals.repeat_interleave(runs, dim=2)
    return torch.cat([cols.reshape(-1), _i32(hashes.index_select(1, uniq)).reshape(-1)])


# ---- the kernels ----------------------------------------------------------------------


def _bind(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lcpc_verify_check.argtypes = ([p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, ll, i, p, p,
                                       ll, ll, p, ll, ll, i, ll, i, ll, i, ll, i, p, p, p, p,
                                       i, i, p])
    lib.lcpc_gather_open.argtypes = [p, i, i, i, ll, ll, p, ll, ll, ll, i, p, ll, p, ll, p, i,
                                     p, p, i, i, p]
    lib.lcpc_verify_check_clusters.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.lcpc_verify_check_clusters.restype = ctypes.c_int
    for fn in (lib.lcpc_verify_check, lib.lcpc_gather_open):
        fn.restype = ctypes.c_int


def _low_words(t: torch.Tensor):
    """(an int32 tensor, its three element strides) the kernels read t
    through: t itself, or for int64 u32 values the low int32 of each
    element of its contiguous copy, read in place."""
    if t.dtype == torch.int32:
        return t, t.stride()
    t = t.contiguous().view(torch.int32)
    return t, (t.stride(0), t.stride(1), 2)


def _split(n_sm: int, R: int, k: int) -> tuple[int, int]:
    """(splits, rows a split): the rows of each 32-column group split over
    a cluster of `splits` blocks, up to CLUSTER_MAX, as many as put a column
    block on every SM, each split at least a stage's CHUNK rows; every
    split gets rows."""
    cap = min(CLUSTER_MAX, max(1, R // CHUNK), -(-n_sm // _n_groups(k)))
    rows = -(-R // cap)
    return -(-R // rows), rows


def _eval_blocks(npr: int, splits: int, col_blocks: int, wave: int) -> int:
    """Blocks of the evaluation: EVAL_J terms a block at least, and no more
    than fill the `wave` blocks the card holds at once beside the column
    blocks, in clusters of `splits` (the grid's cluster size), one cluster
    at least."""
    if npr == 0:
        return 0
    blocks = min(-(-npr // EVAL_J), max(splits, wave - col_blocks))
    return max(splits, blocks // splits * splits)


_clusters: dict = {}


def _wave(lib, w32: int, splits: int, T: int, want_cols: bool, device: int) -> int:
    """Blocks of verify_check the card holds at once in clusters of
    `splits` (the occupancy API, csrc/verify_core.cu
    lcpc_verify_check_clusters); raises where it holds no cluster."""
    key = (w32, splits, T, want_cols, device)
    if key not in _clusters:
        n = ctypes.c_int(0)
        _check_launch("verify_check (its occupancy)", lib.lcpc_verify_check_clusters(
            w32, splits, T, int(want_cols), device, ctypes.byref(n)))
        if n.value < 1:
            raise RuntimeError(f"verify_check: the card holds no cluster of {splits} blocks")
        _clusters[key] = n.value * splits
    return _clusters[key]


def _check_smem(w32: int, T: int, want_cols: bool) -> int:
    """Bytes of verify_check's dynamic shared memory (csrc/verify_core.cu
    CheckSmem): the ring (or the warps' exact sums of a pass, if larger),
    the block's residues, the wanted values."""
    max_t = ACC_WORDS // w32
    ring = max(STAGES * (w32 * CHUNK * COLS + w32 * max_t * CHUNK),
               max_t * WARPS * (3 * w32 + 1) * COLS)
    nw = w32 if want_cols else 2 * w32
    return 4 * (ring + T * (w32 + nw) * COLS)


def verify_check(spec: FieldSpec, state: torch.Tensor, ts: torch.Tensor, col_w: torch.Tensor,
                 want: torch.Tensor, idx: torch.Tensor, *, want_cols: bool = False,
                 p_eval=None, inner=None) -> torch.Tensor:
    """The verifier's column check, the opened columns' hash words and the
    evaluation (see the module docstring): clears state[t] where row t
    fails, writes the evaluation into state[T + 1 : T + 1 + W/2] when
    p_eval and inner are given, returns the (R W/2, k) int32 hash words."""
    w, w32 = spec.w16, spec.w16 // 2
    _check_int("verify_check ts", ts, (torch.int32,), (w32, None, None))
    T, R = ts.shape[1], ts.shape[2]
    _check_int("verify_check col_w", col_w, (torch.int32,), (w32, R, None))
    k = col_w.shape[2]
    _check_int("verify_check idx", idx, (torch.int64,), (k,))
    if want_cols:
        _check_int("verify_check want", want, (torch.int32, torch.int64), (w32, T, k))
    else:
        _check_int("verify_check want", want, (torch.int32,), (w, T, None))
    _check_int("verify_check state", state, (torch.int32,), (state_len(spec, T),))
    if (p_eval is None) != (inner is None):
        raise ValueError("verify_check: p_eval and inner go together")
    if p_eval is not None:
        _check_int("verify_check p_eval", p_eval, (torch.int32,), (None, w32))
        _check_int("verify_check inner", inner, (torch.int32,), tuple(p_eval.shape))
    if k == 0 or R == 0:
        raise ValueError(f"verify_check: no opened columns or no rows ({R} x {k})")
    if _check_smem(w32, T, want_cols) > SMEM_MAX:
        raise ValueError(f"verify_check: {T} rows of ts need more than a block's shared memory")
    if _plain_here("verify_check", state, ts, col_w, want, idx, p_eval, inner):
        ok, ev, words = verify_check_plain(spec, ts, col_w, want, idx, want_cols=want_cols,
                                           p_eval=p_eval, inner=inner)
        state[:T] *= ok.to(torch.int32)
        if ev is not None:
            state[T + 1 : T + 1 + w32] = ev
        return words
    device = ts.device
    words = torch.empty((R * w32, k), dtype=torch.int32, device=device)
    n_sm = _n_sm(device.index or 0)
    splits, rows_split = _split(n_sm, R, k)
    npr = 0 if p_eval is None else p_eval.shape[0]
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(ts)
    # the evaluation's blocks fill what the card holds beside the column
    # blocks (the occupancy API)
    col_blocks = _n_groups(k) * splits
    eval_blocks = _eval_blocks(npr, splits, col_blocks,
                               _wave(lib, w32, splits, T, want_cols, dev) if npr else 0)
    scratch = torch.empty(eval_blocks // splits * w32, dtype=torch.int32, device=device)
    want, want_s = _low_words(want)
    pe = (None, 0, 0) if p_eval is None else (p_eval.data_ptr(), p_eval.stride(1),
                                              p_eval.stride(0))
    inn = (None, 0, 0) if inner is None else (inner.data_ptr(), inner.stride(1),
                                              inner.stride(0))
    _check_launch("verify_check", lib.lcpc_verify_check(
        ts.data_ptr(), *ts.stride(), col_w.data_ptr(), *col_w.stride(), want.data_ptr(),
        *want_s, int(want_cols), idx.contiguous().data_ptr(), *pe,
        *inn, T, R, k, npr, splits, rows_split, eval_blocks, words.data_ptr(),
        state.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
        field_consts(spec, device).data_ptr(), w32, dev, stream))
    verify_check.launches += 1
    return words


launch_count.counted(verify_check)


def verify_walk(digest, state: torch.Tensor, at: int, digs: torch.Tensor,
                uniq_sibs: torch.Tensor, inv: torch.Tensor, idx: torch.Tensor,
                root: torch.Tensor) -> None:
    """The verifier's path walk: from the opened columns' digests digs
    (8, k), the digest's walk (uniq_sibs, inv, idx as its merkle_walk takes
    them) compared with the commitment's root (8,) int64, clearing
    state[at] where a path reaches another node: one launch of the digest's
    walk kernel on CUDA tensors, its plain version on CPU tensors."""
    digest.merkle_walk(digs, uniq_sibs, inv, idx, root=root, flag=state[at : at + 1])


def gather_open(spec: FieldSpec, idx: torch.Tensor, n_rows: int, *, mont=None,
                mont_form: str = "limbs", canon=None, off: int = 0, hashes: torch.Tensor,
                uniq: torch.Tensor, plan: "GatherPlan | None" = None) -> torch.Tensor:
    """Everything the prover opens, in one int32 buffer: the columns idx
    (k,) int64 of n_rows rows as packed Montgomery words (W/2, n_rows, k),
    then the path nodes hashes[:, uniq] (8, U) (hashes (8, nodes) int64,
    uniq (U,) int64).  Column c < off comes from mont: the codeword's limbs
    (W, n_rows, n) (mont_form "limbs") or packed Montgomery words (W/2,
    n_rows, n) ("words": int32, or int64 u32 values), read in place; the
    rest from canon, the kept canonical hash words (n_rows W/2, n - off), at
    c - off, converted to Montgomery form.  `plan` is gather_plan(idx, off)
    on idx's device (the callers push it with idx); without one it is made
    here, from a copy of idx to the host."""
    w, w32 = spec.w16, spec.w16 // 2
    k = idx.shape[0] if idx.dim() == 1 else -1
    _check_int("gather_open idx", idx, (torch.int64,), (k,))
    _check_int("gather_open uniq", uniq, (torch.int64,), (None,))
    _check_int("gather_open hashes", hashes, (torch.int64,), (8, None))
    if mont_form not in ("limbs", "words"):
        raise ValueError(f"gather_open: mont_form limbs or words, got {mont_form!r}")
    if mont is not None:
        _check_int("gather_open mont", mont, (torch.int32,) if mont_form == "limbs"
                   else (torch.int32, torch.int64), (w if mont_form == "limbs" else w32,
                                                     n_rows, None))
    if canon is not None:
        _check_int("gather_open canon", canon, (torch.int32,), (n_rows * w32, None))
    if (off > 0) != (mont is not None) or canon is None and mont is None:
        raise ValueError("gather_open: columns below off need mont, the rest canon")
    _plain_here("gather_open", idx, uniq, hashes, mont, canon)  # one device, a known one
    if plan is None:
        plan = gather_plan(idx.cpu().numpy(), off, idx.device)
    _check_int("gather_open plan", plan.table, (torch.int32,), (4 * plan.n_unique + k,))
    if not 0 <= plan.n_mont <= plan.n_unique <= k:
        raise ValueError(f"gather_open: a plan of {plan.n_unique} columns, {plan.n_mont} "
                         f"below off, for {k} opened")
    if plan.n_mont and mont is None or plan.n_unique > plan.n_mont and canon is None:
        raise ValueError("gather_open: the plan's columns below off need mont, the rest canon")
    if _plain_here("gather_open", idx, uniq, hashes, mont, canon, plan.table):
        return gather_open_plain(spec, idx, n_rows, mont=mont, mont_form=mont_form,
                                 canon=canon, off=off, hashes=hashes, uniq=uniq, plan=plan)
    device = idx.device
    U = uniq.shape[0]
    out = torch.empty(w32 * n_rows * k + 8 * U, dtype=torch.int32, device=device)
    m = (None, 0, 0, 0)
    if mont is not None:
        mont, s = _low_words(mont)
        m = (mont.data_ptr(), *s)
    c = (None, 0)
    if canon is not None:
        canon = canon if canon.stride(1) == 1 else canon.contiguous()
        c = (canon.data_ptr(), canon.stride(0))
    lib = cuda_build.load(_NAME, _bind)
    dev, stream = _launch_args(idx)
    hashes = hashes if hashes.stride(1) == 1 else hashes.contiguous()
    table = plan.table if plan.table.is_contiguous() and plan.table.data_ptr() % 16 == 0 \
        else plan.table.clone()
    _check_launch("gather_open", lib.lcpc_gather_open(
        table.data_ptr() if k else None, k, plan.n_unique, plan.n_mont,
        n_rows, off, *m,
        int(mont_form == "limbs"), *c, hashes.data_ptr(), hashes.stride(0),
        uniq.contiguous().data_ptr() if U else None, U, out.data_ptr(),
        field_consts(spec, device).data_ptr(), w32, dev, stream))
    gather_open.launches += 1
    return out


launch_count.counted(gather_open)
