"""Modular matrix products over Montgomery words and the power table of the
direct column evaluation (wrappers of csrc/mont_dot.cu and
csrc/power_table.cu).

- `mont_dot(spec, x, y, out_form)`: out[a, b] = sum_k x[a, k] y[k, b] for
  Montgomery operands x (W?, A, K) and y (W?, K, B), as (W/2, A, B) int32
  words, "canonical" (the plain value of the sum, what FieldOps.collapse_canon
  gives) or "mont" (its Montgomery form, what an opened codeword column
  holds).  x is "packed" ((W/2, ...) int32 words) or "limbs" ((W, ...)
  int32 16-bit limbs), read in place whatever its strides; y is one of
  those or "planes" ((KT, B, 2W, 128) uint8 byte-digit planes by k-tiles
  of TC_KT, `to_planes`).
  On a CUDA device it launches one of three kernels (`route`; each launch
  counted in mont_dot.launches and in KERNELS[its name].launches): for
  A <= 2 rows against y as words "thin_tc" (the tensor cores against y's
  byte digits read in place: every prove's collapse) or, below its
  crossover, "thin" (the CUDA cores: sums of partials, Brakedown's
  36-row collapse, dots of one column); else "tile" (the tensor cores
  against y as planes; y given as words is laid out as planes first).
  K is split into ranges (the tensor-core kernels' 32-bit sums), and more
  where the output alone would not fill the card, and a thin launch sums
  the splits.  On the CPU it runs `mont_dot_plain`,
  FieldOps.collapse_canon_plain's float64 products.
- `power_table(spec, g, K)`: V[m, j] = g_j^m (m < K) in Montgomery form
  for the points g (W/2, k), as (KT, k, 2W, 128) digit planes; CUDA
  launches the kernel once (power_table.launches), the CPU runs
  `power_table_plain` (the same two ladders with FieldOps).

The plain versions run on any device; the tests use them on the CPU and
chip_smoke.py holds the kernels to them on the card.  `mont_dot_planes_plain`
and `mont_dot_thin_tc_plain` model the tensor-core kernels' arithmetic (u8
products of digit planes, folded every range of k-steps) for the tests; no
path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from . import launch_count
from .launch_count import LaunchCount
from .limbs import get_ops
from .spmv import pack_words, unpack_words

FORMS = ("packed", "limbs")
Y_FORMS = FORMS + ("planes",)
OUT_FORMS = ("canonical", "mont")
TABLE_FORMS = ("words", "planes")
MIN_SPLIT_K = 64    # k-steps a K split at least (thin)
THIN_THREADS = 128  # csrc/mont_dot.cu kThinThreads
# csrc/mont_dot.cu's thin tensor-core kernel: its dynamic shared memory is
# x's digit planes (64 rows x k_split, whole k-tiles), TT_STAGES stages of y
# (at most TT_STAGE bytes, twice for limbs), the fold's staging and the
# stages' barriers, in SMEM_MAX
TT_STAGES, TT_STAGE, TT_STAGING, SMEM_MAX = 4, 32 * 64 * 8, 128 * 64 * 4 + 64, 232_448
TT_MIN_SPLIT = 512  # k-steps a K split at least (thin tensor-core)
TT_MAX_K = 2048     # k-steps a range at most: the fold's 32-bit sums (kTtMaxK)
TT_MIN_K, TT_SMALL_K, TT_SMALL_B = 128, 16, 4096  # thin_tc's crossover (route)
TC_KT = 128         # csrc/mont_dot.cu kKT: k-steps a stage (tensor cores)
TC_MIN_SPLIT = 1024  # k-steps a K split at least (tensor cores)
# csrc/mont_dot.cu kFoldK: k-steps an s32 accumulator of byte products takes
# (2^15 * 255^2 < 2^31)
FOLD_K = 1 << 15
POWER_A = 32        # csrc/power_table.cu kA: the low ladder's length


def _words(v: int, w32: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(w32)]


@functools.lru_cache(maxsize=None)
def _consts_np(spec: FieldSpec) -> np.ndarray:
    """p | -p^-1 mod 2^32 | R^2 mod p | R mod p | R^3 mod p, as int32 words."""
    w32, p = spec.w16 // 2, spec.p
    vals = (_words(p, w32) + [(-pow(p, -1, 1 << 32)) % (1 << 32)] + _words(spec.R2, w32)
            + _words(spec.R % p, w32) + _words(pow(spec.R, 3, p), w32))
    return np.array(vals, dtype=np.uint32).view(np.int32)


_consts: dict = {}


def field_consts(spec: FieldSpec, device) -> torch.Tensor:
    key = (spec.name, torch.device(device))
    if key not in _consts:
        _consts[key] = torch.from_numpy(_consts_np(spec)).to(device)
    return _consts[key]


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(spec: FieldSpec, t: torch.Tensor, form: str, name: str) -> None:
    forms = Y_FORMS if name == "y" else FORMS
    if form not in forms:
        raise ValueError(f"mont_dot: {name}_form must be one of {forms}, got {form!r}")
    if form == "planes":
        if (t.dtype != torch.uint8 or t.dim() != 4 or t.shape[2] != 2 * spec.w16
                or t.shape[3] != TC_KT or not t.is_contiguous()):
            raise ValueError(f"mont_dot: planes must be contiguous (KT, B, {2 * spec.w16}, "
                             f"{TC_KT}) uint8, got {tuple(t.shape)} {t.dtype}")
        return
    rows = spec.w16 if form == "limbs" else spec.w16 // 2
    if t.dtype != torch.int32 or t.dim() != 3 or t.shape[0] != rows:
        raise ValueError(f"mont_dot: {name} must be ({rows}, ., .) int32 ({form}), got "
                         f"{tuple(t.shape)} {t.dtype}")


def plane_tiles(K: int) -> int:
    """The k-tiles of TC_KT bytes that hold K digits."""
    return -(-K // TC_KT)


def to_planes(spec: FieldSpec, y: torch.Tensor, form: str = "packed") -> torch.Tensor:
    """(W/2 or W, K, B) words or limbs -> (KT, B, 2W, TC_KT) uint8 byte-digit
    planes: [t, b, d, e] is byte d of y[t TC_KT + e, b] (byte d mod 4 of word
    d // 4), zero from K on.  Each k-tile of every plane row is one
    contiguous run, and a k-tile of all points one contiguous slab: what the
    tensor-core kernel reads a stage at a time."""
    w = pack_words(y, 0) if form == "limbs" else y
    w32, K, B = w.shape
    kt = plane_tiles(K)
    b = torch.zeros((w32, kt * TC_KT, B, 4), dtype=torch.uint8, device=y.device)
    b[:, :K] = w.contiguous().view(torch.uint8).reshape(w32, K, B, 4)  # little-endian bytes
    b = b.reshape(w32, kt, TC_KT, B, 4).permute(1, 3, 0, 4, 2)
    return b.reshape(kt, B, 4 * w32, TC_KT).contiguous()


def planes_to_words(planes: torch.Tensor, K: int) -> torch.Tensor:
    """The inverse of to_planes: (KT, B, 2W, TC_KT) uint8 -> (W/2, K, B) int32
    words."""
    kt, B, d, _ = planes.shape
    b = planes.reshape(kt, B, d // 4, 4, TC_KT).permute(2, 0, 4, 1, 3)
    b = b.reshape(d // 4, kt * TC_KT, B, 4)[:, :K].contiguous()
    return b.view(torch.int32).reshape(d // 4, K, B)


def mont_dot_plain(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor,
                   out_form: str = "canonical", *, x_form: str = "packed",
                   y_form: str = "packed") -> torch.Tensor:
    """The plain version of mont_dot, on any device: (W/2, A, B) int32 words."""
    ops = get_ops(spec)
    if y_form == "planes":
        y, y_form = planes_to_words(y, x.shape[2]), "packed"
    xl = x if x_form == "limbs" else unpack_words(x, 0)
    yl = y if y_form == "limbs" else unpack_words(y, 0)
    canon = ops.collapse_canon_plain(xl, yl)  # (W, A, B)
    if out_form == "mont":
        canon = ops.to_mont_plain(canon)
    return pack_words(canon, 0)


def mont_dot_planes_plain(spec: FieldSpec, x: torch.Tensor, planes: torch.Tensor,
                          out_form: str = "canonical", *, x_form: str = "packed",
                          fold: int = FOLD_K) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain torch, on any device:
    the u8 product of x's digit planes (rows (a, i)) with the planes (rows
    (b, j)) over each range of `fold` k-steps, its entries held to the s32
    accumulator's limit, each range folded into the exact wide sum
    S = sum_{i, j} P_ij 2^(8 (i + j)), and S reduced over Python ints.
    Exact: integer products (float64 where torch has no integer matmul, its
    sums < 2^53).  (W/2, A, B) int32 words."""
    w32, d = spec.w16 // 2, 2 * spec.w16
    xw = pack_words(x, 0) if x_form == "limbs" else x
    A, K, B = xw.shape[1], xw.shape[2], planes.shape[1]
    xp = xw.contiguous().view(torch.uint8).reshape(w32, A, K, 4).permute(1, 0, 3, 2)
    xp = xp.reshape(A * d, K)                  # row (a, i): byte i of x[a, k]
    yp = planes.permute(1, 2, 0, 3).reshape(B * d, -1)[:, :K]  # row (b, j)
    dt = torch.int64 if x.device.type == "cpu" else torch.float64
    sums = [[0] * B for _ in range(A)]
    for k0 in range(0, K, fold):
        p = (xp[:, k0 : k0 + fold].to(dt) @ yp[:, k0 : k0 + fold].to(dt).T).to(torch.int64)
        if int(p.max()) >= 1 << 31:
            raise OverflowError(f"mont_dot_planes_plain: a digit-plane sum {int(p.max())} "
                                f"passes the s32 accumulator over {fold} k-steps")
        p = p.reshape(A, d, B, d)
        q = torch.zeros((A, B, 2 * d - 1), dtype=torch.int64, device=p.device)
        for i in range(d):  # the anti-diagonal sums Q_s = sum_{i + j = s} P_ij
            q[:, :, i : i + d] += p[:, i]
        q = q.cpu().tolist()
        for a in range(A):
            for b in range(B):
                sums[a][b] += sum(v << (8 * s) for s, v in enumerate(q[a][b]))
    p_, shift = spec.p, 2 if out_form == "canonical" else 1
    scale = pow(pow(spec.R, -1, p_), shift, p_)
    vals = [[s * scale % p_ for s in row] for row in sums]
    words = torch.tensor([[[(v >> (32 * w)) & 0xFFFFFFFF for v in row] for row in vals]
                          for w in range(w32)], dtype=torch.int64).reshape(w32, A, B)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)  # int32 storage of u32
    return words.to(torch.int32).to(x.device)


def _thin_tc_words(y: torch.Tensor, form: str) -> torch.Tensor:
    """y's words as the thin tensor-core kernel reads them (limbs: bytes 0
    and 1 of limbs 2w and 2w + 1), through its strides."""
    if form == "limbs":
        return (y[0::2] & 0xFFFF) | (y[1::2] << 16)
    return y


def mont_dot_thin_tc_plain(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor,
                           out_form: str = "canonical", *, x_form: str = "packed",
                           y_form: str = "packed", k_split: "int | None" = None) -> torch.Tensor:
    """The thin tensor-core kernel's arithmetic in plain torch, on any device:
    the roles swapped from the tile kernel's, y's digit rows (b, j) against
    x's digit planes (a, i) (x padded to 2 rows) as one u8 product per range
    of `k_split` k-steps (the launch's; thin_tc_cap by default), its
    entries held to the s32 accumulator's limit; the fold a digit round d at
    a time, Q_s(a, b) += sum_w P[(b, 4 w + d), (a, s - 4 w - d)], its sums
    held to the 32 bits the kernel keeps them in; each
    range's S = sum_s Q_s 2^(8 s) reduced to a canonical partial over
    Python ints, the partials summed mod p (the split sum's launch), then
    to `out_form`.  Exact: integer products (float64 where torch has no
    integer matmul, sums < 2^53).  (W/2, A, B) int32 words."""
    w32, d = spec.w16 // 2, 2 * spec.w16
    xw = _thin_tc_words(x, x_form)
    yw = _thin_tc_words(y, y_form)
    A, K, B = xw.shape[1], xw.shape[2], yw.shape[2]
    if k_split is None:
        k_split = thin_tc_cap(y_form == "limbs")
    xd = torch.zeros((2, d, K), dtype=torch.uint8, device=x.device)
    xd[:A] = xw.reshape(-1).view(torch.uint8).reshape(w32, A, K, 4).permute(1, 0, 3, 2) \
        .reshape(A, d, K)                                    # row (a, i): byte i of x[a, k]
    yd = yw.reshape(-1).view(torch.uint8).reshape(w32, K, B, 4).permute(2, 0, 3, 1) \
        .reshape(B * d, K)                                   # row (b, j): byte j of y[k, b]
    dt = torch.int64 if x.device.type == "cpu" else torch.float64
    p_, total = spec.p, [[0] * B for _ in range(A)]
    r2inv = pow(pow(spec.R, -1, p_), 2, p_)
    for k0 in range(0, K, k_split):
        pm = (yd[:, k0 : k0 + k_split].to(dt) @ xd.reshape(2 * d, K)[:, k0 : k0 + k_split]
              .to(dt).T).to(torch.int64)
        if int(pm.max()) >= 1 << 31:
            raise OverflowError(f"mont_dot_thin_tc_plain: a digit-plane sum {int(pm.max())} "
                                f"passes the s32 accumulator over {k_split} k-steps")
        pm = pm.reshape(B, w32, 4, 2, d)                     # [b, w, d, a, i]
        q = torch.zeros((2, B, 2 * d - 1), dtype=torch.int64, device=pm.device)
        for dd in range(4):  # the fold's rounds: Q_s += P[(b, 4 w + dd), (a, s - 4 w - dd)]
            for w in range(w32):
                s0 = 4 * w + dd
                q[:, :, s0 : s0 + d] += pm[:, w, dd].permute(1, 0, 2)
        if int(q.max()) >= 1 << 32:
            raise OverflowError(f"mont_dot_thin_tc_plain: an anti-diagonal sum {int(q.max())} "
                                f"passes the fold's 32 bits over {k_split} k-steps")
        q = q.cpu().tolist()
        for a in range(A):
            for b in range(B):
                wide = sum(v << (8 * s) for s, v in enumerate(q[a][b]))
                total[a][b] = (total[a][b] + wide * r2inv) % p_
    if out_form == "mont":
        total = [[v * spec.R % p_ for v in row] for row in total]
    words = torch.tensor([[[(v >> (32 * w)) & 0xFFFFFFFF for v in row] for row in total]
                          for w in range(w32)], dtype=torch.int64).reshape(w32, A, B)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)  # int32 storage of u32
    return words.to(torch.int32).to(x.device)


def thin_tc_cap(limbs: bool) -> int:
    """The most k-steps a thin tensor-core launch's range takes: x's digit
    planes (64 rows x the range, whole k-tiles of TC_KT, in every field)
    beside y's stages (the largest field's) and the fold's staging in
    SMEM_MAX, and at most TT_MAX_K: 2,048 with packed words, 1,024 with
    limbs."""
    ring = TT_STAGES * TT_STAGE * (2 if limbs else 1)
    return min(TT_MAX_K, (SMEM_MAX - 1024 - ring - TT_STAGING) // (64 * TC_KT) * TC_KT)


def thin_tc_split(spec: FieldSpec, limbs: bool, K: int, B: int,
                  n_sm: int) -> tuple[int, int, int]:
    """(k_split, n_split, grid_x) of a thin tensor-core launch: ranges of at
    most thin_tc_cap k-steps, more of them (each at least TT_MIN_SPLIT)
    where the column tiles (64 / W32 column pairs each) number fewer than
    the SMs; grid_x blocks a range (the SMs shared among the ranges), each
    taking every grid_x-th column tile."""
    n_tiles = -(-B // (2 * (64 // (spec.w16 // 2))))
    n = -(-K // thin_tc_cap(limbs))
    if n_tiles * n < n_sm and K > TT_MIN_SPLIT:
        n = max(n, min(-(-n_sm // n_tiles), -(-K // TT_MIN_SPLIT), 65535))
    k_split = -(-K // n)
    n_split = -(-K // k_split)
    return k_split, n_split, min(n_tiles, -(-n_sm // n_split))


def thin_tc_tma(y: torch.Tensor) -> bool:
    """Whether the thin tensor-core kernel reads y by TMA: unit column
    stride, the other strides multiples of 4 words, the pointer 16-byte
    aligned.  Else it copies words one at a time (cp.async), in place:
    Brakedown's (W, 36, 235,173) limbs, whose row stride is odd."""
    return (y.stride(2) == 1 and y.stride(1) % 4 == 0 and y.stride(0) % 4 == 0
            and y.data_ptr() % 16 == 0)


def route(A: int, K: int, B: int, y_form: str) -> str:
    """The kernel mont_dot launches: "tile" (the tensor cores against digit
    planes) for y as planes or more than 2 rows; else "thin_tc" (the
    tensor cores against y's words read in place) or "thin" (the CUDA
    cores).  The crossover, measured on an H100 (scripts/time_thin_dot.py,
    K in 2..256 x B in 189..65,536, A = 1 and 2, packed and limb y):
    thin_tc's fold costs a few microseconds a tile of columns whatever K,
    so it wins from TT_MIN_K k-steps on at any B, and from TT_SMALL_K on up
    to TT_SMALL_B columns; thin keeps the rest: the sums of partials (K a
    handful of blocks), Brakedown's collapse (K = 36 against 235,173
    columns: 0.25 ms against 1.16), dots of one column."""
    if y_form == "planes" or A > 2:
        return "tile"
    if B > 1 and (K >= TT_MIN_K or K >= TT_SMALL_K and B <= TT_SMALL_B):
        return "thin_tc"
    return "thin"


def _tma_operand(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor-core kernel's TMA reads it: unit stride along K, the
    other strides multiples of 4 elements, 16-byte aligned.  Anything else
    (a transpose, K not a multiple of 4: tests and edge shapes, never the
    prover's blocks) is copied into such a tensor, zero past K."""
    if (x.stride(2) == 1 and x.stride(1) % 4 == 0 and x.stride(0) % 4 == 0
            and x.data_ptr() % 16 == 0):
        return x
    rows, A, K = x.shape
    buf = torch.zeros((rows, A, -(-K // 4) * 4), dtype=x.dtype, device=x.device)
    buf[:, :, :K] = x
    return buf


def tc_split(spec: FieldSpec, A: int, K: int, B: int, n_sm: int) -> tuple[int, int]:
    """(k_split, n_split) of a tensor-core launch: ranges of at most FOLD_K
    k-steps, a multiple of TC_KT; more of them where the blocks (PA rows x PB
    points each, csrc/mont_dot.cu Tc<W>) would number fewer than twice the
    SMs."""
    d = 2 * spec.w16
    base = -(-A // (2 * (64 // d))) * -(-B // (256 // d))
    n = -(-K // FOLD_K)
    if base * n < 2 * n_sm and K > TC_MIN_SPLIT:
        n = max(n, min(-(-2 * n_sm // base), -(-K // TC_MIN_SPLIT), 65535))
    k_split = -(-(-(-K // n)) // TC_KT) * TC_KT
    return k_split, -(-K // k_split)


def _bind_dot(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lcpc_mont_dot.argtypes = ([p, ll, ll, ll, i, p, ll, ll, ll, i, p, ll, ll, ll, ll, p, i,
                                   ll, ll, ll, ll, i, i, i, p])
    lib.lcpc_mont_dot.restype = ctypes.c_int
    lib.lcpc_mont_dot_planes.argtypes = ([p, ll, ll, i, p, ll, p, ll, ll, ll, ll, p, i, ll,
                                          ll, ll, ll, i, i, i, p])
    lib.lcpc_mont_dot_planes.restype = ctypes.c_int
    lib.lcpc_mont_dot_thin_tc.argtypes = ([p, ll, ll, ll, i, p, ll, ll, ll, i, p, ll, ll, ll, ll,
                                           p, p, i, ll, ll, ll, ll, i, i, i, i, i, p])
    lib.lcpc_mont_dot_thin_tc.restype = ctypes.c_int


KERNELS = {"thin": LaunchCount(), "thin_tc": LaunchCount(), "tile": LaunchCount()}


def _launch(spec, kernel, x, xs, x_limbs, y, ys, y_limbs, out, os, A, K, B, split, mont) -> None:
    """One launch of `kernel`: x, out tensors with (word/limb, i, j) element
    strides xs and (word, a, b, split) strides os; y words with strides ys
    (the thin kernels, A <= 2) or digit planes (the tile kernel); split the
    launch's (k_split, n_split) and, for thin_tc, (tma, grid_x)."""
    device = out.device
    lib = cuda_build.load("mont_dot", _bind_dot)
    consts = field_consts(spec, device).data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    w32, dev = spec.w16 // 2, device.index or 0
    if kernel == "tile":
        err = lib.lcpc_mont_dot_planes(x.data_ptr(), xs[0], xs[1], int(x_limbs), y.data_ptr(),
                                       y.shape[0], out.data_ptr(), *os, consts, w32, A, K, B,
                                       *split, int(mont), dev, stream)
    elif kernel == "thin_tc":  # its exact sums in scratch, reduced by the same launch
        k_split, n_split, tma, grid_x = split
        wide = torch.empty((n_split, 2 * w32 + 1, A, B), dtype=torch.int32, device=device)
        err = lib.lcpc_mont_dot_thin_tc(x.data_ptr(), *xs, int(x_limbs), y.data_ptr(), *ys,
                                        int(y_limbs), out.data_ptr(), *os, wide.data_ptr(),
                                        consts, w32, A, K, B, k_split, n_split, int(mont),
                                        int(tma), grid_x, dev, stream)
    else:
        err = lib.lcpc_mont_dot(x.data_ptr(), *xs, int(x_limbs), y.data_ptr(), *ys,
                                int(y_limbs), out.data_ptr(), *os, consts, w32, A, K, B,
                                *split, int(mont), dev, stream)
    if err != 0:
        raise RuntimeError(f"mont_dot ({kernel}) launch failed: cudaError_t {err}")
    mont_dot.launches += 1
    KERNELS[kernel].launches += 1


def mont_dot(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor, out_form: str = "canonical",
             *, x_form: str = "packed", y_form: str = "packed",
             out: "torch.Tensor | None" = None, _route: "str | None" = None) -> torch.Tensor:
    """sum_k x[a, k] y[k, b] reduced to `out_form`, as (W/2, A, B) int32
    words (into `out` when given, any strides); see the module docstring.
    `_route` forces a kernel of `route` (tests and chip_smoke.py)."""
    _check(spec, x, x_form, "x")
    _check(spec, y, y_form, "y")
    if out_form not in OUT_FORMS:
        raise ValueError(f"mont_dot: out_form must be one of {OUT_FORMS}, got {out_form!r}")
    A, K = x.shape[1], x.shape[2]
    planes = y_form == "planes"
    if planes and y.shape[0] != plane_tiles(K) or not planes and y.shape[1] != K:
        raise ValueError(f"mont_dot: x {tuple(x.shape)} and y {tuple(y.shape)} ({y_form}) "
                         f"differ in K")
    B = y.shape[1] if planes else y.shape[2]
    w32 = spec.w16 // 2
    if x.device != y.device:
        raise ValueError(f"mont_dot: operands on {x.device} and {y.device}")
    if out is not None and (out.shape != (w32, A, B) or out.dtype != torch.int32
                            or out.device != x.device):
        raise ValueError(f"mont_dot: out must be ({w32}, {A}, {B}) int32 on {x.device}")
    kernel = route(A, K, B, y_form) if _route is None else _route
    if kernel not in KERNELS or (kernel != "tile" and (planes or A > 2)):
        raise ValueError(f"mont_dot: no {kernel!r} kernel for {A} rows against {y_form}")
    device = x.device
    if device.type == "cpu":
        res = mont_dot_plain(spec, x, y, out_form, x_form=x_form, y_form=y_form)
        return res if out is None else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"mont_dot: unsupported device {device}")
    if out is None:
        out = torch.empty((w32, A, B), dtype=torch.int32, device=device)
    if A == 0 or B == 0:
        return out
    if K == 0:
        return out.zero_()
    n_sm = _n_sm(device.index or 0)
    ys = None if planes else y.stride()
    if kernel == "tile":
        if not planes:
            y = to_planes(spec, y, y_form)
        x = _tma_operand(x)
        if K > 65535 * FOLD_K:
            raise ValueError(f"mont_dot: K = {K} is past {65535 * FOLD_K}")
        split = tc_split(spec, A, K, B, n_sm)
        n_split = split[1]
    elif kernel == "thin_tc":
        k_split, n_split, grid_x = thin_tc_split(spec, y_form == "limbs", K, B, n_sm)
        split = (k_split, n_split, thin_tc_tma(y), grid_x)
    else:
        # split K where the output's blocks number fewer than twice the SMs
        base = -(-B // THIN_THREADS)
        n_split = 1
        if base < 2 * n_sm and K > MIN_SPLIT_K:
            n_split = min(-(-2 * n_sm // base), -(-K // MIN_SPLIT_K), 65535)
        k_split = -(-K // n_split)
        n_split = -(-K // k_split)
        split = (k_split, n_split)
    xs = x.stride()
    mont = out_form == "mont"
    y_limbs = y_form == "limbs"
    if n_split == 1:
        _launch(spec, kernel, x, xs, x_form == "limbs", y, ys, y_limbs, out,
                (*out.stride(), 0), A, K, B, split, mont)
        return out
    # canonical partials of each K range, then their sum: a thin launch with
    # x the constant R^2 mod p (sum_s partial_s R^2 R^-2 = sum_s partial_s)
    n = A * B
    parts = torch.empty((w32, n_split, n), dtype=torch.int32, device=device)
    _launch(spec, kernel, x, xs, x_form == "limbs", y, ys, y_limbs, parts,
            (n_split * n, B, 1, n), A, K, B, split, False)
    r2 = field_consts(spec, device)[w32 + 1 :]
    flat = out if out.is_contiguous() else torch.empty_like(out)
    _launch(spec, "thin", r2, (1, 0, 0), False, parts, parts.stride(), False, flat,
            (n, 0, 1, 0), 1, n_split, n, (n_split, 1), mont)
    return out if flat is out else out.copy_(flat)


launch_count.counted(mont_dot)


# ---- the power table ----------------------------------------------------------------


def power_table_plain(spec: FieldSpec, g: torch.Tensor, K: int,
                      form: str = "planes") -> torch.Tensor:
    """The plain version of power_table, on any device: the low ladder g^t
    (t < POWER_A) and the high ladder g^(POWER_A q), each by doubling, then
    one Montgomery product an entry, as (W/2, K, k) words ("words") laid
    out by to_planes ("planes", power_table's layout)."""
    if form not in TABLE_FORMS:
        raise ValueError(f"power_table: form must be one of {TABLE_FORMS}, got {form!r}")
    ops = get_ops(spec)
    gl = unpack_words(g, 0)  # (W, k)
    one = torch.from_numpy(ops.encode_host([1]).astype(np.int32)).to(g.device)
    one = one.expand(-1, gl.shape[1])

    def ladder(step, count):  # [1, s, .., s^(count-1)] (W, count, k), and s^count
        seq = one[:, None, :]
        while seq.shape[1] < count:
            seq = torch.cat([seq, ops.mul_plain(seq, step[:, None, :])], dim=1)
            step = ops.mul_plain(step, step)
        return seq[:, :count], step

    lo, ga = ladder(gl, POWER_A)
    hi, _ = ladder(ga, -(-K // POWER_A))
    table = pack_words(ops.mul_plain(hi[:, :, None, :], lo[:, None, :, :]).flatten(1, 2)[:, :K],
                       0)
    return to_planes(spec, table) if form == "planes" else table


def _bind_table(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lcpc_power_table.argtypes = [p, p, p, i, i, i, i, p]
    lib.lcpc_power_table.restype = ctypes.c_int


def power_table(spec: FieldSpec, g: torch.Tensor, K: int) -> torch.Tensor:
    """V[m, j] = g_j^m for m < K of the points g ((W/2, k) int32 Montgomery
    words), Montgomery, as (KT, k, 2W, TC_KT) uint8 digit planes (to_planes'
    layout, what the tile mont_dot kernel reads)."""
    w32 = spec.w16 // 2
    if g.dtype != torch.int32 or g.dim() != 2 or g.shape[0] != w32:
        raise ValueError(f"power_table: g must be ({w32}, k) int32, got {tuple(g.shape)}")
    if K < 1:
        raise ValueError(f"power_table: K must be >= 1, got {K}")
    if g.device.type == "cpu":
        return power_table_plain(spec, g, K)
    if g.device.type != "cuda":
        raise ValueError(f"power_table: unsupported device {g.device}")
    g = g.contiguous()
    k = g.shape[1]
    out = torch.empty((plane_tiles(K), k, 4 * w32, TC_KT), dtype=torch.uint8, device=g.device)
    if k:
        lib = cuda_build.load("power_table", _bind_table)
        err = lib.lcpc_power_table(g.data_ptr(), out.data_ptr(),
                                   field_consts(spec, g.device).data_ptr(), w32, K, k,
                                   g.device.index or 0,
                                   torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"power_table launch failed: cudaError_t {err}")
        power_table.launches += 1
    return out


launch_count.counted(power_table)
