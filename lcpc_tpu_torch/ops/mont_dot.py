"""Modular matrix products over Montgomery words and the power table of the
direct column evaluation (wrappers of csrc/mont_dot.cu and
csrc/power_table.cu).

- `mont_dot(spec, x, y, out_form)`: out[a, b] = sum_k x[a, k] y[k, b] for
  Montgomery operands x (W?, A, K) and y (W?, K, B), as (W/2, A, B) int32
  words, "canonical" (the plain value of the sum, what FieldOps.collapse_canon
  gives) or "mont" (its Montgomery form, what an opened codeword column
  holds).  Each operand is "packed" ((W/2, ...) int32 words) or "limbs"
  ((W, ...) int32 16-bit limbs), read in place whatever its strides.  On a
  CUDA device it launches the kernel (each launch counted in
  mont_dot.launches), splitting K over more blocks where the output alone
  would not fill the card and summing the splits in a second launch; on the
  CPU it runs `mont_dot_plain`, FieldOps.collapse_canon_plain's float64
  products.
- `power_table(spec, g, K)`: V[m, j] = g_j^m (m < K) in Montgomery form as
  (W/2, K, k) int32 words for the points g (W/2, k); CUDA launches the
  kernel once (power_table.launches), the CPU runs `power_table_plain`
  (the same two ladders with FieldOps).

The plain versions run on any device; the tests use them on the CPU and
chip_smoke.py holds the kernels to them on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from .limbs import get_ops
from .spmv import pack_words, unpack_words

FORMS = ("packed", "limbs")
OUT_FORMS = ("canonical", "mont")
MIN_SPLIT_K = 64    # k-steps a K split at least
THIN_THREADS = 128  # csrc/mont_dot.cu kThinThreads
TILE = 32           # csrc/mont_dot.cu kTile
POWER_A = 32        # csrc/power_table.cu kA: the low ladder's length


def _words(v: int, w32: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(w32)]


@functools.lru_cache(maxsize=None)
def _consts_np(spec: FieldSpec) -> np.ndarray:
    """p | -p^-1 mod 2^32 | R^2 mod p | R mod p, as int32 words."""
    w32, p = spec.w16 // 2, spec.p
    vals = (_words(p, w32) + [(-pow(p, -1, 1 << 32)) % (1 << 32)] + _words(spec.R2, w32)
            + _words(spec.R % p, w32))
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
    if form not in FORMS:
        raise ValueError(f"mont_dot: {name}_form must be one of {FORMS}, got {form!r}")
    rows = spec.w16 if form == "limbs" else spec.w16 // 2
    if t.dtype != torch.int32 or t.dim() != 3 or t.shape[0] != rows:
        raise ValueError(f"mont_dot: {name} must be ({rows}, ., .) int32 ({form}), got "
                         f"{tuple(t.shape)} {t.dtype}")


def mont_dot_plain(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor,
                   out_form: str = "canonical", *, x_form: str = "packed",
                   y_form: str = "packed") -> torch.Tensor:
    """The plain version of mont_dot, on any device: (W/2, A, B) int32 words."""
    ops = get_ops(spec)
    xl = x if x_form == "limbs" else unpack_words(x, 0)
    yl = y if y_form == "limbs" else unpack_words(y, 0)
    canon = ops.collapse_canon_plain(xl, yl)  # (W, A, B)
    if out_form == "mont":
        canon = ops.to_mont(canon)
    return pack_words(canon, 0)


def _bind_dot(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lcpc_mont_dot.argtypes = ([p, ll, ll, ll, i, p, ll, ll, ll, i, p, ll, ll, ll, ll, p, i,
                                   ll, ll, ll, ll, i, i, i, p])
    lib.lcpc_mont_dot.restype = ctypes.c_int


def _launch(spec, x, xs, x_limbs, y, ys, y_limbs, out, os, A, K, B, k_split, n_split,
            mont) -> None:
    """One kernel launch: x, y, out tensors with (word/limb, i, j) element
    strides xs, ys and (word, a, b, split) strides os."""
    device = out.device
    lib = cuda_build.load("mont_dot", _bind_dot)
    err = lib.lcpc_mont_dot(x.data_ptr(), *xs, int(x_limbs), y.data_ptr(), *ys, int(y_limbs),
                            out.data_ptr(), *os, field_consts(spec, device).data_ptr(),
                            spec.w16 // 2, A, K, B, k_split, n_split, int(mont),
                            device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mont_dot launch failed: cudaError_t {err}")
    mont_dot.launches += 1


def mont_dot(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor, out_form: str = "canonical",
             *, x_form: str = "packed", y_form: str = "packed",
             out: "torch.Tensor | None" = None) -> torch.Tensor:
    """sum_k x[a, k] y[k, b] reduced to `out_form`, as (W/2, A, B) int32
    words (into `out` when given, any strides); see the module docstring."""
    _check(spec, x, x_form, "x")
    _check(spec, y, y_form, "y")
    if out_form not in OUT_FORMS:
        raise ValueError(f"mont_dot: out_form must be one of {OUT_FORMS}, got {out_form!r}")
    A, K = x.shape[1], x.shape[2]
    if y.shape[1] != K:
        raise ValueError(f"mont_dot: x {tuple(x.shape)} and y {tuple(y.shape)} differ in K")
    B = y.shape[2]
    w32 = spec.w16 // 2
    if x.device != y.device:
        raise ValueError(f"mont_dot: operands on {x.device} and {y.device}")
    if out is not None and (out.shape != (w32, A, B) or out.dtype != torch.int32
                            or out.device != x.device):
        raise ValueError(f"mont_dot: out must be ({w32}, {A}, {B}) int32 on {x.device}")
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
    # split K where the output's blocks number fewer than twice the SMs
    base = -(-B // THIN_THREADS) if A <= 2 else -(-B // TILE) * -(-A // TILE)
    n_split = 1
    if base < 2 * _n_sm(device.index or 0) and K > MIN_SPLIT_K:
        n_split = min(-(-2 * _n_sm(device.index or 0) // base), -(-K // MIN_SPLIT_K), 65535)
    k_split = -(-K // n_split)
    n_split = -(-K // k_split)
    xs, ys = x.stride(), y.stride()
    mont = out_form == "mont"
    if n_split == 1:
        _launch(spec, x, xs, x_form == "limbs", y, ys, y_form == "limbs", out,
                (*out.stride(), 0), A, K, B, K, 1, mont)
        return out
    # canonical partials of each K range, then their sum: a thin launch with
    # x the constant R^2 mod p (sum_s partial_s R^2 R^-2 = sum_s partial_s)
    n = A * B
    parts = torch.empty((w32, n_split, n), dtype=torch.int32, device=device)
    _launch(spec, x, xs, x_form == "limbs", y, ys, y_form == "limbs", parts,
            (n_split * n, B, 1, n), A, K, B, k_split, n_split, False)
    r2 = field_consts(spec, device)[w32 + 1 :]
    flat = out if out.is_contiguous() else torch.empty_like(out)
    _launch(spec, r2, (1, 0, 0), False, parts, parts.stride(), False, flat, (n, 0, 1, 0),
            1, n_split, n, n_split, 1, mont)
    return out if flat is out else out.copy_(flat)


mont_dot.launches = 0


# ---- the power table ----------------------------------------------------------------


def power_table_plain(spec: FieldSpec, g: torch.Tensor, K: int) -> torch.Tensor:
    """The plain version of power_table, on any device: the low ladder g^t
    (t < POWER_A) and the high ladder g^(POWER_A q), each by doubling, then
    one Montgomery product an entry."""
    ops = get_ops(spec)
    gl = unpack_words(g, 0)  # (W, k)
    one = torch.from_numpy(ops.encode_host([1]).astype(np.int32)).to(g.device)
    one = one.expand(-1, gl.shape[1])

    def ladder(step, count):  # [1, s, .., s^(count-1)] (W, count, k), and s^count
        seq = one[:, None, :]
        while seq.shape[1] < count:
            seq = torch.cat([seq, ops.mul(seq, step[:, None, :])], dim=1)
            step = ops.mul(step, step)
        return seq[:, :count], step

    lo, ga = ladder(gl, POWER_A)
    hi, _ = ladder(ga, -(-K // POWER_A))
    table = ops.mul(hi[:, :, None, :], lo[:, None, :, :]).flatten(1, 2)[:, :K]
    return pack_words(table, 0)


def _bind_table(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lcpc_power_table.argtypes = [p, p, p, i, i, i, i, p]
    lib.lcpc_power_table.restype = ctypes.c_int


def power_table(spec: FieldSpec, g: torch.Tensor, K: int) -> torch.Tensor:
    """V[m, j] = g_j^m for m < K: (W/2, K, k) int32 Montgomery words of the
    points g ((W/2, k) int32 Montgomery words)."""
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
    out = torch.empty((w32, K, k), dtype=torch.int32, device=g.device)
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


power_table.launches = 0
