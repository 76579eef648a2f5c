"""Batched radix-2 NTT over a prime field (natural input, bit-reversed output).

Port of lcpc_tpu/ops/ntt.py.  Semantics follow the reference's
`fffft::fft_io_pc` as the Ligero encoding uses it
(lcpc-ligero-pc/src/lib.rs:140,162-164): over the size-n subgroup generated
by w_n = ROOT_OF_UNITY^(2^(s - log2 n)),

    out[bitrev(k)] = sum_j x[j] * w_n^(j*k)   for k in 0..n.

- `NttPlan` holds the stage twiddles as (W, m) Montgomery limbs, exactly
  lcpc_tpu's `NttPlan.stage_twiddles` (half-sizes m = n/2 .. 1), plus one
  packed table per device for the kernel.
- `ntt_forward` is the wrapper.  On CUDA tensors it packs the rows into the
  kernel's (R, n, W32) word buffer (zero-padding them to n), launches the
  hand-written ladder in `csrc/ntt_mont.cu` (one launch per head stage, one
  for the shared-memory tail) and unpacks; it raises if a launch fails.  On
  CPU tensors it runs `ntt_forward_plain`.  `ntt_forward.launches` counts
  kernel launches.
- `ntt_forward_plain` is the plain PyTorch twin: the Gentleman-Sande ladder
  of `_ntt_forward` with FieldOps.add/sub/mul, on any device.  Both return
  the unique residues < p, so they agree limb for limb.
- `InttPlan` / `intt_inverse` (fffft's ifft_oi) are plain PyTorch only.
- `ntt_host`, `intt_host`, `ntt_reference_host` are the Python-int twins.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from .limbs import FieldOps, get_ops
from .spmv import pack_words, unpack_words

_NAME = "ntt_mont"
TAIL_C = 1024  # chunk of the kernel's shared-memory tail (csrc/ntt_mont.cu)


def bit_reverse_indices(n: int) -> np.ndarray:
    """Index array r with r[i] = bit-reversal of i in log2(n) bits."""
    assert n & (n - 1) == 0
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _powers(w: int, m: int, p: int) -> list[int]:
    out, acc = [], 1
    for _ in range(m):
        out.append(acc)
        acc = (acc * w) % p
    return out


class NttPlan:
    """Twiddle tables for a size-n forward NTT (like fffft's FFTPrecomp)."""

    def __init__(self, spec: FieldSpec, n: int):
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        self.spec = spec
        self.n = n
        self.log_n = n.bit_length() - 1
        if self.log_n > spec.s:
            raise ValueError(f"n = 2^{self.log_n} exceeds {spec.name}'s 2-adicity {spec.s}")
        self.ops = get_ops(spec)
        self.log_c = min(self.log_n, TAIL_C.bit_length() - 1)
        w_n = spec.root_for_log_len(self.log_n)
        # stage half-sizes m = n/2 .. 1; stage twiddle base w_{2m} = w_n^(n/2m)
        self.stage_twiddles: list[np.ndarray] = [
            self.ops.encode_host(_powers(pow(w_n, n // (2 * m), spec.p), m, spec.p))
            for m in (1 << s for s in range(self.log_n - 1, -1, -1))
        ]
        self._tables: dict = {}

    @property
    def launches_per_call(self) -> int:
        """Kernel launches of one ntt_forward: each head stage, then the tail."""
        return self.log_n - self.log_c + 1

    def stage_tensors(self, device) -> list[torch.Tensor]:
        """The stage twiddles as (W, m) int32 tensors on `device` (plain twin)."""
        key = ("stages", torch.device(device))
        if key not in self._tables:
            self._tables[key] = [torch.from_numpy(t.astype(np.int32)).to(device)
                                 for t in self.stage_twiddles]
        return self._tables[key]

    def kernel_table(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(tw, consts) for the kernel on `device`: tw (n-1, W32) packed
        words with half-size m's twiddles at rows m-1 .. 2m-2, and the
        constant block p words | -p^-1 mod 2^32."""
        key = ("kernel", torch.device(device))
        if key not in self._tables:
            limbs = np.concatenate(self.stage_twiddles[::-1], axis=1)  # m = 1, 2, .., n/2
            tw = pack_words(torch.from_numpy(limbs.astype(np.int32)), 0).T.contiguous()
            w32 = self.spec.w16 // 2
            p = self.spec.p
            words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(w32)]
            consts = np.array(words + [(-pow(p, -1, 1 << 32)) % (1 << 32)], dtype=np.uint32)
            self._tables[key] = (tw.to(device),
                                 torch.from_numpy(consts.view(np.int32)).to(device))
        return self._tables[key]


@functools.lru_cache(maxsize=None)
def get_ntt(spec: FieldSpec, n: int) -> NttPlan:
    """The size-n plan of `spec`; its device tables are cached per device."""
    return NttPlan(spec, n)


# ---- the plain version -------------------------------------------------------------


def ntt_forward_plain(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ladder (any device): x (W, R, k <= n) Montgomery limbs,
    zero-padded to n -> (W, R, n) bit-reversed transform (lcpc_tpu
    `_ntt_forward`, without the TPU's head/tail layout split)."""
    ops = plan.ops
    w, r, k = x.shape
    n = plan.n
    if k < n:
        x = torch.nn.functional.pad(x, (0, n - k))
    for s, tw in zip(range(plan.log_n - 1, -1, -1), plan.stage_tensors(x.device)):
        m = 1 << s
        xr = x.reshape(w, r, n // (2 * m), 2, m)
        a, b = xr[:, :, :, 0], xr[:, :, :, 1]
        hi = ops.add(a, b)
        lo = ops.mul(ops.sub(a, b), tw[:, None, None, :])
        x = torch.stack([hi, lo], dim=3).reshape(w, r, n)
    return x


# ---- the kernel ----------------------------------------------------------------------


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.lcpc_ntt_head, lib.lcpc_ntt_tail):
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int


def pack_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """(W, R, k) limbs -> the kernel's packed (R, n, W32) int32 buffer,
    zero-padded from k to n.  Packs where the limbs lie (coalesced), then
    moves the words."""
    w, r, k = x.shape
    buf = torch.empty((r, n, w // 2), dtype=torch.int32, device=x.device)
    buf[:, :k] = pack_words(x, 0).permute(1, 2, 0)
    buf[:, k:] = 0
    return buf


def unpack_rows(buf: torch.Tensor) -> torch.Tensor:
    """Packed (R, n, W32) -> (W, R, n) limbs: move the words limb-major
    first, then unpack (coalesced)."""
    return unpack_words(buf.permute(2, 0, 1).contiguous(), 0)


def ntt_packed_(plan: NttPlan, buf: torch.Tensor) -> torch.Tensor:
    """The kernel's ladder in place on a packed (R, n, W32) int32 buffer on
    a CUDA device: one launch per head stage (m >= C), then the tail
    launch.  Each launch counts in ntt_forward.launches; a failed launch
    raises."""
    w32 = plan.spec.w16 // 2
    if buf.device.type != "cuda":
        raise ValueError(f"ntt_packed_: the kernel runs on CUDA tensors, got {buf.device}")
    if buf.dtype != torch.int32 or not buf.is_contiguous():
        raise ValueError("ntt_packed_: buf must be a contiguous int32 tensor")
    if buf.dim() != 3 or buf.shape[1] != plan.n or buf.shape[2] != w32:
        raise ValueError(f"ntt_packed_: buf must be (R, {plan.n}, {w32}), "
                         f"got {tuple(buf.shape)}")
    r = buf.shape[0]
    if r == 0:
        return buf
    tw, consts = plan.kernel_table(buf.device)
    lib = cuda_build.load(_NAME, _bind)
    dev = buf.device.index or 0
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    args = (buf.data_ptr(), tw.data_ptr(), consts.data_ptr(), w32, r, plan.log_n)
    for log_m in range(plan.log_n - 1, plan.log_c - 1, -1):
        err = lib.lcpc_ntt_head(*args, log_m, dev, stream)
        if err != 0:
            raise RuntimeError(f"ntt_mont head launch (m = 2^{log_m}) failed: cudaError_t {err}")
        ntt_forward.launches += 1
    err = lib.lcpc_ntt_tail(*args, plan.log_c, dev, stream)
    if err != 0:
        raise RuntimeError(f"ntt_mont tail launch failed: cudaError_t {err}")
    ntt_forward.launches += 1
    return buf


def ntt_forward(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of each row: x (W, R, k <= n) int32 Montgomery limbs,
    zero-padded to n -> (W, R, n) limbs in bit-reversed order.

    CUDA tensors go through the kernel (csrc/ntt_mont.cu) or raise; CPU
    tensors take ntt_forward_plain.  Any other device raises."""
    w = plan.spec.w16
    if x.dtype != torch.int32:
        raise TypeError(f"ntt_forward: x must be int32, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != w or x.shape[2] > plan.n:
        raise ValueError(f"ntt_forward: x must be ({w}, R, k <= {plan.n}), "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ntt_forward_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_forward: unsupported device {x.device}")
    return unpack_rows(ntt_packed_(plan, pack_rows(x, plan.n)))


ntt_forward.launches = 0


# ---- inverse (plain PyTorch) ---------------------------------------------------------


class InttPlan:
    """Twiddles for the inverse transform (fffft's ifft_oi semantics:
    bit-reversed input -- fft_io's output order -- to in-order coefficients)."""

    def __init__(self, spec: FieldSpec, n: int):
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        self.spec = spec
        self.n = n
        self.log_n = n.bit_length() - 1
        if self.log_n > spec.s:
            raise ValueError(f"n = 2^{self.log_n} exceeds {spec.name}'s 2-adicity {spec.s}")
        self.ops = get_ops(spec)
        p = spec.p
        w_n_inv = pow(spec.root_for_log_len(self.log_n), p - 2, p)
        # DIT stages m = 1, 2, ..., n/2 with twiddle base w_{2m}^{-1}
        self.stage_twiddles: list[np.ndarray] = [
            self.ops.encode_host(_powers(pow(w_n_inv, n // (2 * m), p), m, p))
            for m in (1 << s for s in range(self.log_n))
        ]
        self.n_inv_limbs = self.ops.encode_host([pow(n, p - 2, p)])[:, 0]


@functools.lru_cache(maxsize=None)
def get_intt(spec: FieldSpec, n: int) -> InttPlan:
    return InttPlan(spec, n)


def intt_inverse(plan: InttPlan, x: torch.Tensor) -> torch.Tensor:
    """x (W, R, n) Montgomery bit-reversed transform -> in-order coefficients:
    the DIF stages in reverse as DIT butterflies with inverse twiddles
    (u' = u + v*tw, v' = u - v*tw), then the n^-1 scale (lcpc_tpu
    `_intt_inverse`)."""
    ops: FieldOps = plan.ops
    w, r, n = x.shape
    if n != plan.n or w != ops.w:
        raise ValueError(f"intt_inverse: x must be ({ops.w}, R, {plan.n}), got {tuple(x.shape)}")
    for s, tw_np in enumerate(plan.stage_twiddles):
        m = 1 << s
        tw = torch.from_numpy(tw_np.astype(np.int32)).to(x.device)
        xr = x.reshape(w, r, n // (2 * m), 2, m)
        u, v = xr[:, :, :, 0], xr[:, :, :, 1]
        vw = ops.mul(v, tw[:, None, None, :])
        x = torch.stack([ops.add(u, vw), ops.sub(u, vw)], dim=3).reshape(w, r, n)
    return ops.mul_const(x, plan.n_inv_limbs)


# ---- host twins (Python ints) ---------------------------------------------------------


def intt_host(spec: FieldSpec, vals: list[int]) -> list[int]:
    """Host inverse of ntt_host (ifft_oi semantics), Python ints."""
    n = len(vals)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    p = spec.p
    w_n_inv = pow(spec.root_for_log_len(log_n), p - 2, p)
    x = list(vals)
    m = 1
    while m < n:
        w_m = pow(w_n_inv, n // (2 * m), p)
        for start in range(0, n, 2 * m):
            wj = 1
            for j in range(m):
                u = x[start + j]
                v = (x[start + j + m] * wj) % p
                x[start + j] = (u + v) % p
                x[start + j + m] = (u - v) % p
                wj = (wj * w_m) % p
        m *= 2
    n_inv = pow(n, p - 2, p)
    return [(v * n_inv) % p for v in x]


def ntt_host(spec: FieldSpec, coeffs: list[int]) -> list[int]:
    """Host O(n log n) DIF NTT with Python ints (same semantics as device)."""
    n = len(coeffs)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    p = spec.p
    w_n = spec.root_for_log_len(log_n)
    x = list(coeffs)
    m = n // 2
    while m >= 1:
        w_m = pow(w_n, n // (2 * m), p)
        for start in range(0, n, 2 * m):
            wj = 1
            for j in range(m):
                a = x[start + j]
                b = x[start + j + m]
                x[start + j] = (a + b) % p
                x[start + j + m] = ((a - b) * wj) % p
                wj = (wj * w_m) % p
        m //= 2
    return x


def ntt_reference_host(spec: FieldSpec, coeffs: list[int]) -> list[int]:
    """Slow-twin DFT: returns out with out[bitrev(k)] = sum_j x[j] w^(jk)."""
    n = len(coeffs)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    w_n = spec.root_for_log_len(log_n)
    rev = bit_reverse_indices(n)
    out = [0] * n
    for k in range(n):
        acc = 0
        wk = pow(w_n, k, spec.p)
        cur = 1
        for j in range(n):
            acc = (acc + coeffs[j] * cur) % spec.p
            cur = (cur * wk) % spec.p
        out[rev[k]] = acc
    return out
