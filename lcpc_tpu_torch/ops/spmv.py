"""Expander SpMV of one Brakedown code level: the CUDA kernel and its plain twin.

    y (n_out, W, R) = A x,   y[c] = sum_k vals[k, :, c] * x[cols[k, c]]

over 16-bit-limb Montgomery operands (int32 storage), one deferred
Montgomery reduction per output.  This is the port of the TPU's only Pallas
kernel (lcpc_tpu/ops/spmv_pallas.py: spmv_mont, pallas_call at line 180)
and of the gather that feeds it (encodings/brakedown.py: _apply_mat_device).

- `spmv_mont` is the wrapper.  On CUDA tensors it launches the hand-written
  kernel in `csrc/spmv_mont.cu` (built with nvcc for sm_90a at first use
  into build/kernels/, loaded with ctypes) or raises; on CPU tensors it runs
  `apply_mat_plain`.  `spmv_mont.launches` counts kernel launches.
- `apply_mat_plain` is the plain PyTorch version: an index_select gather
  followed by FieldOps.mul_sum_mont.  Both return the unique residue < p,
  so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..fields.spec import FieldSpec
from .limbs import get_ops

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "lcpc_tpu_torch", "csrc", "spmv_mont.cu")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
_SO = os.path.join(BUILD_DIR, "libspmv_mont.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""  # nvcc output (ptxas register/spill report) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the spmv_mont kernel cannot be built")


def build(force: bool = False) -> float:
    """Compile csrc/spmv_mont.cu into build/kernels/ if stale; returns the
    seconds spent compiling (0.0 when the library was up to date)."""
    global build_log
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=600)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SRC}:\n{build_log}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(_SO)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.lcpc_spmv_mont.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.lcpc_spmv_mont.restype = ctypes.c_int
        _lib = lib
    return _lib


def max_multiple(spec: FieldSpec, k: int) -> int:
    """Bound on the reduced slot-sum in multiples of p (spmv_pallas.py:220)."""
    return max(2, (k * spec.p) // spec.R + 3)


def kernel_consts(spec: FieldSpec, k: int) -> np.ndarray:
    """The kernel's constant block: p words | n0 | n_mult | multiples of p.

    The multiples are the reference's conditional-subtract chain
    (limbs.py: _cond_sub_chain): power-of-two multiples of p, largest first,
    each W32+1 32-bit words."""
    w32 = spec.w16 // 2
    words = lambda v, n: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]
    m = 1
    while m * 2 < max_multiple(spec, k):
        m *= 2
    mults = []
    while m >= 1:
        mults += words(m * spec.p, w32 + 1)
        m //= 2
    n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    n_mult = len(mults) // (w32 + 1)
    return np.array(words(spec.p, w32) + [n0, n_mult] + mults, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _consts_on(spec: FieldSpec, k: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_consts(spec, k).view(np.int32)).to(device)


def _check(spec: FieldSpec, x, cols, vals):
    w = spec.w16
    for name, t in (("x", x), ("cols", cols), ("vals", vals)):
        if t.dtype != torch.int32:
            raise TypeError(f"spmv_mont: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spmv_mont: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"spmv_mont: {name} on {t.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[1] != w:
        raise ValueError(f"spmv_mont: x must be (n_in, {w}, R), got {tuple(x.shape)}")
    if cols.dim() != 2:
        raise ValueError(f"spmv_mont: cols must be (K, n_out), got {tuple(cols.shape)}")
    k, n_out = cols.shape
    if tuple(vals.shape) != (k, w, n_out):
        raise ValueError(
            f"spmv_mont: vals must be ({k}, {w}, {n_out}), got {tuple(vals.shape)}")
    if not 1 <= k <= (1 << 20):
        raise ValueError(f"spmv_mont: K={k} outside the accumulator bound [1, 2^20]")


def apply_mat_plain(spec: FieldSpec, x: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SpMV: index_select gather + FieldOps.mul_sum_mont.

    Same contract as spmv_mont on any device; the output axis is processed
    in slices so the gathered (K, W, slice, R) operand stays bounded."""
    ops = get_ops(spec)
    k, n_out = cols.shape
    n_in, w, r = x.shape
    step = max(1, (1 << 26) // max(1, k * w * r))
    outs = []
    for c0 in range(0, n_out, step):
        c1 = min(n_out, c0 + step)
        g = x.index_select(0, cols[:, c0:c1].reshape(-1).long())
        g = g.reshape(k, c1 - c0, w, r).permute(0, 2, 1, 3)   # (K, W, c, R)
        v = vals[:, :, c0:c1, None]                           # (K, W, c, 1)
        y = ops.mul_sum_mont(v, g)                            # (W, c, R)
        outs.append(y.permute(1, 0, 2))
    if not outs:
        return x.new_empty((0, w, r))
    return torch.cat(outs, dim=0).contiguous()


def spmv_mont(spec: FieldSpec, x: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """y (n_out, W, R) = A x for x (n_in, W, R), cols (K, n_out) and
    vals (K, W, n_out), all int32 16-bit Montgomery limbs (pad slots: value 0).

    CUDA tensors launch the kernel (csrc/spmv_mont.cu); CPU tensors take
    apply_mat_plain.  Any other device raises."""
    _check(spec, x, cols, vals)
    if x.device.type == "cpu":
        return apply_mat_plain(spec, x, cols, vals)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_mont: unsupported device {x.device}")
    lib = _load()
    k, n_out = cols.shape
    r = x.shape[2]
    y = torch.empty((n_out, spec.w16, r), dtype=torch.int32, device=x.device)
    consts = _consts_on(spec, k, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lcpc_spmv_mont(x.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                             y.data_ptr(), consts.data_ptr(), spec.w16 // 2,
                             k, n_out, r, x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"spmv_mont launch failed: cudaError_t {err}")
    spmv_mont.launches += 1
    return y


spmv_mont.launches = 0
