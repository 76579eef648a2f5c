"""Batched radix-2 NTT over a prime field (natural input, bit-reversed output).

Port of lcpc_tpu/ops/ntt.py.  Semantics follow the reference's
`fffft::fft_io_pc` as the Ligero encoding uses it
(lcpc-ligero-pc/src/lib.rs:140,162-164): over the size-n subgroup generated
by w_n = ROOT_OF_UNITY^(2^(s - log2 n)),

    out[bitrev(k)] = sum_j x[j] * w_n^(j*k)   for k in 0..n.

- `plan_passes` groups the ladder's stages into the kernel's passes
  (`NttPass`: half-sizes 2^hi .. 2^lo, tiles of 2^(hi-lo+1) group elements
  at stride 2^lo x T = 2^log_t consecutive residues, shared memory per
  block).  Plain data: the wrapper launches it, the tests check it.
- `NttPlan` holds the stage twiddles as (W, m) Montgomery limbs, exactly
  lcpc_tpu's `NttPlan.stage_twiddles` (half-sizes m = n/2 .. 1; built on
  the host when first read), the passes, and one packed twiddle table per
  device for the kernel, built there by `mont_powers` (powers by doubling
  through mont_mul_map).
- `ntt_forward(plan, x, output="limbs")` is the wrapper.  On CUDA
  tensors it launches the hand-written ladder in `csrc/ntt_mont.cu`, one
  launch per pass: the first reads the (W, R, k) limbs, the last writes the
  (W, R, n) limbs, the canonical hash words or both (`output` = "limbs",
  "words" or "both"); passes hand over through one packed (R, n, W32)
  scratch buffer.  It raises if a launch fails.  On
  CPU tensors it runs `ntt_forward_plain` (then from_mont and the pack for
  the words).  `ntt_forward.launches` counts kernel launches.
- `ntt_forward_plain` is the plain PyTorch twin: the Gentleman-Sande ladder
  of `_ntt_forward` with FieldOps.add_plain/sub_plain/mul_plain (no
  kernel), on any device.  Both return
  the unique residues < p, so they agree limb for limb.
  `ntt_forward_passes_plain` runs the same ladder pass by pass with the
  kernel's tile and butterfly index arithmetic (for the tests).
- `InttPlan` / `intt_inverse` (fffft's ifft_oi): the ladder over FieldOps'
  elementwise ops, which run the mont_map kernels on the card (no NTT
  kernel of its own yet).
- `ntt_host`, `intt_host`, `ntt_reference_host` are the Python-int twins.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from .limbs import FieldOps, get_ops, pack_row_words
from .spmv import pack_words

_NAME = "ntt_mont"
LOG_CHUNK = 10           # the last pass: contiguous chunks of 1,024 elements
LOG_T = 3                # head passes: T = 8 consecutive residues per group row
MAX_TILE_BYTES = 1 << 16  # head passes: shared memory per block
SMEM_LIMIT = 232448      # an H100 block's dynamic shared memory (csrc/ntt_mont.cu)
MAX_THREADS = 256       # csrc/ntt_mont.cu kMaxThreads
SMALL_GRID = 1024       # fewer tiles than this: two butterflies a thread per stage


def bit_reverse(idx, n: int) -> np.ndarray:
    """The bit-reversals of the indices `idx` (< n) in log2(n) bits, int64."""
    assert n & (n - 1) == 0
    bits = n.bit_length() - 1
    idx = np.asarray(idx, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def bit_reverse_indices(n: int) -> np.ndarray:
    """Index array r with r[i] = bit-reversal of i in log2(n) bits."""
    return bit_reverse(np.arange(n, dtype=np.int64), n)


def _powers(w: int, m: int, p: int) -> list[int]:
    out, acc = [], 1
    for _ in range(m):
        out.append(acc)
        acc = (acc * w) % p
    return out


def mont_powers(spec: FieldSpec, bases: "list[int]", m: int, device, *,
                offset: int = 0) -> torch.Tensor:
    """(W/2, len(bases), m) int32 packed Montgomery words of
    bases[i]^(offset + j) for j < m, built on `device` by doubling: columns
    [s, 2s) are columns [0, s) times b^s, one mont_mul_map launch a
    doubling (ceil(log2 m) launches on the card, the plain version on the
    CPU).  The host computes only the len(bases) multipliers of each step.
    The NTT plans' and DistNtt's twiddle tables; `_powers` and
    FieldOps.encode_host are its plain version."""
    from .mont_map import mont_mul_map

    p, w32 = spec.p, spec.w16 // 2

    def words(vals):  # Montgomery forms of host ints -> (W/2, len(vals), 1) int32 words
        host = get_ops(spec).encode_host(vals)
        return pack_words(torch.from_numpy(host.astype(np.int32)), 0)[:, :, None].to(device)

    out = torch.empty((w32, len(bases), m), dtype=torch.int32, device=device)
    out[:, :, :1] = words([pow(b, offset, p) for b in bases])
    step_pow = [b % p for b in bases]  # b^s for the current step s
    s = 1
    while s < m:
        k = min(s, m - s)
        out[:, :, s : s + k] = mont_mul_map(spec, out[:, :, :k], words(step_pow),
                                            in_form="words", out_form="words")
        step_pow = [v * v % p for v in step_pow]
        s *= 2
    return out


@dataclasses.dataclass(frozen=True)
class NttPass:
    """One kernel launch: the stages of half-size 2^hi down to 2^lo.

    A block owns a tile of G = 2^(hi-lo+1) group elements (indices that
    share their block of 2^(hi+1) and their residue mod 2^lo, at stride
    2^lo) times T = 2^log_t consecutive residues."""

    hi: int
    lo: int
    log_t: int

    @property
    def log_tile(self) -> int:
        return self.hi - self.lo + 1 + self.log_t

    def threads(self, tiles: int) -> int:
        """Threads per block for a grid of `tiles` blocks: 4 butterflies each
        per stage, or 2 under SMALL_GRID tiles (the verify shape), which
        shortens each thread's chain of dependent products; 32 .. 256."""
        bf = 2 if tiles < SMALL_GRID else 4
        return min(MAX_THREADS, max(32, (1 << self.log_tile) // (2 * bf)))

    def smem_bytes(self, w32: int) -> int:
        return (4 * w32) << self.log_tile

    def tile_indices(self, log_n: int) -> np.ndarray:
        """(tiles per row, tile) row indices of every tile's elements, element
        e = g*T + t at base + (g << lo) + t, as the kernel computes them."""
        t_n = 1 << self.log_t
        tt = np.arange(1 << (log_n - self.log_tile), dtype=np.int64)[:, None]
        e = np.arange(1 << self.log_tile, dtype=np.int64)[None, :]
        rg = tt & ((1 << (self.lo - self.log_t)) - 1)
        blk = tt >> (self.lo - self.log_t)
        base = (blk << (self.hi + 1)) + (rg << self.log_t)
        return base + ((e >> self.log_t) << self.lo) + (e & (t_n - 1))


def plan_passes(log_n: int, w32: int, *, log_chunk: int = LOG_CHUNK, log_t: int = LOG_T,
                max_tile_bytes: int = MAX_TILE_BYTES) -> tuple[NttPass, ...]:
    """The kernel's passes for a size-2^log_n transform of W32-word elements:
    the head stages (half-sizes 2^(log_n-1) .. 2^log_chunk) in as few
    shared-memory passes of equal depth as tiles of at most max_tile_bytes
    allow, then the contiguous last pass over chunks of 2^min(log_n,
    log_chunk) elements."""
    if log_n < 1:
        raise ValueError(f"log_n must be >= 1, got {log_n}")
    lc = min(log_n, log_chunk)
    head = log_n - lc
    passes = []
    if head:
        if log_t > lc:
            raise ValueError(f"T = 2^{log_t} exceeds the head passes' stride 2^{lc}")
        depth = (max_tile_bytes // (4 * w32) >> log_t).bit_length() - 1  # stages a tile holds
        if depth < 1:
            raise ValueError(f"a tile of {max_tile_bytes} bytes holds no stage")
        n_head = -(-head // depth)
        hi = log_n - 1
        for i in range(n_head):
            stages = head // n_head + (i < head % n_head)
            passes.append(NttPass(hi, hi - stages + 1, log_t))
            hi -= stages
    passes.append(NttPass(lc - 1, 0, 0))
    if any(ps.smem_bytes(w32) > SMEM_LIMIT for ps in passes):
        raise ValueError(f"a pass needs more than {SMEM_LIMIT} bytes of shared memory")
    return tuple(passes)


class NttPlan:
    """Twiddle tables and kernel passes for a size-n forward NTT (like
    fffft's FFTPrecomp).  The keyword arguments reshape the passes
    (plan_passes); the transform is the same."""

    def __init__(self, spec: FieldSpec, n: int, **pass_kw):
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        self.spec = spec
        self.n = n
        self.log_n = n.bit_length() - 1
        if self.log_n > spec.s:
            raise ValueError(f"n = 2^{self.log_n} exceeds {spec.name}'s 2-adicity {spec.s}")
        self.ops = get_ops(spec)
        self.passes = plan_passes(self.log_n, spec.w16 // 2, **pass_kw)
        self._tables: dict = {}

    @functools.cached_property
    def stage_twiddles(self) -> list[np.ndarray]:
        """The stage twiddles on the host, (W, m) Montgomery limbs for
        half-sizes m = n/2 .. 1 (stage twiddle base w_{2m} = w_n^(n/2m)):
        Python ints, the plain version's table (stage_tensors) and the
        yardstick of the kernel's (kernel_table)."""
        spec, n = self.spec, self.n
        w_n = spec.root_for_log_len(self.log_n)
        return [self.ops.encode_host(_powers(pow(w_n, n // (2 * m), spec.p), m, spec.p))
                for m in (1 << s for s in range(self.log_n - 1, -1, -1))]

    @property
    def launches_per_call(self) -> int:
        """Kernel launches of one ntt_forward: one per pass."""
        return len(self.passes)

    def stage_tensors(self, device) -> list[torch.Tensor]:
        """The stage twiddles as (W, m) int32 tensors on `device` (plain twin)."""
        key = ("stages", torch.device(device))
        if key not in self._tables:
            self._tables[key] = [torch.from_numpy(t.astype(np.int32)).to(device)
                                 for t in self.stage_twiddles]
        return self._tables[key]

    def kernel_table(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(tw, consts) for the kernel on `device`: tw (n-1, W32) packed
        words with half-size m's twiddles at rows m-1 .. 2m-2 (equal to
        stage_twiddles, built on the device by mont_powers), and the
        constant block p words | -p^-1 mod 2^32."""
        key = ("kernel", torch.device(device))
        if key not in self._tables:
            # half-size m's twiddles w_n^(j n/2m) are every (n/2m)-th of
            # the n/2 powers of w_n, which mont_powers builds on the device
            half = self.n // 2
            pw = mont_powers(self.spec, [self.spec.root_for_log_len(self.log_n)], half,
                             device)[:, 0]  # (W32, n/2) words
            tw = torch.cat([pw[:, :: half // m] for m in (1 << s for s in range(self.log_n))],
                           dim=1).T.contiguous()
            w32 = self.spec.w16 // 2
            p = self.spec.p
            words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(w32)]
            consts = np.array(words + [(-pow(p, -1, 1 << 32)) % (1 << 32)], dtype=np.uint32)
            self._tables[key] = (tw, torch.from_numpy(consts.view(np.int32)).to(device))
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
        hi = ops.add_plain(a, b)
        lo = ops.mul_plain(ops.sub_plain(a, b), tw[:, None, None, :])
        x = torch.stack([hi, lo], dim=3).reshape(w, r, n)
    return x


def ntt_forward_passes_plain(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """The plain ladder run pass by pass as the kernel runs it: each pass
    gathers its tiles (NttPass.tile_indices), runs its stages with the
    kernel's butterfly and twiddle index arithmetic, and scatters the tiles
    back.  Equals ntt_forward_plain; the CPU tests hold the plan's index
    arithmetic to it."""
    ops = plan.ops
    w, r, k = x.shape
    x = torch.nn.functional.pad(x, (0, plan.n - k))
    stage_tw = plan.stage_tensors(x.device)
    for ps in plan.passes:
        idx = ps.tile_indices(plan.log_n)                     # (tiles, tile)
        xt = x[:, :, torch.from_numpy(idx).to(x.device)]     # (W, R, tiles, tile)
        bf = np.arange(1 << (ps.log_tile - 1))
        rg = (np.arange(idx.shape[0]) & ((1 << (ps.lo - ps.log_t)) - 1))[:, None]
        t, gp = bf & ((1 << ps.log_t) - 1), bf >> ps.log_t
        for s in range(ps.hi, ps.lo - 1, -1):
            log_mg = s - ps.lo
            jg = gp & ((1 << log_mg) - 1)
            g0 = ((gp >> log_mg) << (log_mg + 1)) + jg
            e0 = (g0 << ps.log_t) + t
            e1 = torch.from_numpy(e0 + (1 << (log_mg + ps.log_t))).to(x.device)
            e0 = torch.from_numpy(e0).to(x.device)
            j = torch.from_numpy((jg << ps.lo) + (rg << ps.log_t) + t).to(x.device)
            tw = stage_tw[plan.log_n - 1 - s][:, j]          # (W, tiles, tile/2)
            a, b = xt[..., e0], xt[..., e1]
            xt[..., e0] = ops.add_plain(a, b)
            xt[..., e1] = ops.mul_plain(ops.sub_plain(a, b), tw[:, None])
        x = torch.empty_like(x)
        x[:, :, torch.from_numpy(idx).to(x.device)] = xt
    return x


# ---- the kernel ----------------------------------------------------------------------


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lcpc_ntt_pass.argtypes = [p, p, p, p, p, p, p] + [i] * 9 + [p]
    lib.lcpc_ntt_pass.restype = ctypes.c_int


_OUTPUTS = ("limbs", "both", "words")


def ntt_forward(plan: NttPlan, x: torch.Tensor, *, output: str = "limbs"):
    """Forward NTT of each row: x (W, R, k <= n) int32 Montgomery limbs,
    zero-padded to n.  `output` names what the last pass writes:
      "limbs"  (W, R, n) limbs in bit-reversed order;
      "both"   (limbs, words), words the canonical hash words, (R*W/2, n)
               int32 storage of LE u32 words (word r*W/2 + i of column c);
      "words"  the words alone (no limb stores: the streaming commit's
               encode).

    CUDA tensors go through the kernel (csrc/ntt_mont.cu), one launch per
    pass, each counted in ntt_forward.launches, or raise; CPU tensors take
    ntt_forward_plain (and from_mont and the pack).  Any other device
    raises."""
    w = plan.spec.w16
    if x.dtype != torch.int32:
        raise TypeError(f"ntt_forward: x must be int32, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != w or x.shape[2] > plan.n:
        raise ValueError(f"ntt_forward: x must be ({w}, R, k <= {plan.n}), "
                         f"got {tuple(x.shape)}")
    if output not in _OUTPUTS:
        raise ValueError(f"ntt_forward: output must be one of {_OUTPUTS}, got {output!r}")
    if x.device.type == "cpu":
        y = ntt_forward_plain(plan, x)
        if output == "limbs":
            return y
        words = pack_row_words(plan.ops.from_mont_plain(y))
        return (y, words) if output == "both" else words
    if x.device.type != "cuda":
        raise ValueError(f"ntt_forward: unsupported device {x.device}")
    x = x.contiguous()
    r, k, n, w32 = x.shape[1], x.shape[2], plan.n, w // 2
    out = (torch.empty((w, r, n), dtype=torch.int32, device=x.device)
           if output != "words" else None)
    words = (torch.empty((r * w32, n), dtype=torch.int32, device=x.device)
             if output != "limbs" else None)
    if r:
        buf = (torch.empty((r, n, w32), dtype=torch.int32, device=x.device)
               if len(plan.passes) > 1 else None)
        tw, consts = plan.kernel_table(x.device)
        lib = cuda_build.load(_NAME, _bind)
        dev = x.device.index or 0
        stream = torch.cuda.current_stream(x.device).cuda_stream
        last = len(plan.passes) - 1
        for i, ps in enumerate(plan.passes):
            err = lib.lcpc_ntt_pass(
                x.data_ptr() if i == 0 else None,
                None if i == 0 else buf.data_ptr(),
                None if i == last else buf.data_ptr(),
                out.data_ptr() if i == last and out is not None else None,
                words.data_ptr() if i == last and words is not None else None,
                tw.data_ptr(), consts.data_ptr(), w32, r, plan.log_n, k,
                ps.hi, ps.lo, ps.log_t, ps.threads(r << (plan.log_n - ps.log_tile)), dev,
                stream)
            if err != 0:
                raise RuntimeError(f"ntt_mont pass {i} (half-sizes 2^{ps.hi} .. 2^{ps.lo}) "
                                   f"launch failed: cudaError_t {err}")
            ntt_forward.launches += 1
    if output == "limbs":
        return out
    return (out, words) if output == "both" else words


ntt_forward.launches = 0


# ---- inverse (FieldOps' elementwise ops) ---------------------------------------------


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
