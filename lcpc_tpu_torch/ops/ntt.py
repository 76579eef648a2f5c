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
  scratch buffer.  With `input="words"` (the verifier's proof rows) the
  first pass reads (R, k, W32) canonical words instead and takes each
  element to Montgomery form as it loads it (one product with R^2, as
  mont_mul_map's to_mont; `lcpc_ntt_words_pass`).  It raises if a launch
  fails.  On CPU tensors it runs `ntt_forward_plain` (after
  mont_mul_map_plain's to_mont for words in; then from_mont and the pack
  for the words out).  `ntt_forward.launches` counts kernel launches.
- `ntt_forward_plain` is the plain PyTorch twin: the Gentleman-Sande ladder
  of `_ntt_forward` with FieldOps.add_plain/sub_plain/mul_plain (no
  kernel), on any device.  Both return
  the unique residues < p, so they agree limb for limb.
  `ntt_forward_passes_plain` runs the same ladder pass by pass with the
  kernel's tile and butterfly index arithmetic (for the tests).
- `InttPlan` / `intt_inverse` (fffft's ifft_oi, lcpc_tpu `_intt_inverse`):
  the wrapper launches csrc/ntt_mont.cu's inverse pass, one launch per
  pass (the forward plan's passes reversed, each pass's stages in rounds
  of two, `inverse_rounds`; an inverse twiddle table derived from the
  forward one, its last stage carrying n^-1), on CUDA tensors, or raises;
  CPU tensors take `intt_inverse_plain`, the DIT ladder over FieldOps'
  plain versions.  `intt_inverse_passes_plain` runs it pass by pass and
  round by round with the kernel's index arithmetic and table (for the
  tests).
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
from ..utils.device import with_index
from . import launch_count
from .limbs import FieldOps, get_ops, pack_row_words
from .mont_dot import field_consts
from .spmv import pack_words, unpack_words

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

    def inverse_threads(self, tiles: int) -> int:
        """Threads per block of the inverse pass over a grid of `tiles`: a
        radix-4 unit (4 elements) each a round, or a butterfly each where
        the pass has one stage; at most 256, or 128 from SMALL_GRID tiles on
        (two units a thread, twice the blocks an SM, one block's barrier
        beside another's products: on an H100, 6.43 against 7.15 ms at 256
        rows of 2^17, 0.0728 against 0.0797 at 2 rows the other way).
        csrc/ntt_mont.cu ntt_inverse_pass_kernel."""
        per = 2 if self.hi == self.lo else 4
        cap = MAX_THREADS // 2 if tiles >= SMALL_GRID else MAX_THREADS
        return max(1, min(cap, (1 << self.log_tile) // per))

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
        key = ("kernel", with_index(device))  # as the kernels' tensors report it
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
    lib.lcpc_ntt_words_pass.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.lcpc_ntt_inverse_pass.argtypes = [p] * 6 + [i] * 8 + [p]
    for fn in (lib.lcpc_ntt_pass, lib.lcpc_ntt_words_pass, lib.lcpc_ntt_inverse_pass):
        fn.restype = ctypes.c_int


_OUTPUTS = ("limbs", "both", "words")
_INPUTS = ("limbs", "words")


def ntt_forward(plan: NttPlan, x: torch.Tensor, *, output: str = "limbs",
                input: str = "limbs"):
    """Forward NTT of each row, zero-padded to n: with input="limbs" x is
    (W, R, k <= n) int32 Montgomery limbs; with input="words" (the
    verifier's proof rows) x is (R, k <= n, W/2) canonical words, int32
    storage of u32, any value below R = 2^(16 W), which the first pass
    takes to Montgomery form as it loads them (a product with R^2, as
    mont_mul_map's to_mont: no launch of its own).  `output` names what the
    last pass writes:
      "limbs"  (W, R, n) limbs in bit-reversed order;
      "both"   (limbs, words), words the canonical hash words, (R*W/2, n)
               int32 storage of LE u32 words (word r*W/2 + i of column c);
      "words"  the words alone (no limb stores: the streaming commit's
               encode).

    CUDA tensors go through the kernel (csrc/ntt_mont.cu), one launch per
    pass, each counted in ntt_forward.launches, or raise; CPU tensors take
    ntt_forward_plain (after mont_mul_map_plain's to_mont for words in;
    then from_mont and the pack for words out).  Any other device
    raises."""
    w = plan.spec.w16
    if x.dtype != torch.int32:
        raise TypeError(f"ntt_forward: x must be int32, got {x.dtype}")
    if input not in _INPUTS:
        raise ValueError(f"ntt_forward: input must be one of {_INPUTS}, got {input!r}")
    words_in = input == "words"
    # the dims of the element's limbs or words, of the columns, and their count
    e_dim, k_dim, rows = (2, 1, w // 2) if words_in else (0, 2, w)
    if x.dim() != 3 or x.shape[e_dim] != rows or x.shape[k_dim] > plan.n:
        want = f"(R, k <= {plan.n}, {rows})" if words_in else f"({w}, R, k <= {plan.n})"
        raise ValueError(f"ntt_forward: x must be {want}, got {tuple(x.shape)}")
    if output not in _OUTPUTS:
        raise ValueError(f"ntt_forward: output must be one of {_OUTPUTS}, got {output!r}")
    if x.device.type == "cpu":
        if words_in:
            from .mont_map import mont_mul_map_plain
            x = mont_mul_map_plain(plan.spec, x.permute(2, 0, 1), op="to_mont", in_form="words")
        y = ntt_forward_plain(plan, x)
        if output == "limbs":
            return y
        words = pack_row_words(plan.ops.from_mont_plain(y))
        return (y, words) if output == "both" else words
    if x.device.type != "cuda":
        raise ValueError(f"ntt_forward: unsupported device {x.device}")
    x = x.contiguous()
    if words_in and x.data_ptr() % 16:  # the kernel's vector loads
        x = x.clone()
    r, k = (x.shape[0], x.shape[1]) if words_in else (x.shape[1], x.shape[2])
    n, w32 = plan.n, w // 2
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
            outs = (None if i == last else buf.data_ptr(),
                    out.data_ptr() if i == last and out is not None else None,
                    words.data_ptr() if i == last and words is not None else None)
            shape = (w32, r, plan.log_n, k, ps.hi, ps.lo, ps.log_t,
                     ps.threads(r << (plan.log_n - ps.log_tile)), dev, stream)
            if i == 0 and words_in:  # the proof rows to Montgomery form in the first load
                err = lib.lcpc_ntt_words_pass(x.data_ptr(), *outs, tw.data_ptr(),
                                              field_consts(plan.spec, x.device).data_ptr(),
                                              *shape)
            else:
                err = lib.lcpc_ntt_pass(x.data_ptr() if i == 0 else None,
                                        None if i == 0 else buf.data_ptr(), *outs,
                                        tw.data_ptr(), consts.data_ptr(), *shape)
            if err != 0:
                raise RuntimeError(f"ntt_mont pass {i} (half-sizes 2^{ps.hi} .. 2^{ps.lo}) "
                                   f"launch failed: cudaError_t {err}")
            ntt_forward.launches += 1
    if output == "limbs":
        return out
    return (out, words) if output == "both" else words


launch_count.counted(ntt_forward)


# ---- inverse --------------------------------------------------------------------------


class InttPlan:
    """The inverse transform of size n (fffft's ifft_oi semantics:
    bit-reversed input -- fft_io's output order -- to in-order
    coefficients): the stage twiddles on the host, exactly lcpc_tpu's
    `InttPlan.stage_twiddles` ((W, m) Montgomery limbs of w_2m^-j for
    half-sizes m = 1 .. n/2), n^-1, and the kernel's passes: the forward
    plan's (plan_passes, the same keyword arguments) in reverse, each
    running its stages from the smallest half-size up."""

    def __init__(self, spec: FieldSpec, n: int, **pass_kw):
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        self.spec = spec
        self.n = n
        self.log_n = n.bit_length() - 1
        if self.log_n > spec.s:
            raise ValueError(f"n = 2^{self.log_n} exceeds {spec.name}'s 2-adicity {spec.s}")
        self.ops = get_ops(spec)
        self.n_inv_limbs = self.ops.encode_host([pow(n, spec.p - 2, spec.p)])[:, 0]
        self.passes = plan_passes(self.log_n, spec.w16 // 2, **pass_kw)[::-1]
        self._tables: dict = {}

    @functools.cached_property
    def stage_twiddles(self) -> list[np.ndarray]:
        """(W, m) Montgomery limbs of w_2m^-j for the DIT stages m = 1 .. n/2
        (built on the host when first read): the plain version's table."""
        spec, n, p = self.spec, self.n, self.spec.p
        w_n_inv = pow(spec.root_for_log_len(self.log_n), p - 2, p)
        return [self.ops.encode_host(_powers(pow(w_n_inv, n // (2 * m), p), m, p))
                for m in (1 << s for s in range(self.log_n))]

    @property
    def launches_per_call(self) -> int:
        """Kernel launches of one intt_inverse: one per pass."""
        return len(self.passes)

    def stage_tensors(self, device) -> list[torch.Tensor]:
        """The stage twiddles as (W, m) int32 tensors on `device` (plain version)."""
        key = ("stages", torch.device(device))
        if key not in self._tables:
            self._tables[key] = [torch.from_numpy(t.astype(np.int32)).to(device)
                                 for t in self.stage_twiddles]
        return self._tables[key]

    def kernel_table(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(tw, consts) for the kernel on `device`: tw (n-1, W32) packed
        words, half-size m's w_2m^-j at rows m-1 .. 2m-2 in ascending j, the
        last stage's (m = n/2) times n^-1 (inverse_stage_twiddles reads it
        back); consts the forward's p words | -p^-1 mod 2^32 (the kernel
        takes u n^-1 as u 2^-log_n by one Montgomery step).  Derived on the
        device from the forward plan's table (get_ntt(spec, n).kernel_table):
        w_2m^-j = -w_2m^(m-j) for j >= 1, its rows gathered and multiplied by
        -1 (every stage but the last) or -n^-1 (the last) in two mont_mul_map
        launches; rows j = 0 hold 1 and n^-1."""
        key = ("kernel", with_index(device))  # as the kernels' tensors report it
        if key not in self._tables:
            from .mont_map import mont_mul_map

            spec, n, p = self.spec, self.n, self.spec.p
            fwd, consts = get_ntt(spec, n).kernel_table(device)
            src = np.concatenate([np.concatenate(([m - 1], np.arange(2 * m - 2, m - 1, -1)))
                                  for m in (1 << s for s in range(self.log_n))])
            rows = fwd[torch.from_numpy(src).to(fwd.device)]

            def words(v):  # (W32, 1) Montgomery words of the host int v
                host = self.ops.encode_host([v]).astype(np.int32)
                return pack_words(torch.from_numpy(host), 0).to(fwd.device)

            n_inv, half = pow(n, p - 2, p), n // 2
            tw = torch.empty_like(rows)
            for lo, hi, c in ((0, half - 1, p - 1), (half - 1, n - 1, p - n_inv)):
                mont_mul_map(spec, rows[lo:hi].T, words(c), in_form="words", out_form="words",
                             out=tw[lo:hi].T)
            tw[[m - 1 for m in (1 << s for s in range(self.log_n - 1))]] = words(1)[:, 0]
            tw[half - 1] = words(n_inv)[:, 0]
            self._tables[key] = (tw, consts)
        return self._tables[key]


@functools.lru_cache(maxsize=None)
def get_intt(spec: FieldSpec, n: int) -> InttPlan:
    """The size-n inverse plan of `spec`; its device tables are cached per device."""
    return InttPlan(spec, n)


def inverse_stage_twiddles(plan: InttPlan, tw: torch.Tensor) -> list[torch.Tensor]:
    """The inverse stage twiddles the kernel's table tw ((n-1, W32) packed
    words, InttPlan.kernel_table) holds: rows m-1 .. 2m-2 as (W, m) int32
    Montgomery limbs for m = 1 .. n/2, the last stage's n^-1 taken back out
    (times n); equal to plan.stage_twiddles (the tests hold them)."""
    ops = plan.ops
    limbs = unpack_words(tw.T.contiguous(), 0)  # (W, n-1)
    out = [limbs[:, m - 1 : 2 * m - 1] for m in (1 << s for s in range(plan.log_n))]
    out[-1] = ops.mul_const_plain(out[-1], ops.encode_host([plan.n])[:, 0])
    return out


def inverse_rounds(k_stages: int) -> list[tuple[int, int]]:
    """The rounds of an inverse pass of k_stages stages, as (first local
    stage, stages): two at a time (a radix-4 unit a thread), the first
    round one stage where k_stages is odd (ntt_inverse_pass_kernel)."""
    s0 = 1 if k_stages & 1 else 2
    return [(0, s0)] + [(k, 2) for k in range(s0, k_stages, 2)]


def intt_inverse_plain(plan: InttPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ladder (any device): x (W, R, n) Montgomery limbs in
    bit-reversed order -> in-order coefficients: DIT butterflies u' = u +
    v tw, v' = u - v tw with the inverse twiddles for m = 1 .. n/2, then
    the n^-1 scale (lcpc_tpu `_intt_inverse`, without the TPU's head/tail
    layout split), with FieldOps' plain versions only."""
    ops = plan.ops
    w, r, n = x.shape
    for s, tw in enumerate(plan.stage_tensors(x.device)):
        m = 1 << s
        xr = x.reshape(w, r, n // (2 * m), 2, m)
        u, v = xr[:, :, :, 0], xr[:, :, :, 1]
        vw = ops.mul_plain(v, tw[:, None, None, :])
        x = torch.stack([ops.add_plain(u, vw), ops.sub_plain(u, vw)], dim=3).reshape(w, r, n)
    return ops.mul_const_plain(x, plan.n_inv_limbs)


def intt_inverse_passes_plain(plan: InttPlan, x: torch.Tensor) -> torch.Tensor:
    """The plain ladder run as the inverse kernel runs it: each pass's tiles
    (NttPass.tile_indices), its stages in inverse_rounds, each round's
    radix-4 units (residue t = unit mod T, groups g0 + m 2^k) with their
    twiddle indices, the twiddles read at the kernel table's rows (its
    values from plan.stage_twiddles, the last stage's times n^-1, with
    FieldOps' plain versions: InttPlan.kernel_table equals them, the tests
    hold it), the transform's last stage multiplying u by n^-1 (the kernel:
    u 2^-log_n by one Montgomery step, the same residue) against the
    table's n^-1-scaled entries; a one-stage pass a butterfly (t, T + t) at
    a time.  (The kernel's first round of the first pass leaves out its
    products by 1; a product by 1 is the same residue.)  Equals
    intt_inverse_plain; the CPU tests hold the kernel's index arithmetic
    and table to it."""
    ops = plan.ops
    dev = x.device
    stages = list(plan.stage_tensors(dev))
    stages[-1] = ops.mul_const_plain(stages[-1], plan.n_inv_limbs)
    tw = torch.cat(stages, dim=1)                            # (W, n-1): the kernel table's rows

    def bfly(u, v, w, fold):  # (u + v w, u - v w); the last stage: u n^-1 first
        t = ops.mul_plain(v, w[:, None])
        if fold:
            u = ops.mul_const_plain(u, plan.n_inv_limbs)
        return ops.add_plain(u, t), ops.sub_plain(u, t)

    def table(sg, j):  # stage 2^sg's twiddles at indices j (tiles, units): (W, tiles, units)
        return tw[:, torch.from_numpy((1 << sg) - 1 + j).to(dev)]

    x = x.clone()
    for ps in plan.passes:
        idx = torch.from_numpy(ps.tile_indices(plan.log_n)).to(dev)
        xt = x[:, :, idx]                                    # (W, R, tiles, tile)
        k_stages, t_n = ps.hi - ps.lo + 1, 1 << ps.log_t
        rj = (np.arange(idx.shape[0]) & ((1 << (ps.lo - ps.log_t)) - 1))[:, None] << ps.log_t
        fold_pass = ps.hi == plan.log_n - 1
        if k_stages == 1:  # butterflies (t, T + t) at twiddle rj + t
            t = np.arange(t_n)
            e = torch.from_numpy(t).to(dev)
            u, v = bfly(xt[..., e], xt[..., e + t_n], table(ps.lo, rj + t), fold_pass)
            xt[..., e], xt[..., e + t_n] = u, v
        for k, stages in inverse_rounds(k_stages) if k_stages > 1 else []:
            fold = fold_pass and k + stages == k_stages
            uu = np.arange((1 << ps.log_tile) >> 2)
            t, q = uu & (t_n - 1), uu >> ps.log_t
            jg = q & ((1 << k) - 1)
            g0 = ((q >> k) << (k + 2)) | jg
            e = [torch.from_numpy(((g0 + (m << k)) << ps.log_t) + t).to(dev) for m in range(4)]
            j1 = (jg << ps.lo) + rj + t                      # (tiles, units)
            sg = ps.lo + k
            xs = [xt[..., em] for em in e]
            w1 = table(sg, j1)
            f1 = fold and stages == 1
            xs[0], xs[1] = bfly(xs[0], xs[1], w1, f1)
            xs[2], xs[3] = bfly(xs[2], xs[3], w1, f1)
            if stages == 2:
                xs[0], xs[2] = bfly(xs[0], xs[2], table(sg + 1, j1), fold)
                xs[1], xs[3] = bfly(xs[1], xs[3], table(sg + 1, j1 + (1 << sg)), fold)
            for em, xm in zip(e, xs):
                xt[..., em] = xm
        x = torch.empty_like(x)
        x[:, :, idx] = xt
    return x


def intt_inverse(plan: InttPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of each row: x (W, R, n) int32 Montgomery limbs below p,
    bit-reversed (ntt_forward's output) -> (W, R, n) in-order coefficients,
    the unique residues < p.

    CUDA tensors go through the kernel (csrc/ntt_mont.cu's inverse pass),
    one launch per pass of plan.passes, each counted in
    intt_inverse.launches, or raise; passes hand over through a packed (R,
    n, W32) scratch buffer.  CPU tensors take intt_inverse_plain.  Any
    other device raises."""
    w = plan.spec.w16
    if x.dtype != torch.int32:
        raise TypeError(f"intt_inverse: x must be int32, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != w or x.shape[2] != plan.n:
        raise ValueError(f"intt_inverse: x must be ({w}, R, {plan.n}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return intt_inverse_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"intt_inverse: unsupported device {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the first pass's 16-byte limb loads
        x = x.clone()
    r, n, w32 = x.shape[1], plan.n, w // 2
    out = torch.empty_like(x)
    if r:
        buf = (torch.empty((r, n, w32), dtype=torch.int32, device=x.device)
               if len(plan.passes) > 1 else None)
        tw, consts = plan.kernel_table(x.device)
        lib = cuda_build.load(_NAME, _bind)
        dev = x.device.index or 0
        stream = torch.cuda.current_stream(x.device).cuda_stream
        last = len(plan.passes) - 1
        for i, ps in enumerate(plan.passes):
            err = lib.lcpc_ntt_inverse_pass(
                x.data_ptr() if i == 0 else None,
                None if i == 0 else buf.data_ptr(),
                None if i == last else buf.data_ptr(),
                out.data_ptr() if i == last else None,
                tw.data_ptr(), consts.data_ptr(), w32, r, plan.log_n, ps.hi, ps.lo,
                ps.log_t, ps.inverse_threads(r << (plan.log_n - ps.log_tile)), dev, stream)
            if err != 0:
                raise RuntimeError(f"ntt_mont inverse pass {i} (half-sizes 2^{ps.lo} .. "
                                   f"2^{ps.hi}) launch failed: cudaError_t {err}")
            intt_inverse.launches += 1
    return out


launch_count.counted(intt_inverse)


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
