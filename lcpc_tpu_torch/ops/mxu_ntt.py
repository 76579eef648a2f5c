"""The four-step NTT on the tensor cores (port of lcpc_tpu/ops/mxu_ntt.py).

The same forward transform as the ladder (ops/ntt.py: natural input,
fft_io's bit-reversed output, out[bitrev(k)] = sum_j x[j] w_n^(jk)), as
the classic four-step decomposition n = A B:

    step 1: a DFT of size A along the major axis (a matrix product with
            K1[u, i] = w_A^(rev_A(u) i): rev_A baked in);
    step 2: the twiddle product tw[u, j] = w_n^(rev_A(u) j);
    step 3: a DFT of size B along the minor axis (K2[v, j] = w_B^(rev_B(v) j)),

so out[r, u B + v] is fft_io's output.  With in_len < n (the rate-1/m
systematic encode: only the first in_len inputs are nonzero) step 1
contracts only the A_nz = in_len / B nonzero channels (`_pick_ab` balances
B against in_len).  Every table is lcpc_tpu's `MxuNttPlan` entry for entry:
tw is its limb table; K1 and K2 are its entries with the port's scale in
place of its R7 = 2^(7 W7r) (K1 and the Montgomery K2 carry R^2 mod p, the
canonical K2 R mod p: lcpc_tpu's R^-1 folded into k2 by `canonical_out`).

- `conv_cap`, `mxu_supported`, `_pick_ab`: lcpc_tpu's, so a forced route
  takes the MXU plan at exactly the shapes lcpc_tpu does (contractions up
  to conv_cap: 2,048 for ft255, 8,192 for ft63).  The port's own bound is
  looser: u8 digits, each anti-diagonal digit sum in an s32 accumulator
  read as u32, exact while a contraction's bytes C D stay within 2^16 (as
  ops/mont_dot.py's FOLD_K = 2^15 k-steps of 255^2 bounds its sums); past
  that the kernel sums chunks of 2^16 bytes (`chunk_c`) in shared memory,
  so it takes any contraction.
- `MxuNttPlan(spec, n, in_len, canonical_out, share_from)`: the tables,
  built once with Python ints as lcpc_tpu builds them (k1, k2: (W/2, P, C)
  u32 words; tw: (W, A, B) u32 limbs); `device_tables` puts them on a
  device once as the kernel reads them: the constants as byte tables
  ((P, CP, D) u8, D = 2W bytes an element, CP = C rounded up to the
  kernel's stage, `stage_c`), tw as (B, A, W/2) words.  share_from reuses
  k1 and tw.
- `MxuNtt(spec, n, in_len, canonical_out, share_plan)(x, output=,
  input=)`: (W, R, k <= in_len) Montgomery limbs (input="limbs") or (R, k,
  W/2) canonical words below R (input="words", verify's proof rows) ->
  (W, R, n) Montgomery limbs ("limbs"), the canonical hash words
  ((R W/2, n), pack_row_words' layout: "words", by the canonical plan when
  the input is limbs) or both ("both"): ntt_forward's modes and layouts.
- `mxu_dft`: the kernel's wrapper (csrc/mxu_ntt.cu `lcpc_mxu_dft`), one
  launch of one step, counted in `mxu_dft.launches`; a transform is two,
  STEP 1 writing z ((R, A, B) elements, each element's bytes reversed:
  STEP 3's Toeplitz operand) for STEP 3 to read.
  The kernel's roles for lcpc_tpu's 7-bit machinery (`_to7`, `_from7`,
  `_conv_digits`, `ReducePlan`, `_matmul_toep`, `_carry7`, none carried
  over): the loading threads put each element's bytes, reversed, into a
  zero-padded shared-memory slot (`_to7`); mma.sync u8 products of those
  slots, read as a Toeplitz matrix of the digits, with the constants'
  bytes give each output's anti-diagonal digit sums whole
  (`_conv_digits`, the Toeplitz matmuls); a thread an output assembles
  the sum from them and reduces it once (`_carry7`, `ReducePlan`); step 1's
  store multiplies by the twiddle and step 3's writes limbs or words
  (`_from7`, `ops.mul`).
- `mxu_ntt_plain(ntt, x, output=, input=)`: the plain version, on any
  device: the same three steps with FieldOps' plain products (mont_dot_plain
  for the two DFTs, mul_plain for the twiddles).

MxuNtt on a CUDA tensor launches the kernel twice or raises; on a CPU
tensor it runs mxu_ntt_plain (no launch counted); any other device raises.
get_mxu_ntt / get_mxu_ntt_canonical cache the transforms by (spec, n,
in_len), in_len == n the full plan (`_norm_in_len`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from . import launch_count
from .limbs import get_ops, pack_row_words
from .mont_dot import field_consts, mont_dot_plain
from .ntt import bit_reverse_indices
from .spmv import pack_words, unpack_words

OUTPUTS = ("limbs", "both", "words")
INPUTS = ("limbs", "words")
CHUNK_BYTES = 1 << 16  # csrc/mxu_ntt.cu kChunkBytes: contraction bytes whose sums stay below 2^32


def stage_c(spec: FieldSpec) -> int:
    """Contraction elements a stage of csrc/mxu_ntt.cu (Dft<W>::CS)."""
    d = 2 * spec.w16
    return 8 if d >= 24 else 256 // d


def chunk_c(spec: FieldSpec) -> int:
    """Contraction elements a chunk: the most whole stages of at most
    CHUNK_BYTES bytes."""
    cs = stage_c(spec)
    return CHUNK_BYTES // (2 * spec.w16) // cs * cs


def _pick_ab(n: int, in_len: "int | None" = None) -> tuple[int, int]:
    """Split n = A B with A, B powers of two (lcpc_tpu's): balanced for the
    full transform, B balanced against in_len for a zero-padded input."""
    if in_len is None or in_len >= n:
        log = n.bit_length() - 1
        a = 1 << (log // 2 + log % 2)
        return a, n // a
    log_in = in_len.bit_length() - 1
    b = 1 << ((log_in + 1) // 2)
    return n // b, b


def conv_cap(spec: FieldSpec) -> int:
    """lcpc_tpu's largest power-of-two contraction (its int8 conv's int32
    accumulator over 7-bit digits): 2,048 for ft255, 4,096 for ft127 and
    ft191, 8,192 for ft63.  The port keeps it so both packages admit the
    same shapes; its own kernel takes any contraction (chunk_c)."""
    w7 = (spec.num_bits + 6) // 7
    cap = (1 << 31) // (w7 * 127 * 127)
    return 1 << (cap.bit_length() - 1)


def mxu_supported(spec: FieldSpec, n: int, in_len: "int | None" = None) -> bool:
    """True where one four-step level covers size n (lcpc_tpu's): both
    contractions at most conv_cap; with in_len < n the step-1 contraction
    is in_len / B."""
    if n < 4:
        return False
    a, b = _pick_ab(n, in_len)
    a_nz = a if in_len is None or in_len >= n else in_len // b
    if in_len is not None and in_len < n and (a_nz == 0 or in_len % b):
        return False
    return max(a_nz, b) <= conv_cap(spec)


def _table(spec: FieldSpec, w_root: int, rev: np.ndarray, n_out: int, n_in: int,
           scale: int) -> np.ndarray:
    """(W/2, n_out, n_in) u32 words of scale * w_root^(rev[u] i) mod p for
    u < n_out, i < n_in (lcpc_tpu's `_dft_kernel` order of products)."""
    p, w32 = spec.p, spec.w16 // 2
    nbytes = 4 * w32
    buf = bytearray(n_out * n_in * nbytes)
    pos = 0
    for u in range(n_out):
        w_row = pow(w_root, int(rev[u]), p)
        entry = scale % p
        for _ in range(n_in):
            buf[pos : pos + nbytes] = entry.to_bytes(nbytes, "little")
            pos += nbytes
            entry = (entry * w_row) % p
    words = np.frombuffer(bytes(buf), dtype="<u4").reshape(n_out, n_in, w32)
    return np.ascontiguousarray(np.moveaxis(words, 2, 0))


def byte_table(words: np.ndarray, cs: int) -> np.ndarray:
    """(W/2, P, C) u32 words -> (P, CP, D) u8: [p, c] holds element (p, c)'s
    D = 4 W/2 bytes, little-endian; zero from C on, CP = C rounded up to cs
    (the stage csrc/mxu_ntt.cu streams in)."""
    w32, P, C = words.shape
    cp = -(-C // cs) * cs
    out = np.zeros((P, cp, 4 * w32), dtype=np.uint8)
    out[:, :C] = np.ascontiguousarray(np.moveaxis(words.astype("<u4"), 0, 2)).view(
        np.uint8).reshape(P, C, 4 * w32)
    return out


class MxuNttPlan:
    """The four-step plan of an n-point transform, optionally with a
    zero-padded input of length in_len (lcpc_tpu's MxuNttPlan: the same
    split, contractions and entries; the scale of k1 and k2 is the port's,
    `k1_scale` / `k2_scale`)."""

    def __init__(self, spec: FieldSpec, n: int, in_len: "int | None" = None,
                 canonical_out: bool = False, share_from: "MxuNttPlan | None" = None):
        if n < 4 or n & (n - 1):
            raise ValueError(f"MxuNttPlan: n must be a power of two >= 4, got {n}")
        self.spec = spec
        self.n = n
        self.canonical_out = canonical_out
        self.in_len = in_len = n if in_len is None else in_len
        if in_len & (in_len - 1) or in_len > n:
            raise ValueError(f"MxuNttPlan: in_len must be a power of two <= {n}, got {in_len}")
        self.a, self.b = _pick_ab(n, in_len)
        self.a_nz = in_len // self.b  # the nonzero input channels
        if max(self.a_nz, self.b) > conv_cap(spec):
            raise ValueError(f"MxuNttPlan: a contraction of {max(self.a_nz, self.b)} is past "
                             f"{spec.name}'s conv_cap {conv_cap(spec)}")
        self.ops = get_ops(spec)
        p = spec.p
        self.k1_scale = spec.R2
        self.k2_scale = spec.R if canonical_out else spec.R2
        w_n = spec.root_for_log_len(n.bit_length() - 1)
        rev_a = bit_reverse_indices(self.a)
        if share_from is not None:
            # the Montgomery and canonical plans differ only in k2's scale
            if (share_from.n, share_from.in_len) != (n, in_len):
                raise ValueError("MxuNttPlan: share_from is another shape's plan")
            self.k1, self.tw, self._dev1 = share_from.k1, share_from.tw, share_from._dev1
        else:
            # k1[w, u, i] = w_A^(rev_A(u) i) R^2; zero-padded inputs keep the
            # first a_nz input channels
            self.k1 = _table(spec, pow(w_n, self.b, p), rev_a, self.a, self.a_nz,
                             self.k1_scale)
            # tw[limb, u, j] = w_n^(rev_A(u) j), Montgomery limbs (lcpc_tpu's table)
            rbytes = spec.repr_bytes
            buf = bytearray(self.a * self.b * rbytes)
            pos = 0
            for u in range(self.a):
                base = pow(w_n, int(rev_a[u]), p)
                acc = spec.R % p
                for _ in range(self.b):
                    buf[pos : pos + rbytes] = acc.to_bytes(rbytes, "little")
                    pos += rbytes
                    acc = (acc * base) % p
            u16 = np.frombuffer(bytes(buf), dtype="<u2").reshape(self.a, self.b, spec.w16)
            self.tw = np.ascontiguousarray(np.moveaxis(u16, 2, 0)).astype(np.uint32)
            self._dev1 = {}
        # k2[w, v, j] = w_B^(rev_B(v) j) times R^2, or R (canonical_out)
        self.k2 = _table(spec, pow(w_n, self.a, p), bit_reverse_indices(self.b), self.b,
                         self.b, self.k2_scale)
        self._dev2: dict = {}

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(k1 (A, CP1, D) u8, tw (B, A, W/2) int32 words, k2 (B, CP2, D) u8)
        on `device`, made there once (k1 and tw shared with share_from's
        plan): what csrc/mxu_ntt.cu reads."""
        key = torch.device(device)
        cs = stage_c(self.spec)
        if key not in self._dev1:
            tw = pack_words(torch.from_numpy(self.tw.astype(np.int32)), 0)  # (W/2, A, B)
            self._dev1[key] = (torch.from_numpy(byte_table(self.k1, cs)).to(key),
                               tw.permute(2, 1, 0).contiguous().to(key))
        if key not in self._dev2:
            self._dev2[key] = torch.from_numpy(byte_table(self.k2, cs)).to(key)
        return (*self._dev1[key], self._dev2[key])

    def word_tables(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(k1 (W/2, A, A_nz) int32 words, tw (W, A, B) int32 limbs, k2
        (W/2, B, B) int32 words) on `device`: the plain version's operands."""
        return tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                     for t in (self.k1, self.tw, self.k2))


def _bind(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lcpc_mxu_dft.argtypes = [i, i, p, ll, i, i, i, i, p, ll, ll, ll, i, ll, ll, ll, p, p, p,
                                 p, p, i, i, p, i, i, p]
    lib.lcpc_mxu_dft.restype = ctypes.c_int


def mxu_dft(spec: FieldSpec, step: int, tbl: torch.Tensor, data: torch.Tensor, *, NR: int,
            NCOL: int, C: int, R: int, chunk: int, strides: tuple = (0, 0, 0),
            limbs: bool = False, k: int = 0, sc: int = 0, sq: int = 0,
            tw: "torch.Tensor | None" = None, zout: "torch.Tensor | None" = None,
            lout: "torch.Tensor | None" = None, wout: "torch.Tensor | None" = None,
            lconv: bool = False, wconv: bool = False) -> None:
    """One launch of csrc/mxu_ntt.cu's step `step` (1 or 3) on the card: the
    NCOL constants' byte table `tbl` ((NCOL, CP, D) u8) against NR data
    elements over a contraction of C, `chunk` elements at a time.  STEP 1:
    data is x (word w of element m = c sc + row sq of row r at w s_w + r s_r
    + m s_m, `strides` (s_w, s_r, s_m); 16-bit limbs with `limbs`; m >= k
    reads 0), the twiddles tw, into zout; STEP 3: data is z, into lout /
    wout.  Every tensor on one CUDA device, or it raises."""
    tensors = [t for t in (tbl, data, tw, zout, lout, wout) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"mxu_dft: operands on {sorted(map(str, devices))}")
    device = data.device
    if device.type != "cuda":
        raise ValueError(f"mxu_dft: the kernel takes CUDA tensors, got {device} "
                         f"(MxuNtt runs mxu_ntt_plain on the CPU)")
    if (tbl.dtype != torch.uint8 or not tbl.is_contiguous() or tbl.dim() != 3
            or tbl.shape[0] != NCOL or tbl.shape[2] != 2 * spec.w16 or tbl.shape[1] < C):
        raise ValueError(f"mxu_dft: tbl must be contiguous ({NCOL}, CP >= {C}, "
                         f"{2 * spec.w16}) uint8, got {tuple(tbl.shape)} {tbl.dtype}")
    for t in (data, tw, zout, lout, wout):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"mxu_dft: int32 operands, got {t.dtype}")
    lib = cuda_build.load("mxu_ntt", _bind)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    x, z = (data, None) if step == 1 else (None, data)
    err = lib.lcpc_mxu_dft(step, spec.w16 // 2, tbl.data_ptr(), tbl.shape[1], NR, NCOL, C,
                           chunk, ptr(x), *strides, int(limbs), k, sc, sq, ptr(z), ptr(tw),
                           ptr(zout), ptr(lout), ptr(wout), int(lconv), int(wconv),
                           field_consts(spec, device).data_ptr(), R, device.index or 0,
                           torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mxu_dft step {step} launch failed: cudaError_t {err}")
    mxu_dft.launches += 1


launch_count.counted(mxu_dft)


class MxuNtt:
    """The four-step transform of one plan: __call__(x, output=, input=)
    as the module docstring says (ntt_forward's modes and layouts)."""

    def __init__(self, spec: FieldSpec, n: int, in_len: "int | None" = None,
                 canonical_out: bool = False, share_plan: "MxuNttPlan | None" = None):
        self.plan = MxuNttPlan(spec, n, in_len=in_len, canonical_out=canonical_out,
                               share_from=share_plan)
        self.spec = spec
        self.n = n
        self.in_len = self.plan.in_len
        self.canonical_out = canonical_out
        self._sibling: "MxuNtt | None" = None

    def for_mode(self, output: str, input: str) -> "MxuNtt":
        """The transform whose plan gives `output` from `input`: the
        canonical plan for words out of limbs, the Montgomery plan
        otherwise (its sibling built once, sharing k1 and tw)."""
        canon = output == "words" and input == "limbs"
        if canon == self.canonical_out:
            return self
        if self._sibling is None:
            self._sibling = MxuNtt(self.spec, self.n, self.plan.in_len, canonical_out=canon,
                                   share_plan=self.plan)
            self._sibling._sibling = self
        return self._sibling

    def check(self, x: torch.Tensor, output: str, input: str) -> tuple[int, int]:
        """(R, k) of a valid input, or raises."""
        w = self.spec.w16
        if x.dtype != torch.int32:
            raise TypeError(f"MxuNtt: x must be int32, got {x.dtype}")
        if input not in INPUTS:
            raise ValueError(f"MxuNtt: input must be one of {INPUTS}, got {input!r}")
        if output not in OUTPUTS:
            raise ValueError(f"MxuNtt: output must be one of {OUTPUTS}, got {output!r}")
        words_in = input == "words"
        e_dim, k_dim, rows = (2, 1, w // 2) if words_in else (0, 2, w)
        if x.dim() != 3 or x.shape[e_dim] != rows or x.shape[k_dim] > self.in_len:
            want = (f"(R, k <= {self.in_len}, {rows})" if words_in
                    else f"({w}, R, k <= {self.in_len})")
            raise ValueError(f"MxuNtt: x must be {want}, got {tuple(x.shape)}")
        return (x.shape[0], x.shape[1]) if words_in else (x.shape[1], x.shape[2])

    def __call__(self, x: torch.Tensor, *, output: str = "limbs", input: str = "limbs"):
        r, k = self.check(x, output, input)
        ntt = self.for_mode(output, input)
        if x.device.type == "cpu":
            return mxu_ntt_plain(ntt, x, output=output, input=input)
        if x.device.type != "cuda":
            raise ValueError(f"MxuNtt: unsupported device {x.device}")
        plan, spec = ntt.plan, self.spec
        w, w32, n, dev = spec.w16, spec.w16 // 2, self.n, x.device
        a, b = plan.a, plan.b
        lout = (torch.empty((w, r, n), dtype=torch.int32, device=dev)
                if output != "words" else None)
        wout = (torch.empty((r * w32, n), dtype=torch.int32, device=dev)
                if output != "limbs" else None)
        if r:
            k1, tw, k2 = plan.device_tables(dev)
            words_in = input == "words"
            st = (x.stride(2), x.stride(0), x.stride(1)) if words_in else x.stride()
            z = torch.empty((r, a, b, w32), dtype=torch.int32, device=dev)
            chunk = chunk_c(spec)
            mxu_dft(spec, 1, k1, x, NR=b, NCOL=a, C=plan.a_nz, R=r, chunk=chunk, strides=st,
                    limbs=not words_in, k=k, sc=b, sq=1, tw=tw, zout=z)
            # canonical words in leave each step's value canonical: limbs
            # need R, words nothing; Montgomery limbs in: words need R^-1,
            # but the canonical plan's k2 carries it already
            mxu_dft(spec, 3, k2, z, NR=a, NCOL=b, C=b, R=r, chunk=chunk, lout=lout, wout=wout,
                    lconv=words_in, wconv=not words_in and not plan.canonical_out)
        if output == "limbs":
            return lout
        return (lout, wout) if output == "both" else wout


def mxu_ntt_plain(ntt: MxuNtt, x: torch.Tensor, *, output: str = "limbs",
                  input: str = "limbs"):
    """The plain version of MxuNtt (ntt's own plan), on any device:
    canonical words in taken to Montgomery limbs (mont_mul_map_plain's
    to_mont), zero-padded to in_len; step 1 as mont_dot_plain of k1 with
    the rows' (A_nz, B) blocks (k1's R^2 makes its canonical-form sum the
    Montgomery value), the twiddles by FieldOps.mul_plain, step 3 as
    mont_dot_plain of k2 with z's (B, A) blocks; words from the canonical
    plan's output, or from_mont_plain of the Montgomery plan's, packed by
    pack_row_words."""
    plan, spec = ntt.plan, ntt.spec
    ops, w32, a, b = plan.ops, spec.w16 // 2, plan.a, plan.b
    if input == "words":
        from .mont_map import mont_mul_map_plain
        x = mont_mul_map_plain(spec, x.permute(2, 0, 1), op="to_mont", in_form="words")
    w, r, k = x.shape
    if k < plan.in_len:
        x = torch.nn.functional.pad(x, (0, plan.in_len - k))
    k1, tw, k2 = plan.word_tables(x.device)
    xw = pack_words(x, 0).reshape(w32, r, plan.a_nz, b).permute(0, 2, 1, 3)
    y = mont_dot_plain(spec, k1, xw.reshape(w32, plan.a_nz, r * b))       # (W/2, A, R B)
    z = ops.mul_plain(unpack_words(y, 0).reshape(w, a, r, b), tw[:, :, None, :])
    zw = pack_words(z, 0).permute(0, 3, 2, 1).reshape(w32, b, r * a)      # [w, j, (r, u)]
    o = mont_dot_plain(spec, k2, zw).reshape(w32, b, r, a)                # [w, v, r, u]
    res = unpack_words(o.permute(0, 2, 3, 1).reshape(w32, r, ntt.n), 0)   # out[r, u B + v]
    if output == "limbs":
        return res
    words = pack_row_words(res if plan.canonical_out else ops.from_mont_plain(res))
    return (res, words) if output == "both" else words


def _norm_in_len(n: int, in_len: "int | None") -> "int | None":
    """Cache key: in_len >= n is the full transform, in_len = None's plan."""
    return None if in_len is None or in_len >= n else in_len


@functools.lru_cache(maxsize=None)
def _get_mxu_ntt_cached(spec: FieldSpec, n: int, in_len: "int | None") -> MxuNtt:
    return MxuNtt(spec, n, in_len=in_len)


def get_mxu_ntt(spec: FieldSpec, n: int, in_len: "int | None" = None) -> MxuNtt:
    return _get_mxu_ntt_cached(spec, n, _norm_in_len(n, in_len))


def get_mxu_ntt_canonical(spec: FieldSpec, n: int, in_len: "int | None" = None) -> MxuNtt:
    """The canonical-output transform; shares k1 and the twiddles with the
    Montgomery one of the same shape (each is the other's `for_mode`)."""
    return get_mxu_ntt(spec, n, in_len).for_mode("words", "limbs")
