"""Prime-field limb arithmetic on torch tensors.

Field elements are **limb-major** tensors of shape (W, ...batch) holding
16-bit limbs (little-endian, limb index first) in Montgomery form with
R = 2^(16*W) — the reference package's layout, so a port tensor compares
element for element with the JAX array.

Storage is int32 (a 16-bit limb fits); arithmetic runs in int64.  torch has
no CPU kernels for uint32 add/shift/compare, and the products of two 16-bit
limbs (up to 2^32 - 2^17 + 1) and their lazy column sums overflow int32.
With 63 bits of headroom no op here needs the reference's u32 chunking, and
borrows come from the sign of an int64 difference instead of u32
wraparound.  Every public op returns the unique fully reduced residue, so
any exact algorithm matches the reference bit for bit.

Internally an op works on (L, B) int64 stacks: L limbs (or unnormalized
column sums) over a flat batch B.  Large batches are processed in slices of
_CHUNK elements to bound the (2W+1, B) int64 temporaries.

The elementwise ops (add, sub, neg, mul, mul_const, to_mont, from_mont,
canon_words) launch the mont_map kernels on CUDA tensors (ops/mont_map.py,
csrc/mont_map.cu) and run these int64 graphs on CPU tensors; their *_plain
twins, mul_sum_mont (the SpMV's plain version) and collapse_canon_plain (the
mont_dot kernel's) run the graphs on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec

MASK16 = 0xFFFF
_CHUNK = 1 << 21  # batch elements per slice of an elementwise op
_MATMUL_R = 1 << 20  # float64 matmul depth that keeps sums exact (< 2^53)


def _limbs16(value: int, w: int) -> list[int]:
    return [(value >> (16 * i)) & 0xFFFF for i in range(w)]


def _norm(cols: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Carry-normalize non-negative int64 columns (L, B) to 16-bit limbs.

    Returns (out_limbs, B); carry beyond out_limbs is discarded (callers pick
    out_limbs so it is provably zero, or want the value mod 2^(16*out))."""
    out = cols.new_empty((out_limbs, cols.shape[1]))
    carry = None
    for i in range(out_limbs):
        if i < cols.shape[0]:
            c = cols[i] if carry is None else cols[i] + carry
        else:
            c = carry if carry is not None else torch.zeros_like(cols[0])
        out[i] = c & MASK16
        carry = c >> 16
    return out


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product columns of limb stacks a (La, B) and b (Lb, B)."""
    out = a.new_zeros((a.shape[0] + b.shape[0] - 1, a.shape[1]))
    for i in range(a.shape[0]):
        out[i : i + b.shape[0]] += a[i] * b
    return out


def _conv_const(a: torch.Tensor, c_limbs: list[int], n_cols: int) -> torch.Tensor:
    """Product columns of a (La, B) with a host constant, first n_cols only."""
    out = a.new_zeros((n_cols, a.shape[1]))
    for j, cj in enumerate(c_limbs):
        if cj and j < n_cols:
            hi = min(n_cols, j + a.shape[0])
            out[j:hi] += a[: hi - j] * cj
    return out


def _sub_const(a: torch.Tensor, c_limbs: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """a - c over all limbs of a: (difference limbs mod 2^(16L), a >= c).

    The borrow is the sign of the int64 limb difference (the reference's
    `(d >> 31) & 1` reads the same bit out of a wrapped u32)."""
    out = torch.empty_like(a)
    borrow = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        ci = c_limbs[i] if i < len(c_limbs) else 0
        d = a[i] - ci - borrow
        out[i] = d & MASK16
        borrow = (d < 0).to(a.dtype)
    return out, borrow == 0


def _chunked(fn, *xs: torch.Tensor) -> torch.Tensor:
    """Apply fn to batch slices of (L_i, B) stacks; concatenate on dim 1."""
    b = xs[0].shape[1]
    if b <= _CHUNK:
        return fn(*xs)
    return torch.cat(
        [fn(*(x[:, s : s + _CHUNK] for x in xs)) for s in range(0, b, _CHUNK)],
        dim=1,
    )


class FieldOps:
    """Torch ops for one field; tensors are (W, ...batch) int32 16-bit limbs."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.w = spec.w16
        self.p_limbs = _limbs16(spec.p, self.w)
        self.r2_limbs = _limbs16(spec.R2, self.w)
        self.n0inv_limbs = _limbs16(spec.n0inv_full, self.w)

    # ---- layout helpers --------------------------------------------------------

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[0] == self.w, (x.shape, self.w)
        return x.reshape(self.w, -1).to(torch.int64)

    @staticmethod
    def _out(y: torch.Tensor, batch) -> torch.Tensor:
        return y.to(torch.int32).reshape(y.shape[0], *batch)

    # ---- reductions on stacks ----------------------------------------------------

    def _cond_sub_p(self, v: torch.Tensor) -> torch.Tensor:
        """v < 2p -> v mod p, first W limbs."""
        d, ge = _sub_const(v, self.p_limbs)
        return torch.where(ge, d, v)[: self.w]

    def _cond_sub_chain(self, v: torch.Tensor, max_mult: int) -> torch.Tensor:
        """v < max_mult*p -> v mod p by conditional subtraction of
        power-of-two multiples of p; first W limbs."""
        m = 1
        while m * 2 < max_mult:
            m *= 2
        while m >= 1:
            d, ge = _sub_const(v, _limbs16(m * self.spec.p, v.shape[0]))
            v = torch.where(ge, d, v)
            m //= 2
        return v[: self.w]

    def _redc(self, v: torch.Tensor) -> torch.Tensor:
        """One Montgomery reduction of a wide value (L > W limbs).

        Returns limbs of (V + m*p)/R with m = (V mod R)(-p^-1) mod R, i.e.
        V*R^-1 mod p up to multiples of p, bounded by V/R + p."""
        w = self.w
        m = _norm(_conv_const(v[:w], self.n0inv_limbs, w), w)
        s = v.new_zeros((max(v.shape[0], 2 * w), v.shape[1]))
        s[: v.shape[0]] += v
        s[: 2 * w - 1] += _conv_const(m, self.p_limbs, 2 * w - 1)
        return _norm(s, s.shape[0] + 1)[w:]

    # ---- elementwise maps: the mont_map kernels on the card ------------------------
    # Each op runs csrc/mont_map.cu on a CUDA tensor (or raises) and its plain
    # version (ops/mont_map.py) on a CPU tensor; the *_plain methods run the
    # plain version on any device: the other kernels' plain versions call
    # only those, so none of them launches a kernel.

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_addsub_map

        return mont_addsub_map(self.spec, a, b, op="add")

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_addsub_map

        return mont_addsub_map(self.spec, a, b, op="sub")

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_addsub_map

        return mont_addsub_map(self.spec, a, op="neg")

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b*R^{-1} mod p (inputs/outputs Montgomery form)."""
        from .mont_map import mont_mul_map

        return mont_mul_map(self.spec, a, b, op="mul")

    def mul_const(self, a: torch.Tensor, c_limbs: np.ndarray) -> torch.Tensor:
        """Multiply by a host-constant element (already in Montgomery form)."""
        return self.mul(a, self._const(a, c_limbs))

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Canonical (or any value < 2^(16W)) -> Montgomery form, reduced."""
        from .mont_map import mont_mul_map

        return mont_mul_map(self.spec, x, op="to_mont")

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery form (any value < 2^(16W)) -> canonical value limbs."""
        from .mont_map import mont_mul_map

        return mont_mul_map(self.spec, x, op="from_mont")

    def canon_words(self, x: torch.Tensor) -> torch.Tensor:
        """(W, R, C) Montgomery limbs -> (R*W/2, C) canonical hash words:
        pack_row_words(from_mont(x)), one launch on the card."""
        from .mont_map import mont_mul_map

        return mont_mul_map(self.spec, x, op="from_mont", out_form="hash")

    def add_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_addsub_map_plain

        return mont_addsub_map_plain(self.spec, a, b, op="add")

    def sub_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_addsub_map_plain

        return mont_addsub_map_plain(self.spec, a, b, op="sub")

    def neg_plain(self, a: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_addsub_map_plain

        return mont_addsub_map_plain(self.spec, a, op="neg")

    def mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_mul_map_plain

        return mont_mul_map_plain(self.spec, a, b, op="mul")

    def mul_const_plain(self, a: torch.Tensor, c_limbs: np.ndarray) -> torch.Tensor:
        return self.mul_plain(a, self._const(a, c_limbs))

    def to_mont_plain(self, x: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_mul_map_plain

        return mont_mul_map_plain(self.spec, x, op="to_mont")

    def from_mont_plain(self, x: torch.Tensor) -> torch.Tensor:
        from .mont_map import mont_mul_map_plain

        return mont_mul_map_plain(self.spec, x, op="from_mont")

    def _const(self, a: torch.Tensor, c_limbs: np.ndarray) -> torch.Tensor:
        """A host constant's limbs as a (W, 1, ...) tensor broadcasting over a."""
        c = torch.as_tensor(np.asarray(c_limbs, dtype=np.int32), device=a.device)
        return c.reshape(self.w, *([1] * (a.dim() - 1)))

    # ---- reductions --------------------------------------------------------------

    def sum(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Modular sum over batch `axis` (>= 1) via a binary tree of adds."""
        assert axis >= 1, "axis 0 is the limb axis"
        x = torch.movedim(x, axis, 1)
        n = x.shape[1]
        while n > 1:
            half = n // 2
            lo = self.add(x[:, :half], x[:, half : 2 * half])
            x = lo if n % 2 == 0 else torch.cat([lo, x[:, 2 * half :]], dim=1)
            n = (n + 1) // 2
        return x[:, 0]

    def dot_mont(self, a: torch.Tensor, b: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Sum_k a_k * b_k over batch `axis` (both in Montgomery form)."""
        return self.sum(self.mul(a, b), axis=axis)

    def mul_sum_mont(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Sum_k a[k]*b[k] of Montgomery operands with ONE deferred reduction.

        a, b: (K, W, ...batch) Montgomery limbs -> (W, ...batch) Montgomery.
        The limb products accumulate over K as exact int64 column sums
        (< 2^32 * W * K), and the Montgomery reduction runs once per output.
        This is the plain form of the expander SpMV (ops/spmv.py)."""
        a, b = torch.broadcast_tensors(a, b)
        k, w = a.shape[0], self.w
        assert a.shape[1] == w
        batch = a.shape[2:]
        a = a.reshape(k, w, -1).to(torch.int64)
        b = b.reshape(k, w, -1).to(torch.int64)
        max_mult = max(2, (k * self.spec.p) // self.spec.R + 3)
        step = max(1, (1 << 26) // (k * w))  # bounds the (K, W, step) product

        def f(x, y):
            cols = x.new_zeros((2 * w - 1, x.shape[2]))
            for i in range(w):
                cols[i : i + w] += (x[:, i : i + 1] * y).sum(dim=0)
            v = _norm(cols, 2 * w + 1)  # < K p^2
            return self._cond_sub_chain(self._redc(v), max_mult)

        outs = [f(a[:, :, s : s + step], b[:, :, s : s + step])
                for s in range(0, a.shape[2], step)]
        return self._out(torch.cat(outs, dim=1), batch)

    def _collapse_cols(self, ts: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
        """Exact product columns (2W-1, T, C) int64 of Σ_r ts[:, t, r] mat[:, r, c].

        One float64 matmul per R-slice over (t, i) x (j, c): every limb
        product is < 2^32 and a slice sums at most 2^20 of them, so each
        float64 partial sum is an integer below 2^53 and exact."""
        w = self.w
        T, R = ts.shape[1], ts.shape[2]
        C = mat.shape[2]
        A = ts.permute(1, 0, 2).reshape(T * w, R).to(torch.float64)
        B = mat.permute(1, 0, 2).reshape(R, w * C).to(torch.float64)
        cols = torch.zeros((2 * w - 1, T, C), dtype=torch.int64, device=ts.device)
        for r0 in range(0, R, _MATMUL_R):
            P = (A[:, r0 : r0 + _MATMUL_R] @ B[r0 : r0 + _MATMUL_R])
            P = P.to(torch.int64).reshape(T, w, w, C)  # (t, i, j, c)
            for i in range(w):
                cols[i : i + w] += P[:, i].permute(1, 0, 2)
        return cols

    def collapse_canon_plain(self, ts: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
        """Batched field dot products with a single deferred reduction.

        ts: (W, T, R) and mat: (W, R, C), both Montgomery 16-bit limbs.
        Returns (W, T, C) **canonical** limbs of sum_r ts[t,r] * mat[r,c]:
        the exact sum Σab (< R p^2) is Montgomery-reduced twice, which takes
        the double-Montgomery value (Σab·R² mod p) straight to canonical.
        The plain version of the mont_dot kernel (ops/mont_dot.py), on any
        device."""
        w = self.w
        T, C = ts.shape[1], mat.shape[2]
        # slice C so the (T, W, W, c) float64 product block stays ~512 MB
        step = max(1, (1 << 26) // (T * w * w))
        outs = []
        for c0 in range(0, C, step):
            cols = self._collapse_cols(ts, mat[:, :, c0 : c0 + step])
            v = _norm(cols.reshape(2 * w - 1, -1), 2 * w + 2)
            v = self._redc(self._redc(v))
            outs.append(self._cond_sub_p(v).reshape(w, T, -1))
        return torch.cat(outs, dim=2).to(torch.int32)

    def collapse_canon(self, ts: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
        """collapse_canon_plain's result; CUDA tensors go through the
        mont_dot kernel (csrc/mont_dot.cu), CPU tensors through the plain
        version."""
        if ts.device.type == "cuda" or mat.device.type == "cuda":
            from .mont_dot import mont_dot
            from .spmv import unpack_words

            return unpack_words(mont_dot(self.spec, ts, mat, x_form="limbs", y_form="limbs"), 0)
        return self.collapse_canon_plain(ts, mat)

    def collapse_words(self, ts: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
        """collapse_canon packed as wire words: (T, C, W/2) int64 (u32 values).

        Row-major per (t, c): words[t, c] viewed as little-endian u32s is
        exactly the ff to_repr byte string of the canonical value."""
        canon = self.collapse_canon(ts, mat).to(torch.int64)  # (W, T, C)
        words = canon[0::2] | (canon[1::2] << 16)  # (W/2, T, C)
        return words.permute(1, 2, 0)

    # ---- host conversions ----------------------------------------------------

    def encode_host(self, values, to_mont: bool = True) -> np.ndarray:
        """Python ints -> (W, n) uint32 limb array (optionally Montgomery).

        Without to_mont each value must lie in [0, 2^(16W))."""
        conv = self.spec.to_mont if to_mont else int
        raw = b"".join(conv(v).to_bytes(2 * self.w, "little") for v in values)
        return np.frombuffer(raw, dtype="<u2").reshape(-1, self.w).T.astype(np.uint32)

    def encode_repr_words(self, values) -> np.ndarray:
        """Python ints (canonical, < p) -> (n, W/2) u32 LE repr words."""
        nbytes = (self.w // 2) * 4
        buf = b"".join(v.to_bytes(nbytes, "little") for v in values)
        return np.frombuffer(buf, dtype="<u4").reshape(len(values),
                                                       self.w // 2)

    def decode_host(self, arr, from_mont: bool = True) -> list[int]:
        """(W, ...) limb array or tensor -> flat list of Python ints (canonical)."""
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        arr = np.asarray(arr).reshape(self.w, -1)
        spec = self.spec
        out = []
        for i in range(arr.shape[1]):
            m = 0
            for j in range(self.w):
                m |= int(arr[j, i]) << (16 * j)
            out.append(spec.from_mont(m) if from_mont else m)
        return out


@functools.lru_cache(maxsize=None)
def get_ops(spec: FieldSpec) -> FieldOps:
    return FieldOps(spec)


def pack_row_words(canon: torch.Tensor) -> torch.Tensor:
    """(W, R, C) canonical limbs -> (R*W/2, C) LE u32 hash words as int32
    storage, row-major: word r*W/2 + i of column c is limbs 2i | 2i+1 << 16
    of (r, c).  A word with its top bit set is negative as int32 (torch
    shifts the int32 bit pattern); mask with 0xFFFFFFFF to read it."""
    w, r, c = canon.shape
    words = canon[0::2] | (canon[1::2] << 16)  # (W/2, R, C)
    return words.transpose(0, 1).reshape(r * (w // 2), c)


def limbs_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint32 16-bit limb array -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)
