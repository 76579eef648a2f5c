"""Brakedown / SDIG expander-code encoding (torch port).

Reimplements lcpc-brakedown-pc, as lcpc_tpu/encodings/brakedown.py does:
- `codespec.rs:17-232`: code parameter sets (alpha, beta, r as exact
  rationals) and the entropy-formula density constants;
- `matgen.rs:23-188`: deterministic seeded generation of the per-level sparse
  code matrices (ChaCha20 per-level streams, Lemire column sampling with
  rejection, nonzero values in sorted-column order) — the verifier
  regenerates identical matrices from the seed, so they never ride the wire;
- `encode.rs:18-110`: iterative recursive systematic encode over one flat
  buffer (precode SpMVs down, Vandermonde Reed-Solomon base case, postcode
  SpMVs up).

The host side (code dims, matrix generation, host twin) is a copy of the
reference's, float operation order included.  Device side: every commit row
is encoded at once in the packed codeword layout (n_cols, R, W32), and each
level — a ragged CSR, the Reed-Solomon base case included as a full level
with cols k = 0..n_in-1 in every row — is one call of ops/spmv.spmv_mont,
which launches the CUDA kernel on the GPU for every row count R (commit and
verify alike).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.encoding import LcEncoding
from ..core.soundness import n_degree_tests
from ..fields.spec import FieldSpec
from ..fs.chacha import ChaCha20Rng
from ..fs.sampling import UniformUsize, field_random_nonzero_raw
from ..ops.limbs import get_ops
from ..ops.spmv import RaggedCsr, pack_words, spmv_mont, unpack_words
from ..utils.device import resolve_device

LAMBDA = 128


def _ent(z: float) -> float:
    assert 0.0 < z < 1.0
    mzp1 = 1.0 - z
    return -z * math.log2(z) - mzp1 * math.log2(mzp1)


def _ceil_muldiv(n: int, num: int, den: int) -> int:
    return (n * num + den - 1) // den


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """SDIG code parameters as exact rationals (codespec.rs:24-129)."""

    name: str
    an: int
    ad: int
    bn: int
    bd: int
    rn: int
    rd: int
    baselen: int

    def dist(self) -> float:
        return (self.bn * self.rd) / (self.bd * self.rn)

    def alpha(self) -> float:
        return self.an / self.ad

    def beta(self) -> float:
        return self.bn / self.bd

    def r(self) -> float:
        return self.rn / self.rd

    def mu(self) -> float:
        return self.r() - 1.0 - self.r() * self.alpha()

    def nu(self) -> float:
        return self.beta() + self.alpha() * self.beta() + 0.03

    def cnst_cn_1(self) -> float:
        return _ent(self.beta()) + self.alpha() * _ent(
            1.28 * self.beta() / self.alpha()
        )

    def cnst_cn_2(self) -> float:
        return self.beta() * math.log2(self.alpha() / (1.28 * self.beta()))

    def cnst_dn_1(self) -> float:
        return self.r() * self.alpha() * _ent(self.beta() / self.r()) + self.mu() * _ent(
            self.nu() / self.mu()
        )

    def cnst_dn_2(self) -> float:
        return self.alpha() * self.beta() * math.log2(self.mu() / self.nu())


# the six parameter rows (codespec.rs:169-232)
CODE1 = CodeSpec("code1", 239, 2000, 71, 2500, 71, 50, 20)
CODE2 = CodeSpec("code2", 69, 500, 111, 2500, 147, 100, 20)
CODE3 = CodeSpec("code3", 89, 500, 61, 1000, 1521, 1000, 20)
CODE4 = CodeSpec("code4", 1, 5, 41, 500, 41, 25, 20)
CODE5 = CodeSpec("code5", 211, 1000, 97, 1000, 202, 125, 20)
CODE6 = CodeSpec("code6", 119, 500, 241, 2000, 43, 25, 20)
ALL_CODES = (CODE1, CODE2, CODE3, CODE4, CODE5, CODE6)


def get_code_dims(code: CodeSpec, n: int, log2p: float):
    """Dimension ladder + densities (matgen.rs:56-111).

    Returns (pre_dims, post_dims): lists of (n_i, m_i, cn) / (n'_i, m'_i, dn).
    """
    baselen = code.baselen
    assert n > baselen
    ladder = [n]
    while ladder[-1] > baselen:
        ladder.append(_ceil_muldiv(ladder[-1], code.an, code.ad))
    assert len(ladder) > 1
    # the Rust take_while keeps entries > baselen, then pushes one more
    keep = [x for x in ladder if x > baselen]
    last = _ceil_muldiv(keep[-1], code.an, code.ad)
    assert last <= baselen
    keep.append(last)

    pre_dims = []
    for ni, mi in zip(keep, keep[1:]):
        cn = min(
            max(
                _ceil_muldiv(ni, 32 * code.bn, 25 * code.bd),
                4 + _ceil_muldiv(ni, code.bn, code.bd),
            ),
            math.ceil((110.0 / ni + code.cnst_cn_1()) / code.cnst_cn_2()),
        )
        cn = min(cn, mi)
        pre_dims.append((ni, mi, cn))

    post_dims = []
    for ni, mi, _ in pre_dims:
        niprime = _ceil_muldiv(mi, code.rn, code.rd)
        miprime = _ceil_muldiv(ni, code.rn, code.rd) - ni - niprime
        tmp1 = _ceil_muldiv(ni, 2 * code.bn, code.bd)
        tmp2 = _ceil_muldiv(ni, code.rn, code.rd) - ni + 110
        dn = min(
            tmp1 + math.ceil(tmp2 / log2p),
            math.ceil((110.0 / ni + code.cnst_dn_1()) / code.cnst_dn_2()),
        )
        dn = min(dn, miprime)
        post_dims.append((niprime, miprime, dn))

    return pre_dims, post_dims


@dataclasses.dataclass
class SparseMat:
    """CSC sparse matrix over the field, mapping R^n_in -> R^n_out.

    Matches the sprs CsMat built by gen_code (matgen.rs:114-188): column j of
    the CSC holds the entries sampled for generated row j.  Values are held
    in Montgomery form as u64 limb rows (exactly the accepted ff
    Field::random draws — see fs/sampling.field_random_raw); the canonical
    int list materializes lazily (it needs a bigint mulmod per nonzero and
    only the host reference twin wants it).
    """

    spec: FieldSpec
    n_out: int  # rows (m in gen_code's CSC shape)
    n_in: int   # cols (n)
    col_ptr: np.ndarray   # (n_in+1,) int64
    row_idx: np.ndarray   # (nnz,) int64, sorted within each column
    vals_mont: np.ndarray  # (nnz, limbs64) uint64 Montgomery limbs
    _vals: "list[int] | None" = None

    @property
    def vals(self) -> list[int]:
        """Canonical field values, aligned with row_idx."""
        if self._vals is None:
            rinv, p = self.spec.Rinv, self.spec.p
            flat = np.ascontiguousarray(self.vals_mont)
            self._vals = [
                (int.from_bytes(flat[i].tobytes(), "little") * rinv) % p
                for i in range(flat.shape[0])
            ]
        return self._vals

    def apply_host(self, x: list[int], p: int) -> list[int]:
        assert len(x) == self.n_in
        y = [0] * self.n_out
        vals = self.vals
        for j in range(self.n_in):
            xj = x[j]
            if xj == 0:
                continue
            for k in range(self.col_ptr[j], self.col_ptr[j + 1]):
                y[self.row_idx[k]] = (y[self.row_idx[k]] + vals[k] * xj) % p
        return y


def gen_code(spec: FieldSpec, n: int, m: int, d: int, rng: ChaCha20Rng) -> SparseMat:
    """One code matrix: n generated rows over m columns, d distinct nonzeros
    per row (matgen.rs:114-188).  RNG consumption matches Rust exactly.
    Pure-Python twin of the native path (lcpc_gen_code in lcpc_native.c)."""
    dist = UniformUsize(m)
    row_idx: list[int] = []
    vals_mont = np.empty((n * d, spec.limbs64), dtype=np.uint64)
    for i in range(n):
        cols: list[int] = []
        while len(cols) < d:
            x = dist.sample(rng)
            if x not in cols:
                cols.append(x)
        cols.sort()
        for k, c in enumerate(cols):
            raw = field_random_nonzero_raw(spec, rng)
            row_idx.append(c)
            for l in range(spec.limbs64):
                vals_mont[i * d + k, l] = (raw >> (64 * l)) & 0xFFFFFFFFFFFFFFFF
    return SparseMat(
        spec=spec,
        n_out=m,
        n_in=n,
        col_ptr=np.arange(n + 1, dtype=np.int64) * d,
        row_idx=np.asarray(row_idx, dtype=np.int64),
        vals_mont=vals_mont,
    )


def gen_code_native(lib, rng_state, spec: FieldSpec, n: int, m: int,
                    d: int) -> SparseMat:
    """Native (C) gen_code: same stream consumption, ~1000x the Python twin.
    `rng_state` is an lcpc_rng_t buffer advanced in place across calls."""
    import ctypes

    assert d <= 64
    cols = np.empty(n * d, dtype=np.int64)
    vals = np.empty((n * d, spec.limbs64), dtype=np.uint64)
    p_limbs = np.array(
        [(spec.p >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(spec.limbs64)],
        dtype=np.uint64,
    )
    top_mask = (1 << 64) - 1 >> spec.shave_bits
    lib.lcpc_gen_code(
        rng_state, n, m, d, p_limbs.ctypes.data, spec.limbs64,
        ctypes.c_uint64(top_mask), cols.ctypes.data, vals.ctypes.data,
    )
    return SparseMat(
        spec=spec,
        n_out=m,
        n_in=n,
        col_ptr=np.arange(n + 1, dtype=np.int64) * d,
        row_idx=cols,
        vals_mont=vals,
    )


def generate(spec: FieldSpec, code: CodeSpec, n: int, seed: int):
    """Seeded generation of all levels (matgen.rs:28-52).

    Level i draws from ChaCha20Rng::seed_from_u64(seed) with stream i;
    precode first, then postcode from the same stream.  Uses the native C
    sampler when available (the Python twin costs minutes at 2^21 sizes —
    the reference's matgen is parallel native Rust); stream consumption is
    identical either way (twin-tested in tests/test_brakedown.py).
    """
    from ..utils import native as _native

    pre_dims, post_dims = get_code_dims(code, n, float(spec.flog2))
    lib = _native.get_lib()
    max_d = max(max(cn for _, _, cn in pre_dims),
                max(dn for _, _, dn in post_dims))
    use_native = lib is not None and max_d <= 64
    if use_native:
        import ctypes

        key = np.frombuffer(
            ChaCha20Rng.seed_from_u64(seed).key.tobytes(), dtype=np.uint8
        ).copy()
        precodes = []
        postcodes = []
        for i, ((ni, mi, cn), (nip, mip, dn)) in enumerate(
            zip(pre_dims, post_dims)
        ):
            st = ctypes.create_string_buffer(_native.RNG_STATE_BYTES)
            lib.lcpc_rng_init(st, key.ctypes.data, ctypes.c_uint64(i))
            precodes.append(gen_code_native(lib, st, spec, ni, mi, cn))
            postcodes.append(gen_code_native(lib, st, spec, nip, mip, dn))
        return precodes, postcodes

    precodes = []
    postcodes = []
    for i, ((ni, mi, cn), (nip, mip, dn)) in enumerate(zip(pre_dims, post_dims)):
        rng = ChaCha20Rng.seed_from_u64(seed)
        rng.set_stream(i)
        precodes.append(gen_code(spec, ni, mi, cn, rng))
        postcodes.append(gen_code(spec, nip, mip, dn, rng))
    return precodes, postcodes


def codeword_length(precodes, postcodes) -> int:
    """encode.rs:18-33."""
    assert precodes and len(precodes) == len(postcodes)
    return (
        precodes[0].n_in
        + postcodes[-1].n_in
        + sum(pc.n_out for pc in precodes[:-1])
        + sum(pc.n_out for pc in postcodes)
    )


def reed_solomon_host(spec: FieldSpec, xi: list[int], n_out: int) -> list[int]:
    """Vandermonde RS at points 1..n_out via Horner (encode.rs:97-110)."""
    p = spec.p
    out = []
    x = 1
    for _ in range(n_out):
        acc = 0
        for j in range(len(xi) - 1, -1, -1):
            acc = (acc * x + xi[j]) % p
        out.append(acc)
        x += 1
    return out


def encode_host(spec: FieldSpec, xi: list[int], precodes, postcodes) -> list[int]:
    """Slow twin of the iterative expander encode (encode.rs:36-94)."""
    p = spec.p
    buf = list(xi)
    assert len(buf) == codeword_length(precodes, postcodes)

    # forward precode SpMVs
    in_start = 0
    for pc in precodes[:-1]:
        in_end = in_start + pc.n_in
        y = pc.apply_host(buf[in_start:in_end], p)
        buf[in_end : in_end + pc.n_out] = y
        in_start = in_end

    # base case RS
    pc = precodes[-1]
    in_end = in_start + pc.n_in
    tmp = pc.apply_host(buf[in_start:in_end], p)
    rs_len = postcodes[-1].n_in
    buf[in_end : in_end + rs_len] = reed_solomon_host(spec, tmp, rs_len)
    out_start = in_end + rs_len
    in_start = in_end + pc.n_out

    # backward postcode SpMVs
    for pc, qc in zip(reversed(precodes), reversed(postcodes)):
        in_start -= pc.n_out
        y = qc.apply_host(buf[in_start:out_start], p)
        buf[out_start : out_start + qc.n_out] = y
        out_start += qc.n_out

    assert in_start == precodes[0].n_in
    assert out_start == len(buf)
    return buf



# ---------------------------------------------------------------------------
# device path
# ---------------------------------------------------------------------------


def _csr_ragged(mat: SparseMat) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSC -> ragged CSR sorted by output row, each row exactly its nonzeros:
    the kernel's form of lcpc_tpu's padded CSR (_csr_pad,
    lcpc_tpu/encodings/brakedown.py:367).

    Returns (row_ptr (n_out+1,) int32, cols (nnz,) int32 input indices,
    vals (nnz, W32) uint32 packed Montgomery words, low word first).
    """
    nnz = mat.row_idx.shape[0]
    d = nnz // mat.n_in if mat.n_in else 1  # uniform stride-d CSC order
    assert mat.n_in * d == nnz
    order = np.argsort(mat.row_idx, kind="stable")
    row_ptr = np.zeros(mat.n_out + 1, dtype=np.int32)
    np.cumsum(np.bincount(mat.row_idx, minlength=mat.n_out), out=row_ptr[1:])
    cols = (order // d).astype(np.int32)
    words = np.ascontiguousarray(mat.vals_mont).view("<u4").reshape(nnz, -1)
    return row_ptr, cols, words[order]


def _as_i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


class _DeviceMat(RaggedCsr):
    """A level of the code as the kernel's checked ragged CSR on a device."""

    @classmethod
    def from_sparse(cls, mat: SparseMat, device) -> "_DeviceMat":
        row_ptr, cols, vals = _csr_ragged(mat)
        return cls(mat.n_in, _as_i32(row_ptr), _as_i32(cols), _as_i32(vals), device)

    @classmethod
    def vandermonde(cls, spec: FieldSpec, n_in: int, n_out: int,
                    device) -> "_DeviceMat":
        """RS base case as a full ragged level: out[c] = sum_k x[k] * (c+1)^k
        (encode.rs:97-110), i.e. row c holds cols k = 0..n_in-1 with the
        Montgomery powers (c+1)^k."""
        nbytes = 2 * spec.w16
        raw = b"".join(spec.to_mont(pow(c, k, spec.p)).to_bytes(nbytes, "little")
                       for c in range(1, n_out + 1) for k in range(n_in))
        vals = np.frombuffer(raw, dtype="<u4").reshape(n_out * n_in, spec.w16 // 2).copy()
        row_ptr = np.arange(n_out + 1, dtype=np.int32) * n_in
        cols = np.tile(np.arange(n_in, dtype=np.int32), n_out)
        return cls(n_in, _as_i32(row_ptr), _as_i32(cols), _as_i32(vals), device)


class SdigEncoding(LcEncoding):
    """SDIG expander-code encoding (lcpc-brakedown-pc/src/lib.rs:39-176).

    `device=None` places the encode on the GPU and raises without one; pass
    device="cpu" for the plain PyTorch path."""

    def __init__(self, spec: FieldSpec, n_per_row: int, seed: int,
                 code: CodeSpec = CODE3, device=None):
        self.spec = spec
        self.code = code
        self.seed = seed
        self.device = resolve_device(device)
        self.ops = get_ops(spec)
        self.precodes, self.postcodes = generate(spec, code, n_per_row, seed)
        assert n_per_row == self.precodes[0].n_in
        self.n_per_row = n_per_row
        self.n_cols = codeword_length(self.precodes, self.postcodes)
        self._dev = None

    # ---- constructors (lib.rs:69-137) ----------------------------------------

    @classmethod
    def _n_col_opens_static(cls, code: CodeSpec) -> int:
        dist_ov_3 = code.dist() / 3.0
        den = math.log2(1.0 - dist_ov_3)
        return math.ceil(-float(LAMBDA) / den)

    @classmethod
    def _n_degree_tests_static(cls, spec: FieldSpec, n_cols: int) -> int:
        return n_degree_tests(LAMBDA, n_cols, spec.flog2)

    @classmethod
    def _new_from_np1(cls, spec: FieldSpec, length: int, np1: int, seed: int,
                      code: CodeSpec, device=None):
        np1 = length if np1 > length else np1
        n_col_opens = cls._n_col_opens_static(code)
        nr1 = (length + np1 - 1) // np1
        nd1 = cls._n_degree_tests_static(spec, np1 * 2)  # approximately
        assert np1 * nr1 >= length
        assert np1 * (nr1 - 1) < length
        np2 = np1 // 2
        nr2 = (length + np2 - 1) // np2
        nd2 = cls._n_degree_tests_static(spec, np2 * 2)  # approximately
        assert np2 * nr2 >= length
        assert np2 * (nr2 - 1) < length
        sz1 = n_col_opens * nr1 + (1 + nd1) * np1
        sz2 = n_col_opens * nr2 + (1 + nd2) * np2
        n_per_row = np1 if sz1 < sz2 else np2
        return cls(spec, n_per_row, seed, code, device)

    @classmethod
    def new(cls, spec: FieldSpec, length: int, seed: int, code: CodeSpec = CODE3,
            device=None):
        lncf = float(cls._n_col_opens_static(code) * length)
        ndt = float(
            cls._n_degree_tests_static(spec, math.ceil(math.sqrt(lncf)) * 2)
        )
        np1 = math.ceil(math.sqrt(lncf / ndt))
        return cls._new_from_np1(spec, length, np1, seed, code, device)

    @classmethod
    def new_ml(cls, spec: FieldSpec, n_vars: int, seed: int, code: CodeSpec = CODE3,
               device=None):
        n_monomials = 1 << n_vars
        lncf = float(cls._n_col_opens_static(code) * n_monomials)
        ndt = float(
            cls._n_degree_tests_static(spec, math.ceil(math.sqrt(lncf)) * 2)
        )
        base = math.ceil(math.sqrt(lncf / ndt))
        np1 = 1 << (base - 1).bit_length() if base > 1 else 1
        return cls._new_from_np1(spec, n_monomials, np1, seed, code, device)

    # ---- LcEncoding ----------------------------------------------------------

    def get_dims(self, length: int) -> tuple[int, int, int]:
        n_rows = (length + self.n_per_row - 1) // self.n_per_row
        return (n_rows, self.n_per_row, self.n_cols)

    def dims_ok(self, n_per_row: int, n_cols: int) -> bool:
        return (
            n_per_row < n_cols
            and n_per_row == self.n_per_row
            and n_cols == self.n_cols
        )

    def get_n_col_opens(self) -> int:
        return self._n_col_opens_static(self.code)

    def get_n_degree_tests(self) -> int:
        return self._n_degree_tests_static(self.spec, self.n_cols)

    def device_mats(self):
        """(precode levels, postcode levels, RS level) on self.device."""
        if self._dev is None:
            pre = [_DeviceMat.from_sparse(m, self.device) for m in self.precodes]
            post = [_DeviceMat.from_sparse(m, self.device) for m in self.postcodes]
            rs = _DeviceMat.vandermonde(self.spec, self.precodes[-1].n_out,
                                        self.postcodes[-1].n_in, self.device)
            self._dev = (pre, post, rs)
        return self._dev

    def encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(W, R, n_per_row) -> (W, R, n_cols) int32 Montgomery limbs.

        Works in the kernel's packed layout (n_cols, R, W32): codeword
        positions lead and one (position, r) is W32 contiguous 32-bit words,
        so each level's input is a contiguous slice of one buffer
        [x | y_1 .. y_{t-1} | rs | v_t .. v_1] and its output is written in
        place right after the previous one (encode.rs:36-94).  Each of the
        reference's `_apply_mat_device` and `_rs_device` calls is one
        spmv_mont call here.  Rows are packed on entry and unpacked on exit,
        so the reference's limb-major layout holds at the boundary."""
        pre, post, rs = self.device_mats()
        w, r, npr = rows.shape
        if npr != self.n_per_row:
            raise ValueError(f"rows must be (W, R, {self.n_per_row}), got {tuple(rows.shape)}")
        buf = torch.empty((self.n_cols, r, w // 2), dtype=torch.int32, device=rows.device)
        # pack where the limbs lie (coalesced), then move the words
        buf[:npr] = pack_words(rows, 0).permute(2, 1, 0)
        starts = [0]  # segment starts: x, y_1 .. y_{t-1}, rs
        off = npr

        def put(x, dm):
            nonlocal off
            spmv_mont(self.spec, x, dm, out=buf[off : off + dm.n_out])
            off += dm.n_out

        x = buf[:npr]
        for dm in pre[:-1]:
            starts.append(off)
            put(x, dm)
            x = buf[starts[-1] : off]
        # base case: the last precode feeds the Reed-Solomon code
        tmp = spmv_mont(self.spec, x, pre[-1])
        starts.append(off)
        put(tmp, rs)
        # backward pass: postcode i reads the encoded sub-codeword from
        # segment i+1 to the current end
        for i in range(len(post) - 1, -1, -1):
            inp = buf[starts[i + 1] : off]
            assert inp.shape[0] == post[i].n_in, (inp.shape, post[i].n_in)
            put(inp, post[i])
        assert off == self.n_cols
        # move the words limb-major first, then unpack (coalesced)
        return unpack_words(buf.permute(2, 1, 0).contiguous(), 0)

    def encode_row_host(self, row: list[int]) -> list[int]:
        assert len(row) <= self.n_cols
        buf = list(row) + [0] * (self.n_cols - len(row))
        return encode_host(self.spec, buf, self.precodes, self.postcodes)
