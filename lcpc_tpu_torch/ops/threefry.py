"""The seeded coefficient generator: JAX's threefry2x32 bits, reproduced.

SeededCoeffSource (core/coeffs.py) makes coefficient i from its seed alone,
exactly as lcpc_tpu's SeededCoeffSource does (lcpc_tpu/core/coeffs.py:
143-267, under JAX's default jax_threefry_partitionable):

    key        = prng_key(seed)
    key_c      = fold_in(key, c)                 chunk c = i // chunk
    digit d    = low8(x0 ^ x1) of threefry2x32(key_c, (0, d * chunk + j)) & mask[d]
    value      = sum_d digit_d 2^(7 d)           read as the Montgomery form

with j = i % chunk, mask[d] = 0x7F except the top digit's, which keeps the
value below 2^(num_bits - 1) < p, and coefficients at or past the source's
length zero.  Chunk c is a pure function of (seed, c), so any block
partitioning sees the same values.

- `threefry2x32_plain`, `fold_in`, `prng_key`: the generator on int64
  tensors holding u32 values (Python ints for keys).
- `seeded_digits_plain(key, c0, n_chunks, chunk, w7, mask)`: whole chunks
  as (W7, n_chunks * chunk) uint8 digit planes, the plain version of the
  kernel and the reference of every test.
- `seeded_digits(spec, key, i0, i1, length, chunk, form=, device=)`: the
  wrapper.  On a CUDA device it launches the kernel of csrc/seeded_gen.cu
  (counted in seeded_digits.launches) or raises; on the CPU it runs the
  plain version.  `form` is "digits" ((W7, n) uint8), "limbs" ((W, n)
  int32 16-bit limbs) or "packed" ((W/2, n) int32 words).
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from . import launch_count

_NAME = "seeded_gen"
_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
FORMS = ("digits", "limbs", "packed")


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32_plain(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (jax._src.prng.threefry_2x32): keys are
    u32 ints or int64 tensors, counts int64 tensors of u32 values; returns
    the two output words, int64 tensors of u32 values."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed) as lcpc_tpu makes it: JAX with 64-bit types
    off (its default, which lcpc_tpu keeps) takes the seed as a 32-bit
    integer, so the key is (0, seed mod 2^32)."""
    return 0, seed & _MASK


def fold_in(key: tuple[int, int], c: int) -> tuple[int, int]:
    """jax.random.fold_in(key, c) for c < 2^32: threefry2x32(key, (0, c))."""
    x0, x1 = threefry2x32_plain(key[0], key[1], torch.tensor([0]), torch.tensor([c]))
    return int(x0[0]), int(x1[0])


def digit_masks(spec: FieldSpec) -> list[int]:
    """The W7 digit masks: 0x7F, the top digit's keeping the value below
    2^(num_bits - 1) (lcpc_tpu/core/coeffs.py:160-163)."""
    w7 = (spec.num_bits + 6) // 7
    top_bits = (spec.num_bits - 1) - 7 * (w7 - 1)
    return [0x7F] * (w7 - 1) + [(1 << max(0, top_bits)) - 1]


def seeded_digits_plain(key: tuple[int, int], c0: int, n_chunks: int, chunk: int, w7: int,
                        mask, device="cpu") -> torch.Tensor:
    """Chunks c0 .. c0 + n_chunks - 1 as (W7, n_chunks * chunk) uint8 digit
    planes on `device`: chunk c is jax.random.bits(fold_in(key, c), (W7,
    chunk), uint8) masked by mask[d] (lcpc_tpu/core/coeffs.py: _gen_span_fn)."""
    mask_t = torch.tensor(list(mask), dtype=torch.int64, device=device)[:, None]
    ctr = torch.arange(w7 * chunk, dtype=torch.int64, device=device)
    out = []
    for c in range(c0, c0 + n_chunks):
        f0, f1 = fold_in(key, c)
        x0, x1 = threefry2x32_plain(f0, f1, torch.zeros_like(ctr), ctr)
        out.append(((x0 ^ x1) & 0xFF).reshape(w7, chunk) & mask_t)
    return torch.cat(out, dim=1).to(torch.uint8)


def digits_to_words_plain(d: torch.Tensor, w32: int) -> torch.Tensor:
    """(W7, n) clean 7-bit digits -> (W/2, n) int32 words of sum_d d 2^(7 d):
    the digits' bit fields do not overlap, so the words are their bits
    (lcpc_tpu/ops/mxu_ntt.py: _from7)."""
    d = d.to(torch.int64)
    words = torch.zeros((w32, d.shape[1]), dtype=torch.int64, device=d.device)
    for k in range(d.shape[0]):
        w, s = divmod(7 * k, 32)
        words[w] |= (d[k] << s) & _MASK
        if s > 25 and w + 1 < w32:
            words[w + 1] |= d[k] >> (32 - s)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _bind(lib) -> None:
    u, ll, i, p = ctypes.c_uint, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.lcpc_seeded_gen.argtypes = [u, u, ll, ll, ll, ll, u, i, i, i, p, i, p]
    lib.lcpc_seeded_gen.restype = ctypes.c_int


def seeded_digits(spec: FieldSpec, key: tuple[int, int], i0: int, i1: int, length: int,
                  chunk: int, *, form: str = "digits", device) -> torch.Tensor:
    """Coefficients [i0, i1) of the seeded source with `key` and `chunk`,
    zero at or past `length`, on `device` in `form` (see the module
    docstring).  CUDA launches csrc/seeded_gen.cu once (counted in
    seeded_digits.launches); the CPU takes the plain version."""
    if form not in FORMS:
        raise ValueError(f"seeded_digits: form must be one of {FORMS}, got {form!r}")
    if not 0 <= i0 <= i1:
        raise ValueError(f"seeded_digits: bad range [{i0}, {i1})")
    device = torch.device(device)
    w7 = (spec.num_bits + 6) // 7
    w32 = spec.w16 // 2
    mask = digit_masks(spec)
    n = i1 - i0
    if device.type == "cpu":
        c0 = i0 // chunk
        c1 = max(c0 + 1, -(-i1 // chunk))
        d = seeded_digits_plain(key, c0, c1 - c0, chunk, w7, mask)
        d = d[:, i0 - c0 * chunk : i1 - c0 * chunk]
        if length < i1:  # zero the padding tail
            d = d.clone()
            d[:, max(0, length - i0):] = 0
        if form == "digits":
            return d
        words = digits_to_words_plain(d, w32)
        if form == "packed":
            return words
        from .spmv import unpack_words

        return unpack_words(words, 0)
    if device.type != "cuda":
        raise ValueError(f"seeded_digits: unsupported device {device}")
    rows = {"digits": w7, "limbs": spec.w16, "packed": w32}[form]
    out = torch.empty((rows, n), dtype=torch.uint8 if form == "digits" else torch.int32,
                      device=device)
    if n:
        lib = cuda_build.load(_NAME, _bind)
        err = lib.lcpc_seeded_gen(key[0], key[1], i0, n, length, chunk, mask[-1], w32, w7,
                                  FORMS.index(form), out.data_ptr(), device.index or 0,
                                  torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"seeded_gen launch failed: cudaError_t {err}")
        seeded_digits.launches += 1
    return out


launch_count.counted(seeded_digits)

