"""Evaluation-tensor helpers (the caller-side conventions of the reference).

The 2-D scheme evaluates <outer (x) inner, coeffs>:
- univariate p(x): inner = (1, x, ..., x^(n_per_row-1)), outer = (1,
  x^n_per_row, x^(2*n_per_row), ...)  (lcpc-ligero-pc/src/tests.rs:232-240);
- multilinear in v variables (monomial basis, 2^v coefficients row-major):
  inner/outer are tensor products of (1, x_i) over the low/high variables
  (tests.rs:228-231 note; new_ml dims guarantee power-of-two tiling).
"""

from __future__ import annotations

import numpy as np

from ..fields.spec import FieldSpec


def univariate_tensors(spec: FieldSpec, x: int, n_per_row: int, n_rows: int):
    inner = [pow(x, i, spec.p) for i in range(n_per_row)]
    xr = (x * inner[-1]) % spec.p
    outer = [pow(xr, i, spec.p) for i in range(n_rows)]
    return outer, inner


def _monomial_tensor(spec: FieldSpec, point: list[int]) -> list[int]:
    out = [1]
    for x in point:
        out = out + [(v * x) % spec.p for v in out]
    return out


def multilinear_tensors(spec: FieldSpec, point: list[int], n_per_row: int, n_rows: int):
    """Monomial-basis multilinear evaluation tensors.

    point = (x_0, ..., x_{v-1}) with x_0 the fastest-varying (lowest) bit of
    the coefficient index; requires n_per_row and n_rows powers of two with
    n_per_row * n_rows == 2^v."""
    v = len(point)
    if n_per_row * n_rows != 1 << v or n_per_row & (n_per_row - 1):
        raise ValueError(f"multilinear_tensors: {n_rows} x {n_per_row} is not a power-of-two "
                         f"tiling of 2^{v}")
    k = n_per_row.bit_length() - 1
    return _monomial_tensor(spec, point[k:]), _monomial_tensor(spec, point[:k])


def multilinear_eval(spec: FieldSpec, coeffs: list[int], point: list[int]) -> int:
    t = _monomial_tensor(spec, point)
    if len(t) < len(coeffs):
        raise ValueError(f"multilinear_eval: {len(coeffs)} coefficients, 2^{len(point)} "
                         "monomials")
    return sum(c * v for c, v in zip(coeffs, t)) % spec.p


def seeded_values(p: int, w16: int, n: int, seed: int) -> list[int]:
    """n field values from numpy's default_rng(seed): each row of w16 random
    16-bit LE limbs, reduced mod p (the golden fixture's input recipe)."""
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, size=(n, w16))
    return [int.from_bytes(r.astype("<u2").tobytes(), "little") % p for r in limbs]


def univariate_eval(spec: FieldSpec, coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % spec.p
    return acc
