"""Evaluation-tensor helpers (the caller-side conventions of the reference).

The 2-D scheme evaluates <outer (x) inner, coeffs>; for a univariate p(x):
inner = (1, x, ..., x^(n_per_row-1)), outer = (1, x^n_per_row,
x^(2*n_per_row), ...)  (lcpc-ligero-pc/src/tests.rs:232-240).
"""

from __future__ import annotations

import numpy as np

from ..fields.spec import FieldSpec


def univariate_tensors(spec: FieldSpec, x: int, n_per_row: int, n_rows: int):
    inner = [pow(x, i, spec.p) for i in range(n_per_row)]
    xr = (x * inner[-1]) % spec.p
    outer = [pow(xr, i, spec.p) for i in range(n_rows)]
    return outer, inner


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
