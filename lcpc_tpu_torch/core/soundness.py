"""Soundness parameter calculators (lcpc-2d/src/lib.rs:613-616, 827-829)."""

from __future__ import annotations


def ceil_log2(v: int) -> int:
    """Reference `log2`: 63 - leading_zeros(next_power_of_two(v)) (lib.rs:827-829)."""
    assert v >= 1
    npw = 1 << (v - 1).bit_length() if v > 1 else 1
    return npw.bit_length() - 1


def n_degree_tests(lam: int, length: int, flog2: int) -> int:
    """Number of degree tests for lam-bit security (lib.rs:613-616)."""
    den = flog2 - ceil_log2(length)
    return (lam + den - 1) // den
