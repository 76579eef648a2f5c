"""Fiat-Shamir substrate: merlin-compatible transcript, rand_chacha-compatible
ChaCha20 RNG, and ff/rand-compatible sampling semantics.

These are deliberately host-side: the transcript is tiny and sequential by
design (lcpc-2d/src/lib.rs:47-49,871,904,1027 uses merlin 2.0), while bulk
ChaCha20 expansion is vectorized with numpy (the FS tensors are a few hundred
elements, far below the threshold where a device kernel would pay off).
"""

from .merlin import Transcript
from .chacha import ChaCha20Rng
from .sampling import field_random_vec, uniform_indices

__all__ = ["Transcript", "ChaCha20Rng", "field_random_vec", "uniform_indices"]
