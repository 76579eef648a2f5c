"""Distributed NTT: one row's transform sharded across the ranks (port of
lcpc_tpu/parallel/dist_ntt.py).

The 4-step decomposition n = A*B with the B axis sharded (SURVEY.md §2.2,
"intra-row NTT sharding"), every step on the port's kernels:

  phase 1: a local DFT_A along the unsharded A axis (each rank owns all of
           A for its jB slice): ntt_forward at n = A;
  twiddle: the rank's slice of the (A, B) table, mont_mul_map;
  reshard: one all_to_all from jB-sharded to kA-sharded (parallel/comm.py);
  phase 2: a local DFT_B along the now-unsharded B axis: ntt_forward at
           n = B.

The output is in fft_io order (out[rev(k)] = X_k), A-sharded: rank r holds
the contiguous columns [r n/world, (r+1) n/world) of the flat transform.
The transposes around the local NTTs are plain copies (lcpc_tpu's
moveaxis); the limb arithmetic stays in kernels.  The twiddle table is
built on the rank's device by mont_powers (powers by doubling through
mont_mul_map) in place of lcpc_tpu's triple Python loop.
"""

from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from ..ops.mont_map import mont_mul_map
from ..ops.ntt import bit_reverse_indices, get_ntt, mont_powers, ntt_forward
from ..ops.spmv import unpack_words
from ..utils.device import resolve_device
from . import multihost
from .comm import Comm


def wide_split(n: int) -> tuple[int, int]:
    """The A*B factorization of a power-of-two n: A = 2^ceil(log/2)."""
    log = n.bit_length() - 1
    a = 1 << (log // 2 + log % 2)
    return a, n // a


class DistNtt:
    """The size-n forward NTT over the ranks of `mesh` (a 1-D DeviceMesh, a
    ProcessGroup or None for every rank), the B axis sharded; this rank's
    kernels run on `device` (default cuda, raising without a GPU)."""

    def __init__(self, spec: FieldSpec, n: int, mesh=None, device=None):
        if n < 4 or n & (n - 1):
            raise ValueError(f"DistNtt: n must be a power of two >= 4, got {n}")
        self.spec = spec
        self.n = n
        self.comm = Comm(mesh)
        self.device = resolve_device(device)
        world = self.comm.world
        self.a, self.b = wide_split(n)
        if self.a % world or self.b % world:
            raise ValueError(f"DistNtt: A = {self.a} and B = {self.b} must each divide "
                             f"over {world} ranks")
        self.ntt_a = get_ntt(spec, self.a)
        self.ntt_b = get_ntt(spec, self.b)
        # this rank's slice of tw[u, jB] = w_n^(rev_a(u) jB) R, jB in
        # [rank B/world, (rank+1) B/world), transposed to phase 1's output
        # layout: (W, B/world, A) limbs
        w_n = spec.root_for_log_len(n.bit_length() - 1)
        rev_a = bit_reverse_indices(self.a)
        bl = self.b // world
        words = mont_powers(spec, [pow(w_n, int(r), spec.p) for r in rev_a], bl, self.device,
                            offset=self.comm.rank * bl)  # (W/2, A, B/world)
        self.tw = unpack_words(words, 0).transpose(1, 2).contiguous()

    def shard_input(self, x: torch.Tensor) -> torch.Tensor:
        """(W, rows, n) host-replicated limbs -> this rank's (W, rows, A,
        B/world) slice on its device."""
        w, rows, n = x.shape
        if n != self.n:
            raise ValueError(f"DistNtt: rows of {n} for a size-{self.n} transform")
        xr = torch.as_tensor(x).reshape(w, rows, self.a, self.b)
        c = self.comm
        return multihost.local_shard(xr, 3, c.rank, c.world).to(self.device, torch.int32)

    def __call__(self, x: torch.Tensor, output: str = "limbs") -> torch.Tensor:
        """x: this rank's (W, rows, A, B/world) Montgomery limbs.  Returns
        its (W, rows, A/world, B) slice of the transform (reshape to
        (W, rows, n/world) for the flat fft_io columns), or with
        output="words" those columns' canonical hash words, (rows*W/2,
        n/world) int32, the same words as ntt_forward(..., output="words")
        gives for these columns."""
        if output not in ("limbs", "words"):
            raise ValueError(f"DistNtt: output must be limbs or words, got {output!r}")
        c, w32 = self.comm, self.spec.w16 // 2
        w, rows, a, bl = x.shape
        al = a // c.world
        # phase 1: DFT_A of every (row, jB), then the twiddles
        y = ntt_forward(self.ntt_a, x.transpose(2, 3).reshape(w, rows * bl, a))
        y = mont_mul_map(self.spec, y.reshape(w, rows, bl, a), self.tw[:, None])
        # reshard: chunk j (rank j's A slice) out, rank i's jB slice in
        chunks = y.reshape(w, rows, bl, c.world, al).permute(3, 0, 1, 2, 4)
        got = c.exchange(chunks)  # (world, W, rows, B/world, A/world)
        z = got.permute(1, 2, 4, 0, 3).reshape(w, rows * al, self.b)
        # phase 2: DFT_B along the now-local B axis
        if output == "limbs":
            return ntt_forward(self.ntt_b, z).reshape(w, rows, al, self.b)
        words = ntt_forward(self.ntt_b, z, output="words")  # (rows*al*W/2, B)
        return (words.reshape(rows, al, w32, self.b).transpose(1, 2)
                .reshape(rows * w32, al * self.b))
