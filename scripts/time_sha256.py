#!/usr/bin/env python3
"""The SHA-256 kernels alone on the card (csrc/sha256_cols.cu).

    python3 scripts/time_sha256.py [--no-check]

Builds sha256_cols.cu and the probes scripts/sha256_chain.cu, prints ptxas's
registers and spills and the probes' instructions by pipe, holds each kernel
to its plain version at a few small shapes (skipped with --no-check), then
times `sha256_cols` at the slice's column shapes (the 2^23 Ligero commit's
131,072 x 2,048 words, the 2^23 Brakedown commit's 357,699 x 288, the 2^28
length over 4,096 columns; one 1,792-word streaming update), the Merkle tree
at 2^17 and 2^19 leaves and the walk at 189 x 17 and 6,593 x 19, each beside
its bound, and one compression's and one parent's latency.  Imports torch
and the port, nothing of JAX.  About a minute with the builds.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402
from lcpc_tpu_torch.ops import sha256 as sha  # noqa: E402
from lcpc_tpu_torch.utils import cuda_build  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 16.75e12  # each integer pipe, 132 SMs at 1.98 GHz


def step_s(alu, fma):
    return max(alu, fma, (alu + fma) / 2) / INT_OPS_PER_S


def bound_ms(nbytes, steps, per_step_s):
    return max(nbytes / HBM_BYTES_PER_S, steps * per_step_s) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    print(kb.card_line(), torch.__version__, torch.version.cuda, flush=True)
    cuda_build.build("sha256_cols", force=True)
    so, chain_log = kb.build_chain(cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                                   kb.SHA_CHAIN_SRC)
    for log in (cuda_build.build_logs["sha256_cols"], chain_log):
        for name, (regs, st, ld) in kb.ptxas_entries(log, "kernel").items():
            print(f"ptxas {name}: {regs} registers, {st} / {ld} bytes spilled", flush=True)
    mix = kb.sha256_sass_mix(so, cuda_build.so_path("sha256_cols"))
    print(f"SASS by pipe (ALU, FMA, all): compression {mix['compress'][0]}, parent "
          f"{mix['parent'][0]}, the update kernel's block loop {mix['cols_loop']}", flush=True)
    comp_s, parent_s = step_s(*mix["compress"][0][:2]), step_s(*mix["parent"][0][:2])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def words(n, c):
        return torch.randint(-2**31, 2**31, (n, c), generator=gen, device="cuda",
                             dtype=torch.int32)

    def digests(n):
        return torch.randint(0, 2**32, (8, n), generator=gen, device="cuda", dtype=torch.int64)

    def same(tag, got, want):
        if not torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want.to(torch.int64) & 0xFFFFFFFF):
            raise AssertionError(f"{tag}: kernel != plain")

    h0 = digests(1)[:, 0].contiguous()
    lat = {}
    for parent in (False, True):
        lat[parent] = kb.time_kernel(lambda: kb.sha256_chain(so, h0, 4096, parent), reps=3) / 4096
    print(f"latency: a compression {lat[False] * 1e3:.4f} us, a parent {lat[True] * 1e3:.4f} us",
          flush=True)

    if not args.no_check:
        for n, c in ((1, 300), (5, 300), (13, 300), (600, 300), (2048, 4096)):
            w = words(n, c)
            same(f"columns {n} x {c}", sha.hash_word_columns(w), sha.hash_word_columns_plain(w))
        w = words(1792 + 9, 1000)
        cv, carry = sha.h0_state(1000, "cuda"), torch.zeros((16, 1000), dtype=torch.int32,
                                                            device="cuda")
        n = sha.sha256_cols(w[:1792], cv=cv, carry=carry)
        pcv, pcarry, pn = sha.sha256_update_plain(sha.h0_state(1000, "cuda"), None, 8, w[:1792])
        same("update", cv, pcv)
        same("finalize", sha.sha256_cols(w[1792:], cv=cv, carry=carry, carry_len=n,
                                          total_words=1809),
             sha.hash_word_columns_plain(w))
        lv = digests(513)
        same("tree", sha.merkle_tree(lv, 1024), sha.merkle_tree_plain(lv, 1024))
        print("kernels equal to their plain versions", flush=True)

    for n, c in ((2048, 131_072), (288, 357_699), (16_384, 4_096)):
        w = words(n, c)
        ms = kb.time_kernel(lambda: sha.hash_word_columns(w))
        b = bound_ms(4 * n * c + 64 * c, c * ((8 + n + 18) // 16), comp_s)
        print(f"sha256_cols {c} columns x {n} words: {ms:.4f} ms, bound {b:.4f} ms "
              f"({100 * b / ms:.1f}%)", flush=True)
    w = words(1792, 131_072)
    cv = sha.h0_state(131_072, "cuda")
    carry = torch.zeros((16, 131_072), dtype=torch.int32, device="cuda")
    ms = kb.time_kernel(lambda: sha.sha256_cols(w, cv=cv, carry=carry))
    b = bound_ms(4 * 1792 * 131_072 + 192 * 131_072, 131_072 * 112, comp_s)
    print(f"sha256_cols update of 1,792 words x 131,072 columns: {ms:.4f} ms, bound {b:.4f} ms",
          flush=True)
    for n_leaves in (1 << 17, 1 << 19):
        lv = digests(n_leaves)
        ms = kb.time_kernel(lambda: sha.merkle_tree(lv, n_leaves))
        depth = n_leaves.bit_length() - 1
        b = bound_ms(64 * n_leaves + 64 * (2 * n_leaves - 1), n_leaves - 1, parent_s)
        print(f"merkle_tree 2^{depth} leaves: {ms:.4f} ms, bound {b:.4f} ms, floor "
              f"{depth * lat[True]:.4f} ms", flush=True)
    for k, levels in ((189, 17), (6_593, 19)):
        digs, sibs = digests(k), digests(k * levels // 2)
        inv = torch.randint(0, sibs.shape[1], (levels, k), generator=gen, device="cuda")
        idx = torch.randint(0, 1 << levels, (k,), generator=gen, device="cuda")
        ms = kb.time_kernel(lambda: sha.merkle_walk(digs, sibs, inv, idx))
        print(f"merkle_walk {k} x {levels}: {ms:.4f} ms, floor {levels * lat[True]:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
