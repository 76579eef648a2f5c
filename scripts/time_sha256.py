#!/usr/bin/env python3
"""The SHA-256 kernels alone on the card (csrc/sha256_cols.cu, csrc/merkle.cuh).

    python3 scripts/time_sha256.py [--repo DIR] [--label NAME] [--no-check] [--reps N]

Builds the checkout's sha256_cols.cu and blake3_cols.cu and its probe
scripts/sha256_chain.cu, prints ptxas's registers and spills of every
SHA-256 kernel and of both digests' Merkle tree kernels, the probes'
instructions by pipe (one scheduled compression, one parent, the column
kernels' block loops, the trees' and the walk's hottest blocks), one
compression's and one parent's latency (the walk's, and the tree's where
the probe has it apart) and, where the probe has them, the latency of a
dependent IADD3, LOP3, SHF and IMAD and one warp's issue of each (the
card's, not the code's), then:
  - checks (skipped with --no-check): sha256_cols by each kernel the
    checkout has against the plain version at 1, 31, 32, 33 and 189 columns
    of 1 .. 600 words, the kernels against each other at verify's shapes
    and at the route's crossover, streaming updates and a finalize, and both
    digests' trees against their plain versions at small sizes;
  - times (device ms, CUDA events over back-to-back launches), each beside
    its operations bound (the probe's SASS), and the few-column shapes also
    beside their critical-path bound (the round loop's longest dependent
    chain in the SASS at the op chains' latencies x 64 x a column's
    compressions; the trees and walks by a parent's) and their one-warp issue bound
    (two clocks an ALU instruction): sha256_cols at verify's shapes (189 x
    2,048, 189 x 16,384, 6,593 x 288) by each kernel, the wide shapes
    (131,072 x 2,048; 357,699 x 288; 524,288 x 16,384; the 2^28 path's
    1,792-word update over 524,288 columns), a sweep of both kernels over
    1,024 .. 131,072 columns of 288 and 2,048 words (the crossover in
    ops/sha256.FEW_COLS_MAX); BLAKE3's chunk kernel (blake3_chunks, which
    shares csrc/blake3.cuh with the small commit) at the same verify and
    wide shapes; both digests' Merkle trees at 2^17, 2^19 and
    357,699 -> 2^19 leaves and at 2^8 .. 2^12; the SHA-256 walks at 189 x
    17 and 6,593 x 19.
With --repo, the checkout in DIR (an older commit unpacked into the
gitignored archive/) is built and timed instead, as far as it has each
piece: run parent, change, change, parent in one call.  Prints one JSON line
last and writes chiprun_out/time_sha256[_LABEL].json.  Imports torch and the
checkout's lcpc_tpu_torch, nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 16.75e12  # each integer pipe, 132 SMs at 1.98 GHz
VERIFY_SHAPES = ((2_048, 189), (16_384, 189), (288, 6_593))  # words x columns
WIDE_SHAPES = ((2_048, 131_072), (288, 357_699), (16_384, 524_288))
UPDATE = (1_792, 524_288)  # the 2^28 path's row-block update
SWEEP_COLS = (1_024, 4_096, 8_192, 10_240, 12_288, 14_336, 16_384, 20_480, 24_576, 32_768,
              65_536, 131_072)
SWEEP_WORDS = (288, 2_048)
TREES = ((1 << 17, 1 << 17), (1 << 19, 1 << 19), (357_699, 1 << 19))
SMALL_TREES = tuple(1 << k for k in range(8, 13))  # one block's subtree and a few of them
WALKS = ((189, 17), (6_593, 19))
CHAIN = 4096


def step_s(alu, fma):
    """One step's time on the card's integer pipes: the larger of its ALU
    and FMA instructions over 16.75e12/s and both over the issue rate."""
    return max(alu, fma, (alu + fma) / 2) / INT_OPS_PER_S


def bound_ms(nbytes, steps, per_step_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, steps * per_step_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cols_cost(n_words, n_cols, finish=True):
    """(bytes, compressions) of sha256_cols: each word read once, an
    update's state read and written, a finish's (8, C) int64 digests
    written; a compression a 64-byte block of the stream (the 8-word prefix
    and a finish's padding included)."""
    stream = 8 + n_words
    blocks = (stream + 3 + 15) // 16 if finish else stream // 16
    state = 32 * n_cols if finish else 4 * 2 * 24 * n_cols
    return 4 * n_words * n_cols + state, blocks * n_cols


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=_ROOT, help="the checkout whose lcpc_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_sha256.py needs a CUDA device")
    repo = os.path.abspath(args.repo)
    sys.path[:0] = [repo]
    import lcpc_tpu_torch as P
    if not P.__file__.startswith(repo):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {repo}")
    from lcpc_tpu_torch.ops import blake3 as b3
    from lcpc_tpu_torch.ops import sha256 as sha
    from lcpc_tpu_torch.utils import cuda_build

    label = args.label or "change"
    card = kb.card_line()
    print(label, card, torch.__version__, torch.version.cuda, repo, flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["sha256_cols", "blake3_cols"], force=True)
    so, chain_log = kb.build_chain(cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                                   os.path.join(repo, "scripts", "sha256_chain.cu"))
    ptxas = {}
    for src, log in (("sha256_cols", cuda_build.build_logs["sha256_cols"]),
                     ("blake3_cols", cuda_build.build_logs["blake3_cols"]),
                     ("sha256_chain", chain_log)):
        for kernel in ("sha256_", "merkle_", "chain_kernel"):
            for name, rec in kb.ptxas_entries(log, kernel).items():
                ptxas[f"{src}:{name}"] = rec
    for name, (regs, st, ld) in sorted(ptxas.items()):
        print(f"{label} ptxas {name}: {regs} registers, {st} / {ld} bytes spilled", flush=True)
    mix = kb.sha256_sass_mix(so, cuda_build.so_path("sha256_cols"))
    comp_s, parent_s = step_s(*mix["compress"][0][:2]), step_s(*mix["parent"][0][:2])
    print(f"{label} SASS by pipe (ALU, FMA, all): compression {mix['compress'][0]}, parent "
          f"{mix['parent'][0]}, the wide kernel's block loop {mix['cols_loop']}, the few-column "
          f"kernel's round loop {mix['few_rounds']}", flush=True)
    print(f"{label} SASS opcodes: compression {mix['compress'][1]}; parent {mix['parent'][1]}",
          flush=True)
    lib_so = cuda_build.so_path("sha256_cols")
    hot = {"tree_block": kb.hot_code(lib_so, "merkle_tree_kernel", loop=False),
           "walk_block": kb.hot_code(lib_so, "walk_kernel", loop=False),
           "blake3_tree_block": kb.hot_code(cuda_build.so_path("blake3_cols"),
                                            "merkle_tree_kernel", loop=False)}
    for name, rec in hot.items():
        print(f"{label} SASS {name}: {rec}", flush=True)
    # the kernels sha256_cols has: both, forced by _route, or (an older
    # checkout) the one it always launches
    routes = (list(sha.COLS_KERNELS) if "_route" in inspect.signature(sha.sha256_cols).parameters
              else [None])
    wide_only = ["wide"] if routes[0] else [None]
    result = {"label": label, "card": card, "repo": repo, "build_s": secs, "ptxas": ptxas,
              "sass": mix, "sass_hot": hot, "routes": routes, "checks": 0, "cols": {}, "sweep": {}, "trees": {},
              "walks": {}, "blake3_chunks": {}}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)

    def words(n, c):
        w = torch.randint(-2**31, 2**31, (n, c), generator=gen, device="cuda",
                          dtype=torch.int32)
        w[0] = -1  # every bit set
        return w

    def digests(n):
        return torch.randint(0, 2**32, (8, n), generator=gen, device="cuda", dtype=torch.int64)

    def hash_by(route, w):
        if route is None:
            return sha.hash_word_columns(w)
        return sha.sha256_cols(w, total_words=8 + w.shape[0], _route=route)

    def same(tag, got, want):
        if not torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want.to(torch.int64) & 0xFFFFFFFF):
            raise AssertionError(f"{label} {tag}: kernel != reference")
        result["checks"] += 1

    # the latencies: one compression, one parent (the checkout's code), and
    # dependent IADD3 / LOP3 / SHF / IMAD (the card's)
    # the checkout's probe: compressions (mode 0), the walk's parent (1) and,
    # where it has one apart, the tree's compact parent (2)
    h0 = digests(1)[:, 0].contiguous()
    funcs = kb.sass_functions(so)
    modes = (0, 1, 2) if any("parent_chain_kernelILb1E" in k for k in funcs) else (0, 1)
    lat = {m: kb.time_kernel(lambda: kb.sha256_chain(so, h0, CHAIN, m), reps=3) / CHAIN
           for m in modes}
    lat[2] = lat.get(2, lat[1])
    ops = kb.op_latencies(so)
    issue = kb.op_latencies(so, wide=True)
    result.update(compression_latency_us=lat[0] * 1e3, parent_latency_us=lat[1] * 1e3,
                  tree_parent_latency_us=lat[2] * 1e3, op_latency_cycles_ns=ops,
                  op_issue_cycles_ns=issue)
    print(f"{label} latency: a compression {lat[0] * 1e3:.4f} us, a parent {lat[1] * 1e3:.4f} "
          f"us (the walk's), {lat[2] * 1e3:.4f} us (the tree's); dependent ops (cycles, ns): "
          f"{ops}; one warp's issue, eight chains (cycles, ns): {issue}", flush=True)
    crit = None
    if ops is not None:
        # the critical paths as ptxas emitted them: the longest dependent
        # chain through the few-column kernel's round loop, the probe's
        # parent (the walk's) and the compact parent's 16-round trips (the
        # tree's), each instruction at the op chains' latency; and one warp's
        # issue: the round loop's ALU instructions at the probe's clocks an
        # instruction of eight independent chains
        ghz = ops["IADD3"][0] / ops["IADD3"][1]
        chains = kb.sha256_sass_chains(so, lib_so, ops) or {}
        few = chains["few_round"][0] if "few_round" in chains else None
        walk = chains["parent"][0] if "parent" in chains else None
        tree = min(walk, 128 * chains["compact_round"][0]) if "compact_round" in chains else walk
        alu_round = mix["few_rounds"][0] / 64 if mix["few_rounds"] else None
        crit = {"ghz": ghz, "sass_chains": chains, "round_cycles": few,
                "issue_round_cycles": issue["IADD3"][0] * alu_round if alu_round else None,
                "compression_us": 64 * few / ghz / 1e3 if few else None,
                "parent_us": walk / ghz / 1e3 if walk else None,
                "tree_parent_us": tree / ghz / 1e3 if tree else None}
        result["critical_path"] = crit
        print(f"{label} critical paths in the SASS at {ghz:.3f} GHz (cycles; opcodes): "
              + "; ".join(f"{k} {c:.2f} ({o})" for k, (c, o) in chains.items())
              + f"; one warp's issue: {crit['issue_round_cycles']} cycles a round", flush=True)

    if not args.no_check:
        w = words(600, 189)
        for n in (1, 5, 7, 8, 56, 600):
            want = sha.hash_word_columns_plain(w[:n])
            for k in (1, 31, 32, 33, 189):
                for route in routes:
                    same(f"{route} {k} x {n}", hash_by(route, w[:n, :k]), want[:, :k])
        for n, c in VERIFY_SHAPES + tuple((288, sha.FEW_COLS_MAX + d) for d in (0, 1)
                                          if hasattr(sha, "FEW_COLS_MAX")):
            w = words(n, c)
            got = [hash_by(route, w) for route in routes]
            for g in got[1:]:
                same(f"routes {c} x {n}", g, got[0])
        w = words(1_792 + 9, 1_000)
        for route in routes:
            kw = {} if route is None else {"_route": route}
            cv = sha.h0_state(1_000, "cuda")
            carry = torch.zeros((16, 1_000), dtype=torch.int32, device="cuda")
            n = sha.sha256_cols(w[:1_792], cv=cv, carry=carry, **kw)
            n = sha.sha256_cols(w[1_792:1_799], cv=cv, carry=carry, carry_len=n, **kw)
            pcv, pcarry, pn = sha.sha256_update_plain(sha.h0_state(1_000, "cuda"), None, 8,
                                                      w[:1_799])
            same(f"{route} update", cv, pcv)
            same(f"{route} carry", carry[:pn], pcarry[:pn])
            same(f"{route} finalize", sha.sha256_cols(w[1_799:], cv=cv, carry=carry,
                                                      carry_len=n, total_words=1_809, **kw),
                 sha.hash_word_columns_plain(w))
        for mod in (sha, b3):
            for n_leaves, np2 in ((1, 1), (2, 2), (300, 512), (513, 1_024), (5_000, 8_192)):
                lv = digests(n_leaves)
                same(f"{mod.__name__} tree {n_leaves}", mod.merkle_tree(lv, np2),
                     mod.merkle_tree_plain(lv, np2))
        torch.cuda.synchronize()
        print(f"{label} {result['checks']} checks equal", flush=True)

    def few_floor(n_words, rec):
        comps = (8 + n_words + 3 + 15) // 16  # a column's chain
        rec["compressions_a_column"] = comps
        rec["floor_ms"] = comps * lat[0]  # the checkout's scheduled compression
        if crit and crit["compression_us"]:
            rec["critical_path_ms"] = comps * crit["compression_us"] / 1e3
            if crit["issue_round_cycles"]:
                rec["issue_ms"] = comps * 64 * crit["issue_round_cycles"] / crit["ghz"] / 1e6

    for n, c in VERIFY_SHAPES + WIDE_SHAPES:
        w = words(n, c)
        nbytes, comps = cols_cost(n, c)
        b, by = bound_ms(nbytes, comps, comp_s)
        for route in routes if c < 100_000 else wide_only:
            ms = kb.time_kernel(lambda: hash_by(route, w), reps=args.reps)
            rec = {"ms": ms, "bound_ms": b, "bound_by": by, "share": b / ms}
            if c < 100_000:
                few_floor(n, rec)
            result["cols"][f"{route or 'wide'} {c}x{n}"] = rec
            print(f"{label} sha256_cols {route or 'wide'} {c} columns x {n} words: {ms:.4f} ms, "
                  f"bound {b:.4f} ({by}, {b / ms:.1%})"
                  + (f", floor {rec['floor_ms']:.4f}" if "floor_ms" in rec else "")
                  + (f", critical path {rec['critical_path_ms']:.4f}"
                     if "critical_path_ms" in rec else "")
                  + (f", one warp's issue {rec['issue_ms']:.4f}" if "issue_ms" in rec else ""),
                  flush=True)
        del w
    torch.cuda.empty_cache()
    n, c = UPDATE
    w = words(n, c)
    cv = sha.h0_state(c, "cuda")
    carry = torch.zeros((16, c), dtype=torch.int32, device="cuda")
    ms = kb.time_kernel(lambda: sha.sha256_cols(w, cv=cv, carry=carry), reps=args.reps)
    nbytes, comps = cols_cost(n, c, finish=False)
    b, by = bound_ms(nbytes, comps, comp_s)
    result["cols"][f"update {c}x{n}"] = {"ms": ms, "bound_ms": b, "bound_by": by}
    print(f"{label} sha256_cols update {c} columns x {n} words: {ms:.4f} ms, bound {b:.4f} "
          f"({by}, {b / ms:.1%})", flush=True)
    del w, cv, carry
    torch.cuda.empty_cache()

    for n, c in VERIFY_SHAPES + WIDE_SHAPES:
        w = words(n, c)
        n_chunks, final_len = b3._chunking(n)
        cvs = torch.empty((n_chunks, 8, c), dtype=torch.int32, device="cuda")
        ms = kb.time_kernel(lambda: b3.blake3_chunks(w, cvs, final_len=final_len), reps=args.reps)
        result["blake3_chunks"][f"{c}x{n}"] = {"ms": ms}
        print(f"{label} blake3_chunks {c} columns x {n} words: {ms:.4f} ms", flush=True)
        del w, cvs
    torch.cuda.empty_cache()

    for n in SWEEP_WORDS:
        w = words(n, SWEEP_COLS[-1])
        for c in SWEEP_COLS:
            row = {route or "wide": kb.time_kernel(lambda: hash_by(route, w[:, :c]),
                                                   reps=args.reps) for route in routes}
            result["sweep"][f"{c}x{n}"] = row
            print(f"{label} sweep {c} columns x {n} words: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
        del w

    for mod, name in ((sha, "sha256"), (b3, "blake3")):
        for n_leaves, np2 in TREES:
            lv = digests(n_leaves)
            ms = kb.time_kernel(lambda: mod.merkle_tree(lv, np2), reps=args.reps)
            depth = np2.bit_length() - 1
            rec = {"ms": ms, "depth": depth}
            if mod is sha:
                rec["bound_ms"], rec["bound_by"] = bound_ms(64 * n_leaves + 64 * (2 * np2 - 1),
                                                            np2 - 1, parent_s)
                rec["floor_ms"] = depth * min(lat[1], lat[2])  # the fastest parent
                rec["floor_ms_compact_parent"] = depth * lat[2]
                if crit and crit["tree_parent_us"]:
                    rec["critical_path_ms"] = depth * crit["tree_parent_us"] / 1e3
            result["trees"][f"{name} {n_leaves}"] = rec
            print(f"{label} {name} merkle_tree {n_leaves} -> 2^{depth}: {ms:.4f} ms"
                  + (f", bound {rec['bound_ms']:.4f} ({rec['bound_by']}), floor "
                     f"{rec['floor_ms']:.4f}" if "bound_ms" in rec else ""), flush=True)
    for mod, name in ((sha, "sha256"), (b3, "blake3")):
        for np2 in SMALL_TREES:
            lv = digests(np2)
            ms = kb.time_kernel(lambda: mod.merkle_tree(lv, np2), reps=args.reps)
            result["trees"][f"{name} {np2}"] = {"ms": ms, "depth": np2.bit_length() - 1}
        print(f"{label} {name} merkle_tree 2^8 .. 2^12: "
              + ", ".join(f"{result['trees'][f'{name} {n}']['ms']:.4f}" for n in SMALL_TREES)
              + " ms", flush=True)
    for k, levels in WALKS:
        digs, sibs = digests(k), digests(max(1, k * levels // 2))
        inv = torch.randint(0, sibs.shape[1], (levels, k), generator=gen, device="cuda")
        idx = torch.randint(0, 1 << levels, (k,), generator=gen, device="cuda")
        ms = kb.time_kernel(lambda: sha.merkle_walk(digs, sibs, inv, idx), reps=args.reps)
        rec = {"ms": ms, "floor_ms": levels * lat[1]}
        if crit and crit["parent_us"]:
            rec["critical_path_ms"] = levels * crit["parent_us"] / 1e3
        if crit and crit["compression_us"] and crit["issue_round_cycles"]:
            # the walk of a round warp fed W + K: two compressions of
            # the few-column kernel's round a level, its chain and one warp's
            # issue of its ALU instructions
            rec["critical_path_rounds_ms"] = levels * 2 * crit["compression_us"] / 1e3
            rec["issue_rounds_ms"] = levels * 128 * crit["issue_round_cycles"] / crit["ghz"] / 1e6
        result["walks"][f"{k}x{levels}"] = rec
        print(f"{label} sha256 merkle_walk {k} x {levels}: {ms:.4f} ms, floor "
              f"{rec['floor_ms']:.4f} (depth x a lone thread's parent), critical path "
              f"{rec.get('critical_path_ms', 0):.4f} (the unrolled parent's SASS chain), "
              f"{rec.get('critical_path_rounds_ms', 0):.4f} (128 rounds of the few-column "
              f"round's chain), one warp's issue of those rounds "
              f"{rec.get('issue_rounds_ms', 0):.4f}", flush=True)
    result["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    out = os.path.join(_ROOT, "chiprun_out",
                       "time_sha256.json" if not args.label else f"time_sha256_{label}.json")
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
