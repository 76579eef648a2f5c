#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lcpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (each prints the seconds it took):
  1. print the card's name and power limit (nvidia-smi);
  2. build the eight CUDA kernel sources from the checkout, one nvcc each,
     started together (csrc/spmv_mont.cu, csrc/ntt_mont.cu,
     csrc/blake3_cols.cu, csrc/seeded_gen.cu, csrc/mont_dot.cu,
     csrc/power_table.cu, csrc/mont_map.cu, csrc/sha256_cols.cu); print
     ptxas's registers and spills per template (fatal if the SpMV's, the
     NTT's, the generator's, the power table's or either field map's W32 =
     8 spills, any of mont_dot's tensor-core templates (tile and thin_tc)
     spills, or ptxas serializes its wgmmas, or any SHA-256 kernel spills;
     every BLAKE3 kernel reported, the
     per-level blake3_parents gone), what the generator's function needs
     by pipe (its bound: 37 digits of one threefry2x32 and xor from the
     SASS of the probe scripts/threefry_chain.cu, held to the plain
     threefry, plus the digit packing; the kernel's whole SASS logged
     beside), the SASS instruction count of the SpMV's W32 = 8 k loop per
     wide product and one BLAKE3 compression's instructions by pipe
     (cuobjdump; the compression latency probe scripts/blake3_chain.cu is
     built beside the kernels), from which every BLAKE3 bound is counted,
     and one SHA-256 compression's and one Merkle parent's (the probes of
     scripts/sha256_chain.cu), from which every SHA-256 bound is counted;
  3. hold the SpMV kernel against its plain PyTorch version
     (apply_mat_plain), bit for bit, on every level of the 2^23 ft255
     Brakedown encoding at r = 36 (the commit's row count), on every level at
     r = 2 (verify's), and on ragged edge levels (an empty row, a row of K =
     96 all p-1 over inputs all p-1, mixed lengths) in each of the four
     fields (every W32 template) at every lane split; time both against the
     bound of each level's nonzeros;
  4. drive the Brakedown path at 2^23 ft255 CODE3 BLAKE3 through the public
     entry points: commit -> prove -> verify once cold (kernel launches
     counted: the BLAKE3 trees 4 times, 2 chunk trees, 1 Merkle tree and 1
     path walk; the collapses through mont_dot's CUDA-core thin kernel;
     mont_mul_map) and 3 times warm (median ms), then once traced by stage
     (mont_mul_map launched once in commit, where the plain limb graph
     converted the codeword to hash words, 5 times in verify; every CUDA
     kernel launch of each stage beside the parent commit's); check the
     evaluation against the
     host polynomial and that tampered proofs fail with the reference's
     kinds; reproduce its golden fixture (tests/data/torch_golden_sdig.json);
     then commit_streaming the same coefficients (its encode launches the
     SpMV) and hold its root and proof bytes to the in-memory ones;
  5. hold the NTT kernel's two outputs against its plain PyTorch version
     (ntt_forward_plain, then from_mont and the hash-word pack), limb for
     limb and word for word, at the 2^23 Ligero commit shape (ft255, R = 256
     rows of 32,768 padded to n = 2^17, limbs and words), at the verify shape
     (R = 2, limbs), at n = 2^19 (2 rows: limbs, and the words-only last
     pass) and on edge cases in each of the four fields (n = 2, 4, C/2, C,
     2C, 2^12, 2^18 and a 2^12 plan forced to 3 passes, with rows all zero,
     all p-1, a delta and random); time each whole call (every pass) and the
     plain version against the bound of the non-trivial butterflies, the hash
     words' reductions and the bytes;
  6. drive the Ligero path at 2^23 ft255 rho = 1/4 BLAKE3 the same way as
     phase 4 (one cold run with the launches counted, 3 warm: prove's
     collapse and verify's column check through mont_dot's thin
     tensor-core kernel; verify's rows by the route protocol.VERIFY_COLS_MIN
     picks at 2^17 columns: the encode (a second encode, 5 conversions
     through mont_mul_map) or at the opened columns (one power table and
     the tile kernel, 4 conversions); the evaluation's dot on the thin
     kernel; no conversion in commit), traced by stage as in phase 4, with
     the evaluation and tamper checks; verify by both routes on the same
     proof (verify_routes: equal values, the same error kind for a flipped
     opened value, both timed); reproduce its golden fixture
     (tests/data/torch_golden_ligero.json) under BLAKE3 and SHA-256 (the
     SHA-256 kernels);
  7. hold the BLAKE3 kernels (blake3_chunks; the chunk tree, merkle_tree
     and merkle_walk, one launch each) against their plain versions, word
     for word: the 2^23 Ligero commit's columns (2,048 words x 131,072), the
     2^28 commit's column length (16,384 words) over 4,096 columns, 189
     columns of both lengths, Brakedown's 6,593 opened columns, edge lengths
     (1, 8, 248, 504, 760, 2,040 words; a few columns also against the host
     hash), the chunk tree in both of its modes (a thread or a warp per
     column), streaming updates with carries of 0, 8 and 255 words, Merkle
     trees of 2^17 and 2^19 leaves and of 357,699 leaves padded to 2^19
     (and 1, 2, 300 and 513 leaves), path walks of 189 x 17 and 6,593 x 19
     (and 5 x 0, 40 x 3); time each (device, and the trees' host wall)
     against its bound and the trees against their dependency floor (depth
     x one compression's latency, from a one-thread chain of 4,096 in
     scripts/blake3_chain.cu);
  8. the streaming commit against the in-memory one at 2^26 (Ligero ft255
     rho = 1/4, 1,024 x 65,536 coefficients, 262,144 columns): equal roots
     and proof bytes with (a) unpacked coefficients on the card in 128-row
     blocks, the words kept on the card, (b) a HostCoeffSource with the words
     spilled to host RAM, (c) packed coefficients and no words kept (prove
     evaluates the opened columns directly); each route's BLAKE3 trees: 1
     chunk tree and 1 Merkle tree, its collapse through mont_dot's thin
     tensor-core kernel, route (c) one power table and the tile kernel;
  9. the streaming path at 2^28: Ligero ft255 rho = 1/4 BLAKE3, 2,048 rows x
     131,072 coefficients (packed on the card, made from the seed), 524,288
     columns: commit_streaming (spill="auto") -> prove -> verify once cold
     with the launches counted (verify by the route the gate picks at 2^19
     columns: the power table or the NTT), then warm runs (median ms, peak
     memory, proof
     bytes); the evaluation against one computed on the card in the other
     association order (rows against the inner tensor first, plain
     FieldOps, collapse_canon_plain); the BLAKE3 trees launched 4 times;
     tampered proofs; verify by both routes (verify_routes); the
     retained words hashed in memory equal to the streamed leaves, the
     chunk tree of 524,288 x 65 CVs equal to its plain version (and both
     kernels timed at that shape); one row
     block of the encode, words only, against the NTT's limbs-and-words
     call and the plain version;
  10. hold the prover's kernels against their plain versions, bit for bit:
     the seeded generator (2^22 ft255 coefficients in all three forms, a
     seed >= 2^32 with a zero tail, chunk-aligned and unaligned partitions,
     every field); mont_dot's thin tensor-core kernel at the 2^23 Ligero
     collapse (2 x 256 x 32,768 limbs), the Brakedown collapse (2 x 36 x
     235,173 limbs, an odd row stride read in place), a 64-row block of the
     2^29 collapse (2 x 64 x 262,144 packed) and the 2^23 verify column
     check (2 x 256 x 189), its CUDA-core thin kernel beside it at the
     same shapes, both on ragged shapes in every field (y as words and as
     limbs, by TMA and word by word, one K range and several) and the
     thin tensor-core kernel on all-0xFF operands across its range cap;
     the tile kernel at the 2^23 verify rows at the columns (2 x 32,768 x
     189) and a 64-row block of the 2^29 column evaluation (64 x 262,144 x
     189), on edge shapes in every field (y as words and as planes; ragged
     rows, k and points; unreduced operands; all-0xFF operands at K = 2^15
     - 1, 2^15, 2^15 + 1, the s32 accumulators' limit); the power table
     (digit planes) at 32,768, 131,072 and 262,144 x 189 and at K = 1, 127,
     128, 129, 4,097 x k = 1, 189, 6,593 in every field; each
     mont_dot shape timed beside the card's bound (its bytes or its byte
     products on the u8 tensor cores, whichever kernel runs it) with the
     CUDA cores' wide products beside;
  11. the slice's path: SeededCoeffSource(FT255, 2^29, seed=0), 2,048 rows
     x 262,144 coefficients, 2^20 columns, the 68.7 GB of hash words not
     kept: commit_streaming -> prove (MxuCollapse and MxuColumnEval over
     regenerated blocks) -> verify (the gate's route) once cold with the
     launches counted (the generator, the NTT, both BLAKE3 kernels, the
     trees 4 times, mont_dot, the power table), then warm runs (median ms
     beside the Rust reference's 64-core numbers, peak memory); the
     evaluation against one over regenerated blocks with the plain collapse
     in the other order; tampered proofs; verify by both routes
     (verify_routes); the columns opened by direct
     evaluation equal to the re-encode's, both timed, and prove's pieces
     (generator, the collapse over all 2,048 rows beside its bound, column
     evaluation, power table) and verify's two rows at the columns (the
     tile kernel) timed;
  12. hold the field maps (mont_mul_map, mont_addsub_map) against their
     plain versions, bit for bit: the 2^23 Brakedown commit's conversion
     (36 x 357,699 limbs -> hash words), Ligero 2^23 verify's rows (2 x
     32,768 words -> words and limbs), verify's opened columns (256 x 189
     and 36 x 6,593 words -> hash words), the 2^28 streaming prove's opened
     columns (2,048 x 189 hash words -> words), add and sub at the codeword's
     shape; each timed beside its bound (bytes or wide products) and the
     plain version; edges in every field (unreduced inputs up to R - 1, 1,
     7 and 41 elements, every form in and out, broadcast and
     non-contiguous operands, no elements);
  13. hold the SHA-256 kernels (csrc/sha256_cols.cu: sha256_cols, the
     Merkle tree and the walk, one launch each) against their plain
     versions, word for word: path (a)'s columns (2,048 words x 131,072),
     the 2^28 column length (16,384 words) over 4,096 columns, path (b)'s
     (288 words x 357,699), the first 189 and 6,593 columns of those alone,
     int32 and int64 words, edge lengths (1, 5, 7, 8, 56, 600 words; a few
     columns also against hashlib), words with every bit set, streaming
     updates from carries of 0, 8 and 15 words with blocks of 1, 7, 8, 9
     and 1,792 words state by state, finalizes at rem 12, 13 and 14 (one
     final block, then two), Merkle trees of 2^17 and 2^19 leaves and of
     357,699 padded to 2^19 (and 1, 2, 300 and 513 leaves), walks of 189 x
     17 and 6,593 x 19 (and 5 x 0, 40 x 3); time each against its bound
     (its bytes, or its compressions or parents by the probes' SASS) and
     the plain version, the trees and walks also against their dependency
     floor (depth x one parent's latency from the probe);
  14. the slice's paths with digest=SHA256 through the public entry points:
     (a) Ligero 2^23 and (b) Brakedown 2^23 as phases 6 and 4 run them
     (cold with the launches counted, 3 warm, traced by stage: commit one
     sha256_cols and one tree, verify one sha256_cols and one walk, no
     BLAKE3 kernel, each stage's CUDA kernels fewer than one plain
     compression launches, its BLAKE3 run's beside), (c) the
     2^28 streaming path of phase 9 (an update a row block and one
     finalize; the kept words hashed in memory equal to the streamed
     leaves; sha256_cols timed over them and at one block's update; traced
     by stage; up to 2 warm runs); each with the evaluation and the tamper
     kinds; the plain compression every plain SHA-256 version calls is
     watched throughout, and a call on the card is fatal;
  15. the sharded paths (lcpc_tpu_torch/parallel) at 2^23 ft255, seed 0:
     the NTT plan's twiddle table at n = 2^20 built on the card (mont_powers,
     19 mont_mul_map launches) against the host's Python-int powers; then
     (a) world 1 on NCCL in this process: Ligero rho = 1/4 by rows under
     BLAKE3 and SHA-256, Brakedown CODE3 by rows, Ligero wide (the DistNtt,
     A = 512, B = 256), and the mesh streaming commit of Ligero (64-row
     blocks) and Brakedown (8-row blocks); each run's root and proof bytes
     equal to the single-device commit (or commit_streaming) and prove on
     the same coefficients, its proof verifying with the evaluation, commit
     and prove counted by stage (each stage's kernels launched), commit and
     prove ms (medians of 3) beside the single device's; the pieces at world
     1 beside their bounds (the all_to_all of the 2^23 Ligero words, a device
     copy: 2 x bytes over 3.35 TB/s; the sharded collapse; the opened
     columns; one mesh streaming block); (b) two ranks on the one card
     (this script with --sharded-rank, a gloo group: NCCL refuses two ranks
     on one device), Ligero by rows and wide and Brakedown by rows, every
     rank's root and proof bytes equal to (a)'s single device's and
     mont_addsub_map launched in each rank's prove (the modular sum of the
     partials); its times pass through host memory, a correctness run;
  16. print the kernel table line, then the result line.

Imports nothing of JAX or of the JAX package; the measurement helpers
(card line, device timing, ptxas and SASS reports) are scripts/kernel_bench.py.
Per-shape numbers land in chiprun_out/chip_smoke_levels.json.
Exits non-zero, without the result line, when no CUDA device is present or
the package is missing.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time
import traceback

N_COEFFS = 1 << 23
R_COMMIT = 36
SEED = 0
REPS = 3
LIGERO_RHO = (1, 4)
# H100 SXM peaks (NVIDIA's data sheet, dense rates at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
# CUDA-core int32 multiply-add rate: half of the 67 TFLOP/s fp32 FMA lanes,
# 33.5 T ops/s counting a multiply-add as 2 ops -> 16.75e12 IMAD/s; a
# 32x32 -> 64-bit product takes two (low and high halves)
WIDE_PRODUCTS_PER_S = 16.75e12 / 2
# dense u8/s8 tensor-core operations (wgmma), 2 a multiply-add
INT8_OPS_PER_S = 1979e12
# the integer pipes: the ALU pipe and the FMA pipe (IMAD family) each take
# 64 lanes per SM a clock, 16.75e12 instructions/s over 132 SMs at 1.98 GHz;
# the schedulers issue twice that in all.  A BLAKE3 compression's time on
# them is counted from its SASS, split by pipe (phase 2, kernel_bench's
# blake3_sass_mix): the larger of its ALU and its FMA instructions over
# 16.75e12/s and of both together over the issue rate
INT_OPS_PER_S = 16.75e12
ISSUE_PER_S = 2 * INT_OPS_PER_S
B3_COMPRESSION_S = None  # set in phase 2 from the probe's SASS
B3_COMMIT = (2048, 131072)  # phase 7: words x columns of the 2^23 Ligero commit
B3_LONG = (16384, 4096)     # phase 7: the 2^28 commit's column length, 4,096 columns
B3_OPENED = 189             # phase 7: verify's opened columns
# phase 7: Merkle trees of the 2^23 Ligero commit, the 2^28 commit and the
# 2^23 Brakedown commit (leaves, padded width)
MERKLE_TREES = ((1 << 17, 1 << 17), (1 << 19, 1 << 19), (357_699, 1 << 19))
# phase 7: path walks of the 2^23 Ligero verify and the 2^23 Brakedown verify
# (opened columns, levels)
WALKS = ((189, 17), (6_593, 19))
CHAIN = 4096                # phase 7: compressions of the latency probe
TREES = ("chunk_tree", "merkle_tree", "merkle_walk")  # the BLAKE3 tree kernels
DOT_KERNELS = {"mont_dot_thin", "mont_dot_thin_tc", "mont_dot_tile"}  # mont_dot's three
# the kernels a 2^23 path launches besides its hash kernels: Brakedown's
# SpMV, its collapses on mont_dot's CUDA-core thin kernel and its
# conversions; Ligero's NTT, mont_dot's three kernels, the power table of
# verify at the columns and its conversions
SDIG_KERNELS = {"spmv_mont", "mont_dot", "mont_dot_thin", "mont_mul_map"}
LIGERO_KERNELS = {"ntt_mont", "mont_dot", "power_table", "mont_mul_map"} | DOT_KERNELS


def verify_at_columns(n_cols):
    """Does a Ligero ft255 verify at n_cols columns evaluate the proof rows
    at the opened columns (the power table, mont_dot's tile kernel) rather
    than encode them (the NTT)?  protocol.VERIFY_COLS_MIN decides."""
    from lcpc_tpu_torch.core import protocol
    return n_cols >= protocol.VERIFY_COLS_MIN


def ligero_kernels(n_cols):
    """LIGERO_KERNELS as verify's route at n_cols uses them: through the
    encode, no power table and no tile kernel (nothing else on a path with
    the words kept launches them)."""
    if verify_at_columns(n_cols):
        return set(LIGERO_KERNELS)
    return LIGERO_KERNELS - {"power_table", "mont_dot_tile"}


def ligero_verify_maps(n_cols):
    """mont_mul_map launches of a Ligero verify: the proof rows to
    Montgomery, the opened columns to hash words and the evaluation's two
    operands; the encode route also converts the rows at the opened
    columns back (from_mont)."""
    return 4 if verify_at_columns(n_cols) else 5
SHA_KERNELS = ("sha256_cols", "sha256_merkle_tree", "sha256_merkle_walk")  # the counters
SHA_COMPRESSION_S = None  # set in phase 2 from the probes' SASS: one scheduled compression
SHA_PARENT_S = None       # and one Merkle parent (a scheduled and a constant-block one)
SHA_SDIG = (288, 357_699)   # phase 13: the 2^23 Brakedown commit's columns (36 rows x 8 words)
SHA_EDGES = (1, 5, 7, 8, 56, 600)  # phase 13: column lengths, and (8 + L) % 16 = 9, 13, 15, 0
# phase 13: streaming updates; the carries before each are 8, 0, 0, 7, 15, 8
# words (the kernel reads a carry's block apart from the others), then one
# more block leaves rem 12, 13 or 14 for the finalize (one final block, then
# two: the pad word and the 64-bit length need 3)
SHA_STREAM = (8, 1792, 7, 8, 9, 1)
SHA_STREAM_TAILS = ((3, 12), (4, 13), (5, 14))
SHA_STREAM_COLS = 1000
SHA_BIG_WARM = 2            # warm runs of phase 14's 2^28 path (fewer when the time limit nears)
SHA_BIG_WARM_DEADLINE_S = 800
B3_KERNELS = ("blake3_chunks_kernel", "chunk_tree_stack_kernel", "chunk_tree_warp_kernel",
              "merkle_tree_kernel", "merkle_walk_kernel")
LOG_N_VERIFY_BIG = 19       # phase 5: the 2^28 verify's NTT size
N_STREAM = 1 << 26   # phase 8: streaming against the in-memory commit
N_BIG = 1 << 28      # phase 9: the slice's path
BIG_WARM = 3         # warm runs of phase 9 (fewer when the time limit nears)
BIG_WARM_DEADLINE_S = 700  # no warm run of phase 9 starts after this
GEN_CHECK = 1 << 22  # phase 10: seeded coefficients held to the plain generator
EVAL_ROWS = 64       # phase 10: rows of the 2^29 column evaluation block
TABLE_EDGE_K = (1, 127, 128, 129, 4_097)  # phase 10: power_table edges in every field
TABLE_EDGE_k = (1, 189, 6_593)
N_SEEDED = 1 << 29   # phase 11: the seeded path
SEEDED_WARM = 2      # warm runs of phase 11 (fewer when the time limit nears)
SEEDED_WARM_DEADLINE_S = 900  # no warm run of phase 11 starts after this
# the Rust reference on 64 cores at 2^29, Ligero ft255 rho = 1/4: commit,
# prove, verify in ms (BASELINE.md:20)
RUST_2_29 = (94_600.0, 1_513.0, 278.0)
DEV = "cuda"         # the card (phases 10 and 11 name it once, for a CPU rehearsal)
# phase 12: the field maps' shapes on the slice's paths (ft255): the 2^23
# Brakedown codeword (rows x columns), Ligero 2^23 verify's proof rows,
# verify's opened columns (rows x columns, Ligero and Brakedown), the 2^28
# streaming prove's opened columns
MAP_CODEWORD = (36, 357_699)
MAP_VERIFY_ROWS = (2, 32_768)
MAP_OPENED = ((256, 189), (36, 6_593))
MAP_STREAM_OPENED = (2_048, 189)
# commit / prove / verify CUDA kernel launches (torch.profiler: every kernel,
# torch's own included) of a warm run of each 2^23 path on commit 28b9104,
# before the field maps were kernels (scripts/time_paths.py, two runs, on an
# NVIDIA H100 80GB HBM3 at 700 W)
PARENT_LAUNCHES = {"sdig": ("2,600", "16", "2,384"), "ligero": ("4-5", "15-16", "2,004-2,005")}
ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def level_cost(spec, nnz, n_in, n_out, r):
    """(bytes, wide products) the level must move / do: each ragged packed
    operand read once (x, row_ptr, cols, vals), the output written once;
    (W/2)^2 32x32 -> 64 products per nonzero and r."""
    w32 = spec.w16 // 2
    nbytes = 4 * (n_in * r * w32 + (n_out + 1) + nnz + nnz * w32 + n_out * r * w32)
    products = nnz * r * w32 ** 2
    return nbytes, products


def ntt_cost(spec, r, k, n, words):
    """(bytes, wide products, non-trivial butterflies) of one ntt_forward of
    r rows of k elements zero-padded to n: the (W, r, k) int32 limbs read
    once, the (W, r, n) int32 limbs written once, with `words` the (r*W32,
    n) hash words written once, and the (n-1, W32) twiddle table read once.
    Each butterfly with a twiddle other than w^0 = 1 (all but n-1 a row)
    costs one CIOS product, 2 W32^2 + W32 wide products; each hash word
    element one Montgomery reduction, W32^2 + W32."""
    w32 = spec.w16 // 2
    butterflies = r * ((n // 2) * (n.bit_length() - 1) - (n - 1))
    nbytes = 4 * (spec.w16 * r * k + spec.w16 * r * n + (n - 1) * w32
                  + (w32 * r * n if words else 0))
    products = butterflies * (2 * w32 * w32 + w32) + (r * n * (w32 * w32 + w32) if words else 0)
    return nbytes, products, butterflies


def bound_ms(nbytes, products):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products / WIDE_PRODUCTS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


class Phase:
    """Prints a phase's name when made and, at done() (or the end of its
    with block), the seconds it took."""

    def __init__(self, name):
        self.name, self.t0 = name, time.perf_counter()
        log(f"== phase {name}")

    def done(self):
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s "
            f"(run {time.perf_counter() - T_START:.1f} s)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.done()


def hash_cost(n_words, n_cols):
    """(bytes, compressions) of hashing n_cols columns of n_words words
    behind the 8-word prefix: blake3_chunks reads each word once and writes
    each chunk's CV (32 bytes), one compression per 64-byte block;
    merge_chunk_cvs reads the CVs and writes the 64-byte (int64) digests,
    one compression per parent (n_chunks - 1 a column)."""
    total = 8 + n_words
    n_chunks = -(-total // 256)
    k1 = (4 * n_words * n_cols + 32 * n_chunks * n_cols, -(-total // 16) * n_cols)
    k2 = (32 * n_chunks * n_cols + 64 * n_cols, (n_chunks - 1) * n_cols)
    return k1, k2


def compression_s(alu, fma):
    """Seconds of one compression of alu ALU-pipe and fma FMA-pipe
    instructions on the card at the peak rates (any SM, any lane)."""
    return max(alu / INT_OPS_PER_S, fma / INT_OPS_PER_S, (alu + fma) / ISSUE_PER_S)


def hash_bound_ms(nbytes, compressions):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = compressions * B3_COMPRESSION_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_host(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def compare_levels(torch, kb, spmv, spec, levels, r, gen, tag, rows):
    """Kernel vs plain on each (name, dm) level at row count r."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0,
           "t_ops": 0.0, "err": 0}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, dm in levels:
        x = kb.random_packed(spmv, spec, dm.n_in, r, gen)
        y = spmv.spmv_mont(spec, x, dm)
        y_plain, plain_ms = time_host(torch, lambda: spmv.apply_mat_plain(spec, x, dm))
        err = int((spmv.unpack_words(y, 2) - spmv.unpack_words(y_plain, 2)).abs().max()
                  .item()) if y.numel() else 0
        if err:
            raise AssertionError(f"{tag} {name}: kernel != plain (max err {err})")
        ms = kb.time_kernel(lambda: spmv.spmv_mont(spec, x, dm))
        nbytes, products = level_cost(spec, dm.nnz, dm.n_in, dm.n_out, r)
        b, tb, to = bound_ms(nbytes, products)
        gather_ms = dm.nnz * r * spec.w16 * 2 / HBM_BYTES_PER_S * 1e3
        lanes = spmv.split_lanes(dm.n_out, r, dm.nnz, n_sm)
        by = "bytes" if tb >= to else "operations"
        rows.append({"phase": tag, "level": name, "n_in": dm.n_in, "n_out": dm.n_out,
                     "nnz": dm.nnz, "kmax": dm.kmax, "r": r, "lanes": lanes, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "bytes": nbytes, "products": products,
                     "gather_no_l2_ms": gather_ms})
        log(f"  {tag} {name:>6} n_in={dm.n_in:>7} n_out={dm.n_out:>6} nnz={dm.nnz:>8} "
            f"kmax={dm.kmax:>3} r={r:>2} S={lanes:>2}: equal, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms, bound {b:.4f} ms ({by}; bytes {tb:.4f}, "
            f"products {to:.4f}), gathers if L2 served none {gather_ms:.4f} ms")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b),
                       ("t_bytes", tb), ("t_ops", to)):
            tot[key] += v
        tot["err"] = max(tot["err"], err)
    tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
    log(f"  {tag} total: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.1f} ms, "
        f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    return tot


def edge_levels(torch, kb, spmv, spec, gen):
    """Ragged edge levels against the plain version at both row counts and
    every lane split: an empty row, rows of K = 96 all p-1 over inputs all
    p-1, and mixed lengths 0..96 with random values."""
    from lcpc_tpu_torch.ops.limbs import get_ops

    ops = get_ops(spec)
    n_in, n_out, k = 1000, 4096, 96
    lens = torch.randint(0, k + 1, (n_out,), generator=gen, device="cuda")
    lens[0], lens[1], lens[2] = 0, k, k
    row_ptr = torch.zeros(n_out + 1, dtype=torch.int64, device="cuda")
    row_ptr[1:] = torch.cumsum(lens, 0)
    nnz = int(row_ptr[-1])
    cols = torch.randint(0, n_in, (nnz,), generator=gen, device="cuda", dtype=torch.int32)
    cols[:k] = torch.arange(k, device="cuda")  # row 1: inputs 0..95
    pm1 = torch.from_numpy(ops.encode_host([spec.p - 1]).astype("int32")).cuda()[:, 0]
    pm1_w = spmv.pack_words(pm1, 0)                   # (W32,)
    vals = kb.random_packed(spmv, spec, nnz, 1, gen)[:, 0].contiguous()
    vals[: 2 * k] = pm1_w                             # rows 1 and 2: all p-1
    mat = spmv.RaggedCsr(n_in, row_ptr.to(torch.int32), cols, vals)
    if mat.kmax != k:
        raise AssertionError(f"edge: kmax {mat.kmax} != {k}")
    for r in (36, 2):
        x = kb.random_packed(spmv, spec, n_in, r, gen)
        x[: n_in // 2] = pm1_w                        # inputs 0..499: all p-1
        want = spmv.apply_mat_plain(spec, x, mat)
        if want[0].any():
            raise AssertionError("edge: the empty row's plain result is not 0")
        for lanes in (1, 2, 4, 8, 16, 32):
            y = spmv.spmv_mont(spec, x, mat, _lanes=lanes)
            if not torch.equal(y, want):
                raise AssertionError(f"edge level r={r} S={lanes}: kernel != plain")
    log(f"  edge {spec.name} (W32={spec.w16 // 2}): {n_out} rows of 0..96 nonzeros "
        f"({nnz} in all; row 0 empty, rows 1-2 K=96 all p-1, inputs 0..499 all p-1), "
        f"r=36 and r=2, S=1..32: equal")


def plain_ntt(nttm, plan, x, words):
    """The plain version of ntt_forward(plan, x), with the words if `words`."""
    from lcpc_tpu_torch.ops.limbs import pack_row_words

    y = nttm.ntt_forward_plain(plan, x)
    return (y, pack_row_words(plan.ops.from_mont_plain(y))) if words else y


def equal_outputs(torch, got, want):
    """Limb for limb (and word for word): (equal, max abs err)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = max(int((g.long() - w.long()).abs().max().item()) if g.numel() else 0
              for g, w in zip(got, want))
    return err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)), err


def compare_ntt(torch, kb, nttm, plan, x, tag, rows, words):
    """NTT kernel vs plain on x (W, R, k <= plan.n): the limbs and, with
    `words`, the hash words; times the whole ntt_forward call (every pass)
    and the plain version; returns the shape's record."""
    spec = plan.spec
    output = "both" if words else "limbs"
    got = nttm.ntt_forward(plan, x, output=output)
    want, plain_ms = time_host(torch, lambda: plain_ntt(nttm, plan, x, words))
    ok, err = equal_outputs(torch, got, want)
    if not ok:
        raise AssertionError(f"ntt {tag}: kernel != plain (max err {err})")
    del got, want
    ms = kb.time_kernel(lambda: nttm.ntt_forward(plan, x, output=output))
    limbs_ms = kb.time_kernel(lambda: nttm.ntt_forward(plan, x)) if words else ms
    r, k = x.shape[1], x.shape[2]
    nbytes, products, butterflies = ntt_cost(spec, r, k, plan.n, words)
    b, tb, to = bound_ms(nbytes, products)
    by = "bytes" if tb >= to else "operations"
    rec = {"phase": tag, "field": spec.name, "r": r, "k": k, "n": plan.n, "words": words,
           "passes": [dataclasses.astuple(ps) for ps in plan.passes],
           "launches_per_call": plan.launches_per_call, "ms": ms, "limbs_only_ms": limbs_ms,
           "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "bytes": nbytes,
           "products": products, "butterflies": butterflies, "err": err}
    rows.append(rec)
    log(f"  ntt {tag}: {spec.name} R={r} k={k} n={plan.n}, {plan.launches_per_call} "
        f"launches, {'limbs and words' if words else 'limbs'}: equal, ntt_forward "
        f"{ms:.4f} ms{f' (limbs only {limbs_ms:.4f} ms)' if words else ''}, plain "
        f"{plain_ms:.1f} ms, bound {b:.4f} ms ({by}; bytes {tb:.4f}, products {to:.4f}; "
        f"{butterflies} non-trivial butterflies)")
    return rec


def ntt_edges(torch, kb, nttm, spec, gen):
    """Edge cases against the plain version, limbs and words: rows all zero,
    all p-1, a delta and random, at n = 2, 4, C/2, C, 2C, 2^12 and 2^18, and
    at 2^12 with a plan forced to 3 passes."""
    from lcpc_tpu_torch.ops.limbs import get_ops

    ops = get_ops(spec)
    pm1 = torch.from_numpy(ops.encode_host([spec.p - 1]).astype("int32")).cuda()
    one = torch.from_numpy(ops.encode_host([1]).astype("int32")).cuda()
    c = 1 << nttm.LOG_CHUNK
    forced = dict(log_chunk=8, max_tile_bytes=64 * spec.w16)  # 2 + 2 + 8 stages
    cases = [(n, {}) for n in (2, 4, c // 2, c, 2 * c, 1 << 12, 1 << 18)] + [(1 << 12, forced)]
    for n, kw in cases:
        plan = nttm.NttPlan(spec, n, **kw)
        if kw and len(plan.passes) != 3:
            raise AssertionError(f"ntt edge {spec.name}: forced plan has {plan.passes}")
        x = kb.random_mont(spec, (4, spec.w16, n), gen).permute(1, 0, 2).contiguous()
        x[:, 0] = 0
        x[:, 1] = pm1
        x[:, 2] = 0
        x[:, 2, n // 2] = one[:, 0]
        for xs in (x, x[:, :, : max(1, n // 4)].contiguous()):  # full and short rows
            y = nttm.ntt_forward(plan, xs, output="both")
            if not equal_outputs(torch, y, plain_ntt(nttm, plan, xs, True))[0]:
                raise AssertionError(f"ntt edge {spec.name} n={n} k={xs.shape[2]} "
                                     f"{len(plan.passes)} passes: kernel != plain")
            if not equal_outputs(torch, nttm.ntt_forward(plan, xs), y[0])[0]:
                raise AssertionError(f"ntt edge {spec.name} n={n}: limbs differ with words")
            if y[0][:, 0].any() or y[1][: spec.w16 // 2].any():
                raise AssertionError(f"ntt edge {spec.name} n={n}: zero row not zero")
    log(f"  ntt edge {spec.name} (W32={spec.w16 // 2}): n = 2, 4, {c // 2}, {c}, "
        f"{2 * c}, 4096, 2^18 and 4096 in 3 passes x rows zero / p-1 / delta / random, "
        f"k = n and n/4, limbs and words: equal")


def drive(torch, P, enc, coeffs_mont, outer, inner, digest):
    """commit -> prove -> verify through the public entry points with
    `digest`; returns (comm, proof, value, (commit, prove, verify) ms, the
    transcript maker)."""
    transcript = transcript_for(P, enc)
    comm, c_ms = time_host(torch, lambda: P.commit(coeffs_mont, enc, digest=digest))
    root = comm.get_root()
    proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
    value, v_ms = time_host(torch, lambda: proof.verify(root, outer, inner, enc,
                                                        transcript(root), digest=digest))
    return comm, proof, value, (c_ms, p_ms, v_ms), transcript


def stage_launches(torch, P, counters, enc, commit, outer, inner, digest):
    """One warm commit (`commit()`), prove and verify, each under
    torch.profiler with every launch count set to 0 just before: per
    stage, the port's kernel launches by counter and every CUDA kernel the
    trace saw (torch's own included; scripts/time_paths.py counts the same
    way)."""
    transcript = transcript_for(P, enc)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    st, out = {}, {}
    stages = (("commit", commit),
              ("prove", lambda: st["commit"].prove(outer, transcript(st["root"]))),
              ("verify", lambda: st["prove"].verify(st["root"], outer, inner, enc,
                                                    transcript(st["root"]), digest=digest)))
    for name, fn in stages:
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            st[name] = fn()
            torch.cuda.synchronize()
        if name == "commit":
            st["root"] = st[name].get_root()
        out[name] = {"counters": {k: c.launches for k, c in counters.items() if c.launches},
                     "cuda_kernels": sum(1 for e in prof.events()
                                         if e.device_type == torch.autograd.DeviceType.CUDA)}
    return out


def main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, tag, path_kernels,
              digest, hash_launches):
    """The main path of one encoding at 2^23 with `digest`: once cold with
    every launch count set to 0 just before and read just after (the
    kernels in `path_kernels` must have launched, the others not; the hash
    kernels as often as `hash_launches` says), then REPS warm runs and one
    traced run (stage_launches).  Checks the evaluation and the tamper
    kinds; returns (launches, cold ms, warm ms, median ms, peak GiB, proof
    bytes, root, the proof, the traced run's launches by stage)."""
    spec = enc.spec
    n_rows = -(-N_COEFFS // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    comm, proof, value, cold, transcript = drive(torch, P, enc, coeffs_mont, outer, inner,
                                                 digest)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"{tag} main path cold ({digest.name}): commit {cold[0]:.1f} ms, prove {cold[1]:.1f} "
        f"ms, verify {cold[2]:.1f} ms; launches {launches}")
    for name, n in launches.items():
        if (n > 0) != (name in path_kernels):
            raise AssertionError(f"{tag}: {name} launched {n} times")
    check_hash_launches(launches, hash_launches, tag)
    if value != want:
        raise AssertionError(f"{tag}: verify returned the wrong evaluation")
    log(f"  verify returned univariate_eval of the {N_COEFFS} coefficients: ok")
    root = comm.get_root()
    data = P.wire.serialize_proof(spec, proof)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  n_rows {comm.n_rows}, n_per_row {comm.n_per_row}, n_cols {comm.n_cols}, "
        f"proof {len(data)} bytes, peak device memory {peak:.2f} GiB")
    tamper_checks(P, spec, data, root, outer, inner, enc, transcript, tag, digest)
    del comm, proof
    warm = [drive(torch, P, enc, coeffs_mont, outer, inner, digest)[3] for _ in range(REPS)]
    med = [statistics.median(t[i] for t in warm) for i in range(3)]
    size = f"2^{N_COEFFS.bit_length() - 1}"
    for i, name in enumerate(("commit", "prove", "verify")):
        log(f"{tag}_{name}_ms_median_{size}_ft255: {med[i]:.1f} "
            f"(warm runs {[round(t[i], 1) for t in warm]}; {card})")
    stages = stage_launches(torch, P, counters, enc,
                            lambda: P.commit(coeffs_mont, enc, digest=digest), outer, inner,
                            digest)
    parent = PARENT_LAUNCHES.get(tag)
    for i, (name, rec) in enumerate(stages.items()):
        log(f"  {tag} {name}: {rec['cuda_kernels']} CUDA kernel launches"
            + (f" (before the field maps were kernels: {parent[i]})" if parent else "")
            + f"; the port's kernels {rec['counters']}")
    return launches, cold, warm, med, peak, len(data), root, data, stages


# BLAKE3 tree launches of commit -> prove -> verify: the chunk tree once in
# commit (the column digests) and once in verify (the opened columns), the
# Merkle tree in commit, the path walk in verify
TREE_LAUNCHES_PATH = {"chunk_tree": 2, "merkle_tree": 1, "merkle_walk": 1}
# of commit_streaming -> prove: the column digests' chunk tree and the Merkle tree
TREE_LAUNCHES_STREAM = {"chunk_tree": 1, "merkle_tree": 1, "merkle_walk": 0}
# SHA-256 launches of commit -> prove -> verify in memory: the column hash in
# commit and in verify (the opened columns), the tree in commit, the walk in
# verify; by stage
SHA_LAUNCHES_PATH = {"sha256_cols": 2, "sha256_merkle_tree": 1, "sha256_merkle_walk": 1}
SHA_LAUNCHES_STAGES = {"commit": {"sha256_cols": 1, "sha256_merkle_tree": 1},
                       "prove": {}, "verify": {"sha256_cols": 1, "sha256_merkle_walk": 1}}


def check_map_launches(stages, tag, want):
    """mont_mul_map's launches by stage of a traced run equal `want`, and
    mont_addsub_map launched nowhere."""
    got = {name: rec["counters"].get("mont_mul_map", 0) for name, rec in stages.items()}
    if got != want or any("mont_addsub_map" in rec["counters"] for rec in stages.values()):
        raise AssertionError(f"{tag}: mont_mul_map launches by stage {got} != {want}")
    log(f"  {tag}: mont_mul_map launches by stage {got}; mont_addsub_map none")


def check_hash_launches(launches, want, tag):
    """The hash kernels named in `want` launched exactly as often."""
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"{tag}: hash kernel launches {got} != {want}")
    log(f"  {tag}: hash kernel launches {sum(got.values())} ({got})")


def golden_run(torch, P, enc, spec, golden, digest):
    """commit -> prove of a golden instance on the GPU: (root, proof bytes)."""
    from lcpc_tpu_torch.utils.tensors import seeded_values

    n = golden["length"] if "length" in golden else golden["n_per_row"] * golden["n_rows"]
    vals = seeded_values(spec.p, spec.w16, n + 1, golden["coeff_seed"])
    coeffs, x = vals[:-1], vals[-1]
    comm = P.commit(coeffs, enc, digest=digest)
    root = comm.get_root()
    tr = P.Transcript(golden["transcript"][0].encode())
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    outer, _ = P.univariate_tensors(spec, x, enc.n_per_row, comm.n_rows)
    return root, P.wire.serialize_proof(spec, comm.prove(outer, tr))


def tamper_checks(P, spec, data, root, outer, inner, enc, transcript, tag, digest):
    """A flipped column limb fails with ColumnDegree, a zeroed path node
    with ColumnPath (verify with `digest`)."""
    for what, kind_want in (("column", "ColumnDegree"), ("path", "ColumnPath")):
        bad = P.wire.deserialize_proof(spec, data)
        if what == "column":
            bad.columns[0].col_mont[0, 0] ^= 1
        else:
            bad.columns[5].path[2] = bytes(32)
        try:
            bad.verify(root, outer, inner, enc, transcript(root), digest=digest)
        except P.VerifierError as e:
            if e.kind != kind_want:
                raise AssertionError(f"{tag} tampered {what}: {e.kind} != {kind_want}")
            log(f"  {tag} tampered {what}: VerifierError({e.kind!r})")
        else:
            raise AssertionError(f"{tag} tampered {what} verified")


def verify_routes(torch, P, enc, data, root, outer, inner, transcript, tag, reps=3):
    """Verify's two routes on one proof, forced through
    protocol.VERIFY_COLS_MIN (0: the rows at the opened columns, the power
    table; past every width: the encode): both must accept with the same
    value and reject a proof with one opened value flipped with the same
    error kind (their flags agree); each timed, host wall, in turns.
    Returns the record."""
    from lcpc_tpu_torch.core import protocol
    gate = protocol.VERIFY_COLS_MIN

    def run(route, mutate=None):
        protocol.VERIFY_COLS_MIN = 0 if route == "cols" else 1 << 62
        try:
            pf = P.wire.deserialize_proof(enc.spec, data)
            if mutate is not None:
                mutate(pf)
            return time_host(torch, lambda: pf.verify(root, outer, inner, enc, transcript(root)))
        except P.VerifierError as e:
            return e.kind, None
        finally:
            protocol.VERIFY_COLS_MIN = gate

    def flip(pf):
        pf.columns[0].col_mont[0, 0] ^= 1

    times = {"cols": [], "encode": []}
    values = set()
    for i in range(reps):
        for route in (("cols", "encode") if i % 2 == 0 else ("encode", "cols")):
            value, ms = run(route)
            if ms is None:
                raise AssertionError(f"{tag}: verify by the {route} route rejected: {value}")
            values.add(value)
            times[route].append(ms)
    kinds = {route: run(route, flip)[0] for route in times}
    if len(values) != 1 or len(set(kinds.values())) != 1 or kinds["cols"] != "ColumnDegree":
        raise AssertionError(f"{tag}: the verify routes disagree: values {len(values)}, "
                             f"a flipped opened value {kinds}")
    med = {route: statistics.median(t) for route, t in times.items()}
    log(f"  {tag} verify by both routes ({enc.n_cols} columns; the gate, "
        f"{gate} columns, takes the {'columns' if enc.n_cols >= gate else 'encode'} route): "
        f"the same value, a flipped opened value {kinds['cols']} by both; median host wall "
        f"columns {med['cols']:.1f} ms, encode {med['encode']:.1f} ms (runs {times})")
    return {"n_cols": enc.n_cols, "gate": gate, "ms": times, "median_ms": med,
            "flipped": kinds}


def transcript_for(P, enc):
    def transcript(root):
        tr = P.Transcript(b"chip smoke")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr
    return transcript


def random_packed_coeffs(torch, spec, n, gen, block=1 << 26):
    """n random field elements (< p) as packed (W/2, n) int32 words on the
    card, made in blocks from `gen`: random 16-bit limbs with the top one
    below p's, which is also a valid Montgomery form as it is."""
    w32 = spec.w16 // 2
    top = spec.p >> (16 * (spec.w16 - 1))
    out = torch.empty((w32, n), dtype=torch.int32, device="cuda")
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        out[:, i0:i1] = torch.randint(-2**31, 2**31, (w32, i1 - i0), generator=gen,
                                      device="cuda", dtype=torch.int32)
        hi = torch.randint(0, top, (i1 - i0,), generator=gen, device="cuda",
                           dtype=torch.int32)
        out[-1, i0:i1] = (out[-1, i0:i1] & 0xFFFF) | (hi << 16)
    return out


def max_err(torch, got, want):
    """Largest |difference| of two word tensors read as u32 values."""
    if got.numel() == 0:
        return 0
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    return int((g - w).abs().max().item())


def host_ms(torch, fn, reps=20):
    """Median host wall per call, each call ending in synchronize(): what
    the caller of a tree waits, its issue included."""
    return statistics.median(time_host(torch, fn)[1] for _ in range(reps))


def chunk_tree_check(torch, kb, b3, cvs, want, plain_ms, lat_ms, check, tag, timed):
    """The chunk tree in every mode its shape allows against `want`, from
    merge_chunk_cvs_plain in plain_ms; with `timed`, each mode's device time
    (and the automatic choice's host wall) beside its bound and dependency
    floor."""
    n, _, n_cols = cvs.shape
    modes = [None, 1] + ([32] if 2 < n <= 512 else [])
    for lanes in modes:
        check(f"{tag} chunk tree (lanes {lanes or 'auto'})", b3.merge_chunk_cvs(cvs, _lanes=lanes),
              want)
    if not timed:
        return {}
    nbytes, compressions = 4 * 8 * n * n_cols + 64 * n_cols, (n - 1) * n_cols
    bound, by = hash_bound_ms(nbytes, compressions)
    auto = 32 if 2 < n <= 512 and n_cols <= b3.WARP_TREE_MAX_COLS else 1
    rec = {"n": n, "n_cols": n_cols, "auto_lanes": auto, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "compressions": compressions, "bytes": nbytes,
           "host_ms": host_ms(torch, lambda: b3.merge_chunk_cvs(cvs)), "launches": 1}
    for lanes in modes[1:]:
        rec[f"ms_lanes_{lanes}"] = kb.time_kernel(lambda: b3.merge_chunk_cvs(cvs, _lanes=lanes))
        depth = n - 1 if lanes == 1 else (n - 1).bit_length()
        rec[f"floor_ms_lanes_{lanes}"] = depth * lat_ms
    rec["ms"] = rec[f"ms_lanes_{auto}"]
    log(f"  blake3 {tag} chunk tree ({n_cols} x {n} CVs): equal in every mode; 1 launch, "
        f"device {rec['ms']:.4f} ms (lanes {auto}; "
        + ", ".join(f"lanes {m}: {rec[f'ms_lanes_{m}']:.4f} ms, floor "
                    f"{rec[f'floor_ms_lanes_{m}']:.4f}" for m in modes[1:])
        + f"), host wall {rec['host_ms']:.4f} ms, bound {bound:.4f} ms ({by}), plain "
        f"{plain_ms:.1f} ms")
    return rec


def blake3_phase(torch, kb, b3, gen, chain_so):
    """Phase 7: the BLAKE3 kernels against their plain versions, word for
    word, and timed against their bounds; the trees also against the
    dependency floor of their depth (one compression's latency from the
    probe library chain_so).  Returns the records."""
    import numpy as np
    from lcpc_tpu_torch.core.streaming import StreamingColumnHasher

    def words(n, c):
        return torch.randint(-2**31, 2**31, (n, c), generator=gen, device="cuda",
                             dtype=torch.int32)

    def digests(n):
        return torch.randint(0, 2**32, (8, n), generator=gen, device="cuda", dtype=torch.int64)

    recs, errs = {}, [0]

    def check(tag, got, want):
        err = max_err(torch, got, want)
        errs[0] = max(errs[0], err)
        if err or not torch.equal(got.to(torch.int64) & 0xFFFFFFFF,
                                  want.to(torch.int64) & 0xFFFFFFFF):
            raise AssertionError(f"blake3 {tag}: kernel != plain (max err {err})")

    log("blake3 kernels vs plain: tolerance 0 — every digest word equal")
    # one compression's latency: a thread running CHAIN dependent ones
    cv0 = digests(1)[:, 0].contiguous()
    node = cv0[None, :, None]
    for _ in range(4):
        node = b3.blake3_parents_plain(node, node, 1, b3.PARENT)
    check("compress chain", kb.compress_chain(chain_so, cv0, 4), node[0, :, 0])
    lat_ms = kb.time_kernel(lambda: kb.compress_chain(chain_so, cv0, CHAIN), reps=3) / CHAIN
    recs["compression_latency_ms"] = lat_ms
    log(f"  one compression's latency (a chain of {CHAIN} in one thread): {lat_ms * 1e3:.4f} us")

    def columns(tag, w, host_cols=0, timed=False, tree_timed=False):
        n_words, n_cols = w.shape
        n_chunks = -(-(8 + n_words) // 256)
        final_len = 8 + n_words - 256 * (n_chunks - 1)
        root = n_chunks == 1
        cvs = torch.empty((n_chunks, 8, n_cols), dtype=torch.int64 if root else torch.int32,
                          device="cuda")
        b3.blake3_chunks(w, cvs, final_len=final_len, root=root)
        cvs_p, k1_plain = time_host(torch, lambda: b3.blake3_chunks_plain(
            w, None, 8, 0, n_chunks, final_len, root))
        check(f"{tag} chunks", cvs, cvs_p)
        rec = {"n_words": n_words, "n_cols": n_cols, "n_chunks": n_chunks}
        if root:
            leaves, leaves_p = cvs[0], cvs_p[0]
        else:
            leaves_p, k2_plain = time_host(torch, lambda: b3.merge_chunk_cvs_plain(cvs_p))
            rec["tree"] = chunk_tree_check(torch, kb, b3, cvs, leaves_p, k2_plain, lat_ms, check,
                                           tag, timed or tree_timed)
            leaves = b3.merge_chunk_cvs(cvs)
        check(f"{tag} hash_word_columns", b3.hash_word_columns(w), leaves_p)
        if host_cols:
            u = w[:, :host_cols].cpu().numpy().view(np.uint32)
            got = b3.digests_to_bytes(leaves[:, :host_cols])
            for c in range(host_cols):
                if bytes(got[c]) != b3.blake3(bytes(32) + u[:, c].astype("<u4").tobytes()):
                    raise AssertionError(f"blake3 {tag}: column {c} != the host hash")
        if timed:
            (k1_b, k1_c), _ = hash_cost(n_words, n_cols)
            k1_ms = kb.time_kernel(lambda: b3.blake3_chunks(w, cvs, final_len=final_len))
            rec.update(k1_ms=k1_ms, k1_plain_ms=k1_plain, k1_compressions=k1_c, k1_bytes=k1_b)
            rec["k1_bound_ms"], rec["k1_bound_by"] = hash_bound_ms(k1_b, k1_c)
            log(f"  blake3 {tag}: {n_cols} columns of {n_words} words ({n_chunks} chunks): "
                f"equal; blake3_chunks {k1_ms:.4f} ms (plain {k1_plain:.1f} ms, bound "
                f"{rec['k1_bound_ms']:.4f} ms, {rec['k1_bound_by']}; {k1_c} compressions)")
        else:
            log(f"  blake3 {tag}: {n_cols} columns of {n_words} words ({n_chunks} chunks): "
                f"equal{f', {host_cols} columns equal to the host hash' if host_cols else ''}")
        recs[tag] = rec

    columns("2^23 commit", words(*B3_COMMIT), host_cols=2, timed=True)
    columns("2^28 column length", words(*B3_LONG), host_cols=1, timed=True)
    columns("2^23 verify (189 columns)", words(B3_COMMIT[0], B3_OPENED), tree_timed=True)
    columns("2^28 verify (189 columns)", words(B3_LONG[0], B3_OPENED), tree_timed=True)
    columns("brakedown 2^23 verify (6,593 columns)", words(288, 6_593), tree_timed=True)
    for n_words in (1, 8, 248, 504, 760, 2040):
        columns(f"edge {n_words}", words(n_words, 300), host_cols=2)
    for lens in ((248, 256, 256), (256, 256, 256), (247, 257)):
        w = words(sum(lens), 1000)
        h = StreamingColumnHasher(1000, 8 + sum(lens), "cuda")
        carries, r0 = [], 0
        for n in lens:
            h.update(w[r0 : r0 + n])
            carries.append(h.buf_len)
            r0 += n
        check(f"stream {lens}", h.finalize(), b3.hash_word_columns_plain(w))
        log(f"  blake3 streaming updates of {lens} words (carries {carries[:-1]}): equal "
            f"to the one-shot plain hash")

    for n_cols, np2 in MERKLE_TREES + ((1, 1), (2, 2), (300, 512), (513, 1024)):
        leaves = digests(n_cols)
        got = b3.merkle_tree(leaves, np2)
        want, plain_ms = time_host(torch, lambda: b3.merkle_tree_plain(leaves, np2))
        check(f"merkle tree {n_cols} -> {np2}", got, want)
        if (n_cols, np2) not in MERKLE_TREES:
            continue
        ms = kb.time_kernel(lambda: b3.merkle_tree(leaves, np2))
        wall = host_ms(torch, lambda: b3.merkle_tree(leaves, np2))
        bound, by = hash_bound_ms(64 * n_cols + 64 * (2 * np2 - 1), np2 - 1)
        depth = np2.bit_length() - 1
        recs[f"merkle {n_cols}"] = {
            "leaves": n_cols, "np2": np2, "launches": 1, "ms": ms, "host_ms": wall,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "floor_ms": depth * lat_ms, "depth": depth}
        log(f"  blake3 merkle tree of {n_cols} leaves (padded to 2^{depth}): equal; 1 launch, "
            f"device {ms:.4f} ms, host wall {wall:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"floor {depth} x latency = {depth * lat_ms:.4f} ms, plain {plain_ms:.1f} ms")
    log("  blake3 merkle trees of 1, 2, 300 -> 512 and 513 -> 1,024 leaves: equal")

    for k, levels in WALKS + ((5, 0), (40, 3)):
        n_sibs = max(1, k * levels // 2)
        digs, sibs = digests(k), digests(n_sibs)
        inv = torch.randint(0, n_sibs, (levels, k), generator=gen, device="cuda")
        idx = torch.randint(0, 1 << levels, (k,), generator=gen, device="cuda")
        idx[:2] = idx[2]  # opened columns repeat
        got = b3.merkle_walk(digs, sibs, inv, idx)
        want, plain_ms = time_host(torch, lambda: b3.merkle_walk_plain(digs, sibs, inv, idx))
        check(f"merkle walk {k} x {levels}", got, want)
        if (k, levels) not in WALKS:
            continue
        ms = kb.time_kernel(lambda: b3.merkle_walk(digs, sibs, inv, idx))
        wall = host_ms(torch, lambda: b3.merkle_walk(digs, sibs, inv, idx))
        read = int(torch.unique(inv).numel())
        bound, by = hash_bound_ms(64 * k + 64 * read + 8 * levels * k + 8 * k + 64 * k,
                                  k * levels)
        recs[f"walk {k}"] = {"columns": k, "levels": levels, "launches": 1, "ms": ms,
                             "host_ms": wall, "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": by, "floor_ms": levels * lat_ms}
        log(f"  blake3 merkle walk of {k} columns x {levels} levels: equal; 1 launch, device "
            f"{ms:.4f} ms, host wall {wall:.4f} ms, bound {bound:.4f} ms ({by}), floor "
            f"{levels * lat_ms:.4f} ms, plain {plain_ms:.1f} ms")
    log("  blake3 merkle walks of 5 x 0 and 40 x 3: equal")
    recs["max_abs_err"] = errs[0]
    return recs


def ntt_2_19(torch, kb, nttm, spec, gen, ntt_rows):
    """Phase 5's n = 2^19 cases: 2 rows of 2^17 (the 2^28 verify shape),
    limbs, and the words-only last pass against the plain words."""
    log_n = LOG_N_VERIFY_BIG
    plan = nttm.get_ntt(spec, 1 << log_n)
    x = kb.random_mont(spec, (2, spec.w16, 1 << (log_n - 2)), gen).permute(1, 0, 2).contiguous()
    rec = compare_ntt(torch, kb, nttm, plan, x, f"n=2^{log_n} verify", ntt_rows, words=False)
    only = nttm.ntt_forward(plan, x, output="words")
    if not equal_outputs(torch, only, plain_ntt(nttm, plan, x, True)[1])[0]:
        raise AssertionError(f"ntt n=2^{log_n}: words-only pass != plain words")
    ms = kb.time_kernel(lambda: nttm.ntt_forward(plan, x, output="words"))
    log(f"  ntt n=2^{log_n} words only (output='words'): equal to the plain words, {ms:.4f} ms")
    return rec


def device_eval(torch, ops, mat, outer, inner, rb):
    """Σ_r outer[r] (Σ_j inner[j] c[r, j]) on the card with plain FieldOps
    (collapse_canon_plain, not the mont_dot kernel the path uses), rows
    against the inner tensor first, in row blocks: mat is the packed
    (W/2, R, n_per_row) Montgomery coefficient matrix."""
    import numpy as np
    from lcpc_tpu_torch.ops.spmv import unpack_words

    def limbs(vals):
        return torch.from_numpy(ops.encode_host(vals).astype(np.int32)).cuda()[:, None, :]

    inner_t, parts = limbs(inner), []
    for r0 in range(0, mat.shape[1], rb):
        blk = unpack_words(mat[:, r0 : r0 + rb], 0)
        parts.append(ops.collapse_canon_plain(inner_t, blk.permute(0, 2, 1)))  # (W, 1, m)
    rows = ops.to_mont_plain(torch.cat(parts, dim=2))
    v = ops.collapse_canon_plain(limbs(outer), rows.permute(0, 2, 1))  # (W, 1, 1) canonical
    return int.from_bytes(v.reshape(-1).cpu().numpy().astype("<u2").tobytes(), "little")


def streaming_2_26(torch, P, counters, gen):
    """Phase 8: commit_streaming against commit at 2^26, three routes.  Each
    route's commit_streaming and prove run with every launch count set to 0
    just before and read just after: the NTT and both BLAKE3 kernels must
    have launched, the SpMV not."""
    import numpy as np
    from lcpc_tpu_torch.ops.spmv import unpack_words

    spec = P.FT255
    enc = P.LigeroEncoding.new(spec, N_STREAM, *LIGERO_RHO)
    packed = random_packed_coeffs(torch, spec, N_STREAM, gen)
    limbs = unpack_words(packed, 0)
    n_rows = -(-N_STREAM // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, 0x5EED, enc.n_per_row, n_rows)
    transcript = transcript_for(P, enc)
    comm, c_ms = time_host(torch, lambda: P.commit(limbs, enc))
    root = comm.get_root()
    proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
    data = P.wire.serialize_proof(spec, proof)
    value = proof.verify(root, outer, inner, enc, transcript(root))
    del comm, proof
    torch.cuda.empty_cache()
    log(f"stream 2^26: {n_rows} x {enc.n_per_row} -> {enc.n_cols} columns; in-memory commit "
        f"{c_ms:.1f} ms, prove {p_ms:.1f} ms, proof {len(data)} bytes")
    host = limbs.cpu().numpy().view(np.uint32)
    cases = (("a: unpacked on the card, 128-row blocks, words kept on the card", limbs,
              dict(row_block=128, spill="device")),
             ("b: HostCoeffSource, words spilled to host RAM",
              P.HostCoeffSource(host, spec), dict(spill="host")),
             ("c: packed on the card, no words kept (prove evaluates the opened columns)", packed,
              dict(spill="none")))
    out = []
    for tag, src, kw in cases:
        # every route collapses through mont_dot (one block of 1,024 rows: the
        # thin tensor-core kernel); with no words kept prove evaluates the
        # columns directly (the power table, the tile kernel, a thin launch
        # summing its K splits)
        path_kernels = {"ntt_mont", "blake3_chunks", "chunk_tree", "merkle_tree", "mont_dot",
                        "mont_dot_thin_tc"}
        if kw["spill"] == "none":
            path_kernels |= {"power_table", "mont_dot_tile", "mont_dot_thin"}
        else:  # the kept words' opened columns to the proof's Montgomery words
            path_kernels |= {"mont_mul_map"}
        for fn in counters.values():
            fn.launches = 0
        cs, cs_ms = time_host(torch, lambda: P.commit_streaming(src, enc, **kw))
        if cs.get_root() != root:
            raise AssertionError(f"stream 2^26 {tag}: root differs from the in-memory commit")
        pf, pf_ms = time_host(torch, lambda: cs.prove(outer, transcript(root)))
        launches = {name: fn.launches for name, fn in counters.items()}
        for name, n in launches.items():
            if (n > 0) != (name in path_kernels):
                raise AssertionError(f"stream 2^26 {tag}: {name} launched {n} times")
        check_hash_launches(launches, TREE_LAUNCHES_STREAM, f"stream 2^26 {tag[0]}")
        got = P.wire.serialize_proof(spec, pf)
        if got != data:
            raise AssertionError(f"stream 2^26 {tag}: proof bytes differ")
        if tag.startswith("c") and pf.verify(root, outer, inner, enc, transcript(root)) != value:
            raise AssertionError("stream 2^26: the streamed proof's evaluation differs")
        log(f"  stream 2^26 ({tag}): row block {cs.row_block}, root and {len(got)} proof bytes "
            f"equal; commit_streaming {cs_ms:.1f} ms, prove {pf_ms:.1f} ms; launches {launches}")
        out.append({"case": tag, "row_block": cs.row_block, "commit_ms": cs_ms, "prove_ms": pf_ms,
                    "launches": launches})
        del cs, pf
        torch.cuda.empty_cache()
    del packed, limbs, host
    torch.cuda.empty_cache()
    return {"in_memory_commit_ms": c_ms, "in_memory_prove_ms": p_ms, "proof_bytes": len(data),
            "cases": out}


def path_2_28(torch, kb, P, counters, b3, nttm, gen, card):
    """Phase 9: the slice's path at 2^28 (see the module docstring)."""
    from lcpc_tpu_torch.ops.limbs import get_ops

    spec = P.FT255
    ops = get_ops(spec)
    enc = P.LigeroEncoding.new(spec, N_BIG, *LIGERO_RHO)
    n_rows = -(-N_BIG // enc.n_per_row)
    log(f"path 2^28: ligero ft255 rho={LIGERO_RHO[0]}/{LIGERO_RHO[1]}, {n_rows} rows x "
        f"{enc.n_per_row} coefficients, {enc.n_cols} columns, {enc.get_n_col_opens()} "
        f"column openings, {enc.get_n_degree_tests()} degree test(s)")
    coeffs, gen_ms = time_host(torch, lambda: random_packed_coeffs(torch, spec, N_BIG, gen))
    x_pt = 0x9E3779B97F4A7C15
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
    want, eval_ms = time_host(torch, lambda: device_eval(
        torch, ops, coeffs.reshape(coeffs.shape[0], n_rows, enc.n_per_row), outer, inner, 256))
    log(f"  coefficients made on the card ({coeffs.numel() * 4 / 2**30:.2f} GiB packed) in "
        f"{gen_ms:.1f} ms; the evaluation in the other order in {eval_ms:.1f} ms")
    transcript = transcript_for(P, enc)

    def run():
        comm, c_ms = time_host(torch, lambda: P.commit_streaming(coeffs, enc))
        root = comm.get_root()
        proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
        value, v_ms = time_host(
            torch, lambda: proof.verify(root, outer, inner, enc, transcript(root)))
        return comm, proof, value, (c_ms, p_ms, v_ms)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    comm, proof, value, cold = run()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path 2^28 cold: commit {cold[0]:.1f} ms, prove {cold[1]:.1f} ms, verify "
        f"{cold[2]:.1f} ms; launches {launches}; row block {comm.row_block}, words kept on "
        f"the card: {comm.words_dev is not None}; peak device memory {peak:.2f} GiB")
    # prove collapses through mont_dot; verify (2^19 columns) takes the
    # route protocol.VERIFY_COLS_MIN picks: at the opened columns (the power
    # table, mont_dot's tile kernel) or through the encode (the NTT)
    for name, n in launches.items():
        if (n > 0) != (name in ligero_kernels(enc.n_cols) | {"blake3_chunks", *TREES}):
            raise AssertionError(f"path 2^28: {name} launched {n} times")
    tables = 1 if verify_at_columns(enc.n_cols) else 0
    if launches["power_table"] != tables:
        raise AssertionError(f"path 2^28: power_table launched {launches['power_table']} times, "
                             f"not {tables}")
    check_hash_launches(launches, TREE_LAUNCHES_PATH, "path 2^28")
    if comm.words_dev is None:
        raise AssertionError("path 2^28: the words were not kept on the card")
    if value != want:
        raise AssertionError("path 2^28: verify's evaluation != the evaluation on the card")
    log("  verify returned the evaluation computed on the card in the other order: ok")
    root = comm.get_root()
    data = P.wire.serialize_proof(spec, proof)
    log(f"  proof {len(data)} bytes")
    tamper_checks(P, spec, data, root, outer, inner, enc, transcript, "path 2^28", P.BLAKE3)
    routes = verify_routes(torch, P, enc, data, root, outer, inner, transcript, "path 2^28")

    # the retained words hashed in memory: equal to the streamed leaves; the
    # kernels timed at the 2^28 commit's shape
    words = comm.words_dev
    leaves = b3.hash_word_columns(words)
    if not torch.equal(leaves, comm.hashes_dev[:, : enc.n_cols]):
        raise AssertionError("path 2^28: in-memory hash of the kept words != streamed leaves")
    (k1_b, k1_c), (k2_b, k2_c) = hash_cost(words.shape[0], words.shape[1])
    n_chunks = -(-(8 + words.shape[0]) // 256)
    cvs = torch.empty((n_chunks, 8, words.shape[1]), dtype=torch.int32, device="cuda")
    final_len = 8 + words.shape[0] - 256 * (n_chunks - 1)
    k1_ms = kb.time_kernel(lambda: b3.blake3_chunks(words, cvs, final_len=final_len), reps=3)
    # the chunk tree at the commit's shape against its plain version, by
    # column slices (the plain version's int64 temporaries at full width
    # would take ~8 GB beside the kept words)
    tree = b3.merge_chunk_cvs(cvs)
    tree_plain_ms = 0.0
    for c0 in range(0, cvs.shape[2], 1 << 16):
        part, ms = time_host(torch, lambda: b3.merge_chunk_cvs_plain(cvs[:, :, c0 : c0 + (1 << 16)]))
        tree_plain_ms += ms
        if not torch.equal(tree[:, c0 : c0 + (1 << 16)], part):
            raise AssertionError(f"path 2^28: chunk tree != plain at columns {c0}..")
    k2_ms = kb.time_kernel(lambda: b3.merge_chunk_cvs(cvs), reps=3)
    hashes = {"k1_ms": k1_ms, "k2_ms": k2_ms, "k1_compressions": k1_c, "k1_bytes": k1_b,
              "k2_compressions": k2_c, "k2_bytes": k2_b, "k2_launches": 1,
              "k2_plain_ms": tree_plain_ms,
              "k2_host_ms": host_ms(torch, lambda: b3.merge_chunk_cvs(cvs), reps=5)}
    hashes["k1_bound_ms"], hashes["k1_bound_by"] = hash_bound_ms(k1_b, k1_c)
    hashes["k2_bound_ms"], hashes["k2_bound_by"] = hash_bound_ms(k2_b, k2_c)
    log(f"  the kept words hashed in memory: equal to the streamed leaves; blake3_chunks "
        f"{k1_ms:.4f} ms ({words.shape[1]} columns x {n_chunks} chunks, bound "
        f"{hashes['k1_bound_ms']:.4f} ms, {hashes['k1_bound_by']}); chunk tree equal to plain, "
        f"1 launch, device {k2_ms:.4f} ms, host wall {hashes['k2_host_ms']:.4f} ms (bound "
        f"{hashes['k2_bound_ms']:.4f} ms, {hashes['k2_bound_by']}; plain {tree_plain_ms:.1f} ms)")
    del cvs, leaves, tree

    # one row block of the encode: words only against limbs and words, and
    # three of its rows against the plain version
    rb = comm.row_block
    block = comm.source.block(0, rb)
    only = enc.encode_rows_words_only(block)
    plan = nttm.get_ntt(spec, enc.n_cols)
    if not torch.equal(only, nttm.ntt_forward(plan, block, output="both")[1]):
        raise AssertionError("path 2^28: words-only block != the limbs-and-words call")
    rows = torch.tensor([0, rb // 2, rb - 1], device="cuda")
    sub = block.index_select(1, rows)
    if not torch.equal(only.reshape(rb, -1, enc.n_cols).index_select(0, rows).reshape(
            -1, enc.n_cols), plain_ntt(nttm, plan, sub, True)[1]):
        raise AssertionError("path 2^28: words-only block rows != plain")
    blk_ms = kb.time_kernel(lambda: enc.encode_rows_words_only(block), reps=3)
    log(f"  one {rb}-row block of the encode (n = 2^{plan.log_n}, {plan.launches_per_call} "
        f"passes), words only: equal to the limbs-and-words call and (rows 0, {rb // 2}, "
        f"{rb - 1}) to plain; {blk_ms:.4f} ms")
    del comm, proof, words, block, only, sub
    torch.cuda.empty_cache()

    warm = []
    for _ in range(BIG_WARM):
        if time.perf_counter() - T_START > BIG_WARM_DEADLINE_S:
            log(f"  path 2^28: {len(warm)} warm runs, not {BIG_WARM}: the run is at "
                f"{time.perf_counter() - T_START:.0f} s")
            break
        comm, proof, value, t = run()
        if value != want:
            raise AssertionError("path 2^28: warm run's evaluation differs")
        warm.append(t)
        del comm, proof
        torch.cuda.empty_cache()
    med = [statistics.median(t[i] for t in warm) if warm else None for i in range(3)]
    for i, name in enumerate(("commit", "prove", "verify")):
        log(f"streaming_ligero_{name}_ms_median_2^28_ft255: "
            f"{med[i] if med[i] is None else round(med[i], 1)} "
            f"(warm runs {[round(t[i], 1) for t in warm]}; cold {cold[i]:.1f}; {card})")
    del coeffs
    torch.cuda.empty_cache()
    return {"launches": launches, "cold": cold, "warm": warm, "median": med, "peak_gib": peak,
            "proof_bytes": len(data), "row_block": rb, "hashes": hashes,
            "block_words_only_ms": blk_ms, "verify_routes": routes}


def gen_pack_ops(w32, w7, form):
    """ALU instructions a coefficient needs beyond its digits' threefry2x32
    and xor: each digit shifted into its word where it does not start one
    (one LEA: the bits do not overlap, so the add is an or), one more shift
    where a digit straddles two words, and for limbs the split of each word
    into its 16-bit halves (two).  Digit planes store the bytes as they are."""
    if form == "digits":
        return 0
    ops = sum(bool(7 * d % 32) + (7 * d % 32 > 25 and 7 * d // 32 + 1 < w32)
              for d in range(w7))
    return ops + (2 * w32 if form == "limbs" else 0)


def generator_mix(torch, kb, tf, tf_so, gen_so):
    """Phase 2: what the generator's function needs, by pipe, per
    coefficient: W7 digits of the threefry probe's per-step SASS
    (scripts/threefry_chain.cu: one threefry2x32 on (0, counter) and the
    xor) plus the packing (gen_pack_ops); the chunk keys (one threefry2x32
    a 2^18-coefficient chunk) are added where the bound is taken.  The
    probe's chain is first held to the plain threefry2x32.  The kernel's
    whole SASS a thread (its own index arithmetic and chunk key included)
    is logged beside.  Returns {"per_digit": (ALU, FMA, all), form: (ALU, FMA)}."""
    key, x, n = (0x13198A2E, 0x03707344), 0xA4093822, 8
    want = x
    for _ in range(n):
        x0, x1 = tf.threefry2x32_plain(key[0], key[1], torch.tensor([0]), torch.tensor([want]))
        want = int(x0[0]) ^ int(x1[0])
    got = kb.threefry_chain(tf_so, key, x, n)
    if got != want:
        raise AssertionError(f"threefry probe: {got:#x} != plain {want:#x}")
    found = kb.threefry_sass_mix(tf_so)
    if found is None:
        raise RuntimeError("cuobjdump not found: the generator's bound cannot be counted")
    digit, opcodes = found
    w32, w7 = 8, 37
    log(f"  SASS threefry probe (equal to plain over {n} steps): a digit is {digit[0]:g} "
        f"ALU-pipe + {digit[1]:g} FMA-pipe of {digit[2]:g} instructions; loop opcodes "
        f"{opcodes}")
    mix = {"per_digit": digit}
    for i, form in enumerate(tf.FORMS):
        pack = gen_pack_ops(w32, w7, form)
        mix[form] = (w7 * digit[0] + pack, w7 * digit[1])
        whole = kb.sass_mix(gen_so, f"seeded_gen_kernelILi8ELi37ELi{i}E")
        log(f"  seeded_gen W32=8 {form}: the function needs {w7} digits + {pack} packing = "
            f"{mix[form][0]:g} ALU-pipe + {mix[form][1]:g} FMA-pipe a coefficient "
            f"({compression_s(*mix[form]) * 1e12:.1f} ps); the kernel's SASS a thread "
            f"{whole[0]} + {whole[1]} of {whole[2]} instructions "
            f"({compression_s(whole[0], whole[1]) * 1e12:.1f} ps)")
    return mix


def gen_bound(n_elem, out_bytes, mix, form, chunk=1 << 18):
    """(ms, by) of the generator: its output written once over the memory
    rate against what its function needs on the integer pipes: n_elem
    coefficients of mix[form] and one threefry2x32 a chunk key (the
    probe's digit, whose xor stands in for fold_in's word select)."""
    t_bytes = out_bytes / HBM_BYTES_PER_S * 1e3
    digit, n_chunks = mix["per_digit"], -(-n_elem // chunk)
    t_ops = (n_elem * compression_s(*mix[form]) + n_chunks * compression_s(*digit[:2])) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dot_bound(spec, x, y, a, k, b):
    """(ms, by, IMAD ms) of a mont_dot: the card's least time for the work,
    x and y read once and the (W/2, a, b) words written once against the
    (2W)^2 byte products a multiply-add on the u8 tensor cores, whichever
    kernel runs it; the CUDA cores' (W/2)^2 wide products beside."""
    w32 = spec.w16 // 2
    nbytes = x.numel() * x.element_size() + y.numel() * y.element_size() + 4 * w32 * a * b
    _, t_bytes, t_imad = bound_ms(nbytes, a * k * b * w32 * w32)
    t_ops = 2 * a * k * b * (4 * w32) ** 2 / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_imad


def table_bound(spec, big_k, k):
    """(ms, by) of a power table (either layout, the same bytes): its words
    written once; one Montgomery product (2 W32^2 + W32 wide products) an
    entry."""
    w32 = spec.w16 // 2
    b_ms, t_bytes, t_ops = bound_ms(4 * w32 * (big_k * k + k),
                                    big_k * k * (2 * w32 * w32 + w32))
    return b_ms, ("bytes" if t_bytes >= t_ops else "operations")


def prove_kernels_phase(torch, kb, P, tf, md, gen, gen_mix):
    """Phase 10: the generator, mont_dot and the power table against their
    plain versions on the card, bit for bit, at the main paths' shapes and
    on edge cases; each timed beside its bound.  Returns the records."""
    from lcpc_tpu_torch.ops.spmv import pack_words, unpack_words

    spec = P.FT255
    w32, w7, chunk = spec.w16 // 2, (spec.num_bits + 6) // 7, 1 << 18
    recs, errs = {}, [0]

    def check(tag, got, want):
        err = max_err(torch, got, want)
        errs[0] = max(errs[0], err)
        if err or not torch.equal(got, want):
            raise AssertionError(f"{tag}: kernel != plain (max err {err})")

    def gen_plain(key, i0, i1, length, form, field=spec):
        fw7 = (field.num_bits + 6) // 7
        c0, c1 = i0 // chunk, -(-i1 // chunk)
        d = tf.seeded_digits_plain(key, c0, c1 - c0, chunk, fw7, tf.digit_masks(field),
                                   device=DEV)[:, i0 - c0 * chunk : i1 - c0 * chunk].clone()
        if length < i1:
            d[:, max(0, length - i0):] = 0
        if form == "digits":
            return d
        words = tf.digits_to_words_plain(d, field.w16 // 2)
        return words if form == "packed" else unpack_words(words, 0)

    log("seeded_gen, mont_dot and power_table vs plain: tolerance 0 — the generator's bits "
        "and exact field arithmetic, every word equal")
    key, n = tf.prng_key(SEED), GEN_CHECK
    digits, digits_ms = time_host(torch, lambda: gen_plain(key, 0, n, n, "digits"))
    for form in tf.FORMS:
        got = tf.seeded_digits(spec, key, 0, n, n, chunk, form=form, device=DEV)
        want, ms = time_host(torch, lambda: digits if form == "digits" else (
            tf.digits_to_words_plain(digits, w32) if form == "packed"
            else unpack_words(tf.digits_to_words_plain(digits, w32), 0)))
        plain_ms = digits_ms + ms
        check(f"seeded_gen {form}", got, want)
        ms = kb.time_kernel(lambda: tf.seeded_digits(spec, key, 0, n, n, chunk, form=form,
                                                     device=DEV))
        out_bytes = n * {"digits": w7, "limbs": 4 * spec.w16, "packed": 4 * w32}[form]
        bound, by = gen_bound(n, out_bytes, gen_mix, form)
        recs[f"gen_{form}"] = {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                               "bound_by": by, "out_bytes": out_bytes}
        log(f"  seeded_gen {form}: {n} ft255 coefficients equal to plain; {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), plain {plain_ms:.1f} ms")
    big = tf.prng_key((1 << 40) + 3)
    length = 3 * chunk + 12_345
    whole = tf.seeded_digits(spec, big, 0, 4 * chunk, length, chunk, form="limbs", device=DEV)
    check("seeded_gen seed 2^40+3 with a zero tail", whole, gen_plain(big, 0, 4 * chunk, length,
                                                                      "limbs"))
    for cuts in ((0, chunk, 2 * chunk, 4 * chunk), (0, 1000, 300_001, 4 * chunk - 7, 4 * chunk)):
        parts = [tf.seeded_digits(spec, big, a, b, length, chunk, form="limbs", device=DEV)
                 for a, b in zip(cuts, cuts[1:])]
        check(f"seeded_gen partition {cuts}", torch.cat(parts, dim=1), whole)
    for field in P.ALL_FIELDS:
        for form in tf.FORMS:
            check(f"seeded_gen {field.name} {form}",
                  tf.seeded_digits(field, big, 77, 5_000, 4_000, chunk, form=form, device=DEV),
                  gen_plain(big, 77, 5_000, 4_000, form, field))
    log("  seeded_gen: seed 2^40+3 with a zero tail, chunk-aligned and unaligned partitions "
        "equal; every field and form on an edge range equal")

    def rand(field, a, k, form="limbs"):
        x = kb.random_mont(field, (a, field.w16, k), gen, device=DEV).permute(1, 0, 2).contiguous()
        return x if form == "limbs" else pack_words(x, 0)

    def dot(tag, x, y, out_form, x_form, y_form, timed=True, reps=10, field=spec, kernel=None):
        """mont_dot by its route (or `kernel`) against mont_dot_plain; timed
        beside the card's bound and the CUDA cores' wide products."""
        kw = {} if kernel is None else {"_route": kernel}
        a, k = x.shape[1], x.shape[2]
        b = y.shape[1] if y_form == "planes" else y.shape[2]
        kern = kernel or md.route(a, k, b, y_form)
        got = md.mont_dot(field, x, y, out_form, x_form=x_form, y_form=y_form, **kw)
        want, plain_ms = time_host(torch, lambda: md.mont_dot_plain(
            field, x, y, out_form, x_form=x_form, y_form=y_form))
        check(f"mont_dot {tag} ({kern})", got, want)
        if not timed:
            return
        ms = kb.time_kernel(lambda: md.mont_dot(field, x, y, out_form, x_form=x_form,
                                                y_form=y_form, **kw), reps=reps)
        bound, by, imad = dot_bound(field, x, y, a, k, b)
        recs[f"dot {tag}"] = {"a": a, "k": k, "b": b, "out_form": out_form, "kernel": kern,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                              "imad_bound_ms": imad, "bound_share": bound / ms}
        log(f"  mont_dot {tag} ({a} x {k} x {b}, {out_form}, {kern}): equal; {ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by}, {bound / ms:.1%}; the CUDA cores' wide products "
            f"{imad:.4f} ms), plain {plain_ms:.1f} ms")

    # the collapses: the thin tensor-core kernel at its shapes, the CUDA
    # cores' kernel beside; Brakedown's odd row stride (235,173 words) read
    # in place by both
    n23 = N_COEFFS // 256
    x, y = rand(spec, 2, 256, "packed"), rand(spec, 256, n23)
    dot("2^23 prove collapse", x, y, "canonical", "packed", "limbs")
    dot("2^23 prove collapse on the CUDA cores", x, y, "canonical", "packed", "limbs",
        kernel="thin")
    x, y = rand(spec, 2, 36, "packed"), rand(spec, 36, 235_173)
    dot("2^23 brakedown collapse", x, y, "canonical", "packed", "limbs")
    dot("2^23 brakedown collapse on the tensor cores", x, y, "canonical", "packed", "limbs",
        kernel="thin_tc")
    x, y = rand(spec, 2, 64, "packed"), rand(spec, 64, N_SEEDED // 2048, "packed")
    dot("2^29 collapse, a 64-row block", x, y, "canonical", "packed", "packed",
        kernel="thin_tc", reps=5)
    x, y = rand(spec, 2, 256), rand(spec, 256, 189, "packed")
    dot("2^23 verify column check", x, y, "mont", "limbs", "packed")
    dot("2^23 verify column check on the CUDA cores", x, y, "mont", "limbs", "packed",
        kernel="thin")
    del x, y
    g = pack_words(kb.random_mont(spec, (1, spec.w16, 189), gen, device=DEV)[0], 0)
    # the table as digit planes at the verify's and the prover's shapes,
    # each with the tile kernel's product there
    for tag, big_k in (("2^23 verify", n23), ("2^28 verify", N_BIG // 2048),
                       ("2^29 prove", N_SEEDED // 2048)):
        table = md.power_table(spec, g, big_k)
        want, plain_ms = time_host(torch, lambda: md.power_table_plain(spec, g, big_k))
        check(f"power_table {tag}", table, want)
        del want
        ms = kb.time_kernel(lambda: md.power_table(spec, g, big_k), reps=5)
        bound, by = table_bound(spec, big_k, 189)
        recs[f"table {tag}"] = {"K": big_k, "k": 189, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": by}
        log(f"  power_table {tag} ({big_k} x 189, digit planes): equal; {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), plain {plain_ms:.1f} ms")
        if tag.startswith("2^23"):
            dot("2^23 verify rows at the columns", rand(spec, 2, big_k), table, "mont", "limbs",
                "planes")
        elif tag.startswith("2^29"):
            dot(f"2^29 column evaluation, a {EVAL_ROWS}-row block", rand(spec, EVAL_ROWS, big_k,
                                                                          "packed"),
                table, "mont", "packed", "planes", reps=3)
        del table
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count if DEV == "cuda" else 132
    for field in P.ALL_FIELDS:
        for a, k, b in ((3, 1, 5), (37, 70, 45), (1, 5_000, 1), (33, 33, 33), (2, 3_000, 189),
                        (37, 300, 189), (5, 300, 190)):
            for out_form in md.OUT_FORMS:
                x, y = rand(field, a, k), rand(field, k, b, "packed")
                dot(f"edge {field.name} {a}x{k}x{b}", x, y, out_form, "limbs", "packed",
                    timed=False, field=field)
                dot(f"edge {field.name} {a}x{k}x{b} planes", pack_words(x, 0),
                    md.to_planes(field, y), out_form, "packed", "planes", timed=False,
                    field=field)
        # both thin kernels on ragged shapes, y as words and as limbs, by TMA
        # (row stride a multiple of 4) and word by word (misaligned), one K
        # range and several
        for a, k, b in ((1, 1, 5), (2, 37, 19), (1, 70, 45), (2, 300, 129), (2, 3_000, 70),
                        (1, 129, 1_000), (2, 2_049, 300)):
            x = rand(field, a, k)
            for y_form in md.FORMS:
                big = rand(field, k, -(-(b + 1) // 4) * 4, y_form)
                for y in (big[:, :, :b], big[:, :, 1 : b + 1]):
                    for out_form in md.OUT_FORMS:
                        for kernel in ("thin_tc", "thin"):
                            dot(f"thin edge {field.name} {a}x{k}x{b} {y_form} "
                                f"tma={md.thin_tc_tma(y)}", x, y, out_form, "limbs", y_form,
                                timed=False, field=field, kernel=kernel)
                del big
        ones = torch.full((field.w16, 2, 300), 0xFFFF, dtype=torch.int32, device=DEV)
        dot(f"unreduced {field.name}", ones, rand(field, 300, 7), "canonical", "limbs", "limbs",
            timed=False, field=field)
        dot(f"unreduced {field.name} planes", torch.full((field.w16, 37, 300), 0xFFFF,
                                                          dtype=torch.int32, device=DEV),
            md.to_planes(field, rand(field, 300, 7), "limbs"), "canonical", "limbs", "planes",
            timed=False, field=field)
        # the thin tensor-core kernel's 32-bit fold at its range limit:
        # all-0xFF words (every value R - 1) across a range's k-steps
        for y_form, cap in (("packed", md.thin_tc_cap(False)), ("limbs", md.thin_tc_cap(True))):
            for k in (cap - 1, cap, cap + 1):
                x = torch.full((field.w16 // 2, 2, k), -1, dtype=torch.int32, device=DEV)
                y = (torch.full((field.w16 // 2, k, 300), -1, dtype=torch.int32, device=DEV)
                     if y_form == "packed" else
                     torch.full((field.w16, k, 300), 0xFFFF, dtype=torch.int32, device=DEV))
                for out_form in md.OUT_FORMS:
                    dot(f"all-0xFF {field.name} 2x{k}x300 {y_form}", x, y, out_form, "packed",
                        y_form, timed=False, field=field, kernel="thin_tc")
        # the table's edges: K around a k-tile and past a 32-tile run, k
        # from one point to Brakedown's opening count
        for k in TABLE_EDGE_k:
            gg = pack_words(kb.random_mont(field, (1, field.w16, k), gen, device=DEV)[0], 0)
            for big_k in TABLE_EDGE_K:
                check(f"power_table {field.name} {big_k} x {k}", md.power_table(field, gg, big_k),
                      md.power_table_plain(field, gg, big_k))
    # the s32 accumulators' limit: all-0xFF bytes (every value R - 1) over
    # K = 2^15 - 1, 2^15, 2^15 + 1 at a shape whose grid needs no further
    # split, so a block's range is the fold limit itself
    a, b = 64, 17 * (256 // (2 * spec.w16))
    for k in (md.FOLD_K - 1, md.FOLD_K, md.FOLD_K + 1):
        k_split, n_split = md.tc_split(spec, a, k, b, n_sm)
        if n_split != -(-k // md.FOLD_K) or k_split > md.FOLD_K:
            raise AssertionError(f"K = {k}: split ({k_split}, {n_split}), not the fold limit's")
        x = torch.full((spec.w16, a, k), 0xFFFF, dtype=torch.int32, device=DEV)
        y = torch.full((md.plane_tiles(k), b, 2 * spec.w16, md.TC_KT), 0xFF, dtype=torch.uint8,
                       device=DEV)
        for out_form in md.OUT_FORMS:
            dot(f"all-0xFF {a}x{k}x{b}", x, y, out_form, "limbs", "planes", timed=False)
        log(f"  mont_dot all-0xFF {a} x {k} x {b} (K ranges of {k_split}, {n_split} of them) "
            f"equal")
        del x, y
    log("  mont_dot edges (3x1x5, 37x70x45, 1x5000x1, 33x33x33, 2x3000x189, 37x300x189, "
        "5x300x190, both outputs, y as words and as planes; all-0xFFFF operands), both thin "
        "kernels on ragged shapes (y words and limbs, by TMA and word by word) and all-0xFF "
        f"across the thin tensor-core kernel's range limit, and power_table edges (K "
        f"{TABLE_EDGE_K} x k {TABLE_EDGE_k}) equal in every field")
    recs["max_abs_err"] = errs[0]
    return recs


def seeded_eval(torch, ops, src, outer, inner, rb):
    """Σ_r outer[r] (Σ_j inner[j] c[r, j]) over the seeded source's
    regenerated limb blocks, rows against the inner tensor first, with the
    PLAIN collapse (FieldOps.collapse_canon_plain): no mont_dot in it."""
    import numpy as np

    def limbs(vals):
        return torch.from_numpy(ops.encode_host(vals).astype(np.int32)).to(DEV)[:, None, :]

    inner_t, parts = limbs(inner), []
    for r0 in range(0, src.n_rows, rb):
        blk = src.block(r0, min(r0 + rb, src.n_rows))
        parts.append(ops.collapse_canon_plain(inner_t, blk.permute(0, 2, 1)))  # (W, 1, m)
        del blk
    rows = ops.to_mont_plain(torch.cat(parts, dim=2))
    v = ops.collapse_canon_plain(limbs(outer), rows.permute(0, 2, 1))
    return int.from_bytes(v.reshape(-1).cpu().numpy().astype("<u2").tobytes(), "little")


def path_2_29(torch, kb, P, counters, md, card):
    """Phase 11: the seeded path at 2^29 (see the module docstring)."""
    import random

    from lcpc_tpu_torch.core import streaming
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.ops.mxu_prove import MxuColumnEval, _packed_ints

    spec = P.FT255
    ops = get_ops(spec)
    src = P.SeededCoeffSource(spec, N_SEEDED, seed=SEED, device=DEV)
    enc = P.LigeroEncoding.new(spec, N_SEEDED, *LIGERO_RHO, device=DEV)
    n_rows = -(-N_SEEDED // enc.n_per_row)
    wpe = spec.w16 // 2
    log(f"path 2^29: seeded ligero ft255 rho={LIGERO_RHO[0]}/{LIGERO_RHO[1]}, {n_rows} rows x "
        f"{enc.n_per_row} coefficients, {enc.n_cols} columns, {enc.get_n_col_opens()} column "
        f"openings, {enc.get_n_degree_tests()} degree test(s); hash words "
        f"{n_rows * wpe * enc.n_cols * 4 / 1e9:.1f} GB")
    x_pt = 0x243F6A8885A308D3
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
    src.set_dims(n_rows, enc.n_per_row)
    want, want_ms = time_host(torch, lambda: seeded_eval(torch, ops, src, outer, inner, 128))
    log(f"  the evaluation over regenerated blocks with the plain collapse, rows first: "
        f"{want_ms:.1f} ms")
    transcript = transcript_for(P, enc)

    def run():
        comm, c_ms = time_host(torch, lambda: P.commit_streaming(src, enc))
        root = comm.get_root()
        proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
        value, v_ms = time_host(
            torch, lambda: proof.verify(root, outer, inner, enc, transcript(root)))
        return comm, proof, value, (c_ms, p_ms, v_ms)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    comm, proof, value, cold = run()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path 2^29 cold: commit {cold[0]:.1f} ms, prove {cold[1]:.1f} ms, verify "
        f"{cold[2]:.1f} ms; launches {launches}; row block {comm.row_block}; peak device "
        f"memory {peak:.2f} GiB")
    path_kernels = {"seeded_gen", "ntt_mont", "blake3_chunks", *TREES, "mont_dot", "power_table",
                    *DOT_KERNELS, "mont_mul_map"}  # verify's conversions
    for name, n in launches.items():
        if (n > 0) != (name in path_kernels):
            raise AssertionError(f"path 2^29: {name} launched {n} times")
    check_hash_launches(launches, TREE_LAUNCHES_PATH, "path 2^29")
    if comm.words_dev is not None or comm.words_host is not None:
        raise AssertionError("path 2^29: hash words were kept")
    log("  no hash words kept (words_dev and words_host None): prove evaluated the opened "
        "columns directly")
    if value != want:
        raise AssertionError("path 2^29: verify's evaluation != the plain evaluation")
    log("  verify returned the evaluation computed with the plain collapse in the other "
        "order: ok")
    root = comm.get_root()
    data = P.wire.serialize_proof(spec, proof)
    log(f"  proof {len(data)} bytes")
    tamper_checks(P, spec, data, root, outer, inner, enc, transcript, "path 2^29", P.BLAKE3)
    routes = verify_routes(torch, P, enc, data, root, outer, inner, transcript, "path 2^29")
    del proof

    # the opening both ways at this shape, and the prove's pieces timed
    rng = random.Random(SEED)
    cols = [rng.randrange(enc.n_cols) for _ in range(enc.get_n_col_opens())]
    by_eval, eval_open_ms = time_host(torch, lambda: streaming._open_by_eval(comm, cols))
    by_enc, reencode_ms = time_host(torch, lambda: streaming._open_by_reencode(comm, cols))
    if not torch.equal(by_eval, by_enc):
        raise AssertionError("path 2^29: _open_by_eval's columns != _open_by_reencode's")
    del by_eval, by_enc
    log(f"  {len(cols)} columns opened by direct evaluation ({eval_open_ms:.1f} ms) equal the "
        f"re-encode's ({reencode_ms:.1f} ms)")
    get_block, form, bpe = streaming._prove_block_source(comm)
    ev = MxuColumnEval(enc)
    ev.set_columns(cols)
    rb = streaming._prove_row_block(comm, bpe, ev.table_bytes)
    gen_ms = kb.time_kernel(lambda: get_block(0, rb), reps=2)
    blk = get_block(0, rb)
    eval_ms = kb.time_kernel(lambda: ev.eval_block(blk, in_form=form), reps=1)
    ts = _packed_ints(spec, [outer, outer], DEV)[:, :, :rb]
    collapse_ms = kb.time_kernel(lambda: md.mont_dot(spec, ts, blk, y_form=form), reps=2)
    collapse_route = md.route(2, rb, enc.n_per_row, form)
    collapse_bound = dot_bound(spec, ts, blk, 2, rb, enc.n_per_row)
    table_ms = host_ms(torch, lambda: ev.set_columns(cols), reps=3)
    # verify's rows at the opened columns by the route it takes: the two
    # proof rows against the planes table on the tile kernel
    rows2 = kb.random_mont(spec, (2, spec.w16, enc.n_per_row), torch.Generator(
        device=DEV).manual_seed(SEED), device=DEV).permute(1, 0, 2).contiguous()
    verify_rows_ms = kb.time_kernel(lambda: ev.eval_block(rows2), reps=3)
    verify_rows_route = md.route(2, enc.n_per_row, len(cols), "planes")
    del rows2
    scale = n_rows / rb
    pieces = {"prove_row_block": rb, "gen_block_ms": gen_ms, "eval_block_ms": eval_ms,
              "collapse_block_ms": collapse_ms, "collapse_route": collapse_route,
              "collapse_block_bound_ms": collapse_bound[0],
              "collapse_block_bound_by": collapse_bound[1],
              "collapse_block_imad_bound_ms": collapse_bound[2],
              "collapse_bound_share": collapse_bound[0] / collapse_ms,
              "verify_rows_ms": verify_rows_ms, "verify_rows_route": verify_rows_route,
              "set_columns_host_ms": table_ms,
              "eval_all_rows_ms": eval_ms * scale, "collapse_all_rows_ms": collapse_ms * scale,
              "gen_all_rows_ms": gen_ms * scale, "open_by_eval_ms": eval_open_ms,
              "open_by_reencode_ms": reencode_ms}
    k = len(cols)
    # the evaluation on the tensor cores: (2W)^2 byte products a multiply-add;
    # the CUDA cores' wide products beside
    t_bytes = 4 * wpe * (n_rows * enc.n_per_row + enc.n_per_row * k + n_rows * k) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_rows * enc.n_per_row * k * (4 * wpe) ** 2 / INT8_OPS_PER_S * 1e3
    pieces["eval_bound_ms"] = max(t_bytes, t_ops)
    pieces["eval_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    pieces["eval_imad_bound_ms"] = n_rows * enc.n_per_row * k * wpe * wpe \
        / WIDE_PRODUCTS_PER_S * 1e3
    pieces["eval_bound_share"] = pieces["eval_bound_ms"] / pieces["eval_all_rows_ms"]
    log(f"  prove's pieces ({rb}-row blocks, x {scale:g} for all rows): seeded_gen packed "
        f"{gen_ms:.2f} ms, mont_dot collapse {collapse_ms:.2f} ms ({collapse_route}; bound "
        f"{collapse_bound[0]:.2f} ms, {collapse_bound[1]}, "
        f"{pieces['collapse_bound_share']:.1%}; IMAD {collapse_bound[2]:.2f} ms), column "
        f"evaluation "
        f"{eval_ms:.2f} ms (all rows {eval_ms * scale:.1f} ms, tensor-core bound "
        f"{pieces['eval_bound_ms']:.1f} ms, {pieces['eval_bound_share']:.1%}; the CUDA cores' "
        f"wide products {pieces['eval_imad_bound_ms']:.1f} ms), set_columns with its power "
        f"table {table_ms:.2f} ms; verify's two rows at the {len(cols)} columns "
        f"{verify_rows_ms:.4f} ms ({verify_rows_route})")
    del blk, ev, ts, comm
    torch.cuda.empty_cache()

    warm = []
    for _ in range(SEEDED_WARM):
        if time.perf_counter() - T_START > SEEDED_WARM_DEADLINE_S:
            log(f"  path 2^29: {len(warm)} warm runs, not {SEEDED_WARM}: the run is at "
                f"{time.perf_counter() - T_START:.0f} s")
            break
        comm, proof, value, t = run()
        if value != want:
            raise AssertionError("path 2^29: warm run's evaluation differs")
        warm.append(t)
        del comm, proof
        torch.cuda.empty_cache()
    med = [statistics.median(t[i] for t in warm) if warm else None for i in range(3)]
    for i, name in enumerate(("commit", "prove", "verify")):
        log(f"seeded_ligero_{name}_ms_median_2^29_ft255: "
            f"{med[i] if med[i] is None else round(med[i], 1)} "
            f"(warm runs {[round(t[i], 1) for t in warm]}; cold {cold[i]:.1f}; Rust on 64 cores "
            f"{RUST_2_29[i]:g} ms, BASELINE.md; {card})")
    return {"launches": launches, "cold": cold, "warm": warm, "median": med, "peak_gib": peak,
            "proof_bytes": len(data), "row_block": rb, "pieces": pieces,
            "plain_eval_ms": want_ms, "verify_routes": routes}



def blake3_mix(kb, chain_so, lib_so):
    """Phase 2: one BLAKE3 compression's instructions by pipe, from the SASS
    of the latency probe's loop body (kb.CHAIN_PER_TRIP compressions) and
    of each library kernel's longest straight-line block (per compression
    it holds).  The least time any of them gives sets B3_COMPRESSION_S: no
    kernel's compression issues less."""
    global B3_COMPRESSION_S
    mix = kb.blake3_sass_mix(chain_so, lib_so, B3_KERNELS)
    if mix is None:
        raise RuntimeError("cuobjdump not found: the BLAKE3 bound cannot be counted")
    counts = {"probe": mix["chain"], **mix["kernels"]}
    for name, (a, f, t, *n) in counts.items():
        log(f"  SASS {name}: a compression is {a:g} ALU-pipe + {f:g} FMA-pipe of {t:g} "
            f"instructions ({compression_s(a, f) * 1e12:.2f} ps at the card's integer rate)"
            + (f", {n[0]} in its longest block" if n else ""))
    least = min(counts, key=lambda k: compression_s(*counts[k][:2]))
    B3_COMPRESSION_S = compression_s(*counts[least][:2])
    log(f"  BLAKE3 bound: {B3_COMPRESSION_S * 1e12:.2f} ps a compression ({least}; 680 "
        f"instructions on one pipe were {680 / INT_OPS_PER_S * 1e12:.2f} ps); probe loop "
        f"opcodes {mix['chain_opcodes']}")
    if mix["chain"][0] < 400:
        raise AssertionError(f"the probe's compression is not on the vector ALU: {mix['chain']}")
    return {"per_compression_alu_fma_all": counts, "least": least,
            "chain_opcodes": mix["chain_opcodes"], "compression_ps": B3_COMPRESSION_S * 1e12}


def tree_rows(hashes, big, sdig, lig, b3_ptxas, size, b3_mix):
    """The kernel table rows of the three BLAKE3 tree kernels: each one
    launch, timed at the 2^23 Ligero commit's shape (the walk at its
    verify's), with the other shapes, the host wall, the dependency floor
    and ptxas's report beside."""
    c23 = hashes["2^23 commit"]["tree"]
    m17, w189 = hashes[f"merkle {MERKLE_TREES[0][0]}"], hashes[f"walk {WALKS[0][0]}"]
    replaced = "redesigned from the per-level blake3_parents kernel (one launch per tree level)"

    def ptx(*names):
        return {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                for k, v in sorted(b3_ptxas.items()) if any(n in k for n in names)}

    def row(name, replaces, rec, shape, **extra):
        return {"name": name, "route": "cuda", "source": "lcpc_tpu_torch/csrc/blake3_cols.cu",
                "replaces": replaces, "launches": big["launches"][name],
                "max_abs_err": hashes["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None, "equal_to_plain": True,
                "tolerance": 0, "shape": shape, "host_ms": rec["host_ms"],
                "launches_2_23_paths": {"sdig": sdig[0][name], "ligero": lig[0][name]},
                "compression_latency_ms": hashes["compression_latency_ms"], "note": replaced,
                "sass_compression_alu_fma_all": b3_mix["per_compression_alu_fma_all"][
                    b3_mix["least"]][:3],
                **extra}

    return [
        row("chunk_tree",
            "lcpc_tpu/ops/blake3_jax.py:221-245 (the chunk tree) and lcpc_tpu/core/streaming.py:127 "
            "(_merge_fn); XLA-fused, not Pallas", c23,
            f"the {size} ligero commit's chunk tree: {c23['n_cols']} columns x {c23['n']} CVs",
            floor_ms=c23["floor_ms_lanes_1"],
            ms_2_28_commit=big["hashes"]["k2_ms"], host_ms_2_28_commit=big["hashes"]["k2_host_ms"],
            bound_ms_2_28_commit=big["hashes"]["k2_bound_ms"],
            verify_shapes={tag: hashes[tag]["tree"] for tag in (
                "2^23 verify (189 columns)", "2^28 verify (189 columns)",
                "brakedown 2^23 verify (6,593 columns)", "2^28 column length")},
            ptxas=ptx("chunk_tree_stack_kernel", "chunk_tree_warp_kernel")),
        row("merkle_tree",
            "lcpc_tpu/ops/blake3_jax.py:264,275 (merkle_parent, merkle_layer) over the layer loop "
            "of lcpc_tpu/core/protocol.py:322-333 and _commit_fused_fn :345-383; XLA-fused, "
            "not Pallas", m17, f"the {size} ligero commit's tree: 2^17 leaves",
            floor_ms=m17["floor_ms"],
            other_shapes={k: v for k, v in hashes.items() if k.startswith("merkle ")},
            ptxas=ptx("merkle_tree_kernel")),
        row("merkle_walk",
            "lcpc_tpu/core/protocol.py:840-845 (_verify_core_fn's path walk) and :793 "
            "(_verify_core_cols_fn); XLA-fused, not Pallas", w189,
            f"the {size} ligero verify's walk: 189 columns x 17 levels",
            floor_ms=w189["floor_ms"], brakedown_2_23=hashes[f"walk {WALKS[1][0]}"],
            ptxas=ptx("merkle_walk_kernel")),
    ]


def map_cost(spec, n, rows_in, rows_out, products):
    """(bytes, wide products) of an elementwise map over n elements: each
    operand's rows (int32 limbs or words) read once, the output's written
    once, `products` 32 x 32 -> 64 products an element."""
    return 4 * n * (rows_in + rows_out), n * products


def mont_map_phase(torch, kb, P, mm, gen):
    """Phase 12: the field maps against their plain versions, bit for bit
    (tolerance 0), at the slice's shapes (timed beside their bound and the
    plain version) and on edges in every field; returns the records."""
    from lcpc_tpu_torch.ops.limbs import get_ops, pack_row_words
    from lcpc_tpu_torch.ops.spmv import pack_words

    recs, errs = {}, [0]

    def check(tag, kernel, plain, *args, timed=None, **kw):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{kernel.__name__} {tag}: kernel != plain")
        errs[0] = max(errs[0], max_err(torch, got, want))
        if timed is None:
            return
        nbytes, products = timed
        ms = kb.time_kernel(lambda: kernel(*args, **kw))
        _, plain_ms = time_host(torch, lambda: plain(*args, **kw))
        bound, t_bytes, t_ops = bound_ms(nbytes, products)
        recs[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "share": bound / ms, "bytes": nbytes, "products": products}
        log(f"  {kernel.__name__} {tag}: equal; {ms:.4f} ms (bound {bound:.4f} ms, "
            f"{recs[tag]['bound_by']}, {100 * bound / ms:.1f}%), plain {plain_ms:.2f} ms")

    spec = P.FT255
    w, w32 = spec.w16, spec.w16 // 2
    mul_p, from_p = 2 * w32 * w32 + w32, w32 * w32 + w32
    log("mont_map kernels vs plain: tolerance 0 — exact field arithmetic, every limb and word "
        "equal")
    # the 2^23 Brakedown commit: the codeword's limbs -> canonical hash words
    r, c = MAP_CODEWORD
    cw = kb.random_mont(spec, (r, w, c), gen, DEV).permute(1, 0, 2).contiguous()
    check("brakedown 2^23 commit: (16, 36, 357,699) limbs -> hash words", mm.mont_mul_map,
          mm.mont_mul_map_plain, spec, cw, op="from_mont", out_form="hash",
          timed=map_cost(spec, r * c, w, w32, from_p))
    check("add at the brakedown 2^23 codeword: (16, 36, 357,699) limbs", mm.mont_addsub_map,
          mm.mont_addsub_map_plain, spec, cw, cw.flip(1), op="add",
          timed=map_cost(spec, r * c, 2 * w, w, 0))
    check("sub at the brakedown 2^23 codeword", mm.mont_addsub_map, mm.mont_addsub_map_plain,
          spec, cw, cw.flip(2), op="sub")
    del cw
    # Ligero 2^23 verify's proof rows: (T, npr, W/2) words -> Montgomery words
    # (the column evaluation's input) and limbs (the full encode's)
    t, npr = MAP_VERIFY_ROWS
    rows = pack_words(kb.random_mont(spec, (t, w, npr), gen, DEV), 1).permute(0, 2, 1).contiguous()
    check("ligero 2^23 verify rows: (2, 32,768) words -> words", mm.mont_mul_map,
          mm.mont_mul_map_plain, spec, rows.permute(2, 0, 1), op="to_mont", in_form="words",
          out_form="words", timed=map_cost(spec, t * npr, w32, w32, mul_p))
    check("ligero 2^23 verify rows -> limbs", mm.mont_mul_map, mm.mont_mul_map_plain, spec,
          rows.permute(2, 0, 1), op="to_mont", in_form="words")
    # verify's opened columns: packed Montgomery words -> canonical hash words
    for (r, k), name in zip(MAP_OPENED, ("ligero", "brakedown")):
        col = pack_words(kb.random_mont(spec, (r, w, k), gen, DEV), 1).permute(1, 0, 2).contiguous()
        check(f"{name} 2^23 opened columns: ({r}, {k}) words -> hash words", mm.mont_mul_map,
              mm.mont_mul_map_plain, spec, col, op="from_mont", in_form="words",
              out_form="hash", timed=map_cost(spec, r * k, w32, w32, from_p))
    # the 2^28 streaming prove's opened columns: hash words -> Montgomery words
    r, k = MAP_STREAM_OPENED
    canon = pack_row_words(kb.random_mont(spec, (r, w, k), gen, DEV).permute(1, 0, 2).contiguous())
    check("streaming 2^28 opened columns: (2,048, 189) hash words -> words", mm.mont_mul_map,
          mm.mont_mul_map_plain, spec, canon, op="to_mont", in_form="hash", out_form="words",
          timed=map_cost(spec, r * k, w32, w32, mul_p))
    # edges in every field (every template): unreduced inputs (0, 1, p - 1,
    # p, 2p - 1, 2p, R - 1 and random values below R), one element, odd
    # counts, every form in and out, broadcast and non-contiguous operands,
    # no elements
    for field in P.ALL_FIELDS:
        ops, fw = get_ops(field), field.w16
        p, big = field.p, (1 << (16 * fw)) - 1
        edge = ops.encode_host([0, 1, p - 1, p, 2 * p - 1, 2 * p, big], to_mont=False)
        raw = torch.randint(0, 1 << 16, (fw, 41), generator=gen, device=DEV,
                            dtype=torch.int32)
        raw[:, :7] = torch.from_numpy(edge.astype("int32")).to(DEV)
        red = kb.random_mont(field, (41, fw), gen, DEV).T.contiguous()
        for n in (1, 7, 41):
            for op in ("to_mont", "from_mont"):
                for out_form in ("limbs", "words"):
                    check(f"{field.name} {op} n={n} -> {out_form}", mm.mont_mul_map,
                          mm.mont_mul_map_plain, field, raw[:, :n], op=op, out_form=out_form)
                check(f"{field.name} {op} words n={n}", mm.mont_mul_map, mm.mont_mul_map_plain,
                      field, pack_words(raw[:, :n], 0), op=op, in_form="words")
            check(f"{field.name} mul n={n}", mm.mont_mul_map, mm.mont_mul_map_plain, field,
                  red[:, :n], red[:, :n].flip(1), op="mul")
            for op in ("add", "sub"):
                check(f"{field.name} {op} n={n}", mm.mont_addsub_map, mm.mont_addsub_map_plain,
                      field, red[:, :n], red[:, :n].flip(1), op=op)
            check(f"{field.name} neg n={n}", mm.mont_addsub_map, mm.mont_addsub_map_plain,
                  field, red[:, :n], op="neg")
        grid = raw[:, :40].reshape(fw, 5, 8)
        hw = pack_row_words(kb.random_mont(field, (5, fw, 8), gen, DEV).permute(1, 0, 2)
                            .contiguous())
        for op in ("to_mont", "from_mont"):
            for out_form in ("limbs", "words", "hash"):
                check(f"{field.name} {op} (5, 8) limbs -> {out_form}", mm.mont_mul_map,
                      mm.mont_mul_map_plain, field, grid, op=op, out_form=out_form)
                check(f"{field.name} {op} (5, 8) hash -> {out_form}", mm.mont_mul_map,
                      mm.mont_mul_map_plain, field, hw, op=op, in_form="hash", out_form=out_form)
        # broadcast operands: a twiddle row over a non-contiguous slice (the
        # ladder's), a (W, 1, 1) constant (mul_const), either side
        x = kb.random_mont(field, (2, fw, 4, 2, 3), gen, DEV).permute(1, 0, 2, 3, 4)[:, :, :, 1]
        tw = kb.random_mont(field, (3, fw), gen, DEV).T.contiguous()[:, None, None, :]
        const = torch.from_numpy(ops.encode_host([12345]).astype("int32")).to(DEV)[:, :, None, None]
        for kernel, plain, op in ((mm.mont_mul_map, mm.mont_mul_map_plain, "mul"),
                                  (mm.mont_addsub_map, mm.mont_addsub_map_plain, "sub"),
                                  (mm.mont_addsub_map, mm.mont_addsub_map_plain, "add")):
            for a, b in ((x, tw), (tw, x), (x, const), (const, x)):
                check(f"{field.name} {op} broadcast {tuple(a.shape)} x {tuple(b.shape)}",
                      kernel, plain, field, a, b, op=op)
        # a 3-dim batch no two dims express (the operands copied contiguous)
        y = kb.random_mont(field, (2, fw, 3, 4), gen, DEV).permute(1, 3, 0, 2)
        z = kb.random_mont(field, (4, fw, 2, 3), gen, DEV).permute(1, 0, 2, 3)
        check(f"{field.name} mul, a 3-dim batch", mm.mont_mul_map, mm.mont_mul_map_plain,
              field, y, z, op="mul")
        before = mm.mont_mul_map.launches
        out = mm.mont_mul_map(field, raw[:, :0], op="to_mont", out_form="words")
        if out.shape != (fw // 2, 0) or mm.mont_mul_map.launches != before:
            raise AssertionError(f"{field.name}: an empty map launched or took the wrong shape")
    log("  edges in every field (unreduced inputs 0, 1, p-1, p, 2p-1, 2p, R-1 and random "
        "below R; n = 1, 7, 41; limbs, words and hash words in and out; broadcast and "
        "non-contiguous operands; no elements): equal")
    # an empty launch's device time (a kernel that spins 0 cycles), the floor
    # of the verify shapes' microsecond launches
    recs["empty_launch_ms"] = kb.time_kernel(lambda: torch.cuda._sleep(0), reps=50)
    log(f"  an empty launch (torch.cuda._sleep(0)): {recs['empty_launch_ms']:.4f} ms of device "
        f"time each, back to back")
    recs["max_abs_err"] = errs[0]
    return recs


def map_rows(maps, s29, big, sdig, lig, map_ptxas, shard):
    """The kernel table rows of the field maps: mont_mul_map timed at the
    2^23 Brakedown commit's conversion (its launches from that path), the
    other shapes beside; mont_addsub_map at the same codeword (its launches
    from its one caller, the sharded collapse of phase 15 (b): rank 0's
    Ligero prove)."""
    ranked = {tag: rec["launches"][0] for tag, rec in shard["ranks"].items()}

    def row(name, replaces, rec, shape, **extra):
        launches = (ranked["ligero rows"]["prove"].get(name, 0) if name == "mont_addsub_map"
                    else sdig[0][name])
        return {"name": name, "route": "cuda", "source": "lcpc_tpu_torch/csrc/mont_map.cu",
                "replaces": replaces, "launches": launches,
                "launches_sharded_rank0": {tag: {k: v.get(name, 0) for k, v in l.items()}
                                           for tag, l in ranked.items()},
                "max_abs_err": maps["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
                "equal_to_plain": True, "tolerance": 0, "shape": shape,
                "launches_by_stage": {"sdig_2_23": {k: v["counters"].get(name, 0)
                                                    for k, v in sdig[8].items()},
                                      "ligero_2_23": {k: v["counters"].get(name, 0)
                                                      for k, v in lig[8].items()}},
                "launches_other_paths": {"ligero_2_23": lig[0][name],
                                         "streaming_2_28": big["launches"][name],
                                         "seeded_2_29": s29["launches"][name]},
                "ptxas": {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                          for k, v in sorted(map_ptxas.items()) if name in k}, **extra}

    commit = "brakedown 2^23 commit: (16, 36, 357,699) limbs -> hash words"
    return [
        row("mont_mul_map",
            "lcpc_tpu/ops/limbs.py:224 (_mul_unrolled, behind mul :262, mul_const :271, to_mont "
            ":275, from_mont :279) and lcpc_tpu/core/protocol.py:307,315 (_pack_words, "
            "_canon_pack_fn); XLA-fused, not Pallas", maps[commit],
            "the 2^23 ft255 Brakedown commit's conversion: 36 x 357,699 Montgomery limbs -> "
            "canonical hash words (from_mont and the pack, one launch)",
            other_shapes={k: v for k, v in maps.items()
                          if isinstance(v, dict) and k != commit and "add" not in k}),
        row("mont_addsub_map",
            "lcpc_tpu/ops/limbs.py:121,131,149 (add, sub, neg); XLA-fused, not Pallas",
            maps["add at the brakedown 2^23 codeword: (16, 36, 357,699) limbs"],
            "add over the 2^23 ft255 Brakedown codeword's shape: 2 x (16, 36, 357,699) limbs; "
            "its caller on the paths: the sharded collapse's modular sum of the ranks' "
            "partials (FieldOps.sum)"),
    ]


def prove_rows(prv, s29, big, sdig, lig, prove_ptxas, gen_mix):
    """The kernel table rows of the seeded generator, mont_dot and the power
    table: each timed at a shape of the 2^29 seeded path or of the 2^23
    main path, with the other shapes beside; launches from the 2^29 path."""

    def ptx(src_name):
        return {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                for k, v in sorted(prove_ptxas[src_name].items())}

    def row(name, source, replaces, rec, shape, **extra):
        return {"name": name, "route": "cuda", "source": f"lcpc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": s29["launches"][name],
                "max_abs_err": prv["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
                "equal_to_plain": True, "tolerance": 0, "shape": shape,
                "launches_other_paths": {"sdig_2_23": sdig[0][name], "ligero_2_23": lig[0][name],
                                         "streaming_2_28": big["launches"][name]},
                "ptxas": ptx(source[:-3]), **extra}

    ev29 = prv[f"dot 2^29 column evaluation, a {EVAL_ROWS}-row block"]
    return [
        row("seeded_gen", "seeded_gen.cu",
            "lcpc_tpu/core/coeffs.py:143 (_gen_span_fn) and :194 (_digits_to_limbs_fn, "
            "ops/mxu_ntt.py:324 _from7); XLA-fused, not Pallas", prv["gen_packed"],
            f"{GEN_CHECK} ft255 coefficients as packed words (prove's form)",
            other_forms={f: prv[f"gen_{f}"] for f in ("digits", "limbs")},
            needed_per_coefficient_alu_fma={f: list(m) for f, m in gen_mix.items()
                                            if f != "per_digit"},
            threefry_digit_alu_fma_all=list(gen_mix["per_digit"]),
            ms_2_29_prove_block=s29["pieces"]["gen_block_ms"],
            prove_block_rows=s29["pieces"]["prove_row_block"]),
        row("mont_dot_tile", "mont_dot.cu",
            "lcpc_tpu/ops/mxu_prove.py:235,258,357 (MxuColumnEval: _eval_chunking, _eval_fns); "
            "XLA-fused, not Pallas", ev29,
            f"the 2^29 ft255 column evaluation, a {EVAL_ROWS}-row block: {EVAL_ROWS} x 262,144 "
            "x 189 (Montgomery), the tile kernel on the tensor cores (bound: u8 wgmma)",
            column_evaluation_2_29_all_rows_ms=s29["pieces"]["eval_all_rows_ms"],
            column_evaluation_2_29_bound_ms=s29["pieces"]["eval_bound_ms"],
            column_evaluation_2_29_imad_bound_ms=s29["pieces"]["eval_imad_bound_ms"],
            open_by_eval_2_29_ms=s29["pieces"]["open_by_eval_ms"],
            open_by_reencode_2_29_ms=s29["pieces"]["open_by_reencode_ms"],
            verify_rows_2_23=prv["dot 2^23 verify rows at the columns"],
            verify_rows_2_29_ms=s29["pieces"]["verify_rows_ms"]),
        row("mont_dot_thin_tc", "mont_dot.cu",
            "lcpc_tpu/ops/mxu_prove.py:86,128,212 (MxuCollapse: _banded_collapse_kernel, "
            "_collapse_fns, collapse_source) and lcpc_tpu/ops/limbs.py:375,421 "
            "(collapse_canon, collapse_words); XLA-fused, not Pallas",
            prv["dot 2^23 prove collapse"],
            "the 2^23 ft255 Ligero collapse: 2 x 256 x 32,768 (y limbs, canonical), the thin "
            "kernel on the tensor cores (bound: the bytes)",
            collapse_2_29_all_rows_ms=s29["pieces"]["collapse_all_rows_ms"],
            collapse_2_29_block_rows=s29["pieces"]["prove_row_block"],
            collapse_2_29_block_ms=s29["pieces"]["collapse_block_ms"],
            collapse_2_29_block_bound_ms=s29["pieces"]["collapse_block_bound_ms"],
            collapse_2_29_block_imad_bound_ms=s29["pieces"]["collapse_block_imad_bound_ms"],
            collapse_2_29_block=prv["dot 2^29 collapse, a 64-row block"],
            brakedown_collapse=prv["dot 2^23 brakedown collapse on the tensor cores"],
            verify_column_check_2_23=prv["dot 2^23 verify column check"]),
        row("mont_dot_thin", "mont_dot.cu",
            "lcpc_tpu/ops/limbs.py:375 (collapse_canon: the sums of partials, the evaluation's "
            "dot, Brakedown's collapses); XLA-fused, not Pallas",
            prv["dot 2^23 brakedown collapse"],
            "the 2^23 ft255 Brakedown collapse: 2 x 36 x 235,173 (y limbs, an odd row stride), "
            "the thin kernel on the CUDA cores (bound: the bytes)",
            ligero_collapse_2_23=prv["dot 2^23 prove collapse on the CUDA cores"],
            verify_column_check_2_23=prv["dot 2^23 verify column check on the CUDA cores"]),
        row("power_table", "power_table.cu",
            "lcpc_tpu/ops/mxu_prove.py:319 (_kernel_build_fns); XLA-fused, not Pallas",
            prv["table 2^29 prove"], "the 2^29 prove's table: 262,144 x 189 entries as digit "
            "planes",
            verify_2_23=prv["table 2^23 verify"], verify_2_28=prv["table 2^28 verify"],
            set_columns_2_29_host_ms=s29["pieces"]["set_columns_host_ms"]),
    ]


def sha256_mix(kb, sha_so, lib_so):
    """Phase 2: SHA-256's instructions by pipe, from the SASS of the probes'
    loop bodies (scripts/sha256_chain.cu: one scheduled compression, one
    Merkle parent); they set SHA_COMPRESSION_S and SHA_PARENT_S, the
    bounds' time of each on the integer pipes.  The column kernel's block
    loop (a compression with its 16 word loads) is reported beside."""
    global SHA_COMPRESSION_S, SHA_PARENT_S
    mix = kb.sha256_sass_mix(sha_so, lib_so)
    if mix is None:
        raise RuntimeError("cuobjdump not found: the SHA-256 bound cannot be counted")
    (c_alu, c_fma, c_all), c_ops = mix["compress"]
    (p_alu, p_fma, p_all), p_ops = mix["parent"]
    SHA_COMPRESSION_S, SHA_PARENT_S = compression_s(c_alu, c_fma), compression_s(p_alu, p_fma)
    l_alu, l_fma, l_all = mix["cols_loop"]
    log(f"  SASS sha256 compression (probe): {c_alu:g} ALU-pipe + {c_fma:g} FMA-pipe of "
        f"{c_all:g} instructions ({SHA_COMPRESSION_S * 1e12:.2f} ps at the card's integer "
        f"rate); opcodes {c_ops}")
    log(f"  SASS sha256 Merkle parent (probe): {p_alu:g} ALU + {p_fma:g} FMA of {p_all:g} "
        f"({SHA_PARENT_S * 1e12:.2f} ps); the column kernel's block loop: {l_alu} ALU + "
        f"{l_fma} FMA of {l_all} ({compression_s(l_alu, l_fma) * 1e12:.2f} ps)")
    if c_alu < 800:
        raise AssertionError(f"the probe's compression is not on the vector ALU: {mix}")
    return {"compress_alu_fma_all": (c_alu, c_fma, c_all), "compress_opcodes": c_ops,
            "parent_alu_fma_all": (p_alu, p_fma, p_all), "parent_opcodes": p_ops,
            "cols_loop_alu_fma_all": (l_alu, l_fma, l_all),
            "compression_ps": SHA_COMPRESSION_S * 1e12, "parent_ps": SHA_PARENT_S * 1e12}


def sha_bound_ms(nbytes, steps, step_s):
    """(bound ms, what bounds it): the bytes over the card's memory rate or
    `steps` compressions (or parents) of step_s seconds each."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = steps * step_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sha_cols_cost(n_words, n_cols, carry_len=8, finish=True):
    """(bytes, compressions) of sha256_cols over n_cols columns of n_words
    words: each word read once, an update's state (8 + 16 int32 words a
    column) read and written, a finish's carry read and its (8, C) int64
    digests written; one compression per 64-byte block of the stream (a
    finish's padding included)."""
    stream = carry_len + n_words
    blocks = (stream + 3 + 15) // 16 if finish else stream // 16
    state = 4 * (carry_len if finish else 2 * (8 + 16)) * n_cols
    out = 64 * n_cols if finish else 0
    return 4 * n_words * n_cols + state + out, blocks * n_cols


def plain_launches(torch, sha, digests):
    """CUDA kernels one plain compression launches on the card (torch's
    elementwise ops, by torch.profiler): what a plain SHA-256 op would add
    to a stage's count."""
    x = digests(64)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sha._compress(x, torch.cat([x, x]))
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def sha256_phase(torch, kb, sha, gen, sha_so):
    """Phase 13: the SHA-256 kernels against their plain versions, word for
    word, each timed against its bound; the trees and the walk also against
    their dependency floor (depth x one parent's latency, from the probe
    library sha_so).  Returns the records."""
    import numpy as np
    from lcpc_tpu_torch.core.streaming import StreamingSha256Hasher
    from lcpc_tpu_torch.ops.blake3 import digests_to_bytes

    def words(n, c):
        w = torch.randint(-2**31, 2**31, (n, c), generator=gen, device=DEV, dtype=torch.int32)
        w[0] = -1  # every bit set, the top one too
        return w

    def digests(n):
        return torch.randint(0, 2**32, (8, n), generator=gen, device=DEV, dtype=torch.int64)

    recs, errs = {}, [0]

    def check(tag, got, want):
        err = max_err(torch, got, want)
        errs[0] = max(errs[0], err)
        if err or not torch.equal(got.to(torch.int64) & 0xFFFFFFFF,
                                  want.to(torch.int64) & 0xFFFFFFFF):
            raise AssertionError(f"sha256 {tag}: kernel != plain (max err {err})")

    log("sha256 kernels vs plain: tolerance 0 — every digest word equal")
    # the latencies of one compression and one parent: a thread running
    # CHAIN dependent ones, held to the plain steps first
    h0 = digests(1)[:, 0].contiguous()
    ref_c = ref_p = h0[:, None]
    for _ in range(2 * kb.SHA_CHAIN_PER_TRIP):
        ref_c = sha._compress(ref_c, torch.cat([ref_c, ref_c]))
        ref_p = sha.merkle_parent_plain(ref_p, ref_p)
    n_ref = 2 * kb.SHA_CHAIN_PER_TRIP
    check("compress chain", kb.sha256_chain(sha_so, h0, n_ref, False), ref_c[:, 0])
    check("parent chain", kb.sha256_chain(sha_so, h0, n_ref, True), ref_p[:, 0])
    lat_c = kb.time_kernel(lambda: kb.sha256_chain(sha_so, h0, CHAIN, False), reps=3) / CHAIN
    lat_p = kb.time_kernel(lambda: kb.sha256_chain(sha_so, h0, CHAIN, True), reps=3) / CHAIN
    recs.update(compression_latency_ms=lat_c, parent_latency_ms=lat_p,
                plain_compression_launches=plain_launches(torch, sha, digests))
    log(f"  latency (a chain of {CHAIN} in one thread): a compression {lat_c * 1e3:.4f} us, a "
        f"Merkle parent {lat_p * 1e3:.4f} us; one plain compression is "
        f"{recs['plain_compression_launches']} CUDA kernel launches")

    def columns(tag, w, host_cols=0, timed=False, sub=()):
        n_words, n_cols = w.shape
        got = sha.hash_word_columns(w)
        want, plain_ms = time_host(torch, lambda: sha.hash_word_columns_plain(w))
        check(f"{tag}", got, want)
        check(f"{tag} (int64 words)", sha.hash_word_columns(w.to(torch.int64) & 0xFFFFFFFF), want)
        rec = {"n_words": n_words, "n_cols": n_cols, "plain_ms": plain_ms, "launches": 1,
               "compressions_a_column": (8 + n_words + 3 + 15) // 16}
        for k in sub:  # the leading columns alone, read at the full row stride
            check(f"{tag} first {k} columns", sha.hash_word_columns(w[:, :k]), want[:, :k])
        if host_cols:
            u = w[:, :host_cols].cpu().numpy().view(np.uint32)
            b = digests_to_bytes(got[:, :host_cols])
            for c in range(host_cols):
                if bytes(b[c]) != hashlib.sha256(bytes(32) + u[:, c].astype("<u4").tobytes()
                                                  ).digest():
                    raise AssertionError(f"sha256 {tag}: column {c} != hashlib")
        if timed:
            nbytes, comps = sha_cols_cost(n_words, n_cols)
            rec["ms"] = kb.time_kernel(lambda: sha.hash_word_columns(w))
            rec["bound_ms"], rec["bound_by"] = sha_bound_ms(nbytes, comps, SHA_COMPRESSION_S)
            rec.update(bytes=nbytes, compressions=comps)
            for k in sub:
                nb, cp = sha_cols_cost(n_words, k)
                rec[f"ms_{k}_columns"] = kb.time_kernel(lambda: sha.hash_word_columns(w[:, :k]))
                rec[f"bound_ms_{k}_columns"], rec[f"bound_by_{k}_columns"] = sha_bound_ms(
                    nb, cp, SHA_COMPRESSION_S)
                # a column's compressions run one after another in its thread
                rec[f"floor_ms_{k}_columns"] = rec["compressions_a_column"] * lat_c
            log(f"  sha256 {tag}: {n_cols} columns of {n_words} words "
                f"({rec['compressions_a_column']} compressions each): equal (int32 and int64 "
                f"words{', ' + str(host_cols) + ' columns to hashlib' if host_cols else ''}); "
                f"sha256_cols {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}; {comps} compressions, {nbytes} bytes), plain "
                f"{plain_ms:.1f} ms"
                + "".join(f"; first {k} columns {rec[f'ms_{k}_columns']:.4f} ms (bound "
                          f"{rec[f'bound_ms_{k}_columns']:.4f}, "
                          f"{rec[f'bound_by_{k}_columns']}; floor "
                          f"{rec['compressions_a_column']} x a compression's latency = "
                          f"{rec[f'floor_ms_{k}_columns']:.4f})" for k in sub))
        else:
            log(f"  sha256 {tag}: {n_cols} columns of {n_words} words: equal"
                f"{f', {host_cols} columns to hashlib' if host_cols else ''}")
        recs[tag] = rec

    columns("2^23 commit", words(*B3_COMMIT), host_cols=2, timed=True, sub=(B3_OPENED,))
    columns("2^28 column length", words(*B3_LONG), host_cols=1, timed=True, sub=(B3_OPENED,))
    columns("brakedown 2^23 commit", words(*SHA_SDIG), timed=True, sub=(6_593, B3_OPENED))
    for n_words in SHA_EDGES:
        columns(f"edge {n_words}", words(n_words, 300), host_cols=2)

    # streaming: the kernel's updates state by state against the plain
    # update, then the finalize at rem 12, 13 and 14 against the plain
    # finalize and the kernel's one-shot hash; the hasher class end to end
    # (the plain one-shot hash of these 1,8xx-word columns would add ~4 s
    # each: ~4,300 torch launches a compression)
    n_cols = SHA_STREAM_COLS
    w_all = words(sum(SHA_STREAM) + max(t for t, _ in SHA_STREAM_TAILS), n_cols)
    cv = sha.h0_state(n_cols, DEV)
    carry = torch.zeros((16, n_cols), dtype=torch.int32, device=DEV)
    pcv, pcarry, n, r0, carries = sha.h0_state(n_cols, DEV), None, 8, 0, []
    for length in SHA_STREAM:
        carries.append(n)
        blk = w_all[r0 : r0 + length]
        got_n = sha.sha256_cols(blk, cv=cv, carry=carry, carry_len=n)
        pcv, pcarry, n = sha.sha256_update_plain(pcv, pcarry, n, blk)
        if got_n != n:
            raise AssertionError(f"sha256 stream update of {length}: rem {got_n} != {n}")
        check(f"stream update of {length} words (carry {carries[-1]}) chaining value", cv, pcv)
        check(f"stream update of {length} words carry", carry[:n], pcarry[:n])
        r0 += length
    if carries != [8, 0, 0, 7, 15, 8]:
        raise AssertionError(f"sha256 stream: carries {carries}")
    for tail, rem_want in SHA_STREAM_TAILS:
        cv_t, carry_t, blk = cv.clone(), carry.clone(), w_all[r0 : r0 + tail]
        got_n = sha.sha256_cols(blk, cv=cv_t, carry=carry_t, carry_len=n)
        tcv, tcarry, tn = sha.sha256_update_plain(pcv, pcarry, n, blk)
        if not got_n == tn == rem_want:
            raise AssertionError(f"sha256 stream: rem {got_n}, plain {tn}, want {rem_want}")
        total = 8 + r0 + tail
        got = sha.sha256_cols(blk[:0], cv=cv_t, carry=carry_t, carry_len=got_n, total_words=total)
        check(f"stream finalize at rem {rem_want}", got,
              sha.sha256_finalize_plain(tcv, tcarry, tn, total))
        check(f"stream finalize at rem {rem_want} vs the one-shot hash", got,
              sha.hash_word_columns(w_all[: r0 + tail]))
    lens = SHA_STREAM + (SHA_STREAM_TAILS[-1][0],)
    hasher = StreamingSha256Hasher(n_cols, 8 + sum(lens), DEV)
    r0 = 0
    for length in lens:
        hasher.update(w_all[r0 : r0 + length])
        r0 += length
    check("StreamingSha256Hasher", hasher.finalize(), got)  # the last tail's digests
    log(f"  sha256 streaming, {n_cols} columns: updates of {list(SHA_STREAM)} words (carries "
        f"{carries}) equal to the plain update state by state; finalizes at rem "
        f"{[r for _, r in SHA_STREAM_TAILS]} equal to the plain finalize and the one-shot "
        f"hash; StreamingSha256Hasher end to end equal")

    lat_floor = {}
    for n_leaves, np2 in MERKLE_TREES + ((1, 1), (2, 2), (300, 512), (513, 1024)):
        leaves = digests(n_leaves)
        got = sha.merkle_tree(leaves, np2)
        want, plain_ms = time_host(torch, lambda: sha.merkle_tree_plain(leaves, np2))
        check(f"merkle tree {n_leaves} -> {np2}", got, want)
        if (n_leaves, np2) not in MERKLE_TREES:
            continue
        ms = kb.time_kernel(lambda: sha.merkle_tree(leaves, np2))
        wall = host_ms(torch, lambda: sha.merkle_tree(leaves, np2))
        bound, by = sha_bound_ms(64 * n_leaves + 64 * (2 * np2 - 1), np2 - 1, SHA_PARENT_S)
        depth = np2.bit_length() - 1
        lat_floor[depth] = depth * lat_p
        recs[f"merkle {n_leaves}"] = {
            "leaves": n_leaves, "np2": np2, "launches": 1, "ms": ms, "host_ms": wall,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "floor_ms": depth * lat_p,
            "depth": depth}
        log(f"  sha256 merkle tree of {n_leaves} leaves (padded to 2^{depth}): equal; 1 launch, "
            f"device {ms:.4f} ms, host wall {wall:.4f} ms, bound {bound:.4f} ms ({by}), floor "
            f"{depth} x a parent's latency = {depth * lat_p:.4f} ms, plain {plain_ms:.1f} ms")
    log("  sha256 merkle trees of 1, 2, 300 -> 512 and 513 -> 1,024 leaves: equal")

    for k, levels in WALKS + ((5, 0), (40, 3)):
        n_sibs = max(1, k * levels // 2)
        digs, sibs = digests(k), digests(n_sibs)
        inv = torch.randint(0, n_sibs, (levels, k), generator=gen, device=DEV)
        idx = torch.randint(0, 1 << levels, (k,), generator=gen, device=DEV)
        idx[:2] = idx[2]  # opened columns repeat
        got = sha.merkle_walk(digs, sibs, inv, idx)
        want, plain_ms = time_host(torch, lambda: sha.merkle_walk_plain(digs, sibs, inv, idx))
        check(f"merkle walk {k} x {levels}", got, want)
        if (k, levels) not in WALKS:
            continue
        ms = kb.time_kernel(lambda: sha.merkle_walk(digs, sibs, inv, idx))
        wall = host_ms(torch, lambda: sha.merkle_walk(digs, sibs, inv, idx))
        read = int(torch.unique(inv).numel())
        bound, by = sha_bound_ms(64 * k + 64 * read + 8 * levels * k + 8 * k + 64 * k,
                                 k * levels, SHA_PARENT_S)
        recs[f"walk {k}"] = {"columns": k, "levels": levels, "launches": 1, "ms": ms,
                             "host_ms": wall, "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": by, "floor_ms": levels * lat_p}
        log(f"  sha256 merkle walk of {k} columns x {levels} levels: equal; 1 launch, device "
            f"{ms:.4f} ms, host wall {wall:.4f} ms, bound {bound:.4f} ms ({by}), floor "
            f"{levels * lat_p:.4f} ms, plain {plain_ms:.1f} ms")
    log("  sha256 merkle walks of 5 x 0 and 40 x 3: equal")
    recs["max_abs_err"] = errs[0]
    return recs


def check_sha_stages(stages, tag, want, plain_per_compression, b3_stages=None):
    """A traced SHA-256 run's launches by stage: the SHA-256 kernels as
    `want` says, no BLAKE3 kernel, and every stage's CUDA kernels (the
    trace's count: torch's own kernels, so any plain op) fewer than one
    plain compression launches — no plain SHA-256 op ran on the card.  The
    trace has been seen to miss a session's kernels, so the limit is never
    under 1,000 (a stage launches at most ~150 and a plain compression
    ~4,300).  The same path's BLAKE3 counts are logged beside."""
    limit = max(plain_per_compression, 1000)
    for name, rec in stages.items():
        got = {k: v for k, v in rec["counters"].items() if k in SHA_KERNELS}
        if got != want[name] or any(k in rec["counters"] for k in ("blake3_chunks", *TREES)):
            raise AssertionError(f"{tag} {name}: launches {rec['counters']}, want {want[name]}")
        if rec["cuda_kernels"] >= limit:
            raise AssertionError(f"{tag} {name}: {rec['cuda_kernels']} CUDA kernel launches, "
                                 f"a plain SHA-256 op ran on the card")
    log(f"  {tag}: SHA-256 launches by stage "
        f"{ {n: r['counters'] for n, r in stages.items()} }; CUDA kernels by stage "
        f"{ {n: r['cuda_kernels'] for n, r in stages.items()} }"
        + (f" (BLAKE3: { {n: r['cuda_kernels'] for n, r in b3_stages.items()} })"
           if b3_stages else "")
        + f", each under {limit} (one plain compression: {plain_per_compression})")


def sha256_path_2_28(torch, kb, P, counters, sha, gen, card, plain_per_compression):
    """Phase 14 (c): the 2^28 streaming path of phase 9 with digest=SHA256:
    commit_streaming (spill="auto") -> prove -> verify once cold with the
    launches counted, the evaluation against one on the card in the other
    order, tampered proofs, the kept words hashed in memory equal to the
    streamed leaves (sha256_cols timed there and at a row block's update),
    one traced run by stage, then warm runs."""
    from lcpc_tpu_torch.ops.limbs import get_ops

    spec, digest = P.FT255, P.SHA256
    enc = P.LigeroEncoding.new(spec, N_BIG, *LIGERO_RHO, device=DEV)
    n_rows, n_cols = -(-N_BIG // enc.n_per_row), enc.n_cols
    coeffs = random_packed_coeffs(torch, spec, N_BIG, gen)
    outer, inner = P.univariate_tensors(spec, 0x5EED5EED5EED, enc.n_per_row, n_rows)
    want = device_eval(torch, get_ops(spec), coeffs.reshape(coeffs.shape[0], n_rows,
                                                            enc.n_per_row), outer, inner, 256)
    transcript = transcript_for(P, enc)

    def run():
        comm, c_ms = time_host(torch, lambda: P.commit_streaming(coeffs, enc, digest=digest))
        root = comm.get_root()
        proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
        value, v_ms = time_host(torch, lambda: proof.verify(root, outer, inner, enc,
                                                            transcript(root), digest=digest))
        return comm, proof, value, (c_ms, p_ms, v_ms)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    comm, proof, value, cold = run()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_blocks = -(-n_rows // comm.row_block)
    log(f"sha path 2^28 cold: commit {cold[0]:.1f} ms, prove {cold[1]:.1f} ms, verify "
        f"{cold[2]:.1f} ms; launches {launches}; row block {comm.row_block} ({n_blocks} "
        f"blocks), words kept on the card: {comm.words_dev is not None}; peak device memory "
        f"{peak:.2f} GiB")
    for name, n in launches.items():
        if (n > 0) != (name in ligero_kernels(enc.n_cols) | set(SHA_KERNELS)):
            raise AssertionError(f"sha path 2^28: {name} launched {n} times")
    # commit: an update a row block and the finalize, the tree; verify: the
    # opened columns' hash and the walk
    check_hash_launches(launches, {"sha256_cols": n_blocks + 2, "sha256_merkle_tree": 1,
                                   "sha256_merkle_walk": 1}, "sha path 2^28")
    if comm.words_dev is None:
        raise AssertionError("sha path 2^28: the words were not kept on the card")
    if value != want:
        raise AssertionError("sha path 2^28: verify's evaluation != the evaluation on the card")
    log("  verify returned the evaluation computed on the card in the other order: ok")
    root = comm.get_root()
    data = P.wire.serialize_proof(spec, proof)
    tamper_checks(P, spec, data, root, outer, inner, enc, transcript, "sha path 2^28", digest)

    words = comm.words_dev
    leaves = sha.hash_word_columns(words)
    if not torch.equal(leaves, comm.hashes_dev[:, :n_cols]):
        raise AssertionError("sha path 2^28: in-memory hash of the kept words != streamed leaves")
    rec = {"launches": launches, "cold": cold, "peak_gib": peak, "proof_bytes": len(data),
           "row_block": comm.row_block, "blocks": n_blocks}
    nbytes, comps = sha_cols_cost(words.shape[0], n_cols)
    rec["cols_ms"] = kb.time_kernel(lambda: sha.hash_word_columns(words), reps=3)
    rec["cols_bound_ms"], rec["cols_bound_by"] = sha_bound_ms(nbytes, comps, SHA_COMPRESSION_S)
    blk = words[: comm.row_block * spec.w16 // 2]
    cv = sha.h0_state(n_cols, DEV)
    carry = torch.zeros((16, n_cols), dtype=torch.int32, device=DEV)
    nb_u, cp_u = sha_cols_cost(blk.shape[0], n_cols, finish=False)
    rec["update_ms"] = kb.time_kernel(lambda: sha.sha256_cols(blk, cv=cv, carry=carry), reps=3)
    rec["update_bound_ms"], rec["update_bound_by"] = sha_bound_ms(nb_u, cp_u, SHA_COMPRESSION_S)
    log(f"  the kept words hashed in memory: equal to the streamed leaves; sha256_cols "
        f"{rec['cols_ms']:.4f} ms ({n_cols} columns x {words.shape[0]} words, bound "
        f"{rec['cols_bound_ms']:.4f} ms, {rec['cols_bound_by']}); one {comm.row_block}-row "
        f"block's update ({blk.shape[0]} words): {rec['update_ms']:.4f} ms (bound "
        f"{rec['update_bound_ms']:.4f} ms, {rec['update_bound_by']})")
    del comm, proof, words, leaves, blk, cv, carry
    torch.cuda.empty_cache()

    rec["stages"] = stage_launches(torch, P, counters, enc,
                                   lambda: P.commit_streaming(coeffs, enc, digest=digest), outer,
                                   inner, digest)
    check_sha_stages(rec["stages"], "sha path 2^28",
                     dict(SHA_LAUNCHES_STAGES, commit={"sha256_cols": n_blocks + 1,
                                                       "sha256_merkle_tree": 1}),
                     plain_per_compression)
    torch.cuda.empty_cache()
    warm = []
    for _ in range(SHA_BIG_WARM):
        if time.perf_counter() - T_START > SHA_BIG_WARM_DEADLINE_S:
            log(f"  sha path 2^28: {len(warm)} warm runs, not {SHA_BIG_WARM}: the run is at "
                f"{time.perf_counter() - T_START:.0f} s")
            break
        comm, proof, value, t = run()
        if value != want:
            raise AssertionError("sha path 2^28: warm run's evaluation differs")
        warm.append(t)
        del comm, proof
        torch.cuda.empty_cache()
    med = [statistics.median(t[i] for t in warm) if warm else None for i in range(3)]
    for i, name in enumerate(("commit", "prove", "verify")):
        log(f"sha256_streaming_ligero_{name}_ms_median_2^28_ft255: "
            f"{med[i] if med[i] is None else round(med[i], 1)} "
            f"(warm runs {[round(t[i], 1) for t in warm]}; cold {cold[i]:.1f}; {card})")
    del coeffs
    torch.cuda.empty_cache()
    rec.update(warm=warm, median=med)
    return rec


def sha256_paths(torch, kb, P, counters, sha, coeffs_mont, x_pt, want, card, gen, b3_stages,
                 plain_per_compression):
    """Phase 14: the slice's paths with digest=SHA256, through the public
    entry points: (a) Ligero 2^23 and (b) Brakedown 2^23 as phases 6 and 4
    run them (main_path: cold with the launches counted, warm, traced by
    stage, the evaluation and the tamper kinds), (c) the 2^28 streaming
    path.  Every plain SHA-256 version goes through sha._compress: it is
    watched for the whole phase, and a call on a CUDA tensor is fatal.
    Returns the records."""
    spec = P.FT255
    out, on_card, compress = {}, [], sha._compress

    def watched(h, m):
        on_card.append(h.is_cuda or m.is_cuda)
        return compress(h, m)

    sha._compress = watched
    lenc = P.LigeroEncoding.new(spec, N_COEFFS, *LIGERO_RHO, device=DEV)
    lig = main_path(torch, P, counters, lenc, coeffs_mont, x_pt, want, card, "sha_ligero",
                    ligero_kernels(lenc.n_cols) | set(SHA_KERNELS), P.SHA256,
                    SHA_LAUNCHES_PATH)
    check_sha_stages(lig[8], "sha_ligero", SHA_LAUNCHES_STAGES, plain_per_compression,
                     b3_stages["ligero"])
    check_map_launches(lig[8], "sha_ligero", {"commit": 0, "prove": 0,
                                              "verify": ligero_verify_maps(lenc.n_cols)})
    del lenc
    t0 = time.perf_counter()
    enc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device=DEV)
    log(f"brakedown 2^23 encoding rebuilt in {time.perf_counter() - t0:.2f} s")
    sdig = main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, "sha_sdig",
                     SDIG_KERNELS | set(SHA_KERNELS), P.SHA256, SHA_LAUNCHES_PATH)
    check_sha_stages(sdig[8], "sha_sdig", SHA_LAUNCHES_STAGES, plain_per_compression,
                     b3_stages["sdig"])
    check_map_launches(sdig[8], "sha_sdig", {"commit": 1, "prove": 0, "verify": 5})
    del enc
    torch.cuda.empty_cache()
    for tag, r in (("ligero_2_23", lig), ("sdig_2_23", sdig)):
        out[tag] = {"launches": r[0], "cold": r[1], "warm": r[2], "median": r[3],
                    "peak_gib": r[4], "proof_bytes": r[5], "stages": r[8]}
    out["ligero_2_28"] = sha256_path_2_28(torch, kb, P, counters, sha, gen, card,
                                          plain_per_compression)
    sha._compress = compress
    if any(on_card):
        raise AssertionError(f"phase 14: {sum(on_card)} plain SHA-256 compressions on the card")
    log(f"  phase 14: no plain SHA-256 compression ran on the card ({len(on_card)} ran in "
        f"all, on the host)")
    out["plain_compressions_on_card"] = 0
    return out


def sha_rows(shas, paths, sha_ptxas, sha_mix):
    """The kernel table rows of the three SHA-256 kernels, each timed at
    path (a)'s shape (the Ligero 2^23 commit's columns and tree, its verify's
    walk), with its launches on each path, the other shapes, the host wall,
    the dependency floor and ptxas's report beside."""
    c23, w189 = shas["2^23 commit"], shas[f"walk {WALKS[0][0]}"]
    m17 = shas[f"merkle {MERKLE_TREES[0][0]}"]
    big = paths["ligero_2_28"]

    def ptx(name):
        return {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                for k, v in sorted(sha_ptxas.items()) if name in k}

    def row(name, replaces, rec, shape, **extra):
        return {"name": name, "route": "cuda", "source": "lcpc_tpu_torch/csrc/sha256_cols.cu",
                "replaces": replaces, "launches": paths["ligero_2_23"]["launches"][name],
                "max_abs_err": shas["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None, "equal_to_plain": True,
                "tolerance": 0, "shape": shape,
                "launches_paths": {tag: paths[tag]["launches"][name]
                                   for tag in ("ligero_2_23", "sdig_2_23", "ligero_2_28")},
                "ptxas": ptx(name.replace("sha256_merkle", "merkle") + "_kernel"),
                "sass_compression_alu_fma_all": sha_mix["compress_alu_fma_all"],
                "sass_parent_alu_fma_all": sha_mix["parent_alu_fma_all"], **extra}

    return [
        row("sha256_cols",
            "lcpc_tpu/ops/sha256_jax.py:53,90 (_compress, hash_word_columns) and "
            "lcpc_tpu/core/streaming.py:408,428,448 (_sha_update_fn, _sha_finalize_fn, "
            "StreamingSha256Hasher); XLA-fused, not Pallas", c23,
            f"path (a)'s commit columns: {c23['n_cols']} x {c23['n_words']} words, "
            f"{c23['compressions_a_column']} compressions each, one launch",
            other_shapes={k: shas[k] for k in ("2^28 column length", "brakedown 2^23 commit")},
            ms_2_28_commit=big["cols_ms"], bound_ms_2_28_commit=big["cols_bound_ms"],
            ms_2_28_block_update=big["update_ms"],
            bound_ms_2_28_block_update=big["update_bound_ms"],
            compression_latency_ms=shas["compression_latency_ms"]),
        row("sha256_merkle_tree",
            "lcpc_tpu/ops/sha256_jax.py:127,144 (merkle_parent, merkle_layer) over the layer "
            "loops of lcpc_tpu/core/protocol.py:326-333, :376-383 and core/streaming.py:719-725; "
            "XLA-fused, not Pallas", m17, "path (a)'s tree: 2^17 leaves",
            host_ms=m17["host_ms"], floor_ms=m17["floor_ms"],
            other_shapes={k: v for k, v in shas.items() if k.startswith("merkle ")},
            parent_latency_ms=shas["parent_latency_ms"]),
        row("sha256_merkle_walk",
            "lcpc_tpu/core/protocol.py:787-793 (_verify_core_fn's parent loop); XLA-fused, "
            "not Pallas", w189, "path (a)'s verify walk: 189 columns x 17 levels",
            host_ms=w189["host_ms"], floor_ms=w189["floor_ms"],
            brakedown_2_23=shas[f"walk {WALKS[1][0]}"],
            parent_latency_ms=shas["parent_latency_ms"]),
    ]


# phase 15: the sharded paths (lcpc_tpu_torch/parallel)
SHARD_STREAM_RB = {"ligero": 64, "sdig": 8}  # mesh streaming row blocks: 4 and 5 blocks at 2^23
RANK_WORLD = 2       # phase 15 (b): ranks on the one card
# NCCL refuses two ranks on one device ("Duplicate GPU detected", NCCL 2.28.9,
# torch 2.11.0+cu128: PERF.md §6), so (b)'s group is gloo, its
# collectives staged through pinned host memory (parallel/comm.py)
RANK_BACKEND = "gloo"
RANK_TIMEOUT_S = 400
TWIDDLE_LOG_N = 20   # phase 15: the NTT plan's table built on the card, against the host's
# kernels each sharded stage must launch (besides the hash kernels of commit)
SHARD_COMMIT = {"ligero": {"ntt_mont"}, "wide": {"ntt_mont", "mont_mul_map"},
                "sdig": {"spmv_mont", "mont_mul_map"}}
SHARD_PROVE = {"mont_dot", "mont_mul_map"}  # the collapse; the opened columns' conversion
HASH_COMMIT = {"blake3": {"blake3_chunks", "chunk_tree", "merkle_tree"},
               "sha256": {"sha256_cols", "sha256_merkle_tree"}}


def main_coeffs(torch, spec, ops, gen):
    """The 2^23 coefficients both main paths commit to, drawn from `gen`:
    (canonical limbs, Montgomery limbs), (W, 2^23) int32 on the card."""
    top = spec.p >> (16 * (spec.w16 - 1))
    canon = torch.randint(0, 1 << 16, (spec.w16, N_COEFFS), generator=gen,
                          device=gen.device, dtype=torch.int32)
    canon[-1] = torch.randint(0, top, (N_COEFFS,), generator=gen, device=gen.device,
                              dtype=torch.int32)
    return canon, ops.to_mont(canon)


def kernel_counters(b3, md, mm, nttm, sha, spmv, tf):
    """Every kernel wrapper of the port by its counter's name."""
    return {"spmv_mont": spmv.spmv_mont, "ntt_mont": nttm.ntt_forward,
            "blake3_chunks": b3.blake3_chunks, "chunk_tree": b3.merge_chunk_cvs,
            "merkle_tree": b3.merkle_tree, "merkle_walk": b3.merkle_walk,
            "seeded_gen": tf.seeded_digits, "mont_dot": md.mont_dot,
            **{f"mont_dot_{k}": v for k, v in md.KERNELS.items()},
            "power_table": md.power_table, "mont_mul_map": mm.mont_mul_map,
            "mont_addsub_map": mm.mont_addsub_map, "sha256_cols": sha.sha256_cols,
            "sha256_merkle_tree": sha.merkle_tree, "sha256_merkle_walk": sha.merkle_walk}


def counted(torch, counters, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (result, host ms, launches by kernel)."""
    for c in counters.values():
        c.launches = 0
    out, ms = time_host(torch, fn)
    return out, ms, {k: c.launches for k, c in counters.items() if c.launches}


def check_launched(launches, want, tag):
    """Each kernel in `want` launched (as often as `want` says, if a dict)."""
    bad = sorted(k for k in want if not launches.get(k)
                 or (isinstance(want, dict) and launches[k] != want[k]))
    if bad:
        raise AssertionError(f"{tag}: {bad} launched {[launches.get(k, 0) for k in bad]} "
                             f"times ({launches})")


def sharded_stages(torch, P, counters, commit_fn, enc, outer, inner, digest, want, tag,
                   commit_kernels, prove_kernels):
    """commit_fn() -> prove -> verify, each stage counted; commit's and
    prove's kernels checked (commit's hash kernels too), verify's value
    against `want`.  Returns (root, proof bytes, {stage: ms}, {stage:
    launches})."""
    transcript = transcript_for(P, enc)
    comm, c_ms, c_l = counted(torch, counters, commit_fn)
    root = comm.get_root()
    proof, p_ms, p_l = counted(torch, counters, lambda: comm.prove(outer, transcript(root)))
    value, v_ms, v_l = counted(torch, counters, lambda: proof.verify(
        root, outer, inner, enc, transcript(root), digest=digest))
    if value != want:
        raise AssertionError(f"{tag}: verify returned the wrong evaluation")
    check_launched(c_l, commit_kernels | HASH_COMMIT[digest.name], f"{tag} commit")
    check_launched(p_l, prove_kernels, f"{tag} prove")
    return (root, P.wire.serialize_proof(enc.spec, proof),
            {"commit": c_ms, "prove": p_ms, "verify": v_ms},
            {"commit": c_l, "prove": p_l, "verify": v_l})


def median_ms(torch, fn, reps=REPS):
    return statistics.median(time_host(torch, fn)[1] for _ in range(reps))


def twiddle_check(torch, P, nttm, counters):
    """The NTT plan's kernel table at n = 2^TWIDDLE_LOG_N built on the card
    (mont_powers: a mont_mul_map launch a doubling) against the host's
    Python-int powers, word for word; both timed cold."""
    import numpy as np
    from lcpc_tpu_torch.ops.spmv import pack_words

    plan = nttm.NttPlan(P.FT255, 1 << TWIDDLE_LOG_N)  # a fresh plan: no table cached
    (tw, _), dev_ms, launches = counted(torch, counters, lambda: plan.kernel_table(DEV))
    t0 = time.perf_counter()
    host = np.concatenate(plan.stage_twiddles[::-1], axis=1)
    want = pack_words(torch.from_numpy(host.astype(np.int32)), 0).T
    host_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(tw.cpu(), want):
        raise AssertionError("the card's NTT twiddle table differs from the host's")
    check_launched(launches, {"mont_mul_map": TWIDDLE_LOG_N - 1}, "the twiddle table")
    log(f"  twiddles n = 2^{TWIDDLE_LOG_N}: built on the card in {dev_ms:.1f} ms "
        f"({launches.get('mont_mul_map')} mont_mul_map launches), the host's powers "
        f"{host_ms:.1f} ms; equal word for word")
    return {"n": 1 << TWIDDLE_LOG_N, "card_ms": dev_ms, "host_ms": host_ms,
            "launches": launches}


def sharded_phase(torch, kb, P, counters, coeffs_mont, x_pt, want, card):
    """Phase 15 (a): the sharded paths at world 1 on NCCL in this process,
    at 2^23 ft255 against the single-device paths on the same coefficients;
    (b): RANK_WORLD ranks on the one card (sharded_ranks)."""
    import numpy as np
    import torch.distributed as dist
    from lcpc_tpu_torch.core import protocol
    from lcpc_tpu_torch.ops import ntt as nttm
    from lcpc_tpu_torch.ops.limbs import get_ops, pack_row_words
    from lcpc_tpu_torch.ops.mxu_prove import MxuCollapse
    from lcpc_tpu_torch.parallel import mesh_protocol as mp, mesh_streaming as ms, multihost
    from lcpc_tpu_torch.parallel.comm import Comm

    spec = P.FT255
    ops = get_ops(spec)
    out = {"twiddles": twiddle_check(torch, P, nttm, counters)}

    multihost.initialize(device=f"{DEV}:0")  # a group of one: NCCL on the card
    mesh = mp.make_mesh()
    c = Comm(mesh)
    log(f"  world {c.world}, backend {c.backend}, mesh {mesh}")
    lenc = P.LigeroEncoding.new(spec, N_COEFFS, *LIGERO_RHO, device=DEV)
    senc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device=DEV)
    paths = (
        ("ligero rows blake3", lenc, P.BLAKE3, "ligero",
         lambda: mp.sharded_commit(coeffs_mont, lenc, mesh, strategy="rows"),
         lambda: P.commit(coeffs_mont, lenc)),
        ("ligero rows sha256", lenc, P.SHA256, "ligero",
         lambda: mp.sharded_commit(coeffs_mont, lenc, mesh, digest=P.SHA256, strategy="rows"),
         lambda: P.commit(coeffs_mont, lenc, digest=P.SHA256)),
        ("sdig rows blake3", senc, P.BLAKE3, "sdig",
         lambda: mp.sharded_commit(coeffs_mont, senc, mesh),
         lambda: P.commit(coeffs_mont, senc)),
        ("ligero wide blake3", lenc, P.BLAKE3, "wide",
         lambda: mp.sharded_commit(coeffs_mont, lenc, mesh, strategy="wide"),
         lambda: P.commit(coeffs_mont, lenc)),
        ("ligero mesh streaming", lenc, P.BLAKE3, "ligero",
         lambda: ms.sharded_commit_streaming(coeffs_mont, lenc, mesh,
                                             row_block=SHARD_STREAM_RB["ligero"]),
         lambda: P.commit_streaming(coeffs_mont, lenc, row_block=SHARD_STREAM_RB["ligero"])),
        ("sdig mesh streaming", senc, P.BLAKE3, "sdig",
         lambda: ms.sharded_commit_streaming(coeffs_mont, senc, mesh,
                                             row_block=SHARD_STREAM_RB["sdig"]),
         lambda: P.commit_streaming(coeffs_mont, senc, row_block=SHARD_STREAM_RB["sdig"])),
    )
    runs, refs = [], {}
    for tag, enc, digest, kind, sharded, single in paths:
        n_rows = -(-N_COEFFS // enc.n_per_row)
        outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
        transcript = transcript_for(P, enc)
        ref_root, ref_proof, ref_ms, _ = sharded_stages(
            torch, P, counters, single, enc, outer, inner, digest, want, f"{tag} (single)",
            set(), {"mont_dot"})
        root, proof, st_ms, launches = sharded_stages(
            torch, P, counters, sharded, enc, outer, inner, digest, want, tag,
            SHARD_COMMIT[kind], SHARD_PROVE)
        if root != ref_root or proof != ref_proof:
            raise AssertionError(f"{tag}: root or proof bytes differ from the single device's")
        comm = sharded()
        if "streaming" in tag and comm.row_block >= comm.n_rows:
            raise AssertionError(f"{tag}: one row block ({comm.row_block} of {comm.n_rows} rows)")
        if kind == "wide" and comm.strategy != "wide":
            raise AssertionError(f"{tag}: strategy {comm.strategy}")
        scomm = single()
        ms_ = {"commit": median_ms(torch, sharded), "single_commit": median_ms(torch, single),
               "prove": median_ms(torch, lambda: comm.prove(outer, transcript(root))),
               "single_prove": median_ms(torch, lambda: scomm.prove(outer, transcript(root)))}
        log(f"  {tag}: root and {len(proof)} proof bytes equal the single device's, verify ok; "
            f"world-1 commit {ms_['commit']:.1f} ms (single device {ms_['single_commit']:.1f}), "
            f"prove {ms_['prove']:.1f} ms ({ms_['single_prove']:.1f}); medians of {REPS}; "
            f"{card}")
        for stage, l in launches.items():
            log(f"    {stage} launches: {l}")
        runs.append({"path": tag, "strategy": getattr(comm, "strategy", None),
                     "row_block": getattr(comm, "row_block", None), "ms": ms_,
                     "first_run_ms": st_ms, "launches": launches, "proof_bytes": len(proof)})
        refs[tag] = (root, proof)
        del comm, scomm
        torch.cuda.empty_cache()
    out["world1"] = runs

    # the pieces at world 1, each beside its bound: the reshard (a device
    # copy at world 1: 2 x bytes over the card's memory rate), the
    # collapse, the opened columns, one mesh-streaming block
    n_rows = -(-N_COEFFS // lenc.n_per_row)
    mat = coeffs_mont.reshape(spec.w16, n_rows, lenc.n_per_row)
    words = lenc.encode_rows_lowmem(mat, post=pack_row_words, canonical=True)
    chunks = words[None]
    a2a_bytes = chunks.numel() * 4
    a2a_ms = kb.time_kernel(lambda: c.exchange(chunks))
    a2a_bound = 2 * a2a_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  all_to_all ({c.backend}, world {c.world}) of the 2^{N_COEFFS.bit_length() - 1} "
        f"Ligero commit's words, {a2a_bytes} bytes: "
        f"{a2a_ms:.4f} ms against {a2a_bound:.4f} ms (2 x bytes / 3.35 TB/s), "
        f"{100 * a2a_bound / a2a_ms:.1f}%; {card}")
    del words, chunks
    nb, prod, _ = ntt_cost(spec, n_rows, lenc.n_per_row, lenc.n_cols, True)
    (k1b, k1c), (k2b, k2c) = hash_cost(n_rows * spec.w16 // 2, lenc.n_cols)
    rows_bound = (bound_ms(nb, prod)[0] + a2a_bound + hash_bound_ms(k1b, k1c)[0]
                  + hash_bound_ms(k2b, k2c)[0])
    a, b = mp.wide_split(lenc.n_cols)
    na, pa, _ = ntt_cost(spec, n_rows * b, a, a, False)
    nbb, pb, _ = ntt_cost(spec, n_rows * a, b, b, True)
    tw_b, tw_p = map_cost(spec, n_rows * lenc.n_cols, spec.w16, spec.w16, 2 * 64 + 8)
    limb_bytes = 4 * spec.w16 * n_rows * lenc.n_cols
    wide_bound = (bound_ms(na, pa)[0] + bound_ms(nbb, pb)[0] + bound_ms(tw_b, tw_p)[0]
                  + 2 * limb_bytes / HBM_BYTES_PER_S * 1e3 + hash_bound_ms(k1b, k1c)[0]
                  + hash_bound_ms(k2b, k2c)[0])
    comm = mp.sharded_commit(coeffs_mont, lenc, mesh, strategy="rows")
    scomm = P.commit(coeffs_mont, lenc)
    ts = [[(x_pt + i) % spec.p for i in range(n_rows)], [(3 * x_pt + i) % spec.p
                                                          for i in range(n_rows)]]
    coll_ms = median_ms(torch, lambda: mp.sharded_collapse(comm, ts))
    single_coll_ms = median_ms(torch, lambda: MxuCollapse(spec, n_rows)(ts, scomm.coeffs).cpu())
    ts_l = torch.from_numpy(np.stack([ops.encode_host(t) for t in ts], axis=1)
                            .astype(np.int32)).to(DEV)
    coll_dev = kb.time_kernel(lambda: ops.collapse_canon(ts_l, comm.coeffs))
    coll_bound = dot_bound(spec, ts_l, comm.coeffs, 2, n_rows, lenc.n_per_row)
    cols = list(range(0, lenc.n_cols, lenc.n_cols // lenc.get_n_col_opens()))[
        :lenc.get_n_col_opens()]
    gather_ms = median_ms(torch, lambda: mp.sharded_open_columns(comm, cols))
    single_gather_ms = median_ms(torch, lambda: protocol._open_columns(scomm, cols))
    if not (mp.sharded_open_columns(comm, cols).col_w
            == protocol._open_columns(scomm, cols).col_w).all():
        raise AssertionError("sharded opened columns differ from the single device's")
    # the opened columns' words read once and written once; index_select of
    # the rank's columns alone (the one PyTorch call of the gather) beside
    gather_bound = 2 * 4 * len(cols) * (n_rows * spec.w16 // 2) / HBM_BYTES_PER_S * 1e3
    pick = torch.as_tensor(cols, device=comm.words.device) % comm.words.shape[1]
    isel_ms = kb.time_kernel(lambda: comm.words.index_select(1, pick))
    rb = SHARD_STREAM_RB["ligero"]
    block = mat[:, :rb]
    blk_ms = kb.time_kernel(lambda: mp.encode_reshard(lenc, c, block, rb))
    one_ms = kb.time_kernel(lambda: lenc.encode_rows_words_only(block))
    nb1, prod1, _ = ntt_cost(spec, rb, lenc.n_per_row, lenc.n_cols, True)
    blk_bound = bound_ms(nb1 - 4 * spec.w16 * rb * lenc.n_cols, prod1)[0] + \
        2 * (4 * rb * spec.w16 // 2 * lenc.n_cols) / HBM_BYTES_PER_S * 1e3
    rows_run = next(r for r in runs if r["path"] == "ligero rows blake3")
    wide_run = next(r for r in runs if r["path"] == "ligero wide blake3")
    out["functions"] = {
        "rows_commit": {"ms": rows_run["ms"]["commit"], "single_ms": rows_run["ms"]["single_commit"],
                        "bound_ms": rows_bound},
        "wide_commit": {"ms": wide_run["ms"]["commit"], "single_ms": wide_run["ms"]["single_commit"],
                        "bound_ms": wide_bound},
        "collapse": {"ms": coll_ms, "single_ms": single_coll_ms, "device_ms": coll_dev,
                     "bound_ms": coll_bound[0], "bound_by": coll_bound[1]},
        "gather": {"ms": gather_ms, "single_ms": single_gather_ms, "bound_ms": gather_bound,
                   "columns": len(cols), "index_select_ms": isel_ms},
        "block_words": {"ms": blk_ms, "encode_only_ms": one_ms, "bound_ms": blk_bound, "rows": rb},
        "all_to_all": {"ms": a2a_ms, "bytes": a2a_bytes, "bound_ms": a2a_bound},
    }
    for name, rec in out["functions"].items():
        log(f"  {name} (world 1): {json.dumps(rec)}; {card}")
    del comm, scomm, mat, block
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    out["ranks"] = sharded_ranks(torch, P, x_pt, refs)
    return out


def sharded_ranks(torch, P, x_pt, refs):
    """Phase 15 (b): RANK_WORLD processes on the one card (this script with
    --sharded-rank), a RANK_BACKEND group: Ligero by rows and wide, Brakedown
    by rows, each rank's root and proof bytes against the single device's
    (`refs`), mont_addsub_map launched in prove (the modular sum of the
    partials).  A correctness run: its times pass through host memory."""
    import pickle
    import subprocess
    import tempfile

    from lcpc_tpu_torch.parallel.multihost import free_port

    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.pkl") for r in range(RANK_WORLD)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank",
                                   str(r), str(port), outs[r], str(x_pt)])
                 for r in range(RANK_WORLD)]
        try:
            codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise AssertionError(f"sharded ranks exited with {codes}")
        got = []
        for path in outs:
            with open(path, "rb") as f:
                got.append(pickle.load(f))
    res = {}
    for tag, want_tag in (("ligero rows", "ligero rows blake3"),
                          ("ligero wide", "ligero rows blake3"),
                          ("sdig rows", "sdig rows blake3")):
        for r, g in enumerate(got):
            rec = g[tag]
            if (rec["root"], rec["proof"]) != refs[want_tag]:
                raise AssertionError(f"{RANK_WORLD} ranks, {tag}: rank {r}'s root or proof bytes "
                                     "differ from the single device's")
            check_launched(rec["launches"]["prove"], {"mont_addsub_map"},
                           f"{tag}: rank {r}'s prove")
            check_launched(rec["launches"]["commit"], SHARD_COMMIT[
                "sdig" if "sdig" in tag else "wide" if "wide" in tag else "ligero"]
                | HASH_COMMIT["blake3"], f"{tag}: rank {r}'s commit")
            want_s = "wide" if "wide" in tag else "rows"
            if rec["strategy"] != want_s:
                raise AssertionError(f"{tag}: rank {r} took {rec['strategy']}")
        res[tag] = {"commit_ms": [g[tag]["commit_ms"] for g in got],
                    "prove_ms": [g[tag]["prove_ms"] for g in got],
                    "launches": [g[tag]["launches"] for g in got], "backend": got[0]["backend"]}
        log(f"  {RANK_WORLD} ranks on the one card ({got[0]['backend']}; its collectives "
            f"through host memory: a correctness run, its times no performance figure), "
            f"{tag}: every rank's root and proof bytes equal the single device's; "
            f"commit {res[tag]['commit_ms']} ms, prove {res[tag]['prove_ms']} ms by rank")
        for r, g in enumerate(got):
            log(f"    rank {r} launches: {g[tag]['launches']}")
    return res


def sharded_rank(rank, port, out, x_pt) -> int:
    """One rank of phase 15 (b): joins a RANK_BACKEND group of RANK_WORLD on
    cuda:0, makes the 2^23 coefficients from SEED as main() does, commits
    and proves Ligero by rows and wide and Brakedown by rows, and pickles
    each path's root, proof bytes, launches by stage and times to `out`."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path[:0] = [ROOT]
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.ops import blake3 as b3, mont_dot as md, mont_map as mm
    from lcpc_tpu_torch.ops import ntt as nttm, sha256 as sha, spmv, threefry as tf
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.parallel import mesh_protocol as mp, multihost
    from lcpc_tpu_torch.parallel.comm import Comm

    rank, port, x_pt = int(rank), int(port), int(x_pt)
    multihost.initialize(f"tcp://localhost:{port}", RANK_WORLD, rank, device=f"{DEV}:0",
                         backend=RANK_BACKEND)
    counters = kernel_counters(b3, md, mm, nttm, sha, spmv, tf)
    spec = P.FT255
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    _, coeffs_mont = main_coeffs(torch, spec, get_ops(spec), gen)
    mesh = mp.make_mesh()
    lenc = P.LigeroEncoding.new(spec, N_COEFFS, *LIGERO_RHO, device=DEV)
    senc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device=DEV)
    res = {"backend": Comm(mesh).backend}
    for tag, enc, strategy in (("ligero rows", lenc, "rows"), ("ligero wide", lenc, "wide"),
                               ("sdig rows", senc, "rows")):
        n_rows = -(-N_COEFFS // enc.n_per_row)
        outer, _ = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
        transcript = transcript_for(P, enc)
        dist.barrier()
        comm, c_ms, c_l = counted(torch, counters,
                                  lambda: mp.sharded_commit(coeffs_mont, enc, mesh,
                                                            strategy=strategy))
        root = comm.get_root()
        proof, p_ms, p_l = counted(torch, counters, lambda: comm.prove(outer, transcript(root)))
        res[tag] = {"root": root, "proof": P.wire.serialize_proof(spec, proof),
                    "strategy": comm.strategy, "commit_ms": round(c_ms, 1),
                    "prove_ms": round(p_ms, 1), "launches": {"commit": c_l, "prove": p_l}}
        del comm, proof
        torch.cuda.empty_cache()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import kernel_bench as kb
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.ops import blake3 as b3
    from lcpc_tpu_torch.ops import mont_dot as md
    from lcpc_tpu_torch.ops import mont_map as mm
    from lcpc_tpu_torch.ops import ntt as nttm
    from lcpc_tpu_torch.ops import sha256 as sha
    from lcpc_tpu_torch.ops import spmv
    from lcpc_tpu_torch.ops import threefry as tf
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.utils import cuda_build, native

    if "jax" in sys.modules or "lcpc_tpu" in sys.modules:
        raise RuntimeError("the port pulled in JAX or the JAX package")
    if hasattr(b3, "blake3_parents"):
        raise AssertionError("the per-level blake3_parents kernel is still in the port")
    counters = kernel_counters(b3, md, mm, nttm, sha, spmv, tf)
    hashing = {"blake3_chunks", *TREES}

    # 1. the card
    card = kb.card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build the eight kernel sources, one nvcc each, at once
    phase = Phase("2 build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:  # the probes beside the kernels
        chain_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR)
        tf_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                           kb.TF_CHAIN_SRC)
        sha_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                            kb.SHA_CHAIN_SRC)
        secs = cuda_build.build_all(["spmv_mont", "ntt_mont", "blake3_cols", "seeded_gen",
                                     "mont_dot", "power_table", "mont_map", "sha256_cols"],
                                    force=True)
        chain_so, chain_log = chain_f.result()
        tf_so, _ = tf_f.result()
        sha_so, sha_chain_log = sha_f.result()
    log(f"build: {', '.join(f'{n}.cu {s:.2f} s' for n, s in secs.items())} and "
        f"scripts/blake3_chain.cu, scripts/threefry_chain.cu, scripts/sha256_chain.cu "
        f"({time.perf_counter() - t0:.2f} s wall) with nvcc {' '.join(cuda_build.NVCC_FLAGS)}")
    ptxas = kb.ptxas_report(spmv.build_log)
    for w32, (regs, st, ld) in sorted(ptxas.items()):
        log(f"  ptxas spmv_mont W32={w32}: {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    if ptxas.get(8, (None, 1, 1))[1:] != (0, 0):
        raise AssertionError(f"W32=8 kernel spills or was not reported: {ptxas.get(8)}")
    ntt_ptxas = kb.ptxas_report(cuda_build.build_logs["ntt_mont"], "ntt_pass_kernel")
    if sorted(ntt_ptxas) != [2, 4, 6, 8]:
        raise AssertionError(f"ntt_pass_kernel templates not reported: {ntt_ptxas}")
    for w32, (regs, st, ld) in sorted(ntt_ptxas.items()):
        log(f"  ptxas ntt_pass_kernel W32={w32}: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
    if ntt_ptxas[8][1:] != (0, 0):
        raise AssertionError(f"ntt_pass_kernel W32=8 spills: {ntt_ptxas[8]}")
    b3_ptxas = {k: v for name in B3_KERNELS
                for k, v in kb.ptxas_entries(cuda_build.build_logs["blake3_cols"],
                                             name).items()}
    if len(b3_ptxas) != 8:  # chunks 2 output types, the chunk tree 2 x 2 input types, 2
        raise AssertionError(f"blake3 kernels not reported by ptxas: {b3_ptxas}")
    for name, (regs, st, ld) in sorted(b3_ptxas.items()):
        log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    for name, (regs, st, ld) in kb.ptxas_entries(chain_log, "compress_chain_kernel").items():
        log(f"  ptxas {name} (the latency probe): {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    b3_mix = blake3_mix(kb, chain_so, cuda_build.so_path("blake3_cols"))
    sha_ptxas = {k: v for name in ("sha256_cols_kernel", "merkle_tree_kernel",
                                   "merkle_walk_kernel")
                 for k, v in kb.ptxas_entries(cuda_build.build_logs["sha256_cols"], name).items()}
    if len(sha_ptxas) != 6:  # the column hash 2 word types x 2 modes, the tree, the walk
        raise AssertionError(f"sha256 kernels not reported by ptxas: {sha_ptxas}")
    for name, (regs, st, ld) in sorted(sha_ptxas.items()):
        log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
        if st or ld:
            raise AssertionError(f"{name} spills: {st} / {ld} bytes")
    for name, (regs, st, ld) in kb.ptxas_entries(sha_chain_log, "chain_kernel").items():
        log(f"  ptxas {name} (the latency probe): {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    sha_mix = sha256_mix(kb, sha_so, cuda_build.so_path("sha256_cols"))
    prove_ptxas = {}
    for src_name, kname in (("seeded_gen", "seeded_gen_kernel"), ("mont_dot", "mont_dot_"),
                            ("power_table", "power_"), ("mont_map", "map_kernel")):
        found = kb.ptxas_entries(cuda_build.build_logs[src_name], kname)
        n_want = {"seeded_gen": 12, "mont_dot": 20, "power_table": 4, "mont_map": 20}[src_name]
        if len(found) != n_want:
            raise AssertionError(f"{src_name} kernels not reported by ptxas: {found}")
        for name, (regs, st, ld) in sorted(found.items()):
            log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill "
                f"loads")
        prove_ptxas[src_name] = found
    for src_name, kname in (("seeded_gen", "seeded_gen_kernelILi8ELi37E"),
                            ("mont_dot", "mont_dot_tc_kernel"),  # every W
                            ("mont_dot", "mont_dot_thin_tc_kernel"),  # every W and y form
                            ("power_table", "power_planes_kernelILi8E"),
                            ("mont_map", "mont_mul_map_kernelILi8E"),  # both ops at W32 = 8
                            ("mont_map", "mont_addsub_map_kernelILi8E")):  # all three
        for k, (regs, st, ld) in prove_ptxas[src_name].items():
            if kname in k and (st or ld):
                raise AssertionError(f"{k} spills: {st} / {ld} bytes")
    serial = [ln for ln in cuda_build.build_logs["mont_dot"].splitlines() if "serialized" in ln]
    if serial:  # ptxas could not keep the wgmmas in flight
        raise AssertionError(f"mont_dot: {serial}")
    gen_mix = generator_mix(torch, kb, tf, tf_so, cuda_build.so_path("seeded_gen"))
    loop = kb.sass_loop(spmv.SO_PATH)
    if loop is None:
        log("  SASS: cuobjdump not found, k-loop count not measured")
    else:
        log(f"  SASS W32=8 k loop (64 wide products a nonzero): {loop[0]} "
            f"instructions, {loop[2]:.3f} per wide product; opcodes {loop[1]}")
    if native.get_lib() is None:
        raise RuntimeError("native C library did not build (needed for matgen)")
    phase.done()

    spec = P.FT255
    ops = get_ops(spec)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    size = f"2^{N_COEFFS.bit_length() - 1}"

    # the 2^23 coefficients both main paths commit to, and their evaluation
    canon, coeffs_mont = main_coeffs(torch, spec, ops, gen)
    raw = canon.cpu().numpy().astype("<u2").T.copy().tobytes()
    coeffs = [int.from_bytes(raw[32 * i : 32 * i + 32], "little")
              for i in range(N_COEFFS)]
    del raw, canon
    x_pt = (coeffs[0] * 0x9E3779B97F4A7C15 + 12345) % spec.p
    want = P.univariate_eval(spec, coeffs, x_pt)
    del coeffs

    # 3. SpMV kernel vs plain on the 2^23 levels
    phase = Phase("3 spmv vs plain")
    t0 = time.perf_counter()
    enc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device="cuda")
    pre, post, rs = enc.device_mats()
    torch.cuda.synchronize()
    log(f"brakedown {size}: n_per_row {enc.n_per_row}, n_cols {enc.n_cols}, "
        f"{len(pre)} precode + {len(post)} postcode levels + RS, "
        f"matgen + device matrices {time.perf_counter() - t0:.2f} s")
    levels = ([(f"pre{i}", dm) for i, dm in enumerate(pre)] + [("rs", rs)]
              + [(f"post{i}", dm) for i, dm in enumerate(post)])
    log("spmv kernel vs plain: tolerance 0 — exact field arithmetic, every limb equal")
    rows = []
    commit_tot = compare_levels(torch, kb, spmv, spec, levels, R_COMMIT, gen, "r=36", rows)
    verify_tot = compare_levels(torch, kb, spmv, spec, levels, 2, gen, "r=2", rows)
    for field in P.ALL_FIELDS:  # every template of the kernel, W32 = 2, 4, 6, 8
        edge_levels(torch, kb, spmv, field, gen)

    phase.done()

    # 4. the Brakedown path at 2^23, its golden fixture, and its streaming commit
    phase = Phase("4 brakedown 2^23")
    n_levels = len(pre) + len(post) + 1
    # prove and verify's column check collapse through mont_dot, on the CUDA
    # cores (K = 36 rows against 235,173 and 6,593 columns: below the thin
    # tensor-core kernel's crossover), the evaluation's dot too; Brakedown
    # has no power table
    # one conversion launch in the commit (the codeword's limbs -> its hash
    # words), five in verify: the proof rows to Montgomery limbs, the
    # encoded rows at the opened columns and the opened columns to canonical
    # words, the evaluation's two operands to Montgomery form
    sdig = main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, "sdig",
                     SDIG_KERNELS | hashing, P.BLAKE3, TREE_LAUNCHES_PATH)
    check_map_launches(sdig[8], "sdig", {"commit": 1, "prove": 0, "verify": 5})
    if sdig[0]["spmv_mont"] != 2 * n_levels:
        raise AssertionError(f"spmv launches {sdig[0]['spmv_mont']} != 2 encodes x "
                             f"{n_levels} levels")
    log(f"  spmv_mont launches {sdig[0]['spmv_mont']} (= 2 encodes x {n_levels} levels)")
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, -(-N_COEFFS // enc.n_per_row))
    for fn in counters.values():
        fn.launches = 0
    scomm, s_ms = time_host(torch, lambda: P.commit_streaming(coeffs_mont, enc))
    s_launches = {name: fn.launches for name, fn in counters.items()}
    if scomm.get_root() != sdig[6]:
        raise AssertionError("sdig streaming root != the in-memory root")
    sproof = scomm.prove(outer, transcript_for(P, enc)(sdig[6]))
    if P.wire.serialize_proof(spec, sproof) != sdig[7]:
        raise AssertionError("sdig streaming proof bytes != the in-memory proof")
    if s_launches["spmv_mont"] != n_levels * -(-scomm.n_rows // scomm.row_block):
        raise AssertionError(f"sdig streaming: spmv launches {s_launches}")
    check_hash_launches(s_launches, TREE_LAUNCHES_STREAM, "sdig commit_streaming")
    log(f"  sdig commit_streaming {s_ms:.1f} ms ({scomm.row_block}-row blocks, words kept "
        f"{'on the card' if scomm.words_dev is not None else 'nowhere'}): root and proof bytes "
        f"equal to the in-memory commit's; launches {s_launches}")
    del enc, pre, post, rs, levels, scomm, sproof
    with open(os.path.join(ROOT, "tests", "data", "torch_golden_sdig.json")) as f:
        golden = json.load(f)
    genc = P.SdigEncoding(spec, golden["n_per_row"], seed=golden["matrix_seed"],
                          device="cuda")
    groot, gdata = golden_run(torch, P, genc, spec, golden, P.BLAKE3)
    if groot.hex() != golden["root"] or \
            hashlib.sha256(gdata).hexdigest() != golden["proof_sha256"]:
        raise AssertionError("sdig golden fixture not reproduced on the GPU")
    log(f"sdig golden fixture: root {groot.hex()[:16]}.. and proof sha256 reproduced")
    torch.cuda.empty_cache()
    phase.done()

    # 5. NTT kernel vs plain at the Ligero shapes and on edge cases
    phase = Phase("5 ntt vs plain")
    lenc = P.LigeroEncoding.new(spec, N_COEFFS, *LIGERO_RHO)
    n_rows = -(-N_COEFFS // lenc.n_per_row)
    log(f"ligero {size} rho={LIGERO_RHO[0]}/{LIGERO_RHO[1]}: n_rows {n_rows}, "
        f"n_per_row {lenc.n_per_row}, n_cols {lenc.n_cols}, "
        f"{lenc.get_n_col_opens()} column openings, "
        f"{lenc.get_n_degree_tests()} degree test(s)")
    plan = nttm.get_ntt(spec, lenc.n_cols)
    log(f"ntt kernel vs plain: tolerance 0 — exact field arithmetic, every limb and word "
        f"equal; passes {[dataclasses.astuple(ps) for ps in plan.passes]} (hi, lo, log_t)")
    ntt_rows = []
    xc = kb.random_mont(spec, (n_rows, spec.w16, lenc.n_per_row), gen)
    xc = xc.permute(1, 0, 2).contiguous()
    ntt_commit = compare_ntt(torch, kb, nttm, plan, xc, "commit", ntt_rows, words=True)
    enc_ms = kb.time_kernel(lambda: lenc.encode_rows_words(xc))
    log(f"  encode_rows_words at the commit shape (every pass, limbs and words): "
        f"{enc_ms:.4f} ms")
    del xc
    xv = kb.random_mont(spec, (2, spec.w16, lenc.n_per_row), gen).permute(1, 0, 2)
    ntt_verify = compare_ntt(torch, kb, nttm, plan, xv.contiguous(), "verify", ntt_rows,
                             words=False)
    ntt_2_19(torch, kb, nttm, spec, gen, ntt_rows)
    for field in P.ALL_FIELDS:  # every template, W32 = 2, 4, 6, 8
        ntt_edges(torch, kb, nttm, field, gen)
    torch.cuda.empty_cache()
    phase.done()

    # 6. the Ligero path at 2^23 and its golden fixture under both digests
    phase = Phase("6 ligero 2^23")
    # prove collapses through mont_dot (the thin tensor-core kernel);
    # verify at 2^17 columns takes the route protocol.VERIFY_COLS_MIN
    # picks: at the opened columns (one power table, mont_dot's tile kernel
    # and a thin launch summing its K splits, no encode) or through the
    # encode (the NTT); either way the column check runs on the thin
    # tensor-core kernel and the evaluation's dot on the thin kernel.
    # The commit's hash words come from the NTT's last pass: no conversion;
    # verify converts the proof rows, the opened columns and the
    # evaluation's two operands (four mont_mul_map launches; the encode
    # route one more, the encoded rows at the opened columns)
    cols_route = verify_at_columns(lenc.n_cols)
    lig = main_path(torch, P, counters, lenc, coeffs_mont, x_pt, want, card, "ligero",
                    ligero_kernels(lenc.n_cols) | hashing, P.BLAKE3, TREE_LAUNCHES_PATH)
    check_map_launches(lig[8], "ligero", {"commit": 0, "prove": 0,
                                          "verify": ligero_verify_maps(lenc.n_cols)})
    per_encode = plan.launches_per_call
    encodes, tables = (1, 1) if cols_route else (2, 0)
    if lig[0]["ntt_mont"] != encodes * per_encode or lig[0]["power_table"] != tables:
        raise AssertionError(f"ntt launches {lig[0]['ntt_mont']} != {encodes} encode(s) x "
                             f"{per_encode}, or power_table {lig[0]['power_table']} != {tables}")
    n_rows = -(-N_COEFFS // lenc.n_per_row)
    outer, inner = P.univariate_tensors(spec, x_pt, lenc.n_per_row, n_rows)
    lig_routes = verify_routes(torch, P, lenc, lig[7], lig[6], outer, inner,
                               transcript_for(P, lenc), "ligero 2^23")
    log(f"  ntt launches {lig[0]['ntt_mont']} ({encodes} encode(s), {per_encode} passes each; "
        f"verify {'evaluates at the columns' if cols_route else 'encodes the rows'} at "
        f"{lenc.n_cols} columns), power_table {tables}, "
        f"mont_dot {lig[0]['mont_dot']}")
    with open(os.path.join(ROOT, "tests", "data", "torch_golden_ligero.json")) as f:
        golden = json.load(f)
    genc = P.LigeroEncoding.new(spec, golden["length"], *golden["rho"])
    for name, want_d in golden["digests"].items():
        groot, gdata = golden_run(torch, P, genc, spec, golden, P.DIGESTS_BY_NAME[name])
        if groot.hex() != want_d["root"] or \
                hashlib.sha256(gdata).hexdigest() != want_d["proof_sha256"]:
            raise AssertionError(f"ligero {name} golden fixture not reproduced on the GPU")
        log(f"ligero golden fixture ({name}): root {groot.hex()[:16]}.. and proof "
            f"sha256 reproduced")
    # the coefficients wait in host memory for phase 14, so that phases 7-12
    # see the card as before
    coeffs_host = coeffs_mont.cpu()
    del coeffs_mont, lenc, genc
    torch.cuda.empty_cache()
    phase.done()

    # 7. the BLAKE3 kernels against their plain versions
    with Phase("7 blake3 vs plain"):
        hashes = blake3_phase(torch, kb, b3, gen, chain_so)
        torch.cuda.empty_cache()

    # 8. streaming against in-memory at 2^26
    with Phase("8 streaming vs in-memory 2^26"):
        stream26 = streaming_2_26(torch, P, counters, gen)

    # 9. the streaming path at 2^28
    with Phase("9 streaming ligero 2^28"):
        big = path_2_28(torch, kb, P, counters, b3, nttm, gen, card)

    # 10. the prover's kernels against their plain versions
    with Phase("10 seeded_gen, mont_dot, power_table vs plain"):
        prv = prove_kernels_phase(torch, kb, P, tf, md, gen, gen_mix)
        torch.cuda.empty_cache()

    # 11. the slice's path: seeded 2^29
    with Phase("11 seeded ligero 2^29"):
        s29 = path_2_29(torch, kb, P, counters, md, card)
        torch.cuda.empty_cache()

    # 12. the field maps against their plain versions
    with Phase("12 mont_mul_map, mont_addsub_map vs plain"):
        maps = mont_map_phase(torch, kb, P, mm, gen)
        torch.cuda.empty_cache()

    # 13. the SHA-256 kernels against their plain versions
    with Phase("13 sha256 vs plain"):
        shas = sha256_phase(torch, kb, sha, gen, sha_so)
        torch.cuda.empty_cache()

    # 14. the slice's paths with SHA-256: Ligero and Brakedown 2^23, Ligero
    # 2^28 streaming
    coeffs_mont = coeffs_host.cuda()
    del coeffs_host
    with Phase("14 sha256 paths"):
        sha_paths = sha256_paths(torch, kb, P, counters, sha, coeffs_mont, x_pt, want,
                                 card, gen, {"ligero": lig[8], "sdig": sdig[8]},
                                 shas["plain_compression_launches"])
        torch.cuda.empty_cache()

    # 15. the sharded paths: world 1 on NCCL here, then two ranks on the card
    with Phase("15 sharded paths"):
        shard = sharded_phase(torch, kb, P, counters, coeffs_mont, x_pt, want, card)
        del coeffs_mont
        torch.cuda.empty_cache()

    # 16. kernel table
    c23, c28 = hashes["2^23 commit"], hashes["2^28 column length"]  # blake3_chunks
    kernels = [{
        "name": "spmv_mont",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/spmv_mont.cu",
        "replaces": "lcpc_tpu/ops/spmv_pallas.py:180",
        "launches": sdig[0]["spmv_mont"],
        "max_abs_err": max(commit_tot["err"], verify_tot["err"]),
        "ms": commit_tot["ms"],
        "plain_ms": commit_tot["plain_ms"],
        "bound_ms": commit_tot["bound_ms"],
        "bound_by": commit_tot["bound_by"],
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": f"one {size} ft255 commit encode: {n_levels} launches at r={R_COMMIT}",
        "verify_encode_ms": verify_tot["ms"],
        "verify_encode_plain_ms": verify_tot["plain_ms"],
        "verify_encode_bound_ms": verify_tot["bound_ms"],
        "verify_encode_bound_by": verify_tot["bound_by"],
        "ptxas_w32_8": {"registers": ptxas[8][0], "spill_bytes": ptxas[8][1] + ptxas[8][2]},
        "sass_per_wide_product": None if loop is None else loop[2],
    }, {
        "name": "ntt_mont",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/ntt_mont.cu",
        "replaces": "lcpc_tpu/ops/ntt.py:80 (_ntt_forward, XLA-fused, not Pallas)",
        "launches": lig[0]["ntt_mont"],
        "max_abs_err": max(r["err"] for r in ntt_rows),
        "ms": ntt_commit["ms"],
        "plain_ms": ntt_commit["plain_ms"],
        "bound_ms": ntt_commit["bound_ms"],
        "bound_by": ntt_commit["bound_by"],
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": (f"one {size} ft255 rho=1/4 commit encode: R={ntt_commit['r']} rows of "
                  f"{ntt_commit['k']} padded to n={ntt_commit['n']}, limbs and hash words, "
                  f"{per_encode} launches"),
        "limbs_only_ms": ntt_commit["limbs_only_ms"],
        "encode_rows_words_ms": enc_ms,
        "verify_encode_ms": ntt_verify["ms"],
        "verify_encode_plain_ms": ntt_verify["plain_ms"],
        "verify_encode_bound_ms": ntt_verify["bound_ms"],
        "verify_encode_bound_by": ntt_verify["bound_by"],
        "ptxas": {str(w): {"registers": v[0], "spill_bytes": v[1] + v[2]}
                  for w, v in sorted(ntt_ptxas.items())},
        "n_2_19_block_words_only_ms": big["block_words_only_ms"],
        "launches_2_28_path": big["launches"]["ntt_mont"],
        "launches_2_29_path": s29["launches"]["ntt_mont"],
    }, {
        "name": "blake3_chunks",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/blake3_cols.cu",
        "replaces": ("lcpc_tpu/ops/blake3_jax.py:130,160,249 (chunk_chain_scan, "
                     "_hash_words_streams, hash_word_columns) and lcpc_tpu/core/streaming.py:48,90 "
                     "(_update_fn, _finalize_fn); XLA-fused, not Pallas"),
        "launches": big["launches"]["blake3_chunks"],
        "max_abs_err": hashes["max_abs_err"],
        "ms": c23["k1_ms"],
        "plain_ms": c23["k1_plain_ms"],
        "bound_ms": c23["k1_bound_ms"],
        "bound_by": c23["k1_bound_by"],
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": (f"the {size} ft255 rho=1/4 commit's columns: {c23['n_cols']} x "
                  f"{c23['n_words']} words, {c23['n_chunks']} chunks, one launch"),
        "launches_2_23_paths": {"sdig": sdig[0]["blake3_chunks"],
                                "ligero": lig[0]["blake3_chunks"]},
        "ms_2_28_commit": big["hashes"]["k1_ms"],
        "bound_ms_2_28_commit": big["hashes"]["k1_bound_ms"],
        "ms_2_28_length_4096_columns": c28["k1_ms"],
        "plain_ms_2_28_length_4096_columns": c28["k1_plain_ms"],
        "bound_ms_2_28_length_4096_columns": c28["k1_bound_ms"],
        "ptxas": {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                  for k, v in sorted(b3_ptxas.items()) if "chunks" in k},
        "sass_compression_alu_fma_all": b3_mix["per_compression_alu_fma_all"][
            b3_mix["least"]][:3],
    }, *tree_rows(hashes, big, sdig, lig, b3_ptxas, size, b3_mix),
        *prove_rows(prv, s29, big, sdig, lig, prove_ptxas, gen_mix),
        *map_rows(maps, s29, big, sdig, lig, prove_ptxas["mont_map"], shard),
        *sha_rows(shas, sha_paths, sha_ptxas, sha_mix)]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_levels.json"), "w") as f:
        json.dump({"card": card, "levels": rows, "ntt": ntt_rows,
                   "sass_k_loop": loop and loop[:3], "blake3_sass": b3_mix,
                   "main_path_ms": {
                       name: {"cold": r[1], "warm": r[2], "median": r[3],
                              "peak_gib": r[4], "proof_bytes": r[5]}
                       for name, r in (("sdig", sdig), ("ligero", lig))},
                   "blake3": hashes, "streaming_2_26": stream26, "path_2_28": big,
                   "prove_kernels": prv, "path_2_29": s29, "mont_map": maps,
                   "sha256": shas, "sha256_paths": sha_paths, "sha256_sass": sha_mix,
                   "stage_launches": {"sdig": sdig[8], "ligero": lig[8]},
                   "verify_routes_2_23": lig_routes,
                   "sharded": shard,
                   "run_s": time.perf_counter() - T_START}, f, indent=1)
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--sharded-rank"]:  # one rank of phase 15 (b)
            sys.exit(sharded_rank(*sys.argv[2:6]))
        sys.exit(main())
    except Exception:  # every phase is fatal: report and exit non-zero
        traceback.print_exc()
        sys.exit(1)
