#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lcpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (each prints the seconds it took):
  1. print the card's name and power limit (nvidia-smi);
  2. build the eleven CUDA kernel sources from the checkout, one nvcc each,
     started together with the probes (csrc/spmv_mont.cu, csrc/ntt_mont.cu,
     csrc/blake3_cols.cu, csrc/seeded_gen.cu, csrc/mont_dot.cu,
     csrc/power_table.cu, csrc/mont_map.cu, csrc/sha256_cols.cu,
     csrc/verify_core.cu, csrc/commit_small.cu, csrc/mxu_ntt.cu); print
     ptxas's registers and spills per template (fatal if the SpMV's, the
     NTT's, the generator's, the power table's, either field map's or
     either verify_core kernel's W32 =
     8 spills, any of mont_dot's tensor-core templates (tile and thin_tc)
     spills, or ptxas serializes its wgmmas, or any SHA-256 kernel spills,
     the few-column column hash and the walk included, or the NTT's words-in
     first pass at W32 = 8 spills, or BLAKE3's walk (a quad of lanes a
     column) has a stack frame or spills, or the four-step NTT's kernel
     (mxu_dft_kernel, W32 = 8) spills;
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
     scripts/sha256_chain.cu), from which every SHA-256 bound is counted,
     and the few-column kernel's round loop (its ALU instructions a round);
  3. hold the SpMV kernel against its plain PyTorch version
     (apply_mat_plain), bit for bit, on every level of the 2^23 ft255
     Brakedown encoding at r = 36 (the commit's row count), on every level at
     r = 2 (verify's), and on ragged edge levels (an empty row, a row of K =
     96 all p-1 over inputs all p-1, mixed lengths) in each of the four
     fields (every W32 template) at every lane split; time both against the
     bound of each level's nonzeros;
  4. drive the Brakedown path at 2^23 ft255 CODE3 BLAKE3 through the public
     entry points: commit -> prove -> verify once cold (kernel launches
     counted: BLAKE3's commit hash by blake3_chunks and 1 chunk tree, 1
     Merkle tree, verify's opened columns by 1 launch of the few-column
     kernel and 1 path walk; the collapse through mont_dot's CUDA-core
     thin kernel;
     mont_mul_map; verify_check; gather_open) and 3 times warm (median
     ms), then once traced by stage (mont_mul_map launched once in commit,
     where the plain limb graph converted the codeword to hash words, once
     in verify, the proof rows to Montgomery words written straight into the
     encode's level buffer (PR 20: no pack after it); verify's core after the
     rows exactly 3 launches, verify_check, the column hash and the walk,
     prove's opening one gather_open; every CUDA event of each stage, its
     host-device copies apart, beside commit a2037ab's); check the
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
     words' reductions and the bytes; the words-in first pass (PR 20:
     verify's canonical proof rows taken to Montgomery form as the first
     pass loads them) bit-equal to mont_mul_map's to_mont then the NTT at R
     = 2, n = 2^17, 2^19 and 2^20 and on one-pass edges in every field, and
     the 2^23 verify rows' conversion and encode timed by both routes in
     turns;
  6. drive the Ligero path at 2^23 ft255 rho = 1/4 BLAKE3 the same way as
     phase 4 (one cold run with the launches counted, 3 warm: prove's
     collapse through mont_dot's thin tensor-core kernel; verify's rows by
     the route protocol.VERIFY_COLS_MIN picks at 2^17 columns: the encode
     (a second encode, whose first NTT pass converts the proof rows as it
     loads them: no mont_mul_map launch, PR 20) or at the opened columns
     (one power table and the tile kernel, one conversion through
     mont_mul_map); the column check and the evaluation in verify_check; no
     conversion in commit), traced by stage as in phase 4, with
     the evaluation and tamper checks; verify by both routes on the same
     proof (verify_routes: equal values, the same error kind for a flipped
     opened value, both timed); reproduce its golden fixture
     (tests/data/torch_golden_ligero.json) under BLAKE3 and SHA-256 (the
     SHA-256 kernels);
  7. hold the BLAKE3 kernels (blake3_chunks; the chunk tree, the
     few-column kernel, merkle_tree and merkle_walk, one launch each)
     against their plain versions, word for word: the 2^23 Ligero
     commit's columns (2,048 words x 131,072), the
     2^28 commit's column length (16,384 words) over 4,096 columns, 189
     columns of both lengths, Brakedown's 6,593 opened columns, edge lengths
     (1, 8, 248, 504, 760, 2,040 words; a few columns also against the host
     hash), the chunk tree in both of its modes (a thread or a warp per
     column), streaming updates with carries of 0, 8 and 255 words, Merkle
     trees of 2^17 and 2^19 leaves and of 357,699 leaves padded to 2^19
     (and 1, 2, 300 and 513 leaves), path walks (PR 20: a quad of lanes a
     column) at 1, 5, 33, 189 and 6,593 columns x 0, 1, 17, 19 and 20
     levels with repeated columns, in the roots form and the verifier's
     (the flag kept on honest paths, cleared by a sibling tampered at the
     first or the last level or by a tampered digest); time each (device,
     and the trees' host wall; the walks at 189 x 17 and 6,593 x 19 warm
     and cold, both forms) against its bound and the trees against their
     dependency floor (depth x one compression's latency, from a chain of
     4,096 in scripts/blake3_chain.cu, in each of its layouts: one thread,
     one thread with its adds on the FMA pipe, one quad of lanes, the
     walk's floor the quad's); the few-column kernel (hash_word_columns'
     "few" route, words to digests in one launch) against its plain version
     and the wide route (blake3_chunks, then the chunk tree) at verify's
     three shapes, 1, 31 and 33 columns of 8 .. 16,384 words
     (B3_FEW_WORDS) and FEW_COLS_MAX columns, verify's shapes timed warm
     and cold in turns wide, few, few, wide beside the bound and the floor
     (a chunk's compressions and the chunk tree's levels);
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
     FieldOps, collapse_canon_plain); the BLAKE3 trees and the few-column
     kernel launched 4 times (verify's core counted again: 3 launches);
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
     launches counted (the generator, the NTT, blake3_chunks, the trees
     and the few-column kernel 4 times, mont_dot, the power table; verify's
     core counted again: 3 launches), then warm runs (median ms
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
     32,768 words -> words and limbs), Brakedown 2^23 verify's rows (2 x
     235,173 words -> the encode's packed level buffer in one launch, PR 20,
     against the old route, to limbs then a pack and a copy, timed in turns
     old, new, new, old), verify's opened columns (256 x 189
     and 36 x 6,593 words -> hash words), the 2^28 streaming prove's opened
     columns (2,048 x 189 hash words -> words), add and sub at the codeword's
     shape; each timed beside its bound (bytes or wide products) and the
     plain version; edges in every field (unreduced inputs up to R - 1, 1,
     7 and 41 elements, every form in and out, broadcast and
     non-contiguous operands, no elements);
  13. hold the SHA-256 kernels (csrc/sha256_cols.cu: sha256_cols by its
     two kernels, the few-column one and the wide one, each forced and as
     ops/sha256.cols_route picks, the paths' full widths by the kernel it
     picks; the Merkle tree and the walk, one launch each) against their
     plain versions, word for word: path (a)'s columns
     (2,048 words x 131,072), the 2^28 column length (16,384 words) over
     4,096 columns, path (b)'s (288 words x 357,699), the first 1, 31, 32,
     33, 189 and 6,593 columns of those alone and the route's crossover
     (FEW_COLS_MAX and one more column), int32 and int64 words, edge
     lengths (1, 5, 7, 8, 56, 600 words over 300 columns and their first 1,
     31, 32, 33 and 189; a few columns also against hashlib), words with
     every bit set, streaming updates by each kernel from carries of 0, 8
     and 15 words with blocks of 1, 7, 8, 9 and 1,792 words state by state,
     finalizes at rem 12, 13 and 14 (one final block, then two), Merkle
     trees of 2^17 and 2^19 leaves and of 357,699 padded to 2^19 (and 1, 2,
     300 and 513 leaves), walks of 189 x 17 and 6,593 x 19 (and 5 x 0, 40 x
     3); time each against its bound (its bytes, or its compressions or
     parents by the probes' SASS) and the plain version, verify's column
     shapes by both kernels also against their floor (a column's
     compressions x one compression's latency), their critical path (the
     round loop's longest dependent chain in the SASS, each instruction at
     its latency from the probe's op chains: the card's, not the code's)
     and one warp's issue (the measured clocks an ALU instruction of the
     round loop), every tree (the odd ones too) against its dependency
     floor (depth x the fastest parent's latency) and critical path (depth
     x a parent's SASS chain), the walks against their critical path and
     one warp's issue (depth x 128 rounds of the few-column kernel's round:
     its SASS chain, its ALU instructions at the measured clocks) and a
     lone thread's parent latency x depth;
  14. the slice's paths with digest=SHA256 through the public entry points:
     (a) Ligero 2^23 and (b) Brakedown 2^23 as phases 6 and 4 run them
     (cold with the launches counted, 3 warm, traced by stage: commit one
     sha256_cols (the wide kernel) and one tree, verify one sha256_cols (the
     kernel cols_route picks for the opened columns) and one walk, no
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
  16. hold verify_core.cu's kernels and the walks in their verifier form
     against their plain versions, tolerance 0, at the Ligero 2^23,
     Brakedown 2^23 and seeded 2^29 verify shapes (ft255, T = 2 rows of 256,
     36, 2,048 against 189, 6,593, 189 opened columns, the evaluation over
     32,768, 235,173, 262,144) and at a small shape in ft63, ft127 and ft191
     (36 rows, 189 of 4,096 columns, 4,096 terms: every W32 template), the
     opened columns drawn with replacement (unsorted, a column opened
     twice), with BLAKE3 (both verify routes: the encoded rows at the opened
     columns, or the rows at the columns) and SHA-256, on honest inputs and
     four tampers (a column word, an encoded row at an opened column, a
     sibling digest, the root), which clear the same flags; gather_open from
     the codeword's limbs, from int64 words (in order and reversed) and, at
     the small shapes, from kept canonical words and a tail keep; at ft255
     verify_check timed warm and cold (kernel_bench.time_kernel_cold: the
     L2 flushed between launches) beside its bound (bytes over 3.35 TB/s
     or wide products at 8.4 T/s) and its plain version, the walks in their
     verifier form timed, gather_open at each path's opening (the
     codeword's limbs at 2^23, the evaluated columns' int64 words at 2^29)
     and at the 2^28 words-kept opening (2,048 rows x 189 columns of kept
     canonical words, their columns cut to 2^16), warm and cold beside its
     bound (bytes), the floor of the random-sector probe
     scripts/gather_probe.cu (one load per distinct 32-byte sector at the
     same count, cold), its plain version and the PyTorch index_select
     alone, warm and cold;
  17. commit -> prove -> verify Ligero rho = 1/4 and Brakedown, BLAKE3, at
     2^15 coefficients in ft63, ft127 and ft191 on the card and through the
     port's CPU path: roots and proof bytes equal, every proof verified
     (the polynomial's value), verify_check and gather_open launched (each
     commit on the card one launch of the small commit's kernel: its
     W32 = 2, 4 and 6 instances);
  18. the small commits by the kernel (csrc/commit_small.cu, one
     cooperative launch: core/protocol.py's _commit_fused_fn) against the
     stages launched one by one and the kernel's plain version, the route
     forced through _FUSED_COMMIT_MAX: Ligero rho = 1/4 at 2^11, 2^13, 2^15,
     2^16, 2^17, 2^19, 2^20 and Brakedown CODE3 at 2^13, 2^15, 2^17, 2^19,
     2^21 ft255 (every size lcpc_tpu fuses), BLAKE3 and SHA-256 at each:
     the first commit on a fresh encoding and a warm one each one launch
     and no other counter moved, a kernel commit captured in a CUDA graph
     one kernel node and nothing else, torch.profiler seeing the kernel
     alone (its events a lower bound in this run); matrices, codewords,
     Merkle arrays and roots equal
     to the staged route's and the plain version's on seeded coefficients
     and on all-(p-1) limbs of length n - 3 (at 2^13 also the CPU path's);
     the port's gates take the kernel exactly under them; host walls of
     the first commit by each route and warm medians in turns (staged,
     kernel, kernel, staged; 16 each), the kernel's device ms beside its
     bound and the staged route's, ptxas's registers and spills;
  19. hold the inverse NTT kernel (csrc/ntt_mont.cu's inverse pass) against
     intt_inverse_plain, bit for bit, in every field (n = 2, 4, 2^10, 2^11,
     2^12, and 2^12 in three passes; rows random, zeros, p - 1, p - 1 - (i
     mod 7)), and at 2 and 256 x 2^17 ft255; intt(ntt(x)) == x at 256 x
     2^17; the reference's FFT identity (the codeword collapsed by the
     outer tensor with mont_dot, inverse-transformed: the collapsed
     coefficients, then zeros) at 2^13 (commit by the small commit's
     kernel) and 2^23 (staged); time it warm and cold at 2 x 2^17 and 256 x 2^17 beside its
     bound and plain version;
  20. the four-step NTT on the tensor cores (ops/mxu_ntt.py's MxuNtt,
     csrc/mxu_ntt.cu, two launches a transform) with encodings/ligero.
     MXU_NTT forced true: (a) its kernel against mxu_ntt_plain, bit for
     bit, in every field (n = 16 .. 4,096, R = 1 .. 3, full and zero-padded
     plans, full and ragged rows of random values, all 0xFFFF limbs or
     0xFFFFFFFF words and values near p; limbs in to limbs, words (the
     canonical plan) and both, words in to limbs and both; contractions in
     2 and 4 chunks through the C entry); (b) against the ladder at the
     2^23 commit's transform (256 x 2^17 from 2^15, ft255; limbs and words,
     words alone) and verify's (2 rows of words in), timed warm and cold in
     turns ladder, mxu, mxu, ladder beside the NTT's bound (the lesser of
     the ladder's count and the four-step's: u8 products at 989.4e12/s,
     wide products at 8.4e12/s, bytes at 3.35 TB/s), and against its plain
     version at 2 and 16 rows of it; (c) the Ligero 2^23 path through it
     (main_path: root and proof bytes equal to phase 6's ladder route,
     verify's value, the tamper kinds), the path again in turns ladder,
     mxu, mxu, ladder (each stage's median, traced wall and device busy),
     and the 2^26 streaming commit's root equal to the ladder route's; (d) their
     launches: mxu_dft twice an encode, ntt_mont never;
  21. print the kernel table line, then the result line.

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
# phase 7: the few-column kernel's shapes beside verify's: columns x words
# (one chunk with ROOT at 248, two at 249, 17 chunks at 4,104, 65 at 16,384)
B3_FEW_COLS = (1, 31, 33)
B3_FEW_WORDS = (8, 248, 249, 504, 2_048, 4_104, 16_384)
DOT_KERNELS = {"mont_dot_thin", "mont_dot_thin_tc", "mont_dot_tile"}  # mont_dot's three
# the kernels a 2^23 path launches besides its hash kernels: Brakedown's
# SpMV, its collapse on mont_dot's CUDA-core thin kernel and its
# conversions; Ligero's NTT, its collapse on mont_dot's thin tensor-core
# kernel, the power table and mont_dot's tile kernel (a thin launch summing
# its K splits) of verify at the columns, its conversion; both paths'
# verify core and prove opening
SDIG_KERNELS = {"spmv_mont", "mont_dot", "mont_dot_thin", "mont_mul_map", "mont_mul_map_vec",
                "verify_check", "gather_open"}
LIGERO_KERNELS = {"ntt_mont", "mont_dot", "power_table", "mont_mul_map", "verify_check",
                  "gather_open"} | DOT_KERNELS


def verify_at_columns(n_cols):
    """Does a Ligero ft255 verify at n_cols columns evaluate the proof rows
    at the opened columns (the power table, mont_dot's tile kernel) rather
    than encode them (the NTT)?  protocol.VERIFY_COLS_MIN decides."""
    from lcpc_tpu_torch.core import protocol
    return n_cols >= protocol.VERIFY_COLS_MIN


def ligero_kernels(n_cols):
    """LIGERO_KERNELS as verify's route at n_cols uses them: through the
    encode, no power table, no tile kernel, no thin launch summing its
    splits and no mont_mul_map (the NTT's first pass converts the proof
    rows; nothing else on a path with the words kept launches them)."""
    if verify_at_columns(n_cols):
        return set(LIGERO_KERNELS)
    return LIGERO_KERNELS - {"power_table", "mont_dot_tile", "mont_dot_thin", "mont_mul_map"}


# mont_mul_map launches of a verify by mode (strided, element-contiguous):
# the proof rows to Montgomery form (the column check, the opened columns'
# hash words and the evaluation are verify_check's).  Brakedown: one,
# written into the encode's level buffer by the element-contiguous mode;
# Ligero: none through the encode (the NTT's first pass converts them as it
# loads them), one strided at the opened columns (before the tile kernel)
SDIG_VERIFY_MAPS = (0, 1)


def ligero_verify_maps(n_cols):
    """mont_mul_map launches by mode of a Ligero verify at n_cols columns."""
    return (1 if verify_at_columns(n_cols) else 0, 0)


def map_modes(launches):
    """mont_mul_map's launches by mode, (strided, element-contiguous), of a
    run's launches by counter."""
    return launches.get("mont_mul_map", 0), launches.get("mont_mul_map_vec", 0)


def check_verify_maps(verify, tag, want):
    """A verify's launches by counter hold `want` mont_mul_map launches by
    mode."""
    got = map_modes(verify)
    if got != want:
        raise AssertionError(f"{tag}: verify launched mont_mul_map {got} times by mode, "
                             f"not {want}")
    log(f"  {tag}: verify's mont_mul_map launches by mode (strided, element-contiguous) {got}")
SHA_KERNELS = ("sha256_cols", "sha256_merkle_tree", "sha256_merkle_walk")  # the counters
SHA_COLS_KERNELS = ("sha256_cols_few", "sha256_cols_wide")  # sha256_cols's two, by their counters
SHA_NARROW = (1, 31, 32, 33)  # phase 13: few-column kernel column counts beside 189 and 6,593
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
SHA_TREE_EDGES = ((1, 1), (2, 2), (300, 512), (513, 1024))  # phase 13: odd trees, also timed
SHA_BIG_WARM = 2            # warm runs of phase 14's 2^28 path (fewer when the time limit nears)
SHA_BIG_WARM_DEADLINE_S = 800
B3_WALK = "merkle_walk_quad_kernel"  # the path walk, a quad of lanes a column (PR 20)
B3_KERNELS = ("blake3_chunks_kernel", "chunk_tree_stack_kernel", "chunk_tree_warp_kernel",
              "blake3_cols_few_kernel", "merkle_tree_kernel", B3_WALK)
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
MAP_SDIG_VERIFY_ROWS = (2, 235_173)  # phase 12: the 2^23 Brakedown verify's proof rows
MAP_COLS_ROWS = (2, 262_144)  # phase 12: the 2^29 verify's rows as the columns route reads them
MAP_VEC_EDGE = (3, 1_031)     # phase 12: the element-contiguous mode in every field (rows x k)
WHOLE_MODE = "Lb1EE"  # in mont_mul_map_kernel<W, OP, true>'s names: the element-contiguous mode
MAP_VEC_REPS = 20             # phase 12: timed calls a turn
# (CUDA events torch.profiler saw, a lower bound; the port's kernel launches,
# exact) of a warm commit, prove and verify of each 2^23 path on the parent
# commit a2037ab, before verify's core and prove's opening were kernels
# (scripts/time_paths.py --repo archive/parent, two runs agreeing, on an
# NVIDIA H100 80GB HBM3 at 700 W)
PARENT_LAUNCHES = {"sdig blake3": ((26, 17), (16, 1), (48, 24)),
                   "ligero blake3": ((5, 5), (16, 1), (30, 13)),
                   "sha_sdig sha256": ((25, 16), (16, 1), (47, 23)),
                   "sha_ligero sha256": ((4, 4), (16, 1), (29, 12))}
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


NTT_WORDS_IN_LOGS = (17, 19, 20)  # phase 5: the words-in first pass at R = 2, every field


def ntt_words_in(torch, kb, P, nttm, lenc, gen):
    """Verify's proof rows through the NTT's words-in first pass
    (ntt_forward(input="words"): canonical words, any value below R, to
    Montgomery form as the first pass loads them; PR 20) bit-equal to
    mont_mul_map's to_mont, then ntt_forward, limbs and hash words, at R = 2,
    k = n / 4 and n = 2^NTT_WORDS_IN_LOGS in every field, and at n = 2 and
    2^10 (one pass) with k = 1 and n / 2 + 1; at the 2^23 Ligero verify's
    shape also against the plain version.  There the rows' encode (the
    conversion and every pass) is timed by both routes in turns old
    (mont_mul_map, then ntt_forward), new, new, old, warm and cold, beside
    its bound.  Returns the record."""
    from lcpc_tpu_torch.ops import mont_map as mm

    def rows(spec, r, k):  # canonical words below 2^(32 W32): some >= p, a row all ones
        x = torch.randint(-2**31, 2**31, (r, k, spec.w16 // 2), generator=gen, device="cuda",
                          dtype=torch.int32)
        x[0, : max(1, k // 8)] = -1
        return x

    def old(plan, x, output="limbs"):
        return nttm.ntt_forward(plan, mm.mont_mul_map(plan.spec, x.permute(2, 0, 1),
                                                      op="to_mont", in_form="words"),
                                output=output)

    cases = [(field, 1 << log_n, 1 << (log_n - 2)) for field in P.ALL_FIELDS
             for log_n in NTT_WORDS_IN_LOGS]
    cases += [(field, n, k) for field in P.ALL_FIELDS for n in (2, 1 << 10)
              for k in (1, n // 2 + 1)]
    for field, n, k in cases:
        plan = nttm.get_ntt(field, n)
        x = rows(field, 2, k)
        before = nttm.ntt_forward.launches
        got = nttm.ntt_forward(plan, x, input="words", output="both")
        if nttm.ntt_forward.launches - before != plan.launches_per_call:
            raise AssertionError(f"ntt words in {field.name} n={n}: not one launch a pass")
        ok, err = equal_outputs(torch, got, old(plan, x, "both"))
        if not ok:
            raise AssertionError(f"ntt words in {field.name} n={n} k={k}: != to_mont + ntt "
                                 f"(max err {err})")
    spec, plan = lenc.spec, nttm.get_ntt(lenc.spec, lenc.n_cols)
    x = rows(spec, 2, lenc.n_per_row)
    got = nttm.ntt_forward(plan, x, input="words")
    want, plain_ms = time_host(torch, lambda: nttm.ntt_forward_plain(plan, mm.mont_mul_map_plain(
        spec, x.permute(2, 0, 1), op="to_mont", in_form="words")))
    if not torch.equal(got, want):
        raise AssertionError("ntt words in at the 2^23 verify shape: != plain")
    rec = {"cases": [f"{f.name} n={n} k={k}" for f, n, k in cases], "plain_ms": plain_ms,
           "r": 2, "k": lenc.n_per_row, "n": plan.n}
    for mode, timer in (("", kb.time_kernel), ("cold_", kb.time_kernel_cold)):
        turns = [(tag, timer(fn)) for tag, fn in (
            ("old", lambda: old(plan, x)), ("new", lambda: lenc.encode_canon_rows(x)),
            ("new", lambda: lenc.encode_canon_rows(x)), ("old", lambda: old(plan, x)))]
        rec[f"{mode}turns"] = turns
        rec[f"{mode}ms"] = statistics.median(v for t, v in turns if t == "new")
        rec[f"old_{mode}ms"] = statistics.median(v for t, v in turns if t == "old")
    w32 = spec.w16 // 2
    nbytes, products, _ = ntt_cost(spec, 2, lenc.n_per_row, plan.n, False)
    nbytes -= 4 * w32 * 2 * lenc.n_per_row  # words in (W32 a element), not limbs (2 W32)
    products += 2 * lenc.n_per_row * (2 * w32 * w32 + w32)  # the conversion's product
    rec["bound_ms"], t_bytes, t_ops = bound_ms(nbytes, products)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"  ntt words in (the first pass converts canonical words): equal to mont_mul_map + "
        f"ntt_forward (limbs and words) in every field at R = 2, n = 2^{NTT_WORDS_IN_LOGS} "
        f"(k = n/4), n = 2 and 1,024 (k = 1, n/2 + 1); at the 2^23 verify shape equal to plain "
        f"({plain_ms:.1f} ms); verify's rows (conversion and encode) warm, turns old, new, new, "
        f"old {[(t, round(v, 4)) for t, v in rec['turns']]} ms, cold "
        f"{[(t, round(v, 4)) for t, v in rec['cold_turns']]}; bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")
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
        cuda = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = {"counters": {k: c.launches for k, c in counters.items() if c.launches},
                     "cuda_kernels": len(cuda),
                     "copies": {d: sum(1 for n in cuda if "Memcpy" in n and d in n)
                                for d in ("HtoD", "DtoH")}}
    return out


# kernels of verify's rows (the encode, or the rows at the opened columns)
# and of prove's collapse: the rest of a stage is verify's core and prove's
# opening
ROWS_KERNELS = {"spmv_mont", "ntt_mont", "mxu_dft", "mont_mul_map", "mont_mul_map_vec",
                "power_table", "mont_dot", *DOT_KERNELS}


def check_verify_core(verify, tag, digest):
    """Verify's core (everything after the rows) from its launches by
    counter: exactly 3 launches with either digest, verify_check, the
    column hash (BLAKE3's few-column kernel, or sha256_cols) and the walk
    once each; no blake3_chunks and no chunk tree.  Returns the core."""
    # sha256_cols's launches by kernel count them twice
    core = {k: n for k, n in verify.items() if k not in ROWS_KERNELS | set(SHA_COLS_KERNELS)}
    want = ({"verify_check": 1, "blake3_cols_few": 1, "merkle_walk": 1}
            if digest.name == "blake3" else
            {"verify_check": 1, "sha256_cols": 1, "sha256_merkle_walk": 1})
    if core != want:
        raise AssertionError(f"{tag}: verify's core launches {core}, not {want}")
    return core


def check_core_launches(stages, tag, digest):
    """Verify's core 3 launches (check_verify_core); prove's opening one
    gather_open; the stages' copies (torch.profiler's Memcpy events)
    logged."""
    verify, prove = stages["verify"]["counters"], stages["prove"]["counters"]
    core = check_verify_core(verify, tag, digest)
    opening = {k: n for k, n in prove.items() if k not in ROWS_KERNELS}
    if opening != {"gather_open": 1}:
        raise AssertionError(f"{tag}: prove's opening {opening}")
    log(f"  {tag}: verify's core {sum(core.values())} launches {core}, copies "
        f"{stages['verify']['copies']}; prove's opening {opening}, prove's copies "
        f"{stages['prove']['copies']}")
    return core


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
    parent = PARENT_LAUNCHES.get(f"{tag} {digest.name}")
    for i, (name, rec) in enumerate(stages.items()):
        port = sum(n for k, n in rec["counters"].items()  # sub-kernels counted twice
                   if k not in DOT_KERNELS and k not in SHA_COLS_KERNELS)
        log(f"  {tag} {name}: {rec['cuda_kernels']} CUDA events, {port} launches of the "
            f"port's kernels" + (f" (commit a2037ab's: {parent[i][0]}, {parent[i][1]})"
                                 if parent else "") + f"; by kernel {rec['counters']}")
    check_core_launches(stages, tag, digest)
    return launches, cold, warm, med, peak, len(data), root, data, stages


# BLAKE3 tree launches of commit -> prove -> verify: the chunk tree once in
# commit (the column digests), the Merkle tree in commit; in verify the
# few-column kernel (the opened columns, their chunk trees in it) and the
# path walk
TREE_LAUNCHES_PATH = {"chunk_tree": 1, "merkle_tree": 1, "merkle_walk": 1, "blake3_cols_few": 1}
# of commit_streaming -> prove: the column digests' chunk tree and the Merkle tree
TREE_LAUNCHES_STREAM = {"chunk_tree": 1, "merkle_tree": 1, "merkle_walk": 0}
# SHA-256 launches of commit -> prove -> verify in memory: the column hash in
# commit and in verify (the opened columns), the tree in commit, the walk in
# verify; by stage.  The column hash launches the kernel ops/sha256.cols_route
# picks for its columns.


def sha_cols_launches(*n_cols):
    """{counter of sha256_cols's kernel: launches} of one sha256_cols call
    over each of these column counts (ops/sha256.cols_route)."""
    from lcpc_tpu_torch.ops import sha256 as sha
    out = {}
    for n in n_cols:
        name = f"sha256_cols_{sha.cols_route(n)}"
        out[name] = out.get(name, 0) + 1
    return out


def sha_launches_stages(commit_cols, verify_cols, commit_calls=1):
    """SHA-256 launches by stage of a path committing to commit_cols columns
    in commit_calls sha256_cols calls (a streaming commit's updates and its
    finalize) and verifying verify_cols opened columns."""
    commit = {"sha256_cols": commit_calls, "sha256_merkle_tree": 1}
    for name, n in sha_cols_launches(commit_cols).items():
        commit[name] = n * commit_calls
    return {"commit": commit, "prove": {},
            "verify": {"sha256_cols": 1, "sha256_merkle_walk": 1,
                       **sha_cols_launches(verify_cols)}}


def sha_launches_path(commit_cols, verify_cols, commit_calls=1):
    """sha_launches_stages summed over the stages: what one cold run of the
    path launches."""
    out = {}
    for stage in sha_launches_stages(commit_cols, verify_cols, commit_calls).values():
        for name, n in stage.items():
            out[name] = out.get(name, 0) + n
    return out


def check_map_launches(stages, tag, want):
    """mont_mul_map's launches by stage and mode (map_modes) of a traced run
    equal `want`, and mont_addsub_map launched nowhere."""
    got = {name: map_modes(rec["counters"]) for name, rec in stages.items()}
    if got != want or any("mont_addsub_map" in rec["counters"] for rec in stages.values()):
        raise AssertionError(f"{tag}: mont_mul_map launches by stage and mode {got} != {want}")
    log(f"  {tag}: mont_mul_map launches by stage and mode (strided, element-contiguous) {got}; "
        f"mont_addsub_map none")


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
    lats = {}
    for layout in kb.CHAIN_LAYOUTS:  # one thread; its adds on the FMA pipe; a quad of lanes
        check(f"compress chain ({layout})", kb.compress_chain(chain_so, cv0, 4, layout),
              node[0, :, 0])
        lats[layout] = kb.time_kernel(lambda: kb.compress_chain(chain_so, cv0, CHAIN, layout),
                                      reps=3) / CHAIN
    lat_ms = lats["thread"]
    recs["compression_latency_ms"] = lat_ms
    recs["compression_latency_ms_by_layout"] = lats
    recs["layouts_sass"] = kb.chain_layout_mix(chain_so)
    log(f"  one compression's latency (a chain of {CHAIN}): one thread {lat_ms * 1e3:.4f} us, "
        f"one thread with its adds on the FMA pipe {lats['fma'] * 1e3:.4f} us, a quad of lanes "
        f"(the walk's) {lats['quad'] * 1e3:.4f} us; SASS a compression (ALU, FMA, all, SHFL; "
        f"the quad's a lane's) {recs['layouts_sass']}")

    def columns(tag, w, host_cols=0, timed=False):
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
                                           tag, timed)
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
            # a chunk's blocks are a chain: the longest, 16 compressions deep, is the floor
            depth = min(16, -(-(8 + n_words) // 16))
            rec.update(k1_ms=k1_ms, k1_plain_ms=k1_plain, k1_compressions=k1_c, k1_bytes=k1_b,
                       k1_floor_ms=depth * lat_ms, k1_depth=depth)
            rec["k1_bound_ms"], rec["k1_bound_by"] = hash_bound_ms(k1_b, k1_c)
            log(f"  blake3 {tag}: {n_cols} columns of {n_words} words ({n_chunks} chunks): "
                f"equal; blake3_chunks {k1_ms:.4f} ms (plain {k1_plain:.1f} ms, bound "
                f"{rec['k1_bound_ms']:.4f} ms, {rec['k1_bound_by']}; {k1_c} compressions; "
                f"floor {depth} x one compression's latency {rec['k1_floor_ms']:.4f} ms)")
        else:
            log(f"  blake3 {tag}: {n_cols} columns of {n_words} words ({n_chunks} chunks): "
                f"equal{f', {host_cols} columns equal to the host hash' if host_cols else ''}")
        recs[tag] = rec

    columns("2^23 commit", words(*B3_COMMIT), host_cols=2, timed=True)
    columns("2^28 column length", words(*B3_LONG), host_cols=1, timed=True)
    columns("2^23 verify (189 columns)", words(B3_COMMIT[0], B3_OPENED), timed=True)
    columns("2^28 verify (189 columns)", words(B3_LONG[0], B3_OPENED), timed=True)
    columns("brakedown 2^23 verify (6,593 columns)", words(288, 6_593), timed=True)
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

    def few(tag, w, timed=False):
        """The few-column route (one launch, words -> digests) against its
        plain version and the wide route, word for word; with `timed`, both
        routes warm and cold in turns wide, few, few, wide."""
        n_words, n_cols = w.shape
        before = b3.COLS_KERNELS["few"].launches
        got = b3.hash_word_columns(w, _route="few")
        if b3.COLS_KERNELS["few"].launches != before + 1:
            raise AssertionError(f"blake3 few {tag}: the kernel did not launch once")
        want, plain_ms = time_host(torch, lambda: b3.hash_word_columns_few_plain(w))
        check(f"few {tag} vs plain", got, want)
        check(f"few {tag} vs wide", got, b3.hash_word_columns(w, _route="wide"))
        if not timed:
            return
        total = 8 + n_words
        n_chunks, blocks = -(-total // 256), -(-total // 16)
        depth = min(16, blocks) + (n_chunks - 1).bit_length()
        nbytes, comps = 4 * n_words * n_cols + 64 * n_cols, (blocks + n_chunks - 1) * n_cols
        rec = {"n_words": n_words, "n_cols": n_cols, "n_chunks": n_chunks, "launches": 1,
               "plain_ms": plain_ms, "compressions": comps, "bytes": nbytes, "depth": depth,
               "floor_ms": depth * lat_ms}
        rec["bound_ms"], rec["bound_by"] = hash_bound_ms(nbytes, comps)
        for mode, timer in (("warm", kb.time_kernel), ("cold", kb.time_kernel_cold)):
            rec[f"{mode}_turns"] = [
                (route, timer(lambda: b3.hash_word_columns(w, _route=route)))
                for route in ("wide", "few", "few", "wide")]
            ms = {r: statistics.median(t for k, t in rec[f"{mode}_turns"] if k == r)
                  for r in ("wide", "few")}
            rec["ms" if mode == "warm" else "cold_ms"] = ms["few"]
            rec["wide_ms" if mode == "warm" else "wide_cold_ms"] = ms["wide"]
        rec["host_ms"] = host_ms(torch, lambda: b3.hash_word_columns(w, _route="few"))
        recs.setdefault("few", {})[tag] = rec
        log(f"  blake3 few {tag}: {n_cols} columns of {n_words} words ({n_chunks} chunks): "
            f"equal to plain and wide; 1 launch, device warm {rec['ms']:.4f} ms, cold "
            f"{rec['cold_ms']:.4f} (turns wide, few, few, wide: warm "
            f"{[round(t, 4) for _, t in rec['warm_turns']]}, cold "
            f"{[round(t, 4) for _, t in rec['cold_turns']]}), host wall {rec['host_ms']:.4f} ms; "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), floor {depth} x latency "
            f"{rec['floor_ms']:.4f} ms, plain {plain_ms:.1f} ms")

    for tag, (n_words, n_cols) in (("2^23 verify (189 columns)", (B3_COMMIT[0], B3_OPENED)),
                                   ("2^28 verify (189 columns)", (B3_LONG[0], B3_OPENED)),
                                   ("brakedown 2^23 verify (6,593 columns)", (288, 6_593))):
        few(tag, words(n_words, n_cols), timed=True)
    for n_cols in B3_FEW_COLS:
        for n_words in B3_FEW_WORDS:
            few(f"{n_cols} x {n_words}", words(n_words, n_cols))
    for n_words in (288, 2_048):
        few(f"FEW_COLS_MAX x {n_words}", words(n_words, b3.FEW_COLS_MAX))
    log(f"  blake3 few: {len(B3_FEW_COLS)} x {len(B3_FEW_WORDS)} shapes {B3_FEW_COLS} x "
        f"{B3_FEW_WORDS} and {b3.FEW_COLS_MAX} x 288, 2,048: equal to plain and wide")

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

    # the walk (a quad of lanes a column) against merkle_walk_plain at
    # 1 .. 6,593 columns x 0 .. 20 levels, repeated columns, both forms: the
    # roots, and the root compared in the kernel (the flag kept on honest
    # paths, cleared by a sibling tampered at the first or the last level or
    # by a tampered digest); scripts/time_blake3_walk.py's checks
    import time_blake3_walk as tbw
    n_walks = tbw.checks(b3, gen, None)
    log(f"  blake3 merkle walks of {tbw.CHECK_K} columns x {tbw.CHECK_LEVELS} levels "
        f"({n_walks} shapes): equal to plain in the roots form; in the verifier's form the flag "
        f"kept on honest paths, cleared by a tampered sibling (first, last level) or digest")
    for k, levels in WALKS:  # honest paths of a tree over random leaves, as verify walks them
        digs, sibs, inv, idx, root = tbw.tree_inputs(b3, gen, k, levels)
        got = b3.merkle_walk(digs, sibs, inv, idx)
        want, plain_ms = time_host(torch, lambda: b3.merkle_walk_plain(digs, sibs, inv, idx))
        check(f"merkle walk {k} x {levels}", got, want)
        check(f"merkle walk {k} x {levels} reaches the root", got, root[:, None].expand(8, k))
        flag = torch.ones(1, dtype=torch.int32, device="cuda")
        rec = {"columns": k, "levels": levels, "launches": 1, "plain_ms": plain_ms}
        for form, call in (("", lambda: b3.merkle_walk(digs, sibs, inv, idx)),
                           ("verifier_", lambda: b3.merkle_walk(digs, sibs, inv, idx, root=root,
                                                                flag=flag))):
            rec[f"{form}ms"] = kb.time_kernel(call)
            rec[f"{form}cold_ms"] = kb.time_kernel_cold(call)
        if int(flag) != 1:
            raise AssertionError(f"blake3 merkle walk {k} x {levels}: honest paths cleared the "
                                 f"flag")
        rec["host_ms"] = host_ms(torch, lambda: b3.merkle_walk(digs, sibs, inv, idx))
        read = int(torch.unique(inv).numel())
        rec["bound_ms"], rec["bound_by"] = hash_bound_ms(
            64 * k + 64 * read + 8 * levels * k + 8 * k + 64 * k, k * levels)
        # the floor: depth x the quad layout's compression latency (the
        # walk's); the one-thread layout's, the floor before PR 20, beside
        rec["floor_ms"] = levels * lats["quad"]
        rec["thread_floor_ms"] = levels * lat_ms
        recs[f"walk {k}"] = rec
        log(f"  blake3 merkle walk of {k} columns x {levels} levels: equal; 1 launch, device "
            f"warm {rec['ms']:.4f} ms, cold {rec['cold_ms']:.4f} (the verifier's form "
            f"{rec['verifier_ms']:.4f}, {rec['verifier_cold_ms']:.4f}), host wall "
            f"{rec['host_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), floor "
            f"{levels} x the quad's latency {rec['floor_ms']:.4f} ms (a thread's "
            f"{rec['thread_floor_ms']:.4f}), plain {plain_ms:.1f} ms")
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
        # thin tensor-core kernel) and opens in one gather_open launch (the
        # kept words' columns converted to Montgomery words in it); with no
        # words kept prove evaluates the columns directly (the power table,
        # the tile kernel, a thin launch summing its K splits)
        path_kernels = {"ntt_mont", "blake3_chunks", "chunk_tree", "merkle_tree", "mont_dot",
                        "mont_dot_thin_tc", "gather_open"}
        if kw["spill"] == "none":
            path_kernels |= {"power_table", "mont_dot_tile", "mont_dot_thin"}
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
        if (n > 0) != (name in ligero_kernels(enc.n_cols)
                       | {"blake3_chunks", *TREES, "blake3_cols_few"}):
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
    _, _, v_launches = counted(torch, counters, lambda: proof.verify(
        root, outer, inner, enc, transcript(root)))
    log(f"  path 2^28 verify's core: {check_verify_core(v_launches, 'path 2^28', P.BLAKE3)}")
    check_verify_maps(v_launches, "path 2^28", ligero_verify_maps(enc.n_cols))
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
    path_kernels = {"seeded_gen", "ntt_mont", "blake3_chunks", *TREES, "blake3_cols_few",
                    "mont_dot", "power_table", *DOT_KERNELS, "verify_check", "gather_open"}
    for name, n in launches.items():
        # mont_mul_map builds the n = 2^20 plan's twiddle table (mont_powers)
        # where this run makes it first, and converts verify's rows at the
        # opened columns' route; verify's are checked below
        if name != "mont_mul_map" and (n > 0) != (name in path_kernels):
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
    _, _, v_launches = counted(torch, counters, lambda: proof.verify(
        root, outer, inner, enc, transcript(root)))
    log(f"  path 2^29 verify's core: {check_verify_core(v_launches, 'path 2^29', P.BLAKE3)}")
    check_verify_maps(v_launches, "path 2^29", ligero_verify_maps(enc.n_cols))
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
    # the walk's quad layout splits a compression over four lanes: its
    # count a lane is no compression's (phase 7 logs it, kb.chain_layout_mix)
    mix = kb.blake3_sass_mix(chain_so, lib_so, tuple(k for k in B3_KERNELS if k != B3_WALK))
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


def few_row(hashes, big, sdig, lig, s29, b3_ptxas, b3_mix):
    """The kernel table's row of BLAKE3's few-column kernel, timed at the
    2^23 Ligero verify's opened columns (189 x 2,048 words), the other
    verify shapes beside; its launches those of each path's run."""
    few = hashes["few"]
    rec = few["2^23 verify (189 columns)"]
    return {
        "name": "blake3_cols_few", "route": "cuda", "source": "lcpc_tpu_torch/csrc/blake3_cols.cu",
        "replaces": ("lcpc_tpu/ops/blake3_jax.py:249 (hash_word_columns, with its chunk tree "
                     ":221-245) as lcpc_tpu/core/protocol.py:838 and :787 (_verify_core_fn, "
                     "_verify_core_cols_fn) call it on the opened columns; XLA-fused, not Pallas"),
        "launches": lig[0]["blake3_cols_few"], "max_abs_err": hashes["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None, "equal_to_plain": True,
        "tolerance": 0, "shape": "the 2^23 ligero verify's opened columns: 189 x 2,048 words",
        "cold_ms": rec["cold_ms"], "floor_ms": rec["floor_ms"], "host_ms": rec["host_ms"],
        "wide_route_ms": rec["wide_ms"], "wide_route_cold_ms": rec["wide_cold_ms"],
        "verify_shapes": few,
        "launches_paths": {"sdig_2_23": sdig[0]["blake3_cols_few"],
                           "ligero_2_23": lig[0]["blake3_cols_few"],
                           "streaming_2_28": big["launches"]["blake3_cols_few"],
                           "seeded_2_29": s29["launches"]["blake3_cols_few"]},
        "ptxas": {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                  for k, v in sorted(b3_ptxas.items()) if "blake3_cols_few" in k},
        "sass_compression_alu_fma_all": b3_mix["per_compression_alu_fma_all"][
            b3_mix["least"]][:3],
    }


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
            floor_ms=w189["floor_ms"], thread_floor_ms=w189["thread_floor_ms"],
            cold_ms=w189["cold_ms"], verifier_form_ms=w189["verifier_ms"],
            verifier_form_cold_ms=w189["verifier_cold_ms"],
            brakedown_2_23=hashes[f"walk {WALKS[1][0]}"],
            compression_latency_ms_by_layout=hashes["compression_latency_ms_by_layout"],
            layouts_sass=hashes["layouts_sass"],
            note_walk="redesigned PR 20: a quad of lanes a column (blake3.cuh quad_parent); "
                      "floor_ms = levels x the quad's probed compression latency, "
                      "thread_floor_ms the one-thread layout's",
            ptxas=ptx(B3_WALK)),
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
    recs.update(vector_route(torch, kb, P, mm, gen))
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


def canon_rows(torch, spec, t, npr, gen):
    """(t, npr, W/2) int32 canonical words, random below R (>= p among
    them); row 0 all ones (R - 1), row 1 all p - 1 (where t > 1)."""
    from lcpc_tpu_torch.ops.limbs import get_ops

    w32 = spec.w16 // 2
    rows = torch.randint(-2**31, 2**31, (t, npr, w32), generator=gen, device=DEV,
                         dtype=torch.int32)
    rows[0] = -1
    if t > 1:
        pm1 = get_ops(spec).encode_repr_words([spec.p - 1]).view("int32")
        rows[1] = torch.from_numpy(pm1.copy()).to(DEV)
    return rows


def strided_map(spec, a, *, out, op, in_form, out_form):
    """mont_mul_map's strided mode (a thread an element) on views its
    wrapper takes by the element-contiguous mode: csrc/mont_map.cu's entry
    called with `whole` 0, to compare and time the two modes on the same
    views (counted nowhere).  Returns out."""
    from lcpc_tpu_torch.ops import mont_map as mm
    from lcpc_tpu_torch.utils import cuda_build

    av, bv, batch = mm._check(spec, op, mm.MUL_OPS, a, None, in_form, out_form)
    _, ts, dims = mm._operands(spec, av, bv, out_form, batch, out)
    args = mm._entry_args(spec, op, ts, [in_form] * (len(ts) - 1) + [out_form], dims)
    err = cuda_build.load("mont_map", mm._bind).lcpc_mont_mul_map(*args, 0)
    if err != 0:
        raise RuntimeError(f"mont_mul_map's strided mode ({op}) failed: cudaError_t {err}")
    return out


def vector_route(torch, kb, P, mm, gen):
    """mont_mul_map's element-contiguous mode (ops/mont_map.map_route)
    against its plain version and against the strided mode on the same
    views (strided_map), word for word (tolerance 0), in every field (W/2
    = 2, 4, 6, 8), each launch counted by its mode: verify's proof rows
    written into Brakedown's packed (positions, R, W/2) level buffer and
    into rows of their own shape ("vector"); the
    columns route's rows to new words (core/protocol.py:748) and rows 4
    bytes off their alignment, which must take the strided route; canonical
    words all ones, all p - 1 and random (>= p among them).  At ft255 the
    Brakedown 2^23 verify's rows (2 x 235,173) into the level buffer timed
    warm and cold in turns strided, vector, vector, strided, and the 2^29
    verify's rows (2 x 262,144) by the columns route (strided) warm and
    cold, beside the bytes bound (the words read once, written once) and
    the plain version.  Returns the records."""
    recs, cases = {}, []
    kw = dict(op="to_mont", in_form="words", out_form="words")

    def into_buffer(spec, rows, strided=False):  # the level buffer (positions, R, W/2)
        t, npr, w32 = rows.shape
        buf = torch.zeros((npr + 5, t, w32), dtype=torch.int32, device=DEV)
        (strided_map if strided else mm.mont_mul_map)(spec, rows.permute(2, 0, 1),
                                                        out=buf[:npr].permute(2, 1, 0), **kw)
        return buf

    for spec in P.ALL_FIELDS:
        t, npr = MAP_VEC_EDGE
        rows = canon_rows(torch, spec, t, npr, gen)
        a = rows.permute(2, 0, 1)
        want = mm.mont_mul_map_plain(spec, a, **kw)
        level = into_buffer(spec, rows)[:npr].permute(2, 1, 0)
        routes = {
            "level_buffer": mm.map_route(spec, a, out=level, **kw),
            "proof_rows": mm.map_route(spec, a, out=torch.empty_like(rows).permute(2, 0, 1), **kw),
            "columns_rows": mm.map_route(spec, a, **kw)}
        before = (mm.VECTOR.launches, mm.mont_mul_map.launches)
        bufs = [into_buffer(spec, rows, strided) for strided in (True, False)]
        same = torch.empty_like(rows)
        mm.mont_mul_map(spec, a, out=same.permute(2, 0, 1), **kw)
        if routes["level_buffer"] != "vector" or routes["proof_rows"] != "vector" or \
                (mm.VECTOR.launches - before[0], mm.mont_mul_map.launches - before[1]) != (2, 0):
            raise AssertionError(f"{spec.name}: routes {routes}")
        if not all(torch.equal(b[:npr].permute(2, 1, 0), want) and not b[npr:].any()
                   for b in bufs) or not torch.equal(same.permute(2, 0, 1), want):
            raise AssertionError(f"{spec.name}: the element-contiguous mode != plain")
        if routes["columns_rows"] != "strided" or not torch.equal(mm.mont_mul_map(spec, a, **kw),
                                                                   want):
            raise AssertionError(f"{spec.name} columns-route rows ({routes['columns_rows']}): "
                                 f"!= plain")
        flat = torch.empty(rows.numel() + 1, dtype=torch.int32, device=DEV)
        off = flat[1:].view(rows.shape)
        off.copy_(rows)
        routes["offset_rows"] = mm.map_route(spec, off.permute(2, 0, 1),
                                             out=torch.empty_like(rows).permute(2, 0, 1), **kw)
        before = (mm.VECTOR.launches, mm.mont_mul_map.launches)
        got = torch.empty_like(rows)
        mm.mont_mul_map(spec, off.permute(2, 0, 1), out=got.permute(2, 0, 1), **kw)
        counts = (mm.VECTOR.launches - before[0], mm.mont_mul_map.launches - before[1])
        if routes["offset_rows"] != "strided" or counts != (0, 1) or \
                not torch.equal(got.permute(2, 0, 1), want):
            raise AssertionError(f"{spec.name} rows 4 bytes off ({routes['offset_rows']}): "
                                 f"!= plain")
        cases.append({"field": spec.name, **routes})
    log(f"  mont_mul_map element-contiguous mode in every field ({MAP_VEC_EDGE[0]} x "
        f"{MAP_VEC_EDGE[1]} canonical words: all ones, all p - 1, random): into the level "
        f"buffer and into proof rows (vector) equal to plain and to the strided mode; "
        f"the columns route's rows and rows 4 bytes off their alignment took the strided route, "
        f"equal to plain")
    recs["vector_route_cases"] = cases

    spec = P.FT255
    w32 = spec.w16 // 2
    for tag, (t, npr) in (("brakedown 2^23 verify rows", MAP_SDIG_VERIFY_ROWS),
                          ("2^29 verify rows, columns route", MAP_COLS_ROWS)):
        rows = canon_rows(torch, spec, t, npr, gen)
        a = rows.permute(2, 0, 1)
        want = mm.mont_mul_map_plain(spec, a, **kw)
        if tag.startswith("brakedown"):
            buf = into_buffer(spec, rows)
            if not torch.equal(buf[:npr].permute(2, 1, 0), want) or \
                    not torch.equal(into_buffer(spec, rows, strided=True), buf):
                raise AssertionError(f"{tag}: != plain or the strided route")
            out = buf[:npr].permute(2, 1, 0)
            fns = {"strided": lambda: strided_map(spec, a, out=out, **kw),
                   "vector": lambda: mm.mont_mul_map(spec, a, out=out, **kw)}
            order = ("strided", "vector", "vector", "strided")
        else:
            out = None
            fns = {"strided": lambda: mm.mont_mul_map(spec, a, **kw)}
            if not torch.equal(fns["strided"](), want):
                raise AssertionError(f"{tag}: != plain")
            order = ("strided",)
        route = mm.map_route(spec, a, out=out, **kw)
        turns = [(k, kb.time_kernel(fns[k], reps=MAP_VEC_REPS)) for k in order]
        cold = [(k, kb.time_kernel_cold(fns[k], reps=MAP_VEC_REPS)) for k in order]
        _, plain_ms = time_host(torch, lambda: mm.mont_mul_map_plain(spec, a, **kw))
        nbytes, products = map_cost(spec, t * npr, w32, w32, 2 * w32 * w32 + w32)
        bound, t_bytes, t_ops = bound_ms(nbytes, products)
        ms = statistics.median(v for k, v in turns if k == route)
        rec = {"route": route, "ms": ms,
               "cold_ms": statistics.median(v for k, v in cold if k == route),
               "strided_ms": statistics.median(v for k, v in turns if k == "strided"),
               "strided_cold_ms": statistics.median(v for k, v in cold if k == "strided"),
               "turns": turns, "cold_turns": cold, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "share": bound / ms,
               "bytes": nbytes, "products": products}
        recs[tag] = rec
        log(f"  mont_mul_map {tag} ({t} x {npr:,} canonical words -> Montgomery words, "
            f"{route}): equal to plain" + (" and to the strided route" if len(fns) > 1 else "")
            + f"; warm turns {' '.join(order)} {[round(v, 4) for _, v in turns]} ms, cold "
            f"{[round(v, 4) for _, v in cold]} (bound {bound:.4f} ms, {rec['bound_by']}, "
            f"{100 * bound / ms:.1f}%); plain {plain_ms:.2f} ms")
        del rows, a, want
    return recs


def map_rows(maps, s29, big, sdig, lig, ptx, shard):
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
                          for k, v in sorted(ptx["mont_map"].items())
                          if name in k and WHOLE_MODE not in k}, **extra}

    commit = "brakedown 2^23 commit: (16, 36, 357,699) limbs -> hash words"
    return [
        row("mont_mul_map",
            "lcpc_tpu/ops/limbs.py:224 (_mul_unrolled, behind mul :262, mul_const :271, to_mont "
            ":275, from_mont :279) and lcpc_tpu/core/protocol.py:307,315 (_pack_words, "
            "_canon_pack_fn); XLA-fused, not Pallas", maps[commit],
            "the 2^23 ft255 Brakedown commit's conversion: 36 x 357,699 Montgomery limbs -> "
            "canonical hash words (from_mont and the pack, one launch)",
            other_shapes={k: v for k, v in maps.items() if isinstance(v, dict) and k != commit
                          and "add" not in k and v.get("route", "strided") == "strided"}),
        vector_row(maps, sdig, {k: v for k, v in ptx["mont_map"].items() if WHOLE_MODE in k}),
        row("mont_addsub_map",
            "lcpc_tpu/ops/limbs.py:121,131,149 (add, sub, neg); XLA-fused, not Pallas",
            maps["add at the brakedown 2^23 codeword: (16, 36, 357,699) limbs"],
            "add over the 2^23 ft255 Brakedown codeword's shape: 2 x (16, 36, 357,699) limbs; "
            "its caller on the paths: the sharded collapse's modular sum of the ranks' "
            "partials (FieldOps.sum)"),
    ]


def vector_row(maps, sdig, map_ptxas):
    """The kernel table row of mont_mul_map's element-contiguous mode
    (mont_mul_map_kernel<W, OP, true>): timed at the 2^23 Brakedown verify's rows
    into the level buffer, its launches from that path, the columns route's
    rows beside."""
    rec = maps["brakedown 2^23 verify rows"]
    return {"name": "mont_mul_map_vec", "route": "cuda",
            "source": "lcpc_tpu_torch/csrc/mont_map.cu",
            "replaces": ("lcpc_tpu/ops/limbs.py:224 (_mul_unrolled behind to_mont :275) as "
                         "lcpc_tpu/core/protocol.py's verify converts its proof rows; XLA-fused, "
                         "not Pallas"),
            "launches": sdig[0]["mont_mul_map_vec"], "max_abs_err": maps["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "equal_to_plain": True,
            "tolerance": 0,
            "shape": (f"the 2^23 ft255 Brakedown verify's proof rows, {MAP_SDIG_VERIFY_ROWS[0]} x "
                      f"{MAP_SDIG_VERIFY_ROWS[1]:,} canonical words -> the packed level buffer's "
                      f"Montgomery words ({rec['route']})"),
            "cold_ms": rec["cold_ms"], "strided_ms": rec["strided_ms"],
            "strided_cold_ms": rec["strided_cold_ms"],
            "launches_by_stage": {k: v["counters"].get("mont_mul_map_vec", 0)
                                  for k, v in sdig[8].items()},
            "columns_route_rows": maps["2^29 verify rows, columns route"],
            "routes_by_field": maps["vector_route_cases"],
            "ptxas": {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                      for k, v in sorted(map_ptxas.items()) if "ILi8E" in k}}


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
    f_alu, f_fma, f_all = mix["few_rounds"]
    log(f"  SASS sha256 compression (probe): {c_alu:g} ALU-pipe + {c_fma:g} FMA-pipe of "
        f"{c_all:g} instructions ({SHA_COMPRESSION_S * 1e12:.2f} ps at the card's integer "
        f"rate); opcodes {c_ops}")
    log(f"  SASS sha256 Merkle parent (probe): {p_alu:g} ALU + {p_fma:g} FMA of {p_all:g} "
        f"({SHA_PARENT_S * 1e12:.2f} ps); the wide column kernel's block loop: {l_alu} ALU + "
        f"{l_fma} FMA of {l_all} ({compression_s(l_alu, l_fma) * 1e12:.2f} ps); the few-column "
        f"kernel's round-warp loop: {f_alu} ALU + {f_fma} FMA of {f_all} ({f_alu / 64:.2f} "
        f"ALU a round)")
    if c_alu < 800:
        raise AssertionError(f"the probe's compression is not on the vector ALU: {mix}")
    return {"compress_alu_fma_all": (c_alu, c_fma, c_all), "compress_opcodes": c_ops,
            "parent_alu_fma_all": (p_alu, p_fma, p_all), "parent_opcodes": p_ops,
            "cols_loop_alu_fma_all": (l_alu, l_fma, l_all),
            "few_rounds_alu_fma_all": (f_alu, f_fma, f_all),
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


def sha256_phase(torch, kb, sha, gen, sha_so, lib_so, sha_mix):
    """Phase 13: the SHA-256 kernels against their plain versions, word for
    word, each timed against its bound; the column hash by both of its
    kernels (the few-column and the wide one, forced by _route, and by the
    route sha256_cols picks), verify's shapes also against their floor (a
    column's compressions x one compression's latency, from the probe
    library sha_so), their critical path (the longest dependent chain of
    the few-column kernel's round loop in the SASS of lib_so, each
    instruction at its latency from the probe's op chains) and one warp's
    issue (the measured clocks an ALU instruction of that loop); the trees
    and the walk against their dependency floor (depth x one parent's
    latency) and critical path (depth x a parent's SASS chain).  Returns the
    records."""
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
    check("compress chain", kb.sha256_chain(sha_so, h0, n_ref, 0), ref_c[:, 0])
    check("parent chain", kb.sha256_chain(sha_so, h0, n_ref, 1), ref_p[:, 0])
    check("tree parent chain", kb.sha256_chain(sha_so, h0, n_ref, 2), ref_p[:, 0])
    lat_c = kb.time_kernel(lambda: kb.sha256_chain(sha_so, h0, CHAIN, 0), reps=3) / CHAIN
    lat_p = kb.time_kernel(lambda: kb.sha256_chain(sha_so, h0, CHAIN, 1), reps=3) / CHAIN
    lat_t = kb.time_kernel(lambda: kb.sha256_chain(sha_so, h0, CHAIN, 2), reps=3) / CHAIN
    recs.update(compression_latency_ms=lat_c, parent_latency_ms=lat_p,
                tree_parent_latency_ms=lat_t,
                plain_compression_launches=plain_launches(torch, sha, digests))
    log(f"  latency (a chain of {CHAIN} in one thread): a compression {lat_c * 1e3:.4f} us, a "
        f"Merkle parent {lat_p * 1e3:.4f} us (the walk's, unrolled), {lat_t * 1e3:.4f} us (the "
        f"tree's, compact); one plain compression is {recs['plain_compression_launches']} CUDA "
        f"kernel launches")
    # the card's yardsticks: dependent IADD3, LOP3, SHF and IMAD (the probe's
    # op chains), and one warp's issue of each (eight independent chains);
    # the critical paths as ptxas emitted them (kb.sha256_sass_chains: the
    # longest dependent chain through a loop body's SASS at those
    # latencies): a round of the few-column kernel, a parent (the walk's
    # unrolled one; the tree's compact one, 128 rounds of its 16-round
    # trips); one warp's issue the few-column kernel's round loop's ALU
    # instructions at the measured clocks an instruction
    ops, issue = kb.op_latencies(sha_so), kb.op_latencies(sha_so, wide=True)
    if ops is None or issue is None:
        raise RuntimeError("the probe's op chains or cuobjdump are missing")
    chains = kb.sha256_sass_chains(sha_so, lib_so, ops)
    if chains is None or set(chains) != {"few_round", "parent", "compress", "compact_round"}:
        raise RuntimeError(f"the SHA-256 loops were not found in the SASS: {chains}")
    ghz = ops["IADD3"][0] / ops["IADD3"][1]
    crit_round = chains["few_round"][0]
    crit_walk = chains["parent"][0]  # cycles a parent
    crit_tree = min(crit_walk, 128 * chains["compact_round"][0])  # the fastest parent's
    issue_round = issue["IADD3"][0] * sha_mix["few_rounds_alu_fma_all"][0] / 64
    crit_c, issue_c = 64 * crit_round / ghz / 1e6, 64 * issue_round / ghz / 1e6  # ms
    crit_pw, crit_pt = crit_walk / ghz / 1e6, crit_tree / ghz / 1e6  # ms a parent
    recs.update(op_latency_cycles_ns=ops, op_issue_cycles_ns=issue, clock_ghz=ghz,
                sass_chains_cycles_opcodes=chains, critical_path_round_cycles=crit_round,
                issue_round_cycles=issue_round, critical_path_compression_ms=crit_c,
                critical_path_parent_ms=crit_pw, critical_path_tree_parent_ms=crit_pt,
                issue_compression_ms=issue_c)
    log(f"  dependent instructions (op chains, cycles / ns): "
        + ", ".join(f"{k} {c:.2f} / {t:.3f}" for k, (c, t) in ops.items())
        + "; one warp's issue, eight chains: "
        + ", ".join(f"{k} {c:.2f} / {t:.3f}" for k, (c, t) in issue.items())
        + f" at {ghz:.3f} GHz")
    log("  critical paths in the SASS (cycles; the chain's opcodes): "
        + "; ".join(f"{k} {c:.2f} ({', '.join(f'{o} {n:g}' for o, n in ops_.items())})"
                    for k, (c, ops_) in chains.items())
        + f"; a compression of the few-column kernel {crit_c * 1e3:.4f} us, a parent "
        f"{crit_pw * 1e3:.4f} us (the walk's), {crit_pt * 1e3:.4f} us (the fastest); one warp's "
        f"issue {issue_round:.2f} cycles a round ({issue_c * 1e3:.4f} us a compression)")

    def by_route(w, route, n_words):
        return sha.sha256_cols(w, total_words=8 + n_words, _route=route)

    def columns(tag, w, host_cols=0, timed=False, sub=(), checked=(), plain_sub=True,
                forced=True):
        # forced: both kernels at the full width too (small shapes); a path's
        # width runs the kernel cols_route picks, both kernels its leading
        # columns (sub, checked)
        n_words, n_cols = w.shape
        got = sha.hash_word_columns(w)
        want, plain_ms = time_host(torch, lambda: sha.hash_word_columns_plain(w))
        check(f"{tag}", got, want)
        check(f"{tag} (int64 words)", sha.hash_word_columns(w.to(torch.int64) & 0xFFFFFFFF), want)
        rec = {"n_words": n_words, "n_cols": n_cols, "plain_ms": plain_ms, "launches": 1,
               "route": sha.cols_route(n_cols),
               "compressions_a_column": (8 + n_words + 3 + 15) // 16}
        for route in sha.COLS_KERNELS if forced else ():
            check(f"{tag} ({route})", by_route(w, route, n_words), want)
        for k in sub + checked:  # the leading columns alone, read at the full row stride
            check(f"{tag} first {k} columns", sha.hash_word_columns(w[:, :k]), want[:, :k])
            for route in sha.COLS_KERNELS:
                check(f"{tag} first {k} columns ({route})", by_route(w[:, :k], route, n_words),
                      want[:, :k])
        if host_cols:
            u = w[:, :host_cols].cpu().numpy().view(np.uint32)
            b = digests_to_bytes(got[:, :host_cols])
            for c in range(host_cols):
                if bytes(b[c]) != hashlib.sha256(bytes(32) + u[:, c].astype("<u4").tobytes()
                                                  ).digest():
                    raise AssertionError(f"sha256 {tag}: column {c} != hashlib")
        narrow = f"; first {', '.join(map(str, checked))} columns by both kernels" if checked else ""
        if timed:
            nbytes, comps = sha_cols_cost(n_words, n_cols)
            rec["ms"] = kb.time_kernel(lambda: sha.hash_word_columns(w))
            rec["bound_ms"], rec["bound_by"] = sha_bound_ms(nbytes, comps, SHA_COMPRESSION_S)
            rec.update(bytes=nbytes, compressions=comps)
            per = rec["compressions_a_column"]
            for k in sub:
                nb, cp = sha_cols_cost(n_words, k)
                rec[f"route_{k}_columns"] = sha.cols_route(k)
                rec[f"ms_{k}_columns"] = kb.time_kernel(lambda: sha.hash_word_columns(w[:, :k]))
                if plain_sub:  # the plain version at this shape (a second each 100 blocks)
                    rec[f"plain_ms_{k}_columns"] = time_host(
                        torch, lambda: sha.hash_word_columns_plain(w[:, :k]))[1]
                for route in sha.COLS_KERNELS:
                    rec[f"ms_{k}_columns_{route}"] = kb.time_kernel(
                        lambda: by_route(w[:, :k], route, n_words))
                rec[f"bound_ms_{k}_columns"], rec[f"bound_by_{k}_columns"] = sha_bound_ms(
                    nb, cp, SHA_COMPRESSION_S)
                # a column's compressions run one after another in its lane
                rec[f"floor_ms_{k}_columns"] = per * lat_c
                rec[f"critical_path_ms_{k}_columns"] = per * crit_c
                rec[f"issue_ms_{k}_columns"] = per * issue_c
            log(f"  sha256 {tag}: {n_cols} columns of {n_words} words ({per} compressions "
                f"each): equal (int32 and int64 words, {'both kernels' if forced else rec['route']}"
                f"{', ' + str(host_cols) + ' columns to hashlib' if host_cols else ''}{narrow}); "
                f"sha256_cols ({rec['route']}) {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}; {comps} compressions, {nbytes} bytes), plain "
                f"{plain_ms:.1f} ms"
                + "".join(f"; first {k} columns ({rec[f'route_{k}_columns']}) "
                          f"{rec[f'ms_{k}_columns']:.4f} ms (few {rec[f'ms_{k}_columns_few']:.4f}, "
                          f"wide {rec[f'ms_{k}_columns_wide']:.4f}; bound "
                          f"{rec[f'bound_ms_{k}_columns']:.4f}, {rec[f'bound_by_{k}_columns']}; "
                          f"floor {per} x a compression's latency = "
                          f"{rec[f'floor_ms_{k}_columns']:.4f}; critical path "
                          f"{rec[f'critical_path_ms_{k}_columns']:.4f}; one warp's issue "
                          f"{rec[f'issue_ms_{k}_columns']:.4f})" for k in sub))
        else:
            log(f"  sha256 {tag}: {n_cols} columns of {n_words} words: equal "
                f"({'both kernels' if forced else rec['route']}"
                f"{', ' + str(host_cols) + ' columns to hashlib' if host_cols else ''}{narrow})")
        recs[tag] = rec

    cross = (sha.FEW_COLS_MAX, sha.FEW_COLS_MAX + 1)  # the route's crossover, both sides
    columns("2^23 commit", words(*B3_COMMIT), host_cols=2, timed=True, sub=(B3_OPENED,),
            checked=SHA_NARROW + cross, forced=False)
    columns("2^28 column length", words(*B3_LONG), host_cols=1, timed=True, sub=(B3_OPENED,),
            checked=SHA_NARROW, plain_sub=False, forced=False)
    columns("brakedown 2^23 commit", words(*SHA_SDIG), timed=True, sub=(6_593, B3_OPENED),
            checked=SHA_NARROW + cross, forced=False)
    for n_words in SHA_EDGES:
        columns(f"edge {n_words}", words(n_words, 300), host_cols=2,
                checked=SHA_NARROW + (B3_OPENED,))

    # streaming, by each kernel: the updates state by state against the plain
    # update, then the finalize at rem 12, 13 and 14 against the plain
    # finalize and the kernel's one-shot hash; the hasher class end to end
    # (the plain one-shot hash of these 1,8xx-word columns would add ~4 s
    # each: ~4,300 torch launches a compression)
    n_cols = SHA_STREAM_COLS
    w_all = words(sum(SHA_STREAM) + max(t for t, _ in SHA_STREAM_TAILS), n_cols)
    pcv, pcarry, n, r0, carries, plain = sha.h0_state(n_cols, DEV), None, 8, 0, [], []
    for length in SHA_STREAM:
        carries.append(n)
        pcv, pcarry, n = sha.sha256_update_plain(pcv, pcarry, n, w_all[r0 : r0 + length])
        plain.append((pcv, pcarry, n))
        r0 += length
    if carries != [8, 0, 0, 7, 15, 8]:
        raise AssertionError(f"sha256 stream: carries {carries}")
    for route in sha.COLS_KERNELS:
        cv = sha.h0_state(n_cols, DEV)
        carry = torch.zeros((16, n_cols), dtype=torch.int32, device=DEV)
        n, r0 = 8, 0
        for length, carried, (scv, scarry, sn) in zip(SHA_STREAM, carries, plain):
            got_n = sha.sha256_cols(w_all[r0 : r0 + length], cv=cv, carry=carry, carry_len=n,
                                    _route=route)
            if got_n != sn:
                raise AssertionError(f"sha256 stream ({route}) update of {length}: rem {got_n} "
                                     f"!= {sn}")
            check(f"stream ({route}) update of {length} words (carry {carried}) chaining value",
                  cv, scv)
            check(f"stream ({route}) update of {length} words carry", carry[:sn], scarry[:sn])
            n, r0 = got_n, r0 + length
        for tail, rem_want in SHA_STREAM_TAILS:
            cv_t, carry_t, blk = cv.clone(), carry.clone(), w_all[r0 : r0 + tail]
            got_n = sha.sha256_cols(blk, cv=cv_t, carry=carry_t, carry_len=n, _route=route)
            tcv, tcarry, tn = sha.sha256_update_plain(pcv, pcarry, n, blk)
            if not got_n == tn == rem_want:
                raise AssertionError(f"sha256 stream ({route}): rem {got_n}, plain {tn}, want "
                                     f"{rem_want}")
            total = 8 + r0 + tail
            got = sha.sha256_cols(blk[:0], cv=cv_t, carry=carry_t, carry_len=got_n,
                                  total_words=total, _route=route)
            check(f"stream ({route}) finalize at rem {rem_want}", got,
                  sha.sha256_finalize_plain(tcv, tcarry, tn, total))
            check(f"stream ({route}) finalize at rem {rem_want} vs the one-shot hash", got,
                  sha.hash_word_columns(w_all[: r0 + tail]))
    lens = SHA_STREAM + (SHA_STREAM_TAILS[-1][0],)
    hasher = StreamingSha256Hasher(n_cols, 8 + sum(lens), DEV)
    r0 = 0
    for length in lens:
        hasher.update(w_all[r0 : r0 + length])
        r0 += length
    check("StreamingSha256Hasher", hasher.finalize(), got)  # the last tail's digests
    log(f"  sha256 streaming, {n_cols} columns, by each kernel: updates of {list(SHA_STREAM)} "
        f"words (carries {carries}) equal to the plain update state by state; finalizes at rem "
        f"{[r for _, r in SHA_STREAM_TAILS]} equal to the plain finalize and the one-shot "
        f"hash; StreamingSha256Hasher end to end equal")

    for n_leaves, np2 in MERKLE_TREES + SHA_TREE_EDGES:
        leaves = digests(n_leaves)
        got = sha.merkle_tree(leaves, np2)
        want, plain_ms = time_host(torch, lambda: sha.merkle_tree_plain(leaves, np2))
        check(f"merkle tree {n_leaves} -> {np2}", got, want)
        ms = kb.time_kernel(lambda: sha.merkle_tree(leaves, np2))
        wall = host_ms(torch, lambda: sha.merkle_tree(leaves, np2))
        bound, by = sha_bound_ms(64 * n_leaves + 64 * (2 * np2 - 1), np2 - 1, SHA_PARENT_S)
        depth = np2.bit_length() - 1
        # the floor: depth x the fastest parent the port has (a level may be
        # built by either); the compact parent's own beside it
        floor = depth * min(lat_p, lat_t)
        recs[f"merkle {n_leaves}"] = {
            "leaves": n_leaves, "np2": np2, "launches": 1, "ms": ms, "host_ms": wall,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "floor_ms": floor,
            "floor_ms_compact_parent": depth * lat_t,
            "critical_path_ms": depth * crit_pt, "depth": depth}
        log(f"  sha256 merkle tree of {n_leaves} leaves (padded to 2^{depth}): equal; 1 launch, "
            f"device {ms:.4f} ms, host wall {wall:.4f} ms, bound {bound:.4f} ms ({by}), floor "
            f"{depth} x the fastest parent's latency = {floor:.4f} ms (the compact parent's "
            f"{depth * lat_t:.4f}), critical path {depth * crit_pt:.4f} ms, plain "
            f"{plain_ms:.1f} ms")

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
        # the walk's round warp runs two compressions of the few-column
        # kernel's round a level, W + K fed by its schedule warp: its chain
        # and one warp's issue of them; a lone thread's parent (the schedule
        # inline) beside, the floor of the earlier walk of a thread a column
        crit_w, issue_w = levels * 2 * crit_c, levels * 2 * issue_c
        recs[f"walk {k}"] = {"columns": k, "levels": levels, "launches": 1, "ms": ms,
                             "host_ms": wall, "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": by, "floor_ms": levels * lat_p,
                             "critical_path_ms": crit_w, "issue_ms": issue_w,
                             "critical_path_unrolled_parent_ms": levels * crit_pw}
        log(f"  sha256 merkle walk of {k} columns x {levels} levels: equal; 1 launch, device "
            f"{ms:.4f} ms, host wall {wall:.4f} ms, bound {bound:.4f} ms ({by}), critical path "
            f"{crit_w:.4f} ms (128 rounds a level), one warp's issue {issue_w:.4f} ms, depth x "
            f"a lone thread's parent {levels * lat_p:.4f} ms, plain {plain_ms:.1f} ms")
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
        got = {k: v for k, v in rec["counters"].items() if k in SHA_KERNELS + SHA_COLS_KERNELS}
        if got != want[name] or any(k in rec["counters"]
                                    for k in ("blake3_chunks", *TREES, "blake3_cols_few")):
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
    # commit: an update a row block and the finalize, the tree; verify: the
    # opened columns' hash and the walk
    want_sha = sha_launches_path(n_cols, enc.get_n_col_opens(), n_blocks + 1)
    for name, n in launches.items():
        if (n > 0) != (name in ligero_kernels(enc.n_cols) | set(want_sha)):
            raise AssertionError(f"sha path 2^28: {name} launched {n} times")
    check_hash_launches(launches, want_sha, "sha path 2^28")
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
                     sha_launches_stages(n_cols, enc.get_n_col_opens(), n_blocks + 1),
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
    shape = (lenc.n_cols, lenc.get_n_col_opens())
    lig = main_path(torch, P, counters, lenc, coeffs_mont, x_pt, want, card, "sha_ligero",
                    ligero_kernels(lenc.n_cols) | set(sha_launches_path(*shape)), P.SHA256,
                    sha_launches_path(*shape))
    check_sha_stages(lig[8], "sha_ligero", sha_launches_stages(*shape), plain_per_compression,
                     b3_stages["ligero"])
    check_map_launches(lig[8], "sha_ligero", {"commit": (0, 0), "prove": (0, 0),
                                              "verify": ligero_verify_maps(lenc.n_cols)})
    del lenc
    t0 = time.perf_counter()
    enc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device=DEV)
    log(f"brakedown 2^23 encoding rebuilt in {time.perf_counter() - t0:.2f} s")
    shape = (enc.n_cols, enc.get_n_col_opens())
    sdig = main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, "sha_sdig",
                     SDIG_KERNELS | set(sha_launches_path(*shape)), P.SHA256,
                     sha_launches_path(*shape))
    check_sha_stages(sdig[8], "sha_sdig", sha_launches_stages(*shape), plain_per_compression,
                     b3_stages["sdig"])
    check_map_launches(sdig[8], "sha_sdig", {"commit": (1, 0), "prove": (0, 0),
                                             "verify": SDIG_VERIFY_MAPS})
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


# phase 16: the verifier's core and the prover's opening at the paths'
# shapes (ft255, T = 2 rows): (tag, rows, opened columns, codeword columns,
# the evaluation's length)
VC_SHAPES = (("ligero 2^23", 256, 189, 1 << 17, 32_768),
             ("sdig 2^23", 36, 6_593, 357_699, 235_173),
             ("seeded 2^29", 2_048, 189, 1 << 20, 262_144))
# the small shape held in ft63, ft127 and ft191 (W32 = 2, 4, 6)
VC_FIELD_SHAPE = ("small", 36, 189, 1 << 12, 4_096)
# the 2^28 words-kept opening: 2,048 rows of 189 opened columns out of kept
# canonical words, their columns cut from 2^19 to 2^16 (the gather reads
# the opened columns alone)
VC_CANON = (2_048, 189, 1 << 16)
VC_TAMPERS = ("column word", "encoded row", "sibling", "root")
# the random-sector probe (scripts/gather_probe.cu) at each gather's sector
# count: (plane-rows, sectors a plane-row)
VC_PROBES = {"ligero 2^23": (16 * 256, 189), "sdig 2^23": (16 * 36, 6_593),
             "2^28 words kept": (2_048 * 8, 189)}


def vc_bound(spec, T, R, k, npr):
    """(bound ms, bytes ms, products ms) of verify_check: ts, the columns,
    the encoded rows' limbs at the opened columns, the indices and the
    evaluation's two operands read once, the hash words written once; the
    T column sums' and the evaluation's wide products and one from_mont a
    column word and a wanted element (W/2 steps of W/2 products)."""
    w32 = spec.w16 // 2
    nbytes = 4 * w32 * (T * R + 2 * R * k + 2 * T * k + 2 * npr) + 8 * k
    return bound_ms(nbytes, w32 * w32 * ((T + 1) * R * k + T * k + npr))


def vc_idx(torch, n_cols, k, gen):
    """k opened columns of n_cols drawn with replacement, as the transcript
    draws them (fs/sampling.py): unsorted, slot 5 repeating slot 2."""
    idx = torch.randint(0, n_cols, (k,), generator=gen, device=DEV)
    if k > 5:
        idx[5] = idx[2]
    return idx


def vc_inputs(torch, P, kb, spec, digest, R, k, n_cols, npr, gen):
    """Random inputs of one verify core at a path's shape, all of whose
    checks pass: ts and the opened columns (every slot of a column opened
    twice holding its words; column 3 unreduced words 0xFFFFFFFF: a column
    word is any value below R), the columns idx drawn with replacement
    (vc_idx), encoded rows (W, T, n_cols) holding to_mont of each column's
    sums at the opened columns (and the same as (W/2, T, k) int64 words,
    the columns route's form), p_eval and inner, and a Merkle tree over
    random leaves with the opened columns' digests at idx: its root and the
    path data deduplicated by position, as verify makes them."""
    import numpy as np
    from lcpc_tpu_torch.core import protocol
    from lcpc_tpu_torch.ops import mont_dot as md
    from lcpc_tpu_torch.ops import mont_map as mm
    from lcpc_tpu_torch.ops.spmv import pack_words, unpack_words

    T, w = 2, spec.w16
    ts = pack_words(kb.random_mont(spec, (T, w, R), gen, DEV).permute(1, 0, 2), 0).contiguous()
    col = pack_words(kb.random_mont(spec, (R, w, k), gen, DEV).permute(1, 0, 2), 0)
    idx = vc_idx(torch, n_cols, k, gen)
    _, inv = torch.unique(idx, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), k, device=DEV).scatter_reduce(
        0, inv, torch.arange(k, device=DEV), "amin")
    col = col[:, :, first[inv]].contiguous()
    col[:, :, idx == idx[3]] = -1
    got = md.mont_dot_plain(spec, ts, col)
    want = mm.mont_mul_map_plain(spec, got, op="to_mont", in_form="words", out_form="words")
    enc_rows = kb.random_mont(spec, (T, w, n_cols), gen, DEV).permute(1, 0, 2).contiguous()
    enc_rows[:, :, idx] = unpack_words(want, 0)
    pe = pack_words(kb.random_mont(spec, (npr, w), gen, DEV), 1).contiguous()
    inner = pack_words(kb.random_mont(spec, (npr, w), gen, DEV), 1).contiguous()
    words = mm.mont_mul_map_plain(spec, col, op="from_mont", in_form="words", out_form="hash")
    leaves = torch.randint(0, 2**32, (8, n_cols), generator=gen, device=DEV, dtype=torch.int64)
    leaves[:, idx] = digest.hash_word_columns(words)
    tree = digest.merkle_tree(leaves, protocol._next_pow2(n_cols))
    pos = protocol.path_node_indices(n_cols, idx.tolist())
    uniq, inv = np.unique(pos.reshape(-1), return_inverse=True)
    uniq_t = torch.as_tensor(uniq.astype(np.int64), device=DEV)
    return {"ts": ts, "col": col, "idx": idx, "enc_rows": enc_rows,
            "want_cols": want.to(torch.int64) & 0xFFFFFFFF, "pe": pe, "inner": inner,
            "tree": tree, "root": tree[:, -1].clone(), "sibs": tree.index_select(1, uniq_t),
            "inv": torch.as_tensor(inv.reshape(k, -1).T.copy(), device=DEV), "uniq": uniq_t}


def vc_tamper(inp, what):
    """The inputs with one of VC_TAMPERS applied: an opened column's word,
    the encoded row 0 at an opened column (both forms), a sibling digest
    (level 0 of column 2), the root; None for the honest inputs."""
    out = dict(inp)
    if what == "column word":
        out["col"] = inp["col"].clone()
        out["col"][0, 0, 0] ^= 1
    elif what == "encoded row":
        out["enc_rows"], out["want_cols"] = inp["enc_rows"].clone(), inp["want_cols"].clone()
        out["enc_rows"][0, 0, inp["idx"][1]] ^= 1
        out["want_cols"][0, 0, 1] ^= 1
    elif what == "sibling":
        out["sibs"] = inp["sibs"].clone()
        out["sibs"][0, inp["inv"][0, 2]] ^= 1
    elif what == "root":
        out["root"] = inp["root"].clone()
        out["root"][0] ^= 1
    return out


def vc_kernel(torch, vc, spec, digest, inp, want_cols, state0):
    """verify_check, the digest's column hash and verify_walk on the card:
    (the state after them, the hash words)."""
    state = state0.clone()
    want = inp["want_cols"] if want_cols else inp["enc_rows"]
    words = vc.verify_check(spec, state, inp["ts"], inp["col"], want, inp["idx"],
                            want_cols=want_cols, p_eval=inp["pe"], inner=inp["inner"])
    digs = digest.hash_word_columns(words)
    vc.verify_walk(digest, state, 2, digs, inp["sibs"], inp["inv"], inp["idx"], inp["root"])
    return state, words


def vc_plain(torch, vc, spec, digest, inp, want_cols, roots):
    """The same through the plain versions: the expected state (T flags,
    the path flag, the evaluation's words) and the hash words.  The walk
    runs plain over the columns whose path the inputs changed (all of them
    when `roots` is None; their roots replace the honest ones)."""
    want = inp["want_cols"] if want_cols else inp["enc_rows"]
    ok, ev, words = vc.verify_check_plain(spec, inp["ts"], inp["col"], want, inp["idx"],
                                          want_cols=want_cols, p_eval=inp["pe"],
                                          inner=inp["inner"])
    digs = digest.hash_word_columns(words)
    if roots is None:
        cols = torch.arange(digs.shape[1], device=DEV)
        roots = torch.empty_like(digs)
    else:
        changed = (digs != inp["digs_honest"]).any(dim=0)
        if inp["sibs"] is not inp["sibs_honest"]:
            bad = (inp["sibs"] != inp["sibs_honest"]).any(dim=0).nonzero().flatten()
            changed |= torch.isin(inp["inv"], bad).any(dim=0)
        cols = changed.nonzero().flatten()
        roots = roots.clone()
    if cols.numel():
        roots[:, cols] = digest.merkle_walk_plain(digs[:, cols], inp["sibs"],
                                                  inp["inv"][:, cols], inp["idx"][cols])
    path = bool((roots == inp["root"][:, None]).all())
    state = [int(v) for v in ok.tolist()] + [int(path)] + ev.tolist()
    return state, words, digs, roots


def vc_probe_floors(torch, kb, probe_so):
    """The probe's time (ms) at each gather's sector count, ascending
    within each plane-row and random, cold (the floor: the card reading
    each element from its own 32-byte sector) and warm."""
    probe = kb.GatherProbe(probe_so)
    try:
        out = {}
        for tag, (rows, k) in VC_PROBES.items():
            asc, rnd = probe.fn(rows, k), probe.fn(rows, k, random=True)
            rec = {"sectors": rows * k, "ascending_cold_ms": kb.time_kernel_cold(asc),
                   "random_cold_ms": kb.time_kernel_cold(rnd),
                   "ascending_warm_ms": kb.time_kernel(asc), "random_warm_ms": kb.time_kernel(rnd)}
            out[tag] = rec
            log(f"  gather probe {tag}: {rows * k} sectors, cold {rec['ascending_cold_ms']:.4f} "
                f"ms ascending, {rec['random_cold_ms']:.4f} random "
                f"({32 * rows * k / rec['ascending_cold_ms'] / 1e9:.3f} TB/s of 32-byte "
                f"sectors); warm {rec['ascending_warm_ms']:.4f}, {rec['random_warm_ms']:.4f}")
        return out
    finally:
        probe.close()


def verify_core_phase(torch, kb, P, vc, gen, probe_so):
    """Phase 16: verify_check, verify_walk (both digests) and gather_open
    against their plain versions, tolerance 0, at the paths' shapes in
    ft255 and at VC_FIELD_SHAPE in ft63, ft127 and ft191, on honest inputs
    and the four tampers (the same flags cleared), the opened columns drawn
    with replacement; at ft255 each kernel timed warm and cold beside its
    bound and its plain version, gather_open also beside the probe's floor
    and the PyTorch index_select alone (warm and cold), and at the 2^28
    words-kept opening.  Returns the records."""
    import numpy as np
    from lcpc_tpu_torch.core import protocol
    from lcpc_tpu_torch.ops.spmv import pack_words

    floors = vc_probe_floors(torch, kb, probe_so)
    T = 2
    log("verify core kernels vs plain: tolerance 0 — every flag, evaluation word, hash word "
        "and opened word equal")
    recs = {"probe": floors}
    shapes = [(P.FT255, *sh) for sh in VC_SHAPES]
    shapes += [(f, *VC_FIELD_SHAPE) for f in (P.FT63, P.FT127, P.FT191)]
    for spec, tag, R, k, n_cols, npr in shapes:
        w32, timed = spec.w16 // 2, spec is P.FT255
        tag = tag if timed else f"{spec.name} {tag}"
        for digest in (P.BLAKE3, P.SHA256):
            inp = vc_inputs(torch, P, kb, spec, digest, R, k, n_cols, npr, gen)
            state0 = torch.from_numpy(vc.state_init(spec, T)).to(DEV)
            routes = (False, True) if digest is P.BLAKE3 else (False,)
            honest_roots = None
            for want_cols in routes:
                cases = {}
                for what in (None, *VC_TAMPERS):
                    cur = vc_tamper(inp, what)
                    cur["digs_honest"] = inp.get("digs_honest")
                    cur["sibs_honest"] = inp["sibs"]
                    got, words = vc_kernel(torch, vc, spec, digest, cur, want_cols, state0)
                    want, want_words, digs, roots = vc_plain(torch, vc, spec, digest, cur,
                                                             want_cols, honest_roots)
                    if what is None and honest_roots is None:
                        honest_roots, inp["digs_honest"] = roots, digs
                    got_l = got[: T + 1 + w32].tolist()
                    if got_l != want or not torch.equal(words, want_words):
                        raise AssertionError(f"verify core {tag} {digest.name} {what}: kernel "
                                             f"state {got_l} != plain {want}")
                    cases[what or "honest"] = got_l[: T + 1]
                if cases["honest"] != [1] * (T + 1) or any(
                        v == [1] * (T + 1) for name, v in cases.items() if name != "honest"):
                    raise AssertionError(f"verify core {tag}: flags {cases}")
                log(f"  {tag} {digest.name} ({'columns' if want_cols else 'encode'} route): "
                    f"honest and tampered flags equal to plain {cases}; the evaluation and "
                    f"hash words equal")
            rec = recs.setdefault(tag, {"field": spec.name, "rows": R, "columns": k,
                                        "n_cols": n_cols, "npr": npr,
                                        "repeats": k - int(torch.unique(inp["idx"]).numel())})
            if digest is P.BLAKE3 and not timed:
                vc_many_rows(torch, kb, vc, spec, R, k, n_cols, npr, gen)
            if digest is P.BLAKE3:
                rec["gather"] = vc_gather_forms(torch, kb, vc, spec, tag, R, k, n_cols, inp,
                                                gen, floors.get(tag) if timed else None,
                                                timed)
            if not timed:
                continue
            # timings: the check (encode route), warm and cold; the walk in
            # its verifier form
            state = state0.clone()

            def check():
                return vc.verify_check(spec, state, inp["ts"], inp["col"], inp["enc_rows"],
                                       inp["idx"], p_eval=inp["pe"], inner=inp["inner"])

            digs = inp["digs_honest"]
            walk_ms = kb.time_kernel(lambda: vc.verify_walk(
                digest, state, T, digs, inp["sibs"], inp["inv"], inp["idx"], inp["root"]))
            rec[f"walk_{digest.name}_ms"] = walk_ms
            rec["levels"] = int(inp["inv"].shape[0])
            if digest is P.SHA256:
                continue
            ms, cold = kb.time_kernel(check), kb.time_kernel_cold(check)
            _, plain_ms = time_host(torch, lambda: vc.verify_check_plain(
                spec, inp["ts"], inp["col"], inp["enc_rows"], inp["idx"], p_eval=inp["pe"],
                inner=inp["inner"]))
            bound, t_bytes, t_ops = vc_bound(spec, T, R, k, npr)
            rec.update({"check_ms": ms, "check_cold_ms": cold, "check_plain_ms": plain_ms,
                        "check_bound_ms": bound,
                        "check_bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "check_bytes_ms": t_bytes, "check_products_ms": t_ops})
            log(f"  verify_check {tag} (T {T} x {R} rows x {k} columns, npr {npr}): device "
                f"warm {ms:.4f} ms, cold {cold:.4f} ms, bound {bound:.4f} ms "
                f"({rec['check_bound_by']}; bytes {t_bytes:.4f}, products {t_ops:.4f}), plain "
                f"{plain_ms:.1f} ms")
        del inp
        torch.cuda.empty_cache()
    vc_many_rows(torch, kb, vc, P.FT255, *VC_FIELD_SHAPE[1:], gen)  # three passes at W32 = 8
    # the 2^28 words-kept opening: canonical words converted in the gather
    spec = P.FT255
    w32 = spec.w16 // 2
    R, k, n_kept = VC_CANON
    canon = pack_words(kb.random_mont(spec, (R, spec.w16, n_kept), gen, DEV).permute(1, 0, 2),
                       0)
    canon = canon.permute(1, 0, 2).reshape(R * w32, n_kept).contiguous()  # hash-word layout
    tree = torch.randint(0, 2**32, (8, 2 * n_kept - 1), generator=gen, device=DEV,
                         dtype=torch.int64)
    idx_l = vc_idx(torch, n_kept, k, gen)
    uniq = torch.as_tensor(np.unique(protocol.path_node_indices(n_kept, idx_l.tolist()))
                           .astype(np.int64), device=DEV)
    recs["2^28 words kept"] = {"rows": R, "columns": k, "kept_columns": n_kept, "gather": vc_gather(
        torch, kb, vc, spec, "2^28 words-kept opening", idx_l, R, tree, uniq, dict(canon=canon),
        lambda: canon.index_select(1, idx_l), 4 * w32 * R * k, floors["2^28 words kept"])}
    del canon, tree
    torch.cuda.empty_cache()
    return recs


def vc_many_rows(torch, kb, vc, spec, R, k, n_cols, npr, gen, T=5):
    """verify_check with T rows of ts (more than one pass of the kernel's
    accumulators at W32 = 6 and 8: it streams the rows once a pass) against
    its plain version on random inputs, tolerance 0, both routes: every flag
    as the plain version finds it, the evaluation and the hash words."""
    from lcpc_tpu_torch.ops.spmv import pack_words

    w, w32 = spec.w16, spec.w16 // 2
    ts = pack_words(kb.random_mont(spec, (T, w, R), gen, DEV).permute(1, 0, 2), 0).contiguous()
    col = pack_words(kb.random_mont(spec, (R, w, k), gen, DEV).permute(1, 0, 2), 0).contiguous()
    enc = kb.random_mont(spec, (T, w, n_cols), gen, DEV).permute(1, 0, 2).contiguous()
    idx = vc_idx(torch, n_cols, k, gen)
    want_w = pack_words(enc.index_select(2, idx), 0).to(torch.int64) & 0xFFFFFFFF
    pe = pack_words(kb.random_mont(spec, (npr, w), gen, DEV), 1).contiguous()
    inner = pack_words(kb.random_mont(spec, (npr, w), gen, DEV), 1).contiguous()
    for want_cols in (False, True):
        want = want_w if want_cols else enc
        state = torch.from_numpy(vc.state_init(spec, T)).to(DEV)
        words = vc.verify_check(spec, state, ts, col, want, idx, want_cols=want_cols,
                                p_eval=pe, inner=inner)
        ok, ev, pwords = vc.verify_check_plain(spec, ts, col, want, idx, want_cols=want_cols,
                                               p_eval=pe, inner=inner)
        got = state[: T + 1 + w32].tolist()
        if got != [int(v) for v in ok.tolist()] + [1] + ev.tolist() or \
                not torch.equal(words, pwords):
            raise AssertionError(f"verify_check {spec.name} T {T}: kernel != plain")
    log(f"  verify_check {spec.name} T {T} ({-(-T // (16 // w32))} passes of the rows), both "
        f"routes: equal to plain")


def vc_gather_forms(torch, kb, vc, spec, tag, R, k, n_cols, inp, gen, floor, timed):
    """gather_open at one verify shape's opened columns (inp["idx"]: drawn
    with replacement): from the codeword's limbs read in place (timed at
    2^23), from int64 words made apart (the 2^29 opening by evaluation:
    columns 0 .. k - 1, timed in order, held also in reverse), and, at the
    small shapes, from kept canonical words and a tail keep (limbs below
    off, kept words past it), each against gather_open_plain."""
    from lcpc_tpu_torch.ops.spmv import pack_words

    w32, uniq, tree = spec.w16 // 2, inp["uniq"], inp["tree"]
    rec = None
    if n_cols <= 1 << 19:
        comm = kb.random_mont(spec, (R, spec.w16, n_cols), gen, DEV).permute(1, 0, 2)
        comm = comm.contiguous()
        idx = inp["idx"]
        rec = vc_gather(torch, kb, vc, spec, f"{tag} opening", idx, R, tree, uniq,
                        dict(mont=comm, off=n_cols), lambda: comm.index_select(2, idx),
                        4 * spec.w16 * R * k, floor, timed)
        if not timed:
            canon = pack_words(comm, 0).permute(1, 0, 2).reshape(R * w32, n_cols).contiguous()
            half = n_cols // 2
            for name, kw in (("kept words", dict(canon=canon)),
                             ("tail keep", dict(mont=comm, off=half,
                                                canon=canon[:, half:].contiguous()))):
                vc_gather(torch, kb, vc, spec, f"{tag} {name} opening", idx, R, tree, uniq, kw,
                          None, 0, None, False)
        del comm
    words = inp["want_cols"].new_empty((w32, R, k)).random_(0, 2**32, generator=gen)
    kw, read = dict(mont=words, mont_form="words", off=k), torch.arange(k, device=DEV)
    got = vc_gather(torch, kb, vc, spec, f"{tag} int64 words opening", read, R, tree, uniq,
                    kw, lambda: words.index_select(2, read), 8 * w32 * R * k, None,
                    timed and n_cols > 1 << 19)
    vc_gather(torch, kb, vc, spec, f"{tag} int64 words opening, reversed", read.flip(0), R,
              tree, uniq, kw, None, 0, None, False)
    return rec or got


def vc_gather(torch, kb, vc, spec, tag, idx, R, hashes, uniq, kw, lib, in_bytes, floor,
              timed=True):
    """gather_open against gather_open_plain at one shape; timed, its
    warm and cold times, its bound (the opened words read once, the buffer
    written once, the path nodes), the probe's floor and the PyTorch
    index_select of the columns alone (warm and cold) beside."""
    got = vc.gather_open(spec, idx, R, hashes=hashes, uniq=uniq, **kw)
    want, plain_ms = time_host(torch, lambda: vc.gather_open_plain(
        spec, idx, R, hashes=hashes, uniq=uniq, **kw))
    if not torch.equal(got, want):
        raise AssertionError(f"gather_open {tag}: kernel != plain")
    U, k = uniq.numel(), idx.numel()
    if not timed:
        log(f"  gather_open {tag} ({R} rows x {k} columns, "
            f"{k - int(torch.unique(idx).numel())} repeats): equal to plain")
        return None
    plan = vc.gather_plan(idx.cpu().numpy(), kw.get("off", 0), DEV)
    call = lambda: vc.gather_open(spec, idx, R, hashes=hashes, uniq=uniq, plan=plan,  # noqa
                                  **kw)
    ms, cold = kb.time_kernel(call), kb.time_kernel_cold(call)
    lib_ms, lib_cold = kb.time_kernel(lib), kb.time_kernel_cold(lib)
    nbytes = in_bytes + 4 * got.numel() + 64 * U + 8 * (k + U)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    fl = floor["ascending_cold_ms"] if floor else None
    log(f"  gather_open {tag} ({R} rows x {k} columns, {k - int(torch.unique(idx).numel())} "
        f"repeats, {U} path nodes): equal to plain; device warm {ms:.4f} ms, cold {cold:.4f} "
        f"ms, bound {bound:.4f} ms (bytes), the probe's floor "
        f"{'-' if fl is None else f'{fl:.4f}'} ms (cold), index_select alone warm "
        f"{lib_ms:.4f}, cold {lib_cold:.4f} ms, plain {plain_ms:.1f} ms")
    return {"ms": ms, "cold_ms": cold, "bound_ms": bound, "bound_by": "bytes",
            "floor_ms": fl, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_cold_ms": lib_cold, "path_nodes": U}


FIELD_E2E_N = 1 << 15  # phase 17: coefficients a path in ft63, ft127 and ft191


def every_field_phase(torch, P, counters):
    """Phase 17: commit -> prove -> verify on the card in ft63, ft127 and
    ft191 (Ligero rho = 1/4 and Brakedown, BLAKE3, FIELD_E2E_N coefficients
    from a seed) and through the port's own CPU path on the same
    coefficients: roots and proof wire bytes equal, each proof verified on
    both (the polynomial's value), verify_check and gather_open launched on
    the card.  Returns the records."""
    from lcpc_tpu_torch.utils.tensors import seeded_values

    out = {}
    for spec in (P.FT63, P.FT127, P.FT191):
        vals = seeded_values(spec.p, spec.w16, FIELD_E2E_N + 1, SEED + spec.w16)
        coeffs, x = vals[:-1], vals[-1]
        want = P.univariate_eval(spec, coeffs, x)
        for name in ("ligero", "sdig"):
            got = {}
            for dev in (DEV, "cpu"):
                t0 = time.perf_counter()
                enc = (P.LigeroEncoding.new(spec, FIELD_E2E_N, *LIGERO_RHO, device=dev)
                       if name == "ligero" else
                       P.SdigEncoding.new(spec, FIELD_E2E_N, seed=SEED, device=dev))
                for fn in counters.values():
                    fn.launches = 0
                comm = P.commit(coeffs, enc, digest=P.BLAKE3)
                root = comm.get_root()
                outer, inner = P.univariate_tensors(spec, x, enc.n_per_row, comm.n_rows)
                tr = transcript_for(P, enc)
                data = P.wire.serialize_proof(spec, comm.prove(outer, tr(root)))
                value = P.wire.deserialize_proof(spec, data).verify(
                    root, outer, inner, enc, tr(root), digest=P.BLAKE3)
                launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
                got[dev] = (root, data, value, launches, (time.perf_counter() - t0) * 1e3)
            (r_c, d_c, v_c, l_c, ms_c), (r_h, d_h, v_h, _, ms_h) = got[DEV], got["cpu"]
            tag = f"{spec.name} {name} 2^{FIELD_E2E_N.bit_length() - 1}"
            if r_c != r_h or d_c != d_h:
                raise AssertionError(f"{tag}: the card's root or proof bytes != the CPU path's")
            if v_c != want or v_h != want:
                raise AssertionError(f"{tag}: verify returned another value")
            if DEV != "cpu" and (l_c.get("verify_check", 0) < 1 or l_c.get("gather_open", 0) < 1):
                raise AssertionError(f"{tag}: verify_check or gather_open not launched: {l_c}")
            log(f"  {tag}: root and {len(d_c)} proof bytes equal to the CPU path's, verified on "
                f"both; card {ms_c:.1f} ms, CPU {ms_h:.1f} ms (commit, prove, verify); the card's "
                f"launches {l_c}")
            out[tag] = {"proof_bytes": len(d_c), "card_ms": ms_c, "cpu_ms": ms_h,
                        "launches": l_c}
    return out


# phase 18: every size lcpc_tpu commits in one dispatch (its _FUSED_COMMIT_MAX,
# 2^22 encoded elements), and 2^11: Ligero rho = 1/4 at 2^11 .. 2^20 (128 x
# 32,768, the largest under it) and Brakedown CODE3 at 2^13 .. 2^21 (18 x
# 178,850); BLAKE3 and SHA-256 at each
SMALL_LOGS = {"ligero": (11, 13, 15, 16, 17, 19, 20), "sdig": (13, 15, 17, 19, 21)}
SMALL_REPS = 16  # warm commits a route: staged, kernel, kernel, staged, 8 each
SMALL_MAIN_LOG = 13  # the kernel table's row: Ligero 2^13, BLAKE3 (also held to the CPU path)
KERNEL_GATE = 1 << 62  # protocol._FUSED_COMMIT_MAX past every size: the kernel route
PROFILED = 4       # kernel commits a torch.profiler trace of phase 18 holds
PROFILE_TRIES = 5  # traces taken while one shows no CUDA event
# the small commit kernel's noinline phases, whose spills ptxas reports apart
COMMIT_PHASES = ("ligero_pass", "sdig_pack", "sdig_level", "b3_chunks", "b3_merge",
                 "sha_columns", "tree_subtrees", "tree_top")


def small_encoding(P, name, spec, n, dev):
    return (P.LigeroEncoding.new(spec, n, *LIGERO_RHO, device=dev) if name == "ligero"
            else P.SdigEncoding.new(spec, n, seed=SEED, device=dev))


def commit_ptxas(kb, build_log):
    """ptxas's report of csrc/commit_small.cu: {kernel: (registers, spill
    store bytes, spill load bytes)} of its 16 instantiations, and the
    noinline phases' entries that spill."""
    kernels = {**kb.ptxas_entries(build_log, "commit_ligero_kernel"),
               **kb.ptxas_entries(build_log, "commit_sdig_kernel")}
    spills = {k: v for name in COMMIT_PHASES
              for k, v in kb.ptxas_entries(build_log, name).items() if v[1] or v[2]}
    return kernels, spills


def small_commit_bound(spec, enc, n_rows, digest_name):
    """(bound ms, what bounds it, bytes, wide products, compressions) of one
    small commit (ops/commit_small.py's function): the (W, length) limbs and
    the encoding's tables read once (Ligero the (n-1, W32) twiddles, ntt_cost;
    Brakedown each level's CSR and values, level_cost), the codeword's limbs
    and the (8, 2 np2 - 1) int64 Merkle array written once; the products of
    the encode (the NTT's non-trivial butterflies, or (W/2)^2 a nonzero and
    row) and of the hash words (a reduction an element, W32^2 + W32); the
    column hash's compressions (BLAKE3: hash_cost; SHA-256: sha_cols_cost)
    and a compression a BLAKE3 Merkle parent or a SHA-256 parent's two, at
    the probes' rates (phase 2)."""
    w32 = spec.w16 // 2
    npr, n_cols = enc.n_per_row, enc.n_cols
    np2 = 1 << (n_cols - 1).bit_length()
    out_bytes = 4 * spec.w16 * n_rows * n_cols + 64 * (2 * np2 - 1)
    if hasattr(enc, "precodes"):
        pre, post, rs = enc.device_mats()
        nbytes, products = 4 * spec.w16 * n_rows * npr + out_bytes, 0
        for dm in (*pre, *post, rs):
            b, p = level_cost(spec, dm.nnz, dm.n_in, dm.n_out, n_rows)
            nbytes += 4 * ((dm.n_out + 1) + dm.nnz * (1 + w32))  # the level's CSR and values
            products += p
        products += n_rows * n_cols * (w32 * w32 + w32)  # the hash words
    else:
        nbytes, products, _ = ntt_cost(spec, n_rows, npr, n_cols, True)
        nbytes += out_bytes - 4 * spec.w16 * n_rows * n_cols - 4 * w32 * n_rows * n_cols
    words = n_rows * w32
    if digest_name == "blake3":
        (_, c1), (_, c2) = hash_cost(words, n_cols)
        comp, t_comp = c1 + c2 + np2 - 1, (c1 + c2 + np2 - 1) * B3_COMPRESSION_S
    else:
        _, c1 = sha_cols_cost(words, n_cols)
        comp, t_comp = c1 + 2 * (np2 - 1), c1 * SHA_COMPRESSION_S + (np2 - 1) * SHA_PARENT_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products / WIDE_PRODUCTS_PER_S * 1e3 + t_comp * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes,
            products, comp)


def commit_outputs_equal(torch, got, want):
    """(mat, comm, flat) triples (or LcCommits) equal in every word."""
    if hasattr(got, "hashes_dev"):
        got = (got.coeffs, got.comm, got.hashes_dev)
    if hasattr(want, "hashes_dev"):
        want = (want.coeffs, want.comm, want.hashes_dev)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def small_commit_phase(torch, kb, P, counters, gen, ptxas):
    """Phase 18: the small commit by the kernel (csrc/commit_small.cu, one
    cooperative launch: core/protocol.py's _commit_fused_fn) against the
    staged route and the kernel's plain version (ops/commit_small.py's
    commit_small_plain, the stages' plain versions on the card), the route
    forced through protocol._FUSED_COMMIT_MAX.  At each size of SMALL_LOGS
    and each digest: the first commit on a fresh encoding (its tables made
    there) and a warm one, each counted: one launch of the kernel and no
    other counter of the port's kernels moved (launch_count.COUNTERS); a
    kernel commit's stream work captured in a CUDA graph: one kernel node,
    the kernel's, and nothing else; torch.profiler's CUDA kernel events
    over PROFILED warm commits, recorded: the kernel, at most once a commit,
    and nothing else (events are a lower bound in this run: a trace that
    shows none is taken again, up to PROFILE_TRIES); mat, comm, flat and
    root equal to the staged route's and
    to the plain version's on seeded coefficients and on all-(p-1) limbs
    of a padded length (n - 3); the route the port's gates take; host walls
    of the first commit by each route (fresh encodings) and warm medians in
    turns (staged, kernel, kernel, staged; SMALL_REPS of each); the
    kernel's device ms by CUDA events beside its bound and the staged
    route's device ms; at 2^13 also against the port's CPU path.  Returns
    the records, ptxas's report and the (Ligero 2^13, BLAKE3) main run
    (counts zeroed just before, read just after) under "main"."""
    from lcpc_tpu_torch.core import protocol as proto
    from lcpc_tpu_torch.ops import commit_small as cs
    from lcpc_tpu_torch.ops import launch_count
    from lcpc_tpu_torch.ops.limbs import get_ops

    spec = P.FT255
    ops = get_ops(spec)
    gate0 = proto._FUSED_COMMIT_MAX
    recs = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def moved(fn):
        """fn() with every counter of the package zeroed before: (result, host
        ms, {counter: launches} of those that moved)."""
        for c in launch_count.COUNTERS:
            c.launches = 0
        out, ms = time_host(torch, fn)
        return out, ms, {getattr(c, "__name__", repr(c)): c.launches
                         for c in launch_count.COUNTERS if c.launches}

    one = {"commit_small": 1}
    dot = os.path.join(ROOT, "chiprun_out", "commit_small_graph.dot")  # the graphs' dumps
    os.makedirs(os.path.dirname(dot), exist_ok=True)
    try:
        for name, logs in SMALL_LOGS.items():
            for log_n in logs:
                n = 1 << log_n
                small_encoding(P, name, spec, n, DEV).device_tables()  # the plan's table
                for digest in (P.BLAKE3, P.SHA256):
                    tag = f"{name} 2^{log_n} {digest.name}"
                    a = kb.random_mont(spec, (1, spec.w16, n), gen, device=DEV)[0]
                    edge = torch.from_numpy(ops.encode_host([spec.p - 1] * (n - 3), to_mont=False)
                                            .astype("int32")).to(DEV)

                    def commit(x, gate, e):
                        proto._FUSED_COMMIT_MAX = gate0 if gate is None else {
                            k: gate for k in gate0}
                        return P.commit(x, e, digest=digest)

                    fresh = small_encoding(P, name, spec, n, DEV)
                    first, first_ms, l_first = moved(lambda: commit(a, KERNEL_GATE, fresh))
                    enc = fresh
                    n_rows, npr, n_cols = enc.get_dims(n)
                    warm, warm_ms, l_warm = moved(lambda: commit(a, KERNEL_GATE, enc))
                    if l_first != one or l_warm != one:
                        raise AssertionError(f"{tag}: a kernel commit moved {l_first} (first), "
                                             f"{l_warm} (warm); want {one}")
                    staged_fresh = small_encoding(P, name, spec, n, DEV)
                    _, staged_first_ms, l_staged = moved(
                        lambda: commit(a, 0, staged_fresh))
                    del staged_fresh
                    staged = commit(a, 0, enc)
                    plain, plain_ms = time_host(torch, lambda: cs.commit_small_plain(
                        enc, digest, a))
                    for what, got in (("first", first), ("warm", warm)):
                        if not (commit_outputs_equal(torch, got, staged)
                                and commit_outputs_equal(torch, got, plain)):
                            raise AssertionError(f"{tag}: the kernel's {what} commit != the "
                                                 f"staged route's or the plain version's")
                    e_k = commit(edge, KERNEL_GATE, enc)
                    if not (commit_outputs_equal(torch, e_k, commit(edge, 0, enc))
                            and commit_outputs_equal(torch, e_k, cs.commit_small_plain(
                                enc, digest, edge))):
                        raise AssertionError(f"{tag}: all-(p-1) limbs of length n - 3: the "
                                             f"kernel != the staged route or the plain version")
                    if warm.get_root() != staged.get_root() or \
                            e_k.get_root() == warm.get_root():
                        raise AssertionError(f"{tag}: roots")
                    if log_n == SMALL_MAIN_LOG:
                        cpu = P.commit(a.cpu(), small_encoding(P, name, spec, n, "cpu"),
                                       digest=digest)
                        if cpu.get_root() != warm.get_root() or not torch.equal(
                                cpu.comm, warm.comm.cpu()):
                            raise AssertionError(f"{tag}: the kernel's commit != the CPU path's")
                    # the port's gate
                    under = n_rows * n_cols <= gate0.get(type(enc).__name__, 0)
                    _, _, l_gate = moved(lambda: commit(a, None, enc))
                    if (l_gate == one) != under:
                        raise AssertionError(f"{tag}: under the port's gates the commit "
                                             f"launched {l_gate}")
                    # a kernel commit's stream work, captured in a CUDA graph: the
                    # kernel and nothing else (no torch kernel, copy or memset;
                    # a host sync would fail the capture)
                    nodes = kb.captured_nodes(lambda: cs.commit_small(enc, digest, a), dot)
                    if [k for k, _ in nodes] != ["KERNEL"] or "commit_" not in nodes[0][1]:
                        raise AssertionError(f"{tag}: a kernel commit's captured graph holds "
                                             f"{[(k, t[:120]) for k, t in nodes]}")
                    # torch.profiler over PROFILED commits, recorded: the kernel, at
                    # most once a commit, and nothing else.  Its CUDA events in
                    # this long run are a lower bound (phases 4, 6, 14 log traces
                    # that lost some or all): a trace with none is taken again
                    kernels = []
                    for _ in range(PROFILE_TRIES):
                        commit(a, KERNEL_GATE, enc)
                        with torch.profiler.profile(activities=acts) as prof:
                            time_host(torch, lambda: [commit(a, KERNEL_GATE, enc)
                                                      for _ in range(PROFILED)])
                        kernels = [e.name for e in prof.events()
                                   if e.device_type == torch.autograd.DeviceType.CUDA]
                        if len(kernels) > PROFILED or any("commit_" not in k for k in kernels):
                            raise AssertionError(f"{tag}: torch.profiler saw {kernels} over "
                                                 f"{PROFILED} commits")
                        if kernels:
                            break
                    # timed: host walls in turns, device ms by events
                    runs = {"staged": [], "kernel": []}
                    for route in ("staged", "kernel", "kernel", "staged"):
                        gate = 0 if route == "staged" else KERNEL_GATE
                        runs[route] += [time_host(torch, lambda: commit(a, gate, enc))[1]
                                        for _ in range(SMALL_REPS // 2)]
                    dev_ms = kb.time_kernel(lambda: proto._commit_fused_fn(enc, digest)(a))
                    staged_dev_ms = kb.time_kernel(lambda: proto._commit_staged(enc, digest, a))
                    bound, by, nbytes, products, comp = small_commit_bound(spec, enc, n_rows,
                                                                           digest.name)
                    rec = {"n_rows": n_rows, "n_per_row": npr, "n_cols": n_cols,
                           "elements": n_rows * n_cols, "first_ms": first_ms,
                           "warm_counted_ms": warm_ms, "staged_first_ms": staged_first_ms,
                           "staged_first_launches": l_staged,
                           "staged_ms": statistics.median(runs["staged"]),
                           "kernel_ms": statistics.median(runs["kernel"]), "runs_ms": runs,
                           "device_ms": dev_ms, "staged_device_ms": staged_dev_ms,
                           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                           "bytes": nbytes, "products": products, "compressions": comp,
                           "graph_nodes": [k for k, _ in nodes], "profiler_kernels": kernels,
                           "route_at_gate": "kernel" if under else "staged"}
                    if (name, log_n, digest.name) == ("ligero", SMALL_MAIN_LOG, "blake3"):
                        # the row's run: counts zeroed just before, read just after
                        _, main_ms, main_l = counted(torch, counters,
                                                     lambda: commit(a, KERNEL_GATE, enc))
                        rec.update(main_ms=main_ms, main_launches=main_l)
                    recs[tag] = rec
                    log(f"  {tag}: {n_rows} x {n_cols} = {n_rows * n_cols:,} elements; kernel == "
                        f"staged == plain (first, warm; seeded and all p-1 of n - 3)"
                        f"{' == CPU path' if log_n == SMALL_MAIN_LOG else ''}; 1 launch, its "
                        f"captured graph 1 kernel node; profiler {len(kernels)} of {PROFILED} seen "
                        f"{kernels[0][:40] if kernels else '(none in ' + str(PROFILE_TRIES) + ' traces)'}"
                        f"; first commit kernel {first_ms:.4f} ms, staged "
                        f"{staged_first_ms:.4f}; warm kernel {rec['kernel_ms']:.4f} ms, staged "
                        f"{rec['staged_ms']:.4f} (x{rec['staged_ms'] / rec['kernel_ms']:.2f}); "
                        f"device {dev_ms:.4f} ms (staged {staged_dev_ms:.4f}), bound "
                        f"{bound:.4f} ({by}), plain {plain_ms:.1f} ms; the port's gate: "
                        f"{rec['route_at_gate']}")
                    del first, warm, staged, plain, e_k
                del enc, fresh
                torch.cuda.empty_cache()
    finally:
        proto._FUSED_COMMIT_MAX = gate0
    wins = {}
    for tag, rec in recs.items():
        if rec["kernel_ms"] < rec["staged_ms"] and tag.endswith("blake3"):
            enc_name = tag.split()[0]
            wins[enc_name] = max(wins.get(enc_name, 0), rec["elements"])
    kernels, spills = ptxas
    log(f"  largest kernel win (encoded elements): {wins}; the gates _FUSED_COMMIT_MAX = "
        f"{gate0}; ptxas {len(kernels)} kernels, noinline phases that spill: {spills or 'none'}")
    return {"records": recs, "largest_kernel_win": wins, "gate": gate0,
            "ptxas": {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                      for k, v in kernels.items()},
            "phase_spills": {k: v[1] + v[2] for k, v in spills.items()},
            "main": recs[f"ligero 2^{SMALL_MAIN_LOG} blake3"]}


# phase 19: n = 2, 4, 8 and 32 (a one-stage and a two-stage round), one
# pass's widest, two passes (the second of one stage), 2^12
INTT_LOGS = (1, 2, 3, 5, 10, 11, 12)
INTT_TIMED = (17, (2, 256))  # phase 19: n = 2^17 at verify's rows and the 2^23 codeword's
INTT_IDENTITY = (13, 23)     # phase 19: the FFT identity's sizes (the kernel route, staged)


def intt_cost(spec, r, n):
    """(bytes, wide products) of one intt_inverse of r rows of n: the (W, r,
    n) limbs read and written once, the (n-1, W32) table read once; every
    butterfly with a twiddle other than 1 one CIOS product (2 W32^2 + W32
    wide products), its v's n^-1 folded into that twiddle; the n^-1 scale
    of the last stage's n/2 + 1 other operands (its u's, and the v of its
    one butterfly whose twiddle is 1) one Montgomery step of log2 n bits
    each (W32 + 1 wide products: csrc/ntt_mont.cu's div_pow2)."""
    w32 = spec.w16 // 2
    butterflies = r * ((n // 2) * (n.bit_length() - 1) - (n - 1))
    nbytes = 4 * (2 * spec.w16 * r * n + (n - 1) * w32)
    return nbytes, butterflies * (2 * w32 * w32 + w32) + r * (n // 2 + 1) * (w32 + 1)


def intt_phase(torch, kb, P, nttm, counters, gen):
    """Phase 19: the inverse NTT kernel (csrc/ntt_mont.cu's inverse pass)
    against intt_inverse_plain, bit for bit, in every field (n = INTT_LOGS,
    2^12 in three passes; rows random, zeros, all p - 1, p -
    1 - (i mod 7)); intt(ntt(x)) == x at 256 x 2^17; the reference's FFT
    identity (collapse the codeword by the outer tensor with mont_dot,
    inverse-transform it: the collapsed coefficients, then zeros) at 2^13
    (the small commit's kernel) and 2^23 (the main path's width, counts zeroed just
    before, read just after); timed warm and cold at 2 x 2^17 and 256 x
    2^17 beside its bound and its plain version.  Returns the records."""
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.ops.mont_dot import mont_dot
    from lcpc_tpu_torch.ops.spmv import unpack_words

    out = {"cases": [], "shapes": {}, "identity": {}}
    err = 0
    for spec in P.ALL_FIELDS:
        ops = get_ops(spec)
        three = dict(log_chunk=6, log_t=2, max_tile_bytes=64 * spec.w16)  # 6 + 3 + 3 stages
        for log_n, kw in [(v, {}) for v in INTT_LOGS] + [(12, three)]:
            n = 1 << log_n
            plan = nttm.InttPlan(spec, n, **kw)
            if kw and len(plan.passes) != 3:
                raise AssertionError(f"intt {spec.name}: forced plan {plan.passes}")
            x = kb.random_mont(spec, (4, spec.w16, n), gen, device=DEV).permute(1, 0, 2)
            x = x.contiguous()
            x[:, 1] = 0
            edge = [spec.p - 1] * n, [spec.p - 1 - i % 7 for i in range(n)]
            for r, vals in zip((2, 3), edge):  # stored words near p, as they are
                x[:, r] = torch.from_numpy(ops.encode_host(vals, to_mont=False)
                                           .astype("int32")).to(DEV)
            before = nttm.intt_inverse.launches
            got = nttm.intt_inverse(plan, x)
            if DEV != "cpu" and nttm.intt_inverse.launches - before != plan.launches_per_call:
                raise AssertionError(f"intt {spec.name} n={n}: launches")
            ok, e = equal_outputs(torch, got, nttm.intt_inverse_plain(plan, x))
            err = max(err, e)
            if not ok:
                raise AssertionError(f"intt {spec.name} n=2^{log_n} {len(plan.passes)} passes: "
                                     f"kernel != plain (max err {e})")
            out["cases"].append({"field": spec.name, "n": n, "passes": len(plan.passes)})
        log(f"  intt {spec.name} (W32={spec.w16 // 2}): n = 2^{', 2^'.join(map(str, INTT_LOGS))} "
            f"and 2^12 in 3 passes x rows random / 0 / p-1 / near p: equal")
    spec = P.FT255
    log_n, rows = INTT_TIMED
    n = 1 << log_n
    plan, fwd = nttm.get_intt(spec, n), nttm.get_ntt(spec, n)
    for r in rows:
        x = kb.random_mont(spec, (r, spec.w16, n), gen, device=DEV).permute(1, 0, 2)
        x = x.contiguous()
        y = nttm.ntt_forward(fwd, x)
        back = nttm.intt_inverse(plan, y)
        if not torch.equal(back, x):
            raise AssertionError(f"intt(ntt(x)) != x at {r} x 2^{log_n}")
        want, plain_ms = time_host(torch, lambda: nttm.intt_inverse_plain(plan, y))
        ok, e = equal_outputs(torch, back, want)
        err = max(err, e)
        if not ok:
            raise AssertionError(f"intt {r} x 2^{log_n}: kernel != plain (max err {e})")
        del want, back
        ms = kb.time_kernel(lambda: nttm.intt_inverse(plan, y))
        cold_ms = kb.time_kernel_cold(lambda: nttm.intt_inverse(plan, y))
        nbytes, products = intt_cost(spec, r, n)
        b, tb, to = bound_ms(nbytes, products)
        out["shapes"][f"{r} rows"] = {"n": n,
            "ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": "bytes" if tb >= to else "operations", "bytes": nbytes,
            "products": products, "passes": [dataclasses.astuple(ps) for ps in plan.passes]}
        log(f"  intt ft255 {r} x 2^{log_n} ({plan.launches_per_call} passes): intt(ntt(x)) == x, "
            f"equal to plain; {ms:.4f} ms warm, {cold_ms:.4f} cold, plain {plain_ms:.1f} ms, "
            f"bound {b:.4f} ms (bytes {tb:.4f}, products {to:.4f})")
        del x, y
        torch.cuda.empty_cache()
    ops = get_ops(spec)
    for log_n in INTT_IDENTITY:
        enc = P.LigeroEncoding.new(spec, 1 << log_n, *LIGERO_RHO, device=DEV)
        coeffs = kb.random_mont(spec, (1, spec.w16, 1 << log_n), gen, device=DEV)[0]
        n_rows, npr, n_cols = enc.get_dims(1 << log_n)
        outer, _ = P.univariate_tensors(spec, 0x5EED % spec.p, npr, n_rows)
        outer_m = torch.from_numpy(ops.encode_host(outer).astype("int32")).to(DEV)[:, None, :]
        def identity():
            comm = P.commit(coeffs, enc)
            flat = unpack_words(mont_dot(spec, outer_m, comm.coeffs, "mont", x_form="limbs",
                                         y_form="limbs"), 0)
            enc_flat = unpack_words(mont_dot(spec, outer_m, comm.comm, "mont", x_form="limbs",
                                             y_form="limbs"), 0)
            return flat, nttm.intt_inverse(nttm.get_intt(spec, n_cols), enc_flat)

        (flat, back), ms, launches = counted(torch, counters, identity)
        kernel = launches.get("commit_small", 0) == 1
        if not torch.equal(back[:, :, :npr], flat) or back[:, :, npr:].any():
            raise AssertionError(f"FFT identity 2^{log_n}: the inverse of the collapsed codeword "
                                 f"!= the collapsed coefficients, zeros above")
        out["identity"][f"2^{log_n}"] = {"n_rows": n_rows, "n_cols": n_cols, "ms": ms,
                                         "kernel_route": kernel, "launches": launches}
        log(f"  FFT identity 2^{log_n} ({n_rows} x {n_cols}, commit by the "
            f"{'kernel' if kernel else 'staged'} route): intt(collapsed codeword) = collapsed "
            f"coefficients, then zeros; {ms:.1f} ms; launches {launches}")
        del enc, coeffs, flat, back
        torch.cuda.empty_cache()
    if not out["identity"][f"2^{INTT_IDENTITY[0]}"]["kernel_route"]:
        raise AssertionError("FFT identity: the small commit did not take the kernel route")
    out["max_abs_err"] = err
    return out


def small_rows(small, inv):
    """The kernel table rows of the small commit's kernel and the inverse NTT."""
    main = small["main"]
    big = inv["shapes"][f"{INTT_TIMED[1][1]} rows"]
    verify = inv["shapes"][f"{INTT_TIMED[1][0]} rows"]
    return [{
        "name": "commit_small",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/commit_small.cu",
        "replaces": "lcpc_tpu/core/protocol.py:345 (_commit_fused_fn, XLA-fused, not Pallas)",
        "launches": main["main_launches"].get("commit_small", 0),
        "max_abs_err": 0,
        "ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": (f"one ft255 rho=1/4 BLAKE3 commit of 2^{SMALL_MAIN_LOG} coefficients "
                  f"({main['n_rows']} x "
                  f"{main['n_cols']}): one cooperative launch, device ms by CUDA events"),
        "host_first_ms": main["first_ms"],
        "host_warm_ms": main["kernel_ms"],
        "host_staged_ms": main["staged_ms"],
        "host_staged_first_ms": main["staged_first_ms"],
        "staged_device_ms": main["staged_device_ms"],
        "by_size_ms": {tag: {k: r[k] for k in ("first_ms", "kernel_ms", "staged_first_ms",
                                               "staged_ms", "device_ms", "staged_device_ms",
                                               "bound_ms")}
                       for tag, r in small["records"].items()},
        "largest_kernel_win_elements": small["largest_kernel_win"],
        "gate": small["gate"],
        "ptxas": small["ptxas"],
        "phase_spills": small["phase_spills"],
    }, {
        "name": "intt_inverse",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/ntt_mont.cu",
        "replaces": "lcpc_tpu/ops/ntt.py:184 (_intt_inverse; BatchedIntt :229; XLA-fused, "
                    "not Pallas)",
        "launches": inv["identity"][f"2^{INTT_IDENTITY[1]}"]["launches"].get("intt_inverse", 0),
        "max_abs_err": inv["max_abs_err"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": "ft255 256 x 2^17 (the 2^23 Ligero codeword's rows), limbs in and out",
        "cold_ms": big["cold_ms"],
        "rows_2_ms": verify["ms"],
        "rows_2_cold_ms": verify["cold_ms"],
        "rows_2_plain_ms": verify["plain_ms"],
        "rows_2_bound_ms": verify["bound_ms"],
    }]


# phase 20: the four-step NTT on the tensor cores (ops/mxu_ntt.py) with
# encodings/ligero.MXU_NTT forced true.  (a) the kernel's cases in every
# field: (n, in_len or None for the full plan, rows); each also ragged, its
# rows 3 short of in_len
MXU_CASES = ((16, None, 1), (16, 4, 2), (64, 16, 3), (256, 64, 2), (512, 256, 1),
             (1024, None, 3), (4096, 1024, 2), (4096, None, 1))
MXU_TURNS = ("ladder", "mxu", "mxu", "ladder")  # (b): the routes' timing turns
MXU_PLAIN_ROWS = (2, 16)  # (b): the plain version's rows at the main path's n (verify's, more)
PATH_TURN_REPS = 3  # (c): warm commit -> prove -> verify runs a turn of MXU_TURNS


def mxu_cost(spec, r, k, n, a_nz, b, output, words_in):
    """(bytes, u8 multiply-adds, wide products) of one MxuNtt call: x read
    once ((W, r, k) limbs or (r, k, W/2) words), the tables once (the
    constants' bytes (A, CP1, 2W) and (B, CP2, 2W), tw's (B, A, W/2)
    words), the outputs written once ((W, r, n) limbs, (r W/2, n) words).
    Step 1 contracts a_nz and step 3 b elements an output, (2W)^2 byte
    products each (the kernel's Toeplitz operand issues SR 2W of them,
    SR = 4W - 1 rounded up to 16: its zeros are not counted); each of the
    r n outputs of either step one wide
    reduction (2 W32^2 wide products), step 1's a twiddle product (2 W32^2 +
    W32), step 3's a from_mont for Montgomery words (W32^2 + W32) and a
    product by R^2 for limbs from words (2 W32^2 + W32)."""
    from lcpc_tpu_torch.ops.mxu_ntt import stage_c

    w32 = spec.w16 // 2
    a = n // b
    cp = lambda c: -(-c // stage_c(spec)) * stage_c(spec)  # noqa: E731
    limbs, words = output != "words", output != "limbs"
    nbytes = (4 * w32 * r * k + a * 4 * w32 * cp(a_nz) + 4 * w32 * a * b + b * 4 * w32 * cp(b)
              + (4 * spec.w16 * r * n if limbs else 0) + (4 * w32 * r * n if words else 0))
    macs = r * n * (a_nz + b) * (4 * w32) ** 2
    epi = 2 * (2 * w32 * w32) + (2 * w32 * w32 + w32)
    if words and not words_in and output == "both":
        epi += w32 * w32 + w32
    if limbs and words_in:
        epi += 2 * w32 * w32 + w32
    return nbytes, macs, r * n * epi


def mxu_bound(spec, r, k, n, a_nz, b, output, words_in):
    """(ms, by, bytes ms, u8 ms, wide ms): the larger of the bytes over
    3.35 TB/s and the operations, the u8 multiply-adds at 989.4e12/s and
    the wide products at 8.4e12/s each on their own units."""
    nbytes, macs, wide = mxu_cost(spec, r, k, n, a_nz, b, output, words_in)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_u8 = 2 * macs / INT8_OPS_PER_S * 1e3
    t_wide = wide / WIDE_PRODUCTS_PER_S * 1e3
    t = max(t_bytes, t_u8, t_wide)
    return t, ("bytes" if t == t_bytes else "operations"), t_bytes, t_u8, t_wide


def mxu_inputs(torch, kb, spec, r, k, gen):
    """((W, r, k) Montgomery limbs, (r, k, W/2) canonical words), both
    strided views: row 0 random below p, row 1 all 0xFFFF limbs / all
    0xFFFFFFFF words (R - 1, top bit set), row 2 p - 1 - (i mod 7)."""
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.ops.spmv import pack_words

    ops = get_ops(spec)
    x = kb.random_mont(spec, (r, spec.w16, k), gen, device=DEV).permute(1, 0, 2)
    xw = pack_words(kb.random_mont(spec, (r, spec.w16, k), gen, device=DEV), 1)
    xw = xw.permute(0, 2, 1)  # (r, k, W/2), the word axis strided
    if r > 1:
        x[:, 1] = 0xFFFF
        xw[1] = -1
    if r > 2:
        near = ops.encode_host([spec.p - 1 - i % 7 for i in range(k)], to_mont=False)
        x[:, 2] = torch.from_numpy(near.astype("int32")).to(DEV)
        xw[2] = pack_words(x[:, 2], 0).T
    return x, xw


def mxu_steps(torch, ntt, x, chunk):
    """MxuNtt's two launches on (W, R, k) limbs, both outputs, as two
    calls of the C entry (step 1, step 3), with the contraction summed
    `chunk` elements at a time (MxuNtt takes chunk_c, past every
    contraction this phase can hold to its plain version): returns
    (step1, step3, (limbs, words)), the outputs filled once both ran."""
    from lcpc_tpu_torch.ops import mxu_ntt as mx

    plan, spec = ntt.plan, ntt.spec
    w32, (_, r, k), n, a, b = spec.w16 // 2, x.shape, ntt.n, plan.a, plan.b
    k1, tw, k2 = plan.device_tables(x.device)
    z = torch.empty((r, a, b, w32), dtype=torch.int32, device=x.device)
    lout = torch.empty((spec.w16, r, n), dtype=torch.int32, device=x.device)
    wout = torch.empty((r * w32, n), dtype=torch.int32, device=x.device)
    step1 = lambda: mx.mxu_dft(  # noqa: E731
        spec, 1, k1, x, NR=b, NCOL=a, C=plan.a_nz, R=r, chunk=chunk, strides=x.stride(),
        limbs=True, k=k, sc=b, sq=1, tw=tw, zout=z)
    step3 = lambda: mx.mxu_dft(  # noqa: E731
        spec, 3, k2, z, NR=a, NCOL=b, C=b, R=r, chunk=chunk, lout=lout, wout=wout,
        wconv=not plan.canonical_out)
    return step1, step3, (lout, wout)


def mxu_kernel_phase(torch, kb, P, nttm, card, gen):
    """Phase 20 (a), (b): MxuNtt's kernel (csrc/mxu_ntt.cu, two launches a
    transform) against mxu_ntt_plain, bit for bit, in every field
    (MXU_CASES; Montgomery and canonical plans; limbs and words in; limbs,
    words and both out); against the ladder (ntt_forward) at the 2^23
    commit's transform (256 x 2^17 from 2^15, ft255: limbs and words) and
    verify's (2 rows, words in), and against its plain version at
    MXU_PLAIN_ROWS rows of it; timed warm and cold in turns MXU_TURNS beside
    its bound and the ladder's.  Returns the records."""
    from lcpc_tpu_torch.ops import mxu_ntt as mx
    from lcpc_tpu_torch.ops.spmv import pack_words

    out = {"cases": [], "shapes": {}}
    err = 0

    def held(ntt, x, output, input, tag):
        before = mx.mxu_dft.launches
        got = ntt(x, output=output, input=input)
        if DEV != "cpu" and mx.mxu_dft.launches - before != 2:
            raise AssertionError(f"mxu {tag}: {mx.mxu_dft.launches - before} launches, not 2")
        ok, e = equal_outputs(torch, got, mx.mxu_ntt_plain(ntt, x, output=output, input=input))
        if not ok:
            raise AssertionError(f"mxu {tag} {input} -> {output}: kernel != plain (max err {e})")
        return e

    for spec in P.ALL_FIELDS:
        for n, in_len, r in MXU_CASES:
            ntt = mx.get_mxu_ntt(spec, n, in_len)
            full = in_len or n
            for k in (full, full - 3) if full > 4 else (full,):
                x, xw = mxu_inputs(torch, kb, spec, r, k, gen)
                tag = f"{spec.name} n={n} in_len={in_len} R={r} k={k}"
                for output in ("limbs", "words", "both"):
                    err = max(err, held(ntt, x, output, "limbs", tag))
                for output in ("limbs", "both"):
                    err = max(err, held(ntt, xw, output, "words", tag))
                out["cases"].append({"field": spec.name, "n": n, "in_len": in_len, "r": r,
                                     "k": k, "a": ntt.plan.a, "b": ntt.plan.b})
        cs = mx.stage_c(spec)  # contractions of 2 and 4 chunks of one stage each
        for n in ((2 * cs) ** 2, (4 * cs) ** 2):
            ntt = mx.get_mxu_ntt(spec, n)
            x, _ = mxu_inputs(torch, kb, spec, 2, n, gen)
            if DEV != "cpu":
                step1, step3, got = mxu_steps(torch, ntt, x, cs)
                step1()
                step3()
                ok, e = equal_outputs(torch, got, mx.mxu_ntt_plain(ntt, x, output="both"))
                err = max(err, e)
                if not ok:
                    raise AssertionError(f"mxu {spec.name} n={n} in chunks of {cs}: kernel != "
                                         f"plain (max err {e})")
            out["cases"].append({"field": spec.name, "n": n, "in_len": None, "r": 2, "k": n,
                                 "a": ntt.plan.a, "b": ntt.plan.b, "chunk": cs})
        log(f"  mxu {spec.name} (W32={spec.w16 // 2}): {len(MXU_CASES)} plans (n = 16 .. 4,096, "
            f"full and zero-padded), R = 1 .. 3, full and ragged rows (random, all 0xFFFF "
            f"limbs / 0xFFFFFFFF words, near p), limbs in (limbs, words by the canonical plan, "
            f"both) and words in (limbs, both), and contractions in 2 and 4 chunks: equal "
            f"to mxu_ntt_plain")

    spec = P.FT255
    lenc = P.LigeroEncoding.new(spec, N_COEFFS, *LIGERO_RHO, device=DEV)
    n, npr = lenc.n_cols, lenc.n_per_row
    n_rows = -(-N_COEFFS // npr)
    plan = nttm.get_ntt(spec, n)
    mxu = mx.get_mxu_ntt(spec, n, npr)
    a_nz, b = mxu.plan.a_nz, mxu.plan.b
    x = kb.random_mont(spec, (n_rows, spec.w16, npr), gen, device=DEV).permute(1, 0, 2)
    x = x.contiguous()
    xv = pack_words(kb.random_mont(spec, (2, spec.w16, npr), gen, device=DEV), 1)
    xv = xv.permute(0, 2, 1).contiguous()  # verify's proof rows: (2, npr, W/2) words
    shapes = (("commit", x, "both", "limbs"), ("commit words", x, "words", "limbs"),
              ("verify", xv, "limbs", "words"))
    for tag, xi, output, input in shapes:
        got = mxu(xi, output=output, input=input)
        ok, e = equal_outputs(torch, got, nttm.ntt_forward(plan, xi, output=output, input=input))
        err = max(err, e)
        if not ok:
            raise AssertionError(f"mxu {tag} at {xi.shape}: != ntt_forward (max err {e})")
        del got
    log(f"  mxu ft255 {n_rows} x {npr} -> {n} (A = {mxu.plan.a}, B = {b}, A_nz = {a_nz}): "
        f"limbs and words equal to ntt_forward (the ladder); words only (the canonical plan) "
        f"equal; verify's 2 rows of words in equal")
    plain = {}
    for r in MXU_PLAIN_ROWS:
        xr = x[:, :r]
        want_r, plain[r] = time_host(torch, lambda: mx.mxu_ntt_plain(mxu, xr, output="both"))
        ok, e = equal_outputs(torch, mxu(xr, output="both"), want_r)
        err = max(err, e)
        if not ok:
            raise AssertionError(f"mxu {r} x {npr} -> {n}: kernel != plain (max err {e})")
        del want_r
    log(f"  mxu ft255 {', '.join(map(str, MXU_PLAIN_ROWS))} rows: equal to mxu_ntt_plain; "
        f"plain {', '.join(f'{v:.1f}' for v in plain.values())} ms")
    routes = {"ladder": lambda xi, o, i: nttm.ntt_forward(plan, xi, output=o, input=i),
              "mxu": lambda xi, o, i: mxu(xi, output=o, input=i)}
    for tag, xi, output, input in shapes:
        r = xi.shape[1] if input == "limbs" else xi.shape[0]
        turns = []
        for route in MXU_TURNS:
            fn = lambda: routes[route](xi, output, input)  # noqa: E731
            turns.append({"route": route, "ms": kb.time_kernel(fn),
                          "cold_ms": kb.time_kernel_cold(fn)})
        bnd = mxu_bound(spec, r, npr, n, a_nz, b, output, input == "words")
        nbytes, products, _ = ntt_cost(spec, r, npr, n, output != "limbs")
        ladder_b, ladder_bytes, ladder_ops = bound_ms(nbytes, products)
        # the function's bound is the lesser count of the same NTT: the
        # ladder's n log n butterflies, not the four-step's dense DFTs
        if ladder_b <= bnd[0]:
            by = "bytes" if ladder_bytes >= ladder_ops else "operations"
            fn_bound = (ladder_b, by, "ladder (ntt_cost)")
        else:
            fn_bound = (bnd[0], bnd[1], "four-step (mxu_cost)")
        rec = {"r": r, "k": npr, "n": n, "output": output, "input": input, "turns": turns,
               "bound_ms": fn_bound[0], "bound_by": fn_bound[1], "bound_count": fn_bound[2],
               "mxu_bound_ms": bnd[0], "mxu_bound_by": bnd[1], "bytes_ms": bnd[2],
               "u8_ms": bnd[3], "wide_ms": bnd[4], "ladder_bound_ms": ladder_b}
        out["shapes"][tag] = rec
        warm, cold = (", ".join(f"{t[key]:.4f}" for t in turns) for key in ("ms", "cold_ms"))
        log(f"  mxu vs ladder, {tag} ({r} x {npr} -> {n}, {input} -> {output}), warm / cold ms "
            f"in turns {', '.join(MXU_TURNS)}: {warm} / {cold}; the NTT's bound "
            f"{fn_bound[0]:.4f} ms ({fn_bound[1]}, by the {fn_bound[2]} count); the four-step "
            f"count's {bnd[0]:.4f} ({bnd[1]}: bytes {bnd[2]:.4f}, u8 products {bnd[3]:.4f}, "
            f"wide products {bnd[4]:.4f}), the ladder's {ladder_b:.4f} ({card})")
    if DEV != "cpu":  # the two launches apart at the commit's transform, warm
        step1, step3, _ = mxu_steps(torch, mxu, x, mx.chunk_c(spec))
        out["steps_ms"] = [kb.time_kernel(step1), kb.time_kernel(step3)]
        log(f"  mxu commit's launches apart: step 1 (contraction {a_nz}) "
            f"{out['steps_ms'][0]:.4f} ms, step 3 (contraction {b}) {out['steps_ms'][1]:.4f} ms")
    out["plain_ms"] = plain
    out["max_abs_err"] = err
    del x, xv
    torch.cuda.empty_cache()
    return out


def path_turns(torch, P, ligero, enc, coeffs_mont, x_pt, want, card):
    """Phase 20 (c): the Ligero 2^23 path with BLAKE3 in turns MXU_TURNS,
    MXU_NTT set by each turn's route: the median ms by stage of
    PATH_TURN_REPS warm runs, then one run with each stage traced
    (torch.profiler) for its wall and device-busy ms, and the caching
    allocator's reserved GiB before the turn.  Puts a route's gap in a stage
    on the device or the host.  Returns the turns."""
    spec = enc.spec
    n_rows = -(-N_COEFFS // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
    transcript = transcript_for(P, enc)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = ("commit", "prove", "verify")
    turns = []
    for route in MXU_TURNS:
        ligero.MXU_NTT = route == "mxu"
        reserved = torch.cuda.memory_reserved() / 2**30
        runs = []
        for _ in range(PATH_TURN_REPS):
            _, _, value, ms, _ = drive(torch, P, enc, coeffs_mont, outer, inner, P.BLAKE3)
            if value != want:
                raise AssertionError(f"path turn {route}: verify returned the wrong evaluation")
            runs.append(ms)
        st, traced = {}, {}
        stages = (("commit", lambda: P.commit(coeffs_mont, enc, digest=P.BLAKE3)),
                  ("prove", lambda: st["commit"].prove(outer, transcript(st["root"]))),
                  ("verify", lambda: st["prove"].verify(st["root"], outer, inner, enc,
                                                        transcript(st["root"]),
                                                        digest=P.BLAKE3)))
        for name, fn in stages:
            with torch.profiler.profile(activities=acts) as prof:
                st[name], wall = time_host(torch, fn)
            if name == "commit":
                st["root"] = st[name].get_root()
            busy = sum(e.device_time_total for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            traced[name] = {"wall_ms": wall, "device_busy_ms": busy}
        if st["verify"] != want:
            raise AssertionError(f"path turn {route}: traced verify returned the wrong value")
        del st
        med = [statistics.median(t[i] for t in runs) for i in range(3)]
        turns.append({"route": route, "median_ms": med, "runs_ms": runs,
                      "reserved_gib_before": reserved, "traced": traced})
        log(f"  path turn {route}: median " + ", ".join(
            f"{k} {v:.2f}" for k, v in zip(names, med)) + " ms; traced wall / device busy "
            + ", ".join(f"{k} {traced[k]['wall_ms']:.2f} / {traced[k]['device_busy_ms']:.2f}"
                        for k in names) + f" ms; reserved before {reserved:.2f} GiB ({card})")
    for i, name in enumerate(names):
        mean = {r: statistics.mean(t["median_ms"][i] for t in turns if t["route"] == r)
                for r in ("ladder", "mxu")}
        busy = {r: statistics.mean(t["traced"][name]["device_busy_ms"] for t in turns
                                   if t["route"] == r) for r in ("ladder", "mxu")}
        log(f"  path turns, {name}: mxu - ladder {mean['mxu'] - mean['ladder']:+.2f} ms wall "
            f"(medians' mean), {busy['mxu'] - busy['ladder']:+.2f} ms device busy (traced)")
    return turns


def mxu_path_phase(torch, P, counters, coeffs_mont, x_pt, want, card, lig, gen, hashing):
    """Phase 20 (c), (d): with MXU_NTT forced true, the Ligero 2^23 path
    (main_path: its root and proof bytes equal to phase 6's ladder route,
    verify's value, the tamper kinds; mxu_dft twice an encode, ntt_mont
    never), the path in turns by route (path_turns) and the 2^26 streaming
    commit (its root equal to the ladder route's; mxu_dft twice a row
    block).  Returns the records."""
    from lcpc_tpu_torch.encodings import ligero

    spec = P.FT255
    lenc = P.LigeroEncoding.new(spec, N_COEFFS, *LIGERO_RHO, device=DEV)
    n, npr = lenc.n_cols, lenc.n_per_row
    out = {}
    ligero.MXU_NTT = True
    try:
        if ligero.ntt_route(spec, n, npr) != "mxu":
            raise AssertionError("ntt_route: MXU_NTT = True did not pick mxu at 2^23")
        kernels = (ligero_kernels(n) - {"ntt_mont"}) | {"mxu_dft"} | hashing
        path = main_path(torch, P, counters, lenc, coeffs_mont, x_pt, want, card, "ligero mxu",
                         kernels, P.BLAKE3, TREE_LAUNCHES_PATH)
        check_map_launches(path[8], "ligero mxu", {"commit": (0, 0), "prove": (0, 0),
                                                   "verify": ligero_verify_maps(n)})
        encodes = 1 if verify_at_columns(n) else 2
        for stage in ("commit", "verify"):
            got = path[8][stage]["counters"]
            if stage == "verify" and encodes == 1:
                continue
            if got.get("mxu_dft") != 2 or got.get("ntt_mont"):
                raise AssertionError(f"ligero mxu {stage}: launches {got}, not mxu_dft 2 and "
                                     f"no ntt_mont")
        if path[0]["mxu_dft"] != 2 * encodes or path[0]["ntt_mont"]:
            raise AssertionError(f"ligero mxu: mxu_dft {path[0]['mxu_dft']} != 2 x {encodes} "
                                 f"encodes, or ntt_mont {path[0]['ntt_mont']}")
        if path[6] != lig[6] or path[7] != lig[7]:
            raise AssertionError("ligero mxu: root or proof bytes differ from the ladder route's")
        log(f"  ligero mxu 2^{N_COEFFS.bit_length() - 1}: root and {len(path[7])} proof bytes "
            f"equal to phase 6's ladder "
            f"route; mxu_dft {path[0]['mxu_dft']} launches ({encodes} encodes x 2), ntt_mont 0; "
            f"commit {path[3][0]:.1f} ms median (ladder {lig[3][0]:.1f}), verify "
            f"{path[3][2]:.1f} (ladder {lig[3][2]:.1f})")
        out["path"] = {"launches": path[0]["mxu_dft"], "cold": path[1], "warm": path[2],
                       "median": path[3], "ladder_median": lig[3], "peak_gib": path[4],
                       "stages": path[8]}
        del path
        torch.cuda.empty_cache()
        out["turns"] = path_turns(torch, P, ligero, lenc, coeffs_mont, x_pt, want, card)
        torch.cuda.empty_cache()
        senc = P.LigeroEncoding.new(spec, N_STREAM, *LIGERO_RHO, device=DEV)
        packed = random_packed_coeffs(torch, spec, N_STREAM, gen)
        roots, stream = {}, {}
        for route in ("ladder", "mxu"):  # the ladder's plan is phase 8's; mxu's made here
            ligero.MXU_NTT = route == "mxu"
            cs, ms, launches = counted(torch, counters,
                                       lambda: P.commit_streaming(packed, senc, spill="none"))
            roots[route] = cs.get_root()
            stream[route] = {"ms": ms, "launches": launches, "row_block": cs.row_block,
                             "n_rows": cs.n_rows}
            del cs
            stream[route]["warm_ms"] = median_ms(
                torch, lambda: P.commit_streaming(packed, senc, spill="none"))
        blocks = -(-stream["mxu"]["n_rows"] // stream["mxu"]["row_block"])
        ml = stream["mxu"]["launches"]
        if ml.get("mxu_dft") != 2 * blocks or ml.get("ntt_mont"):
            raise AssertionError(f"stream 2^26 mxu: launches {ml}, not mxu_dft 2 x {blocks}")
        if roots["mxu"] != roots["ladder"]:
            raise AssertionError("stream 2^26: the mxu route's root != the ladder route's")
        log(f"  stream 2^{N_STREAM.bit_length() - 1} (packed, no words kept): the mxu route's "
            f"root equal to the ladder's; {blocks} blocks, mxu_dft {ml['mxu_dft']}, ntt_mont 0; "
            f"commit_streaming {stream['mxu']['ms']:.1f} ms first (its plan built), "
            f"{stream['mxu']['warm_ms']:.1f} warm (ladder {stream['ladder']['ms']:.1f}, "
            f"{stream['ladder']['warm_ms']:.1f})")
        out["stream_2_26"] = stream
        del packed
    finally:
        ligero.MXU_NTT = False
    torch.cuda.empty_cache()
    return out


def mxu_row(mxo, mxp, mxu_ptxas):
    """The kernel table row of the four-step NTT (two launches a transform)."""
    rec = mxo["shapes"]["commit"]
    turns = rec["turns"]
    ms = [t["ms"] for t in turns if t["route"] == "mxu"]
    cold = [t["cold_ms"] for t in turns if t["route"] == "mxu"]
    r = min(MXU_PLAIN_ROWS)
    return {
        "name": "mxu_dft",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/mxu_ntt.cu",
        "replaces": ("lcpc_tpu/ops/mxu_ntt.py:401 (MxuNtt: _conv_digits :371, ReducePlan :91, "
                     "_matmul_toep :385, MxuNttPlan :180; XLA-fused, not Pallas)"),
        "launches": mxp["path"]["launches"],
        "max_abs_err": mxo["max_abs_err"],
        "ms": statistics.mean(ms),
        "plain_ms": mxo["plain_ms"][r],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": (f"one MxuNtt of the 2^23 ft255 rho=1/4 commit: {rec['r']} x {rec['k']} -> "
                  f"{rec['n']}, limbs and words, two launches; plain_ms at {r} rows "
                  f"(verify's), the 256-row plain not run"),
        "cold_ms": statistics.mean(cold),
        "turns": turns,
        "ladder_ms": statistics.mean(t["ms"] for t in turns if t["route"] == "ladder"),
        "bound_count": rec["bound_count"],
        "bound_parts_ms": {"ladder_count_ms": rec["ladder_bound_ms"],
                           "four_step_count_ms": rec["mxu_bound_ms"],
                           "four_step_bytes_ms": rec["bytes_ms"],
                           "four_step_u8_ms": rec["u8_ms"],
                           "four_step_wide_ms": rec["wide_ms"]},
        "steps_ms": mxo.get("steps_ms"),
        "verify_shape": mxo["shapes"]["verify"],
        "words_only": mxo["shapes"]["commit words"],
        "path_median_ms": mxp["path"]["median"],
        "ladder_path_median_ms": mxp["path"]["ladder_median"],
        "path_turns": mxp["turns"],
        "stream_2_26": mxp["stream_2_26"],
        "ptxas": mxu_ptxas,
    }


def vc_rows(vcore, lig, sdig, big, s29, shas, hashes, vc_ptxas):
    """The kernel table rows of verify_core.cu's two kernels, each timed at
    the Ligero 2^23 shapes, the other paths' shapes and launches beside;
    the walks in their verifier form (root compared in the kernel) as
    phase 16 timed them, beside their output form (phases 7, 13)."""
    main = vcore[VC_SHAPES[0][0]]

    def ptx(name):
        return {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                for k, v in sorted(vc_ptxas.items()) if name in k}

    def launches(name):
        return {"sdig_2_23": sdig[0][name], "ligero_2_28": big["launches"][name],
                "seeded_2_29": s29["launches"][name]}

    common = {"route": "cuda", "source": "lcpc_tpu_torch/csrc/verify_core.cu",
              "max_abs_err": 0, "equal_to_plain": True, "tolerance": 0}
    walks = {tag: {d: rec[f"walk_{d}_ms"] for d in ("blake3", "sha256")}
             for tag, rec in vcore.items() if "walk_blake3_ms" in rec}
    return [{
        "name": "verify_check", **common,
        "replaces": ("lcpc_tpu/core/protocol.py:807 (_verify_core_fn), :767 "
                     "(_verify_core_cols_fn), :730 (_eval_dot_fn); XLA-fused, not Pallas"),
        "launches": lig[0]["verify_check"], "ms": main["check_ms"],
        "cold_ms": main["check_cold_ms"],
        "plain_ms": main["check_plain_ms"], "bound_ms": main["check_bound_ms"],
        "bound_by": main["check_bound_by"], "library_ms": None,
        "shape": (f"the ligero 2^23 verify: T 2 x {main['rows']} rows x {main['columns']} "
                  f"opened columns, the evaluation over {main['npr']}"),
        "launches_paths": launches("verify_check"),
        "other_shapes": {tag: {k: v for k, v in rec.items() if k.startswith("check")}
                         for tag, rec in vcore.items() if "check_ms" in rec},
        "walks_verifier_form_ms": walks,
        "walks_output_form_ms": {"blake3": {f"{k} x {lv}": hashes[f"walk {k}"]["ms"]
                                            for k, lv in WALKS},
                                 "sha256": {f"{k} x {lv}": shas[f"walk {k}"]["ms"]
                                            for k, lv in WALKS}},
        "ptxas": ptx("verify_check_kernel"),
    }, {
        "name": "gather_open", **common,
        "replaces": ("lcpc_tpu/core/protocol.py:547 (_gather_open), :538 (_gather_packed), "
                     "lcpc_tpu/core/streaming.py:332 (_gather_canon_fn); XLA-fused, not Pallas"),
        "launches": lig[0]["gather_open"], "ms": main["gather"]["ms"],
        "cold_ms": main["gather"]["cold_ms"], "floor_ms": main["gather"]["floor_ms"],
        "plain_ms": main["gather"]["plain_ms"], "bound_ms": main["gather"]["bound_ms"],
        "bound_by": "bytes", "library_ms": main["gather"]["library_ms"],
        "library_cold_ms": main["gather"]["library_cold_ms"],
        "library_call": "torch.index_select of the opened columns alone",
        "shape": (f"the ligero 2^23 prove's opening: {main['columns']} columns of "
                  f"{main['rows']} rows out of the codeword's limbs, "
                  f"{main['gather']['path_nodes']} path nodes"),
        "launches_paths": launches("gather_open"),
        "other_shapes": {tag: rec["gather"] for tag, rec in vcore.items()
                         if rec.get("gather") is not None},
        "probe_floors": vcore["probe"],
        "fields_held": sorted({rec["field"] for rec in vcore.values() if "field" in rec}),
        "ptxas": ptx("gather_open_kernel"),
    }]


def sha_rows(shas, paths, sha_ptxas, sha_mix):
    """The kernel table rows of the SHA-256 kernels, each timed at path (a)'s
    shape (the Ligero 2^23 commit's columns and tree, its verify's opened
    columns and walk), with its launches on each path, the other shapes, the
    host wall, the dependency floor and ptxas's report beside.  sha256_cols
    is two kernels, a row each: the wide one (the commits, the streaming
    updates) and the few-column one (verify's opened columns)."""
    c23, w189 = shas["2^23 commit"], shas[f"walk {WALKS[0][0]}"]
    m17 = shas[f"merkle {MERKLE_TREES[0][0]}"]
    big = paths["ligero_2_28"]
    k = B3_OPENED

    def ptx(*names):
        return {n: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                for n, v in sorted(sha_ptxas.items()) if any(k in n for k in names)}

    def row(name, replaces, rec, shape, kernel, counter=None, **extra):
        counter = counter or name
        return {"name": name, "route": "cuda", "source": "lcpc_tpu_torch/csrc/sha256_cols.cu",
                "replaces": replaces, "launches": paths["ligero_2_23"]["launches"][counter],
                "max_abs_err": shas["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None, "equal_to_plain": True,
                "tolerance": 0, "shape": shape,
                "launches_paths": {tag: paths[tag]["launches"][counter]
                                   for tag in ("ligero_2_23", "sdig_2_23", "ligero_2_28")},
                "ptxas": ptx(*kernel),
                "sass_compression_alu_fma_all": sha_mix["compress_alu_fma_all"],
                "sass_parent_alu_fma_all": sha_mix["parent_alu_fma_all"], **extra}

    cols_replaces = ("lcpc_tpu/ops/sha256_jax.py:53,90 (_compress, hash_word_columns) and "
                     "lcpc_tpu/core/streaming.py:408,428,448 (_sha_update_fn, _sha_finalize_fn, "
                     "StreamingSha256Hasher); XLA-fused, not Pallas")
    opened = {"ms": c23[f"ms_{k}_columns_few"], "plain_ms": c23[f"plain_ms_{k}_columns"],
              "bound_ms": c23[f"bound_ms_{k}_columns"], "bound_by": c23[f"bound_by_{k}_columns"]}
    return [
        row("sha256_cols", cols_replaces, c23,
            f"path (a)'s commit columns: {c23['n_cols']} x {c23['n_words']} words, "
            f"{c23['compressions_a_column']} compressions each, one launch (the wide kernel)",
            ("sha256_cols_kernel",), counter="sha256_cols_wide",
            other_shapes={n: shas[n] for n in ("2^28 column length", "brakedown 2^23 commit")},
            ms_2_28_commit=big["cols_ms"], bound_ms_2_28_commit=big["cols_bound_ms"],
            ms_2_28_block_update=big["update_ms"],
            bound_ms_2_28_block_update=big["update_bound_ms"],
            compression_latency_ms=shas["compression_latency_ms"],
            sass_block_loop_alu_fma_all=sha_mix["cols_loop_alu_fma_all"]),
        row("sha256_cols_few", cols_replaces, opened,
                 f"path (a)'s verify columns: {k} x {c23['n_words']} words, "
                 f"{c23['compressions_a_column']} compressions each, one launch (the "
                 f"few-column kernel; routed to it up to FEW_COLS_MAX columns)",
                 ("sha256_few_kernel",),
                 opened_2_28={
                     f"{n}{r}": shas["2^28 column length"][f"{n}_{k}_columns{r}"]
                     for n, r in (("ms", "_few"), ("ms", "_wide"), ("bound_ms", ""),
                                  ("floor_ms", ""), ("critical_path_ms", ""), ("issue_ms", ""))},
                 opened_brakedown={
                     f"{n}{r}": shas["brakedown 2^23 commit"][f"{n}_6593_columns{r}"]
                     for n, r in (("ms", "_few"), ("ms", "_wide"), ("ms", ""), ("route", ""),
                                  ("bound_ms", ""), ("floor_ms", ""), ("plain_ms", ""),
                                  ("critical_path_ms", ""), ("issue_ms", ""))},
                 wide_kernel_ms=c23[f"ms_{k}_columns_wide"],
                 floor_ms=c23[f"floor_ms_{k}_columns"],
                 critical_path_ms=c23[f"critical_path_ms_{k}_columns"],
                 issue_ms=c23[f"issue_ms_{k}_columns"],
                 op_latency_cycles_ns=shas["op_latency_cycles_ns"],
                 sass_round_loop_alu_fma_all=sha_mix["few_rounds_alu_fma_all"]),
        row("sha256_merkle_tree",
            "lcpc_tpu/ops/sha256_jax.py:127,144 (merkle_parent, merkle_layer) over the layer "
            "loops of lcpc_tpu/core/protocol.py:326-333, :376-383 and core/streaming.py:719-725; "
            "XLA-fused, not Pallas", m17, "path (a)'s tree: 2^17 leaves",
            ("merkle_tree_kernel",),
            host_ms=m17["host_ms"], floor_ms=m17["floor_ms"],
            critical_path_ms=m17["critical_path_ms"],
            other_shapes={n: v for n, v in shas.items() if n.startswith("merkle ")},
            parent_latency_ms=shas["tree_parent_latency_ms"]),
        row("sha256_merkle_walk",
            "lcpc_tpu/core/protocol.py:787-793 (_verify_core_fn's parent loop); XLA-fused, "
            "not Pallas", w189, "path (a)'s verify walk: 189 columns x 17 levels",
            ("sha256_walk_kernel",), host_ms=w189["host_ms"], floor_ms=w189["floor_ms"],
            critical_path_ms=w189["critical_path_ms"], issue_ms=w189["issue_ms"],
            brakedown_2_23=shas[f"walk {WALKS[1][0]}"],
            parent_latency_ms=shas["parent_latency_ms"],
            note="a round warp fed W + K by a schedule warp, 32 columns a block"),
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
SHARD_PROVE = {"mont_dot", "gather_open"}  # the collapse; the opened columns (one launch)
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


def kernel_counters(b3, md, mm, nttm, sha, spmv, tf, vc):
    """Every kernel wrapper of the port by its counter's name."""
    from lcpc_tpu_torch.ops import commit_small as cs
    from lcpc_tpu_torch.ops import mxu_ntt as mx

    return {"spmv_mont": spmv.spmv_mont, "ntt_mont": nttm.ntt_forward,
            "blake3_chunks": b3.blake3_chunks, "chunk_tree": b3.merge_chunk_cvs,
            **{f"blake3_cols_{k}": v for k, v in b3.COLS_KERNELS.items()},
            "merkle_tree": b3.merkle_tree, "merkle_walk": b3.merkle_walk,
            "seeded_gen": tf.seeded_digits, "mont_dot": md.mont_dot,
            **{f"mont_dot_{k}": v for k, v in md.KERNELS.items()},
            "power_table": md.power_table, "mont_mul_map": mm.mont_mul_map,
            "mont_mul_map_vec": mm.VECTOR, "mont_addsub_map": mm.mont_addsub_map,
            "sha256_cols": sha.sha256_cols,
            **{f"sha256_cols_{k}": v for k, v in sha.COLS_KERNELS.items()},
            "sha256_merkle_tree": sha.merkle_tree, "sha256_merkle_walk": sha.merkle_walk,
            "verify_check": vc.verify_check, "gather_open": vc.gather_open,
            "intt_inverse": nttm.intt_inverse, "commit_small": cs.commit_small,
            "mxu_dft": mx.mxu_dft}


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
    check_verify_core(v_l, f"{tag} verify", digest)
    check_verify_maps(v_l, f"{tag} verify", ligero_verify_maps(enc.n_cols)
                      if isinstance(enc, P.LigeroEncoding) else SDIG_VERIFY_MAPS)
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
    from lcpc_tpu_torch.ops import verify_core as vc
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.parallel import mesh_protocol as mp, multihost
    from lcpc_tpu_torch.parallel.comm import Comm

    rank, port, x_pt = int(rank), int(port), int(x_pt)
    multihost.initialize(f"tcp://localhost:{port}", RANK_WORLD, rank, device=f"{DEV}:0",
                         backend=RANK_BACKEND)
    counters = kernel_counters(b3, md, mm, nttm, sha, spmv, tf, vc)
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
    from lcpc_tpu_torch.ops import verify_core as vc
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.utils import cuda_build, native

    if "jax" in sys.modules or "lcpc_tpu" in sys.modules:
        raise RuntimeError("the port pulled in JAX or the JAX package")
    if hasattr(b3, "blake3_parents"):
        raise AssertionError("the per-level blake3_parents kernel is still in the port")
    counters = kernel_counters(b3, md, mm, nttm, sha, spmv, tf, vc)
    hashing = {"blake3_chunks", *TREES, "blake3_cols_few"}  # the in-memory paths' hashing

    # 1. the card
    card = kb.card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build the eleven kernel sources, one nvcc each, at once
    phase = Phase("2 build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:  # the probes beside the kernels
        chain_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR)
        probe_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                              kb.GATHER_PROBE_SRC)
        tf_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                           kb.TF_CHAIN_SRC)
        sha_f = pool.submit(kb.build_chain, cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR,
                            kb.SHA_CHAIN_SRC)
        secs = cuda_build.build_all(["spmv_mont", "ntt_mont", "blake3_cols", "seeded_gen",
                                     "mont_dot", "power_table", "mont_map", "sha256_cols",
                                     "verify_core", "commit_small", "mxu_ntt"], force=True)
        chain_so, chain_log = chain_f.result()
        tf_so, _ = tf_f.result()
        sha_so, sha_chain_log = sha_f.result()
        probe_so, _ = probe_f.result()
    log(f"build: {', '.join(f'{n}.cu {s:.2f} s' for n, s in secs.items())} and "
        f"scripts/blake3_chain.cu, scripts/threefry_chain.cu, scripts/sha256_chain.cu, "
        f"scripts/gather_probe.cu "
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
    words_ptxas = kb.ptxas_report(cuda_build.build_logs["ntt_mont"], "ntt_words_pass_kernel")
    if sorted(words_ptxas) != [2, 4, 6, 8] or words_ptxas[8][1:] != (0, 0):
        raise AssertionError(f"ntt_words_pass_kernel (the words-in first pass) not reported or "
                             f"W32=8 spills: {words_ptxas}")
    for w32, (regs, st, ld) in sorted(words_ptxas.items()):
        log(f"  ptxas ntt_words_pass_kernel W32={w32}: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
    b3_ptxas = {k: v for name in B3_KERNELS
                for k, v in kb.ptxas_entries(cuda_build.build_logs["blake3_cols"],
                                             name).items()}
    # chunks 2 output types, the chunk tree 2 x 2 input types, the few-column kernel, 2
    if len(b3_ptxas) != 9:
        raise AssertionError(f"blake3 kernels not reported by ptxas: {b3_ptxas}")
    for name, (regs, st, ld) in sorted(b3_ptxas.items()):
        log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    walk_stack = kb.ptxas_stack(cuda_build.build_logs["blake3_cols"], B3_WALK)
    walk_spill = [v[1:] for k, v in b3_ptxas.items() if B3_WALK in k]
    if list(walk_stack.values()) != [0] or walk_spill != [(0, 0)]:
        raise AssertionError(f"the walk kernel uses local memory: stack {walk_stack}, spills "
                             f"{walk_spill}")
    log(f"  ptxas {B3_WALK}: 0 bytes stack frame, no spill")
    for probe in ("compress_chain_kernel", "quad_chain_kernel"):
        for name, (regs, st, ld) in kb.ptxas_entries(chain_log, probe).items():
            log(f"  ptxas {name} (the latency probe): {regs} registers, {st} bytes spill "
                f"stores, {ld} bytes spill loads")
    b3_mix = blake3_mix(kb, chain_so, cuda_build.so_path("blake3_cols"))
    sha_ptxas = {k: v for name in ("sha256_cols_kernel", "sha256_few_kernel", "merkle_tree_kernel",
                                   "sha256_walk_kernel")
                 for k, v in kb.ptxas_entries(cuda_build.build_logs["sha256_cols"], name).items()}
    # the column hash's two kernels, 2 word types x 2 modes each, the tree, the walk
    if len(sha_ptxas) != 10:
        raise AssertionError(f"sha256 kernels not reported by ptxas: {sha_ptxas}")
    for name, (regs, st, ld) in sorted(sha_ptxas.items()):
        log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
        if st or ld:
            raise AssertionError(f"{name} spills: {st} / {ld} bytes")
    for name, (regs, st, ld) in kb.ptxas_entries(sha_chain_log, "chain_kernel").items():
        log(f"  ptxas {name} (the latency probe): {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    sha_mix = sha256_mix(kb, sha_so, cuda_build.so_path("sha256_cols"))
    vc_ptxas = {k: v for name in ("verify_check_kernel", "gather_open_kernel")
                for k, v in kb.ptxas_entries(cuda_build.build_logs["verify_core"], name).items()}
    if len(vc_ptxas) != 8:  # both kernels at W32 = 2, 4, 6, 8
        raise AssertionError(f"verify_core kernels not reported by ptxas: {vc_ptxas}")
    for name, (regs, st, ld) in sorted(vc_ptxas.items()):
        log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
        if "ILi8E" in name and (st or ld):
            raise AssertionError(f"{name} spills: {st} / {ld} bytes")
    cs_ptxas = commit_ptxas(kb, cuda_build.build_logs["commit_small"])
    if len(cs_ptxas[0]) != 16:  # 2 encodings x 2 digests x W32 = 2, 4, 6, 8
        raise AssertionError(f"commit_small kernels not reported by ptxas: {cs_ptxas[0]}")
    for name, (regs, st, ld) in sorted(cs_ptxas[0].items()):
        log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    for name, (regs, st, ld) in sorted(cs_ptxas[1].items()):
        log(f"  ptxas {name} (a noinline phase of commit_small): {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    prove_ptxas = {}
    for src_name, kname in (("seeded_gen", "seeded_gen_kernel"), ("mont_dot", "mont_dot_"),
                            ("power_table", "power_"), ("mont_map", "map_kernel")):
        found = kb.ptxas_entries(cuda_build.build_logs[src_name], kname)
        n_want = {"seeded_gen": 12, "mont_dot": 20, "power_table": 4, "mont_map": 28}[src_name]
        if len(found) != n_want:
            raise AssertionError(f"{src_name} kernels not reported by ptxas: {found}")
        for name, (regs, st, ld) in sorted(found.items()):
            log(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill "
                f"loads")
        prove_ptxas[src_name] = found
    vec_ptxas = {k: v for k, v in prove_ptxas["mont_map"].items() if WHOLE_MODE in k}
    if len(vec_ptxas) != 8:  # W32 = 2, 4, 6, 8 x mul, from_mont
        raise AssertionError(f"mont_mul_map_kernel's element-contiguous mode not reported by "
                             f"ptxas: {vec_ptxas}")
    for name, (regs, st, ld) in sorted(vec_ptxas.items()):
        if "ILi8E" in name and (st or ld):
            raise AssertionError(f"{name} spills: {st} / {ld} bytes")
    inv_ptxas = kb.ptxas_report(cuda_build.build_logs["ntt_mont"], "ntt_inverse_pass_kernel")
    if sorted(inv_ptxas) != [2, 4, 6, 8] or inv_ptxas[8][1:] != (0, 0):
        raise AssertionError(f"ntt_inverse_pass_kernel not reported or W32=8 spills: "
                             f"{inv_ptxas}")
    for w32, (regs, st, ld) in sorted(inv_ptxas.items()):
        log(f"  ptxas ntt_inverse_pass_kernel W32={w32}: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
    for src_name, kname in (("seeded_gen", "seeded_gen_kernelILi8ELi37E"),
                            ("mont_dot", "mont_dot_tc_kernel"),  # every W
                            ("mont_dot", "mont_dot_thin_tc_kernel"),  # every W and y form
                            ("power_table", "power_planes_kernelILi8E"),
                            ("mont_map", "mont_mul_map_kernelILi8E"),  # both ops at W32 = 8
                            ("mont_map", "mont_addsub_map_kernelILi8E")):  # all three
        for k, (regs, st, ld) in prove_ptxas[src_name].items():
            if kname in k and (st or ld):
                raise AssertionError(f"{k} spills: {st} / {ld} bytes")
    mxu_ptxas = {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                 for k, v in kb.ptxas_entries(cuda_build.build_logs["mxu_ntt"],
                                              "mxu_dft_kernel").items()}
    if len(mxu_ptxas) != 8:  # W32 = 2, 4, 6, 8 x the two steps
        raise AssertionError(f"mxu_dft_kernel not reported by ptxas: {mxu_ptxas}")
    for name, v in sorted(mxu_ptxas.items()):
        log(f"  ptxas {name}: {v['registers']} registers, {v['spill_bytes']} bytes spilled")
        if "ILi8E" in name and v["spill_bytes"]:
            raise AssertionError(f"{name} spills: {v['spill_bytes']} bytes")
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
    # words, strided), one in verify (the proof rows into the level buffer,
    # by the element-contiguous mode: SDIG_VERIFY_MAPS)
    sdig = main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, "sdig",
                     SDIG_KERNELS | hashing, P.BLAKE3, TREE_LAUNCHES_PATH)
    check_map_launches(sdig[8], "sdig", {"commit": (1, 0), "prove": (0, 0),
                                         "verify": SDIG_VERIFY_MAPS})
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
    ntt_words = ntt_words_in(torch, kb, P, nttm, lenc, gen)
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
    # verify's proof rows are converted by the NTT's first pass as it loads
    # them on the encode route (no mont_mul_map, PR 20), by one mont_mul_map
    # launch on the opened columns' route (verify_check converts the rest)
    cols_route = verify_at_columns(lenc.n_cols)
    lig = main_path(torch, P, counters, lenc, coeffs_mont, x_pt, want, card, "ligero",
                    ligero_kernels(lenc.n_cols) | hashing, P.BLAKE3, TREE_LAUNCHES_PATH)
    check_map_launches(lig[8], "ligero", {"commit": (0, 0), "prove": (0, 0),
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
        shas = sha256_phase(torch, kb, sha, gen, sha_so, cuda_build.so_path("sha256_cols"),
                            sha_mix)
        torch.cuda.empty_cache()

    # 14. the slice's paths with SHA-256: Ligero and Brakedown 2^23, Ligero
    # 2^28 streaming
    coeffs_mont = coeffs_host.cuda()
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

    # 16. the verifier's core and the prover's opening against their plain
    # versions at the paths' shapes
    with Phase("16 verify core"):
        vcore = verify_core_phase(torch, kb, P, vc, gen, probe_so)
        torch.cuda.empty_cache()

    # 17. commit -> prove -> verify in ft63, ft127 and ft191 against the CPU path
    with Phase("17 every field end to end"):
        fields = every_field_phase(torch, P, counters)
        torch.cuda.empty_cache()

    # 18. the small commits: the kernel against the staged route and its plain version
    with Phase("18 small commits"):
        small = small_commit_phase(torch, kb, P, counters, gen, cs_ptxas)
        torch.cuda.empty_cache()

    # 19. the inverse NTT against its plain version, and the FFT identity
    with Phase("19 inverse ntt"):
        inv = intt_phase(torch, kb, P, nttm, counters, gen)
        torch.cuda.empty_cache()

    # 20. the four-step NTT on the tensor cores, and the Ligero paths through it
    with Phase("20 mxu ntt"):
        coeffs_mont = coeffs_host.cuda()
        del coeffs_host
        mxo = mxu_kernel_phase(torch, kb, P, nttm, card, gen)
        mxp = mxu_path_phase(torch, P, counters, coeffs_mont, x_pt, want, card, lig, gen, hashing)
        del coeffs_mont
        torch.cuda.empty_cache()

    # 21. kernel table
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
        "verify_rows_words_in": ntt_words,
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
        "verify_columns_ms_bound_floor": {
            tag: [hashes[tag]["k1_ms"], hashes[tag]["k1_bound_ms"], hashes[tag]["k1_floor_ms"]]
            for tag in ("2^23 verify (189 columns)", "2^28 verify (189 columns)",
                        "brakedown 2^23 verify (6,593 columns)")},
        "ptxas": {k: {"registers": v[0], "spill_bytes": v[1] + v[2]}
                  for k, v in sorted(b3_ptxas.items()) if "chunks" in k},
        "sass_compression_alu_fma_all": b3_mix["per_compression_alu_fma_all"][
            b3_mix["least"]][:3],
    }, few_row(hashes, big, sdig, lig, s29, b3_ptxas, b3_mix),
        *tree_rows(hashes, big, sdig, lig, b3_ptxas, size, b3_mix),
        *prove_rows(prv, s29, big, sdig, lig, prove_ptxas, gen_mix),
        *map_rows(maps, s29, big, sdig, lig, prove_ptxas, shard),
        *sha_rows(shas, sha_paths, sha_ptxas, sha_mix),
        *vc_rows(vcore, lig, sdig, big, s29, shas, hashes, vc_ptxas),
        *small_rows(small, inv), mxu_row(mxo, mxp, mxu_ptxas)]
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
                   "sharded": shard, "verify_core": vcore, "every_field": fields,
                   "small_commits": small, "intt": inv,
                   "mxu_ntt": {**mxo, **mxp},
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
