#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lcpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from the checkout, one nvcc each, started
     together (csrc/spmv_mont.cu, csrc/ntt_mont.cu); print ptxas's registers
     and spills per template (fatal if either kernel's W32 = 8 spills) and
     the SASS instruction count of the SpMV's W32 = 8 k loop per wide product
     (cuobjdump);
  3. hold the SpMV kernel against its plain PyTorch version
     (apply_mat_plain), bit for bit, on every level of the 2^23 ft255
     Brakedown encoding at r = 36 (the commit's row count), on every level at
     r = 2 (verify's), and on ragged edge levels (an empty row, a row of K =
     96 all p-1 over inputs all p-1, mixed lengths) in each of the four
     fields (every W32 template) at every lane split; time both against the
     bound of each level's nonzeros;
  4. drive the Brakedown path at 2^23 ft255 CODE3 BLAKE3 through the public
     entry points: commit -> prove -> verify once cold (kernel launches
     counted) and 3 times warm (median ms); check the evaluation against the
     host polynomial and that tampered proofs fail with the reference's
     kinds; reproduce its golden fixture (tests/data/torch_golden_sdig.json);
  5. hold the NTT kernel's two outputs against its plain PyTorch version
     (ntt_forward_plain, then from_mont and the hash-word pack), limb for
     limb and word for word, at the 2^23 Ligero commit shape (ft255, R = 256
     rows of 32,768 padded to n = 2^17, limbs and words), at the verify shape
     (R = 2, limbs) and on edge cases in each of the four fields (n = 2, 4,
     C/2, C, 2C, 2^12, 2^18 and a 2^12 plan forced to 3 passes, with rows all
     zero, all p-1, a delta and random); time each whole call (every pass)
     and the plain version against the bound of the non-trivial butterflies,
     the hash words' reductions and the bytes;
  6. drive the Ligero path at 2^23 ft255 rho = 1/4 BLAKE3 the same way as
     phase 4 (one cold run with the launches counted, 3 warm), with the
     evaluation and tamper checks; reproduce its golden fixture
     (tests/data/torch_golden_ligero.json) under BLAKE3 and SHA-256;
  7. print the kernel table line, then the result line.

Imports nothing of JAX or of the JAX package; the measurement helpers
(card line, device timing, ptxas and SASS reports) are scripts/kernel_bench.py.
Exits non-zero, without the result line, when no CUDA device is present or
the package is missing.
"""

from __future__ import annotations

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
ROOT = os.path.dirname(os.path.abspath(__file__))


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
    """The plain version of ntt_forward(plan, x, canon_words=words)."""
    from lcpc_tpu_torch.ops.limbs import pack_row_words

    y = nttm.ntt_forward_plain(plan, x)
    return (y, pack_row_words(plan.ops.from_mont(y))) if words else y


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
    got = nttm.ntt_forward(plan, x, canon_words=words)
    want, plain_ms = time_host(torch, lambda: plain_ntt(nttm, plan, x, words))
    ok, err = equal_outputs(torch, got, want)
    if not ok:
        raise AssertionError(f"ntt {tag}: kernel != plain (max err {err})")
    del got, want
    ms = kb.time_kernel(lambda: nttm.ntt_forward(plan, x, canon_words=words))
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
            y = nttm.ntt_forward(plan, xs, canon_words=True)
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


def drive(torch, P, enc, coeffs_mont, outer, inner):
    """commit -> prove -> verify through the public entry points; returns
    (comm, proof, value, (commit, prove, verify) ms, the transcript maker)."""
    def transcript(root):
        tr = P.Transcript(b"chip smoke")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr

    comm, c_ms = time_host(torch, lambda: P.commit(coeffs_mont, enc))
    root = comm.get_root()
    proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
    value, v_ms = time_host(
        torch, lambda: proof.verify(root, outer, inner, enc, transcript(root)))
    return comm, proof, value, (c_ms, p_ms, v_ms), transcript


def main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, tag, path_kernels):
    """The main path of one encoding at 2^23: once cold with every launch
    count set to 0 just before and read just after (the kernels in
    `path_kernels` must have launched, the others not), then REPS warm runs.
    Checks the evaluation and the tamper kinds; returns (launches, cold ms,
    warm ms, median ms, peak GiB, proof bytes)."""
    spec = enc.spec
    n_rows = -(-N_COEFFS // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    comm, proof, value, cold, transcript = drive(torch, P, enc, coeffs_mont, outer, inner)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"{tag} main path cold: commit {cold[0]:.1f} ms, prove {cold[1]:.1f} ms, "
        f"verify {cold[2]:.1f} ms; launches {launches}")
    for name, n in launches.items():
        if (n > 0) != (name in path_kernels):
            raise AssertionError(f"{tag}: {name} launched {n} times")
    if value != want:
        raise AssertionError(f"{tag}: verify returned the wrong evaluation")
    log(f"  verify returned univariate_eval of the {N_COEFFS} coefficients: ok")
    root = comm.get_root()
    data = P.wire.serialize_proof(spec, proof)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  n_rows {comm.n_rows}, n_per_row {comm.n_per_row}, n_cols {comm.n_cols}, "
        f"proof {len(data)} bytes, peak device memory {peak:.2f} GiB")
    for what, kind_want in (("column", "ColumnDegree"), ("path", "ColumnPath")):
        bad = P.wire.deserialize_proof(spec, data)
        if what == "column":
            bad.columns[0].col_mont[0, 0] ^= 1
        else:
            bad.columns[5].path[2] = bytes(32)
        try:
            bad.verify(root, outer, inner, enc, transcript(root))
        except P.VerifierError as e:
            if e.kind != kind_want:
                raise AssertionError(f"tampered {what}: {e.kind} != {kind_want}")
            log(f"  tampered {what}: VerifierError({e.kind!r})")
        else:
            raise AssertionError(f"tampered {what} verified")
    del comm, proof, bad
    warm = [drive(torch, P, enc, coeffs_mont, outer, inner)[3] for _ in range(REPS)]
    med = [statistics.median(t[i] for t in warm) for i in range(3)]
    size = f"2^{N_COEFFS.bit_length() - 1}"
    for i, name in enumerate(("commit", "prove", "verify")):
        log(f"{tag}_{name}_ms_median_{size}_ft255: {med[i]:.1f} "
            f"(warm runs {[round(t[i], 1) for t in warm]}; {card})")
    return launches, cold, warm, med, peak, len(data)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import kernel_bench as kb
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.ops import ntt as nttm
    from lcpc_tpu_torch.ops import spmv
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.utils import cuda_build, native

    if "jax" in sys.modules or "lcpc_tpu" in sys.modules:
        raise RuntimeError("the port pulled in JAX or the JAX package")
    counters = {"spmv_mont": spmv.spmv_mont, "ntt_mont": nttm.ntt_forward}

    # 1. the card
    card = kb.card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build both kernels, one nvcc each, at once
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["spmv_mont", "ntt_mont"], force=True)
    log(f"build: {', '.join(f'{n}.cu {s:.2f} s' for n, s in secs.items())} "
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
    loop = kb.sass_loop(spmv.SO_PATH)
    if loop is None:
        log("  SASS: cuobjdump not found, k-loop count not measured")
    else:
        log(f"  SASS W32=8 k loop (64 wide products a nonzero): {loop[0]} "
            f"instructions, {loop[2]:.3f} per wide product; opcodes {loop[1]}")
    if native.get_lib() is None:
        raise RuntimeError("native C library did not build (needed for matgen)")

    spec = P.FT255
    ops = get_ops(spec)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    size = f"2^{N_COEFFS.bit_length() - 1}"

    # the 2^23 coefficients both main paths commit to, and their evaluation
    top = spec.p >> (16 * (spec.w16 - 1))
    canon = torch.randint(0, 1 << 16, (spec.w16, N_COEFFS), generator=gen,
                          device="cuda", dtype=torch.int32)
    canon[-1] = torch.randint(0, top, (N_COEFFS,), generator=gen, device="cuda",
                              dtype=torch.int32)
    coeffs_mont = ops.to_mont(canon)
    raw = canon.cpu().numpy().astype("<u2").T.copy().tobytes()
    coeffs = [int.from_bytes(raw[32 * i : 32 * i + 32], "little")
              for i in range(N_COEFFS)]
    del raw, canon
    x_pt = (coeffs[0] * 0x9E3779B97F4A7C15 + 12345) % spec.p
    want = P.univariate_eval(spec, coeffs, x_pt)
    del coeffs

    # 3. SpMV kernel vs plain on the 2^23 levels
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

    # 4. the Brakedown path at 2^23 and its golden fixture
    n_levels = len(pre) + len(post) + 1
    sdig = main_path(torch, P, counters, enc, coeffs_mont, x_pt, want, card, "sdig",
                     path_kernels={"spmv_mont"})
    if sdig[0]["spmv_mont"] != 2 * n_levels:
        raise AssertionError(f"spmv launches {sdig[0]['spmv_mont']} != 2 encodes x "
                             f"{n_levels} levels")
    log(f"  spmv_mont launches {sdig[0]['spmv_mont']} (= 2 encodes x {n_levels} levels)")
    del enc, pre, post, rs, levels
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

    # 5. NTT kernel vs plain at the Ligero shapes and on edge cases
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
    for field in P.ALL_FIELDS:  # every template, W32 = 2, 4, 6, 8
        ntt_edges(torch, kb, nttm, field, gen)
    torch.cuda.empty_cache()

    # 6. the Ligero path at 2^23 and its golden fixture under both digests
    lig = main_path(torch, P, counters, lenc, coeffs_mont, x_pt, want, card, "ligero",
                    path_kernels={"ntt_mont"})
    per_encode = plan.launches_per_call
    if lig[0]["ntt_mont"] != 2 * per_encode:
        raise AssertionError(f"ntt launches {lig[0]['ntt_mont']} != 2 encodes x "
                             f"{per_encode}")
    log(f"  ntt launches {lig[0]['ntt_mont']} (= 2 encodes x {per_encode} passes)")
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

    # 7. kernel table
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
    }]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_levels.json"), "w") as f:
        json.dump({"card": card, "levels": rows, "ntt": ntt_rows,
                   "sass_k_loop": loop and loop[:3],
                   "main_path_ms": {
                       name: {"cold": r[1], "warm": r[2], "median": r[3],
                              "peak_gib": r[4], "proof_bytes": r[5]}
                       for name, r in (("sdig", sdig), ("ligero", lig))}}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # every phase is fatal: report and exit non-zero
        traceback.print_exc()
        sys.exit(1)
