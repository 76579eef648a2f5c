#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lcpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernel (csrc/spmv_mont.cu) from the checkout with nvcc;
  3. hold the kernel against its plain PyTorch version (apply_mat_plain), bit
     for bit, on every level of the 2^23 ft255 Brakedown encoding at r = 36
     (the commit's row count), on every level at r = 2 (verify's), and on an
     edge case (every value p-1, K = 96, zero pad slots); time both;
  4. drive the main path at 2^23 ft255 CODE3 BLAKE3 through the public entry
     points: commit -> prove -> verify once cold (kernel launches counted)
     and 3 times warm (median ms); check the evaluation against the host
     polynomial and that tampered proofs fail with the reference's kinds;
  5. reproduce the golden fixture (tests/data/torch_golden_sdig.json) on the
     GPU;
  6. print the kernel table line, then the result line.

Imports nothing of JAX or of the JAX package.  Exits non-zero, without the
result line, when no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

N_COEFFS = 1 << 23
R_COMMIT = 36
SEED = 0
REPS = 3
# H100 SXM peaks (NVIDIA's data sheet, dense rates at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
# CUDA-core int32 multiply-add rate: half of the 67 TFLOP/s fp32 FMA lanes,
# 33.5 T ops/s counting a multiply-add as 2 ops -> 16.75e12 IMAD/s; a
# 32x32 -> 64-bit product takes two (low and high halves)
WIDE_PRODUCTS_PER_S = 16.75e12 / 2


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def level_cost(spec, k, n_in, n_out, r):
    """(bytes, wide products) the level must move / do: each input read
    once, the output written once; K*(W/2)^2 products per output."""
    w = spec.w16
    nbytes = 4 * (n_in * w * r + k * n_out + k * w * n_out + n_out * w * r)
    products = k * n_out * r * (w // 2) ** 2
    return nbytes, products


def bound_ms(nbytes, products):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products / WIDE_PRODUCTS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def random_mont(torch, spec, shape, gen, device):
    """Random field elements (< p) as int32 limbs of `shape` (W at dim 1)."""
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=device,
                      dtype=torch.int32)
    top = (spec.p >> (16 * (spec.w16 - 1)))
    x[:, -1] = torch.randint(0, top, (shape[0], *shape[2:]), generator=gen,
                             device=device, dtype=torch.int32)
    return x


def time_kernel(torch, fn, reps=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def compare_levels(torch, spmv, spec, levels, r, gen, tag, rows):
    """Kernel vs plain on each (name, dm) level at row count r."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0,
           "t_ops": 0.0, "err": 0}
    for name, dm in levels:
        x = random_mont(torch, spec, (dm.n_in, spec.w16, r), gen, "cuda")
        y = spmv.spmv_mont(spec, x, dm.cols, dm.vals)
        y_plain, plain_ms = time_host(
            torch, lambda: spmv.apply_mat_plain(spec, x, dm.cols, dm.vals))
        err = int((y.long() - y_plain.long()).abs().max().item()) if y.numel() else 0
        if err:
            raise AssertionError(f"{tag} {name}: kernel != plain (max err {err})")
        ms = time_kernel(torch, lambda: spmv.spmv_mont(spec, x, dm.cols, dm.vals))
        nbytes, products = level_cost(spec, dm.kmax, dm.n_in, dm.n_out, r)
        b, tb, to = bound_ms(nbytes, products)
        rows.append({"phase": tag, "level": name, "n_in": dm.n_in, "n_out": dm.n_out,
                     "K": dm.kmax, "r": r, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bytes": nbytes, "products": products})
        log(f"  {tag} {name:>6} n_in={dm.n_in:>7} n_out={dm.n_out:>6} K={dm.kmax:>3} "
            f"r={r:>2}: equal, kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
            f"bound {b:.4f} ms ({'bytes' if tb >= to else 'operations'})")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b),
                       ("t_bytes", tb), ("t_ops", to)):
            tot[key] += v
        tot["err"] = max(tot["err"], err)
    return tot


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.ops import spmv
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.utils import native
    from lcpc_tpu_torch.utils.tensors import seeded_values

    if "jax" in sys.modules or "lcpc_tpu" in sys.modules:
        raise RuntimeError("the port pulled in JAX or the JAX package")

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build
    build_s = spmv.build(force=True)
    log(f"build: spmv_mont.cu with nvcc {' '.join(spmv.NVCC_FLAGS)} in {build_s:.2f} s")
    for line in spmv.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.split(' : ')[-1].strip()}")
    if native.get_lib() is None:
        raise RuntimeError("native C library did not build (needed for matgen)")

    spec = P.FT255
    ops = get_ops(spec)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    # 3. kernel vs plain on the 2^23 levels
    t0 = time.perf_counter()
    enc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device="cuda")
    pre, post, rs = enc.device_mats()
    torch.cuda.synchronize()
    size = f"2^{N_COEFFS.bit_length() - 1}"
    log(f"encoding {size}: n_per_row {enc.n_per_row}, n_cols {enc.n_cols}, "
        f"{len(pre)} precode + {len(post)} postcode levels + RS, "
        f"matgen + device matrices {time.perf_counter() - t0:.2f} s")
    levels = ([(f"pre{i}", dm) for i, dm in enumerate(pre)] + [("rs", rs)]
              + [(f"post{i}", dm) for i, dm in enumerate(post)])
    log("kernel vs plain: tolerance 0 — exact field arithmetic, every limb equal")
    rows = []
    commit_tot = compare_levels(torch, spmv, spec, levels, R_COMMIT, gen, "r=36", rows)
    verify_tot = compare_levels(torch, spmv, spec, levels, 2, gen, "r=2", rows)
    # edge case: every value p-1, K = 96 (above the largest 2^23 kmax, 94),
    # two zero pad slots per output reading input 0
    k, n_in, n_out = 96, 1000, 4096
    pm1 = torch.from_numpy(ops.encode_host([spec.p - 1]).astype("int32")).cuda()[:, 0]
    vals = pm1[None, :, None].expand(k, spec.w16, n_out).contiguous()
    vals[-2:] = 0
    cols = torch.randint(0, n_in, (k, n_out), generator=gen, device="cuda",
                         dtype=torch.int32)
    cols[-2:] = 0
    x = pm1[None, :, None].expand(n_in, spec.w16, R_COMMIT).contiguous()
    y = spmv.spmv_mont(spec, x, cols, vals)
    y_plain = spmv.apply_mat_plain(spec, x, cols, vals)
    if not torch.equal(y, y_plain):
        raise AssertionError("edge case (all p-1, K=96): kernel != plain")
    log("  edge: all values p-1, K=96, zero pad slots, r=36: equal")

    # 4. main path at 2^23
    n_rows = -(-N_COEFFS // enc.n_per_row)
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
    outer, inner = P.univariate_tensors(spec, x_pt, enc.n_per_row, n_rows)

    def transcript(root):
        tr = P.Transcript(b"chip smoke")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr

    def run_once():
        comm, c_ms = time_host(torch, lambda: P.commit(coeffs_mont, enc))
        root = comm.get_root()
        proof, p_ms = time_host(torch, lambda: comm.prove(outer, transcript(root)))
        value, v_ms = time_host(
            torch, lambda: proof.verify(root, outer, inner, enc, transcript(root)))
        return comm, proof, value, (c_ms, p_ms, v_ms)

    torch.cuda.reset_peak_memory_stats()
    spmv.spmv_mont.launches = 0
    comm, proof, value, cold = run_once()
    launches = spmv.spmv_mont.launches
    n_levels = len(pre) + len(post) + 1
    log(f"main path cold: commit {cold[0]:.1f} ms, prove {cold[1]:.1f} ms, "
        f"verify {cold[2]:.1f} ms; spmv_mont launches {launches} "
        f"(= 2 encodes x {n_levels} levels)")
    if launches != 2 * n_levels:
        raise AssertionError(f"launches {launches} != {2 * n_levels}")
    want = P.univariate_eval(spec, coeffs, x_pt)
    if value != want:
        raise AssertionError("verify returned the wrong evaluation")
    log(f"  verify returned univariate_eval of the {N_COEFFS} coefficients: ok")
    root = comm.get_root()
    data = P.wire.serialize_proof(spec, proof)
    log(f"  n_rows {comm.n_rows}, n_cols {comm.n_cols}, proof {len(data)} bytes, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    warm = [run_once()[3] for _ in range(REPS)]
    med = [statistics.median(t[i] for t in warm) for i in range(3)]
    for name, m in zip(("commit", "prove", "verify"), med):
        log(f"{name}_ms_median_{size}_ft255: {m:.1f} "
            f"(warm runs {[round(t[('commit', 'prove', 'verify').index(name)], 1) for t in warm]}; {card})")

    # 5. golden fixture on the GPU
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "torch_golden_sdig.json")) as f:
        golden = json.load(f)
    genc = P.SdigEncoding(spec, golden["n_per_row"], seed=golden["matrix_seed"],
                          device="cuda")
    vals_g = seeded_values(spec.p, spec.w16,
                           golden["n_per_row"] * golden["n_rows"] + 1,
                           golden["coeff_seed"])
    gcoeffs, gx = vals_g[:-1], vals_g[-1]
    gcomm = P.commit(gcoeffs, genc)
    groot = gcomm.get_root()
    gtr = P.Transcript(golden["transcript"][0].encode())
    gtr.append_message(b"polycommit", groot)
    gtr.append_message(b"ncols", genc.get_n_col_opens().to_bytes(8, "big"))
    gouter, _ = P.univariate_tensors(spec, gx, genc.n_per_row, gcomm.n_rows)
    gdata = P.wire.serialize_proof(spec, gcomm.prove(gouter, gtr))
    if groot.hex() != golden["root"] or \
            hashlib.sha256(gdata).hexdigest() != golden["proof_sha256"]:
        raise AssertionError("golden fixture not reproduced on the GPU")
    log(f"golden fixture: root {groot.hex()[:16]}.. and proof sha256 reproduced")

    # 6. kernel table
    kernels = [{
        "name": "spmv_mont",
        "route": "cuda",
        "source": "lcpc_tpu_torch/csrc/spmv_mont.cu",
        "replaces": "lcpc_tpu/ops/spmv_pallas.py:180",
        "launches": launches,
        "max_abs_err": max(commit_tot["err"], verify_tot["err"]),
        "ms": commit_tot["ms"],
        "plain_ms": commit_tot["plain_ms"],
        "bound_ms": commit_tot["bound_ms"],
        "bound_by": "bytes" if commit_tot["t_bytes"] >= commit_tot["t_ops"] else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "tolerance": 0,
        "shape": f"one {size} ft255 commit encode: {n_levels} launches at r={R_COMMIT}",
        "verify_encode_ms": verify_tot["ms"],
        "verify_encode_plain_ms": verify_tot["plain_ms"],
    }]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_levels.json"), "w") as f:
        json.dump({"card": card, "levels": rows, "main_path_ms": {
            "cold": cold, "warm": warm, "median": med}}, f, indent=1)
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
