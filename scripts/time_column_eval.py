"""The direct column evaluation's kernels on one GPU: mont_dot's tensor-core
kernel and power_table's digit planes, held to their plain versions (bit
for bit) and timed at the 2^29 prove's shapes.

    python3 scripts/time_column_eval.py [--rows 64,2048] [--no-check]

Builds csrc/mont_dot.cu and csrc/power_table.cu (ptxas's registers and
spills of every template printed, with any wgmma warning), then:
  - checks: the tensor-core path against mont_dot_plain in every field
    (ragged A, K and B, both outputs, packed and limb coefficients, a
    power table as planes), all-0xFF operands at K = 2^15 - 1, 2^15 and
    2^15 + 1 at a shape that splits K at 2^15 (the s32 accumulator's
    limit), and the planes table against power_table_plain;
  - times: the 2^29 column evaluation (ft255, 262,144 coefficients a row,
    189 points) for each row count of --rows beside its tensor-core and
    IMAD bounds, the plain version at the smallest, and the power table.
Prints one JSON line last and writes chiprun_out/time_column_eval.json.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12        # dense u8/s8 tensor-core operations (2 a multiply-add)
WIDE_PRODUCTS_PER_S = 16.75e12 / 2  # 32 x 32 -> 64 products on the CUDA cores
NPR, POINTS = 1 << 18, 189      # the 2^29 prove: coefficients a row, opened columns


def eval_bounds(w32, a, k, b):
    """(tensor-core ms, IMAD ms, bytes ms) of an a x k x b evaluation: the
    byte products (4 w32)^2 a multiply-add, the wide products w32^2, the
    coefficient words, the planes and the output read or written once."""
    d = 4 * w32
    return (2 * a * k * b * d * d / INT8_OPS_PER_S * 1e3,
            a * k * b * w32 * w32 / WIDE_PRODUCTS_PER_S * 1e3,
            (4 * w32 * (a * k + a * b) + d * k * b) / HBM_BYTES_PER_S * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="64,2048")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_column_eval.py needs a CUDA device")
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.ops import mont_dot as md
    from lcpc_tpu_torch.ops.spmv import pack_words
    from lcpc_tpu_torch.utils import cuda_build

    card = kb.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["mont_dot", "power_table"], force=True)
    print(f"build {secs} ({time.perf_counter() - t0:.1f} s wall)", flush=True)
    res = {"card": card, "ptxas": {}, "warnings": []}
    for name, kname in (("mont_dot", "mont_dot_"), ("power_table", "power_")):
        log = cuda_build.build_logs[name]
        for k, (regs, st, ld) in sorted(kb.ptxas_entries(log, kname).items()):
            print(f"  ptxas {k}: {regs} registers, {st} / {ld} bytes spill", flush=True)
            res["ptxas"][k] = [regs, st, ld]
        res["warnings"] += [ln for ln in log.splitlines() if re.search(r"warn|wgmma", ln, re.I)]
    for ln in res["warnings"]:
        print(f"  nvcc: {ln}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(field, a, k, form="packed"):
        x = kb.random_mont(field, (a, field.w16, k), gen).permute(1, 0, 2).contiguous()
        return x if form == "limbs" else pack_words(x, 0)

    def rand_packed(field, a, k):  # (W/2, a, k) words below p, without a limb copy
        w32, top = field.w16 // 2, field.p >> (32 * (field.w16 // 2 - 1))
        x = torch.randint(-2**31, 2**31, (w32, a, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        x[-1] = torch.randint(0, top, (a, k), generator=gen, device="cuda", dtype=torch.int32)
        return x

    def points(field, k):
        return pack_words(kb.random_mont(field, (1, field.w16, k), gen)[0], 0)

    def same(tag, got, want):
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{tag}: kernel != plain ({bad} words differ)")

    if not args.no_check:
        t0 = time.perf_counter()
        for field in P.ALL_FIELDS:
            for a, k, b in ((3, 1, 5), (37, 70, 45), (33, 33, 33), (64, 300, 189),
                            (5, 3000, 190), (1, 200, 7), (2, 129, 9)):
                for out_form in md.OUT_FORMS:
                    for x_form in md.FORMS:
                        x = rand(field, a, k, x_form)
                        y = rand(field, k, b)
                        want = md.mont_dot_plain(field, x, y, out_form, x_form=x_form)
                        planes = md.to_planes(field, y)
                        same(f"{field.name} {a}x{k}x{b} {out_form} {x_form}",
                             md.mont_dot(field, x, planes, out_form, x_form=x_form,
                                         y_form="planes"), want)
                        if a > 2:
                            same(f"{field.name} {a}x{k}x{b} {out_form} {x_form} words y",
                                 md.mont_dot(field, x, y, out_form, x_form=x_form), want)
            g = points(field, 11)
            for big_k in (1, 70, 5_000):
                same(f"{field.name} planes table {big_k}",
                     md.power_table(field, g, big_k),
                     md.power_table_plain(field, g, big_k, "planes"))
            print(f"  {field.name}: tensor-core mont_dot and planes table equal to plain",
                  flush=True)
        spec = P.FT255
        d = 2 * spec.w16
        for k in (md.FOLD_K - 1, md.FOLD_K, md.FOLD_K + 1):
            a, b = 64, 17 * (256 // d)
            split = md.tc_split(spec, a, k, b, torch.cuda.get_device_properties(0)
                                .multi_processor_count)
            if split[1] != -(-k // md.FOLD_K) or split[0] > md.FOLD_K:
                raise AssertionError(f"K = {k}: split {split} is not the fold limit's")
            x = torch.full((spec.w16, a, k), 0xFFFF, dtype=torch.int32, device="cuda")
            y = torch.full((md.plane_tiles(k), b, d, md.TC_KT), 0xFF, dtype=torch.uint8,
                           device="cuda")
            for out_form in md.OUT_FORMS:
                same(f"all-0xFF K={k} {out_form}",
                     md.mont_dot(spec, x, y, out_form, x_form="limbs", y_form="planes"),
                     md.mont_dot_plain(spec, x, y, out_form, x_form="limbs", y_form="planes"))
            print(f"  all-0xFF {a} x {k} x {b} (k_split {split[0]}, {split[1]} splits) equal",
                  flush=True)
        g = points(spec, POINTS)
        same("2^29 planes table", md.power_table(spec, g, NPR),
             md.power_table_plain(spec, g, NPR, "planes"))
        print(f"  the 2^29 planes table equal; checks {time.perf_counter() - t0:.1f} s",
              flush=True)

    spec = P.FT255
    w32 = spec.w16 // 2
    g = points(spec, POINTS)
    res["table_ms"] = {"planes": kb.time_kernel(lambda: md.power_table(spec, g, NPR), reps=5)}
    print(f"power_table {NPR} x {POINTS}: {res['table_ms']}", flush=True)
    table = md.power_table(spec, g, NPR)
    res["eval"] = {}
    for rows in (int(r) for r in args.rows.split(",")):
        x = rand_packed(spec, rows, NPR)
        ms = kb.time_kernel(lambda: md.mont_dot(spec, x, table, "mont", y_form="planes"),
                            reps=3 if rows <= 256 else 1)
        tc, imad, nbytes = eval_bounds(w32, rows, NPR, POINTS)
        rec = {"ms": ms, "tc_bound_ms": tc, "imad_bound_ms": imad, "bytes_ms": nbytes,
               "tc_share": tc / ms, "split": md.tc_split(spec, rows, NPR, POINTS, 132)}
        if rows == min(int(r) for r in args.rows.split(",")):
            got = md.mont_dot(spec, x, table, "mont", y_form="planes")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = md.mont_dot_plain(spec, x, table, "mont", y_form="planes")
            torch.cuda.synchronize()
            rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
            same(f"2^29 evaluation, {rows} rows", got, want)
            del got, want
        res["eval"][rows] = rec
        print(f"evaluation {rows} x {NPR} x {POINTS}: {ms:.3f} ms; tensor-core bound {tc:.3f} "
              f"ms ({tc / ms:.1%}), IMAD bound {imad:.1f} ms, bytes {nbytes:.3f} ms; "
              f"{rec}", flush=True)
        del x
        torch.cuda.empty_cache()
    out_dir = os.path.join(os.path.dirname(_HERE), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "time_column_eval.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"card": card, "table_ms": res["table_ms"],
                      "eval_ms": {r: v["ms"] for r, v in res["eval"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
