"""power_table on one GPU: the kernel held to its plain version bit for bit
and timed beside its bound at the shapes of the slice's paths.

    python3 scripts/time_power_table.py [--repo DIR] [--label NAME] [--no-check] [--reps N]

Builds csrc/power_table.cu (ptxas's registers and spills of every
power_planes_kernel template printed; the W32 = 8 template's SASS counted:
all its instructions by opcode, and those of its loop with the most
IMAD.WIDE, the entry loop), then:
  - checks (skipped with --no-check): the kernel's digit planes against
    power_table_plain at K x k = 32,768 x 189 (the 2^23 verify), 131,072 x
    189 (the 2^28 verify) and 262,144 x 189 (the 2^29 prove and verify), and
    at K = 1, 127, 128, 129, 4,097 with k = 1, 189, 6,593 in every field;
  - times (device ms, CUDA events over back-to-back launches) at the three
    path shapes, each beside its bound (the table's bytes written once over
    3.35 TB/s against one Montgomery product, 2 W32^2 + W32 wide products,
    an entry at 8.4 T/s: chip_smoke.table_bound), and the plain version's
    host wall at the 2^23 shape;
  - the start of a launch: each path shape's K with one point (the blocks'
    table build and one tile a warp at most), and the resident warps an SM
    from ptxas's registers;
  - MxuColumnEval.set_columns at the 2^29 prove's shape (2^20 columns, 189
    opened), host wall to synchronize, median of 5 warm runs.
With --repo, the checkout in DIR (an older commit unpacked into the
gitignored archive/) is built and timed instead: run parent, change,
change, parent in one call.  Prints one JSON line last and writes
chiprun_out/time_power_table[_LABEL].json.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE, _ROOT]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
WIDE_PRODUCTS_PER_S = 16.75e12 / 2  # 32 x 32 -> 64 products on the CUDA cores
SHAPES = ((32_768, 189), (131_072, 189), (262_144, 189))
EDGE_K = (1, 127, 128, 129, 4_097)
EDGE_k = (1, 189, 6_593)


def table_bound(w32, big_k, k):
    """(ms, by): the table's words written once against one Montgomery
    product (2 W32^2 + W32 wide products) an entry (chip_smoke.table_bound)."""
    t_bytes = 4 * w32 * (big_k * k + k) / HBM_BYTES_PER_S * 1e3
    t_ops = big_k * k * (2 * w32 * w32 + w32) / WIDE_PRODUCTS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sass_report(so_path, w32=8):
    """Opcode counts of the W32 template: the whole kernel and its loop
    with the most IMAD.WIDE (the entry loop), or None without cuobjdump."""
    funcs = kb.sass_functions(so_path)
    if funcs is None:
        return None
    instrs = next(v for k, v in funcs.items() if f"power_planes_kernelILi{w32}E" in k)
    loop = max(kb._loops(instrs), key=lambda lp: sum(t.startswith("IMAD.WIDE") for t in lp),
               default=[])
    ops = collections.Counter(t.split()[0] for t in loop)
    wide = sum(t.startswith("IMAD.WIDE") for t in loop)
    alu, fma, n = kb.pipe_mix(loop)
    return {"kernel_instructions": len(instrs), "loop_instructions": n, "loop_alu": alu,
            "loop_fma": fma, "loop_imad_wide": wide, "loop_opcodes": dict(ops.most_common())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=_ROOT, help="the checkout whose lcpc_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_power_table.py needs a CUDA device")
    sys.path[:0] = [os.path.abspath(args.repo)]
    import lcpc_tpu_torch as P
    if not P.__file__.startswith(os.path.abspath(args.repo)):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {args.repo}")
    from lcpc_tpu_torch.ops import mont_dot as md
    from lcpc_tpu_torch.ops.spmv import pack_words
    from lcpc_tpu_torch.utils import cuda_build

    label = args.label or "change"
    card = kb.card_line()
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["power_table"], force=True)
    ptxas = kb.ptxas_entries(cuda_build.build_logs["power_table"], "power_")
    for name, (regs, st, ld) in sorted(ptxas.items()):
        print(f"{label} ptxas {name}: {regs} registers, {st} bytes spill stores, {ld} bytes "
              f"spill loads", flush=True)
    sass = sass_report(cuda_build.so_path("power_table"))
    print(f"{label} SASS W32=8: {sass}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    spec = P.FT255
    w32 = spec.w16 // 2

    def points(field, k):
        return pack_words(kb.random_mont(field, (1, field.w16, k), gen)[0], 0)

    result = {"label": label, "card": card, "build_s": secs, "ptxas": ptxas, "sass": sass,
              "shapes": {}, "checks": 0}
    g = points(spec, 189)
    if not args.no_check:
        for big_k, k in SHAPES:
            got = md.power_table(spec, g[:, :k], big_k)
            if not torch.equal(got, md.power_table_plain(spec, g[:, :k], big_k)):
                raise AssertionError(f"power_table {big_k} x {k} != plain")
            result["checks"] += 1
            del got
        for field in P.ALL_FIELDS:
            for k in EDGE_k:
                gg = points(field, k)
                for big_k in EDGE_K:
                    if not torch.equal(md.power_table(field, gg, big_k),
                                       md.power_table_plain(field, gg, big_k)):
                        raise AssertionError(f"power_table {field.name} {big_k} x {k} != plain")
                    result["checks"] += 1
        torch.cuda.synchronize()
        print(f"{label} power_table equal to plain at {result['checks']} shapes (the three path "
              f"shapes; K {EDGE_K} x k {EDGE_k} in every field)", flush=True)
    for big_k, k in SHAPES:
        ms = kb.time_kernel(lambda: md.power_table(spec, g[:, :k], big_k), reps=args.reps)
        bound, by = table_bound(w32, big_k, k)
        rec = {"ms": ms, "bound_ms": bound, "bound_by": by, "share": bound / ms}
        if big_k == SHAPES[0][0]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            md.power_table_plain(spec, g[:, :k], big_k)
            torch.cuda.synchronize()
            rec["plain_ms"] = (time.perf_counter() - t1) * 1e3
        result["shapes"][f"{big_k}x{k}"] = rec
        print(f"{label} power_table {big_k} x {k}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / ms:.1%} of it", flush=True)
    # the launch's start: one point, so every warp stores a tile or none and
    # the time is the launch, the blocks' table build (17 products deep at
    # K = 2^15, 20 at 2^18) and one tile
    for big_k, _ in SHAPES:
        ms = kb.time_kernel(lambda: md.power_table(spec, g[:, :1], big_k), reps=args.reps)
        result["shapes"][f"{big_k}x1"] = {"ms": ms}
        print(f"{label} power_table {big_k} x 1 (the start): {ms:.4f} ms", flush=True)
    # the resident warps an SM, from ptxas's registers at W32 = 8 (65,536 a
    # SM, 64 warps at most; the blocks' shared memory does not bind)
    regs8 = next((v[0] for k, v in ptxas.items() if "ILi8E" in k), None)
    if regs8:
        with open(cuda_build.source_path("power_table")) as fh:
            warps = int(re.search(r"constexpr int k(?:Plane)?Warps = (\d+);", fh.read()).group(1))
        threads = 32 * warps
        blocks = 65536 // (-(-regs8 // 8) * 8 * threads)
        result["warps_per_sm_w8"] = min(64, blocks * threads // 32)
        print(f"{label} W32 = 8: {regs8} registers, {blocks} blocks of {threads} threads an SM, "
              f"{result['warps_per_sm_w8']} of 64 warps resident", flush=True)
    # MxuColumnEval.set_columns at the 2^29 prove (2^20 columns, 189 opened):
    # the host's points, their upload and the table, host wall to synchronize
    from lcpc_tpu_torch.ops.mxu_prove import MxuColumnEval
    enc = P.LigeroEncoding.new(spec, 1 << 29, 1, 4)
    cols = [int(c) for c in torch.randint(0, enc.n_cols, (189,), generator=torch.Generator()
                                          .manual_seed(29))]
    ev = MxuColumnEval(enc)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev.set_columns(cols)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    result["set_columns_2_29_host_ms"] = sorted(walls[1:])[2]
    result["set_columns_2_29_host_ms_runs"] = walls
    print(f"{label} set_columns at 2^29 ({enc.n_cols} columns, 189 opened): median "
          f"{result['set_columns_2_29_host_ms']:.2f} ms of 5 warm runs {walls[1:]}", flush=True)
    result["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    out = os.path.join(_ROOT, "chiprun_out", f"time_power_table_{label}.json")
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
