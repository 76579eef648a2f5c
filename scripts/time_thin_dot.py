"""mont_dot's thin path on one GPU: the tensor-core kernel (thin_tc) held
to its plain version bit for bit and timed against the CUDA-core kernel
(thin) at the prover's collapse shapes, the crossover between the two, the
verifier's rows at the opened columns by both table layouts, and the NTT
at the 2^29 commit's block shape.

    python3 scripts/time_thin_dot.py [--repo DIR] [--label NAME] [--no-check] [--no-sweep]

Builds csrc/mont_dot.cu, csrc/power_table.cu and csrc/ntt_mont.cu (ptxas's
registers and spills of every mont_dot_thin_tc template printed, with any
wgmma serialization), then:
  - checks: thin_tc against mont_dot_plain in every field (A = 1 and 2,
    ragged K and B, packed and limb y, both outputs, an odd row stride,
    all-0xFF operands), at the 2^23 Ligero and Brakedown collapses and a
    64-row block of the 2^29 and 2^28 collapses;
  - times (device ms, each beside its bytes bound, its u8 tensor-core
    bound and the CUDA cores' wide products): both kernels at the 2^29,
    2^28, 2^23 Ligero and Brakedown collapses; a K x B sweep of both for
    the crossover (--no-sweep skips it); verify's rows at the opened
    columns at K = 2^15 and 2^18 (189 columns, two rows), each with its
    table: (a) the words table and the thin kernel (the route before the
    words table was removed: --repo a checkout that has it), (b) the planes
    table and the tile kernel; one 96-row words-only ntt_forward at n = 2^20.
With --repo, the checkout in DIR (an older commit unpacked into the
gitignored archive/) is timed instead, as far as it has each piece: a
checkout without the thin tensor-core kernel times its own route at the
collapses, one with the words table also times route (a).  Prints one
JSON line last and writes chiprun_out/time_thin_dot[_LABEL].json.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
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
INT8_OPS_PER_S = 1979e12            # dense u8/s8 tensor-core operations (2 a multiply-add)
WIDE_PRODUCTS_PER_S = 16.75e12 / 2  # 32 x 32 -> 64 products on the CUDA cores


def dot_bounds(w32, a, k, b, y_bytes):
    """(bytes ms, u8 tensor-core ms, IMAD ms) of an a x k x b product: x, y
    and the output read or written once; (4 w32)^2 byte products or w32^2
    wide products a multiply-add."""
    nbytes = 4 * w32 * (a * k + a * b) + y_bytes
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2 * a * k * b * (4 * w32) ** 2 / INT8_OPS_PER_S * 1e3,
            a * k * b * w32 * w32 / WIDE_PRODUCTS_PER_S * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--repo", default=_ROOT, help="the checkout whose lcpc_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_thin_dot.py needs a CUDA device")
    sys.path[:0] = [os.path.abspath(args.repo)]
    import lcpc_tpu_torch as P
    if not P.__file__.startswith(os.path.abspath(args.repo)):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {args.repo}")
    from lcpc_tpu_torch.ops import mont_dot as md
    from lcpc_tpu_torch.ops import ntt as nttm
    from lcpc_tpu_torch.ops.spmv import pack_words
    from lcpc_tpu_torch.utils import cuda_build
    import chip_smoke

    card = kb.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["mont_dot", "power_table", "ntt_mont"], force=True)
    print(f"build {secs} ({time.perf_counter() - t0:.1f} s wall)", flush=True)
    has_tc = hasattr(md, "thin_tc_split")  # the thin tensor-core kernel and mont_dot's _route
    has_words = "form" in inspect.signature(md.power_table).parameters  # the words table
    res = {"card": card, "label": args.label, "repo": os.path.abspath(args.repo), "ptxas": {}}
    log = cuda_build.build_logs["mont_dot"]
    for k, (regs, st, ld) in sorted(kb.ptxas_entries(log, "mont_dot_").items()):
        print(f"  ptxas {k}: {regs} registers, {st} / {ld} bytes spill", flush=True)
        res["ptxas"][k] = [regs, st, ld]
    res["serialized"] = [ln for ln in log.splitlines() if re.search(r"serializ", ln, re.I)]
    for ln in res["serialized"]:
        print(f"  nvcc: {ln}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def rand(field, a, k, form="packed"):
        x = kb.random_mont(field, (a, field.w16, k), gen).permute(1, 0, 2).contiguous()
        return x if form == "limbs" else pack_words(x, 0)

    def rand_packed(field, a, k):  # (W/2, a, k) words below p, without a limb copy
        w32, top = field.w16 // 2, field.p >> (32 * (field.w16 // 2 - 1))
        x = torch.randint(-2**31, 2**31, (w32, a, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        x[-1] = torch.randint(0, top, (a, k), generator=gen, device="cuda", dtype=torch.int32)
        return x

    def same(tag, got, want):
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{tag}: kernel != plain ({bad} words differ)")

    def dot(field, x, y, out_form, x_form, y_form, kernel):
        kw = {"_route": kernel} if has_tc else {}  # else the checkout's own route
        return md.mont_dot(field, x, y, out_form, x_form=x_form, y_form=y_form, **kw)

    spec = P.FT255
    w32 = spec.w16 // 2
    shapes = {  # name: (x as (A, K), y as (K, B), x form, y form)
        "2^29 collapse": (2, 2048, 1 << 18, "packed", "packed"),
        "2^28 collapse": (2, 2048, 1 << 17, "packed", "packed"),
        "2^23 ligero collapse": (2, 256, 1 << 15, "packed", "limbs"),
        "2^23 brakedown collapse": (2, 36, 235_173, "packed", "limbs"),  # SdigEncoding's dims
    }
    if has_tc and not args.no_check:
        t0 = time.perf_counter()
        for field in P.ALL_FIELDS:
            for a, k, b in ((1, 1, 5), (2, 37, 19), (1, 70, 45), (2, 33, 300), (2, 300, 129),
                            (2, 3000, 70), (1, 129, 1000)):
                for out_form in md.OUT_FORMS:
                    for y_form in md.FORMS:
                        x = rand(field, a, k, "limbs")
                        # by TMA (row stride a multiple of 4) and by cp.async (misaligned)
                        big = rand(field, k, -(-(b + 1) // 4) * 4, y_form)
                        for y in (big[:, :, :b], big[:, :, 1 : b + 1]):
                            want = md.mont_dot_plain(field, x, y, out_form, x_form="limbs",
                                                     y_form=y_form)
                            same(f"{field.name} {a}x{k}x{b} {out_form} {y_form} "
                                 f"tma={md.thin_tc_tma(y)}",
                                 dot(field, x, y, out_form, "limbs", y_form, "thin_tc"), want)
            for k in (1000, 2049):  # all-0xFF x and y words, limbs 0xFFFF
                x = torch.full((field.w16 // 2, 2, k), -1, dtype=torch.int32, device="cuda")
                for y_form, y in (("packed", torch.full((field.w16 // 2, k, 300), -1,
                                                        dtype=torch.int32, device="cuda")),
                                  ("limbs", torch.full((field.w16, k, 300), 0xFFFF,
                                                       dtype=torch.int32, device="cuda"))):
                    for out_form in md.OUT_FORMS:
                        same(f"{field.name} all-0xFF K={k} {y_form} {out_form}",
                             dot(field, x, y, out_form, "packed", y_form, "thin_tc"),
                             md.mont_dot_plain(field, x, y, out_form, y_form=y_form))
            print(f"  {field.name}: thin_tc equal to plain", flush=True)
        for name, (a, k, b, x_form, y_form) in shapes.items():
            k = min(k, 64)  # a 64-row block of the 2^29 and 2^28 collapses
            x, y = rand(spec, a, k, x_form), rand(spec, k, b, y_form)
            for out_form in md.OUT_FORMS:
                same(f"{name} {out_form}", dot(spec, x, y, out_form, x_form, y_form, "thin_tc"),
                     md.mont_dot_plain(spec, x, y, out_form, x_form=x_form, y_form=y_form))
            print(f"  {name} ({a} x {k} x {b}, y {y_form}, tma={md.thin_tc_tma(y)}): equal",
                  flush=True)
            del x, y
        print(f"  checks {time.perf_counter() - t0:.1f} s", flush=True)

    res["collapse"] = {}
    for name, (a, k, b, x_form, y_form) in shapes.items():
        x = rand(spec, a, k, x_form)
        y = rand_packed(spec, k, b) if y_form == "packed" else rand(spec, k, b, "limbs")
        t_bytes, t_tc, t_imad = dot_bounds(w32, a, k, b, y.numel() * 4)
        rec = {"a": a, "k": k, "b": b, "y_form": y_form, "bytes_ms": t_bytes, "tc_ms": t_tc,
               "imad_ms": t_imad}
        if has_tc:
            rec["split"] = md.thin_tc_split(spec, y_form == "limbs", k, b, n_sm)
            rec["tma"] = md.thin_tc_tma(y)
        reps = 3 if k * b > 1 << 28 else 20
        for kernel in ("thin", "thin_tc", "thin_tc", "thin") if has_tc else ("thin", "thin"):
            ms = kb.time_kernel(lambda: dot(spec, x, y, "canonical", x_form, y_form, kernel),
                                reps=reps)
            rec.setdefault(kernel, []).append(ms)
        res["collapse"][name] = rec
        print(f"{args.label} {name} {a} x {k} x {b} (y {y_form}): thin {rec['thin']} ms, "
              f"thin_tc {rec.get('thin_tc')} ms; bound {max(t_bytes, t_tc):.4f} ms (bytes "
              f"{t_bytes:.4f}, tensor cores {t_tc:.4f}; IMAD {t_imad:.4f}); split "
              f"{rec.get('split')}", flush=True)
        del x, y
        torch.cuda.empty_cache()

    if has_tc and not args.no_sweep:
        res["sweep"] = []
        for y_form in ("limbs", "packed"):
            for k in (2, 8, 16, 36, 64, 128, 256):
                for b in (189, 1024, 4096, 16384, 65536):
                    for a in (1, 2):
                        x, y = rand(spec, a, k, "packed"), rand(spec, k, b, y_form)
                        t = {kern: kb.time_kernel(lambda: dot(spec, x, y, "canonical", "packed",
                                                              y_form, kern), reps=20)
                             for kern in ("thin", "thin_tc")}
                        res["sweep"].append({"a": a, "k": k, "b": b, "y_form": y_form, **t})
                        print(f"  sweep {y_form} {a} x {k} x {b}: thin {t['thin']:.4f} ms, "
                              f"thin_tc {t['thin_tc']:.4f} ms", flush=True)

    # verify's rows at the opened columns, table included: (a) the words
    # table + the thin kernel, where the checkout has the words table; (b)
    # the planes table + the tile kernel
    res["verify_rows"] = {}
    g = pack_words(kb.random_mont(spec, (1, spec.w16, 189), gen)[0], 0)

    def table(big_k, form):
        return md.power_table(spec, g, big_k, *((form,) if has_words else ()))

    routes = {"b planes + tile": ("planes", "planes", "tile")}
    if has_words:
        routes = {"a words + thin": ("words", "packed", "thin"), **routes}
    for big_k in (1 << 15, 1 << 18):
        x = rand(spec, 2, big_k, "limbs")
        rec = {}
        want = None
        for tag, (form, y_form, kernel) in routes.items():
            tab = table(big_k, form)
            got = dot(spec, x, tab, "mont", "limbs", y_form, kernel)
            if want is None:
                want = got
            same(f"verify rows K={big_k} {tag}", got, want)
            rec[tag] = {
                "table_ms": kb.time_kernel(lambda: table(big_k, form), reps=5),
                "dot_ms": kb.time_kernel(lambda: dot(spec, x, tab, "mont", "limbs", y_form,
                                                     kernel), reps=5),
                "both_ms": kb.time_kernel(lambda: dot(spec, x, table(big_k, form), "mont",
                                                      "limbs", y_form, kernel), reps=5)}
            del tab
        res["verify_rows"][big_k] = rec
        print(f"{args.label} verify rows at the columns, K = {big_k} x 189: {rec}", flush=True)
        del x
    torch.cuda.empty_cache()

    # the 2^29 commit's encode block: 96 rows of 2^18 to n = 2^20, words only
    plan = nttm.get_ntt(spec, 1 << 20)
    x = kb.random_mont(spec, (96, spec.w16, 1 << 18), gen).permute(1, 0, 2).contiguous()
    ms = kb.time_kernel(lambda: nttm.ntt_forward(plan, x, output="words"), reps=3)
    nbytes, products, bfl = chip_smoke.ntt_cost(spec, 96, 1 << 18, 1 << 20, True)
    nbytes -= 4 * spec.w16 * 96 * (1 << 20)  # words only: no limbs written
    bound, t_bytes, t_ops = chip_smoke.bound_ms(nbytes, products)
    res["ntt_2_20"] = {"rows": 96, "k": 1 << 18, "n": 1 << 20, "ms": ms, "bound_ms": bound,
                       "bytes_ms": t_bytes, "ops_ms": t_ops, "butterflies": bfl,
                       "passes": plan.launches_per_call}
    print(f"ntt_forward 96 x 2^18 -> 2^20, words only: {ms:.4f} ms in {plan.launches_per_call} "
          f"passes; bound {bound:.4f} ms (bytes {t_bytes:.4f}, operations {t_ops:.4f})",
          flush=True)

    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = f"time_thin_dot{'_' + args.label if args.label else ''}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"card": card, "label": args.label,
                      "collapse": {k: {kern: v.get(kern) for kern in ("thin", "thin_tc")}
                                   for k, v in res["collapse"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
