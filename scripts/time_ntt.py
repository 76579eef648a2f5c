"""Device time of one `ntt_forward` at the 2^23 Ligero shapes, for any
checkout of the port.

    python3 scripts/time_ntt.py [--repo DIR] [--label NAME] [--sweep] [--parts] [--sdig]
        [--inverse] [--maps]

Imports lcpc_tpu_torch from DIR (default: this checkout) and times, with
kernel_bench.time_kernel (10 calls queued behind a sleeping kernel, CUDA
events), on random ft255 rows:
  - `ntt_forward(plan, x)` at the commit shape (R = 256 rows of 32,768
    padded to n = 2^17) and at the verify shape (R = 2): every launch and
    layout copy of the call;
  - the commit's encode with its column-hash words: `ntt_forward(plan, x,
    output="both")` (or `canon_words=True`, its older spelling) where the
    wrapper has it, else `ntt_forward`, then
    `from_mont` and `_pack_words` (what the commit ran before the NTT wrote
    the words).
  - verify's proof rows (2 rows of 32,768 canonical words, some of them
    >= p): `protocol._rows_encode(enc, rows_w)`, the conversion to
    Montgomery form and the encode (PR 20: the NTT's first pass converts as
    it loads; before, one mont_mul_map launch, then the NTT), warm and cold,
    with the launches of one call by kernel (chip_smoke.py phase 5 holds
    the words-in pass to mont_mul_map + ntt_forward in every field);
  - the same for Brakedown's verify rows (2 x 235,173 words; PR 20: the
    conversion writes the level buffer, no pack) with --sdig;
  - the small commit's one launch (`protocol._commit_fused_fn`, BLAKE3) at
    Ligero 2^13 and 2^16, whose kernel shares the NTT's pass body;
  - with --inverse, `intt_inverse` at 2 and 256 rows of 2^17, warm and cold;
  - with --maps, mont_mul_map's conversion of verify's canonical rows alone,
    warm and cold: Brakedown 2^23's 2 x 235,173 words into its packed level
    buffer (`out=`), and the 2^29 verify's 2 x 262,144 words as the columns
    route reads them (core/protocol.py, to_mont to a new words tensor).
With --sweep it also times the commit shape under other pass plans, and
with --parts each pass alone at both shapes, built as is and built
with LCPC_NTT_NO_PRODUCTS (every twiddle product left out: the passes'
memory, shared-memory and add/sub time alone); both for this checkout
only.  Two commits are timed by one method: unpack the other into a
gitignored directory (`git archive`) and run both in one call on one card,
in the order A, B, B, A.  Prints the card line first and one JSON line
last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import inspect
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))

N_COEFFS = 1 << 23
SEED = 0
SWEEP = ({"log_t": 2}, {"log_t": 4}, {"log_t": 5, "max_tile_bytes": 1 << 17},
         {"log_chunk": 9}, {"log_chunk": 11}, {"log_chunk": 8, "max_tile_bytes": 1 << 15})


def _pass_args(plan, x, out, words, buf, i, stream):
    """lcpc_ntt_pass's arguments for pass i of plan on x, as ntt_forward
    passes them (words may be None)."""
    ps, last = plan.passes[i], len(plan.passes) - 1
    tw, consts = plan.kernel_table(x.device)
    r = x.shape[1]
    return (x.data_ptr() if i == 0 else None, None if i == 0 else buf.data_ptr(),
            None if i == last else buf.data_ptr(), out.data_ptr() if i == last else None,
            words.data_ptr() if i == last and words is not None else None, tw.data_ptr(),
            consts.data_ptr(),
            plan.spec.w16 // 2, r, plan.log_n, x.shape[2], ps.hi, ps.lo, ps.log_t,
            ps.threads(r << (plan.log_n - ps.log_tile)), x.device.index or 0, stream)


def time_parts(torch, kb, nttm, plan, x, with_words):
    """ms of each pass alone (limbs, and words if asked, out), as built and
    without the twiddle products (the LCPC_NTT_NO_PRODUCTS build)."""
    cb = nttm.cuda_build
    lib = cb.load(nttm._NAME, nttm._bind)
    so = os.path.join(cb.BUILD_DIR, "libntt_mont_no_products.so")
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-DLCPC_NTT_NO_PRODUCTS", "-o", so,
                    cb.source_path(nttm._NAME)], check=True, capture_output=True, timeout=600)
    bare = ctypes.CDLL(so)
    nttm._bind(bare)
    w, r, n = plan.spec.w16, x.shape[1], plan.n
    out = torch.empty((w, r, n), dtype=torch.int32, device=x.device)
    words = (torch.empty((r * w // 2, n), dtype=torch.int32, device=x.device)
             if with_words else None)
    buf = torch.empty((r, n, w // 2), dtype=torch.int32, device=x.device)
    parts = []
    for i, ps in enumerate(plan.passes):
        args = _pass_args(plan, x, out, words, buf, i, torch.cuda.current_stream().cuda_stream)
        rec = {"pass": [ps.hi, ps.lo, ps.log_t]}
        for name, l in (("ms", lib), ("no_products_ms", bare)):
            rec[name] = kb.time_kernel(lambda: l.lcpc_ntt_pass(*args))
        parts.append(rec)
        print(f"  pass {i} (half-sizes 2^{ps.hi} .. 2^{ps.lo}, T = {1 << ps.log_t}): "
              f"{rec['ms']:.4f} ms, without the products {rec['no_products_ms']:.4f} ms",
              flush=True)
    return parts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(_HERE),
                    help="checkout whose lcpc_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--sweep", action="store_true", help="also time other pass plans")
    ap.add_argument("--parts", action="store_true",
                    help="also time each pass alone, with and without the products")
    ap.add_argument("--sdig", action="store_true", help="also Brakedown 2^23's verify rows")
    ap.add_argument("--inverse", action="store_true", help="also intt_inverse at 2^17")
    ap.add_argument("--maps", action="store_true",
                    help="also mont_mul_map's verify-row conversions alone")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.repo)]

    import torch

    import kernel_bench as kb

    if not torch.cuda.is_available():
        raise RuntimeError("time_ntt.py needs a CUDA device")
    P = importlib.import_module("lcpc_tpu_torch")
    nttm = importlib.import_module("lcpc_tpu_torch.ops.ntt")
    protocol = importlib.import_module("lcpc_tpu_torch.core.protocol")
    if not P.__file__.startswith(os.path.abspath(args.repo)):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {args.repo}")
    card = kb.card_line()
    print(card, flush=True)

    spec = P.FT255
    enc = P.LigeroEncoding.new(spec, N_COEFFS, 1, 4, device="cuda")
    plan = nttm.get_ntt(spec, enc.n_cols)
    ops = plan.ops
    params = inspect.signature(nttm.ntt_forward).parameters
    both = {"output": "both"} if "output" in params else {"canon_words": True}
    fused = "output" in params or "canon_words" in params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n_rows = -(-N_COEFFS // enc.n_per_row)
    result = {"label": args.label, "repo": os.path.abspath(args.repo), "card": card,
              "launches_per_call": plan.launches_per_call, "words_fused": fused}
    for tag, r in (("commit", n_rows), ("verify", 2)):
        x = kb.random_mont(spec, (r, spec.w16, enc.n_per_row), gen).permute(1, 0, 2)
        x = x.contiguous()
        rec = {"r": r, "ntt_forward_ms": kb.time_kernel(lambda: nttm.ntt_forward(plan, x))}
        if tag == "commit":
            if fused:
                words = lambda: nttm.ntt_forward(plan, x, **both)  # noqa: E731
            else:
                words = lambda: protocol._pack_words(  # noqa: E731
                    ops.from_mont(nttm.ntt_forward(plan, x)))
            rec["with_words_ms"] = kb.time_kernel(words, reps=5)
            if args.sweep:
                rec["sweep"] = []
                for kw in SWEEP:
                    alt = nttm.NttPlan(spec, enc.n_cols, **kw)
                    ms = kb.time_kernel(lambda: nttm.ntt_forward(alt, x, **both))
                    rec["sweep"].append({"plan": kw, "passes": [list(vars(p).values())
                                                                for p in alt.passes],
                                         "with_words_ms": ms})
                    print(f"{args.label} sweep {kw}: {len(alt.passes)} passes, "
                          f"{ms:.4f} ms with words", flush=True)
        if args.parts:
            rec["parts"] = time_parts(torch, kb, nttm, plan, x, tag == "commit")
        result[tag] = rec
        print(f"{args.label} {tag} R={r}: ntt_forward {rec['ntt_forward_ms']:.4f} ms"
              + (f", with the hash words {rec['with_words_ms']:.4f} ms"
                 f" ({'fused' if fused else 'from_mont + pack after'})"
                 if "with_words_ms" in rec else ""), flush=True)
        del x
    encs = [("ligero", enc)]
    if args.sdig:
        encs.append(("sdig", P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device="cuda")))
    for name, e in encs:
        result[f"rows_{name}"] = time_rows(torch, kb, P, protocol, e, gen)
        print(f"{args.label} {name} verify rows {result[f'rows_{name}']}", flush=True)
    if args.inverse:
        result["inverse"] = time_inverse(torch, kb, nttm, spec, enc.n_cols, gen)
        print(f"{args.label} inverse {result['inverse']}", flush=True)
    if args.maps:
        result["maps"] = time_maps(torch, kb, spec, gen)
        print(f"{args.label} maps {result['maps']}", flush=True)
    result["commit_small"] = {}
    for log_n in SMALL_LOGS:
        e = P.LigeroEncoding.new(spec, 1 << log_n, 1, 4, device="cuda")
        arr = kb.random_mont(spec, (1, spec.w16, 1 << log_n), gen)[0].contiguous()
        fn = protocol._commit_fused_fn(e, P.BLAKE3)
        fn(arr)
        result["commit_small"][log_n] = kb.time_kernel(lambda: fn(arr), reps=20)
        print(f"{args.label} commit_small ligero 2^{log_n}: "
              f"{result['commit_small'][log_n]:.4f} ms", flush=True)
    print(json.dumps(result), flush=True)
    return 0


SMALL_LOGS = (13, 16)


def canon_rows(torch, spec, r, npr, gen):
    """(r, npr, W/2) int32 canonical words, random below 2^(16 W): values >=
    p among them (the conversion reduces them), the first all ones."""
    w32 = spec.w16 // 2
    x = torch.randint(-2**31, 2**31, (r, npr, w32), generator=gen, device="cuda",
                      dtype=torch.int32)
    x[:, 0] = -1
    return x


INVERSE_ROWS = (2, 256)  # verify's row count and the 2^23 Ligero codeword's
MAP_ROWS = {"sdig_buffer": (2, 235_173), "columns_rows": (2, 262_144)}


def time_inverse(torch, kb, nttm, spec, n, gen):
    """intt_inverse of INVERSE_ROWS rows of n random Montgomery elements,
    warm and cold (kernel_bench), and its launches a call."""
    plan = nttm.get_intt(spec, n)
    rec = {"n": n, "launches_per_call": plan.launches_per_call}
    for r in INVERSE_ROWS:
        x = kb.random_mont(spec, (r, spec.w16, n), gen).permute(1, 0, 2).contiguous()
        reps = 20 if r < 16 else 10
        rec[f"{r} rows"] = {
            "warm_ms": kb.time_kernel(lambda: nttm.intt_inverse(plan, x), reps=reps),
            "cold_ms": kb.time_kernel_cold(lambda: nttm.intt_inverse(plan, x), reps=reps)}
        del x
    return rec


def time_maps(torch, kb, spec, gen):
    """mont_mul_map's to_mont of verify's canonical rows, warm and cold:
    into Brakedown's packed (positions, R, W/2) level buffer, and to a new
    words tensor (the columns route's)."""
    from lcpc_tpu_torch.ops import mont_map as mm

    rec, w32 = {}, spec.w16 // 2
    for tag, (r, npr) in MAP_ROWS.items():
        a = canon_rows(torch, spec, r, npr, gen).permute(2, 0, 1)
        kw = {}
        if tag == "sdig_buffer":
            buf = torch.empty((npr + 5, r, w32), dtype=torch.int32, device="cuda")
            kw["out"] = buf[:npr].permute(2, 1, 0)

        def fn():
            mm.mont_mul_map(spec, a, op="to_mont", in_form="words", out_form="words", **kw)

        rec[tag] = {"warm_ms": kb.time_kernel(fn, reps=20),
                    "cold_ms": kb.time_kernel_cold(fn, reps=20)}
    return rec


def time_rows(torch, kb, P, protocol, enc, gen):
    """Verify's rows at the 2^23 shape: protocol._rows_encode warm and cold,
    and one call's launches by kernel."""
    from lcpc_tpu_torch.ops import launch_count
    x = canon_rows(torch, enc.spec, 2, enc.n_per_row, gen)
    rec = {"rows": 2, "n_per_row": enc.n_per_row,
           "warm_ms": kb.time_kernel(lambda: protocol._rows_encode(enc, x), reps=20),
           "cold_ms": kb.time_kernel_cold(lambda: protocol._rows_encode(enc, x), reps=20)}
    counters = {getattr(c, "__name__", f"counter {i}"): c
                for i, c in enumerate(launch_count.COUNTERS)}
    before = {k: c.launches for k, c in counters.items()}
    protocol._rows_encode(enc, x)
    torch.cuda.synchronize()
    rec["launches"] = {k: c.launches - before[k] for k, c in counters.items()
                       if c.launches != before[k]}
    return rec


if __name__ == "__main__":
    sys.exit(main())
