"""Device time of one `ntt_forward` at the 2^23 Ligero shapes, for any
checkout of the port.

    python3 scripts/time_ntt.py [--repo DIR] [--label NAME] [--sweep] [--parts]

Imports lcpc_tpu_torch from DIR (default: this checkout) and times, with
kernel_bench.time_kernel (10 calls queued behind a sleeping kernel, CUDA
events), on random ft255 rows:
  - `ntt_forward(plan, x)` at the commit shape (R = 256 rows of 32,768
    padded to n = 2^17) and at the verify shape (R = 2): every launch and
    layout copy of the call;
  - the commit's encode with its column-hash words: `ntt_forward(plan, x,
    canon_words=True)` where the wrapper has it, else `ntt_forward`, then
    `from_mont` and `_pack_words` (what the commit ran before the NTT wrote
    the words).
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
    fused = "canon_words" in inspect.signature(nttm.ntt_forward).parameters
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
                words = lambda: nttm.ntt_forward(plan, x, canon_words=True)  # noqa: E731
            else:
                words = lambda: protocol._pack_words(  # noqa: E731
                    ops.from_mont(nttm.ntt_forward(plan, x)))
            rec["with_words_ms"] = kb.time_kernel(words, reps=5)
            if args.sweep:
                rec["sweep"] = []
                for kw in SWEEP:
                    alt = nttm.NttPlan(spec, enc.n_cols, **kw)
                    ms = kb.time_kernel(lambda: nttm.ntt_forward(alt, x, canon_words=True))
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
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
