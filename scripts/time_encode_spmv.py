"""Device time of the expander-SpMV launches of one Brakedown encode, for any
checkout of the port.

    python3 scripts/time_encode_spmv.py [--repo DIR] [--label NAME]

Imports lcpc_tpu_torch from DIR (default: this checkout), builds the 2^23
ft255 CODE3 seed-0 encoding on the card (the chip_smoke.py size), and runs
`encode_rows` once at r = 36 (commit) and once at r = 2 (verify) on random
rows, recording every `spmv_mont` call it makes.  Each recorded call is then
timed alone with kernel_bench.time_kernel (10 launches queued behind a
sleeping kernel, CUDA events), and the whole `encode_rows` the same way.
The recording works with any version of the port whose encode_rows calls
`encodings.brakedown.spmv_mont`, whatever that wrapper's operands, so two
commits are timed by one method: unpack the other into a gitignored
directory (`git archive`) and run them in one call on one card, in the
order A, B, B, A.  Prints the card line first and one JSON line last.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))

N_COEFFS = 1 << 23
SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(_HERE),
                    help="checkout whose lcpc_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the result")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.repo)]

    import torch

    import kernel_bench as kb

    if not torch.cuda.is_available():
        raise RuntimeError("time_encode_spmv.py needs a CUDA device")
    P = importlib.import_module("lcpc_tpu_torch")
    bd = importlib.import_module("lcpc_tpu_torch.encodings.brakedown")
    if not P.__file__.startswith(os.path.abspath(args.repo)):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {args.repo}")
    card = kb.card_line()
    print(card, flush=True)

    spec = P.FT255
    enc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device="cuda")
    enc.device_mats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    launch = bd.spmv_mont
    result = {"label": args.label, "repo": os.path.abspath(args.repo), "card": card}
    for r in (36, 2):
        rows = kb.random_mont(spec, (enc.n_per_row, spec.w16, r), gen).permute(1, 2, 0)
        rows = rows.contiguous()                          # (W, R, n_per_row)
        calls = []

        def record(*a, **k):
            calls.append((a, k))
            return launch(*a, **k)

        bd.spmv_mont = record
        try:
            enc.encode_rows(rows)
        finally:
            bd.spmv_mont = launch
        level_ms = [kb.time_kernel(lambda: launch(*a, **k)) for a, k in calls]
        encode_ms = kb.time_kernel(lambda: enc.encode_rows(rows), reps=5)
        result[f"r{r}"] = {"launches": len(calls), "spmv_ms": sum(level_ms),
                           "level_ms": level_ms, "encode_rows_ms": encode_ms}
        print(f"{args.label} r={r}: {len(calls)} spmv_mont launches, {sum(level_ms):.4f} ms "
              f"in all ({' '.join(f'{t:.4f}' for t in level_ms)}); encode_rows "
              f"{encode_ms:.4f} ms", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
