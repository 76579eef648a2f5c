#!/usr/bin/env python3
"""The four-step NTT's kernel (csrc/mxu_ntt.cu, ops/mxu_ntt.py) alone on one GPU.

    python3 scripts/time_mxu_ntt.py

Builds csrc/mxu_ntt.cu with the ladder's kernels beside it, prints ptxas's
registers and spills of every mxu_dft_kernel template, then runs
chip_smoke.py phase 20's kernel half (chip_smoke.mxu_kernel_phase): the
kernel against mxu_ntt_plain in every field, against the ladder at the
2^23 Ligero commit's transform (ft255, 256 x 2^17 from 2^15) and verify's
(2 rows of words in), both routes timed warm and cold in turns ladder,
mxu, mxu, ladder beside the bound, the two launches apart.  Writes
chiprun_out/time_mxu_ntt.json and prints it as the last line.  ~1 min;
needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_mxu_ntt: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import chip_smoke
    import kernel_bench as kb
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.ops import ntt as nttm
    from lcpc_tpu_torch.utils import cuda_build

    card = kb.card_line()
    print(card, f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["mxu_ntt", "ntt_mont", "mont_map", "mont_dot"], force=True)
    print(f"build {secs} ({time.perf_counter() - t0:.1f} s wall)", flush=True)
    ptxas = {k: v for k, v in kb.ptxas_entries(cuda_build.build_logs["mxu_ntt"],
                                                "mxu_dft_kernel").items()}
    stack = kb.ptxas_stack(cuda_build.build_logs["mxu_ntt"], "mxu_dft_kernel")
    for name, (regs, st, ld) in sorted(ptxas.items()):
        print(f"  ptxas {name}: {regs} registers, {st} / {ld} bytes spilled, "
              f"{stack.get(name, 0)} bytes stack", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    out = chip_smoke.mxu_kernel_phase(torch, kb, P, nttm, card, gen)
    out.update(card=card, ptxas=ptxas, stack=stack)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_mxu_ntt.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
