"""Time the expander-SpMV kernel at every lane split on the 2^23 levels.

    python3 scripts/sweep_spmv_lanes.py

ft255, CODE3, seed 0, N = 2^23 (the chip_smoke.py size), one GPU.  For each
of the 13 levels at r = 36 (commit) and r = 2 (verify), times the kernel
with S = 1, 2, .., 32 lanes per (output, r) (device time, launches queued
behind a sleeping kernel) and marks the split that `split_lanes` picks;
at that split it also times the kernel with every column index set to 0
("cols=0": every gather reads one L1-resident element), which leaves the
arithmetic and the per-output work and takes the gathers' memory traffic
away.
Also writes the SASS of the W32 = 8 k loop to chiprun_out/spmv_sass_loop.txt
(cuobjdump).  Prints one JSON line last; the full table goes to
chiprun_out/sweep_spmv_lanes.json.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402
import lcpc_tpu_torch as P  # noqa: E402
from lcpc_tpu_torch.ops import spmv  # noqa: E402

LANES = (1, 2, 4, 8, 16, 32)
N_COEFFS = 1 << 23
SEED = 0


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_spmv_lanes.py needs a CUDA device")
    card = kb.card_line()
    print(card, flush=True)
    spmv.build(force=True)
    out_dir = os.path.join(_REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    loop = kb.sass_loop(spmv.SO_PATH)
    if loop is not None:
        print(f"SASS W32=8 k loop: {loop[0]} instructions, {loop[2]:.3f} per wide "
              f"product; opcodes {loop[1]}", flush=True)
        with open(os.path.join(out_dir, "spmv_sass_loop.txt"), "w") as f:
            f.write("\n".join(loop[3]) + "\n")
    spec = P.FT255
    enc = P.SdigEncoding.new(spec, N_COEFFS, seed=SEED, device="cuda")
    pre, post, rs = enc.device_mats()
    levels = ([(f"pre{i}", dm) for i, dm in enumerate(pre)] + [("rs", rs)]
              + [(f"post{i}", dm) for i, dm in enumerate(post)])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, totals = [], {}
    for r in (36, 2):
        pick_sum, best_sum, no_gather_sum = 0.0, 0.0, 0.0
        for name, dm in levels:
            x = kb.random_packed(spmv, spec, dm.n_in, r, gen)
            ms = {s: kb.time_kernel(lambda: spmv.spmv_mont(spec, x, dm, _lanes=s))
                  for s in LANES}
            pick = spmv.split_lanes(dm.n_out, r, dm.nnz, n_sm)
            best = min(ms, key=ms.get)
            cols0 = spmv.RaggedCsr(dm.n_in, dm.row_ptr, torch.zeros_like(dm.cols), dm.vals)
            no_gather = kb.time_kernel(lambda: spmv.spmv_mont(spec, x, cols0, _lanes=pick))
            pick_sum += ms[pick]
            best_sum += ms[best]
            no_gather_sum += no_gather
            rows.append({"r": r, "level": name, "n_out": dm.n_out, "nnz": dm.nnz,
                         "pick": pick, "best": best, "ms": ms, "cols0_ms": no_gather})
            print(f"r={r:>2} {name:>6} n_out={dm.n_out:>6} nnz={dm.nnz:>8} pick S={pick:>2} "
                  f"best S={best:>2}: " + " ".join(f"{s}:{t:.4f}" for s, t in ms.items())
                  + f" | cols=0 at S={pick}: {no_gather:.4f}", flush=True)
        totals[r] = {"picked_ms": pick_sum, "best_ms": best_sum, "cols0_ms": no_gather_sum}
        print(f"r={r}: sum at the picked split {pick_sum:.4f} ms, at the best {best_sum:.4f} "
              f"ms, with cols=0 {no_gather_sum:.4f} ms", flush=True)
    with open(os.path.join(out_dir, "sweep_spmv_lanes.json"), "w") as f:
        json.dump({"card": card, "levels": rows, "totals": totals}, f, indent=1)
    print(json.dumps({"card": card, "totals": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
