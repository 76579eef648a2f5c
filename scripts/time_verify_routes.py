"""Verify's two routes on one GPU, for the gate protocol.VERIFY_COLS_MIN:
Ligero ft255 rho = 1/4 with BLAKE3 at n_cols = 2^15 .. 2^20.

    python3 scripts/time_verify_routes.py [--logs 19,21,23,25,28,29] [--reps 5]

Each size commits and proves once (2^19, 2^21, 2^23 and 2^25 coefficients
in memory: 2^15, 2^16, 2^17 and 2^18 columns; 2^28 streamed from packed
coefficients made on the card, the words kept: 2^19 columns; 2^29 seeded,
no words kept: 2^20 columns), then verifies the proof by each route,
forced through protocol.VERIFY_COLS_MIN (0: the rows evaluated at the
opened columns, MxuColumnEval's power table and the tile mont_dot; beyond
every size: the rows encoded at full width, the NTT), after one warm-up
each, in turns (columns, encode, encode, columns, ...), `--reps` of each:
  - each verify's host wall (host clock around a call ending in
    synchronize()); both routes must accept and return the same value;
  - one torch.profiler trace of a verify by each route: device busy and
    kernel launches;
  - the route's own piece alone on the same shapes (random proof rows):
    columns = set_columns + to_mont + eval_block, encode = _rows_encode +
    the opened columns' gather and from_mont, host wall (synchronized) and
    CUDA events around back-to-back calls (the host's work between the
    launches included).
Prints one JSON line last and writes chiprun_out/time_verify_routes.json.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE, _ROOT]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

OFF = 1 << 62  # a gate no size reaches: the encode route
DEV = "cuda"    # the card (a CPU rehearsal sets "cpu")


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def trace(fn):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = synced(fn)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"wall_ms": wall, "device_busy_ms": sum(e.device_time_total for e in kernels) / 1e3,
            "launches": len(kernels)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--logs", default="19,21,23,25,28,29")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_verify_routes.py needs a CUDA device")
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.core import protocol
    from lcpc_tpu_torch.ops.mont_map import mont_mul_map
    from lcpc_tpu_torch.ops.mxu_prove import MxuColumnEval
    from lcpc_tpu_torch.ops.spmv import pack_words, unpack_words
    from lcpc_tpu_torch.utils import cuda_build

    card = kb.card_line()
    cuda_build.build_all(["ntt_mont", "blake3_cols", "mont_dot", "power_table", "mont_map",
                          "seeded_gen"])
    spec = P.FT255
    gen = torch.Generator(device=DEV).manual_seed(0)
    result = {"card": card, "gate": protocol.VERIFY_COLS_MIN, "sizes": {}}

    def packed(n):
        limbs = kb.random_mont(spec, (1, spec.w16, n), gen, device=DEV)[0]
        return pack_words(limbs, 0)

    for log_n in (int(x) for x in args.logs.split(",")):
        n = 1 << log_n
        enc = P.LigeroEncoding.new(spec, n, 1, 4, device=DEV)
        n_rows = -(-n // enc.n_per_row)
        outer, inner = P.univariate_tensors(spec, 0x5EED + log_n, enc.n_per_row, n_rows)
        torch.cuda.empty_cache()
        if log_n <= 25:
            how = "in memory"
            commit = lambda: P.commit(unpack_words(packed(n), 0), enc)  # noqa: E731
        elif log_n == 28:
            how = "streamed, words kept"
            coeffs = packed(n)
            commit = lambda: P.commit_streaming(coeffs, enc)  # noqa: E731
        else:
            how = "seeded, no words kept"
            src = P.SeededCoeffSource(spec, n, seed=0, device=DEV)
            commit = lambda: P.commit_streaming(src, enc)  # noqa: E731
        comm, c_ms = synced(commit)
        root = comm.get_root()

        def transcript():
            tr = P.Transcript(b"verify routes")
            tr.append_message(b"polycommit", root)
            tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
            return tr

        proof, p_ms = synced(lambda: comm.prove(outer, transcript()))
        del comm
        torch.cuda.empty_cache()

        def verify(gate):
            protocol.VERIFY_COLS_MIN = gate
            try:
                return proof.verify(root, outer, inner, enc, transcript())
            finally:
                protocol.VERIFY_COLS_MIN = result["gate"]

        value = {"cols": synced(lambda: verify(0))[0], "encode": synced(lambda: verify(OFF))[0]}
        if value["cols"] != value["encode"]:
            raise AssertionError(f"2^{log_n}: the routes' values differ")
        walls = {"cols": [], "encode": []}
        for i in range(args.reps):
            for route in (("cols", "encode") if i % 2 == 0 else ("encode", "cols")):
                v, ms = synced(lambda: verify(0 if route == "cols" else OFF))
                if v != value[route]:
                    raise AssertionError(f"2^{log_n} {route}: the value changed")
                walls[route].append(ms)
        traces = {"cols": trace(lambda: verify(0)), "encode": trace(lambda: verify(OFF))}
        # the routes' own pieces on random proof rows of this shape
        limbs = kb.random_mont(spec, (2, spec.w16, enc.n_per_row), gen, device=DEV)
        rows = pack_words(limbs.permute(1, 0, 2), 0).permute(1, 2, 0).contiguous()  # (T, npr, W/2)
        cols = [random.Random(log_n).randrange(enc.n_cols) for _ in range(enc.get_n_col_opens())]
        idx = torch.tensor(cols, device=DEV)

        def piece_cols():
            ev = MxuColumnEval(enc)
            ev.set_columns(cols)
            rows_m = mont_mul_map(spec, rows.permute(2, 0, 1), op="to_mont", in_form="words",
                                  out_form="words")
            return ev.eval_block(rows_m, in_form="packed")

        def piece_encode():
            enc_rows = protocol._rows_encode(enc, rows)
            return mont_mul_map(spec, enc_rows.index_select(2, idx), op="from_mont",
                                out_form="words")

        pieces = {}
        for route, fn in (("cols", piece_cols), ("encode", piece_encode)):
            fn()
            hw = sorted(synced(fn)[1] for _ in range(7))
            pieces[route] = {"host_ms_median": hw[3], "host_ms": hw,
                             "device_ms": kb.time_kernel(fn, reps=5)}
        med = {r: statistics.median(w) for r, w in walls.items()}
        rec = {"n_cols": enc.n_cols, "n_per_row": enc.n_per_row, "commit": how,
               "commit_ms": c_ms, "prove_ms": p_ms, "verify_ms": walls,
               "verify_ms_median": med, "traces": traces, "pieces": pieces}
        result["sizes"][log_n] = rec
        print(f"2^{log_n} ({enc.n_cols} columns, {how}): verify median cols {med['cols']:.2f} ms, "
              f"encode {med['encode']:.2f} ms (runs {walls}); busy cols "
              f"{traces['cols']['device_busy_ms']:.3f} ms in {traces['cols']['launches']} "
              f"launches, encode {traces['encode']['device_busy_ms']:.3f} ms in "
              f"{traces['encode']['launches']}; pieces: cols host "
              f"{pieces['cols']['host_ms_median']:.3f} ms / device "
              f"{pieces['cols']['device_ms']:.4f} ms, encode host "
              f"{pieces['encode']['host_ms_median']:.3f} / device "
              f"{pieces['encode']['device_ms']:.4f} ms; {card}", flush=True)
        del proof
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "time_verify_routes.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
