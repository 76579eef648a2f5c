"""End-to-end times of one checkout of the port on one GPU, for comparing two
commits in one call.

    python3 scripts/time_paths.py [--repo DIR] [--label NAME] [--reps N]
                                  [--paths NAME,...] [--digest blake3|sha256]

Imports lcpc_tpu_torch from DIR (default: this checkout), so an older commit
unpacked into the gitignored archive/ is timed by the same method:
run parent, change, change, parent in one call.  ft255, seed 0, BLAKE3
(--digest sha256 for the 2^23 paths); --paths picks some of them (default
all but sdig_2_23); each trace counts the CUDA events torch.profiler saw
and, exactly, the launches of every kernel wrapper of the checkout's
lcpc_tpu_torch.ops (its .launches):

  - ligero_2_23: Ligero rho = 1/4 at 2^23 (commit -> prove -> verify): one
    cold run, then the median and the least of N warm runs (host clock
    around synchronized calls; single runs spread with the shared host),
    and a torch.profiler trace of one commit, one prove and one verify
    (kernel launches, device busy, idle share);
  - sdig_2_23: Brakedown CODE3 at 2^23, the same runs and traces;
  - ligero_2_26_nokeep: Ligero rho = 1/4 at 2^26 through commit_streaming
    with no hash words kept (spill="none", chip_smoke.py phase 8's route
    (c): prove opens the columns without the codeword), then prove and
    verify: one cold run and the median and the least of 5 warm runs;
  - ligero_2_28: Ligero rho = 1/4 at 2^28 through commit_streaming (packed
    coefficients made on the card), then prove and verify: one cold run
    and the median and the least of 2 warm runs, and a trace of one verify;
  - ligero_2_29_seeded: seeded Ligero rho = 1/4 at 2^29 (SeededCoeffSource,
    seed 0, no hash words kept: prove evaluates the opened columns
    directly): one commit, then prove 3 times (the first cold) and verify
    once.

Then ptxas's registers and spills of every mont_dot, power_table and
mont_map template the checkout built.  Prints one JSON line last and writes
chiprun_out/time_paths_<label>.json.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402


PATHS = ("sdig_2_23", "ligero_2_23", "ligero_2_26_nokeep", "ligero_2_28", "ligero_2_29_seeded")


def synced(fn):
    """(result, host ms) of one call ending in synchronize()."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


COUNTERS = {}  # the checkout's kernel wrappers by name, each with its .launches


def find_counters():
    """Every kernel wrapper of the checkout's lcpc_tpu_torch.ops that counts
    its launches (a callable with an int .launches), by name."""
    import pkgutil
    ops = importlib.import_module("lcpc_tpu_torch.ops")
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"lcpc_tpu_torch.ops.{info.name}")
        for name, obj in vars(mod).items():
            if (callable(obj) and isinstance(getattr(obj, "launches", None), int)
                    and getattr(obj, "__module__", None) == mod.__name__):
                COUNTERS[f"{info.name}.{name}"] = obj


def trace(fn):
    """One synchronized call under torch.profiler: wall, device busy, the
    CUDA events the trace saw (a lower bound: it can miss some), the port's
    kernel launches by wrapper (exact), idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for c in COUNTERS.values():
        c.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = synced(fn)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    port = {k: c.launches for k, c in COUNTERS.items() if c.launches}
    return {"wall_ms": wall, "device_busy_ms": busy, "launches": len(kernels),
            "port_launches": port, "port_launches_total": sum(port.values()),
            "idle_share": max(0.0, 1 - busy / wall) if wall else None}


def packed_coeffs(spec, n, gen, block=1 << 26):
    """n random elements (< p) as packed (W/2, n) int32 Montgomery words on the
    card (random 16-bit limbs, the top one below p's)."""
    w32, top = spec.w16 // 2, spec.p >> (16 * (spec.w16 - 1))
    out = torch.empty((w32, n), dtype=torch.int32, device="cuda")
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        out[:, i0:i1] = torch.randint(-2**31, 2**31, (w32, i1 - i0), generator=gen,
                                      device="cuda", dtype=torch.int32)
        hi = torch.randint(0, top, (i1 - i0,), generator=gen, device="cuda", dtype=torch.int32)
        out[-1, i0:i1] = (out[-1, i0:i1] & 0xFFFF) | (hi << 16)
    return out


def run_path(P, enc, commit, outer, inner, reps, digest=None):
    """Cold run, then `reps` warm runs of commit -> prove -> verify; returns
    the per-run (commit, prove, verify) ms and the last run's objects."""
    def transcript(root):
        tr = P.Transcript(b"time paths")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr

    runs = []
    for _ in range(reps + 1):
        comm = proof = None  # the last run's state goes before the next commit allocates
        torch.cuda.empty_cache()
        comm, c_ms = synced(commit)
        root = comm.get_root()
        proof, p_ms = synced(lambda: comm.prove(outer, transcript(root)))
        kw = {} if digest is None else {"digest": digest}
        value, v_ms = synced(lambda: proof.verify(root, outer, inner, enc, transcript(root),
                                                  **kw))
        runs.append((c_ms, p_ms, v_ms))
    verify = lambda: proof.verify(root, outer, inner, enc, transcript(root), **kw)  # noqa: E731
    return runs, comm, verify, value


def summary(runs):
    warm = runs[1:]
    return {"cold": runs[0], "warm": warm,
            "median": [statistics.median(r[i] for r in warm) for i in range(3)],
            "min": [min(r[i] for r in warm) for i in range(3)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(_HERE))
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--paths", default="ligero_2_23,ligero_2_26_nokeep,ligero_2_28,"
                    "ligero_2_29_seeded")
    ap.add_argument("--digest", default="blake3", help="the 2^23 paths' digest")
    args = ap.parse_args()
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        raise ValueError(f"unknown paths {sorted(unknown)}; known: {PATHS}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_paths.py needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.repo))
    P = importlib.import_module("lcpc_tpu_torch")
    if not P.__file__.startswith(os.path.abspath(args.repo)):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {args.repo}")
    spmv = importlib.import_module("lcpc_tpu_torch.ops.spmv")
    find_counters()
    digest = P.DIGESTS_BY_NAME[args.digest]
    card = kb.card_line()
    spec = P.FT255
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    result = {"label": args.label, "repo": os.path.abspath(args.repo), "card": card,
              "digest": args.digest, "values": {}}

    # the 2^23 paths, in memory
    for name in ("sdig_2_23", "ligero_2_23"):
        if name not in paths:
            continue
        n = 1 << 23
        if name == "sdig_2_23":
            enc = P.SdigEncoding.new(spec, n, seed=0, device="cuda")
        else:
            enc = P.LigeroEncoding.new(spec, n, 1, 4)
        coeffs = spmv.unpack_words(packed_coeffs(spec, n, gen), 0)  # (W, n) Montgomery limbs
        n_rows = -(-n // enc.n_per_row)
        outer, inner = P.univariate_tensors(spec, 0x5EED, enc.n_per_row, n_rows)
        commit = lambda: P.commit(coeffs, enc, digest=digest)  # noqa: E731
        runs, comm, verify, value = run_path(P, enc, commit, outer, inner, args.reps, digest)
        root = comm.get_root()
        tr = P.Transcript(b"time paths")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        result[name] = summary(runs)
        result[name]["traces"] = {"commit": trace(commit),
                                  "prove": trace(lambda: comm.prove(outer, tr)),
                                  "verify": trace(verify)}
        result["values"][name] = value % (1 << 64)
        del comm, verify, coeffs, enc
        torch.cuda.empty_cache()
    if "ligero_2_26_nokeep" in paths:
        run_2_26(P, spec, gen, result)
    if "ligero_2_28" in paths:
        run_2_28(P, spec, gen, result)
    if "ligero_2_29_seeded" in paths:
        run_2_29(P, spec, result, args.label)

    # the kernels this checkout built: registers and spills of every template
    cb = importlib.import_module("lcpc_tpu_torch.utils.cuda_build")
    result["ptxas"] = {name: {k: list(v) for k, v in
                              kb.ptxas_entries(cb.build_logs.get(name, ""), kname).items()}
                       for name, kname in (("mont_dot", "mont_dot_"), ("power_table", "power_"),
                                           ("mont_map", "map_kernel"))}
    for name, ents in result["ptxas"].items():
        for k, (regs, st, ld) in sorted(ents.items()):
            print(f"{args.label} ptxas {k}: {regs} registers, {st} / {ld} bytes spill", flush=True)

    summed = [name for name in PATHS if name in paths and "traces" in result[name]]
    for name in summed:
        r = result[name]
        log = ", ".join(f"{k} {v['launches']} CUDA events, {v['port_launches_total']} port "
                        f"launches {v['port_launches']}, busy {v['device_busy_ms']:.2f} of "
                        f"{v['wall_ms']:.1f} ms, idle {v['idle_share']:.3f}"
                        for k, v in r["traces"].items())
        print(f"{args.label} {name}: commit / prove / verify median "
              f"{' / '.join(f'{x:.2f}' for x in r['median'])} ms (least "
              f"{' / '.join(f'{x:.2f}' for x in r['min'])}; cold "
              f"{' / '.join(f'{x:.1f}' for x in r['cold'])}); traces: {log}", flush=True)
    out_dir = os.path.join(os.path.dirname(_HERE), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"time_paths_{args.label}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("label", "card", "values")}
                     | {name: result[name]["median"] for name in summed}
                     | {f"{name}_launches": {k: (v["launches"], v["port_launches_total"])
                                             for k, v in result[name]["traces"].items()}
                        for name in summed}
                     | ({"ligero_2_29_seeded_prove_ms": result["ligero_2_29_seeded"]["prove_ms"]}
                        if "ligero_2_29_seeded" in paths else {})))
    return 0


def run_2_26(P, spec, gen, result):
    """Ligero 2^26, streamed, no words kept."""
    n = 1 << 26
    enc = P.LigeroEncoding.new(spec, n, 1, 4)
    coeffs = packed_coeffs(spec, n, gen)
    n_rows = -(-n // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, 0x5EED, enc.n_per_row, n_rows)
    runs, comm, verify, value = run_path(
        P, enc, lambda: P.commit_streaming(coeffs, enc, spill="none"), outer, inner, 5)
    if comm.words_dev is not None or comm.words_host is not None:
        raise AssertionError("the 2^26 spill='none' commit kept words")
    result["ligero_2_26_nokeep"] = summary(runs)
    result["ligero_2_26_nokeep"]["traces"] = {}
    result["values"]["ligero_2_26_nokeep"] = value % (1 << 64)
    del comm, verify, coeffs
    torch.cuda.empty_cache()


def run_2_28(P, spec, gen, result):
    """Ligero 2^28, streamed."""
    n = 1 << 28
    enc = P.LigeroEncoding.new(spec, n, 1, 4)
    coeffs = packed_coeffs(spec, n, gen)
    n_rows = -(-n // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, 0x9E3779B97F4A7C15, enc.n_per_row, n_rows)
    runs, comm, verify, value = run_path(
        P, enc, lambda: P.commit_streaming(coeffs, enc), outer, inner, 2)
    result["ligero_2_28"] = summary(runs)
    result["ligero_2_28"]["traces"] = {"verify": trace(verify)}
    result["values"]["ligero_2_28"] = value % (1 << 64)
    del comm, verify, coeffs
    torch.cuda.empty_cache()


def run_2_29(P, spec, result, label):
    """Seeded Ligero 2^29, no words kept: one commit, prove 3 times, verify
    once."""
    n = 1 << 29
    enc = P.LigeroEncoding.new(spec, n, 1, 4)
    src = P.SeededCoeffSource(spec, n, seed=0, device="cuda")
    n_rows = -(-n // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, 0x243F6A8885A308D3, enc.n_per_row, n_rows)
    torch.cuda.empty_cache()
    comm, c_ms = synced(lambda: P.commit_streaming(src, enc))
    if comm.words_dev is not None or comm.words_host is not None:
        raise AssertionError("the 2^29 commit kept words")
    root = comm.get_root()

    def transcript():
        tr = P.Transcript(b"time paths")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr

    proves = []
    for _ in range(3):
        proof, p_ms = synced(lambda: comm.prove(outer, transcript()))
        proves.append(p_ms)
    value, v_ms = synced(lambda: proof.verify(root, outer, inner, enc, transcript()))
    result["ligero_2_29_seeded"] = {"commit_ms": c_ms, "prove_ms": proves, "verify_ms": v_ms,
                                    "prove_median_warm": statistics.median(proves[1:])}
    result["values"]["ligero_2_29_seeded"] = value % (1 << 64)
    del comm, proof, src
    torch.cuda.empty_cache()
    print(f"{label} ligero_2_29_seeded: commit {c_ms:.1f} ms (cold), prove "
          f"{' / '.join(f'{x:.1f}' for x in proves)} ms (first cold), verify {v_ms:.1f} ms",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
