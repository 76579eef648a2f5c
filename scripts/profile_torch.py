"""Where the time goes in one of the port's main paths on one GPU.

    python3 scripts/profile_torch.py [sdig|ligero]

ft255, BLAKE3 at N = 2^23 (the chip_smoke.py size): Brakedown CODE3
(sdig, the default) or Ligero rho = 1/4 (ligero).
After one warm-up commit -> prove -> verify it reports:
  - stage times (host clock around synchronized work, median of 3) for the
    pieces of commit (sdig: encode, from_mont, pack; ligero: the encode
    with its hash words from the NTT, their u32 form; then the column hash
    and the Merkle layers),
    prove (device collapse, everything else) and verify (row encode, the
    opened columns' hash, eval dot, everything else);
  - per phase, a torch.profiler trace: wall ms, device-busy ms (sum of GPU
    kernel time), kernel launches, idle share, and the top kernels;
  - per phase, a cProfile of the host side: the functions with the most
    own time (tottime), i.e. where the host holds the device back.
Writes chiprun_out/profile_torch_<path>.json; prints one JSON line last.
Needs a CUDA device (raises without one).
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lcpc_tpu_torch as P  # noqa: E402
from lcpc_tpu_torch.core import protocol  # noqa: E402
from lcpc_tpu_torch.ops import blake3  # noqa: E402
from lcpc_tpu_torch.ops.limbs import get_ops  # noqa: E402

LOG_N = 23


def timed(fn, reps=3):
    """(result, median ms) over reps synchronized calls."""
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def trace(fn):
    """Profile one synchronized call: wall, device-busy, launches, top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3  # us -> ms
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall, "device_busy_ms": busy, "launches": len(kernels),
            "idle_share": max(0.0, 1 - busy / wall) if wall else None,
            "top": [{"kernel": k[:90], "launches": n, "ms": t} for k, (n, t) in top]}


def host_profile(fn, top=10):
    """cProfile one synchronized call: functions by own host time (ms)."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats  # {(file, line, name): (cc, nc, tt, ct, callers)}
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"function": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", "calls": v[1],
             "own_ms": v[2] * 1e3, "cum_ms": v[3] * 1e3} for k, v in rows]


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "sdig"
    if path not in ("sdig", "ligero"):
        raise SystemExit("usage: profile_torch.py [sdig|ligero]")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    spec, n = P.FT255, 1 << LOG_N
    ops = get_ops(spec)
    if path == "sdig":
        enc = P.SdigEncoding.new(spec, n, seed=0, device="cuda")
        enc.device_mats()
    else:
        enc = P.LigeroEncoding.new(spec, n, 1, 4, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    canon = torch.randint(0, 1 << 16, (spec.w16, n), generator=gen, device="cuda",
                          dtype=torch.int32)
    canon[-1] = torch.randint(0, spec.p >> (16 * (spec.w16 - 1)), (n,), generator=gen,
                              device="cuda", dtype=torch.int32)
    coeffs = ops.to_mont(canon)
    n_rows = -(-n // enc.n_per_row)
    outer, inner = P.univariate_tensors(spec, 123456789, enc.n_per_row, n_rows)

    def transcript(root):
        tr = P.Transcript(b"profile")
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr

    comm = P.commit(coeffs, enc)
    root = comm.get_root()
    proof = comm.prove(outer, transcript(root))
    proof.verify(root, outer, inner, enc, transcript(root))

    # commit stages
    stages = {}
    mat = comm.coeffs
    if path == "sdig":  # encode_rows_words' default: encode, from_mont, pack
        cw, stages["commit.encode_rows"] = timed(lambda: enc.encode_rows(mat))
        canon_cw, stages["commit.from_mont"] = timed(lambda: ops.from_mont(cw))
        words, stages["commit.pack_words"] = timed(lambda: protocol._pack_words(canon_cw))
        del canon_cw
    else:  # the NTT's last pass writes the hash words
        (cw, words32), stages["commit.encode_rows_words"] = timed(
            lambda: enc.encode_rows_words(mat))
        words, stages["commit.words_to_u32"] = timed(lambda: protocol._u32(words32))
        del words32
    leaves, stages["commit.hash_columns"] = timed(lambda: blake3.hash_word_columns(words))
    np2 = protocol._next_pow2(comm.n_cols)
    padded = torch.nn.functional.pad(leaves, (0, np2 - comm.n_cols))

    def merkle():
        layer = padded
        while layer.shape[1] > 1:
            layer = blake3.merkle_layer(layer)
        return layer

    _, stages["commit.merkle_layers"] = timed(merkle)
    _, stages["commit.total"] = timed(lambda: P.commit(coeffs, enc))
    del cw, words

    # prove stages: the degree-test + eval collapse on the device
    ts = torch.from_numpy(
        np.stack([ops.encode_host(outer)] * 2, axis=1).astype(np.int32)).cuda()
    _, stages["prove.collapse_words(T=2)"] = timed(
        lambda: ops.collapse_words(ts, comm.coeffs).cpu())
    _, stages["prove.total"] = timed(lambda: comm.prove(outer, transcript(root)))

    # verify stages
    rows_w = torch.randint(0, 1 << 16, (2, enc.n_per_row, spec.w16 // 2),
                           generator=gen, device="cuda", dtype=torch.int64)
    _, stages["verify.rows_encode(T=2)"] = timed(lambda: protocol._rows_encode(enc, rows_w))
    k = enc.get_n_col_opens()
    col_words = torch.randint(0, 1 << 32, (comm.n_rows * spec.w16 // 2, k), generator=gen,
                              device="cuda", dtype=torch.int64)
    _, stages[f"verify.hash_opened_columns(k={k})"] = timed(
        lambda: blake3.hash_word_columns(col_words))
    inner_w = torch.from_numpy(ops.encode_repr_words(inner).astype("int64")).cuda()
    _, stages["verify.eval_dot"] = timed(lambda: protocol._eval_dot(ops, rows_w, inner_w))
    _, stages["verify.total"] = timed(
        lambda: proof.verify(root, outer, inner, enc, transcript(root)))

    traces = {
        "commit": trace(lambda: P.commit(coeffs, enc)),
        "prove": trace(lambda: comm.prove(outer, transcript(root))),
        "verify": trace(lambda: proof.verify(root, outer, inner, enc, transcript(root))),
    }
    host = {
        "commit": host_profile(lambda: P.commit(coeffs, enc)),
        "prove": host_profile(lambda: comm.prove(outer, transcript(root))),
        "verify": host_profile(
            lambda: proof.verify(root, outer, inner, enc, transcript(root))),
    }
    for k, v in stages.items():
        print(f"{k:32s} {v:10.2f} ms", flush=True)
    for phase, t in traces.items():
        print(f"{phase}: wall {t['wall_ms']:.1f} ms, device busy {t['device_busy_ms']:.1f} ms, "
              f"{t['launches']} launches, idle share {t['idle_share']:.3f}", flush=True)
        for row in t["top"]:
            print(f"   {row['ms']:9.2f} ms  x{row['launches']:<6} {row['kernel']}", flush=True)
        print("  host, by own time (cProfile on, so inflated):", flush=True)
        for row in host[phase]:
            print(f"   {row['own_ms']:9.2f} ms own {row['cum_ms']:9.2f} ms cum "
                  f"x{row['calls']:<7} {row['function']}", flush=True)
    result = {"card": card, "path": path, "log_n": LOG_N, "stages_ms": stages, "traces": traces,
              "host": host}
    out_dir = os.path.join(_REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_torch_{path}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "path": path, "stages_ms": stages,
                      "idle_share": {k: v["idle_share"] for k, v in traces.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
