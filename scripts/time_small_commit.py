"""The commit's two routes on one GPU, for the gates protocol._FUSED_COMMIT_MAX:
Ligero ft255 rho = 1/4 and Brakedown CODE3 ft255 commits at 2^N coefficients,
staged (every stage launched from Python) against the small commit's kernel
(one launch of csrc/commit_small.cu).

    python3 scripts/time_small_commit.py [--logs 11,12,...,23] [--reps 16]
        [--encodings ligero,sdig] [--trace 13,16] [--profile]
        [--parent archive/parent]

Each size makes a fresh encoding and random Montgomery coefficients on the
card and commits through the public entry point (protocol.commit), the route
forced through protocol._FUSED_COMMIT_MAX (0 for every encoding: staged;
past every size: the kernel), BLAKE3 at every size and SHA-256 at the first
and the last:
  - the first commit on a fresh encoding by each route (its device tables
    and, for Brakedown, its matrices made there; the kernels built before),
    host ms, and the launches it counted (the kernel route: one);
  - both routes' roots, Merkle arrays, codewords and matrices equal;
  - host wall (a host clock around a commit that ends in synchronize()),
    the median of --reps warm commits a route, in turns: staged, kernel,
    kernel, staged, --reps / 2 each;
  - device ms by CUDA events (scripts/kernel_bench.py's time_kernel: back
    to back behind a sleeping kernel): the kernel's launch, and the staged
    route's launches;
  - one torch.profiler trace of a warm commit by each route: CUDA kernel
    events and their names, device busy, the idle share (1 - busy / wall);
  - with --trace, at those sizes, the kernel's phases: csrc/commit_small.cu
    with %globaltimer stamps patched in (thread 0 of each block at the
    kernel's start, on both sides of each grid barrier and at its end;
    TRACE_PATCHES) built apart and bound in place of the library for one
    commit: each phase's time to its last block's end and each barrier's
    wait beside;
  - with --profile, cProfile's top functions over 200 warm kernel-route
    commits at the first size (the host's share).
The crossover of each encoding is the largest size whose kernel median is
below the staged median (the gate, capped at lcpc_tpu's 2^22).  Prints one
JSON line last and writes chiprun_out/time_small_commit.json.

With --parent DIR (an older checkout, e.g. `git archive` of the parent
commit), the runs alternate parent, this, this, parent, each a process of
its checkout's own scripts/time_small_commit.py with the same --logs,
--reps and --encodings, and the last line gathers their JSON lines.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE, _ROOT]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

KERNEL = 1 << 62  # a gate every size is under: the kernel route
STAGED = 0        # a gate every size is over: the staged route
CAP = 1 << 22     # lcpc_tpu's gate, the port's ceiling


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
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    names = sorted({e.name[:60] for e in events})
    return {"wall_ms": wall, "device_busy_ms": busy, "cuda_events": len(events),
            "names": names, "idle_share": 1 - busy / wall if wall else None}


def make_encoding(P, name, spec, n):
    if name == "ligero":
        return P.LigeroEncoding.new(spec, n, 1, 4, device="cuda")
    return P.SdigEncoding.new(spec, n, seed=0, device="cuda")


def counted(counters, fn):
    for c in counters:
        c.launches = 0
    out, ms = synced(fn)
    return out, ms, sum(c.launches for c in counters)


# %globaltimer stamps for --trace, patched into a copy of csrc/commit_small.cu
# at these anchors (each found once): thread 0 of each block stamps the
# kernel's start, both sides of every grid barrier and the kernel's end into
# (TRACE_BLOCKS, TRACE_SLOTS) slots; lcpc_commit_small_trace reads them back
# and clears them.
TRACE_BLOCKS, TRACE_SLOTS = 1024, 64
_TRACE_HEAD = f"""
constexpr int kTraceSlots = {TRACE_SLOTS};
constexpr int kTraceBlocks = {TRACE_BLOCKS};
__device__ unsigned long long trace_stamps[kTraceBlocks * kTraceSlots];
__device__ int trace_slot[kTraceBlocks];
__device__ __forceinline__ void stamp() {{
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {{
    const int slot = trace_slot[blockIdx.x]++;
    if (slot < kTraceSlots) {{
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      trace_stamps[blockIdx.x * kTraceSlots + slot] = t;
    }}
  }}
}}
"""
_TRACE_TAIL = """
extern "C" int lcpc_commit_small_trace(unsigned long long* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaStreamSynchronize((cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, trace_stamps, sizeof(trace_stamps));
  static unsigned long long zeros[kTraceBlocks * kTraceSlots];
  static int slot_zeros[kTraceBlocks];
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(trace_stamps, zeros, sizeof(zeros));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(trace_slot, slot_zeros, sizeof(slot_zeros));
  return (int)err;
}
"""
TRACE_PATCHES = (  # (anchor, its replacement, times found)
    ("// a grid barrier: every block's work", _TRACE_HEAD + "// a grid barrier: every block's work",
     1),
    ("void sync_phase(cg::grid_group& grid) { grid.sync(); }",
     "void sync_phase(cg::grid_group& grid) { stamp(); grid.sync(); stamp(); }", 1),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  stamp();\n", 2),  # both kernels' start
    ("    tree_top<typename D::Merkle>(h, s);\n  }\n}\n",
     "    tree_top<typename D::Merkle>(h, s);\n  }\n  stamp();\n}\n", 1),  # the end
)


def build_trace_lib(commit_small, cuda_build):
    """csrc/commit_small.cu with TRACE_PATCHES applied, built apart and bound
    with the package's argtypes and the trace's entry point (raises where
    an anchor is not found as often as listed)."""
    src_dir = os.path.dirname(cuda_build.source_path("commit_small"))
    text = open(cuda_build.source_path("commit_small")).read()
    for anchor, new, times in TRACE_PATCHES:
        if text.count(anchor) != times:
            raise RuntimeError(f"trace: anchor found {text.count(anchor)} times: {anchor!r}")
        text = text.replace(anchor, new)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "commit_small_trace.cu")
    so = os.path.join(cuda_build.BUILD_DIR, "libcommit_small_trace.so")
    with open(src, "w") as f:
        f.write(text + _TRACE_TAIL)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", src_dir, "-o", so,
                           src], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"trace build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    commit_small._bind(lib)
    lib.lcpc_commit_small_trace.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.lcpc_commit_small_trace.restype = ctypes.c_int
    return lib


def phase_trace(lib, run):
    """One commit through the trace build: per slot pair (a phase's work,
    then its barrier), the ms from the previous barrier's last exit to the
    phase's last block done, and from there to the barrier's last exit;
    the blocks that stamped."""
    stamps = (ctypes.c_ulonglong * (TRACE_BLOCKS * TRACE_SLOTS))()
    run()
    stream = torch.cuda.current_stream().cuda_stream
    if lib.lcpc_commit_small_trace(ctypes.addressof(stamps), 0, stream) != 0:
        raise RuntimeError("trace read failed")
    rows = [list(stamps[b * TRACE_SLOTS:(b + 1) * TRACE_SLOTS]) for b in range(TRACE_BLOCKS)]
    rows = [r for r in rows if r[0]]
    used = max(i + 1 for r in rows for i, v in enumerate(r) if v)
    t0 = min(r[0] for r in rows)
    ends = [max(r[i] for r in rows) for i in range(used)]
    # slot 0 the start, then (done, released) pairs, the last slot the end
    phases, prev = [], max(r[0] for r in rows)
    for i in range(1, used - 1, 2):
        phases.append({"work_ms": (ends[i] - prev) / 1e6,
                       "barrier_ms": (ends[i + 1] - ends[i]) / 1e6})
        prev = ends[i + 1]
    if (used - 1) % 2 == 1:
        phases.append({"work_ms": (ends[used - 1] - prev) / 1e6, "barrier_ms": 0.0})
    return {"blocks": len(rows), "start_spread_ms": (max(r[0] for r in rows) - t0) / 1e6,
            "total_ms": (ends[used - 1] - t0) / 1e6, "phases": phases}


def measure(P, protocol, cs, gates, counters, name, log_n, digest, reps, gen, trace_lib):
    spec = P.FT255
    n = 1 << log_n
    coeffs = kb.random_mont(spec, (1, spec.w16, n), gen)[0]

    def commit(enc, gate):
        protocol._FUSED_COMMIT_MAX = {k: gate for k in gates}
        return P.commit(coeffs, enc, digest=digest)

    make_encoding(P, name, spec, n).device_tables()  # the NTT plan's table (process-wide)
    first = {}
    for route, gate in (("staged", STAGED), ("kernel", KERNEL)):
        enc = make_encoding(P, name, spec, n)  # fresh: its tables made in the first commit
        out, ms, launches = counted(counters, lambda: commit(enc, gate))
        first[route] = {"ms": ms, "launches": launches}
    if first["kernel"]["launches"] != 1:
        raise AssertionError(f"{name} 2^{log_n}: the kernel route's first commit launched "
                             f"{first['kernel']['launches']} kernels")
    staged = commit(enc, STAGED)
    for what in ("hashes_dev", "comm", "coeffs"):
        if not torch.equal(getattr(out, what), getattr(staged, what)):
            raise AssertionError(f"{name} 2^{log_n}: the routes' {what} differ")
    n_rows, n_per_row, n_cols = enc.get_dims(n)
    times = {"staged": [], "kernel": []}
    for route in ("staged", "kernel", "kernel", "staged"):
        gate = STAGED if route == "staged" else KERNEL
        commit(enc, gate)
        times[route] += [synced(lambda: commit(enc, gate))[1] for _ in range(max(1, reps // 2))]
    med = {k: statistics.median(v) for k, v in times.items()}
    arr = coeffs.contiguous()
    dev = {"kernel": kb.time_kernel(lambda: protocol._commit_fused_fn(enc, digest)(arr)),
           "staged": kb.time_kernel(lambda: protocol._commit_staged(enc, digest, arr))}
    traces = {route: trace(lambda: commit(enc, STAGED if route == "staged" else KERNEL))
              for route in ("staged", "kernel")}
    rec = {"encoding": name, "log_n": log_n, "digest": digest.name, "n_rows": n_rows,
           "n_per_row": n_per_row, "n_cols": n_cols, "elements": n_rows * n_cols,
           "first_staged_ms": first["staged"]["ms"], "first_kernel_ms": first["kernel"]["ms"],
           "first_staged_launches": first["staged"]["launches"],
           "staged_ms": med["staged"], "kernel_ms": med["kernel"],
           "speedup": med["staged"] / med["kernel"],
           "kernel_device_ms": dev["kernel"], "staged_device_ms": dev["staged"],
           "staged_runs_ms": times["staged"], "kernel_runs_ms": times["kernel"],
           "trace": traces}
    if trace_lib is not None:
        real = cs.cuda_build._libs.get("commit_small")
        cs.cuda_build._libs["commit_small"] = trace_lib
        try:
            rec["phases"] = phase_trace(trace_lib, lambda: cs.commit_small(enc, digest, arr))
        finally:
            cs.cuda_build._libs["commit_small"] = real
    print(f"{name} 2^{log_n} ({digest.name}): {n_rows} x {n_cols} = {n_rows * n_cols:,} "
          f"elements; first commit staged {first['staged']['ms']:.4f} ms "
          f"({first['staged']['launches']} launches), kernel {first['kernel']['ms']:.4f} (1); "
          f"warm staged {med['staged']:.4f}, kernel {med['kernel']:.4f} "
          f"(x{rec['speedup']:.2f}); device kernel {dev['kernel']:.4f}, staged "
          f"{dev['staged']:.4f}; events {traces['staged']['cuda_events']} / "
          f"{traces['kernel']['cuda_events']} {traces['kernel']['names']}, idle "
          f"{traces['staged']['idle_share']:.3f} / {traces['kernel']['idle_share']:.3f}"
          + (f"; phases {json.dumps(rec['phases'])}" if "phases" in rec else ""), flush=True)
    return rec


def host_profile(P, protocol, gates, name, log_n, gen):
    spec = P.FT255
    enc = make_encoding(P, name, spec, 1 << log_n)
    coeffs = kb.random_mont(spec, (1, spec.w16, 1 << log_n), gen)[0]
    protocol._FUSED_COMMIT_MAX = {k: KERNEL for k in gates}
    P.commit(coeffs, enc)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(200):
        P.commit(coeffs, enc)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(18)
    return out.getvalue()


def with_parent(args) -> int:
    """Parent, this, this, parent: each a process of its checkout's script."""
    here = os.path.abspath(__file__)
    there = os.path.join(os.path.abspath(args.parent), "scripts", "time_small_commit.py")
    common = ["--logs", args.logs, "--reps", str(args.reps), "--encodings", args.encodings]
    runs = []
    for label, script in (("parent", there), ("change", here), ("change", here),
                          ("parent", there)):
        proc = subprocess.run([sys.executable, script, *common], capture_output=True,
                              text=True, timeout=3000)
        sys.stdout.write(proc.stdout[-12000:])
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise RuntimeError(f"the {label} run failed: rc {proc.returncode}")
        runs.append({"label": label, "result": json.loads(proc.stdout.strip().splitlines()[-1])})
    with open(os.path.join(_ROOT, "chiprun_out", "time_small_commit_parent.json"), "w") as f:
        json.dump(runs, f, indent=1)
    print(json.dumps({"runs": runs}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--logs", default="11,12,13,14,15,16,17,18,19,20,21,22,23")
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--encodings", default="ligero,sdig")
    ap.add_argument("--trace", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_small_commit.py needs a CUDA device")
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    if args.parent:
        return with_parent(args)
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.core import protocol
    from lcpc_tpu_torch.ops import commit_small as cs
    from lcpc_tpu_torch.ops import launch_count
    from lcpc_tpu_torch.utils import cuda_build

    card = kb.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all(["commit_small", "ntt_mont", "spmv_mont", "blake3_cols",
                          "sha256_cols", "mont_map"])
    trace_logs = {int(v) for v in args.trace.split(",") if v}
    trace_lib = build_trace_lib(cs, cuda_build) if trace_logs else None
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gate0 = protocol._FUSED_COMMIT_MAX
    logs = [int(v) for v in args.logs.split(",")]
    recs, crossover, profile = [], {}, None
    try:
        for name in args.encodings.split(","):
            for log_n in logs:
                for digest in ((P.BLAKE3, P.SHA256) if log_n in (logs[0], logs[-1])
                               else (P.BLAKE3,)):
                    rec = measure(P, protocol, cs, gate0, launch_count.COUNTERS, name, log_n,
                                  digest, args.reps, gen,
                                  trace_lib if log_n in trace_logs else None)
                    recs.append(rec)
                    if digest is P.BLAKE3 and rec["kernel_ms"] < rec["staged_ms"]:
                        crossover[name] = max(crossover.get(name, 0), rec["elements"])
                    torch.cuda.empty_cache()
        if args.profile:
            profile = host_profile(P, protocol, gate0, args.encodings.split(",")[0], logs[0],
                                   gen)
            print(profile, flush=True)
    finally:
        protocol._FUSED_COMMIT_MAX = gate0
    gates = {f"{'Ligero' if k == 'ligero' else 'Sdig'}Encoding": min(v, CAP)
             for k, v in crossover.items()}
    out = {"card": card, "gate": gate0, "largest_kernel_win_elements": crossover,
           "gates_measured": gates, "records": recs, "profile": profile}
    with open(os.path.join(_ROOT, "chiprun_out", "time_small_commit.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": card, "gate": gate0, "largest_kernel_win_elements": crossover,
                      "gates_measured": gates,
                      "ms": {f"{r['encoding']} 2^{r['log_n']} {r['digest']}": [
                          r["staged_ms"], r["kernel_ms"], r["first_staged_ms"],
                          r["first_kernel_ms"], r["kernel_device_ms"], r["staged_device_ms"]]
                          for r in recs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
