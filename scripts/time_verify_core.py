#!/usr/bin/env python3
"""verify_core.cu's two kernels alone on the card: verify_check (the
verifier's column check, hash words and evaluation) and gather_open (the
prover's opening), and the random-sector probe scripts/gather_probe.cu.

    python3 scripts/time_verify_core.py [--repo DIR] [--label NAME] [--probe]
        [--trace] [--no-check] [--reps N]

Builds the checkout's csrc/verify_core.cu, prints ptxas's registers and
spills and the SASS of verify_check's rows loop (its loads and stores
against its first wide product: how many rows a thread has in flight), then
at the paths' shapes (ft255, T = 2):
  - checks (skipped with --no-check): each kernel against its plain version
    on the card, tolerance 0 (the state's flags and evaluation, the hash
    words; the opened words and path nodes), the opened columns drawn with
    replacement (unsorted, repeats), as the transcript draws them;
  - times each kernel warm (kernel_bench.time_kernel: back-to-back launches
    on the same inputs, which stay in the 50 MB L2 where they fit) and cold
    (kernel_bench.time_kernel_cold: 128 MB written and 128 MB read between
    launches, each launch timed alone, the median), beside its bound (each
    input byte read once and each output byte written once over 3.35 TB/s,
    or verify_check's wide products over 8.4e12/s), and the gather beside
    torch.index_select of the same columns, warm and cold;
  - with --probe, the probe: one 4-byte load per distinct 32-byte sector,
    at each gather's sector count (Ligero 16 x 256 x 189, Brakedown 16 x 36
    x 6,593, the 2^28 kept words 2,048 x 8 x 189) over a 2 GiB buffer, in
    ascending and random order, by ld.global.nc and by
    ld.global.nc.L1::no_allocate.L2::evict_first, cold and warm, then again
    under cudaLimitMaxL2FetchGranularity = 32 (a device-wide limit, set back
    to its value after; measured only, the port never sets it);
  - with --trace, a %globaltimer trace of one launch of each kernel at
    each shape, warm and cold, each stamp's median and latest over the
    blocks (us after the first block's start): the source's own stamps
    (csrc/verify_core.cu, -DLCPC_VC_TRACE), or, in the PR 15 source, stamps
    patched in at anchors (verify_check's blocks' start, the end of their
    rows, their residues stored, their meet, the last block's end; gather_open's
    blocks' first load and last store).
With --repo, the checkout in DIR (an older commit unpacked into the
gitignored archive/) is built and timed instead: run parent, change, change,
parent in one call.  Prints one JSON line last and writes
chiprun_out/time_verify_core[_LABEL].json.  Imports torch and the
checkout's lcpc_tpu_torch, nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
WIDE_PRODUCTS_PER_S = 8.4e12
T = 2
# (tag, rows, opened columns, codeword columns, the evaluation's length)
CHECKS = (("ligero 2^23", 256, 189, 1 << 17, 32_768),
          ("sdig 2^23", 36, 6_593, 357_699, 235_173),
          ("seeded 2^29", 2_048, 189, 1 << 20, 262_144))
# (tag, rows, opened columns, columns of the source, source form)
GATHERS = (("ligero 2^23", 256, 189, 1 << 17, "limbs"),
           ("sdig 2^23", 36, 6_593, 357_699, "limbs"),
           ("2^28 words kept", 2_048, 189, 1 << 16, "canon"),
           ("seeded 2^29", 2_048, 189, 189, "int64"))
# the probe: (tag, plane-rows, sectors a plane-row) of each gather
PROBES = (("ligero 2^23", 16 * 256, 189), ("sdig 2^23", 16 * 36, 6_593),
          ("2^28 words kept", 2_048 * 8, 189))


def check_bound(w32, R, k, npr):
    """(bound ms, by, bytes ms, products ms) of verify_check (as chip_smoke's
    vc_bound): ts, the columns, the encoded rows' limbs at the opened
    columns, the indices and the evaluation's operands read once, the hash
    words written once; T + 1 wide products a column element (the T sums,
    from_mont), one a wanted element and one an evaluation term, W32^2 each."""
    nbytes = 4 * w32 * (T * R + 2 * R * k + 2 * T * k + 2 * npr) + 8 * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = w32 * w32 * ((T + 1) * R * k + T * k + npr) / WIDE_PRODUCTS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def gather_bound(in_bytes, out_words, k, U):
    """(bound ms) of gather_open (as chip_smoke's vc_gather): the opened
    words read once, the buffer written once, the path nodes (int64 in,
    int32 out) and the indices."""
    return (in_bytes + 4 * out_words + 64 * U + 8 * (k + U)) / HBM_BYTES_PER_S * 1e3


# ---- the parent's trace: %globaltimer stamps patched into the PR 15 source ---------------

_TRACE_HEAD = r'''
__device__ unsigned long long vc_trace[6 * 8192];
__device__ __forceinline__ unsigned long long vc_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define VC_STAMP(slot) (vc_trace[6 * blockIdx.x + (slot)] = vc_now())
extern "C" int lcpc_vc_trace(unsigned long long* host, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(host, vc_trace, n * sizeof(unsigned long long));
  if (e != cudaSuccess) return (int)e;
  void* p = nullptr;
  e = cudaGetSymbolAddress(&p, vc_trace);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(vc_trace));
}
'''

# (anchor, text put after it): slot 0 a block's start (gather: thread 0's
# first load), 1 the end of its rows, 2 its residues stored (or checked,
# one split), 3 its meet (after the counter's atomic), 4 the last block's
# end; gather slot 1 the block's last store (the latest of its threads)
_TRACE_PATCHES = (
    ('#include "mont.cuh"\n', _TRACE_HEAD),
    ("  const int n_col_blocks = a.groups * a.splits;\n",
     "  if (threadIdx.x == 0) VC_STAMP(0);\n"),
    ("      __syncthreads();\n      if (warp == 0) {\n#pragma unroll\n        for (int u = 0; u < "
     "kMaxT; ++u) {\n", "          if (threadIdx.x == 0 && t0 == 0 && u == 0) VC_STAMP(1);\n"),
    ("          if (a.splits == 1) {\n            check(t, s);\n          } else {\n"
     "#pragma unroll\n            for (int w = 0; w < W; ++w)\n"
     "              part[(((size_t)t * a.splits + y) * W + w) * kCols + lane] = s[w];\n"
     "          }\n", "          if (threadIdx.x == 0 && t == a.T - 1) VC_STAMP(2);\n"),
    ("    if (threadIdx.x == 0) last = atomicAdd(counters + 1 + g, 1u) == "
     "(unsigned)a.splits - 1;\n", "    if (threadIdx.x == 0) VC_STAMP(3);\n"),
    ("      check(t, s);\n    }\n", "    if (lane == 0) VC_STAMP(4);\n"),
    ("  for (int w = 0; w < W; ++w) red[0][warp][w][lane] = s[w];\n  __syncthreads();\n",
     "  if (threadIdx.x == 0) VC_STAMP(1);\n"),
    ("  if (threadIdx.x == 0) last = atomicAdd(counters, 1u) == (unsigned)a.eval_blocks - 1;\n",
     "  if (threadIdx.x == 0) VC_STAMP(3);\n"),
    ("  for (int w = 0; w < W; ++w) a.state[a.T + 1 + w] = (int32_t)t[w];\n",
     "  VC_STAMP(4);\n"),
    ("    const long long e = (long long)blockIdx.x * kGatherThreads + threadIdx.x;\n"
     "    if (e >= a.R * a.k) return;\n", "    if (threadIdx.x == 0) VC_STAMP(0);\n"),
    ("    for (int w = 0; w < W; ++w) a.out[(w * a.R + r) * a.k + j] = (int32_t)x[w];\n",
     "    atomicMax(&vc_trace[6 * blockIdx.x + 1], vc_now());\n"),
)


def build_traced(repo, out_dir):
    """The checkout's verify_core.cu with its %globaltimer stamps, built
    into out_dir: a source that has them (LCPC_VC_TRACE) built with them on;
    PR 15's with them patched in (raises where an anchor is missing)."""
    src_dir = os.path.join(repo, "lcpc_tpu_torch", "csrc")
    text = open(os.path.join(src_dir, "verify_core.cu")).read()
    flags = []
    if "LCPC_VC_TRACE" in text:
        flags = ["-DLCPC_VC_TRACE"]
    else:
        for anchor, add in _TRACE_PATCHES:
            if text.count(anchor) != 1:
                raise RuntimeError(f"trace: anchor found {text.count(anchor)} times: {anchor!r}")
            text = text.replace(anchor, anchor + add)
    os.makedirs(out_dir, exist_ok=True)
    src, so = os.path.join(out_dir, "verify_core_traced.cu"), os.path.join(
        out_dir, "libverify_core_traced.so")
    open(src, "w").write(text)
    from lcpc_tpu_torch.utils import cuda_build
    nvcc = kb.find_tool("nvcc")
    proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, *flags, "-I", src_dir, "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"trace build failed:\n{proc.stdout}{proc.stderr}")
    return so


TRACE_BLOCKS = 8192  # vc_trace's blocks, six stamps each


def trace_summary(st, n_col):
    """One launch's stamps (blocks x 6, ns) as microseconds after the
    first block's start: for the first n_col blocks (verify_check's column
    blocks, gather_open's column blocks) and the rest, each slot's median
    and latest over the blocks that stamped it."""
    st = st.astype(np.int64)
    used = st[:, 0] > 0
    t0 = st[used, 0].min()
    rel = np.where(st > 0, st - t0, -1).astype(np.float64) / 1e3

    def slots(rows):
        out = {}
        for k in range(6):
            v = rows[:, k][rows[:, k] >= 0]
            if v.size:
                out[k] = (round(float(np.median(v)), 3), round(float(v.max()), 3))
        return out

    n_used = int(used.sum())
    return {"blocks": (min(n_col, n_used), max(0, n_used - n_col)),
            "column": slots(rel[:n_col]), "other": slots(rel[n_col:n_used]),
            "end_us": round(float(rel.max()), 3)}


# ---- the probe --------------------------------------------------------------------------


def run_probe(label, out_dir):
    from lcpc_tpu_torch.utils import cuda_build
    so, _ = kb.build_chain(cuda_build.NVCC_FLAGS, out_dir, kb.GATHER_PROBE_SRC)
    probe = kb.GatherProbe(so)
    was = probe.granularity()
    out = {"default_l2_fetch_granularity": was}
    try:
        for gran in (None, 32):
            if gran is not None:
                probe.set_granularity(gran)
            for tag, rows, k in PROBES:
                for order in (False, True):
                    for ef in (False, True):
                        fn = probe.fn(rows, k, order, ef)
                        cold, warm = kb.time_kernel_cold(fn), kb.time_kernel(fn)
                        key = (f"{tag} {'random' if order else 'ascending'} "
                               f"{'evict_first' if ef else 'nc'}"
                               f"{'' if gran is None else ' granularity 32'}")
                        sectors = rows * k
                        out[key] = {"sectors": sectors, "cold_ms": cold, "warm_ms": warm,
                                    "cold_TBps_of_sectors": 32 * sectors / cold / 1e9,
                                    "bound_32B_ms": 32 * sectors / HBM_BYTES_PER_S * 1e3}
                        print(f"{label} probe {key}: {sectors} sectors, cold {cold:.4f} ms "
                              f"({32 * sectors / cold / 1e9:.3f} TB/s of sectors), warm "
                              f"{warm:.4f} ms; 32 B a sector at 3.35 TB/s: "
                              f"{32 * sectors / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    finally:
        probe.set_granularity(was)
        probe.close()
    return out


# ---- the kernels ------------------------------------------------------------------------


def sass_rows_loop(so_path):
    """verify_check's rows loop at W32 = 8 in the SASS: the shortest
    backward-branch loop holding at least 64 IMAD.WIDE (one product of two
    elements); its loads and stores and where they sit against its first
    wide product."""
    funcs = kb.sass_functions(so_path)
    if funcs is None:
        return None
    name = next((k for k in funcs if "verify_check_kernelILi8E" in k), None)
    if name is None:
        return None
    loops = list(kb._loops(funcs[name]))
    if not loops:
        return {"loops": 0}
    # the innermost loop of the products: the shortest with a row's (one
    # mac's 64 at W32 = 8)
    wide = [lp for lp in loops if sum(t.startswith("IMAD.WIDE") for t in lp) >= 64]
    best = min(wide, key=len) if wide else max(
        loops, key=lambda lp: sum(t.startswith("IMAD.WIDE") for t in lp))
    first = next((n for n, t in enumerate(best) if t.startswith("IMAD.WIDE")), len(best))
    kinds = ("LDG", "LDS", "STG", "LDGSTS", "BAR", "LDSM")
    pos = {kd: [n for n, t in enumerate(best) if t.split()[0].split(".")[0] == kd]
           for kd in kinds}
    return {"instructions": len(best), "wide_products": sum(t.startswith("IMAD.WIDE")
                                                            for t in best),
            "first_wide_product_at": first,
            **{f"{kd}_before_first_product": sum(n < first for n in v) for kd, v in pos.items()},
            **{f"{kd}_after_first_product": sum(n >= first for n in v) for kd, v in pos.items()},
            "sass": best}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=_ROOT, help="the checkout whose lcpc_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_verify_core.py needs a CUDA device")
    repo = os.path.abspath(args.repo)
    sys.path[:0] = [repo]
    import lcpc_tpu_torch as P
    if not P.__file__.startswith(repo):
        raise RuntimeError(f"lcpc_tpu_torch came from {P.__file__}, not {repo}")
    from lcpc_tpu_torch.ops import verify_core as vc
    from lcpc_tpu_torch.ops.spmv import pack_words
    from lcpc_tpu_torch.utils import cuda_build

    label = args.label or "change"
    card = kb.card_line()
    print(label, card, torch.__version__, torch.version.cuda, repo, flush=True)
    out_dir = os.path.join(_ROOT, "chiprun_out")
    scratch = os.path.join(repo, "build", "time_verify_core")
    secs = cuda_build.build_all(["verify_core"], force=True)
    ptxas = kb.ptxas_entries(cuda_build.build_logs["verify_core"], "_kernel")
    for name, (regs, st, ld) in sorted(ptxas.items()):
        print(f"{label} ptxas {name}: {regs} registers, {st} / {ld} bytes spilled", flush=True)
    loop = sass_rows_loop(cuda_build.so_path("verify_core"))
    if loop is not None and "sass" in loop:
        with open(os.path.join(out_dir, f"verify_check_rows_loop_{label}.txt"), "w") as fh:
            fh.write("\n".join(loop.pop("sass")) + "\n")
    print(f"{label} verify_check rows loop SASS (W32 = 8): {loop}", flush=True)
    result = {"label": label, "card": card, "repo": repo, "build_s": secs, "ptxas": ptxas,
              "rows_loop": loop, "checks": 0, "verify_check": {}, "gather_open": {}}
    if args.probe:
        result["probe"] = run_probe(label, scratch)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    n_state = len(inspect.signature(vc.state_init).parameters)
    has_plan = hasattr(vc, "gather_plan")
    spec = P.FT255
    w, w32 = spec.w16, spec.w16 // 2
    traced = None
    if args.trace:
        so = build_traced(repo, scratch)
        traced = ctypes.CDLL(so)
        vc._bind(traced)
        traced.lcpc_vc_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
        traced.lcpc_vc_trace.restype = ctypes.c_int
        result["trace"] = {}

    def trace_one(kind, fn, n_col, tag):
        plain_lib = cuda_build._libs.get("verify_core")
        cuda_build._libs["verify_core"] = traced
        buf = np.zeros(6 * TRACE_BLOCKS, dtype=np.uint64)
        try:
            rec = {}
            for temp in ("warm", "cold"):
                fn()
                if temp == "cold":
                    kb.flush_l2()
                torch.cuda.synchronize()
                traced.lcpc_vc_trace(buf.ctypes.data, buf.size)  # clears
                fn()
                torch.cuda.synchronize()
                if traced.lcpc_vc_trace(buf.ctypes.data, buf.size) != 0:
                    raise RuntimeError("trace read failed")
                rec[temp] = trace_summary(buf.reshape(TRACE_BLOCKS, 6), n_col)
            res = np.unique(np.diff(np.unique(buf[buf > 0])))
            rec["timer_step_ns_min"] = int(res[0]) if res.size else None
        finally:
            cuda_build._libs["verify_core"] = plain_lib
        print(f"{label} trace {kind} {tag}: {rec}", flush=True)
        result["trace"][f"{kind} {tag}"] = rec

    for tag, R, k, n_cols, npr in CHECKS:
        ts = pack_words(kb.random_mont(spec, (T, w, R), gen).permute(1, 0, 2), 0).contiguous()
        col = pack_words(kb.random_mont(spec, (R, w, k), gen).permute(1, 0, 2), 0).contiguous()
        enc = kb.random_mont(spec, (T, w, n_cols), gen).permute(1, 0, 2).contiguous()
        idx = torch.randint(0, n_cols, (k,), generator=gen, device="cuda", dtype=torch.int64)
        pe = pack_words(kb.random_mont(spec, (npr, w), gen), 1).contiguous()
        inner = pack_words(kb.random_mont(spec, (npr, w), gen), 1).contiguous()
        init = vc.state_init(spec, T) if n_state == 2 else vc.state_init(spec, T, k)
        state0 = torch.from_numpy(init).cuda()
        state = state0.clone()

        def call():
            return vc.verify_check(spec, state, ts, col, enc, idx, p_eval=pe, inner=inner)

        if not args.no_check:
            words = call()
            ok, ev, pwords = vc.verify_check_plain(spec, ts, col, enc, idx, p_eval=pe,
                                                   inner=inner)
            got = state[: T + 1 + w32].tolist()
            want = [int(v) for v in ok.tolist()] + [1] + ev.tolist()
            if got != want or not torch.equal(words, pwords):
                raise AssertionError(f"{label} verify_check {tag}: kernel {got} != plain {want}")
            result["checks"] += 1
        warm = kb.time_kernel(call, args.reps)
        cold = kb.time_kernel_cold(call, args.reps)
        bound, by, t_bytes, t_ops = check_bound(w32, R, k, npr)
        result["verify_check"][tag] = {"warm_ms": warm, "cold_ms": cold, "bound_ms": bound,
                                       "bound_by": by, "bytes_ms": t_bytes, "products_ms": t_ops}
        print(f"{label} verify_check {tag} (T {T} x {R} rows x {k} columns, npr {npr}): warm "
              f"{warm:.4f} ms, cold {cold:.4f} ms, bound {bound:.4f} ms ({by}; bytes "
              f"{t_bytes:.4f}, products {t_ops:.4f})", flush=True)
        if traced is not None:
            splits, _ = vc._split(vc._n_sm(0), R, k)
            trace_one("verify_check", call, -(-k // vc.COLS) * splits, tag)
        del ts, col, enc, pe, inner
        torch.cuda.empty_cache()

    for tag, R, k, n_src, form in GATHERS:
        if form == "int64":
            idx = torch.arange(k, device="cuda")
        else:
            idx = torch.randint(0, n_src, (k,), generator=gen, device="cuda", dtype=torch.int64)
        n_nodes = 2 * (1 << (max(n_src, 2) - 1).bit_length()) - 1  # the padded tree's
        hashes = torch.randint(0, 2**32, (8, max(n_nodes, 1)), generator=gen, device="cuda",
                               dtype=torch.int64)
        from lcpc_tpu_torch.core import protocol
        uniq = torch.as_tensor(np.unique(protocol.path_node_indices(
            max(n_src, 2), [int(c) for c in idx.tolist()])).astype(np.int64), device="cuda")
        if form == "limbs":
            src = kb.random_mont(spec, (R, w, n_src), gen).permute(1, 0, 2).contiguous()
            kw = dict(mont=src, off=n_src)
            lib = lambda: src.index_select(2, idx)  # noqa: E731
            in_bytes = 4 * w * R * k
        elif form == "canon":
            src = pack_words(kb.random_mont(spec, (R, w, n_src), gen).permute(1, 0, 2), 0)
            src = src.permute(1, 0, 2).reshape(R * w32, n_src).contiguous()
            kw = dict(canon=src)
            lib = lambda: src.index_select(1, idx)  # noqa: E731
            in_bytes = 4 * w32 * R * k
        else:
            src = torch.empty((w32, R, k), dtype=torch.int64, device="cuda").random_(
                0, 2**32, generator=gen)
            kw = dict(mont=src, mont_form="words", off=k)
            lib = lambda: src.index_select(2, idx)  # noqa: E731
            in_bytes = 8 * w32 * R * k
        if has_plan:
            kw["plan"] = vc.gather_plan(idx.cpu().numpy(), kw.get("off", 0), device="cuda")

        def call():
            return vc.gather_open(spec, idx, R, hashes=hashes, uniq=uniq, **kw)

        if not args.no_check:
            got = call()
            want = vc.gather_open_plain(spec, idx, R, hashes=hashes, uniq=uniq, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"{label} gather_open {tag}: kernel != plain")
            result["checks"] += 1
        U = uniq.numel()
        warm, cold = kb.time_kernel(call, args.reps), kb.time_kernel_cold(call, args.reps)
        lib_warm, lib_cold = kb.time_kernel(lib, args.reps), kb.time_kernel_cold(lib, args.reps)
        bound = gather_bound(in_bytes, w32 * R * k + 8 * U, k, U)
        repeats = k - int(torch.unique(idx).numel())
        result["gather_open"][tag] = {"warm_ms": warm, "cold_ms": cold, "bound_ms": bound,
                                      "index_select_warm_ms": lib_warm,
                                      "index_select_cold_ms": lib_cold, "rows": R,
                                      "columns": k, "repeats": repeats, "path_nodes": U}
        print(f"{label} gather_open {tag} ({R} rows x {k} columns, {repeats} repeats, {U} path "
              f"nodes, from {form}): warm {warm:.4f} ms, cold {cold:.4f} ms, bound {bound:.4f} "
              f"ms; index_select alone warm {lib_warm:.4f}, cold {lib_cold:.4f}", flush=True)
        if traced is not None:
            trace_one("gather", call, TRACE_BLOCKS, tag)
        del src, hashes
        torch.cuda.empty_cache()

    path = os.path.join(out_dir, f"time_verify_core{'_' + args.label if args.label else ''}.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("ptxas",)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
