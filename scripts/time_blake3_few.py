#!/usr/bin/env python3
"""BLAKE3's column hash at few columns on the card: the few-column kernel
(csrc/blake3_cols.cu's blake3_cols_few_kernel, one launch from words to
digests) against the wide route (blake3_chunks, then the chunk tree: two
launches), both forced through ops/blake3.hash_word_columns(_route=).

    python3 scripts/time_blake3_few.py [--no-check] [--no-sweep] [--trace] [--reps N]

Builds blake3_cols.cu and the latency probe scripts/blake3_chain.cu, prints
ptxas's registers and spills of the few kernel and the SASS of a
compression by pipe, one compression's latency (a chain of CHAIN in one
thread), then:
  - checks (skipped with --no-check): the few kernel against its plain
    version (hash_word_columns_few_plain on the card) and against the wide
    route, word for word, at CHECK_COLS x CHECK_WORDS, verify's three shapes,
    FEW_COLS_MAX columns and FEW_WORDS_MAX words;
  - times verify's three shapes (189 x 2,048 words, 189 x 16,384, 6,593 x
    288) by both routes in turns wide, few, few, wide, warm (CUDA events
    over back-to-back calls) and cold (kernel_bench.time_kernel_cold: the
    L2 flushed before each call, each timed alone), beside the operations
    bound (the compressions at the probe's SASS count), the bytes bound and
    the floor: a chunk's chained compressions plus the chunk tree's levels
    at the probe's latency;
  - sweeps both routes over SWEEP_COLS x SWEEP_WORDS and the 2^23
    Brakedown commit's 357,699 x 288, warm (where the few kernel stops
    leading; ops/blake3.FEW_COLS_MAX is set under it), unless --no-sweep;
  - with --trace, a copy of the source with %globaltimer stamps patched in
    (TRACE_PATCHES: thread 0 of each block at the kernel's start, before and
    after the block's chunk-tree merge, before and after the last block's
    merge of the blocks' subtrees, at the end), built apart and bound for
    one call at each of verify's shapes: when the blocks' chunk chains,
    merges and ends finished.
Prints one JSON line last and writes chiprun_out/time_blake3_few.json.
Imports torch and lcpc_tpu_torch, nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_ROOT, _HERE]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 16.75e12  # each integer pipe, 132 SMs at 1.98 GHz
VERIFY_SHAPES = ((2_048, 189), (16_384, 189), (288, 6_593))  # words x columns
CHECK_COLS = (1, 31, 33)
CHECK_WORDS = (8, 248, 249, 504, 2_048, 4_104, 16_384)
SWEEP_COLS = (189, 1_024, 4_096, 6_593, 8_192, 16_384, 32_768, 65_536, 131_072)
SWEEP_WORDS = (288, 2_048, 16_384)
CHAIN = 4096


def cost(n_words, n_cols):
    """(bytes, compressions, depth) of the column hash: each word read once
    and the (8, C) int64 digests written; a compression a 64-byte block of
    each chunk and a parent a merge (n_chunks - 1 a column); the longest
    chain, a chunk's blocks (at most 16) and the chunk tree's levels."""
    total = 8 + n_words
    n_chunks = -(-total // 256)
    blocks = -(-total // 16)
    depth = min(16, blocks) + (n_chunks - 1).bit_length()
    return 4 * n_words * n_cols + 64 * n_cols, (blocks + n_chunks - 1) * n_cols, depth


def bound_ms(nbytes, compressions, per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, compressions * per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# %globaltimer stamps for --trace, patched into a copy of csrc/blake3_cols.cu
# at these anchors (each found once): thread 0 of each block writes slot s
# of its row; lcpc_blake3_few_trace reads the rows back and clears them
TRACE_BLOCKS, TRACE_SLOTS = 8192, 6
_TRACE_HEAD = f"""
constexpr int kTraceSlots = {TRACE_SLOTS};
constexpr int kTraceBlocks = {TRACE_BLOCKS};
__device__ unsigned long long trace_stamps[kTraceBlocks * kTraceSlots];
__device__ __forceinline__ void stamp(int slot) {{
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && b < kTraceBlocks) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    trace_stamps[b * kTraceSlots + slot] = t;
  }}
}}
"""
_TRACE_TAIL = """
extern "C" int lcpc_blake3_few_trace(unsigned long long* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaStreamSynchronize((cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, trace_stamps, sizeof(trace_stamps));
  static unsigned long long zeros[kTraceBlocks * kTraceSlots];
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(trace_stamps, zeros, sizeof(zeros));
  return (int)err;
}
"""
TRACE_PATCHES = (  # (anchor, its replacement)
    ("// ---- the few-column route", _TRACE_HEAD + "// ---- the few-column route"),
    ("  uint32_t cv[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};\n",
     "  uint32_t cv[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};\n  stamp(0);\n"),
    ("  merge_warps(cv, m, n_groups == 1, slots);\n",
     "  stamp(1);\n  merge_warps(cv, m, n_groups == 1, slots);\n  stamp(2);\n"),
    ("    merge_nodes(cv, n_groups, smem);\n",
     "    stamp(3);\n    merge_nodes(cv, n_groups, smem);\n    stamp(4);\n"),
    ("    for (int w = 0; w < 8; ++w) out[(size_t)w * n_cols + c] = cv[w];\n  }\n}\n",
     "    for (int w = 0; w < 8; ++w) out[(size_t)w * n_cols + c] = cv[w];\n  }\n"
     "  stamp(5);\n}\n"),
)


def build_variant(cuda_build, b3, tag, text):
    """`text` (a copy of csrc/blake3_cols.cu) built apart as lib<tag>.so and
    bound with the package's argtypes."""
    src_dir = os.path.dirname(cuda_build.source_path("blake3_cols"))
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, f"{tag}.cu")
    so = os.path.join(cuda_build.BUILD_DIR, f"lib{tag}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", src_dir, "-o", so,
                           src], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag} build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    b3._bind(lib)
    return lib, proc.stdout + proc.stderr


def patched(cuda_build, patches):
    text = open(cuda_build.source_path("blake3_cols")).read()
    for anchor, new in patches:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor found {text.count(anchor)} times: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def trace_call(lib, run, n_blocks):
    """One call through the trace build: the ms from the first block's start
    to the last block's stamp of each slot (the slots a block reached)."""
    stamps = (ctypes.c_ulonglong * (TRACE_BLOCKS * TRACE_SLOTS))()
    run()
    if lib.lcpc_blake3_few_trace(ctypes.addressof(stamps), 0,
                                 torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("trace read failed")
    rows = [stamps[b * TRACE_SLOTS:(b + 1) * TRACE_SLOTS] for b in range(min(n_blocks,
                                                                            TRACE_BLOCKS))]
    t0 = min(r[0] for r in rows)
    names = ("start", "chunks", "block_merge", "top_loaded", "top_merge", "end")
    out = {"blocks": len(rows)}
    for s, name in enumerate(names):
        vals = [r[s] for r in rows if r[s]]
        if vals:
            out[f"{name}_last_ms"] = (max(vals) - t0) / 1e6
            out[f"{name}_first_ms"] = (min(vals) - t0) / 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_blake3_few.py needs a CUDA device")
    from lcpc_tpu_torch.ops import blake3 as b3
    from lcpc_tpu_torch.utils import cuda_build

    card = kb.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["blake3_cols"], force=True)
    chain_so, _ = kb.build_chain(cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR)
    ptxas = kb.ptxas_entries(cuda_build.build_logs["blake3_cols"], "blake3_")
    for name, (regs, st, ld) in sorted(ptxas.items()):
        print(f"ptxas {name}: {regs} registers, {st} / {ld} bytes spilled", flush=True)
    lib_so = cuda_build.so_path("blake3_cols")
    mix = kb.blake3_sass_mix(chain_so, lib_so, ("blake3_cols_few_kernel", "blake3_chunks_kernel"))
    alu, fma, _ = mix["chain"]
    per_s = max(alu, fma, (alu + fma) / 2) / INT_OPS_PER_S
    loop = kb.hot_code(lib_so, "blake3_cols_few_kernel")
    print(f"SASS of the few kernel's chunk loop ((ALU, FMA, all), opcodes): {loop}", flush=True)
    print(f"build {secs} + probe ({time.perf_counter() - t0:.1f} s); SASS a compression (ALU, "
          f"FMA, all): probe {mix['chain']}, kernels {mix['kernels']}; {per_s * 1e12:.2f} ps at "
          f"the card's integer rate", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)

    def words(n, c):
        w = torch.randint(-2**31, 2**31, (n, c), generator=gen, device="cuda", dtype=torch.int32)
        w[0] = -1  # every bit set
        return w

    cv0 = torch.randint(0, 2**32, (8,), generator=gen, device="cuda", dtype=torch.int64)
    lat_ms = kb.time_kernel(lambda: kb.compress_chain(chain_so, cv0, CHAIN), reps=3) / CHAIN
    print(f"one compression's latency: {lat_ms * 1e3:.4f} us", flush=True)
    result = {"card": card, "build_s": secs, "ptxas": ptxas, "sass": mix, "sass_loop": loop,
              "compression_ps": per_s * 1e12, "latency_us": lat_ms * 1e3, "checks": 0,
              "verify": {}, "sweep": {}, "trace": {}}

    def few(w):
        return b3.hash_word_columns(w, _route="few")

    def wide(w):
        return b3.hash_word_columns(w, _route="wide")

    if not args.no_check:
        shapes = [(n, c) for c in CHECK_COLS for n in CHECK_WORDS] + list(VERIFY_SHAPES) + [
            (288, b3.FEW_COLS_MAX), (2_048, b3.FEW_COLS_MAX), (b3.FEW_WORDS_MAX, 33)]
        for n, c in shapes:
            w = words(n, c)
            before = b3.COLS_KERNELS["few"].launches
            got = few(w)
            if b3.COLS_KERNELS["few"].launches != before + 1:
                raise AssertionError("the few route did not launch its kernel once")
            sub = w[:, : min(c, 256)]  # the plain version on the card: a column slice
            if not torch.equal(got, wide(w)) or not torch.equal(
                    got[:, : sub.shape[1]], b3.hash_word_columns_few_plain(sub)):
                raise AssertionError(f"few kernel != wide route or plain at {c} x {n}")
            result["checks"] += 1
        torch.cuda.synchronize()
        print(f"checks: {result['checks']} shapes, few == wide == plain", flush=True)

    for n, c in VERIFY_SHAPES:
        w = words(n, c)
        nbytes, comps, depth = cost(n, c)
        bound, by = bound_ms(nbytes, comps, per_s)
        rec = {"bound_ms": bound, "bound_by": by, "floor_ms": depth * lat_ms, "depth": depth,
               "compressions": comps, "bytes": nbytes}
        for mode, timer in (("warm", lambda f: kb.time_kernel(f, reps=args.reps)),
                            ("cold", lambda f: kb.time_kernel_cold(f, reps=args.reps))):
            order = (("wide", wide), ("few", few), ("few", few), ("wide", wide))
            rec[mode] = [(name, timer(lambda: fn(w))) for name, fn in order]
        result["verify"][f"{c}x{n}"] = rec
        print(f"{c} columns x {n} words: warm {rec['warm']}, cold {rec['cold']} ms; bound "
              f"{bound:.4f} ({by}), floor {depth} x latency = {rec['floor_ms']:.4f}", flush=True)

    if not args.no_sweep:
        for n, c in [(n, c) for n in SWEEP_WORDS for c in SWEEP_COLS] + [(288, 357_699)]:
            w = words(n, c)
            rec = {name: kb.time_kernel(lambda: fn(w), reps=5)
                   for name, fn in (("wide", wide), ("few", few))}
            result["sweep"][f"{c}x{n}"] = rec
            print(f"sweep {c} x {n}: wide {rec['wide']:.4f} ms, few {rec['few']:.4f} ms",
                  flush=True)
            del w
        torch.cuda.empty_cache()

    package_lib = cuda_build.load("blake3_cols", b3._bind)
    try:
        if args.trace:
            lib, _ = build_variant(cuda_build, b3, "blake3_cols_trace",
                                   patched(cuda_build, TRACE_PATCHES) + _TRACE_TAIL)
            lib.lcpc_blake3_few_trace.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.lcpc_blake3_few_trace.restype = ctypes.c_int
            cuda_build._libs["blake3_cols"] = lib
            for n, c in VERIFY_SHAPES:
                w = words(n, c)
                n_chunks = -(-(8 + n) // 256)
                blocks = -(-c // 32) * -(-n_chunks // b3.FEW_WARPS)
                trace_call(lib, lambda: few(w), blocks)  # warm; clears every stamp
                recs = [trace_call(lib, lambda: few(w), blocks) for _ in range(3)]
                result["trace"][f"{c}x{n}"] = recs
                print(f"trace {c} x {n}: {recs}", flush=True)
    finally:
        cuda_build._libs["blake3_cols"] = package_lib

    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "time_blake3_few.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("card", "latency_us", "checks", "verify")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
