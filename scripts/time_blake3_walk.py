#!/usr/bin/env python3
"""BLAKE3's verifier path walk on the card: this checkout's
csrc/blake3_cols.cu merkle_walk (a quad of lanes an opened column) against
another checkout's (a thread a column before PR 20), in turns.

    python3 scripts/time_blake3_walk.py [--parent DIR] [--no-check] [--reps N]

Builds this checkout's blake3_cols.cu and the latency probe
scripts/blake3_chain.cu, prints ptxas's registers, stack and spills of the
walk kernel, then:
  - the probe: one compression's latency in each of its layouts (a chain
    of CHAIN: one thread; one thread with the adds on the FMA pipe; one
    quad of lanes, the walk's), each chain first held to the plain
    compression, and each layout's SASS a compression by pipe (its loop
    body; the quad's a lane's, its shuffles beside);
  - checks (skipped with --no-check): the walk against merkle_walk_plain
    on the card, word for word, at CHECK_K columns x CHECK_LEVELS levels
    (the paths of a Merkle tree over random leaves, as verify builds them,
    opened columns repeating), the roots form and the verifier's form (the
    root compared in the kernel: the flag kept on honest paths, cleared by
    a sibling tampered at the first and the last level and by a tampered
    digest), and with --parent the parent's kernel equal to this one;
  - times the walk at SHAPES (columns x levels: the 2^23 Ligero verify's
    189 x 17, the 2^28 and 2^29 verifies' 189 x 19 and 189 x 20, the 2^23
    Brakedown verify's 6,593 x 19; the paths of a Merkle tree of random
    leaves, honest, as verify walks them), in the verifier's form and the roots
    form, warm (kernel_bench.time_kernel: back-to-back launches) and cold
    (kernel_bench.time_kernel_cold: the L2 flushed before each launch, each
    timed alone), in turns parent, this, this, parent with --parent DIR
    (the parent commit unpacked by `git archive` into a gitignored
    directory; its source built apart with the same nvcc flags and called
    through its own lcpc_blake3_merkle_walk, whose arguments are the
    same), else this checkout alone; beside each the floor, levels x each
    layout's probed latency, and the operations bound (the compressions at
    the one-thread probe's SASS count over the integer pipes).
Prints one JSON line last and writes chiprun_out/time_blake3_walk.json.
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
SHAPES = ((189, 17), (189, 19), (189, 20), (6_593, 19))  # opened columns x levels
CHECK_K = (1, 5, 33, 189, 6_593)
CHECK_LEVELS = (0, 1, 17, 19, 20)
CHAIN = 4096
WALK_KERNEL = "merkle_walk"  # both kernels' names hold it


def tree_inputs(b3, gen, k, levels):
    """k opened columns of a Merkle tree over 2^levels random leaves, as
    verify builds the walk's inputs: the columns' digests, the path nodes
    deduplicated by position, the level map, the indices (the first two
    columns repeat the third) and the root; every path reaches the root."""
    np2 = 1 << levels
    leaves = torch.randint(0, 2**32, (8, np2), generator=gen, device="cuda", dtype=torch.int64)
    flat = b3.merkle_tree(leaves, np2)
    idx = torch.randint(0, np2, (k,), generator=gen, device="cuda")
    if k > 2:
        idx[:2] = idx[2]
    lvl = torch.arange(levels, device="cuda")[:, None]
    pos = 2 * np2 - 2 * (np2 >> lvl) + ((idx[None] >> lvl) ^ 1)  # the sibling at each level
    uniq, inv = torch.unique(pos, return_inverse=True)
    return (flat[:, idx].contiguous(), flat[:, uniq].contiguous(), inv.contiguous(), idx,
            flat[:, -1].contiguous())


def bind(so):
    lib = ctypes.CDLL(so)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lcpc_blake3_merkle_walk.argtypes = [p, ll, ll, p, ll, ll, p, p, i, i, p, p, p, i, p]
    lib.lcpc_blake3_merkle_walk.restype = ctypes.c_int
    return lib


def launcher(lib, digs, sibs, inv, idx, out=None, root=None, flag=None):
    """A callable launching lib's walk once on these tensors."""
    k, levels = digs.shape[1], inv.shape[0]
    args = (digs.data_ptr(), *digs.stride(), sibs.data_ptr(), *sibs.stride(), inv.data_ptr(),
            idx.data_ptr(), k, levels, None if out is None else out.data_ptr(),
            None if root is None else root.data_ptr(), None if flag is None else flag.data_ptr(),
            digs.device.index or 0)

    def run():
        err = lib.lcpc_blake3_merkle_walk(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"merkle walk launch: cudaError_t {err}")
    return run


def build_parent(parent, cuda_build):
    """The parent checkout's blake3_cols.cu built apart with the same flags."""
    out_dir = os.path.join(_ROOT, "build", "kernels_parent")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libblake3_cols.so")
    src = os.path.join(os.path.abspath(parent), "lcpc_tpu_torch", "csrc", "blake3_cols.cu")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def checks(b3, gen, parent_lib):
    """The walk against its plain version in both forms (see the module
    docstring); returns the number of cases."""
    n = 0
    for k in CHECK_K:
        for levels in CHECK_LEVELS:
            digs, sibs, inv, idx, root = tree_inputs(b3, gen, k, levels)
            want = b3.merkle_walk_plain(digs, sibs, inv, idx)
            before = b3.merkle_walk.launches
            got = b3.merkle_walk(digs, sibs, inv, idx)
            if (b3.merkle_walk.launches != before + 1 or not torch.equal(got, want)
                    or not torch.equal(got, root[:, None].expand(8, k))):
                raise AssertionError(f"walk {k} x {levels}: kernel != plain or the root")
            if parent_lib is not None:
                out = torch.empty_like(got)
                launcher(parent_lib, digs, sibs, inv, idx, out=out)()
                if not torch.equal(out, got):
                    raise AssertionError(f"walk {k} x {levels}: parent's kernel != this one's")
            # the verifier's form: honest paths, then the last column's
            # sibling at the first and the last level, or its digest, tampered
            cases = [("honest", digs, sibs, inv)]
            for lvl in sorted({0, levels - 1}) if levels else ():
                bad = sibs[:, int(inv[lvl, -1])].clone()
                bad[lvl % 8] ^= 1 << 31
                i_bad = inv.clone()
                i_bad[lvl, -1] = sibs.shape[1]  # a tampered copy, past the others
                cases.append((f"sibling at level {lvl}", digs, torch.cat([sibs, bad[:, None]], 1),
                              i_bad))
            d_bad = digs.clone()
            d_bad[5, -1] ^= 1
            cases.append(("digest", d_bad, sibs, inv))
            for tag, d, s, iv in cases:
                flag = torch.ones(1, dtype=torch.int32, device="cuda")
                b3.merkle_walk(d, s, iv, idx, root=root, flag=flag)
                plain = bool((b3.merkle_walk_plain(d, s, iv, idx) == root[:, None]).all())
                if int(flag) != int(plain) or plain != (tag == "honest"):
                    raise AssertionError(f"walk {k} x {levels} verifier form, {tag}: flag "
                                         f"{int(flag)}, plain {plain}")
            n += 1
    torch.cuda.synchronize()
    return n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="an older checkout to time in turns")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_blake3_walk.py needs a CUDA device")
    from lcpc_tpu_torch.ops import blake3 as b3
    from lcpc_tpu_torch.utils import cuda_build

    card = kb.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build_all(["blake3_cols"], force=True)
    chain_so, _ = kb.build_chain(cuda_build.NVCC_FLAGS, cuda_build.BUILD_DIR)
    ptxas = kb.ptxas_entries(cuda_build.build_logs["blake3_cols"], WALK_KERNEL)
    parent_lib, parent_ptxas = None, {}
    if args.parent:
        so, log = build_parent(args.parent, cuda_build)
        parent_lib, parent_ptxas = bind(so), kb.ptxas_entries(log, WALK_KERNEL)
    for tag, rep in (("this", ptxas), ("parent", parent_ptxas)):
        for name, (regs, st, ld) in sorted(rep.items()):
            print(f"ptxas ({tag}) {name}: {regs} registers, {st} / {ld} bytes spilled",
                  flush=True)
    stack = kb.ptxas_stack(cuda_build.build_logs["blake3_cols"], WALK_KERNEL)
    print(f"ptxas stack frames of the walk: {stack}", flush=True)
    cur_lib = bind(cuda_build.so_path("blake3_cols"))
    lib_so = cuda_build.so_path("blake3_cols")
    mix = kb.blake3_sass_mix(chain_so, lib_so, (WALK_KERNEL,))
    layouts = kb.chain_layout_mix(chain_so)
    alu, fma, _ = mix["chain"]
    per_s = max(alu, fma, (alu + fma) / 2) / INT_OPS_PER_S
    print(f"build {secs} + probe ({time.perf_counter() - t0:.1f} s); SASS a compression (ALU, "
          f"FMA, all[, SHFL]): probe {mix['chain']}, layouts {layouts}, kernels "
          f"{mix['kernels']}; {per_s * 1e12:.2f} ps at the card's integer rate", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    cv0 = torch.randint(0, 2**32, (8,), generator=gen, device="cuda", dtype=torch.int64)
    node = cv0[None, :, None]
    for _ in range(4):
        node = b3.blake3_parents_plain(node, node, 1, b3.PARENT)
    lat = {}
    for layout in kb.CHAIN_LAYOUTS:
        got = kb.compress_chain(chain_so, cv0, 4, layout)
        if not torch.equal(got, node[0, :, 0]):
            raise AssertionError(f"the probe's {layout} chain != the plain compression")
        lat[layout] = kb.time_kernel(lambda: kb.compress_chain(chain_so, cv0, CHAIN, layout),
                                     reps=3) / CHAIN
    print("one compression's latency (us): "
          + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in lat.items()), flush=True)
    result = {"card": card, "build_s": secs, "ptxas": ptxas, "parent_ptxas": parent_ptxas,
              "stack": stack, "sass": mix, "layouts_sass": layouts,
              "compression_ps": per_s * 1e12, "latency_us": {k: v * 1e3 for k, v in lat.items()},
              "parent": os.path.abspath(args.parent) if args.parent else None, "checks": 0,
              "shapes": {}}
    if not args.no_check:
        result["checks"] = checks(b3, gen, parent_lib)
        print(f"checks: {result['checks']} shapes in both forms, kernel == plain"
              + (" == parent" if parent_lib else ""), flush=True)

    for k, levels in SHAPES:
        digs, sibs, inv, idx, root = tree_inputs(b3, gen, k, levels)
        out = torch.empty((8, k), dtype=torch.int64, device="cuda")
        flag = torch.ones(1, dtype=torch.int32, device="cuda")
        read = int(torch.unique(inv).numel())
        nbytes = 64 * k + 64 * read + 8 * levels * k + 8 * k + 64 * k
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, k * levels * per_s * 1e3
        rec = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
               else "operations", "floor_ms": {lay: levels * v for lay, v in lat.items()}}
        libs = [("this", cur_lib)] if parent_lib is None else [
            ("parent", parent_lib), ("this", cur_lib), ("this", cur_lib), ("parent", parent_lib)]
        for form, kw in (("verifier", {"root": root, "flag": flag}), ("roots", {"out": out})):
            for mode, timer in (("warm", lambda f: kb.time_kernel(f, reps=args.reps)),
                                ("cold", lambda f: kb.time_kernel_cold(f, reps=args.reps))):
                rec[f"{form}_{mode}"] = [(tag, timer(launcher(lib, digs, sibs, inv, idx, **kw)))
                                         for tag, lib in libs]
        if int(flag) != 1 or not torch.equal(out, root[:, None].expand(8, k)):
            raise AssertionError(f"walk {k} x {levels}: an honest path missed the root")
        result["shapes"][f"{k}x{levels}"] = rec
        print(f"walk {k} x {levels}: verifier form warm {rec['verifier_warm']}, cold "
              f"{rec['verifier_cold']}; roots form warm {rec['roots_warm']}, cold "
              f"{rec['roots_cold']} ms; bound {rec['bound_ms']:.4f} ({rec['bound_by']}); "
              f"floor " + ", ".join(f"{lay} {v:.4f}" for lay, v in rec["floor_ms"].items()),
              flush=True)

    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "time_blake3_walk.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
