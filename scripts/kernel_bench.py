"""Measurement helpers shared by chip_smoke.py and the kernel scripts
(scripts/sweep_spmv_lanes.py, scripts/time_encode_spmv.py): the card's name
and power limit, device time per kernel call, ptxas's register and spill
report, the SASS of the SpMV kernel's k loop, the BLAKE3 compression's
latency probe (scripts/blake3_chain.cu) and its instruction mix by pipe, the
SHA-256 compression's and Merkle parent's (scripts/sha256_chain.cu), with
that probe's op chains (a dependent IADD3, LOP3, SHF, IMAD: latency and one
warp's issue), the generator's threefry probe (scripts/threefry_chain.cu)
and its mix, the hottest loop or block of a built kernel, the nodes of a
CUDA graph captured around a call, and random packed operands.

Imports torch and nothing of the port, so a script can time any checkout's
lcpc_tpu_torch with it.  Everything here needs a CUDA device except
`ptxas_report`.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess

import torch


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_kernel(fn, reps=10):
    """Device ms per call: the calls queue behind a sleeping kernel, so the
    events time back-to-back launches, not the host's issue rate."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
_flush: dict = {}


def flush_l2():
    """Queue an L2 flush on the current stream: write one buffer of
    FLUSH_BYTES, then read another of the same size, so the cache ends
    holding clean lines of neither operand (as after a pass that streamed
    other data), with no dirty line left to write back inside a timed call."""
    dev = torch.cuda.current_device()
    if dev not in _flush:
        n = FLUSH_BYTES // 4
        _flush[dev] = (torch.empty(n, dtype=torch.int32, device="cuda"),
                       torch.ones(n, dtype=torch.int32, device="cuda"), torch.empty(
                           (), dtype=torch.int64, device="cuda"))
    w, r, out = _flush[dev]
    w.fill_(7)
    torch.sum(r, dim=0, dtype=torch.int64, out=out)


def time_kernel_cold(fn, reps=10):
    """Device ms per call with a cold L2: the median of `reps` launches,
    each timed by its own pair of events, with flush_l2 between them
    (outside the timed interval); all queued behind a sleeping kernel, so
    the events time the device, not the host's issue."""
    fn()
    flush_l2()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(4_000_000)
    for start, end in evs:
        flush_l2()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in evs)
    return times[len(times) // 2]


def captured_nodes(fn, path):
    """The stream work of fn(): the nodes of a CUDA graph captured around it
    on a side stream (every kernel, copy and memset it enqueues there; a
    host sync inside fails the capture), from the graph's DOT dump
    (cudaGraphDebugDotPrint, written to `path`): [(node type, label text)],
    e.g. ("KERNEL", ...) with the kernel's function name in the label.  The
    graph is never replayed."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.debug_dump(path)
    del graph
    with open(path) as f:
        dot = f.read()
    nodes = []
    for part in re.split(r'^\s*"[^"]+"\s*\[', dot, flags=re.M)[1:]:
        kind = re.search(r'label=["<][{\s]*(?:<[^>]*>[{\s]*)*([A-Z][A-Z_]+)', part)
        if kind:
            nodes.append((kind.group(1), part))
    return nodes


def random_mont(spec, shape, gen, device="cuda"):
    """Random field elements (< p) as int32 limbs of `shape` (W at dim 1)."""
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=device,
                      dtype=torch.int32)
    top = spec.p >> (16 * (spec.w16 - 1))
    x[:, -1] = torch.randint(0, top, (shape[0], *shape[2:]), generator=gen,
                             device=device, dtype=torch.int32)
    return x


def random_packed(spmv, spec, n, r, gen):
    """n x r random field elements (< p) as packed words (n, r, W32) on the
    card; `spmv` is the port's ops.spmv module."""
    limbs = random_mont(spec, (n, spec.w16, r), gen)
    return spmv.pack_words(limbs, 1).permute(0, 2, 1).contiguous()


def ptxas_report(build_log, kernel="spmv_mont_kernel"):
    """{W32: (registers, spill store bytes, spill load bytes)} of the
    templates of `kernel` from nvcc -v."""
    out, w = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = re.search(rf"{kernel}ILi(\d+)E", line)
            w = int(m.group(1)) if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and w is not None:
            out.setdefault(w, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and w is not None:
            out.setdefault(w, [None, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def ptxas_entries(build_log, kernel):
    """{mangled entry name: (registers, spill store bytes, spill load bytes)}
    of every entry function whose name contains `kernel`, from nvcc -v."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = re.search(r"(?:function '|properties for )(\w+)", line)
            name = m.group(1) if m and kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name is not None:
            out.setdefault(name, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.setdefault(name, [None, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def ptxas_stack(build_log, kernel):
    """{mangled function name: stack frame bytes} of every function whose
    name contains `kernel`, from nvcc -v ("Function properties for ...",
    then "N bytes stack frame")."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"properties for (\w+)", line)
            name = m.group(1) if m and kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name is not None:
            out[name] = int(m.group(1))
    return out


def find_tool(name):
    """A CUDA toolkit program (PATH, then CUDA_HOME), or None."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return shutil.which(name) or (cand if os.path.exists(cand) else None)


def find_cuobjdump():
    return find_tool("cuobjdump")


def sass_functions(so_path):
    """{function name: [(address, instruction without its predicate)]} of
    every kernel in a built library's SASS, or None without cuobjdump."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        head, body = f.split("\n", 1)
        out[head.strip()] = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t)) for a, t in
                             re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
    return out


def _branch_target(ins):
    m = re.match(r"(?:BRA|BSSY|CALL)\S*\s+(?:\S+,\s*)?(?:`\()?0x([0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def _loops(instrs):
    """The instruction lists of every backward-branch loop."""
    for addr, ins in instrs:
        target = _branch_target(ins)
        if ins.startswith("BRA") and target is not None and target <= addr:
            yield [t for a, t in instrs if target <= a <= addr]


def sass_loop(so_path, w32=8):
    """The k loop of the W32 kernel in the built library's SASS: the
    backward-branch loop with the most IMADs.  Its IMAD.WIDE.U32(.X) are
    the wide products (one each; the unrolled loop holds several nonzeros).
    Returns (instructions, opcode counts, instructions per wide product, the
    loop's SASS lines) or None without cuobjdump."""
    funcs = sass_functions(so_path)
    if funcs is None:
        return None
    instrs = next(v for k, v in funcs.items() if f"spmv_mont_kernelILi{w32}E" in k)
    best = max(_loops(instrs), key=lambda lp: sum(t.startswith("IMAD") for t in lp),
               default=None)
    if best is None:
        return None
    ops = collections.Counter(t.split()[0] for t in best)
    products = sum(n for op, n in ops.items() if op.startswith("IMAD.WIDE.U32"))
    return len(best), dict(ops.most_common()), len(best) / max(1, products), best


# Hopper's pipes for the integer mix (the pipe names of Nsight Compute): the
# ALU pipe runs the logic, shift, byte-permute, three-input add, compare and
# select instructions, the FMA pipe the IMAD family (IMAD.IADD, IMAD.SHL,
# IMAD.MOV, ...).  Each takes 64 lanes per SM a clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0); the
# four schedulers of an SM issue 128 lanes' instructions a clock in all.
ALU_OPS = ("LOP3", "LOP", "SHF", "PRMT", "IADD3", "ISETP", "SEL", "LEA", "IABS", "IMNMX")
FMA_OPS = ("IMAD", "IMUL")


def pipe_mix(instrs):
    """(ALU-pipe, FMA-pipe, all) instruction counts of a list of SASS
    instructions; loads, stores, moves and branches count only in `all`."""
    ops = [t.split()[0].split(".")[0] for t in instrs]
    return (sum(op in ALU_OPS for op in ops), sum(op in FMA_OPS for op in ops), len(ops))


def _blocks(instrs):
    """The basic blocks of a function: split at branch targets and after
    branches, exits and barriers."""
    targets = {_branch_target(t) for _, t in instrs} - {None}
    block = []
    for addr, ins in instrs:
        if addr in targets and block:
            yield block
            block = []
        block.append(ins)
        if ins.split()[0].split(".")[0] in ("BRA", "EXIT", "RET", "BSYNC", "BAR", "WARPSYNC",
                                            "CALL", "BSSY"):
            yield block
            block = []
    if block:
        yield block


def blake3_sass_mix(chain_so, lib_so, kernels):
    """The BLAKE3 compression's instruction mix by pipe from the SASS:
    `chain`, the probe's loop body over its CHAIN_PER_TRIP compressions
    (the loop's own instructions shared out among them) as (ALU, FMA,
    all), and for each kernel of the library whose name holds one of
    `kernels`, its longest basic block (the straight-line compression) per
    compression it holds, by the probe's count, as (ALU, FMA, all,
    compressions).  None without cuobjdump."""
    chain_funcs, lib_funcs = sass_functions(chain_so), sass_functions(lib_so)
    if chain_funcs is None or lib_funcs is None:
        return None
    probe = next((v for k, v in chain_funcs.items() if "compress_chain_kernelILb0E" in k),
                 None) or next(v for k, v in chain_funcs.items() if "compress_chain_kernel" in k)
    body = max(_loops(probe), key=lambda lp: pipe_mix(lp)[0])
    chain = tuple(x / CHAIN_PER_TRIP for x in pipe_mix(body))
    per_kernel = {}
    for name, instrs in lib_funcs.items():
        if any(k in name for k in kernels):
            mix = pipe_mix(max(_blocks(instrs), key=lambda b: pipe_mix(b)[0]))
            n = max(1, round((mix[0] + mix[1]) / max(1, chain[0] + chain[1])))
            per_kernel[name] = (*(x / n for x in mix), n)
    return {"chain": chain, "kernels": per_kernel,
            "chain_opcodes": dict(collections.Counter(t.split()[0] for t in body).most_common())}


def chain_layout_mix(chain_so):
    """Each BLAKE3 probe layout's compression by pipe from its loop body's
    SASS (scripts/blake3_chain.cu): {layout: (ALU, FMA, all, SHFL)} a
    compression, the quad's a lane's (its loop body is one compression, the
    one-thread layouts' CHAIN_PER_TRIP); None without cuobjdump."""
    funcs = sass_functions(chain_so)
    if funcs is None:
        return None
    out = {}
    for layout, name, per in (("thread", "compress_chain_kernelILb0E", CHAIN_PER_TRIP),
                              ("fma", "compress_chain_kernelILb1E", CHAIN_PER_TRIP),
                              ("quad", "quad_chain_kernel", 1)):
        probe = next((v for k, v in funcs.items() if name in k), None)
        if probe is None:
            continue
        body = max(_loops(probe), key=lambda lp: pipe_mix(lp)[0])
        shfl = sum(t.split()[0].startswith("SHFL") for t in body)
        out[layout] = tuple(x / per for x in (*pipe_mix(body), shfl))
    return out


CHAIN_PER_TRIP = 4  # compressions (threefry steps) in a probe's loop body (kPerTrip)
CHAIN_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "blake3_chain.cu")
TF_CHAIN_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "threefry_chain.cu")
SHA_CHAIN_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sha256_chain.cu")
SHA_CHAIN_PER_TRIP = 2  # SHA-256 steps in its probes' loop bodies (kPerTrip)
_chain_libs = {}


def build_chain(flags, out_dir, src=CHAIN_SRC):
    """Compile a one-thread chain probe (scripts/blake3_chain.cu, or
    threefry_chain.cu: a library source and the chain kernel) with nvcc
    `flags` into out_dir; returns (the library's path, nvcc's output)."""
    nvcc = find_tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the probe cannot be built")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{os.path.basename(src)[:-3]}.so")
    proc = subprocess.run([nvcc, *flags, "-o", so, src], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


GATHER_PROBE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gather_probe.cu")


class GatherProbe:
    """The random-sector probe (scripts/gather_probe.cu, built by
    build_chain): one 4-byte load per distinct 32-byte sector of a 2 GiB
    buffer, `rows` plane-rows of k sectors each, in ascending or random
    order; the card's floor for a gather whose every element sits in its
    own sector."""

    WORDS = 1 << 29  # 2 GiB of int32

    def __init__(self, so):
        lib = ctypes.CDLL(so)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lcpc_probe_sectors.argtypes = [p, ll, i, ll, i, i, p, p]
        lib.lcpc_probe_l2_granularity.argtypes = [i]
        lib.lcpc_probe_get_l2_granularity.argtypes = [ctypes.POINTER(ll)]
        self.lib = lib
        self.buf = torch.randint(1, 1 << 30, (self.WORDS,), dtype=torch.int32, device="cuda")
        self.sink = torch.zeros(1, dtype=torch.int32, device="cuda")

    def fn(self, rows, k, random=False, evict_first=False):
        """A callable launching one pass over rows x k sectors."""
        stride = (self.WORDS // rows) // 8 * 8

        def run():
            err = self.lib.lcpc_probe_sectors(
                self.buf.data_ptr(), rows, k, stride, int(random), int(evict_first),
                self.sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gather probe launch: cudaError_t {err}")
        return run

    def granularity(self):
        v = ctypes.c_longlong(0)
        if self.lib.lcpc_probe_get_l2_granularity(ctypes.byref(v)) != 0:
            raise RuntimeError("gather probe: cudaDeviceGetLimit failed")
        return v.value

    def set_granularity(self, nbytes):
        """cudaLimitMaxL2FetchGranularity for the whole device."""
        if self.lib.lcpc_probe_l2_granularity(int(nbytes)) != 0:
            raise RuntimeError("gather probe: cudaDeviceSetLimit failed")

    def close(self):
        self.buf = None
        torch.cuda.empty_cache()


# the probe's layouts (scripts/blake3_chain.cu): one thread, one thread with
# its adds on the FMA pipe, one quad of lanes (the path walk's compression)
CHAIN_LAYOUTS = {"thread": "lcpc_blake3_compress_chain", "fma": "lcpc_blake3_compress_chain_fma",
                 "quad": "lcpc_blake3_quad_chain"}


def compress_chain(so, cv, n, layout="thread"):
    """n (a multiple of CHAIN_PER_TRIP) dependent compressions cv <-
    compress(IV, cv || cv, 0, 64, PARENT) of an (8,) int64 CV on the card,
    by the probe `so` in `layout` (CHAIN_LAYOUTS: one thread, one thread
    with its adds on the FMA pipe, one quad of lanes)."""
    lib = _chain_libs.get(so)
    if lib is None:
        lib = _chain_libs[so] = ctypes.CDLL(so)
    fn = getattr(lib, CHAIN_LAYOUTS[layout])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cv = cv.contiguous()
    out = torch.empty(8, dtype=torch.int64, device=cv.device)
    err = fn(cv.data_ptr(), n, out.data_ptr(), torch.cuda.current_stream(cv.device).cuda_stream)
    if err:
        raise RuntimeError(f"compress_chain ({layout}) launch failed: cudaError_t {err}")
    return out


def threefry_chain(so, key, x, n):
    """n (a multiple of CHAIN_PER_TRIP) dependent steps x <- x0 ^ x1 of
    threefry2x32(key, (0, x)) on the card, in one thread of the probe `so`
    (scripts/threefry_chain.cu); returns the last x."""
    lib = _chain_libs.get(so)
    if lib is None:
        lib = _chain_libs[so] = ctypes.CDLL(so)
        lib.lcpc_threefry_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.lcpc_threefry_chain.restype = ctypes.c_int
    inp = torch.tensor([key[0], key[1], x], dtype=torch.int64, device="cuda")
    out = torch.empty(1, dtype=torch.int64, device="cuda")
    err = lib.lcpc_threefry_chain(inp.data_ptr(), n, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"threefry_chain launch failed: cudaError_t {err}")
    return int(out.item())


def _probe_mix(funcs, kernel, per_trip=CHAIN_PER_TRIP):
    """((ALU, FMA, all) a step, the body's opcodes) of a chain probe's loop
    body over its per_trip steps (the loop's own instructions shared out
    among them), `kernel` naming the probe's function."""
    probe = next(v for k, v in funcs.items() if kernel in k)
    body = max(_loops(probe), key=lambda lp: pipe_mix(lp)[0])
    return (tuple(x / per_trip for x in pipe_mix(body)),
            dict(collections.Counter(t.split()[0] for t in body).most_common()))


def threefry_sass_mix(chain_so):
    """One generator digit's instruction mix by pipe, from the SASS of the
    threefry probe's loop body: ((ALU, FMA, all), the body's opcodes), or
    None without cuobjdump."""
    funcs = sass_functions(chain_so)
    return None if funcs is None else _probe_mix(funcs, "threefry_chain_kernel")


def sha256_chain(so, h, n, parent):
    """n (a multiple of SHA_CHAIN_PER_TRIP) dependent SHA-256 steps of an (8,)
    int64 state on the card, in one thread of the probe `so`
    (scripts/sha256_chain.cu): compressions h <- compress(h, h || h), or
    with `parent` Merkle parents h <- parent(h, h) (parent = 2: the tree's
    compact parent, where the probe has it); returns the last h."""
    lib = _chain_libs.get(so)
    if lib is None:
        lib = _chain_libs[so] = ctypes.CDLL(so)
        lib.lcpc_sha256_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.lcpc_sha256_chain.restype = ctypes.c_int
    h = h.contiguous()
    out = torch.empty(8, dtype=torch.int64, device=h.device)
    err = lib.lcpc_sha256_chain(h.data_ptr(), n, int(parent), out.data_ptr(),
                                torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"sha256_chain launch failed: cudaError_t {err}")
    return out


# the SHA-256 column kernels' templates by mangled name: the wide kernel's
# update over int32 words, the few-column kernel's finish over int32 words
# (verify's opened columns)
SHA_WIDE_UPDATE = "sha256_cols_kernelIiLb0E"
# the probe's unrolled parent chain (the walk's parent; the tree's compact one
# runs the same rounds in loops), whose loop body is a parent's instructions;
# an older probe has one parent chain, untemplated
SHA_PARENT_CHAIN = ("sha256_parent_chain_kernelILb0E", "sha256_parent_chain_kernel")
SHA_FEW_FINISH = "sha256_few_kernelIiLb1E"


def sha256_sass_mix(chain_so, lib_so):
    """SHA-256's instruction mix by pipe from the SASS: `compress`, one
    scheduled compression, and `parent`, one Merkle parent (a scheduled
    compression and one over the constant padding block), each from its
    probe's loop body as ((ALU, FMA, all), opcodes); `cols_loop`, the wide
    column kernel's block loop (an update's: one compression, its 16 word
    loads and the loop's own instructions) as (ALU, FMA, all); `few_rounds`,
    the few-column kernel's round-warp block loop (64 rounds from the ring,
    its 16 loads from the ring and the barriers: the loop that reads shared
    memory) as (ALU, FMA, all), or None in a library without that kernel.
    None without cuobjdump."""
    chain_funcs, lib_funcs = sass_functions(chain_so), sass_functions(lib_so)
    if chain_funcs is None or lib_funcs is None:
        return None

    def loop_mix(name, reads_smem=False):
        instrs = next((v for k, v in lib_funcs.items() if name in k), None)
        loops = [] if instrs is None else [
            lp for lp in _loops(instrs) if not reads_smem or any(t.startswith("LDS") for t in lp)]
        return pipe_mix(max(loops, key=lambda lp: pipe_mix(lp)[0])) if loops else None

    return {"compress": _probe_mix(chain_funcs, "sha256_compress_chain_kernel",
                                   SHA_CHAIN_PER_TRIP),
            "parent": _probe_mix(chain_funcs, next(n for n in SHA_PARENT_CHAIN
                                                   if any(n in k for k in chain_funcs)),
                                 SHA_CHAIN_PER_TRIP),
            "cols_loop": loop_mix(SHA_WIDE_UPDATE),
            "few_rounds": loop_mix(SHA_FEW_FINISH, reads_smem=True)}


def hot_code(so_path, name, loop=True):
    """((ALU, FMA, all), opcodes) of the first function of a built library
    whose name holds `name`: its loop with the most ALU instructions, or
    with loop=False its basic block with the most; None without cuobjdump
    or the function."""
    funcs = sass_functions(so_path)
    instrs = None if funcs is None else next((v for k, v in funcs.items() if name in k), None)
    if instrs is None:
        return None
    parts = list(_loops(instrs)) if loop else list(_blocks(instrs))
    best = max(parts, key=lambda b: pipe_mix(b)[0], default=[])
    return pipe_mix(best), dict(collections.Counter(t.split()[0] for t in best).most_common())


# SASS opcodes with no register result (their first operand is read)
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "EXIT", "RET", "BSSY", "BSYNC",
            "WARPSYNC", "CALL", "NOP", "DEPBAR", "MEMBAR", "ERRBAR", "CCTL", "YIELD")
_LOADS = ("LD", "LDS", "LDG", "LDL", "LDC", "ULDC", "S2R", "S2UR", "CS2R", "LDSM")


def _regs(operand, width=1):
    """The registers an operand names (R5, [R2+0x10], R4.64: a pair)."""
    out = []
    for m in re.finditer(r"\bR(\d+)(\.64)?\b", operand):
        n = int(m.group(1))
        out += [n + i for i in range(2 if m.group(2) else width)]
    return out


def sass_chain(instrs, latency, trips=3):
    """The longest read-after-write chain through a loop body's SASS
    (instruction strings, straight-line) run `trips` times in a row, so that
    the registers the body carries over link one trip to the next.  Each
    instruction with a register result waits for its register operands and
    takes latency(opcode) cycles; loads, constants and the first trip's
    inputs are ready at the start (the chain is the ALU / FMA work on the
    critical path).  Returns (cycles, {opcode: count}) of the last trip's
    part of the chain: the body's steady-state critical path a trip."""
    parsed = []  # the instructions with a register result
    for ins in instrs:
        op, _, rest = ins.partition(" ")
        base = op.split(".")[0]
        parts = [p.strip() for p in rest.split(",")] if rest else []
        if base in _NO_DEST or not parts or not re.fullmatch(r"R\d+", parts[0]):
            continue
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
        parsed.append((op, base, _regs(parts[0], width), [r for p in parts[1:] for r in _regs(p)]))
    ready = {}  # register -> (cycles, index, predecessor node)
    best = (0.0, -1, None)
    n = len(parsed)
    for i in range(trips * n):
        op, base, dest, srcs = parsed[i % n]
        if base in _LOADS:
            for r in dest:
                ready[r] = (0.0, -1, None)
            continue
        prev = max((ready[r] for r in srcs if r in ready), key=lambda x: x[0],
                   default=(0.0, -1, None))
        node = (prev[0] + latency(op), i, prev)
        for r in dest:
            ready[r] = node
        if node[0] > best[0]:
            best = node
    ops, node, cycles = collections.Counter(), best, 0.0
    last = (trips - 1) * n
    while node is not None and node[1] >= last:
        op = parsed[node[1] % n][0]
        ops[op] += 1
        cycles += node[0] - (node[2][0] if node[2] is not None else 0.0)
        node = node[2]
    return cycles, dict(ops.most_common())


def sha256_sass_chains(chain_so, lib_so, op_lat):
    """SHA-256's critical paths as ptxas emitted them (sass_chain): for the
    few-column kernel's round loop a round, for the probe's unrolled parent
    (the walk's) and compression a step, for the compact parent (the
    tree's) a round of its 16-round trips.  op_lat: op_latencies' {kind:
    (cycles, ns)}; an opcode of no measured kind takes IADD3's latency.
    Each entry is (cycles, {opcode: count}); None without cuobjdump."""
    chain_funcs, lib_funcs = sass_functions(chain_so), sass_functions(lib_so)
    if chain_funcs is None or lib_funcs is None:
        return None

    def latency(op):
        base = op.split(".")[0]
        return op_lat.get(base, op_lat["IADD3"])[0]

    def per(cycles_ops, k):
        cycles, ops = cycles_ops
        return cycles / k, {o: c / k for o, c in ops.items()}

    def body(funcs, name, pick):
        instrs = next((v for k, v in funcs.items() if name in k), None)
        loops = [] if instrs is None else [lp for lp in _loops(instrs) if pick(lp)]
        return max(loops, key=lambda lp: pipe_mix(lp)[0]) if loops else None

    out = {}
    few = body(lib_funcs, SHA_FEW_FINISH, lambda lp: any(t.startswith("LDS") for t in lp))
    if few is not None:
        out["few_round"] = per(sass_chain(few, latency), 64)
    for key, name, k in (("parent", SHA_PARENT_CHAIN[0], SHA_CHAIN_PER_TRIP),
                         ("compress", "sha256_compress_chain_kernel", SHA_CHAIN_PER_TRIP)):
        lp = body(chain_funcs, name, lambda lp: True)
        if lp is not None:
            out[key] = per(sass_chain(lp, latency), k)
    # the compact parent's 16-round trips: its inner loops, the probe's
    # outer loop holding them excluded (it has backward branches inside)
    lp = body(chain_funcs, "sha256_parent_chain_kernelILb1E",
              lambda lp: not any(t.startswith("BRA") for t in lp[:-1]))
    if lp is not None:
        out["compact_round"] = per(sass_chain(lp, latency), 16)
    return out


OP_CHAINS = ("IADD3", "LOP3", "SHF", "IMAD")  # lcpc_op_chain's kinds, in its order


def op_chain(so, op, n, wide=False):
    """n (a multiple of 64) instructions of kind OP_CHAINS[op] in one thread
    of the probe `so` (scripts/sha256_chain.cu), in one dependent chain or,
    with `wide`, eight independent ones: the loop's clock64() cycles.
    Returns (cycles, the launch's device ms), or None without the probe's
    op chains."""
    lib = _chain_libs.get(so)
    if lib is None:
        lib = _chain_libs[so] = ctypes.CDLL(so)
    if not hasattr(lib, "lcpc_op_chain"):
        return None
    lib.lcpc_op_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.lcpc_op_chain.restype = ctypes.c_int
    v0 = torch.arange(3, 3 + 16, dtype=torch.int64, device="cuda") * 0x9E3779B1
    out = torch.empty(2, dtype=torch.int64, device="cuda")

    def run():
        err = lib.lcpc_op_chain(op, int(wide), v0.data_ptr(), n, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"op_chain launch failed: cudaError_t {err}")

    ms = time_kernel(run, reps=3)
    return int(out[1].item()), ms


def op_chain_counts(chain_so, wide=False):
    """{kind: the chains' instructions of that kind in its probe loop's SASS}
    (an IADD3 with an immediate operand is the loop's counter, not a chain),
    or None without cuobjdump."""
    funcs = sass_functions(chain_so)
    if funcs is None:
        return None
    out = {}
    for i, kind in enumerate(OP_CHAINS):
        name = f"op_chain_kernelILi{i}ELi{8 if wide else 1}E"
        instrs = next((v for k, v in funcs.items() if name in k), None)
        if instrs is None:
            return None
        body = max(_loops(instrs), key=len)
        out[kind] = sum(1 for t in body if t.split()[0].split(".")[0] == kind
                        and not (kind == "IADD3" and "0x" in t))
    return out


def op_latencies(chain_so, n=1 << 20, wide=False):
    """{kind: (cycles, ns) an instruction} from the probe's op chains: a
    dependent instruction's latency, or with `wide` one warp's issue of one
    of eight independent ones; None where the probe or cuobjdump lacks them.
    Each loop body holds 64 steps (kOpPerTrip)."""
    counts = op_chain_counts(chain_so, wide)
    if counts is None:
        return None
    out = {}
    for i, kind in enumerate(OP_CHAINS):
        got = op_chain(chain_so, i, n, wide)
        if got is None or not counts[kind]:
            return None
        cycles, ms = got
        per_trip = counts[kind]  # the chain's instructions in 64 steps
        steps = n // 64 * per_trip
        out[kind] = (cycles / steps, ms * 1e6 / steps)
    return out


def sass_mix(so_path, kernel):
    """(ALU-pipe, FMA-pipe, all) instruction counts of the whole first
    function of a built library whose name holds `kernel` (a straight-line
    kernel: one thread's work), or None without cuobjdump."""
    funcs = sass_functions(so_path)
    if funcs is None:
        return None
    instrs = next(v for k, v in funcs.items() if kernel in k)
    return pipe_mix([t for _, t in instrs])
