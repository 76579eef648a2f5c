"""Measurement helpers shared by chip_smoke.py and the kernel scripts
(scripts/sweep_spmv_lanes.py, scripts/time_encode_spmv.py): the card's name
and power limit, device time per kernel call, ptxas's register and spill
report, the SASS of the SpMV kernel's k loop, and random packed operands.

Imports torch and nothing of the port, so a script can time any checkout's
lcpc_tpu_torch with it.  Everything here needs a CUDA device except
`ptxas_report`.
"""

from __future__ import annotations

import collections
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


def find_cuobjdump():
    """The CUDA toolkit's cuobjdump (PATH, then CUDA_HOME), or None."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return shutil.which("cuobjdump") or (cand if os.path.exists(cand) else None)


def sass_loop(so_path, w32=8):
    """The k loop of the W32 kernel in the built library's SASS: the
    backward-branch loop with the most IMADs.  Its IMAD.WIDE.U32(.X) are
    the wide products (one each; the unrolled loop holds several nonzeros).
    Returns (instructions, opcode counts, instructions per wide product, the
    loop's SASS lines) or None without cuobjdump."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if f"spmv_mont_kernelILi{w32}E" in f.split("\n", 1)[0])
    instrs = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t)) for a, t in
              re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
    best = None
    for addr, ins in instrs:
        m = re.match(r"BRA\S*\s+(?:`\()?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= addr:
            loop = [t for a, t in instrs if int(m.group(1), 16) <= a <= addr]
            n_imad = sum(1 for t in loop if t.startswith("IMAD"))
            if best is None or n_imad > best[0]:
                best = (n_imad, loop)
    if best is None:
        return None
    loop = best[1]
    ops = collections.Counter(t.split()[0] for t in loop)
    products = sum(n for op, n in ops.items() if op.startswith("IMAD.WIDE.U32"))
    return len(loop), dict(ops.most_common()), len(loop) / max(1, products), loop
