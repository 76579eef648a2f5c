#!/usr/bin/env python3
"""Do two checkouts' kernels compile to the same machine code?  Builds each
named source of lcpc_tpu_torch/csrc from this checkout and from --parent
DIR with the port's nvcc flags (utils/cuda_build.NVCC_FLAGS), dumps both
libraries' SASS (cuobjdump -sass) and compares it function by function,
instructions and their encodings alike.

    python3 scripts/sass_diff.py --parent DIR [--sources ntt_mont,commit_small,mont_map]

Prints, for each source, the functions whose SASS is identical, those that
differ (with the first differing line of each) and those in one checkout
only; one JSON line last, also written to chiprun_out/sass_diff.json.
Exits 1 when a function of both checkouts differs, unless it is named in
--allow (a comma-separated list of name fragments: kernels the change is
meant to change).  Needs nvcc and cuobjdump (the machine with the card),
not the card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_ROOT, _HERE]

import kernel_bench as kb  # noqa: E402
from lcpc_tpu_torch.utils import cuda_build  # noqa: E402


def build(src, so):
    os.makedirs(os.path.dirname(so), exist_ok=True)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return so


# an anonymous namespace's mangled name carries a hash of its source's path:
# the same source in two checkouts names its kernels apart
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
# a template's last argument `false` (a flag added with that default, as
# mont_mul_map_kernel's WHOLE): the instantiation keeps its old name here
_FLAG_OFF = re.compile(r"Lb0E(?=E)")


def functions(so):
    """{function name: its SASS lines} of a library, cuobjdump's text, the
    anonymous namespaces' path hashes taken out of names and lines, a last
    template argument `false` out of names (_FLAG_OFF)."""
    sass = subprocess.run([kb.find_cuobjdump(), "-sass", so], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", _ANON.sub("_GLOBAL__N__", sass))[1:]:
        head, body = f.split("\n", 1)
        # runs of blanks collapsed: cuobjdump pads every line to the widest
        # instruction of the library, which other functions change
        out[_FLAG_OFF.sub("", head.strip())] = [
            " ".join(ln.split()) for ln in body.splitlines()
            if ln.strip() and not ln.strip().startswith(("Fatbin", "code for", "......"))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the other checkout")
    ap.add_argument("--sources", default="ntt_mont,commit_small,mont_map")
    ap.add_argument("--allow", default="", help="name fragments of functions that may differ")
    args = ap.parse_args()
    if kb.find_cuobjdump() is None:
        raise RuntimeError("cuobjdump not found")
    names = args.sources.split(",")
    allow = [a for a in args.allow.split(",") if a]
    out_dir = os.path.join(_ROOT, "build", "sass_diff")
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(2 * len(names)) as pool:
        for name in names:
            for tag, root in (("parent", os.path.abspath(args.parent)), ("this", _ROOT)):
                src = os.path.join(root, "lcpc_tpu_torch", "csrc", f"{name}.cu")
                so = os.path.join(out_dir, tag, f"lib{name}.so")
                jobs[name, tag] = pool.submit(build, src, so)
        built = {key: f.result() for key, f in jobs.items()}
    result, bad = {}, []
    for name in names:
        a, b = functions(built[name, "parent"]), functions(built[name, "this"])
        same = sorted(f for f in a.keys() & b.keys() if a[f] == b[f])
        differ = {}
        for f in sorted(a.keys() & b.keys() - set(same)):
            first = next((i for i, (x, y) in enumerate(zip(a[f], b[f])) if x != y),
                         min(len(a[f]), len(b[f])))
            differ[f] = {"lines": [len(a[f]), len(b[f])], "first": first,
                         "parent": a[f][first] if first < len(a[f]) else None,
                         "this": b[f][first] if first < len(b[f]) else None}
            if not any(x in f for x in allow):
                bad.append(f)
        result[name] = {"identical": same, "differ": differ,
                        "parent_only": sorted(a.keys() - b.keys()),
                        "this_only": sorted(b.keys() - a.keys())}
        print(f"{name}: {len(same)} functions identical, {len(differ)} differ "
              f"{sorted(differ)}, parent only {result[name]['parent_only']}, this only "
              f"{result[name]['this_only']}", flush=True)
    result["unexpected"] = bad
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "sass_diff.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({name: {k: len(v) for k, v in rec.items()} for name, rec in result.items()
                      if name != "unexpected"} | {"unexpected": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
