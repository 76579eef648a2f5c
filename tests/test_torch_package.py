"""The port's import boundary: lcpc_tpu_torch, chip_smoke.py and its helper
module scripts/kernel_bench.py use neither JAX nor the JAX package, and
importing the port loads neither."""

import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|lcpc_tpu)(\b(?!_torch)|\.)",
                        re.M)


def _port_sources():
    pkg = os.path.join(_REPO, "lcpc_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                yield os.path.join(root, name)
    yield os.path.join(_REPO, "chip_smoke.py")
    yield os.path.join(_REPO, "scripts", "kernel_bench.py")


def test_sources_import_neither_jax_nor_reference():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        offenders += [(path, m.group(0).strip()) for m in _FORBIDDEN.finditer(text)]
        offenders += [(path, "import_module")
                      for _ in re.finditer(r"import_module\(['\"](jax|lcpc_tpu)\b", text)]
    assert offenders == []


def test_pattern_catches_forbidden_imports():
    assert _FORBIDDEN.search("import jax\n")
    assert _FORBIDDEN.search("from lcpc_tpu.ops import limbs\n")
    assert _FORBIDDEN.search("    from jax import numpy\n")
    assert _FORBIDDEN.search("import jaxlib\n")
    assert not _FORBIDDEN.search("from lcpc_tpu_torch import wire\n")


_MODULES = ["lcpc_tpu_torch", "lcpc_tpu_torch.convert", "lcpc_tpu_torch.ops.ntt",
            "lcpc_tpu_torch.encodings.ligero", "lcpc_tpu_torch.ops.sha256",
            "lcpc_tpu_torch.utils.cuda_build"]


@pytest.mark.parametrize("rel", ["ops/ntt.py", "encodings/ligero.py", "ops/sha256.py",
                                 "utils/cuda_build.py", "csrc/ntt_mont.cu",
                                 "csrc/spmv_mont.cu"])
def test_scan_covers_module(rel):
    assert os.path.join(_REPO, "lcpc_tpu_torch", rel) in set(_port_sources())


def test_import_loads_neither():
    code = (f"import sys, {', '.join(_MODULES)}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'lcpc_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
