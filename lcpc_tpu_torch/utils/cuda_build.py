"""Build and load the port's CUDA kernels: nvcc -> plain-C shared library -> ctypes.

Each source `lcpc_tpu_torch/csrc/<name>.cu` becomes its own library
`build/kernels/lib<name>.so` (gitignored) at first use, compiled for sm_90a.
The sources export plain C entry points (pointers and the stream as void*,
sizes as int) that return the launch's cudaError_t, so no PyTorch header is
compiled: a build takes seconds.  nvcc exists only where the card is; nothing
here runs when the package is imported.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_REPO, "lcpc_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

build_logs: dict[str, str] = {}  # nvcc output (ptxas report) of each source's last build
_libs: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str, force: bool = False) -> float:
    """Compile csrc/<name>.cu into build/kernels/ if stale (older than the
    source or a csrc/ header); returns the seconds spent compiling (0.0 when
    the library was up to date)."""
    src, so = source_path(name), so_path(name)
    headers = glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))
    newest = max(os.path.getmtime(f) for f in [src, *headers])
    if not force and os.path.exists(so) and os.path.getmtime(so) >= newest:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{build_logs[name]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def build_all(names, force: bool = False) -> dict[str, float]:
    """Build several sources at once, one nvcc process each; returns the
    seconds of each build.  Raises if any build failed."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name, force) for name in names}
    return {name: f.result() for name, f in futures.items()}


def load(name: str, bind) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if stale and loaded once;
    `bind(lib)` declares its entry points' argtypes and restype."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(so_path(name))
        bind(lib)
        _libs[name] = lib
    return lib
