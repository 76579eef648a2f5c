"""The kernel build helper (utils/cuda_build.py) on the CPU, with a stand-in
for nvcc: a stale library is rebuilt and a fresh one is not, several
sources build at once with their logs kept, a failed build raises with the
compiler's output and leaves no partial library, and a missing nvcc raises.
The real nvcc runs only where the card is (chip_smoke.py phase 2)."""

import os
import stat
import time

import pytest

from lcpc_tpu_torch.ops import spmv
from lcpc_tpu_torch.utils import cuda_build

FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac
done
if grep -q FAIL "$src"; then echo "error: $src does not compile" >&2; exit 1; fi
echo "ptxas info    : Used 10 registers"
cp "$src" "$out"
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ and build/ pair and a stand-in nvcc on PATH."""
    csrc, build, bin_dir = tmp_path / "csrc", tmp_path / "build", tmp_path / "bin"
    for d in (csrc, bin_dir):
        d.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}:/usr/bin:/bin")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(cuda_build, "build_logs", {})
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// kernel {name}\n")
    return csrc, build


def test_build_when_stale_and_not_when_fresh(tree):
    csrc, build = tree
    assert cuda_build.build("a") > 0.0
    so = cuda_build.so_path("a")
    assert so == str(build / "liba.so") and os.path.exists(so)
    assert "Used 10 registers" in cuda_build.build_logs["a"]
    assert cuda_build.build("a") == 0.0                    # up to date
    assert cuda_build.build("a", force=True) > 0.0
    later = time.time() + 10
    os.utime(csrc / "a.cu", (later, later))                # the source changed
    assert cuda_build.build("a") > 0.0


def test_build_all_builds_each_source(tree):
    _, build = tree
    secs = cuda_build.build_all(["a", "b"], force=True)
    assert set(secs) == {"a", "b"} and all(s > 0.0 for s in secs.values())
    assert sorted(os.listdir(build)) == ["liba.so", "libb.so"]
    assert set(cuda_build.build_logs) == {"a", "b"}


def test_failed_build_raises_and_leaves_nothing(tree):
    csrc, build = tree
    (csrc / "b.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="does not compile"):
        cuda_build.build_all(["a", "b"])
    assert sorted(os.listdir(build)) == ["liba.so"]        # no partial libb.so


def test_missing_nvcc_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("a")


def test_kernel_modules_name_their_libraries():
    assert spmv.SO_PATH == cuda_build.so_path("spmv_mont")
    for name in ("spmv_mont", "ntt_mont"):
        assert os.path.exists(cuda_build.source_path(name))
    assert spmv.NVCC_FLAGS is cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert spmv.build_log == cuda_build.build_logs.get("spmv_mont", "")
