"""Loader for the shared native C runtime (`native/lcpc_native.c`), via ctypes.

The C library provides the production transcript (Keccak-f/STROBE/merlin)
and the expander-matrix sampler; the pure-Python code in
`lcpc_tpu_torch.fs` and `encodings.brakedown.gen_code` stays as the bit-exact
twin and the fallback when no C compiler is available.

The source is shared with the reference package, but the port compiles it
into its own build directory (`build/native/`, listed in .gitignore) and
never writes under `native/`.  The compile goes to a temporary name and is
renamed into place, so concurrent first uses (test workers) are safe.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "lcpc_native.c")
BUILD_DIR = os.path.join(_REPO, "build", "native")
_SO = os.path.join(BUILD_DIR, "liblcpc_native.so")

_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                continue
            os.replace(tmp, _SO)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    p = ctypes.c_void_p  # accepts ints (numpy .ctypes.data) and ctypes bufs
    lib.lcpc_strobe_init.argtypes = [p, p, ctypes.c_size_t]
    lib.lcpc_strobe_meta_ad.argtypes = [p, p, ctypes.c_size_t, ctypes.c_int]
    lib.lcpc_strobe_ad.argtypes = [p, p, ctypes.c_size_t, ctypes.c_int]
    lib.lcpc_strobe_prf.argtypes = [p, p, ctypes.c_size_t]
    lib.lcpc_transcript_append.argtypes = [
        p, p, ctypes.c_size_t, p, ctypes.c_size_t
    ]
    lib.lcpc_transcript_append_batch.argtypes = [
        p, p, ctypes.c_size_t, p, ctypes.c_size_t, ctypes.c_size_t,
    ]
    lib.lcpc_transcript_challenge.argtypes = [p, p, ctypes.c_size_t, p,
                                              ctypes.c_size_t]
    u64 = ctypes.c_uint64
    lib.lcpc_rng_init.argtypes = [p, p, u64]
    lib.lcpc_gen_code.argtypes = [p, u64, u64, u64, p, ctypes.c_int, u64,
                                  p, p]
    for fn in (lib.lcpc_strobe_init, lib.lcpc_strobe_meta_ad,
               lib.lcpc_strobe_ad, lib.lcpc_strobe_prf,
               lib.lcpc_transcript_append, lib.lcpc_transcript_append_batch,
               lib.lcpc_transcript_challenge, lib.lcpc_rng_init,
               lib.lcpc_gen_code):
        fn.restype = None
    _lib = lib
    return _lib


RNG_STATE_BYTES = 320  # sizeof(lcpc_rng_t), padded
