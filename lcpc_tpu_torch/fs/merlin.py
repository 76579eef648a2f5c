"""merlin 2.0-compatible transcript (STROBE-128 over Keccak-f[1600]).

Byte-compatible reimplementation of the `merlin` crate as used by the
reference (lcpc-2d/src/lib.rs:47-49 FieldHash::transcript_update,
lib.rs:871,904,1027 challenge_bytes).  The STROBE parameters follow
merlin's strobe.rs: security level 128, R = 166, protocol label
"Merlin v1.0", operations meta-AD / AD / PRF only.
"""

from __future__ import annotations

from .keccak import keccak_f1600_bytes

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    """merlin's minimal STROBE-128 (AD / meta-AD / PRF subset)."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals -------------------------------------------------------------
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "flag mismatch on more=True"
            return
        assert flags & FLAG_T == 0, "T flag not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & (FLAG_C | FLAG_K)) != 0
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops ------------------------------------------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


def _encode_usize_as_u32(n: int) -> bytes:
    assert n <= 0xFFFFFFFF
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript equivalent.

    Uses the native C STROBE (lcpc_tpu_torch/utils/native.py) when available — the
    transcript sits on the prove/verify critical path with O(n_per_row)
    appends — and falls back to the pure-Python Strobe128 twin.  Both are
    byte-identical (tested in tests/test_native.py).
    """

    def __init__(self, label: bytes):
        from ..utils import native as _native

        lib = _native.get_lib()
        if lib is not None:
            import ctypes

            self._lib = lib
            self._st = ctypes.create_string_buffer(208)
            lib.lcpc_strobe_init(self._st, self._u8(b"Merlin v1.0"), 11)
            self.strobe = None
        else:
            self._lib = None
            self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    @staticmethod
    def _u8(b: bytes):
        import ctypes

        return ctypes.c_char_p(b)

    def append_message(self, label: bytes, message: bytes) -> None:
        if self._lib is not None:
            self._lib.lcpc_transcript_append(
                self._st, self._u8(label), len(label),
                self._u8(message), len(message),
            )
            return
        # the length is a continuation (more=True) of the label's meta-AD op
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_encode_usize_as_u32(len(message)), True)
        self.strobe.ad(message, False)

    def append_elements(self, label: bytes, rows: "np.ndarray") -> None:
        """Batch-append equal-size messages: rows is (n, esize) uint8."""
        import numpy as np

        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        n, esize = rows.shape
        if self._lib is not None:
            self._lib.lcpc_transcript_append_batch(
                self._st, self._u8(label), len(label),
                rows.ctypes.data, esize, n,
            )
            return
        for i in range(n):
            self.append_message(label, rows[i].tobytes())

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        if self._lib is not None:
            import ctypes

            out = ctypes.create_string_buffer(n)
            self._lib.lcpc_transcript_challenge(
                self._st, self._u8(label), len(label),
                ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), n,
            )
            return out.raw[:n]
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_encode_usize_as_u32(n), True)
        return self.strobe.prf(n, False)
