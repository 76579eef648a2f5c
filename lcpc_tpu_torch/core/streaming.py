"""Streaming commit: encode and hash by row blocks without holding the codeword
(port of lcpc_tpu/core/streaming.py).

For large polynomials the encoded matrix exceeds device memory: a 2^28 ft255
rho = 1/4 Ligero commit is 2,048 rows x 524,288 columns, 68.7 GB of
Montgomery limbs and 34.4 GB of hash words.  `commit_streaming` runs the
commit over row blocks instead: each block is encoded to its column-hash
words alone (`LcEncoding.encode_rows_words_only`), folded into per-column
BLAKE3 chunk state (`StreamingColumnHasher`, over the two kernels of
csrc/blake3_cols.cu), optionally retained, then dropped.  Only the
coefficients (behind a CoeffSource, core/coeffs.py), the Merkle array and,
where it fits, the packed canonical codeword persist.

The column hash state is exact: BLAKE3 chunks never align with element rows
(the 32-byte zero prefix shifts everything by 8 words), so the hasher keeps
a carry buffer of sub-chunk words.  Row blocks whose word count is a multiple
of the 256-word chunk keep that carry at the prefix's 8 words.

`prove_streaming` takes lcpc_tpu's routes.  It collapses the coefficients
by prove-sized row blocks through MxuCollapse (ops/mxu_prove.py), each
block's product a partial that one launch sums.  It opens columns from the
retained words, from the systematic coefficients plus a retained tail
(Brakedown), from the host copy, or, with no words kept, by evaluating the
opened columns directly (`_open_by_eval`: MxuColumnEval over prove-sized
blocks, a Reed-Solomon code's columns being its rows at w^bitrev(c)) or by
re-encoding every block (`_open_by_reencode`, the other codes).  Its proof is an ordinary LcEvalProof: `verify` checks it,
and its bytes equal the in-memory prove's.

Column hashing is BLAKE3 (StreamingColumnHasher) or SHA-256
(StreamingSha256Hasher, over the kernel of csrc/sha256_cols.cu), each
update one launch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import numpy as np
import torch

from ..fs.merlin import Transcript
from ..ops import blake3, sha256
from ..ops.digest import BLAKE3, DeviceDigest
from ..ops.mont_map import mont_mul_map
from ..ops.mxu_prove import MxuCollapse, MxuColumnEval
from ..utils import hbm
from . import coeffs as coeffs_mod
from .encoding import LcEncoding
from .protocol import (
    LcEvalProof,
    ProverError,
    _next_pow2,
    _open_batched,
    _pack_pairs,
    prove_core,
)


class StreamingColumnHasher:
    """Per-column BLAKE3 over row blocks with a sub-chunk carry buffer.

    update() hashes the stream's whole chunks with one blake3_chunks launch
    (the carry buffer's words first, then the block's) and keeps the rest,
    fewer than 256 words, as the next carry; it never consumes the final
    chunk, whose flags finalize() sets.  Between calls the state is the
    chunk CVs, the carry and the counts."""

    def __init__(self, n_cols: int, total_words: int, device):
        self.n_cols = n_cols
        self.total_words = total_words  # includes the 8-word zero prefix
        self.n_chunks = max(1, -(-total_words // blake3.CHUNK_WORDS))
        assert self.n_chunks > 1, "streaming hasher expects multi-chunk columns"
        self.chunk_cvs = torch.empty((self.n_chunks, 8, n_cols), dtype=torch.int32,
                                     device=device)
        self.buf = torch.zeros((blake3.CHUNK_WORDS, n_cols), dtype=torch.int32, device=device)
        self.buf_len = blake3.PREFIX_WORDS  # the zero prefix
        self.words_done = 0
        self.chunks_done = 0

    @staticmethod
    def resident_bytes(n_cols: int, total_words: int) -> int:
        """Device bytes the hasher holds for the whole commit: the chunk CVs
        (and the merge's first two levels) and the carry."""
        n_chunks = -(-total_words // blake3.CHUNK_WORDS)
        return ((n_chunks + (n_chunks + 1) // 2 + (n_chunks + 3) // 4) * 8 * n_cols * 4
                + blake3.CHUNK_WORDS * n_cols * 4)

    def update(self, words: torch.Tensor) -> None:
        """words: (L, n_cols) u32 words (int32 storage) appended to every
        column's stream."""
        l = words.shape[0]
        total = self.buf_len + l
        n_full = total // blake3.CHUNK_WORDS
        # never consume the final chunk here; finalize() handles its flags
        is_final = self.words_done + l + blake3.PREFIX_WORDS == self.total_words
        if is_final and total % blake3.CHUNK_WORDS == 0 and n_full > 0:
            n_full -= 1
        if n_full:
            c0 = self.chunks_done
            blake3.blake3_chunks(words, self.chunk_cvs[c0 : c0 + n_full], carry=self.buf,
                                 carry_len=self.buf_len, chunk_base=c0)
        start = n_full * blake3.CHUNK_WORDS  # stream words [start, total) carry over
        if start >= self.buf_len:
            rest = words[start - self.buf_len :]
            self.buf[: rest.shape[0]] = rest
        else:  # no chunk completed: the block joins the carry
            self.buf[self.buf_len : total] = words
        self.buf_len = total - start
        self.words_done += l
        self.chunks_done += n_full

    def finalize(self) -> torch.Tensor:
        """Hash the final partial chunk and merge the chunk tree: (8, n_cols)
        int64 digests."""
        assert self.words_done + blake3.PREFIX_WORDS == self.total_words, (
            self.words_done, self.total_words)
        rem = self.buf_len
        assert rem > 0 and self.chunks_done + 1 == self.n_chunks
        c0 = self.chunks_done
        blake3.blake3_chunks(self.buf[:0], self.chunk_cvs[c0 : c0 + 1], carry=self.buf,
                             carry_len=rem, chunk_base=c0, final_len=rem)
        chunk_cvs, self.chunk_cvs, self.buf = self.chunk_cvs, None, None
        return blake3.merge_chunk_cvs(chunk_cvs)


class StreamingSha256Hasher:
    """Per-column SHA-256 over row blocks (lcpc_tpu/core/streaming.py:448),
    over the kernel of csrc/sha256_cols.cu (ops/sha256.py: sha256_cols).

    Same update/finalize interface as StreamingColumnHasher and equal to
    sha256.hash_word_columns over the concatenated stream; SHA-256 has no
    chunk tree, so the state is the chaining value (8, C) and a carry of
    fewer than 16 words (16, C), both int32 on the encoding's device.
    update() is one launch: the carry and the block's words through their
    whole 64-byte blocks, the rest kept as the next carry (a block shorter
    than the carry's free space only appends); finalize() is one launch:
    the carry, the padding and the 64-bit length."""

    def __init__(self, n_cols: int, total_words: int, device):
        self.total_words = total_words  # includes the 8-word zero prefix
        self.h = sha256.h0_state(n_cols, device)
        self.buf = torch.zeros((sha256.BLOCK_WORDS, n_cols), dtype=torch.int32, device=device)
        self.buf_len = sha256.PREFIX_WORDS  # the zero prefix
        self.words_done = 0

    @staticmethod
    def resident_bytes(n_cols: int, total_words: int) -> int:
        """Device bytes the hasher holds for the whole commit: the chaining
        value and the carry, 24 int32 words a column."""
        return (8 + sha256.BLOCK_WORDS) * 4 * n_cols

    def update(self, words: torch.Tensor) -> None:
        """words: (L, n_cols) u32 words (int32 storage) appended to every
        column's stream."""
        self.buf_len = sha256.sha256_cols(words, cv=self.h, carry=self.buf,
                                          carry_len=self.buf_len)
        self.words_done += words.shape[0]

    def finalize(self) -> torch.Tensor:
        """The final block(s), padding and the 64-bit length: (8, n_cols)
        int64 digests (LE words)."""
        assert self.words_done + sha256.PREFIX_WORDS == self.total_words, (
            self.words_done, self.total_words)
        out = sha256.sha256_cols(self.buf[:0], cv=self.h, carry=self.buf,
                                 carry_len=self.buf_len, total_words=self.total_words)
        self.h = self.buf = None
        return out


# streaming hashers by digest name (the digest= plug point of the streaming
# path; protocol.commit covers the non-streaming one)
_STREAM_HASHERS = {"blake3": StreamingColumnHasher, "sha256": StreamingSha256Hasher}


@dataclasses.dataclass
class LcCommitStreaming:
    """Commit state without the Montgomery codeword matrix.

    When the packed CANONICAL codeword fits the device keep budget it is
    retained (words_dev, (n_rows*W/2, n_cols - words_off) int32 storage of
    u32 words) and prove gathers opened columns there; with spill="host" it
    is retained in host RAM instead (words_host); otherwise prove re-encodes
    the coefficient blocks.  `coeffs` is the (W or W/2, n_rows, n_per_row)
    device matrix when the source is array-backed, else None.  Like
    LcCommit, the Merkle array stays on the device as digest words."""

    enc: LcEncoding
    source: coeffs_mod.CoeffSource
    coeffs: "torch.Tensor | None"
    n_rows: int
    n_per_row: int
    n_cols: int
    hashes_dev: torch.Tensor  # (8, 2*np2-1) int64 digest words, leaves first
    row_block: int
    digest: DeviceDigest = BLAKE3
    words_dev: "torch.Tensor | None" = None
    words_off: int = 0  # words_dev holds columns [words_off:] only (tail keep)
    words_host: "np.ndarray | None" = None  # (n_rows*W/2, n_cols) uint32
    packed: bool = False  # coeffs held as (W/2, n_rows, n_per_row) words
    _hashes_np: "np.ndarray | None" = None
    _root: "bytes | None" = None

    @property
    def hashes(self) -> np.ndarray:
        if self._hashes_np is None:
            self._hashes_np = blake3.digests_to_bytes(self.hashes_dev)
        return self._hashes_np

    def get_root(self) -> bytes:
        if self._root is None:
            self._root = blake3.digests_to_bytes(self.hashes_dev[:, -1:])[0].tobytes()
        return self._root

    def get_n_rows(self) -> int:
        return self.n_rows

    def get_n_per_row(self) -> int:
        return self.n_per_row

    def get_n_cols(self) -> int:
        return self.n_cols

    def prove(self, outer_tensor: list[int], tr: Transcript) -> LcEvalProof:
        return prove_streaming(self, outer_tensor, self.enc, tr)


def _row_block_for(enc: LcEncoding, n_rows: int, requested: "int | None",
                   resident_bytes: int = 0) -> int:
    """The encode/hash row block: sized from the device budget (hbm.py) less
    the arrays resident for the whole commit, over the encoding's own block
    footprint per row (stream_bytes_per_row), unless `requested`.  Blocks
    of at least a 256-word boundary's rows are rounded to it (the carry
    stays at the prefix's 8 words); smaller ones fall back to a power of
    two (floor 8 rows), whose carry cycles through a few lengths."""
    wpe = enc.spec.w16 // 2
    if requested is None:
        usable = hbm.usable_hbm_bytes(enc.device)
        if usable - resident_bytes < 512 << 20:
            warnings.warn(
                f"streaming commit: resident arrays ({resident_bytes >> 20} MiB) leave "
                f"under 512 MiB of the {usable >> 20} MiB usable for block transients; "
                "falling back to minimum-size row blocks")
        budget = max(min(hbm.stream_bytes(enc.device), usable - resident_bytes), 512 << 20)
        requested = max(32, budget // enc.stream_bytes_per_row())
    rb = max(1, min(requested, n_rows))
    align = 256 // math.gcd(256, wpe)  # rows per 256-word boundary
    if rb >= align:
        return (rb // align) * align
    return 1 << max(3, rb.bit_length() - 1)


def commit_streaming(coeffs, enc: LcEncoding, row_block: "int | None" = None,
                     digest: DeviceDigest = BLAKE3, packed: "bool | None" = None,
                     spill: str = "auto") -> LcCommitStreaming:
    """Streaming commit over row blocks on the encoding's device (see the
    module docstring); the root equals commit()'s.

    `coeffs` is a list of canonical ints, a (W, N) Montgomery limb tensor or
    a packed (W/2, N) int32 word tensor (the layout inferred from the shape
    unless `packed=` says it), a numpy array of either (kept in host RAM),
    or a CoeffSource.

    `spill` says where the packed canonical codeword is retained for
    prove's column gather:
      "auto"   on the device when it fits hbm.keep_bytes_budget, else (a
               systematic encoding) only its non-systematic tail when that
               fits, else nowhere;
      "device" on the device;
      "host"   in host RAM, block by block;
      "none"   nowhere (prove re-encodes blocks).
    """
    hasher_cls = _STREAM_HASHERS.get(digest.name)
    if hasher_cls is None:
        raise ValueError(f"no streaming hasher for digest {digest.name!r}")
    if spill not in ("auto", "device", "host", "none"):
        raise ValueError(f"spill must be auto, device, host or none, got {spill!r}")
    device = enc.device
    source = coeffs_mod.as_source(coeffs, enc.spec, packed=packed, device=device)
    # compared resolved: "cuda" and "cuda:0" are one device
    if torch.empty(0, device=source.device).device != torch.empty(0, device=device).device:
        raise ValueError(f"commit_streaming: the source's blocks lie on {source.device}, "
                         f"the encoding runs on {device}")
    n_rows, n_per_row, n_cols = enc.get_dims(source.length)
    if not enc.dims_ok(n_per_row, n_cols):
        raise ProverError("TooBig", "n_cols is too large for this encoding")
    source.set_dims(n_rows, n_per_row)
    array_backed = isinstance(source, coeffs_mod.ArrayCoeffSource)

    wpe = enc.spec.w16 // 2
    total_words = blake3.PREFIX_WORDS + n_rows * wpe
    keep_bytes = n_rows * wpe * n_cols * 4
    keep = (keep_bytes <= hbm.keep_bytes_budget(device) if spill == "auto"
            else spill == "device")
    # tail keep: a systematic encoding's first n_per_row columns are the
    # coefficients (Brakedown, [x | z | v], encode.rs:36-94), which prove can
    # take from the source; retaining the rest turns prove's column opening
    # from a re-encode of every block into two gathers
    words_off = 0
    sys_pref = getattr(enc, "systematic_prefix", 0)
    if (spill == "auto" and not keep and sys_pref
            and not isinstance(source, coeffs_mod.HostCoeffSource)):
        tail_bytes = n_rows * wpe * (n_cols - sys_pref) * 4
        if tail_bytes <= hbm.keep_bytes_budget(device):
            keep, words_off, keep_bytes = True, sys_pref, tail_bytes

    # arrays resident for the whole commit, which the block transients fit
    # beside: coefficients, the retained words, the hasher's state
    resident = (source.resident_bytes + (keep_bytes if keep else 0)
                + hasher_cls.resident_bytes(n_cols, total_words))
    rb = _row_block_for(enc, n_rows, row_block, resident)
    hasher = hasher_cls(n_cols, total_words, device)

    words_dev = (torch.empty((n_rows * wpe, n_cols - words_off), dtype=torch.int32,
                             device=device) if keep else None)
    words_host = (np.empty((n_rows * wpe, n_cols), dtype=np.uint32)
                  if spill == "host" else None)
    prev = None
    for r0 in range(0, n_rows, rb):
        r1 = min(r0 + rb, n_rows)
        words = enc.encode_rows_words_only(source.block(r0, r1))
        hasher.update(words)
        if words_dev is not None:
            words_dev[r0 * wpe : r1 * wpe] = words[:, words_off:]
        elif words_host is not None:
            words_host[r0 * wpe : r1 * wpe] = words.cpu().numpy().view(np.uint32)
        if device.type == "cuda":
            # at most two blocks queued ahead of the card: the host waits
            # for the previous block before it sets up the next
            done = torch.cuda.Event()
            done.record()
            if prev is not None:
                prev.synchronize()
            prev = done
        del words  # freed before the next block's encode allocates

    flat = digest.merkle_tree(hasher.finalize(), _next_pow2(n_cols))
    return LcCommitStreaming(
        enc=enc, source=source, coeffs=source.raw_block(0, n_rows) if array_backed else None,
        n_rows=n_rows, n_per_row=n_per_row, n_cols=n_cols, hashes_dev=flat,
        row_block=rb, digest=digest, words_dev=words_dev, words_off=words_off,
        words_host=words_host, packed=source.packed)


def _canon_to_proof_words(spec, cols: torch.Tensor) -> torch.Tensor:
    """(R*W/2, k) canonical hash words -> (W/2, R, k) packed Montgomery
    words, int64 u32 values (the proof's wire form, lib.rs:401-408): one
    mont_map launch."""
    words = mont_mul_map(spec, cols, op="to_mont", in_form="hash", out_form="words")
    return words.to(torch.int64) & 0xFFFFFFFF


def _systematic_columns(comm: LcCommitStreaming, idx: torch.Tensor) -> torch.Tensor:
    """Codeword columns idx < systematic_prefix, which ARE the coefficient
    columns in Montgomery form, out of the source's regenerated blocks:
    (W/2, R, k) packed words."""
    return torch.cat([_pack_pairs(comm.source.block(r0, min(r0 + comm.row_block, comm.n_rows))
                                  .index_select(2, idx))
                      for r0 in range(0, comm.n_rows, comm.row_block)], dim=1)


def _prove_block_source(comm: LcCommitStreaming):
    """(get_block, in_form, bytes_per_elem) for prove's contractions: the
    resident matrix sliced as it is (packed or limbs), a source's packed
    words where it makes them (SeededCoeffSource), else its limb blocks."""
    w = comm.enc.spec.w16
    if comm.coeffs is not None:
        get_block = lambda r0, r1: comm.coeffs[:, r0:r1, :]  # noqa: E731
        return (get_block, "packed", 2 * w) if comm.packed else (get_block, "limbs", 4 * w)
    if hasattr(comm.source, "block_packed"):
        return comm.source.block_packed, "packed", 2 * w
    return comm.source.block, "limbs", 4 * w


def _prove_row_block(comm: LcCommitStreaming, bytes_per_elem: int, extra_bytes: int = 0) -> int:
    """Row block of prove's contractions (lcpc_tpu/core/streaming.py:796).

    The commit's row block is sized for the encode's transients (the NTT's
    scratch and words, ~20x the coefficient bytes of a row); prove's passes
    hold one coefficient block and small outputs, so much larger blocks fit:
    two blocks beside the resident arrays (and `extra_bytes`, the column
    evaluation's power table) with 1 GiB to spare, at least the commit's,
    a power of two when larger."""
    resident = comm.hashes_dev.numel() * comm.hashes_dev.element_size() + extra_bytes
    for t in (comm.coeffs, comm.words_dev):
        if t is not None:
            resident += t.numel() * t.element_size()
    free = hbm.usable_hbm_bytes(comm.enc.device) - resident - (1 << 30)
    rb = min(max(comm.row_block, free // (2 * comm.n_per_row * bytes_per_elem)), comm.n_rows)
    if rb > comm.row_block:
        rb = 1 << (rb.bit_length() - 1)
    return max(1, rb)


def _open_by_eval(comm: LcCommitStreaming, cols: list[int]) -> torch.Tensor:
    """The opened columns of a Reed-Solomon codeword evaluated directly
    (MxuColumnEval over prove-sized blocks, written into one device
    buffer): (W/2, n_rows, k) packed Montgomery words, int64 u32 values."""
    ev = MxuColumnEval(comm.enc)
    ev.set_columns(cols)
    get_block, form, bpe = _prove_block_source(comm)
    rb = _prove_row_block(comm, bpe, ev.table_bytes)
    buf = torch.empty((comm.enc.spec.w16 // 2, comm.n_rows, len(cols)), dtype=torch.int64,
                      device=comm.enc.device)
    for r0 in range(0, comm.n_rows, rb):
        r1 = min(r0 + rb, comm.n_rows)
        buf[:, r0:r1] = ev.eval_block(get_block(r0, r1), in_form=form)
    return buf


def _open_by_reencode(comm: LcCommitStreaming, cols: list[int]) -> torch.Tensor:
    """The opened columns by re-encoding every commit-sized row block and
    keeping them: (W/2, n_rows, k) packed Montgomery words, int64."""
    idx = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=comm.enc.device)
    pieces = []
    for r0 in range(0, comm.n_rows, comm.row_block):
        r1 = min(r0 + comm.row_block, comm.n_rows)
        limbs = comm.enc.encode_rows(comm.source.block(r0, r1))
        pieces.append(_pack_pairs(limbs.index_select(2, idx)))
        del limbs
    return torch.cat(pieces, dim=1)


def prove_streaming(comm: LcCommitStreaming, outer_tensor: list[int],
                    enc: LcEncoding, tr: Transcript) -> LcEvalProof:
    """Evaluation proof for a streaming commitment; the same bytes as
    prove() on the in-memory commitment of the same coefficients."""
    spec = enc.spec
    device = enc.device

    def collapse_words_fn(ts: list[list[int]]) -> np.ndarray:
        get_block, form, bpe = _prove_block_source(comm)
        words = MxuCollapse(spec, comm.n_rows, in_form=form).collapse_source(
            ts, get_block, comm.n_rows, _prove_row_block(comm, bpe))
        return words.cpu().numpy().astype(np.uint32)

    def open_columns_fn(cols: list[int]):
        # one gather_open launch reads the opened columns where they lie
        # (the kept words, the resident coefficients) and the paths; columns
        # made apart first (host words, regenerated blocks) are read as they are
        idx_np = np.asarray(cols, dtype=np.int64)
        k = len(cols)
        opened = functools.partial(_open_batched, spec, comm.hashes_dev, comm.n_cols,
                                   comm.n_rows, cols)
        if comm.words_dev is not None and comm.words_off and comm.coeffs is not None:
            # tail keep: systematic columns from the coefficients, the rest
            # from the retained tail
            return opened(mont=comm.coeffs, mont_form="words" if comm.packed else "limbs",
                          canon=comm.words_dev, off=comm.words_off)
        if comm.words_dev is not None and comm.words_off:
            # tail keep over a source: the systematic columns regenerated
            off = comm.words_off
            tail = _canon_to_proof_words(spec, comm.words_dev.index_select(
                1, torch.as_tensor(np.maximum(idx_np - off, 0), device=device)))
            sys_w = _systematic_columns(
                comm, torch.as_tensor(np.minimum(idx_np, off - 1), device=device))
            is_sys = torch.as_tensor(idx_np < off, device=device)
            col_w = torch.where(is_sys[None, None, :], sys_w, tail)
        elif comm.words_dev is not None:
            return opened(canon=comm.words_dev)
        elif comm.words_host is not None:
            host = np.ascontiguousarray(comm.words_host[:, idx_np]).view(np.int32)
            return opened(range(k), canon=torch.from_numpy(host).to(device))
        elif getattr(enc, "supports_direct_col_eval", False):
            col_w = _open_by_eval(comm, cols)
        else:
            col_w = _open_by_reencode(comm, cols)
        return opened(range(k), mont=col_w, mont_form="words", off=k)

    return prove_core(enc, tr, comm.n_rows, comm.n_cols, outer_tensor,
                      collapse_words_fn, open_columns_fn)
