"""Elementwise Montgomery maps over field elements (wrappers of
csrc/mont_map.cu) and their plain PyTorch versions.

- `mont_mul_map(spec, a, b=None, *, op, in_form, out_form)`: op
  "mul" a b R^-1 mod p, "to_mont" a R mod p, "from_mont" a R^-1 mod p
  (FieldOps.mul, mul_const, to_mont, from_mont; lcpc_tpu/ops/limbs.py:224
  `_mul_unrolled` behind :262-283).  With out_form="hash" the from_mont
  map writes the canonical hash words of pack_row_words itself
  (lcpc_tpu/core/protocol.py:307, 315).
- `mont_addsub_map(spec, a, b=None, *, op, ...)`: op "add", "sub" or "neg"
  mod p (FieldOps.add, sub, neg; lcpc_tpu/ops/limbs.py:121, 131, 149).

Forms of a field-element tensor, all int32:
  "limbs"  (W, ...batch) 16-bit limbs, limb-major (FieldOps' layout);
  "words"  (W/2, ...batch) packed words, word i = limb 2i | limb 2i+1 << 16
           (int32 storage of u32: a word with its top bit set is negative);
  "hash"   (R*W/2, C) words of pack_row_words' layout (word r*W/2 + i of
           column c), standing for the (W/2, R, C) words of batch (R, C).
Both operands have in_form and as many batch dims; the output has out_form
over their broadcast batch, in a new tensor or, with mont_mul_map's `out=`,
written into a given one at any strides that two batch dims express
(Brakedown's verify writes its rows into the encode's packed level
buffer).  mul, add and sub take operands below p (Montgomery residues, as
lcpc_tpu's ops); to_mont and from_mont any value below R = 2^(16 W); every
map returns the unique residue below p.

On a CUDA tensor a wrapper launches its kernel (one launch) or raises; on
a CPU tensor it runs its plain version; any other device raises.
mont_mul_map picks one of its kernel's two modes by `map_route`, from the
views' strides and data pointers alone: where a and the output are words
views whose words of an element lie side by side and aligned (the
verifier's proof rows into Brakedown's level buffer), each element is read
and written whole (the element-contiguous mode, counted in `VECTOR`); any
other view takes a thread an element at any strides (counted in
`mont_mul_map.launches`).  mont_addsub_map counts in its own `launches`.
The plain
versions (`mont_mul_map_plain`, `mont_addsub_map_plain`: FieldOps' int64
limb graphs) run on any device; the tests use them on the CPU and
chip_smoke.py holds the kernels to them on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.spec import FieldSpec
from ..utils import cuda_build
from . import launch_count
from .limbs import MASK16, _chunked, _conv, _conv_const, _norm, get_ops, pack_row_words
from .mont_dot import field_consts
from .spmv import pack_words, unpack_words

FORMS = ("limbs", "words", "hash")
# the launches of mont_mul_map's element-contiguous mode (map_route "vector");
# mont_mul_map.launches counts its strided mode's
VECTOR = launch_count.LaunchCount("mont_mul_map_vec")
MUL_OPS = ("mul", "to_mont", "from_mont")
ADDSUB_OPS = ("add", "sub", "neg")
_OP_CODE = {"mul": 0, "to_mont": 1, "from_mont": 2, "add": 0, "sub": 1, "neg": 2}


# ---- forms ----------------------------------------------------------------------------


def _rows_view(spec: FieldSpec, t: torch.Tensor, form: str, name: str) -> torch.Tensor:
    """t as (rows, ...batch): limbs (W, ...), words (W/2, ...), the hash
    layout (R*W/2, C) viewed as its (W/2, R, C) words."""
    if form not in FORMS:
        raise ValueError(f"in_form must be one of {FORMS}, got {form!r}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    w32 = spec.w16 // 2
    if form == "hash":
        if t.dim() != 2 or t.shape[0] % w32:
            raise ValueError(f"{name} (hash words) must be (R*{w32}, C), got {tuple(t.shape)}")
        return t.unflatten(0, (t.shape[0] // w32, w32)).transpose(0, 1)
    rows = spec.w16 if form == "limbs" else w32
    if t.dim() < 1 or t.shape[0] != rows:
        raise ValueError(f"{name} ({form}) must be ({rows}, ...), got {tuple(t.shape)}")
    return t


def _broadcast(a, b) -> tuple:
    """The broadcast of two batch shapes of as many dims (torch.broadcast_shapes
    without its first call's import of torch._refs, ~1.4 s)."""
    if any(x != y and 1 not in (x, y) for x, y in zip(a, b)):
        raise ValueError(f"batch shapes {tuple(a)} and {tuple(b)} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def _check(spec, op, ops_, a, b, in_form, out_form):
    """The operands as (rows, ...batch) views and the broadcast batch."""
    if op not in ops_:
        raise ValueError(f"op must be one of {ops_}, got {op!r}")
    if out_form not in FORMS:
        raise ValueError(f"out_form must be one of {FORMS}, got {out_form!r}")
    av = _rows_view(spec, a, in_form, "a")
    binary = op in ("mul", "add", "sub")
    if binary != (b is not None):
        raise ValueError(f"{op} takes {'two operands' if binary else 'one operand'}")
    bv = _rows_view(spec, b, in_form, "b") if binary else None
    if bv is not None and bv.device != av.device:
        raise ValueError(f"operands on {av.device} and {bv.device}")
    if bv is not None and bv.dim() != av.dim():
        raise ValueError(f"operands of {av.dim() - 1} and {bv.dim() - 1} batch dims")
    batch = av.shape[1:] if bv is None else _broadcast(av.shape[1:], bv.shape[1:])
    if out_form == "hash" and len(batch) != 2:
        raise ValueError(f"hash words out need a (R, C) batch, got {tuple(batch)}")
    return av, bv, tuple(batch)


def _to_limbs(spec: FieldSpec, v: torch.Tensor, form: str) -> torch.Tensor:
    return v if form == "limbs" else unpack_words(v, 0)


def _from_limbs(limbs: torch.Tensor, form: str) -> torch.Tensor:
    if form == "limbs":
        return limbs
    return pack_row_words(limbs) if form == "hash" else pack_words(limbs, 0)


# ---- the plain versions ---------------------------------------------------------------


def mont_mul_map_plain(spec: FieldSpec, a: torch.Tensor, b: "torch.Tensor | None" = None, *,
                       op: str = "mul", in_form: str = "limbs",
                       out_form: str = "limbs") -> torch.Tensor:
    """The plain version of mont_mul_map, on any device: FieldOps' int64
    limb graphs (exact product columns, carry normalization, one Montgomery
    reduction, a conditional subtract)."""
    av, bv, _ = _check(spec, op, MUL_OPS, a, b, in_form, out_form)
    ops, w = get_ops(spec), spec.w16
    x = _to_limbs(spec, av, in_form)
    if op == "mul":
        x, y = torch.broadcast_tensors(x, _to_limbs(spec, bv, in_form))
        f = lambda u, v: ops._cond_sub_p(ops._redc(_norm(_conv(u, v), 2 * w)))  # noqa: E731
        res = _chunked(f, ops._flat(x), ops._flat(y))
    elif op == "to_mont":
        def f(v):  # x R^2 R^-1: (x R^2 + m p)/R < 2p
            t = _norm(_conv_const(v, ops.r2_limbs, 2 * w - 1), 2 * w)
            return ops._cond_sub_p(ops._redc(t))
        res = _chunked(f, ops._flat(x))
    else:
        def f(v):  # x R^-1: (x + m p)/R <= p
            return ops._cond_sub_p(ops._redc(torch.cat([v, torch.zeros_like(v)], dim=0)))
        res = _chunked(f, ops._flat(x))
    return _from_limbs(ops._out(res, x.shape[1:]), out_form)


def mont_addsub_map_plain(spec: FieldSpec, a: torch.Tensor, b: "torch.Tensor | None" = None, *,
                          op: str = "add", in_form: str = "limbs",
                          out_form: str = "limbs") -> torch.Tensor:
    """The plain version of mont_addsub_map, on any device: FieldOps'
    int64 limb graphs (add: carry-normalized sum, a conditional subtract;
    sub: a borrow chain, p added back where it borrowed; neg: 0 - a)."""
    av, bv, _ = _check(spec, op, ADDSUB_OPS, a, b, in_form, out_form)
    ops, w = get_ops(spec), spec.w16
    x = _to_limbs(spec, av, in_form)
    if op == "neg":
        x, y = torch.zeros_like(x), x
    else:
        x, y = torch.broadcast_tensors(x, _to_limbs(spec, bv, in_form))
    if op == "add":
        f = lambda u, v: ops._cond_sub_p(_norm(u + v, w + 1))  # noqa: E731
    else:
        def f(u, v):
            d = torch.empty_like(u)
            borrow = torch.zeros_like(u[0])
            for i in range(w):
                di = u[i] - v[i] - borrow
                d[i] = di & MASK16
                borrow = (di < 0).to(u.dtype)
            p = torch.tensor(ops.p_limbs, dtype=d.dtype, device=d.device)[:, None]
            return torch.where(borrow.bool(), _norm(d + p, w), d)
    res = _chunked(f, ops._flat(x), ops._flat(y))
    return _from_limbs(ops._out(res, x.shape[1:]), out_form)


# ---- the kernels ----------------------------------------------------------------------


def _bind(lib) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    args = [i] + [p, ll, ll, ll, i] * 3 + [p, i, ll, ll, i, p]
    lib.lcpc_mont_mul_map.argtypes = args + [i]  # and `whole`: the element-contiguous mode
    lib.lcpc_mont_addsub_map.argtypes = args
    for fn in (lib.lcpc_mont_mul_map, lib.lcpc_mont_addsub_map):
        fn.restype = ctypes.c_int


def _merge_2d(ts, batch):
    """(R, C) and each tensor's (r, c) element strides with the batch
    merged into at most two dims that every tensor's strides allow, or
    None.  A dim of size 1 drops out; dim d folds into d + 1 where each
    stride of d is the stride of d + 1 times its size."""
    dims = [(n, [t.stride(k + 1) for t in ts]) for k, n in enumerate(batch) if n != 1]
    merged = []
    for n, st in reversed(dims):
        if merged and all(s == s1 * merged[-1][0] for s, s1 in zip(st, merged[-1][1])):
            merged[-1] = (merged[-1][0] * n, merged[-1][1])
        else:
            merged.append((n, st))
    if len(merged) > 2:
        return None
    merged += [(1, [0] * len(ts))] * (2 - len(merged))
    (C, sc), (R, sr) = merged
    return R, C, sr, sc


def _operands(spec, av, bv, out_form, batch, into):
    """The output (a new tensor, or `into`), the (rows, ...batch) views the
    kernel reads and writes (a, b if any, out) and their two merged dims (R,
    C, sr, sc), or None for an empty output."""
    w, w32 = spec.w16, spec.w16 // 2
    if into is not None:
        out = ov = into
    elif out_form == "hash":
        out = torch.empty((batch[0] * w32, batch[1]), dtype=torch.int32, device=av.device)
        ov = out.unflatten(0, (batch[0], w32)).transpose(0, 1)
    else:
        out = ov = torch.empty((w if out_form == "limbs" else w32, *batch), dtype=torch.int32,
                               device=av.device)
    if ov.numel() == 0:
        return out, None, None
    ts = [av.expand(av.shape[0], *batch), ov]
    if bv is not None:
        ts.insert(1, bv.expand(bv.shape[0], *batch))
    dims = _merge_2d(ts, batch)
    if dims is None:  # strides no two dims express: the operands copied contiguous
        ts = [t.contiguous() for t in ts[:-1]] + [ov]
        dims = _merge_2d(ts, batch)
    if dims is None:
        raise ValueError(f"out's strides {ov.stride()} take more than two dims of the batch "
                         f"{tuple(batch)}")
    return out, ts, dims


def _whole(w32, t, form, sr, sc) -> bool:
    """t's words of an element side by side (words, row stride 1), its
    address and element strides aligned to 16 bytes (W/2 % 4 == 0) or 8:
    what the element-contiguous mode loads or stores whole."""
    align = 4 if w32 % 4 == 0 else 2  # words
    return (form == "words" and t.stride(0) == 1 and t.data_ptr() % (4 * align) == 0
            and sr % align == 0 and sc % align == 0)


def _route(w32, ts, forms, dims):
    """(route, dims): "vector" where a and out are both element-contiguous
    (_whole), its dims in the order the mode walks them (R and C swapped
    where out's element-contiguous rows are its R dim, so the walk follows
    out's addresses); else "strided" and the dims as they are."""
    R, C, sr, sc = dims
    if (R * C >= 1 << 31 or not _whole(w32, ts[0], forms[0], sr[0], sc[0])
            or not _whole(w32, ts[-1], forms[-1], sr[-1], sc[-1])):
        return "strided", dims
    if sc[-1] != w32 and sr[-1] == w32 and R > 1:
        R, C, sr, sc = C, R, sc, sr
    return "vector", (R, C, sr, sc)


def map_route(spec: FieldSpec, a: torch.Tensor, b: "torch.Tensor | None" = None, *,
              op: str = "mul", in_form: str = "limbs", out_form: str = "limbs",
              out: "torch.Tensor | None" = None) -> str:
    """The route that mont_mul_map takes for these operands on a card,
    from their strides and data pointers alone (any device: the CPU
    tests call it): "vector" where a and the output are element-contiguous,
    aligned words views (each element read and written whole), else
    "strided" (a thread an element at any strides)."""
    av, bv, batch = _check(spec, op, MUL_OPS, a, b, in_form, out_form)
    if out is not None:
        _check_into(spec, out, av, out_form, batch)
    _, ts, dims = _operands(spec, av, bv, out_form, batch, out)
    if ts is None:
        return "strided"
    return _route(spec.w16 // 2, ts, [in_form] * (len(ts) - 1) + [out_form], dims)[0]


def _entry_args(spec, op, ts, forms, dims) -> tuple:
    """The arguments of csrc/mont_map.cu's entries (lcpc_mont_mul_map before
    its `whole` flag, lcpc_mont_addsub_map) for the views ts (a, b if any,
    out) in forms over dims (R, C, sr, sc)."""
    R, C, sr, sc = dims
    device = ts[0].device

    def view(k):
        t = ts[k]
        return (t.data_ptr(), t.stride(0), sr[k], sc[k], int(forms[k] == "limbs"))

    b_args = view(1) if len(ts) == 3 else (None, 0, 0, 0, 0)
    return (_OP_CODE[op], *view(0), *b_args, *view(len(ts) - 1),
            field_consts(spec, device).data_ptr(), spec.w16 // 2, R, C, device.index or 0,
            torch.cuda.current_stream(device).cuda_stream)


def _launch(kernel, spec, op, av, bv, in_form, out_form, batch, into=None) -> torch.Tensor:
    """One launch of `kernel` over the broadcast batch (mont_mul_map: by
    map_route's route); returns the output in out_form, written into `into`
    when given (_check_into)."""
    out, ts, dims = _operands(spec, av, bv, out_form, batch, into)
    if ts is None:
        return out
    forms = [in_form] * (len(ts) - 1) + [out_form]
    lib = cuda_build.load("mont_map", _bind)
    if kernel is mont_mul_map:
        route, dims = _route(spec.w16 // 2, ts, forms, dims)
        counter = VECTOR if route == "vector" else mont_mul_map
        err = lib.lcpc_mont_mul_map(*_entry_args(spec, op, ts, forms, dims),
                                    int(route == "vector"))
    else:
        route, counter = "strided", mont_addsub_map
        err = lib.lcpc_mont_addsub_map(*_entry_args(spec, op, ts, forms, dims))
    if err != 0:
        raise RuntimeError(f"{kernel.__name__} ({op}, {route}) launch failed: cudaError_t {err}")
    counter.launches += 1
    return out


def _check_into(spec, into, av, out_form, batch) -> None:
    """`into` is an int32 tensor of out_form ("limbs" or "words") over the
    batch, (W or W/2, ...batch), on the operands' device: any strides, the
    batch merged to at most two dims (the kernel's)."""
    if out_form == "hash":
        raise ValueError("out: limbs or words only (a hash-words output is allocated)")
    rows = spec.w16 if out_form == "limbs" else spec.w16 // 2
    if into.dtype != torch.int32 or into.device != av.device or tuple(into.shape) != (
            rows, *batch):
        raise ValueError(f"out must be int32 ({rows}, {', '.join(map(str, batch))}) on "
                         f"{av.device}, got {into.dtype} {tuple(into.shape)} on {into.device}")


def _dispatch(kernel, plain, ops_, spec, a, b, op, in_form, out_form, into=None):
    av, bv, batch = _check(spec, op, ops_, a, b, in_form, out_form)
    if into is not None:
        _check_into(spec, into, av, out_form, batch)
    if av.device.type == "cpu":
        res = plain(spec, a, b, op=op, in_form=in_form, out_form=out_form)
        return res if into is None else into.copy_(res)
    if av.device.type != "cuda":
        raise ValueError(f"{kernel.__name__}: unsupported device {av.device}")
    return _launch(kernel, spec, op, av, bv, in_form, out_form, batch, into)


def mont_mul_map(spec: FieldSpec, a: torch.Tensor, b: "torch.Tensor | None" = None, *,
                 op: str = "mul", in_form: str = "limbs", out_form: str = "limbs",
                 out: "torch.Tensor | None" = None) -> torch.Tensor:
    """a b R^-1 ("mul"), a R ("to_mont") or a R^-1 ("from_mont") mod p of
    each element, in out_form; see the module docstring.  With `out` (a
    limbs or words tensor over the batch, any strides two dims express) the
    result is written there and returned: Brakedown's verify writes its
    proof rows' Montgomery words straight into the encode's packed
    (positions, R, W/2) level buffer, `out=buf[:npr].permute(2, 1, 0)`, by
    the element-contiguous mode (map_route)."""
    return _dispatch(mont_mul_map, mont_mul_map_plain, MUL_OPS, spec, a, b, op, in_form,
                     out_form, out)


def mont_addsub_map(spec: FieldSpec, a: torch.Tensor, b: "torch.Tensor | None" = None, *,
                    op: str = "add", in_form: str = "limbs",
                    out_form: str = "limbs") -> torch.Tensor:
    """a + b ("add"), a - b ("sub") or -a ("neg") mod p of each element, in
    out_form; see the module docstring."""
    return _dispatch(mont_addsub_map, mont_addsub_map_plain, ADDSUB_OPS, spec, a, b, op,
                     in_form, out_form)


launch_count.counted(mont_mul_map)
launch_count.counted(mont_addsub_map)
