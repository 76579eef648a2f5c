"""The rank processes of tests/test_torch_parallel.py, and the cases both sides share.

    python tests/torch_parallel_ranks.py WORLD RANK PORT OUT

starts one gloo rank (device="cpu") of a WORLD-rank group at
tcp://localhost:PORT, runs every case through the port's sharded paths and
pickles what it got to OUT: roots, Merkle arrays and proof bytes of each
regime and edge case, the DistNtt's and the sharded collapse's limbs, and
the meshes.  It imports torch and lcpc_tpu_torch only: the test process
holds the results against lcpc_tpu, the port's single-device path and the
serial twins.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import sys
import traceback

import numpy as np
import torch

LABEL = b"test transcript"


@dataclasses.dataclass(frozen=True)
class Case:
    """One commitment: field, encoding (`make_enc`'s description), length,
    coefficient seed, path ("commit" or "streaming"), strategy, row block
    and digest."""

    field: str
    enc: tuple
    length: int
    seed: int
    path: str = "commit"
    strategy: str = "auto"
    row_block: "int | None" = None
    digest: str = "blake3"


# the seven regimes of MULTICHIP_r05.json, at the shapes lcpc_tpu's own
# mesh tests use (tests/test_mesh_protocol.py, tests/test_mesh_streaming.py)
REGIMES = {
    "ligero": Case("ft63", ("ligero_new", 1000), 1000, 101),
    "brakedown": Case("ft63", ("sdig_new", 3000, 0), 3000, 202),  # 3,906 columns
    "ligero-wide": Case("ft63", ("ligero", 128, 256), 512, 505, strategy="wide"),
    "ligero-mesh-streaming": Case("ft63", ("ligero", 64, 128), 64 * 700 - 13, 71,
                                  path="streaming", row_block=256),
    "brakedown-mesh-streaming": Case("ft63", ("sdig", 24, 0), 6000, 72, path="streaming",
                                     row_block=32),  # 250 rows, 37 columns
    "ligero-sha256": Case("ft63", ("ligero", 64, 128), 1024, 404, digest="sha256"),
    "sha256-mesh-streaming": Case("ft63", ("ligero", 64, 128), 64 * 300 - 5, 73,
                                  path="streaming", row_block=128, digest="sha256"),
}


def edges(world: int) -> dict:
    """The edge cases at `world` ranks, checked against the port's
    single-device path and the serial twins."""
    return {
        # fewer rows than ranks: "auto" takes the wide strategy
        "auto-wide": Case("ft63", ("ligero", 64, 256), 64 * (world - 1) - 5, 31),
        # 3 rows: a pad row at both worlds; at 4 ranks "auto" takes wide
        "ft255-ligero": Case("ft255", ("ligero_new", 300, 1, 4), 300, 32),
        # 1 row over every rank, 761 columns: ragged over 2 and 4
        "ft255-brakedown": Case("ft255", ("sdig_new", 500, 0), 500, 33),
        # 40 rows of 8 words in 16-row blocks: 3 blocks, 2-chunk columns
        "ft255-streaming": Case("ft255", ("ligero", 16, 64, 1, 4), 16 * 40 - 3, 34,
                                path="streaming", row_block=16),
    }


# DistNtt in every field: (field, n, rows, seed); the sharded collapse:
# (field, rows, cols, T, operands), values near p or every limb 0xFFFF
DIST_NTT = {"ft63": ("ft63", 256, 3, 11), "ft127": ("ft127", 64, 1, 13),
            "ft191": ("ft191", 256, 2, 14), "ft255": ("ft255", 64, 2, 12)}
COLLAPSE = {"near-p": ("ft63", 8, 64, 1, "near-p"),
            "all-ffff": ("ft255", 6, 24, 2, "all-ffff"),
            "near-p-3-rows": ("ft127", 3, 16, 2, "near-p"),  # fewer rows than 4 ranks
            "all-ffff-t3": ("ft191", 5, 20, 3, "all-ffff")}


def field(pkg, name: str):
    """The field of `pkg` named `name`."""
    return {f.name: f for f in pkg.ALL_FIELDS}[name]


def make_enc(pkg, spec, desc, **kw):
    """An encoding of `pkg` (lcpc_tpu or lcpc_tpu_torch) from a description:
    ("ligero", n_per_row, n_cols[, rho_num, rho_den]), ("ligero_new",
    length[, rho_num, rho_den]), ("sdig", n_per_row, seed) or ("sdig_new",
    length, seed)."""
    kind, *args = desc
    if kind == "ligero":
        return pkg.LigeroEncoding.new_from_dims(spec, *args, **kw)
    if kind == "ligero_new":
        return pkg.LigeroEncoding.new(spec, *args, **kw)
    if kind == "sdig_new":
        return pkg.SdigEncoding.new(spec, args[0], seed=args[1], **kw)
    return pkg.SdigEncoding(spec, args[0], seed=args[1], **kw)


def inputs(pkg, spec, case: Case, enc):
    """(coeffs, x, outer, inner) of a case: seeded values, the evaluation
    point last, and the univariate tensors."""
    from lcpc_tpu_torch.utils.tensors import seeded_values

    vals = seeded_values(spec.p, spec.w16, case.length + 1, case.seed)
    coeffs, x = vals[:-1], vals[-1]
    n_rows, n_per_row, _ = enc.get_dims(case.length)
    outer, inner = pkg.univariate_tensors(spec, x, n_per_row, n_rows)
    return coeffs, x, outer, inner


def transcript(pkg, enc, root):
    """lcpc_tpu's test preamble (tests/test_mesh_protocol.py: _preamble)."""
    tr = pkg.Transcript(LABEL)
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    return tr


def hashes_digest(hashes: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(hashes).tobytes()).hexdigest()


def seeded_limbs(spec, shape, seed) -> np.ndarray:
    """(W, *shape) Montgomery limbs of seeded field values."""
    from lcpc_tpu_torch.ops.limbs import get_ops
    from lcpc_tpu_torch.utils.tensors import seeded_values

    n = int(np.prod(shape))
    limbs = get_ops(spec).encode_host(seeded_values(spec.p, spec.w16, n, seed))
    return limbs.reshape(spec.w16, *shape)


def collapse_operands(spec, rows, cols, t, kind):
    """(mat (W, rows, cols) limbs, T tensors of plain ints) of a collapse
    case: values near p (canonical p-1, p-2, ...) or every limb 0xFFFF (R - 1,
    above p: no reduced residue); tensors near p."""
    from lcpc_tpu_torch.ops.limbs import get_ops

    ts = [[spec.p - 1 - 3 * i - j for i in range(rows)] for j in range(t)]
    if kind == "all-ffff":
        return np.full((spec.w16, rows, cols), 0xFFFF, dtype=np.uint32), ts
    vals = [spec.p - 1 - i for i in range(rows * cols)]
    return get_ops(spec).encode_host(vals).reshape(spec.w16, rows, cols), ts


def _run_case(P, mesh, case: Case) -> dict:
    from lcpc_tpu_torch.parallel import mesh_protocol, mesh_streaming

    spec = field(P, case.field)
    enc = make_enc(P, spec, case.enc, device="cpu")
    coeffs, _, outer, _ = inputs(P, spec, case, enc)
    digest = P.DIGESTS_BY_NAME[case.digest]
    if case.path == "streaming":
        comm = mesh_streaming.sharded_commit_streaming(coeffs, enc, mesh,
                                                       row_block=case.row_block,
                                                       digest=digest)
    else:
        comm = mesh_protocol.sharded_commit(coeffs, enc, mesh, digest=digest,
                                            strategy=case.strategy)
    proof = comm.prove(outer, transcript(P, enc, comm.get_root()))
    return {"root": comm.get_root(), "hashes": hashes_digest(comm.hashes),
            "proof": P.wire.serialize_proof(spec, proof), "strategy": comm.strategy,
            "n_rows": comm.n_rows, "row_block": getattr(comm, "row_block", None)}


def _run_dist_ntt(P, mesh, fname, n, rows, seed) -> dict:
    from lcpc_tpu_torch.parallel.dist_ntt import DistNtt

    spec = field(P, fname)
    dn = DistNtt(spec, n, mesh, device="cpu")
    x = dn.shard_input(torch.from_numpy(seeded_limbs(spec, (rows, n), seed).astype(np.int32)))
    return {"limbs": dn(x).numpy(), "words": dn(x, output="words").numpy()}


def _run_collapse(P, mesh, c, fname, rows, cols, t, kind) -> np.ndarray:
    from lcpc_tpu_torch.parallel import mesh_protocol, multihost

    spec = field(P, fname)
    mat, ts = collapse_operands(spec, rows, cols, t, kind)
    rp = -(-rows // c.world) * c.world
    full = torch.zeros((spec.w16, rp, cols), dtype=torch.int32)
    full[:, :rows] = torch.from_numpy(mat.astype(np.int32))
    nc = 1 << cols.bit_length()  # any valid codeword: the collapse reads the coefficients only
    enc = P.LigeroEncoding.new_from_dims(spec, cols, nc, device="cpu")
    comm = mesh_protocol.ShardedCommit(
        enc=enc, mesh=mesh, coeffs=multihost.local_shard(full, 1, c.rank, c.world).contiguous(),
        words=None, n_rows=rows, n_per_row=cols, n_cols=nc, hashes_dev=None)
    return mesh_protocol.sharded_collapse(comm, ts)


def main(world: int, rank: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.parallel import multihost
    from lcpc_tpu_torch.parallel.comm import Comm

    multihost.initialize(f"tcp://localhost:{port}", world, rank, device="cpu", timeout_s=300)
    mesh = multihost.make_multihost_mesh()
    hybrid = multihost.make_hybrid_mesh()
    c = Comm(mesh)
    res = {
        "rank": rank, "backend": c.backend, "mesh": tuple(mesh.shape),
        "hybrid": tuple(hybrid.shape),
        "hybrid_groups": {ax: dist.get_process_group_ranks(hybrid[ax].get_group())
                          for ax in hybrid.mesh_dim_names},
        "cases": {name: _run_case(P, mesh, case)
                  for name, case in {**REGIMES, **edges(world)}.items()},
        "dist_ntt": {k: _run_dist_ntt(P, mesh, *v) for k, v in DIST_NTT.items()},
        "collapse": {k: _run_collapse(P, mesh, c, *v) for k, v in COLLAPSE.items()},
        "comm_calls": dict(Comm.calls),
    }
    with open(out + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".tmp", out)
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
