"""Write the golden fixtures: the reference package's roots and proof
digests for one ft255 instance of each encoding.

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py           # sdig
    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py ligero

- sdig: tests/data/torch_golden_sdig.json, Brakedown (CODE3), BLAKE3;
- ligero: tests/data/torch_golden_ligero.json, Ligero rho = 1/4, with the
  root and proof digest under BLAKE3 and under SHA-256.

The port (lcpc_tpu_torch) must reproduce these bytes on the CPU
(tests/test_torch_protocol.py, tests/test_torch_ligero.py) and on the GPU
(chip_smoke.py).  This script runs lcpc_tpu's device path under JAX on the
CPU and cross-checks the BLAKE3 roots against lcpc_tpu's serial twin
(core/reference_impl.py) before writing.

The inputs are a pure function of the recorded seeds
(lcpc_tpu_torch.utils.tensors.seeded_values).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = {"sdig": os.path.join(_REPO, "tests", "data", "torch_golden_sdig.json"),
       "ligero": os.path.join(_REPO, "tests", "data", "torch_golden_ligero.json")}

FIELD = "ft255"
COEFF_SEED = 20231043
INPUTS = ("numpy default_rng(coeff_seed).integers(0, 2**16, (n_coeffs + 1, w16)); "
          "each row is the 16-bit LE limbs of one value, reduced mod p; the last "
          "value is the point x")
TRANSCRIPT = ["polycommit: root", "ncols: n_col_opens as 8 big-endian bytes"]
SOURCE = "lcpc_tpu device path under JAX on the CPU (scripts/make_torch_golden.py)"

# sdig
N_PER_ROW = 512
N_ROWS = 16
MATRIX_SEED = 0
LABEL = b"lcpc golden sdig"

# ligero: LigeroEncoding.new(FT255, LIGERO_LENGTH, 1, 4) -> 4 rows x 256, 1024 columns
LIGERO_LENGTH = 1000
LIGERO_RHO = (1, 4)
LIGERO_LABEL = b"lcpc golden ligero"


def _run(J, enc, coeffs, x, label, digest):
    """commit -> prove through lcpc_tpu's device path: (root, proof bytes)."""
    from lcpc_tpu.core import wire
    from lcpc_tpu.utils.tensors import univariate_tensors

    comm = J.commit(coeffs, enc, digest=digest)
    root = comm.get_root()
    tr = J.Transcript(label)
    tr.append_message(b"polycommit", root)
    tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
    outer, _ = univariate_tensors(enc.spec, x, comm.n_per_row, comm.n_rows)
    data = wire.serialize_proof(enc.spec, comm.prove(outer, tr))
    return comm, root, data


def sdig(J, ref, spec, vals) -> dict:
    from lcpc_tpu.ops.digest import BLAKE3

    coeffs, x = vals[:-1], vals[-1]
    enc = J.SdigEncoding(spec, N_PER_ROW, seed=MATRIX_SEED)
    comm, root, data = _run(J, enc, coeffs, x, LABEL, BLAKE3)
    assert comm.n_rows == N_ROWS
    assert ref.ref_commit(coeffs, enc).get_root() == root
    return {
        "field": FIELD,
        "code": "code3",
        "digest": "blake3",
        "n_per_row": N_PER_ROW,
        "n_rows": N_ROWS,
        "matrix_seed": MATRIX_SEED,
        "coeff_seed": COEFF_SEED,
        "inputs": INPUTS.replace("n_coeffs", "n_rows*n_per_row"),
        "transcript": [LABEL.decode(), *TRANSCRIPT],
        "tensors": "univariate_tensors(spec, x, n_per_row, n_rows)",
        "root": root.hex(),
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "proof_bytes": len(data),
        "eval": None,
        "source": SOURCE,
    }


def ligero(J, ref, spec, vals) -> dict:
    from lcpc_tpu.ops.digest import DIGESTS_BY_NAME

    coeffs, x = vals[:-1], vals[-1]
    enc = J.LigeroEncoding.new(spec, LIGERO_LENGTH, *LIGERO_RHO)
    digests = {}
    for name in ("blake3", "sha256"):
        comm, root, data = _run(J, enc, coeffs, x, LIGERO_LABEL, DIGESTS_BY_NAME[name])
        if name == "blake3":
            assert ref.ref_commit(coeffs, enc).get_root() == root
        digests[name] = {"root": root.hex(),
                         "proof_sha256": hashlib.sha256(data).hexdigest(),
                         "proof_bytes": len(data)}
    return {
        "field": FIELD,
        "encoding": "ligero",
        "constructor": "LigeroEncoding.new(spec, length, rho_num, rho_den)",
        "length": LIGERO_LENGTH,
        "rho": list(LIGERO_RHO),
        "n_rows": comm.n_rows,
        "n_per_row": comm.n_per_row,
        "n_cols": comm.n_cols,
        "coeff_seed": COEFF_SEED,
        "inputs": INPUTS.replace("n_coeffs", "length"),
        "transcript": [LIGERO_LABEL.decode(), *TRANSCRIPT],
        "tensors": "univariate_tensors(spec, x, n_per_row, n_rows)",
        "digests": digests,
        "eval": None,
        "source": SOURCE,
    }


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "sdig"
    if mode not in OUT:
        raise SystemExit(f"usage: make_torch_golden.py [{'|'.join(OUT)}]")
    sys.path.insert(0, _REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import lcpc_tpu as J
    from lcpc_tpu.core import reference_impl as ref
    from lcpc_tpu.utils.tensors import univariate_eval
    from lcpc_tpu_torch.utils.tensors import seeded_values

    spec = J.FT255
    n = N_PER_ROW * N_ROWS if mode == "sdig" else LIGERO_LENGTH
    vals = seeded_values(spec.p, spec.w16, n + 1, COEFF_SEED)
    record = (sdig if mode == "sdig" else ligero)(J, ref, spec, vals)
    record["eval"] = hex(univariate_eval(spec, vals[:-1], vals[-1]))
    with open(OUT[mode], "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
