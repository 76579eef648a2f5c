"""Write tests/data/torch_golden_sdig.json: the reference package's root and
proof digest for one ft255 Brakedown instance.

The port (lcpc_tpu_torch) must reproduce these bytes on the CPU
(tests/test_torch_protocol.py) and on the GPU (chip_smoke.py).  This script
runs lcpc_tpu's device path under JAX on the CPU and cross-checks it against
lcpc_tpu's serial twin (core/reference_impl.py) before writing.

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py

The inputs are a pure function of the recorded seeds
(lcpc_tpu_torch.utils.tensors.seeded_values).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(_REPO, "tests", "data", "torch_golden_sdig.json")

FIELD = "ft255"
N_PER_ROW = 512
N_ROWS = 16
MATRIX_SEED = 0
COEFF_SEED = 20231043
LABEL = b"lcpc golden sdig"


def main() -> None:
    sys.path.insert(0, _REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lcpc_tpu import FT255, SdigEncoding, Transcript, commit
    from lcpc_tpu.core import reference_impl as ref
    from lcpc_tpu.core import wire
    from lcpc_tpu.utils.tensors import univariate_eval, univariate_tensors
    from lcpc_tpu_torch.utils.tensors import seeded_values

    spec = FT255
    vals = seeded_values(spec.p, spec.w16, N_PER_ROW * N_ROWS + 1, COEFF_SEED)
    coeffs, x = vals[:-1], vals[-1]
    enc = SdigEncoding(spec, N_PER_ROW, seed=MATRIX_SEED)

    def transcript(root):
        tr = Transcript(LABEL)
        tr.append_message(b"polycommit", root)
        tr.append_message(b"ncols", enc.get_n_col_opens().to_bytes(8, "big"))
        return tr

    comm = commit(coeffs, enc)
    root = comm.get_root()
    assert comm.n_rows == N_ROWS
    assert ref.ref_commit(coeffs, enc).get_root() == root
    outer, inner = univariate_tensors(spec, x, comm.n_per_row, comm.n_rows)
    proof = comm.prove(outer, transcript(root))
    data = wire.serialize_proof(spec, proof)
    value = univariate_eval(spec, coeffs, x)
    record = {
        "field": FIELD,
        "code": "code3",
        "digest": "blake3",
        "n_per_row": N_PER_ROW,
        "n_rows": N_ROWS,
        "matrix_seed": MATRIX_SEED,
        "coeff_seed": COEFF_SEED,
        "inputs": ("numpy default_rng(coeff_seed).integers(0, 2**16, "
                   "(n_rows*n_per_row + 1, w16)); each row is the 16-bit LE limbs "
                   "of one value, reduced mod p; the last value is the point x"),
        "transcript": [LABEL.decode(), "polycommit: root",
                       "ncols: n_col_opens as 8 big-endian bytes"],
        "tensors": "univariate_tensors(spec, x, n_per_row, n_rows)",
        "root": root.hex(),
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "proof_bytes": len(data),
        "eval": hex(value),
        "source": "lcpc_tpu device path under JAX on the CPU "
                  "(scripts/make_torch_golden.py)",
    }
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
