"""lcpc_tpu_torch: the PyTorch/CUDA port of lcpc_tpu.

The same 2-D linear-code polynomial commitment (eprint 2021/1043) as the JAX
package `lcpc_tpu`, written for an NVIDIA H100: plain PyTorch around
hand-written CUDA kernels (`csrc/`).  Roots, proofs and wire bytes are
byte-identical to `lcpc_tpu` on the same inputs.  The package imports
nothing of `lcpc_tpu` or JAX.

Entry points run on the GPU unless the caller passes device="cpu" (the plain
PyTorch path the tests use); without a GPU and without device="cpu" they
raise.

    from lcpc_tpu_torch import LigeroEncoding, commit, Transcript, FT255
    enc = LigeroEncoding.new(FT255, len(coeffs), 1, 4)      # device="cuda"
    com = commit(coeffs, enc)                               # digest=SHA256 too
    tr = Transcript(b"my protocol")
    tr.append_message(b"polycommit", com.get_root())
    proof = com.prove(outer_tensor, tr)
"""

from .fields import FT63, FT127, FT191, FT255, ALL_FIELDS, FieldSpec
from .core.protocol import (
    LcCommit,
    LcEvalProof,
    ProverError,
    VerifierError,
    commit,
    prove,
    verify,
)
from .core import wire
from .core.encoding import LcEncoding
from .encodings.ligero import LigeroEncoding
from .encodings.brakedown import (
    SdigEncoding,
    CODE1,
    CODE2,
    CODE3,
    CODE4,
    CODE5,
    CODE6,
)
from .fs.merlin import Transcript
from .ops.digest import BLAKE3, SHA256, DIGESTS_BY_NAME, DeviceDigest
from .utils.tensors import univariate_eval, univariate_tensors

__all__ = [
    "FT63", "FT127", "FT191", "FT255", "ALL_FIELDS", "FieldSpec",
    "LcCommit", "LcEvalProof", "LcEncoding", "ProverError", "VerifierError",
    "commit", "prove", "verify", "wire",
    "LigeroEncoding", "SdigEncoding", "CODE1", "CODE2", "CODE3", "CODE4", "CODE5", "CODE6",
    "Transcript", "BLAKE3", "SHA256", "DIGESTS_BY_NAME", "DeviceDigest",
    "univariate_tensors", "univariate_eval",
]
