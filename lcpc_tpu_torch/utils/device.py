"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with
`device=None` they take `cuda` and raise when no GPU is present, rather than
falling back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lcpc_tpu_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
