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


def with_index(device) -> torch.device:
    """`device` with its index: a CUDA device named without one is the
    current one, as a tensor made there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
