"""Device-memory budgets of the streaming commit (port of lcpc_tpu/utils/hbm.py).

The streaming commit keeps some arrays for the whole commit (coefficients,
the retained hash words, the hasher's chunk CVs) and encodes and hashes row
blocks beside them.  Two budgets size it, both read from the card itself:

- `usable_hbm_bytes(device)`: what this process may hold on the device —
  the free memory `torch.cuda.mem_get_info` reports plus what PyTorch's
  caching allocator already reserves (arrays the process holds count as
  usable: the caller subtracts the ones it keeps), less 6% of headroom for
  the CUDA context's scratch and fragmentation.  On the CPU it is a nominal
  10 GiB, so block sizing behaves in the tests as on a card;
- `keep_bytes_budget(device)`: the retained packed codeword's cap, half of
  the usable bytes (the other half holds the coefficients, the hasher state
  and the block transients);
- `stream_bytes(device)`: the cap of one row block's transients, an eighth
  of the usable bytes (about 10 GB on an 80 GB card: a 2^28 ft255 Ligero
  commit encodes 224 rows of 2^19 columns at a time).

No environment variables: tests pick a route with commit_streaming's
`spill=` or `row_block=`, or by replacing these functions.
"""

from __future__ import annotations

import torch

CPU_USABLE_BYTES = 10 << 30
HEADROOM = 0.94


def usable_hbm_bytes(device=None) -> int:
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return CPU_USABLE_BYTES
    free, _total = torch.cuda.mem_get_info(device)
    return int((free + torch.cuda.memory_reserved(device)) * HEADROOM)


def keep_bytes_budget(device=None) -> int:
    return usable_hbm_bytes(device) // 2


def stream_bytes(device=None) -> int:
    return usable_hbm_bytes(device) // 8
