"""Process-level entry of the sharded paths: the process group and the meshes
(port of lcpc_tpu/parallel/multihost.py).

lcpc_tpu drives every device of a host from one controller process (a
`jax.sharding.Mesh`), and across hosts runs one process per host.  Here it
is one process per device, as PyTorch runs it: every rank calls the same
entry point with the same host-replicated inputs (coefficients, tensors),
takes its own slice of them (`local_shard`, the port of `put_sharded`),
and the ranks meet in the collectives of parallel/comm.py.

- `initialize()` starts this process's rank: from explicit arguments,
  else from torchrun's `env://` variables (MASTER_ADDR, MASTER_PORT, RANK,
  WORLD_SIZE, LOCAL_RANK), else as a group of one process.  NCCL on
  `cuda:{LOCAL_RANK}` by default (raising without a GPU); gloo when the
  caller passes device="cpu".  A caller may also name backend="gloo" for
  ranks on CUDA devices (several ranks on one card, which NCCL refuses):
  their collectives then stage through pinned host memory, and every
  kernel still runs on the card.
- `make_multihost_mesh()`: the 1-D protocol mesh over every rank, in rank
  order, which torchrun numbers host-major; so each host's row shard is a
  contiguous row range and only the reshard (one all_to_all) and the leaf
  all_gather cross hosts.
- `make_hybrid_mesh()`: the 2-D (hosts, local devices) mesh.

Run the sharded paths on N GPUs of a host with
`torchrun --nproc-per-node=N script.py`, the script calling initialize()
and then mesh_protocol.sharded_commit(...) on every rank.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(init_method: "str | None" = None, world_size: "int | None" = None,
               rank: "int | None" = None, local_rank: "int | None" = None,
               device=None, backend: "str | None" = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join this process's rank to the default process group; returns the
    device its tensors live on (see the module docstring).

    `init_method`, `world_size` and `rank` are init_process_group's; when
    none is given, torchrun's env:// variables are read, and without those
    the group is this one process at a free localhost port.  `local_rank`
    (else LOCAL_RANK, else 0) picks the card; `device` overrides it
    ("cpu" for the plain path).  `backend` defaults to nccl for a CUDA
    device and gloo for the CPU.  A second call returns the device."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        device = torch.device(resolve_device().type, local_rank)  # raises without a GPU
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    if init_method is None and world_size is None and rank is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
        else:  # one process: a group of one
            init_method, world_size, rank = f"tcp://localhost:{free_port()}", 1, 0
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    return device


def _device_type() -> str:
    """The meshes' device type: the default group's backend decides (a gloo
    group is a "cpu" mesh even where its ranks' tensors lie on a card)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_multihost_mesh(axis: str = "r"):
    """The 1-D mesh over every rank of the default group, in rank order."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (dist.get_world_size(),), mesh_dim_names=(axis,))


def make_hybrid_mesh(dcn_axis: str = "h", ici_axis: str = "r"):
    """The 2-D (hosts, local devices) mesh: the host axis leads, so a caller
    can keep the bandwidth-heavy collectives on the local axis.  Ranks per
    host from torchrun's LOCAL_WORLD_SIZE (one host without it)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host}")
    return init_device_mesh(_device_type(), (world // per_host, per_host),
                            mesh_dim_names=(dcn_axis, ici_axis))


def local_shard(x: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    """This rank's contiguous 1/world slice of the host-replicated `x` along
    `dim` (which `world` must divide): the port of `put_sharded`, each rank
    placing only its own shard."""
    size = x.shape[dim]
    if size % world:
        raise ValueError(f"dim {dim} of size {size} does not split over {world} ranks")
    step = size // world
    return x.narrow(dim, rank * step, step)
