"""The collectives of the sharded paths, over one torch.distributed group.

lcpc_tpu's sharded graphs call `jax.lax.all_to_all` and `all_gather` inside
`shard_map`; here every rank is one process and calls the same two
collectives on the same tensors' shapes:

- `Comm.exchange(chunks)`: (world, ...) chunks, chunk j sent to rank j;
  returns (world, ...) with chunk i received from rank i
  (`all_to_all_single`).  Callers lay out their chunks themselves, so each
  reshard is one copy in and at most one out.
- `Comm.gather(x)`: (world, *x.shape), rank i's x at index i
  (`all_gather_into_tensor`).

An NCCL group moves CUDA tensors on the card.  A gloo group works in host
memory: here a CUDA tensor is copied through pinned host memory and the
result back to its device by this module, not inside gloo (whose handling
of CUDA tensors varies between torch versions), so the host copies are
explicit and timed with the collective.  Ranks that share one card run this
way: NCCL refuses two ranks on one device ("Duplicate GPU detected", NCCL
2.28.9).  Which of the two a call takes follows from the group's backend
and the tensor's device, never from a failure.  `Comm.calls` counts each
collective's calls.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(mesh):
    """The process group of a 1-D DeviceMesh, a ProcessGroup, or None (the
    default group of every rank)."""
    if mesh is None:
        return dist.group.WORLD
    if hasattr(mesh, "get_group"):
        if mesh.ndim != 1:
            raise ValueError(f"the sharded paths take a 1-D mesh, got {mesh.ndim} dims")
        return mesh.get_group()
    return mesh


class Comm:
    """One rank's view of a group: its size, this rank's index, the backend
    and the collectives (see the module docstring)."""

    calls = {"exchange": 0, "gather": 0}

    def __init__(self, mesh=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "lcpc_tpu_torch.parallel.multihost.initialize() first")
        self.mesh = mesh
        self.group = _group(mesh)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group))

    def staged(self, t: torch.Tensor) -> bool:
        """Whether a collective on `t` goes through pinned host memory: a
        CUDA tensor in a gloo group."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def exchange(self, chunks: torch.Tensor) -> torch.Tensor:
        """(world, ...) chunks -> (world, ...): out[i] is rank i's chunks[rank]."""
        if chunks.shape[0] != self.world:
            raise ValueError(f"exchange: {chunks.shape[0]} chunks for {self.world} ranks")
        chunks = chunks.contiguous()
        Comm.calls["exchange"] += 1
        if self.staged(chunks):
            inp = self._host(chunks)
            out = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
            dist.all_to_all_single(out, inp, group=self.group)
            return out.to(chunks.device)
        out = torch.empty_like(chunks)
        dist.all_to_all_single(out, chunks, group=self.group)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """x -> (world, *x.shape), rank i's x at index i."""
        x = x.contiguous()
        Comm.calls["gather"] += 1
        # the output concatenated along dim 0 (the form every backend takes),
        # then viewed (world, *x.shape)
        shape = (self.world * x.shape[0], *x.shape[1:])
        if self.staged(x):
            inp = self._host(x)
            out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
            dist.all_gather_into_tensor(out, inp, group=self.group)
            return out.to(x.device).view(self.world, *x.shape)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.view(self.world, *x.shape)
