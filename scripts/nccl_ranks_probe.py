#!/usr/bin/env python3
"""What the card's collectives take: two NCCL ranks on one card, gloo with
CUDA tensors, and a world-1 NCCL all_to_all against its copy bound.

    python3 scripts/nccl_ranks_probe.py

Runs on one GPU (cuda:0) and prints the card's name and power limit, then
one JSON line per group: world 1 on NCCL, two NCCL ranks on the same card
(NCCL 2.28.9 refuses them: "Duplicate GPU detected"), two gloo ranks with
CUDA tensors (all_to_all_single and all_gather_into_tensor); then a world-1
NCCL all_to_all of 256 MiB timed with CUDA events beside 2 x bytes over
3.35 TB/s.  parallel/comm.py's choice of gloo, staged through pinned host
memory, for ranks that share a card rests on this probe.  Imports torch
only; every process it starts ends before it exits.
"""

import json
import socket
import subprocess
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank, world, port, backend, q):
    out = {"rank": rank, "backend": backend}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world,
                                device_id=torch.device("cuda:0") if backend == "nccl" else None)
        x = torch.arange(8, dtype=torch.int32, device="cuda") + 100 * rank
        y = torch.empty_like(x)
        try:
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
            out["all_to_all"] = y.tolist()
        except Exception as e:  # the probe reports what each backend refuses
            out["all_to_all_error"] = repr(e)[:300]
        z = torch.empty(8 * world, dtype=torch.int32, device="cuda")
        try:
            dist.all_gather_into_tensor(z, x)
            torch.cuda.synchronize()
            out["all_gather"] = z.tolist()
        except Exception as e:
            out["all_gather_error"] = repr(e)[:300]
        dist.barrier()
        dist.destroy_process_group()
    except Exception as e:
        out["init_error"] = repr(e)[:500]
    q.put(out)


def run(world, backend):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, backend, q))
             for r in range(world)]
    for p in procs:
        p.start()
    res = []
    for _ in procs:
        try:
            res.append(q.get(timeout=90))
        except Exception as e:
            res.append({"timeout": repr(e)})
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_ranks_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"nccl {torch.cuda.nccl.version()}", flush=True)
    for world, backend in ((1, "nccl"), (2, "nccl"), (2, "gloo")):
        print(json.dumps({"world": world, "backend": backend, "ranks": run(world, backend)}),
              flush=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    x = torch.arange(1 << 26, dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    for _ in range(3):
        dist.all_to_all_single(y, x)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        dist.all_to_all_single(y, x)
    e1.record()
    torch.cuda.synchronize()
    nbytes = x.numel() * 4
    print(json.dumps({"all_to_all_world1_bytes": nbytes, "ms": e0.elapsed_time(e1) / 10,
                      "bound_ms": 2 * nbytes / 3.35e12 * 1e3}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
