"""The commit's two routes on one GPU, for the gates protocol._FUSED_COMMIT_MAX:
Ligero ft255 rho = 1/4 and Brakedown CODE3 ft255 commits at 2^N coefficients.

    python3 scripts/time_small_commit.py [--logs 11,13,...,23] [--reps 16]
                                         [--encodings ligero,sdig] [--digest blake3]
                                         [--dot]

Each size makes its encoding and random Montgomery coefficients on the card,
then commits through the public entry point (protocol.commit) by each route,
forced through protocol._FUSED_COMMIT_MAX (0 for every encoding: stage by
stage, every kernel launched from Python; past every size: the graph route,
which here captures a shape's CUDA graph on its second commit,
protocol._CAPTURE_AT forced to 2, and replays the same kernels with the
copies in and out after):
  - one-shot commits (the shape's first, staged and counted: the cache
    cleared before each) against staged ones, host ms, in turns (staged,
    graph, graph, staged; --reps / 4 each, medians);
  - the capture's commit (the shape's second: capture and one replay), host
    ms, the device memory the captured graph keeps (its pool and buffers),
    and a capture alone (protocol._CommitGraph) and its first replay;
  - both routes' roots, Merkle arrays and codewords equal;
  - host wall (a host clock around a commit that ends in synchronize()),
    the median of --reps warm commits a route, in turns: staged, graph,
    graph, staged, --reps / 2 each;
  - one torch.profiler trace of a commit by each route: CUDA kernel events,
    device busy, the idle share (1 - busy / wall);
  - the graph route's copies (the coefficients in; the codeword, the Merkle
    array and, for a padded row, the coefficient matrix out) timed alone
    on the device;
  - with --dot, the first size's graph captured in debug mode: its nodes by
    type and kernel node labels, the DOT file in chiprun_out/.
The crossover of each encoding is the largest size whose graph median is
below the staged median; a capture pays for itself after (capture's commit
- staged) ms / (staged - graph) ms commits (protocol._CAPTURE_AT).  Prints one JSON line last and writes
chiprun_out/time_small_commit.json.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE, _ROOT]

import torch  # noqa: E402

import kernel_bench as kb  # noqa: E402

OFF = 1 << 62  # a gate every size is under: the graph route
STAGED = 0     # a gate every size is over: the staged route


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def trace(fn):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = synced(fn)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "cuda_events": len(events),
            "idle_share": 1 - busy / wall if wall else None}


def make_encoding(P, name, spec, n):
    if name == "ligero":
        return P.LigeroEncoding.new(spec, n, 1, 4, device="cuda")
    return P.SdigEncoding.new(spec, n, seed=0, device="cuda")


def set_gate(protocol, gates, gate):
    """Every encoding's gate set to `gate`, every capture at a shape's second
    commit."""
    protocol._FUSED_COMMIT_MAX = {k: gate for k in gates}
    protocol._CAPTURE_AT = {k: 2 for k in gates}


def measure(P, protocol, gates, name, log_n, digest, reps, gen, dot):
    spec = P.FT255
    n = 1 << log_n
    enc = make_encoding(P, name, spec, n)
    coeffs = kb.random_mont(spec, (1, spec.w16, n), gen)[0]
    n_rows, n_per_row, n_cols = enc.get_dims(n)

    def commit(gate):
        set_gate(protocol, gates, gate)
        return P.commit(coeffs, enc, digest=digest)

    staged = commit(STAGED)  # the kernels built and the tables made
    replays = protocol._commit_fused_fn.launches
    one = {"staged": [], "graph": []}
    for route in ("staged", "graph", "graph", "staged"):
        for _ in range(max(1, reps // 4)):
            protocol._fused_commits.clear()  # the shape unseen
            one[route].append(synced(lambda: commit(STAGED if route == "staged" else OFF))[1])
    if protocol._commit_fused_fn.launches != replays:
        raise AssertionError(f"{name} 2^{log_n}: the shape's first commit replayed a graph")
    one_shot_ms = statistics.median(one["graph"])
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    with kb.debug_graphs() if dot else contextlib.nullcontext() as made:
        commit(OFF)  # the shape's first commit: counted
        graph, capture_ms_commit = synced(lambda: commit(OFF))
    if protocol._commit_fused_fn.launches != replays + 1:
        raise AssertionError(f"{name} 2^{log_n}: the second commit did not replay")
    for a, b, what in ((staged.hashes_dev, graph.hashes_dev, "Merkle array"),
                       (staged.comm, graph.comm, "codeword"), (staged.coeffs, graph.coeffs,
                                                               "coefficients")):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} 2^{log_n}: the routes' {what} differ")
    lone, capture_ms = synced(lambda: protocol._CommitGraph(enc, digest, n))
    _, first_replay_ms = synced(lambda: lone.run(coeffs))
    del lone
    nodes = None
    if dot:
        path = os.path.join(_ROOT, "chiprun_out", f"commit_graph_{name}_{log_n}.dot")
        found = kb.graph_nodes(made[0], path)
        nodes = {"by_type": dict(collections.Counter(k for k, _ in found)),
                 "kernels": [" ".join(lab.split())[:400] for k, lab in found if k == "KERNEL"]}
        print(f"{name} 2^{log_n} graph nodes: {nodes['by_type']}; DOT head:\n"
              f"{open(path).read()[:3000]}", flush=True)
    times = {"staged": [], "graph": []}
    for route in ("staged", "graph", "graph", "staged"):
        gate = STAGED if route == "staged" else OFF
        commit(gate)
        times[route] += [synced(lambda: commit(gate))[1] for _ in range(max(1, reps // 2))]
    med = {k: statistics.median(v) for k, v in times.items()}
    traces = {route: trace(lambda: commit(STAGED if route == "staged" else OFF))
              for route in ("staged", "graph")}
    copies = [graph.comm, graph.hashes_dev] + ([graph.coeffs] if n_rows * n_per_row > n else [])
    copy_ms = kb.time_kernel(lambda: [t.clone() for t in copies] + [coeffs.clone()])
    copy_bytes = 2 * sum(t.numel() * t.element_size() for t in copies + [coeffs])
    n_copies = len(copies) + 1
    del staged, graph, copies
    torch.cuda.empty_cache()
    graph_bytes = torch.cuda.memory_reserved() - reserved  # the graph's pool, kept
    gain = med["staged"] - med["graph"]
    rec = {"encoding": name, "log_n": log_n, "digest": digest.name, "n_rows": n_rows,
           "n_per_row": n_per_row, "n_cols": n_cols, "elements": n_rows * n_cols,
           "one_shot_ms": one_shot_ms, "one_shot_staged_ms": statistics.median(one["staged"]),
           "one_shot_runs_ms": one, "capture_commit_ms": capture_ms_commit,
           "capture_ms": capture_ms, "first_replay_ms": first_replay_ms,
           "staged_ms": med["staged"], "graph_ms": med["graph"],
           "speedup": med["staged"] / med["graph"],
           "commits_to_repay_capture": ((capture_ms_commit - med["staged"]) / gain
                                        if gain > 0 else None),
           "graph_bytes": graph_bytes, "graph_nodes": nodes,
           "staged_runs_ms": times["staged"], "graph_runs_ms": times["graph"],
           "trace": traces, "copies": n_copies,
           "copy_bytes": copy_bytes, "copy_ms": copy_ms}
    print(f"{name} 2^{log_n} ({digest.name}): {n_rows} x {n_cols} = {n_rows * n_cols:,} "
          f"elements; staged {med['staged']:.4f} ms, graph {med['graph']:.4f} ms "
          f"(x{rec['speedup']:.2f}); one-shot {one_shot_ms:.4f} ms (staged "
          f"{rec['one_shot_staged_ms']:.4f}), capture commit {capture_ms_commit:.3f} ms "
          f"(capture {capture_ms:.3f}, first replay {first_replay_ms:.3f}; repaid after "
          f"{rec['commits_to_repay_capture']} commits), graph "
          f"keeps {graph_bytes / 2**20:.1f} MiB; events {traces['staged']['cuda_events']} / "
          f"{traces['graph']['cuda_events']}, idle {traces['staged']['idle_share']:.3f} / "
          f"{traces['graph']['idle_share']:.3f}; copies {n_copies}, "
          f"{copy_bytes / 1e6:.2f} MB moved, {copy_ms:.4f} ms", flush=True)
    del enc
    protocol._fused_commits.clear()
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--logs", default="11,12,13,14,15,16,17,18,19,20,21,22,23")
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--encodings", default="ligero,sdig")
    ap.add_argument("--digest", default="blake3")
    ap.add_argument("--dot", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_small_commit.py needs a CUDA device")
    import lcpc_tpu_torch as P
    from lcpc_tpu_torch.core import protocol

    card = kb.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    digest = P.DIGESTS_BY_NAME[args.digest]
    gate0, capture0 = protocol._FUSED_COMMIT_MAX, protocol._CAPTURE_AT
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    recs, crossover = [], {}
    try:
        for name in args.encodings.split(","):
            for i, log_n in enumerate(int(v) for v in args.logs.split(",")):
                rec = measure(P, protocol, gate0, name, log_n, digest, args.reps, gen,
                              args.dot and i == 0)
                recs.append(rec)
                if rec["graph_ms"] < rec["staged_ms"]:
                    crossover[name] = max(crossover.get(name, 0), rec["elements"])
    finally:
        protocol._FUSED_COMMIT_MAX, protocol._CAPTURE_AT = gate0, capture0
    out = {"card": card, "gate": gate0, "largest_graph_win_elements": crossover,
           "records": recs}
    with open(os.path.join(_ROOT, "chiprun_out", "time_small_commit.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": card, "gate": gate0, "largest_graph_win_elements": crossover,
                      "ms": {f"{r['encoding']} 2^{r['log_n']}": [
                          r["staged_ms"], r["graph_ms"], r["one_shot_ms"],
                          r["capture_commit_ms"]] for r in recs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
