"""What the exact solver's CUDA graphs cost and save on one GPU: the scan
step's, or the grouped random loop's quota iterations'.

    python3 scripts/step_graph_costs.py --out FILE [--shape interpod5k|spread5k]
        [--nodes N] [--pods P]

``interpod5k`` (the default; 5,120 nodes, 1,024 pods): chip_smoke's mixed
InterPodAffinity workload, hostPort, hard zone spread, required hostname
anti-affinity and preferred zone affinity pods on nodes in 3 zones; the
unit is a scan step. ``spread5k`` (5,000 nodes, 1,024 pods): the benchmark
configuration's nodes (4 CPU, 32Gi, 110 pods, 3 zones) and its pods (one
hard zone spread at maxSkew 5 over their own label, 100m / 500Mi), 16
spread chunks of 64 pods; the unit is a spread chunk's loop iteration.
Random tie-break, BalancedAllocation in float64, session solves of one
batch on one solver:

- ``eager``: the graphs off (``graphs.engages`` patched to False), a
  warm-up solve, then a measured one: the issue seconds per unit;
- ``graphs``: a fresh solver, a first solve that warms up and captures each
  signature's graph (each capture and instantiation timed on the host),
  then the same batch again, which replays only: the issue seconds per
  replayed unit and the card's seconds per unit (CUDA events around the
  solve, after a synchronize);
- ``threshold``: capture seconds over the eager unit's issue seconds, the
  number of eager units a capture costs (``graphs.MIN_STEPS`` or
  ``graphs.MIN_ITERATIONS``).

The assignments of the two solvers' measured solves must be equal. Writes
one JSON object to FILE and prints it, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--shape", choices=("interpod5k", "spread5k"), default="interpod5k")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--pods", type=int, default=1024)
    args = ap.parse_args()
    spread = args.shape == "spread5k"
    if args.nodes is None:
        args.nodes = 5000 if spread else 5120
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_graph_costs: CUDA is not available; this script runs on an NVIDIA GPU")
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
    from kubernetes_tpu_torch.solver import graphs as sg
    from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
    from kubernetes_tpu_torch.tensorize.schema import ResourceVocab

    dev = torch.device("cuda")
    if spread:
        nodes = [MakeNode().name(f"node-{i:05}")
                 .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
                 .label(cs.ZONE, f"z{i % 3}").label(cs.HOST, f"node-{i:05}").obj()
                 for i in range(args.nodes)]
        pods = [MakePod().name(f"pod-{i:05}").label("foo", "bar")
                .req({"cpu": "100m", "memory": "500Mi"})
                .spread_constraint(5, cs.ZONE, "DoNotSchedule", {"foo": "bar"}).obj()
                for i in range(args.pods)]
    else:
        nodes = cs.make_nodes(args.nodes)
        pods = [cs.make_pod(i) for i in range(args.pods)]
    vocab = ResourceVocab.build(pods, nodes)

    def units(tm):
        """(units, replayed, captured) of the last solve: scan steps, or
        the spread chunks' loop iterations."""
        if spread:
            return (tm.chunk_iterations["spread"], sum(tm.grouped_graph_replays.values()),
                    sum(tm.grouped_graph_captures.values()))
        return tm.scan_steps, tm.graph_replays, tm.graph_captures
    cfg = ExactSolverConfig(tie_break="random", balanced_fdtype="float64", seed=cs.SEED)

    def solve(solver):
        inp = cs.tensorize(nodes, pods, {}, vocab)
        versions = np.zeros(inp[0].padded, np.int64)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        a = solver.solve(*inp, col_versions=versions, device=dev)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        tm = solver.times
        n, replays, captures = units(tm)
        return a, {"wall_s": wall, "card_s": start.elapsed_time(end) / 1e3,
                   "issue_s": tm.seconds["issue"], "card_read_s": tm.seconds["card_read"],
                   "units": n, "replays": replays, "captures": captures}

    real = sg.engages
    sg.engages = lambda *a: False
    try:
        eager = ExactSolver(cfg)
        solve(eager)  # warm-up: kernels built and loaded, caches filled
        a_eager, e = solve(eager)
    finally:
        sg.engages = real
    e["issue_us_per_unit"] = 1e6 * e["issue_s"] / e["units"]

    captures = []
    orig = sg.StepGraphs.capture

    def timed(self, fn):
        t = time.perf_counter()
        g = orig(self, fn)
        captures.append(time.perf_counter() - t)
        return g

    sg.StepGraphs.capture = timed
    try:
        solver = ExactSolver(cfg)
        _, first = solve(solver)
        a_graph, g = solve(solver)
    finally:
        sg.StepGraphs.capture = orig
    if not np.array_equal(a_graph, a_eager):
        raise AssertionError("graphs: the replayed solve differs from the eager one")
    g["issue_us_per_unit"] = 1e6 * g["issue_s"] / g["units"]
    g["card_us_per_unit"] = 1e6 * g["card_s"] / g["units"]
    capture_s = statistics.median(captures)
    res = {
        "card": _smi(), "shape": args.shape, "nodes": args.nodes, "pods": args.pods,
        "unit": "spread iteration" if spread else "scan step",
        "eager": e, "graphs_first_solve": first, "graphs": g,
        "capture_s": captures,
        "threshold": {"capture_s_median": capture_s,
                      "eager_units_per_capture": capture_s / (e["issue_s"] / e["units"]),
                      "MIN_ITERATIONS" if spread else "MIN_STEPS":
                          sg.MIN_ITERATIONS if spread else sg.MIN_STEPS},
        "placed": int((a_graph >= 0).sum()),
    }
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
