"""What the exact solver's scan-step CUDA graphs cost and save on one GPU.

    python3 scripts/step_graph_costs.py --out FILE [--nodes 5120] [--pods 1024]

At interpod5k's shape by default (chip_smoke's mixed InterPodAffinity
workload: hostPort, hard zone spread, required hostname anti-affinity and
preferred zone affinity pods on nodes in 3 zones, random tie-break,
BalancedAllocation in float64), session solves of one batch on one solver:

- ``eager``: the step graphs off (``graphs.engages`` patched to False), a
  warm-up solve, then a measured one: the issue seconds per scan step;
- ``graphs``: a fresh solver, a first solve that warms up and captures each
  signature's graph (each capture and instantiation timed on the host),
  then the same batch again, which replays only: the issue seconds per
  replayed step and the card's seconds per pod (CUDA events around the
  solve, after a synchronize);
- ``threshold``: capture seconds over the eager step's issue seconds, the
  number of eager steps a capture costs (``graphs.MIN_STEPS``).

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
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--pods", type=int, default=1024)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_graph_costs: CUDA is not available; this script runs on an NVIDIA GPU")
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.solver import graphs as sg
    from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
    from kubernetes_tpu_torch.tensorize.schema import ResourceVocab

    dev = torch.device("cuda")
    nodes = cs.make_nodes(args.nodes)
    pods = [cs.make_pod(i) for i in range(args.pods)]
    vocab = ResourceVocab.build(pods, nodes)
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
        return a, {"wall_s": wall, "card_s": start.elapsed_time(end) / 1e3,
                   "issue_s": tm.seconds["issue"], "scan_steps": tm.scan_steps,
                   "graph_replays": tm.graph_replays, "graph_captures": tm.graph_captures}

    real = sg.engages
    sg.engages = lambda *a: False
    try:
        eager = ExactSolver(cfg)
        solve(eager)  # warm-up: kernels built and loaded, caches filled
        a_eager, e = solve(eager)
    finally:
        sg.engages = real
    e["issue_us_per_step"] = 1e6 * e["issue_s"] / e["scan_steps"]

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
        raise AssertionError("step graphs: the replayed solve differs from the eager one")
    g["issue_us_per_step"] = 1e6 * g["issue_s"] / g["scan_steps"]
    g["card_us_per_pod"] = 1e6 * g["card_s"] / g["scan_steps"]
    capture_s = statistics.median(captures)
    res = {
        "card": _smi(), "nodes": args.nodes, "pods": args.pods,
        "eager": e, "graphs_first_solve": first, "graphs": g,
        "capture_s": captures,
        "threshold": {"capture_s_median": capture_s,
                      "eager_steps_per_capture": capture_s / (e["issue_s"] / e["scan_steps"]),
                      "MIN_STEPS": sg.MIN_STEPS},
        "placed": int((a_graph >= 0).sum()),
    }
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
