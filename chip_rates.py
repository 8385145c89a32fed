"""Random-mode rates of the PyTorch/CUDA port on one GPU, written so that
two trees can be compared in one call.

    python3 chip_rates.py [--root DIR] --out FILE

Imports ``kubernetes_tpu_torch`` and ``chip_smoke``'s workload builders from
``--root`` (by default this script's directory), so the same measurement
runs against another checkout, such as a parent commit unpacked into a
git-ignored directory. Run the two trees in turns (parent, change, change,
parent) and compare within the call. With tie_break "random", on the card:

- ``scan``: ``ExactSolver.solve`` of chip_smoke's mixed InterPodAffinity
  workload at phase 13a's shape (5,120 nodes, 1,024 pods, one batch,
  unsharded, balanced float64), after a warm-up solve: solve seconds and
  pods/s; and the card's kernel launches per scan step from torch.profiler
  (two solves of 64 and 128 pods, whose difference cancels the upload and
  the read);
- ``9b``: phase 9b's two ``PerfRunner`` workloads with the default config
  (SchedulingPodAntiAffinity at 5,120 nodes and 5,120 pods,
  SchedulingPodTopologySpread at 5,120 nodes and 10,240 pods): steady
  pods/s and device-solve seconds.

Writes one JSON object to FILE and prints it, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()


def scan_rates(cs, torch, dev, n_nodes=5120, n_pods=1024):
    from kubernetes_tpu_torch.solver.exact import ExactSolver, ExactSolverConfig
    from kubernetes_tpu_torch.tensorize.schema import ResourceVocab
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nodes = cs.make_nodes(n_nodes)
    cfg = ExactSolverConfig(tie_break="random", balanced_fdtype="float64", seed=cs.SEED)

    def inputs(n):
        pods = [cs.make_pod(i) for i in range(n)]
        return cs.tensorize(nodes, pods, {}, ResourceVocab.build(pods, nodes))

    ExactSolver(cfg).solve(*inputs(64), device=dev)  # warm-up: kernels built, caches filled
    batch = inputs(n_pods)
    torch.cuda.synchronize()
    t = time.perf_counter()
    a = ExactSolver(cfg).solve(*batch, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {}
    for n in (64, 128):
        solver_in = inputs(n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ExactSolver(cfg).solve(*solver_in, device=dev)
            torch.cuda.synchronize()
        launches[n] = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset")))
    per_step = (launches[128] - launches[64]) / 64 if launches[128] else "not measured"
    return {"nodes": n_nodes, "pods": n_pods, "placed": int((a >= 0).sum()),
            "solve_s": secs, "pods_per_s": n_pods / secs,
            "launches_per_step": per_step, "launches": launches}


def perf_rates(cs, dev, anti=(5120, 5120), spread=(5120, 10240)):
    import kubernetes_tpu_torch.perf.runner as runner_mod
    from kubernetes_tpu_torch.config import types as ct

    cases = {c["name"]: c for c in cs._yaml_cases()}
    runner = runner_mod.PerfRunner(ct.scheduler_config(ct.KubeSchedulerConfiguration()),
                                   device=dev)
    out = {}
    for case_name, (n_nodes, n_pods), label in (
            ("SchedulingPodAntiAffinity", anti, "anti"),
            ("SchedulingPodTopologySpread", spread, "spread")):
        params = {"initNodes": n_nodes, "measurePods": n_pods}
        t = time.perf_counter()
        r = runner.run_workload(case_name, "full width", cases[case_name]["workloadTemplate"],
                                params, os.path.dirname(cs.PERF_YAML))
        out[label] = {"case": case_name, **params, "scheduled": r.scheduled,
                      "wall_s": time.perf_counter() - t,
                      "steady_pods_per_s": r.steady_pods_per_sec(),
                      "device_solve_s": r.solve_seconds}
        if r.scheduled != n_pods:
            raise AssertionError(f"9b {label}: {r.scheduled} of {n_pods} placed")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_rates: CUDA is not available; this script runs on an NVIDIA GPU")
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    res = {"root": root, "scan": scan_rates(cs, torch, dev), "9b": perf_rates(cs, dev),
           "card": _smi()}
    res["seconds"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
