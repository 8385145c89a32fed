"""The correctness check's controls and planted faults, run at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds a,b,c --seconds <s> --variants v1,v2

A control is the program with one of its own options set the way the
configuration does not state, run through the whole of a benchmark run: the
check has to read it as not correct, or, for ``float32``, shows that this
configuration's answers do not move with the lower precision (see PERF.md).
Variants:

- ``float32``: BalancedAllocation in float32, the precision below the
  configuration's float64;
- ``most_allocated``: NodeResourcesFit's MostAllocated in place of the
  default profile's LeastAllocated (each pick then lies off the default
  profile's best score);
- ``no_filters``: NodePorts, InterPodAffinity and PodTopologySpread's
  filters switched off (the hostPort, anti-affinity and spread guarantees
  then break);
- ``sound``: the configuration as stated (the lower readings).

All seeds of all variants run in one process, one JSON line each with the
numbers compared;
the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "sound": {},
    "float32": {"balanced_fdtype": "float32"},
    "most_allocated": {"scoring_strategy": "MostAllocated"},
    "no_filters": {"disabled_filters": ("NodePorts", "InterPodAffinity", "PodTopologySpread")},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", required=True, help=f"comma-separated, of {', '.join(sorted(VARIANTS))}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, params = harness.load_cell(args.workload, bench)
    variants = args.variants.split(",")
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    for variant in variants:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = harness.run_cell(cell, config, params, bench, seed, args.seconds, False,
                                   device=args.device, solver_overrides=VARIANTS[variant])
            print(json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                              "correct": out["correct"], "metrics": out["metrics"],
                              "checks": {k: v["value"] for k, v in out["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
