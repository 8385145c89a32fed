"""Run one cell of the port's benchmark once, on the card, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number the correctness check
compared, with its limit). The same numbers end standard error. Without a
CUDA card, or with fewer cards than the cell asks for, it prints no result
and exits with 2; it never runs on the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, params = harness.load_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, config, params, bench, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T0)
    sys.stdout.flush()
    for line in harness.check_lines(out):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
