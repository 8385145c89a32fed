"""CLI: ``python -m kubernetes_tpu_torch.analysis [options] [paths...]``.

Exit status 0 when every finding is suppressed (with a reason) and
every enabled gate holds, 1 otherwise — tests/test_torch_analysis.py
keys on this. 2 means the invocation itself was wrong (bad path).

Gates and artifacts beyond the finding scan:

- ``--sarif FILE``      write the findings as SARIF 2.1.0 (CI artifact)
- ``--ratchet``         enforce the suppression-debt baseline
- ``--write-baseline``  regenerate analysis/suppression_baseline.json
- ``--check-lock-order`` fail if analysis/LOCK_ORDER.md drifted from the
  computed lock graph
- ``--write-lock-order`` regenerate analysis/LOCK_ORDER.md

The lock-order artifact is the port's own file inside this package; the
JAX package's ``docs/LOCK_ORDER.md`` is never written.

Copied from ``kubernetes_tpu/analysis/__main__.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import (
    ALL_PASSES,
    ALL_PROJECT_PASSES,
    analyze_project,
    build_project,
    default_context,
    load_modules,
)
from .passes.lockorder import lock_order_markdown
from .ratchet import (
    BASELINE_PATH,
    check_ratchet,
    count_suppressions,
    load_baseline,
    render_baseline,
)
from .sarif import render_sarif

LOCK_ORDER_PATH = Path(__file__).resolve().parent / "LOCK_ORDER.md"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.analysis",
        description="Host-sync & lock-discipline static analyzer.",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories (default: the kubernetes_tpu_torch package)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings (including suppressed) as a JSON array",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print suppressed findings in text mode",
    )
    parser.add_argument(
        "--sarif", metavar="FILE",
        help="write findings as SARIF 2.1.0 ('-' for stdout)",
    )
    parser.add_argument(
        "--ratchet", action="store_true",
        help="enforce the suppression-debt baseline "
        f"({BASELINE_PATH.name})",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="regenerate the suppression-debt baseline file",
    )
    parser.add_argument(
        "--check-lock-order", action="store_true",
        help="fail if analysis/LOCK_ORDER.md drifted from the computed "
        "lock graph",
    )
    parser.add_argument(
        "--write-lock-order", action="store_true",
        help="regenerate analysis/LOCK_ORDER.md from the computed lock graph",
    )
    args = parser.parse_args(argv)

    ctx = default_context()
    try:
        modules, broken = load_modules(args.paths or None)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    findings = analyze_project(modules, ctx=ctx)
    findings.extend(broken)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    failures: list[str] = []

    if args.sarif:
        text = render_sarif(findings)
        if args.sarif == "-":
            print(text)
        else:
            Path(args.sarif).write_text(text + "\n")

    if args.write_baseline:
        BASELINE_PATH.write_text(
            render_baseline(count_suppressions(modules))
        )
        print(f"wrote {BASELINE_PATH}", file=sys.stderr)
    elif args.ratchet:
        failures.extend(
            check_ratchet(count_suppressions(modules), load_baseline())
        )

    if args.write_lock_order or args.check_lock_order:
        project = build_project(modules, ctx)
        artifact = lock_order_markdown(project)
        if args.write_lock_order:
            LOCK_ORDER_PATH.write_text(artifact)
            print(f"wrote {LOCK_ORDER_PATH}", file=sys.stderr)
        elif args.check_lock_order:
            committed = (
                LOCK_ORDER_PATH.read_text()
                if LOCK_ORDER_PATH.exists()
                else ""
            )
            if committed != artifact:
                failures.append(
                    "analysis/LOCK_ORDER.md drifted from the computed lock "
                    "graph — regenerate: python -m kubernetes_tpu_torch."
                    "analysis --write-lock-order"
                )

    if args.as_json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
        for msg in failures:
            print(f"GATE: {msg}", file=sys.stderr)
    else:
        shown = findings if args.show_suppressed else active
        for f in shown:
            print(f.render())
        for msg in failures:
            print(f"GATE: {msg}")
        rules = ", ".join(
            c.rule for c in ALL_PASSES + ALL_PROJECT_PASSES
        )
        print(
            f"{len(active)} finding(s), {len(suppressed)} suppressed "
            f"(passes: {rules})"
        )
    return 1 if (active or failures) else 0


if __name__ == "__main__":
    sys.exit(main())
