"""Suppression-debt ratchet.

Every ``# ktpu: ignore[RULE]: reason`` is technical debt: code the
rules believe is wrong, waved through by hand. The ratchet pins
today's debt in a committed baseline
(``analysis/suppression_baseline.json``) and CI fails when the count
GROWS — per rule, not just in total, so trading a TPU001 ignore for a
new FENCE001 ignore is visible. Shrinking is always allowed (and the
next ``--write-baseline`` commits the better number).

The unit counted is the ignore DIRECTIVE per rule it names (one
``ignore[TPU001,LOCK001]`` line counts once for each rule), not the
findings it happens to match — so a directive that stops matching
anything still shows up as debt until it is deleted, which is exactly
the nudge we want.

Copied from ``kubernetes_tpu/analysis/ratchet.py``; the baseline is the
port's own ``analysis/suppression_baseline.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

BASELINE_PATH = Path(__file__).resolve().parent / "suppression_baseline.json"


def count_suppressions(modules) -> dict:
    """{"total": n, "rules": {rule: n}} over the analyzed modules."""
    rules: dict[str, int] = {}
    total = 0
    for m in modules:
        for s in m.suppressions:
            total += 1
            for r in s.rules:
                rules[r] = rules.get(r, 0) + 1
    return {"total": total, "rules": dict(sorted(rules.items()))}


def render_baseline(counts: dict) -> str:
    return json.dumps(counts, indent=2, sort_keys=True) + "\n"


def load_baseline(path: Path | None = None) -> dict | None:
    p = path or BASELINE_PATH
    if not p.exists():
        return None
    return json.loads(p.read_text())


def check_ratchet(counts: dict, baseline: dict | None) -> list[str]:
    """Human-readable violations; empty means the ratchet holds."""
    if baseline is None:
        return [
            "no committed suppression baseline "
            f"({BASELINE_PATH.name}) — write one: "
            "python -m kubernetes_tpu_torch.analysis --write-baseline"
        ]
    out = []
    if counts["total"] > baseline.get("total", 0):
        out.append(
            f"suppression count grew: {counts['total']} > baseline "
            f"{baseline.get('total', 0)}"
        )
    base_rules = baseline.get("rules", {})
    for rule, n in sorted(counts["rules"].items()):
        if n > base_rules.get(rule, 0):
            out.append(
                f"suppressions for {rule} grew: {n} > baseline "
                f"{base_rules.get(rule, 0)}"
            )
    if out:
        out.append(
            "fix the finding instead of suppressing it; if the "
            "suppression is genuinely correct, bump the baseline in "
            "the same commit: python -m kubernetes_tpu_torch.analysis "
            "--write-baseline"
        )
    return out
