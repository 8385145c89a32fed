"""SARIF 2.1.0 serialization for CI artifact upload.

One run, one tool (``ktpu-analysis``), one result per finding.
Suppressed findings are carried as SARIF ``suppressions`` entries
(kind ``inSource``) instead of being dropped, so the artifact is a
complete audit trail — the same contract as ``--json``. Output is
deterministic: results arrive pre-sorted from the runner and the
rules index is sorted by id.

Copied from ``kubernetes_tpu/analysis/sarif.py``.
"""

from __future__ import annotations

import json

# rule id -> short description, for the SARIF rules table; unknown
# ids (KTPU000/KTPU001 synthetics) get a generic entry
_RULE_HELP = {
    "TPU001": "host<->device sync in device/hot scope",
    "TPU002": "device-value branch in python control flow",
    "TPU003": "weak dtype discipline in solver tensors",
    "TPU004": "cross-module host-sync escape",
    "LOCK001": "guarded attribute touched outside its lock",
    "LOCK002": "lock-order cycle / self-deadlock",
    "FENCE001": "replicated state touched without role/epoch fence",
    "RETRY001": "retry-discipline violation",
    "MET001": "unregistered metric series name",
    "MET002": "metrics registry <-> docs drift",
    "KTPU000": "suppression without a reason",
    "KTPU001": "unparsable source file",
}


def to_sarif(findings) -> dict:
    rule_ids = sorted({f.rule for f in findings} | set(_RULE_HELP))
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "warning" if f.suppressed else "error",
            "message": {
                "text": f.message + (f" (hint: {f.hint})" if f.hint else "")
            },
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": max(f.line, 1)},
                    }
                }
            ],
        }
        if f.suppressed:
            result["suppressions"] = [
                {
                    "kind": "inSource",
                    "justification": f.suppress_reason,
                }
            ]
        results.append(result)
    return {
        "version": "2.1.0",
        "$schema": (
            "https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/os/"
            "schemas/sarif-schema-2.1.0.json"
        ),
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "ktpu-analysis",
                        "informationUri": (
                            "kubernetes_tpu_torch/analysis/README.md"
                        ),
                        "rules": [
                            {
                                "id": rid,
                                "shortDescription": {
                                    "text": _RULE_HELP.get(
                                        rid, "kubernetes_tpu_torch analyzer rule"
                                    )
                                },
                            }
                            for rid in rule_ids
                        ],
                    }
                },
                "results": results,
            }
        ],
    }


def render_sarif(findings) -> str:
    return json.dumps(to_sarif(findings), indent=2, sort_keys=True)
