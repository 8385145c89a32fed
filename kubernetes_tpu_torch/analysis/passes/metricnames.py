"""MET001 — metric usage must resolve against the metrics registry.

Every ``metrics.<attr>`` reference in scheduler.py / server/ / solver/
must be an attribute actually defined in ``kubernetes_tpu_torch/metrics``
(the module registers against a dedicated CollectorRegistry, so a typo
does not fail at import — it raises AttributeError on the first hot
batch that tries to record it). String literals shaped like a
prometheus series name (``scheduler_*``) must likewise name a
registered series, so dashboards never chase a renamed metric.

Copied from ``kubernetes_tpu/analysis/passes/metricnames.py``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from ..core import Finding, Pass

_NAME_RE = re.compile(r"scheduler_[a-z0-9_]+")
_METRIC_CLASSES = {"Counter", "Gauge", "Histogram", "Summary"}


def load_metric_registry(path: Path | None = None) -> dict[str, str | None]:
    """attr name -> prometheus series name (None for non-metric module
    globals like REGISTRY / render, which are still valid attributes)."""
    if path is None:
        path = (
            Path(__file__).resolve().parents[2] / "metrics" / "__init__.py"
        )
    attrs: dict[str, str | None] = {}
    tree = ast.parse(path.read_text(), filename=str(path))
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            attrs[stmt.name] = None
        elif isinstance(stmt, ast.Assign):
            name = None
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    name = t.id
            if name is None:
                continue
            series = None
            v = stmt.value
            if (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Name)
                and v.func.id in _METRIC_CLASSES
                and v.args
                and isinstance(v.args[0], ast.Constant)
                and isinstance(v.args[0].value, str)
            ):
                series = v.args[0].value
            attrs[name] = series
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for alias in stmt.names:
                attrs[alias.asname or alias.name.split(".")[0]] = None
    return attrs


class MetricNamePass(Pass):
    rule = "MET001"
    title = "unregistered metric reference"

    def run(self, module, ctx):
        if not any(module.rel.startswith(p) for p in ctx.metric_scan_paths):
            return []
        attrs = ctx.metric_attrs
        if attrs is None:
            attrs = ctx.metric_attrs = load_metric_registry()
        series = {s for s in attrs.values() if s}
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "metrics"
            ):
                if node.attr not in attrs:
                    findings.append(
                        Finding(
                            self.rule, module.path, node.lineno,
                            f"metrics.{node.attr} is not defined in "
                            "kubernetes_tpu_torch/metrics/__init__.py",
                            hint="register the series there (dedicated "
                            "registry) before recording to it",
                        )
                    )
            elif (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _NAME_RE.fullmatch(node.value)
                and node.value not in series
            ):
                findings.append(
                    Finding(
                        self.rule, module.path, node.lineno,
                        f'metric name string "{node.value}" does not match '
                        "any registered series",
                        hint="dashboards key on exposition names; register "
                        "or correct the series name",
                    )
                )
        return findings
