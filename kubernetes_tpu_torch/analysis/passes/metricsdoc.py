"""MET002 — two-way drift check: metrics registry vs docs/METRICS.md.

The registry (``kubernetes_tpu_torch/metrics/__init__.py``) and the
documentation table are both hand-visible surfaces; the doc keeps up
with new metrics only because a runtime gate
(``python -m kubernetes_tpu_torch.metrics --check``) compares the RENDERED
document byte-for-byte. That gate needs a live prometheus import; this
pass is the analyzer-side equivalent — pure AST + text, so it runs in
the lint gate with zero runtime deps — and it is two-way:

- every metric registered in the module must appear in the doc table
  (finding anchored at the registration line);
- every ``| `name` |`` row in the doc must correspond to a registered
  metric (finding anchored at the doc row, path = the doc file).

Prometheus counters expose ``<name>_total`` even when registered
without the suffix; the comparison normalizes exactly like the doc
generator does.

Copied from ``kubernetes_tpu/analysis/passes/metricsdoc.py``; the port
reads the JAX package's ``docs/METRICS.md`` and never writes it. The
port's own series are documented beside its registry
(``kubernetes_tpu_torch/metrics/METRICS.md``), which this pass reads as
a second table when it reads the shipped files.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from ..core import AnalysisContext, Finding
from ..project import ProjectGraph, ProjectPass

_METRIC_CLASSES = {"Counter", "Gauge", "Histogram", "Summary"}
_ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|")


def _registered(tree: ast.Module) -> list:
    """(exposed series name, line) per registry assignment."""
    out = []
    for stmt in tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and isinstance(stmt.value, ast.Call)
        ):
            continue
        f = stmt.value.func
        kind = (
            f.id
            if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else ""
        )
        if kind not in _METRIC_CLASSES or not stmt.value.args:
            continue
        arg = stmt.value.args[0]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            continue
        name = arg.value
        if kind == "Counter" and not name.endswith("_total"):
            name += "_total"
        out.append((name, stmt.lineno))
    return out


class MetricsDocPass(ProjectPass):
    rule = "MET002"
    title = "metrics registry <-> docs/METRICS.md drift"

    def run_project(
        self, project: ProjectGraph, ctx: AnalysisContext
    ) -> list:
        reg_rel = next(
            (
                rel
                for rel in sorted(project.modules)
                if rel.endswith(ctx.metrics_module_suffix)
            ),
            None,
        )
        if reg_rel is None:
            return []  # partial run (single file / fixtures without one)
        m = project.modules[reg_rel]
        registered = _registered(m.tree)

        doc_text = ctx.metrics_doc_text
        doc_label = "docs/METRICS.md"
        docs: list[tuple[str, str]] = []
        if doc_text is None:
            doc_path = (
                Path(m.path).resolve().parents[2] / "docs" / "METRICS.md"
            )
            doc_label = str(doc_path)
            if not doc_path.exists():
                return [
                    Finding(
                        rule=self.rule,
                        path=m.path,
                        line=1,
                        message="docs/METRICS.md not found",
                        hint=(
                            "the port reads the JAX package's "
                            "docs/METRICS.md and never writes it"
                        ),
                    )
                ]
            doc_text = doc_path.read_text()
            port_doc = Path(m.path).resolve().parent / "METRICS.md"
            if port_doc.exists():
                docs.append((str(port_doc), port_doc.read_text()))
        docs.insert(0, (doc_label, doc_text))

        documented: dict[str, tuple[str, int]] = {}
        for label, text in docs:
            for i, line in enumerate(text.splitlines(), 1):
                row = _ROW_RE.match(line.strip())
                if row:
                    documented.setdefault(row.group(1), (label, i))

        findings: list[Finding] = []
        reg_names = {name for name, _ in registered}
        for name, line in registered:
            if name not in documented:
                findings.append(
                    Finding(
                        rule=self.rule,
                        path=m.path,
                        line=line,
                        message=(
                            f"metric '{name}' is registered but missing "
                            "from docs/METRICS.md"
                        ),
                        hint=(
                            "the port's series names are the JAX "
                            "package's: python -m kubernetes_tpu_torch."
                            "metrics --check"
                        ),
                    )
                )
        for name in sorted(documented):
            if name not in reg_names:
                path, line = documented[name]
                findings.append(
                    Finding(
                        rule=self.rule,
                        path=path,
                        line=line,
                        message=(
                            f"documented metric '{name}' is not "
                            "registered in kubernetes_tpu_torch/metrics"
                        ),
                        hint=(
                            "restore the metric: python -m "
                            "kubernetes_tpu_torch.metrics --check"
                        ),
                    )
                )
        return findings
