"""FENCE001 — epoch/role fence discipline (project-wide).

The hub HA contract: after a failover, a deposed primary must
never serve replica-facing traffic from its (possibly diverged)
replicated state. The enforcement pattern is a *fence check* — the
``OccupancyExchange._ensure_primary_locked`` idiom: verify role and
lease epoch, raise ``HubDeposed`` otherwise — run at the top of every
method that touches replicated state.

A violation is easy to miss by reading the code;
this pass makes the contract structural:

- ``# ktpu: replicated`` trailing an attribute assignment in
  ``__init__`` registers hub-replicated state;
- ``# ktpu: fence-check`` marks the checker method(s);
- every OTHER method of that class touching a replicated attribute
  must *reach* a fence check — directly or through helpers, resolved
  over the cross-module call graph, so wrapping the checks in an
  ``_admit_gate()`` helper (or inheriting them from a base class)
  still satisfies the rule;
- ``# ktpu: fenced-by-caller`` exempts ``_locked``-suffix helpers
  whose public callers already ran the checks;
- ``# ktpu: fence-exempt(reason)`` records the deliberate bypasses —
  the replication apply path (a standby MUST write unfenced), debug
  and post-mortem surfaces — with a mandatory reason; a reasonless
  exemption is itself a finding.

Copied from ``kubernetes_tpu/analysis/passes/fence.py``.
"""

from __future__ import annotations

import ast

from ..callgraph import own_nodes
from ..core import AnalysisContext, Finding
from ..project import ProjectGraph, ProjectPass

# receiver-method calls that mutate a container in place: touching
# replicated state through these is a WRITE for the message text
_MUTATORS = {
    "append", "add", "pop", "popleft", "remove", "discard", "clear",
    "extend", "update", "setdefault", "insert",
}


class FencePass(ProjectPass):
    rule = "FENCE001"
    title = "epoch/role fence discipline"

    def run_project(
        self, project: ProjectGraph, ctx: AnalysisContext
    ) -> list:
        checks = set()
        for rel in sorted(project.graphs):
            graph = project.graphs[rel]
            m = project.modules[rel]
            for qual, finfo in graph.functions.items():
                if m.is_fence_check(finfo.node):
                    checks.add((rel, qual))
        satisfied = project.reaches(checks) if checks else set()

        findings: list[Finding] = []
        for key in sorted(project.classes):
            cinfo = project.classes[key]
            if not cinfo.replicated:
                continue
            rel = cinfo.rel
            m = project.modules[rel]
            graph = project.graphs[rel]
            for qual in sorted(graph.functions):
                finfo = graph.functions[qual]
                if finfo.cls != cinfo.name or finfo.parent:
                    continue
                name = finfo.node.name
                if name == "__init__":
                    continue  # construction precedes any role
                if m.is_fence_check(finfo.node):
                    continue
                if m.is_fenced_by_caller(finfo.node):
                    continue
                exempt = m.fence_exempt(finfo.node)
                if exempt is not None:
                    if not exempt:
                        findings.append(
                            Finding(
                                rule=self.rule,
                                path=m.path,
                                line=finfo.node.lineno,
                                message=(
                                    f"fence-exempt on '{qual}' has no "
                                    "reason"
                                ),
                                hint=(
                                    "write '# ktpu: fence-exempt(<why "
                                    "this surface may skip the fence>)'"
                                ),
                            )
                        )
                    continue
                if (rel, qual) in satisfied:
                    continue
                touch = self._first_touch(finfo.node, cinfo.replicated)
                if touch is None:
                    continue
                line, attr, wrote = touch
                verb = "writes" if wrote else "reads"
                findings.append(
                    Finding(
                        rule=self.rule,
                        path=m.path,
                        line=line,
                        message=(
                            f"'{qual}' {verb} replicated state "
                            f"'self.{attr}' without a role/epoch fence "
                            "check on any path"
                        ),
                        hint=(
                            "call the fence-check helper first (e.g. "
                            "_ensure_primary_locked), or annotate the "
                            "method: fenced-by-caller for _locked "
                            "helpers, fence-exempt(reason) for the "
                            "replication/debug surfaces"
                        ),
                    )
                )
        return findings

    def _first_touch(self, fnode, replicated) -> tuple | None:
        """(line, attr, wrote) of the first replicated-state access in
        the method's own statements; writes win over reads on a line."""
        best: tuple | None = None
        for node in own_nodes(fnode):
            hit = None
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in replicated
            ):
                wrote = isinstance(node.ctx, (ast.Store, ast.Del))
                hit = (node.lineno, node.attr, wrote)
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                # self._rows[k] = v stores through the Subscript; the
                # inner Attribute is only a Load
                base = node.value
                while isinstance(base, ast.Subscript):
                    base = base.value
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                    and base.attr in replicated
                ):
                    hit = (node.lineno, base.attr, True)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
            ):
                base = node.func.value
                # self._journal.append(...) / self._rows[k].pop(...)
                while isinstance(base, ast.Subscript):
                    base = base.value
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                    and base.attr in replicated
                ):
                    hit = (node.lineno, base.attr, True)
            if hit is not None and (
                best is None
                or hit[0] < best[0]
                or (hit[0] == best[0] and hit[2] and not best[2])
            ):
                best = hit
        return best
