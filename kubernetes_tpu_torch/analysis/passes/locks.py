"""LOCK001 — lock discipline for annotated shared attributes.

The pipelined loop shares mutable scheduler state (conflict fence,
session staleness, in-flight bookkeeping) between the drain thread and
watch-event ingest. The discipline is declared, not inferred: an
attribute assignment in ``__init__`` carrying ``# ktpu:
guarded-by(cluster.lock)`` registers the attribute, and every other
read or write of ``self.<attr>`` in the class must then sit lexically
inside ``with self.cluster.lock:`` (any alias spelled exactly
``self.<lockexpr>``) or in a function annotated ``# ktpu:
holds(cluster.lock)`` (asserting every caller already holds it — watch
callbacks fire under the cluster lock, for example).

The check is lexical: a nested function defined outside a ``with`` but
only ever *called* inside one needs a ``holds`` annotation (that is the
documentation the rule exists to force). ``__init__`` itself is exempt
(no concurrent readers before construction completes).

Copied from ``kubernetes_tpu/analysis/passes/locks.py``.
"""

from __future__ import annotations

import ast

from ..core import Finding, Pass, SourceModule


class LockDisciplinePass(Pass):
    rule = "LOCK001"
    title = "guarded attribute accessed without its lock"

    def run(self, module, ctx):
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                self._check_class(node, module, findings)
        return findings

    def _check_class(
        self, cls: ast.ClassDef, module: SourceModule, findings: list
    ) -> None:
        guarded = self._collect_guarded(cls, module)
        if not guarded:
            return
        for stmt in cls.body:
            if (
                isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name != "__init__"
            ):
                held = set()
                h = module.holds_lock(stmt)
                if h:
                    held.add(h)
                for sub in ast.iter_child_nodes(stmt):
                    self._visit(
                        sub, guarded, held, module, findings, stmt.name
                    )

    def _collect_guarded(
        self, cls: ast.ClassDef, module: SourceModule
    ) -> dict[str, str]:
        guarded: dict[str, str] = {}
        init = next(
            (
                s
                for s in cls.body
                if isinstance(s, ast.FunctionDef) and s.name == "__init__"
            ),
            None,
        )
        if init is None:
            return guarded
        for stmt in ast.walk(init):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            lock = module.guarded_by(stmt)
            if lock is None:
                continue
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    guarded[t.attr] = lock
        return guarded

    def _visit(
        self, node, guarded, held, module, findings, funcname
    ) -> None:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in guarded
            and guarded[node.attr] not in held
        ):
            lock = guarded[node.attr]
            findings.append(
                Finding(
                    self.rule, module.path, node.lineno,
                    f"'{node.attr}' is guarded by '{lock}' but accessed "
                    f"outside 'with self.{lock}' in '{funcname}'",
                    hint=f"wrap the access in 'with self.{lock}:', or "
                    f"annotate the function '# ktpu: holds({lock})' if "
                    "every caller already holds it",
                )
            )
            return
        if isinstance(node, ast.With):
            added = set()
            locks = set(guarded.values())
            for item in node.items:
                self._visit(
                    item.context_expr, guarded, held, module, findings,
                    funcname,
                )
                expr = ast.unparse(item.context_expr)
                for lock in locks:
                    if expr in (f"self.{lock}", lock):
                        added.add(lock)
            for sub in node.body:
                self._visit(
                    sub, guarded, held | added, module, findings, funcname
                )
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            h = module.holds_lock(node)
            inner = held | ({h} if h else set())
            for sub in ast.iter_child_nodes(node):
                self._visit(sub, guarded, inner, module, findings, node.name)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, guarded, held, module, findings, funcname)
