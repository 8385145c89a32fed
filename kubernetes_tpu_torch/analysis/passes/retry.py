"""RETRY001 — retry discipline at RPC call sites (project-wide).

The fleet tier's contract (server/bulk.py + fleet/runtime.py):

- transport faults (``UNAVAILABLE``-class, ``ExchangeUnreachable``)
  are retried with **bounded attempts and full-jitter exponential
  backoff** (``rng.uniform(0, base * 2**attempt)`` before the next
  try) — a fleet of replicas retrying in lockstep against a recovering
  hub is a self-inflicted outage;
- **semantic rejections are never retried**: ``AdmitConflict`` means
  the admission CAS lost — the row changed, and replaying the same
  request can double-place a pod. It must propagate to the conflict
  re-solve path, not sit inside a retry loop.

What counts as a *retry loop* (fixture-pinned, deliberately narrow so
work-drain loops like ``while self._sealed:`` stay out of scope):

- ``for <v> in range(...)`` — the bounded-attempts idiom — or an
  unconditional ``while True:`` loop,
- containing a ``try`` whose handler *swallows* the exception (its
  body does not end in ``raise``/``return``/``break``), letting the
  loop try again.

For such loops two rules fire:

- **RETRY001/non-retryable**: a swallowing handler that names a type
  in ``AnalysisContext.non_retryable_errors`` (default
  ``AdmitConflict``). Handlers that re-raise are fine — that is the
  documented failover idiom.
- **RETRY001/backoff**: no full-jitter backoff anywhere in the loop —
  neither an inline ``sleep(...uniform(...))`` (sync or awaited) nor a
  call resolving, through the cross-module call graph, to a helper
  that performs one.

Copied from ``kubernetes_tpu/analysis/passes/retry.py``.
"""

from __future__ import annotations

import ast

from ..callgraph import own_nodes
from ..core import AnalysisContext, Finding
from ..project import ProjectGraph, ProjectPass

_JITTER_SOURCES = {"uniform", "random", "triangular", "betavariate"}


def _is_sleep_call(node: ast.Call) -> bool:
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "sleep") or (
        isinstance(f, ast.Name) and f.id == "sleep"
    )


def _has_jitter_arg(node: ast.Call) -> bool:
    for arg in list(node.args) + [kw.value for kw in node.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Call):
                f = sub.func
                name = (
                    f.attr
                    if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else ""
                )
                if name in _JITTER_SOURCES:
                    return True
    return False


def _jittered_sleep_direct(fnode) -> bool:
    for node in own_nodes(fnode):
        if (
            isinstance(node, ast.Call)
            and _is_sleep_call(node)
            and _has_jitter_arg(node)
        ):
            return True
    return False


def _exception_names(type_expr) -> set:
    """Names caught by an except clause (Name, dotted, or tuple)."""
    if type_expr is None:
        return set()
    items = (
        list(type_expr.elts)
        if isinstance(type_expr, ast.Tuple)
        else [type_expr]
    )
    out = set()
    for item in items:
        if isinstance(item, ast.Name):
            out.add(item.id)
        elif isinstance(item, ast.Attribute):
            out.add(item.attr)
    return out


def _swallows(handler: ast.ExceptHandler) -> bool:
    """The handler lets the loop continue to another attempt."""
    if not handler.body:
        return True
    last = handler.body[-1]
    return not isinstance(last, (ast.Raise, ast.Return, ast.Break))


class RetryPass(ProjectPass):
    rule = "RETRY001"
    title = "retry discipline (typed errors, full-jitter backoff)"

    def run_project(
        self, project: ProjectGraph, ctx: AnalysisContext
    ) -> list:
        direct = {
            node_id
            for node_id in project.all_nodes()
            if _jittered_sleep_direct(project.function(node_id).node)
        }
        # nodes from which a jittered sleep is reachable: a loop calling
        # self._backoff(attempt) is properly backed off
        jittery = project.reaches(direct) if direct else set()

        findings: list[Finding] = []
        for rel in sorted(project.graphs):
            graph = project.graphs[rel]
            m = project.modules[rel]
            for qual in sorted(graph.functions):
                finfo = graph.functions[qual]
                self._scan(
                    finfo.node.body,
                    m,
                    rel,
                    finfo,
                    project,
                    jittery,
                    ctx,
                    findings,
                )
        return findings

    # -- loop discovery ----------------------------------------------------

    def _scan(
        self, stmts, m, rel, finfo, project, jittery, ctx, findings
    ) -> None:
        for stmt in stmts:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(stmt, (ast.For, ast.While)) and _retry_shape(stmt):
                self._check_loop(
                    stmt, m, rel, finfo, project, jittery, ctx, findings
                )
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    self._scan(
                        [child], m, rel, finfo, project, jittery, ctx,
                        findings,
                    )
                elif isinstance(child, (ast.ExceptHandler, ast.match_case)):
                    self._scan(
                        child.body, m, rel, finfo, project, jittery, ctx,
                        findings,
                    )

    def _check_loop(
        self, loop, m, rel, finfo, project, jittery, ctx, findings
    ) -> None:
        swallowing = [
            h
            for t in _tries_in(loop.body)
            for h in t.handlers
            if _swallows(h)
        ]
        if not swallowing:
            return
        bad = set(ctx.non_retryable_errors)
        for h in swallowing:
            caught = _exception_names(h.type) & bad
            for name in sorted(caught):
                findings.append(
                    Finding(
                        rule=self.rule,
                        path=m.path,
                        line=h.lineno,
                        message=(
                            f"non-retryable '{name}' is swallowed inside "
                            "a retry loop — a semantic rejection must "
                            "not be replayed"
                        ),
                        hint=(
                            "re-raise it (the failover idiom: 'except "
                            f"{name}: raise') and let the conflict "
                            "re-solve path handle it"
                        ),
                    )
                )
        if not self._loop_has_backoff(loop, rel, finfo, project, jittery):
            findings.append(
                Finding(
                    rule=self.rule,
                    path=m.path,
                    line=loop.lineno,
                    message=(
                        "retry loop has no full-jitter backoff — "
                        "synchronized retries stampede a recovering "
                        "endpoint"
                    ),
                    hint=(
                        "sleep rng.uniform(0, base * 2**attempt) before "
                        "the next try (see RemoteOccupancyExchange._op), "
                        "or route through a helper that does"
                    ),
                )
            )

    def _loop_has_backoff(
        self, loop, rel, finfo, project, jittery
    ) -> bool:
        env = None
        for node in _walk_no_defs(loop.body):
            if not isinstance(node, ast.Call):
                continue
            if _is_sleep_call(node) and _has_jitter_arg(node):
                return True
            if jittery:
                if env is None:
                    env = project.local_env(rel, finfo)
                if project.call_targets(rel, finfo, node, env) & jittery:
                    return True
        return False


def _retry_shape(loop) -> bool:
    if isinstance(loop, ast.For):
        it = loop.iter
        return (
            isinstance(it, ast.Call)
            and (
                (isinstance(it.func, ast.Name) and it.func.id == "range")
                or (
                    isinstance(it.func, ast.Attribute)
                    and it.func.attr == "range"
                )
            )
        )
    if isinstance(loop, ast.While):
        t = loop.test
        return isinstance(t, ast.Constant) and bool(t.value)
    return False


def _tries_in(stmts) -> list:
    """Try statements within a loop body, not crossing into nested
    loops (their retries are judged on their own) or nested defs."""
    out = []
    for stmt in stmts:
        if isinstance(
            stmt,
            (
                ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.For, ast.AsyncFor, ast.While,
            ),
        ):
            continue
        if isinstance(stmt, ast.Try):
            out.append(stmt)
            out.extend(_tries_in(stmt.body))
            # the else/finally blocks run in the loop too
            out.extend(_tries_in(stmt.orelse))
            out.extend(_tries_in(stmt.finalbody))
            continue
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                out.extend(_tries_in([child]))
            elif isinstance(child, (ast.ExceptHandler, ast.match_case)):
                out.extend(_tries_in(child.body))
    return out


def _walk_no_defs(stmts):
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
