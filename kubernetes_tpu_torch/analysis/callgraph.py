"""Intra-module call graph + hot/device scope computation.

Scope rules (analysis/README.md §TPU001):

- *device roots*: the host functions that issue the card's launches,
  listed by ``(path, qualname)`` in registry.DEVICE_ROOTS (the port runs
  eagerly and has no ``jit`` to find them by; they are the counterparts
  of the JAX package's ``jax.jit`` roots). Every device-scope function
  also runs on the host once per launch, so a sync there costs one card
  round trip per step.
- *hot roots*: functions marked ``# ktpu: hot`` — host-side functions on
  the per-batch critical path (the pipelined apply path, the sanctioned
  device-read boundary, the ops the solver calls per step).
- Scope propagates through the intra-module call graph: plain-name calls
  to module-level functions and ``self.method(...)`` calls to methods of
  the same class. Nested ``def``\\ s inherit their parent's scope (a step
  body is part of the device computation).
- Propagation STOPS at functions marked ``# ktpu: cold`` (explicitly
  off-hot-path: error diagnosis, preemption aftermath) and at whitelisted
  sanctioned sync points (the audited device-read boundary).

The graph is intentionally intra-module and name-based: cross-module
calls (``nr.rtc_score``) are not followed — cover those modules with
their own device/hot roots. Precision over recall inside one file; the
fixture tests pin the exact contract.

Copied from ``kubernetes_tpu/analysis/callgraph.py``; device roots come
from the analysis context instead of ``jax.jit`` decorators.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import SourceModule


@dataclass
class FunctionInfo:
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: str | None  # enclosing class name, if a method
    parent: str | None  # enclosing function qualname, if nested
    calls: set = field(default_factory=set)  # callee qualnames (resolved)


class ModuleGraph:
    """Function index + call edges for one module."""

    def __init__(self, module: SourceModule):
        self.module = module
        self.functions: dict[str, FunctionInfo] = {}
        self._class_methods: dict[str, set] = {}
        self._module_level: set = set()
        self._hot_roots: set = set()
        self._build()

    # -- construction ------------------------------------------------------

    def _build(self) -> None:
        self._index(self.tree_body(), cls=None, parent=None)
        for info in self.functions.values():
            self._resolve_calls(info)
            if self.module.is_hot(info.node):
                self._hot_roots.add(info.qualname)

    def tree_body(self) -> list[ast.stmt]:
        return self.module.tree.body

    def _index(self, body, cls, parent) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{parent}.{stmt.name}" if parent else (
                    f"{cls}.{stmt.name}" if cls else stmt.name
                )
                info = FunctionInfo(qual, stmt, cls, parent)
                self.functions[qual] = info
                if cls and not parent:
                    self._class_methods.setdefault(cls, set()).add(stmt.name)
                if cls is None and parent is None:
                    self._module_level.add(stmt.name)
                self._index(stmt.body, cls=cls, parent=qual)
            elif isinstance(stmt, ast.ClassDef):
                self._index(stmt.body, cls=stmt.name, parent=None)
            elif isinstance(
                stmt,
                (
                    ast.If, ast.Try, ast.With, ast.For, ast.While,
                    ast.AsyncWith, ast.AsyncFor, ast.Match,
                    ast.ExceptHandler, ast.match_case,
                ),
            ):
                # descend through compound statements INCLUDING the
                # non-stmt containers (except handlers, match cases) so a
                # def inside an error-recovery path is still indexed
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, (ast.stmt, ast.ExceptHandler, ast.match_case)):
                        self._index([sub], cls=cls, parent=parent)

    def _resolve_calls(self, info: FunctionInfo) -> None:
        """Collect callee qualnames from this function's OWN statements
        (nested defs resolve their own calls)."""
        for node in own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                name = f.id
                # nested function in an enclosing FUNCTION scope wins,
                # then module level. The walk must stop BEFORE the class
                # prefix: a bare name inside a method never resolves to a
                # sibling method (that needs `self.`), and pairing it with
                # one would shadow a same-named module-level function
                # (a false negative)
                scope = info.qualname
                while scope and scope != info.cls:
                    cand = f"{scope}.{name}"
                    if cand in self.functions:
                        info.calls.add(cand)
                        break
                    scope = scope.rpartition(".")[0]
                else:
                    if name in self._module_level:
                        info.calls.add(name)
            elif (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and info.cls
                and f.attr in self._class_methods.get(info.cls, ())
            ):
                info.calls.add(f"{info.cls}.{f.attr}")

    # -- scope -------------------------------------------------------------

    def _expand(self, roots: set, barrier) -> set:
        """BFS through call edges + nested defs, stopping at barriers."""
        seen: set = set()
        work = [q for q in roots if not barrier(q)]
        while work:
            q = work.pop()
            if q in seen:
                continue
            seen.add(q)
            info = self.functions.get(q)
            if info is None:
                continue
            nxt = set(info.calls)
            # nested defs inherit the parent's scope
            for other, oinfo in self.functions.items():
                if oinfo.parent == q:
                    nxt.add(other)
            for callee in nxt:
                if callee not in seen and not barrier(callee):
                    work.append(callee)
        return seen

    def device_roots(self, ctx) -> set:
        return {
            q for q in self.functions
            if ctx.is_device_root(self.module.rel, q)
        }

    def scopes(self, ctx) -> tuple[set, set]:
        """(device, hot) qualname sets after propagation; whitelisted and
        cold functions are excluded (they are the barriers)."""

        def barrier(qual: str) -> bool:
            info = self.functions.get(qual)
            if info is None:
                return False
            if self.module.is_cold(info.node):
                return True
            return ctx.is_sanctioned(self.module.rel, qual)

        device = self._expand(self.device_roots(ctx), barrier)
        hot = self._expand(set(self._hot_roots), barrier)
        return device, hot


def scoped_graph(module: SourceModule, ctx) -> tuple["ModuleGraph", set, set]:
    """(graph, device, hot) for a module, memoized on the module object —
    graph construction and scope BFS are the analyzer's expensive steps
    and every scope-driven pass needs the same result."""
    cache = getattr(module, "_scope_cache", None)
    if cache is not None and cache[0] is ctx:
        return cache[1], cache[2], cache[3]
    graph = ModuleGraph(module)
    device, hot = graph.scopes(ctx)
    module._scope_cache = (ctx, graph, device, hot)
    return graph, device, hot


def own_nodes(func: ast.AST):
    """Walk a function's own statements, NOT descending into nested
    function/class definitions (those are separate scope entries)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
