"""LOCK002 — lock-order deadlock detection (project-wide).

Builds the *acquired-while-holding* graph over every lock the project
declares (``self.<attr> = threading.Lock()/RLock()/Condition()``): an
edge A→B means some code path acquires B while holding A — either a
lexically nested ``with``, or a call made under A to a function that
(transitively, through the cross-module call graph) acquires B. Two
findings fall out:

- a **cycle** among distinct locks (A→B and B→A reachable): two threads
  taking the locks in opposite orders can deadlock;
- a **self-acquisition** of a non-reentrant ``threading.Lock`` — a
  function called with the lock held takes it again and blocks forever
  (an RLock self-edge is reentrant and ignored).

``# ktpu: holds(expr)`` annotations participate: a function annotated
as running under ``self.cluster.lock`` contributes edges for the locks
it acquires inside. Unresolvable ``with`` subjects (e.g. a foreign
library's internal lock) contribute nothing — every edge comes from a
positive resolution.

When the graph is acyclic the proven total order is emitted as a
committed artifact (``analysis/LOCK_ORDER.md`` inside this package,
regenerated via ``python -m kubernetes_tpu_torch.analysis
--write-lock-order`` and pinned by
``--check-lock-order`` plus a tier-1 test).

Copied from ``kubernetes_tpu/analysis/passes/lockorder.py``; the
artifact is the port's own file (the JAX package's ``docs/LOCK_ORDER.md``
is never written).
"""

from __future__ import annotations

import ast

from ..core import AnalysisContext, Finding
from ..project import ProjectGraph, ProjectPass

_JITTER_NONE = frozenset()


class LockOrderAnalysis:
    """One full lock-order computation; shared by the pass (findings)
    and the artifact writer (markdown)."""

    def __init__(self, project: ProjectGraph):
        self.project = project
        self.locks = {}  # lock_id -> LockDecl
        self._attr_index: dict[str, list] = {}
        for key in sorted(project.classes):
            cinfo = project.classes[key]
            for attr in sorted(cinfo.locks):
                decl = cinfo.locks[attr]
                self.locks[decl.lock_id] = decl
                self._attr_index.setdefault(attr, []).append(decl)
        # (a, b) -> (rel, line, kind) — first (sorted) example site;
        # kind is "with" for a lexical nesting, "call" for an edge
        # discovered through the call graph
        self.edges: dict[tuple, tuple] = {}
        self.self_deadlocks: list = []  # (lock_id, rel, line, via)
        self._acq_direct: dict[tuple, set] = {}  # node -> {lock_id}
        self._held_calls: list = []  # (held tuple, call node ids, rel, line)
        self._walk_project()
        self._close_over_calls()

    # -- per-function lexical walk -----------------------------------------

    def _walk_project(self) -> None:
        p = self.project
        for rel in sorted(p.graphs):
            graph = p.graphs[rel]
            m = p.modules[rel]
            for qual in sorted(graph.functions):
                finfo = graph.functions[qual]
                env = p.local_env(rel, finfo)
                cinfo = (
                    p.classes.get((rel, finfo.cls)) if finfo.cls else None
                )
                held0: tuple = ()
                holds = m.holds_lock(finfo.node)
                if holds:
                    decl = self._resolve_holds(holds, rel, finfo, env, cinfo)
                    if decl is not None:
                        held0 = (decl.lock_id,)
                self._walk(
                    finfo.node.body, held0, rel, qual, finfo, env, cinfo
                )

    def _resolve_holds(self, text, rel, finfo, env, cinfo):
        """holds(cluster.lock) means self.cluster.lock (LOCK001 grammar)."""
        try:
            expr = ast.parse(f"self.{text.strip()}", mode="eval").body
        except SyntaxError:
            return None
        return self._resolve_lock(expr, rel, finfo, env, cinfo)

    def _resolve_lock(self, expr, rel, finfo, env, cinfo):
        if not isinstance(expr, ast.Attribute):
            return None
        types = self.project.expr_types(expr.value, rel, env, cinfo)
        for t in sorted(types):
            decl = self._lock_on_class(t, expr.attr)
            if decl is not None:
                return decl
        # a lock attribute name used by exactly ONE class project-wide
        # resolves even when the receiver cannot be typed ("cluster.lock"
        # on an unannotated local): precision holds because ambiguous
        # names stay unresolved
        decls = self._attr_index.get(expr.attr, ())
        if len(decls) == 1:
            return decls[0]
        return None

    def _lock_on_class(self, ctype, attr):
        seen, work = set(), [ctype]
        while work:
            cur = work.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            cinfo = self.project.classes.get(cur)
            if cinfo is None:
                continue
            if attr in cinfo.locks:
                return cinfo.locks[attr]
            work.extend(cinfo.bases)
        return None

    def _walk(self, stmts, held, rel, qual, finfo, env, cinfo) -> None:
        for stmt in stmts:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # nested defs are separate entries
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in stmt.items:
                    self._scan_calls(
                        item.context_expr, held, rel, qual, finfo, env
                    )
                    decl = self._resolve_lock(
                        item.context_expr, rel, finfo, env, cinfo
                    )
                    if decl is None:
                        continue
                    self._acquire(
                        decl, new_held, rel, qual, stmt.lineno
                    )
                    if decl.lock_id not in new_held:
                        new_held = new_held + (decl.lock_id,)
                self._walk(
                    stmt.body, new_held, rel, qual, finfo, env, cinfo
                )
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_calls(child, held, rel, qual, finfo, env)
                elif isinstance(child, ast.stmt):
                    self._walk(
                        [child], held, rel, qual, finfo, env, cinfo
                    )
                elif isinstance(child, (ast.ExceptHandler, ast.match_case)):
                    self._walk(
                        child.body, held, rel, qual, finfo, env, cinfo
                    )

    def _acquire(self, decl, held, rel, qual, line) -> None:
        self._acq_direct.setdefault((rel, qual), set()).add(decl.lock_id)
        if decl.lock_id in held:
            if not decl.reentrant:
                self.self_deadlocks.append(
                    (decl.lock_id, rel, line, "with")
                )
            return
        for h in held:
            self._note_edge(h, decl.lock_id, rel, line, "with")

    def _note_edge(self, a, b, rel, line, kind) -> None:
        site = (rel, line, kind)
        prev = self.edges.get((a, b))
        if prev is None or site[:2] < prev[:2]:
            self.edges[(a, b)] = site

    def _scan_calls(self, expr, held, rel, qual, finfo, env) -> None:
        if not held:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                targets = self.project.call_targets(rel, finfo, node, env)
                if targets:
                    self._held_calls.append(
                        (held, tuple(sorted(targets)), rel, node.lineno)
                    )

    # -- interprocedural closure -------------------------------------------

    def _close_over_calls(self) -> None:
        # acquires*(n): locks a call to n may take, transitively
        acq = {n: set(s) for n, s in self._acq_direct.items()}
        edges = self.project.edges
        changed = True
        while changed:
            changed = False
            for n in edges:
                cur = acq.get(n)
                add = set()
                for c in edges[n]:
                    add |= acq.get(c, _JITTER_NONE)
                if add and (cur is None or not add <= cur):
                    acq.setdefault(n, set()).update(add)
                    changed = True
        self.acquires_star = acq
        for held, targets, rel, line in self._held_calls:
            reach = set()
            for t in targets:
                reach |= acq.get(t, _JITTER_NONE)
            for h in held:
                for lock_id in reach:
                    if lock_id == h:
                        if not self.locks[lock_id].reentrant:
                            self.self_deadlocks.append(
                                (lock_id, rel, line, "call")
                            )
                        continue
                    self._note_edge(h, lock_id, rel, line, "call")

    # -- cycles + order ----------------------------------------------------

    def cycles(self) -> list:
        """Strongly connected components with more than one lock, as
        sorted lock-id tuples (deterministic)."""
        graph: dict[str, set] = {k: set() for k in self.locks}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set = set()
        stack: list = []
        out: list = []
        counter = [0]

        def strongconnect(v):  # iterative Tarjan
            work = [(v, iter(sorted(graph.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph.get(w, ())))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        out.append(tuple(sorted(comp)))

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        return sorted(out)

    def order(self) -> list:
        """Deterministic topological order (Kahn, sorted ties) over ALL
        declared locks; meaningful only when cycles() is empty."""
        indeg = {k: 0 for k in self.locks}
        succ: dict[str, set] = {k: set() for k in self.locks}
        for (a, b) in self.edges:
            if b not in succ.get(a, set()):
                succ.setdefault(a, set()).add(b)
                indeg[b] = indeg.get(b, 0) + 1
        ready = sorted(k for k, d in indeg.items() if d == 0)
        out = []
        while ready:
            cur = ready.pop(0)
            out.append(cur)
            for nxt in sorted(succ.get(cur, ())):
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    ready.append(nxt)
            ready.sort()
        return out


def get_analysis(project: ProjectGraph) -> LockOrderAnalysis:
    """Memoized on the project — the pass and the artifact writer run
    in the same CLI invocation and the walk is the expensive part."""
    cached = getattr(project, "_lock_order_cache", None)
    if cached is None:
        cached = LockOrderAnalysis(project)
        project._lock_order_cache = cached
    return cached


class LockOrderPass(ProjectPass):
    rule = "LOCK002"
    title = "lock-order deadlock detection"

    def run_project(
        self, project: ProjectGraph, ctx: AnalysisContext
    ) -> list:
        analysis = get_analysis(project)
        findings: list[Finding] = []
        for lock_id, rel, line, via in sorted(
            set(analysis.self_deadlocks)
        ):
            decl = analysis.locks[lock_id]
            how = (
                "re-enters it with a nested 'with'"
                if via == "with"
                else "calls a function that re-acquires it"
            )
            findings.append(
                Finding(
                    rule=self.rule,
                    path=project.modules[rel].path,
                    line=line,
                    message=(
                        f"non-reentrant lock '{lock_id}' ({decl.kind}) is "
                        f"already held here and this {how} — guaranteed "
                        "self-deadlock"
                    ),
                    hint=(
                        "hoist the inner acquisition out, add a _locked "
                        "variant of the callee, or make the lock an RLock "
                        "as a design decision"
                    ),
                )
            )
        for comp in analysis.cycles():
            # one example edge per hop, for an actionable message
            hops = []
            ordered = list(comp) + [comp[0]]
            for a, b in zip(ordered, ordered[1:]):
                site = analysis.edges.get((a, b))
                where = f" ({site[0]}:{site[1]})" if site else ""
                hops.append(f"{a} -> {b}{where}")
            anchor = min(
                (
                    analysis.edges[(a, b)]
                    for (a, b) in analysis.edges
                    if a in comp and b in comp
                ),
                default=("", 1, ""),
            )
            rel = anchor[0] or next(iter(sorted(project.modules)))
            findings.append(
                Finding(
                    rule=self.rule,
                    path=project.modules[rel].path,
                    line=anchor[1],
                    message=(
                        "lock-order cycle (potential deadlock): "
                        + "; ".join(hops)
                    ),
                    hint=(
                        "pick one global order (docs/LOCK_ORDER.md) and "
                        "restructure the later acquisition to happen "
                        "outside the held region"
                    ),
                )
            )
        return findings


def lock_order_markdown(project: ProjectGraph) -> str:
    """The committed artifact: every declared lock in its proven
    acquisition order, plus the observed acquired-while-holding edges
    with one example site each."""
    analysis = get_analysis(project)
    cycles = analysis.cycles()
    lines = [
        "# Lock acquisition order",
        "",
        "Generated by `python -m kubernetes_tpu_torch.analysis "
        "--write-lock-order`; CI re-derives it and fails on drift "
        "(`--check-lock-order`). Acquire locks strictly in the order "
        "below — LOCK002 proves the observed acquired-while-holding "
        "graph is cycle-free against this file.",
        "",
        "## Order",
        "",
        "| # | lock | kind | declared at |",
        "|---|------|------|-------------|",
    ]
    if cycles:
        lines.append("")
        lines.append(
            "**CYCLE DETECTED** — no valid order exists: "
            + "; ".join(" <-> ".join(c) for c in cycles)
        )
    else:
        for i, lock_id in enumerate(analysis.order(), 1):
            d = analysis.locks[lock_id]
            lines.append(
                f"| {i} | `{lock_id}` | {d.kind} | `{d.rel}:{d.line}` |"
            )
    lines += [
        "",
        "## Observed acquired-while-holding edges",
        "",
        "| held | then acquired | example site |",
        "|------|---------------|--------------|",
    ]
    for (a, b) in sorted(analysis.edges):
        rel, line, kind = analysis.edges[(a, b)]
        lines.append(
            f"| `{a}` | `{b}` | `{rel}:{line}` ({kind}) |"
        )
    lines.append("")
    return "\n".join(lines)
