"""Project-wide symbol table and cross-module call graph.

The :mod:`callgraph` is deliberately intra-module: a bare-name call
resolves inside one file and ``nr.rtc_score(...)`` is not followed.
That was the right precision/recall trade for TPU001's per-file scope,
but it is structurally blind to the fleet tier's bug classes —
lock-order inversions that span ``state/cluster.py`` and
``fleet/occupancy.py``, fence checks hidden behind a helper in another
file, and a ``# ktpu: hot`` function calling a cross-module helper that
blocks on the device.

:class:`ProjectGraph` closes the gap. It is still name-based and
best-effort (stdlib-only, no type checker), but it resolves:

- ``import a.b as m`` / ``from .mod import sym`` bindings, anywhere in
  the file (this codebase imports inside ``__init__`` bodies on
  purpose) — including relative imports, resolved against the module's
  package path;
- constructor calls ``C(...)`` to ``C.__init__`` across modules;
- attribute types: ``self.x = ClusterState(...)``, ``self.x = param``
  with an annotated param, annotated params themselves, and
  module-level singletons (``WATCHER = CompileWatcher()``), so
  ``self.cluster.lock`` and ``self.exchange.stage(...)`` resolve to the
  owning class — when an attribute is assigned conditionally with two
  types (``RemoteOccupancyExchange`` | ``OccupancyExchange``) BOTH are
  kept and analyses union over the candidates;
- method lookup through project-local base classes.

Unresolvable receivers stay unresolved — passes treat "unknown" as
"no edge", never as an error, so precision is preserved: a LOCK002
edge or a FENCE001 "fence reached" verdict only ever comes from a
positive resolution.

Node identity is ``(module.rel, qualname)``; helpers below expose the
global scope BFS (TPU004), reverse reachability (FENCE001), and the
transitive "may acquire" closure (LOCK002).

Copied from ``kubernetes_tpu/analysis/project.py``; the global scope
starts from the port's device roots instead of ``jax.jit`` roots.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .callgraph import ModuleGraph, own_nodes, scoped_graph
from .core import AnalysisContext, SourceModule

# lock constructors recognized for LOCK002 lock-identity registration
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}


@dataclass
class LockDecl:
    """One lock attribute: ``self.<attr> = threading.Lock()`` in a class
    body (any method, in practice ``__init__``)."""

    lock_id: str  # "<rel>::<Class>.<attr>"
    cls: str
    attr: str
    kind: str  # "Lock" | "RLock" | "Condition"
    rel: str
    line: int

    @property
    def reentrant(self) -> bool:
        return self.kind == "RLock"


@dataclass
class ClassInfo:
    name: str
    rel: str
    node: ast.ClassDef
    methods: set = field(default_factory=set)
    bases: list = field(default_factory=list)  # resolved (rel, name) pairs
    # attr -> set of candidate (rel, class) types
    attr_types: dict = field(default_factory=dict)
    # attr -> LockDecl
    locks: dict = field(default_factory=dict)
    # attr -> line of the `# ktpu: replicated` registration
    replicated: dict = field(default_factory=dict)


def module_name(rel: str) -> str:
    """Dotted module name for a package-relative path; bare fixture
    filenames ("a.py") become plain names ("a")."""
    name = rel[:-3] if rel.endswith(".py") else rel
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


class ProjectGraph:
    """All modules of one analysis run, cross-linked."""

    def __init__(self, modules, ctx: AnalysisContext):
        self.ctx = ctx
        self.modules: dict[str, SourceModule] = {}
        self.graphs: dict[str, ModuleGraph] = {}
        self._intra_scopes: dict[str, tuple[set, set]] = {}
        for m in modules:
            if m.rel in self.modules:  # duplicate path on the CLI
                continue
            self.modules[m.rel] = m
            graph, device, hot = scoped_graph(m, ctx)
            self.graphs[m.rel] = graph
            self._intra_scopes[m.rel] = (device, hot)
        self._by_name = {module_name(rel): rel for rel in self.modules}
        # (rel, class name) -> ClassInfo ; class name -> [ClassInfo]
        self.classes: dict[tuple, ClassInfo] = {}
        self._imports: dict[str, dict] = {}  # rel -> local name -> binding
        self._module_vars: dict[str, dict] = {}  # rel -> var -> type set
        self.edges: dict[tuple, set] = {}  # (rel, qual) -> {(rel, qual)}
        self._collect_classes()
        self._collect_imports()
        self._collect_module_vars()
        self._infer_attr_types()
        self._resolve_bases()
        self._build_edges()

    # -- symbol collection -------------------------------------------------

    def _collect_classes(self) -> None:
        for rel, m in self.modules.items():
            for stmt in m.tree.body:
                if isinstance(stmt, ast.ClassDef):
                    info = ClassInfo(name=stmt.name, rel=rel, node=stmt)
                    graph = self.graphs[rel]
                    info.methods = set(
                        graph._class_methods.get(stmt.name, set())
                    )
                    self.classes[(rel, stmt.name)] = info
        self._classes_by_name: dict[str, list] = {}
        for (rel, name), info in self.classes.items():
            self._classes_by_name.setdefault(name, []).append(info)

    def _resolve_module(self, dotted: str, from_rel: str, level: int) -> str | None:
        """Dotted module name (possibly relative) -> rel path of a module
        in this project, or None."""
        if level:
            base = module_name(from_rel).split(".")
            if not from_rel.endswith("/__init__.py"):
                base = base[:-1]  # strip the module leaf -> its package
            up = level - 1  # level 1 = current package
            base = base[: len(base) - up] if up <= len(base) else []
            dotted = ".".join(base + ([dotted] if dotted else []))
        cand = self._by_name.get(dotted)
        return cand

    def _collect_imports(self) -> None:
        for rel, m in self.modules.items():
            table: dict[str, tuple] = {}
            for node in ast.walk(m.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        target = self._resolve_module(alias.name, rel, 0)
                        if target:
                            local = alias.asname or alias.name.split(".")[0]
                            # "import a.b" binds "a"; only alias form gives
                            # a direct handle on the leaf module
                            if alias.asname or "." not in alias.name:
                                table[local] = ("module", target, None)
                elif isinstance(node, ast.ImportFrom):
                    target = self._resolve_module(
                        node.module or "", rel, node.level
                    )
                    for alias in node.names:
                        local = alias.asname or alias.name
                        if target is None:
                            continue
                        sub = self._resolve_module(
                            (node.module or "") + "." + alias.name
                            if node.module
                            else alias.name,
                            rel,
                            node.level,
                        )
                        if sub is not None:
                            # "from . import occupancy" — a module binding
                            table[local] = ("module", sub, None)
                        else:
                            table[local] = ("symbol", target, alias.name)
            self._imports[rel] = table

    def _collect_module_vars(self) -> None:
        """Module-level singleton types: ``WATCHER = CompileWatcher()``."""
        for rel, m in self.modules.items():
            env: dict[str, frozenset] = {}
            for stmt in m.tree.body:
                if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Call
                ):
                    types = self._type_of_ctor(stmt.value.func, rel)
                    if types:
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                env[t.id] = types
            self._module_vars[rel] = env

    # -- type resolution ---------------------------------------------------

    def resolve_symbol(self, name: str, rel: str):
        """A bare name in module `rel` -> ("class", ClassInfo) |
        ("function", (rel, qual)) | ("module", rel) | None."""
        if (rel, name) in self.classes:
            return ("class", self.classes[(rel, name)])
        graph = self.graphs.get(rel)
        if graph is not None and name in graph._module_level:
            return ("function", (rel, name))
        binding = self._imports.get(rel, {}).get(name)
        if binding is None:
            return None
        kind, target, sym = binding
        if kind == "module":
            return ("module", target)
        if (target, sym) in self.classes:
            return ("class", self.classes[(target, sym)])
        tgraph = self.graphs.get(target)
        if tgraph is not None and sym in tgraph._module_level:
            return ("function", (target, sym))
        types = self._module_vars.get(target, {}).get(sym)
        if types:
            # imported singleton: treat the name as a value of that type
            return ("value", types)
        return None

    def _type_of_ctor(self, func: ast.expr, rel: str) -> frozenset:
        """Types produced by calling `func` as a constructor."""
        if isinstance(func, ast.Name):
            got = self.resolve_symbol(func.id, rel)
            if got and got[0] == "class":
                return frozenset({(got[1].rel, got[1].name)})
        elif isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            got = self.resolve_symbol(func.value.id, rel)
            if got and got[0] == "module":
                target = got[1]
                if (target, func.attr) in self.classes:
                    return frozenset({(target, func.attr)})
        return frozenset()

    def _type_of_annotation(self, ann: ast.expr, rel: str) -> frozenset:
        """Best-effort class types named by an annotation; unwraps
        ``X | None`` and ``Optional[X]``."""
        if ann is None:
            return frozenset()
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return self._type_of_annotation(
                ann.left, rel
            ) | self._type_of_annotation(ann.right, rel)
        if isinstance(ann, ast.Subscript):
            return self._type_of_annotation(ann.slice, rel)
        if isinstance(ann, ast.Constant):
            if isinstance(ann.value, str):
                try:
                    return self._type_of_annotation(
                        ast.parse(ann.value, mode="eval").body, rel
                    )
                except SyntaxError:
                    return frozenset()
            return frozenset()
        return self._type_of_ctor(ann, rel)

    def _param_types(self, fnode, rel: str) -> dict:
        env: dict[str, frozenset] = {}
        a = fnode.args
        for arg in (
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
        ):
            types = self._type_of_annotation(arg.annotation, rel)
            if types:
                env[arg.arg] = types
        return env

    def _infer_attr_types(self) -> None:
        """``self.x = <ctor>`` / ``self.x = <annotated param>`` inside any
        method registers candidate types (and lock declarations) for the
        enclosing class; ``# ktpu: replicated`` trailing the assignment
        registers replicated state (FENCE001)."""
        for (rel, cname), cinfo in self.classes.items():
            m = self.modules[rel]
            graph = self.graphs[rel]
            for qual, finfo in graph.functions.items():
                if finfo.cls != cname or finfo.parent:
                    continue
                env = self._param_types(finfo.node, rel)
                for node in own_nodes(finfo.node):
                    # `self.x = ...` and `self.x: T = ...` both register
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, ast.AnnAssign) and node.value:
                        targets = [node.target]
                    else:
                        continue
                    for t in targets:
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        if isinstance(node.value, ast.Call):
                            lk = _lock_kind(node.value.func)
                            if lk:
                                cinfo.locks[t.attr] = LockDecl(
                                    lock_id=f"{rel}::{cname}.{t.attr}",
                                    cls=cname,
                                    attr=t.attr,
                                    kind=lk,
                                    rel=rel,
                                    line=node.lineno,
                                )
                                continue
                            types = self._type_of_ctor(node.value.func, rel)
                        elif isinstance(node.value, ast.Name):
                            types = env.get(node.value.id, frozenset())
                        else:
                            types = frozenset()
                        if isinstance(node, ast.AnnAssign):
                            types = types | self._type_of_annotation(
                                node.annotation, rel
                            )
                        if types:
                            cinfo.attr_types[t.attr] = (
                                cinfo.attr_types.get(t.attr, frozenset())
                                | types
                            )
                        if m.replicated_mark(node):
                            cinfo.replicated[t.attr] = node.lineno
                # annotated attribute declarations in the class body also
                # count (dataclass-style)
            for stmt in cinfo.node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    types = self._type_of_annotation(stmt.annotation, rel)
                    if types:
                        cinfo.attr_types[stmt.target.id] = (
                            cinfo.attr_types.get(stmt.target.id, frozenset())
                            | types
                        )

    def _resolve_bases(self) -> None:
        for (rel, _), cinfo in self.classes.items():
            for b in cinfo.node.bases:
                types = self._type_of_ctor(b, rel)
                cinfo.bases.extend(sorted(types))

    def lookup_method(self, ctype: tuple, name: str) -> tuple | None:
        """(rel, "Cls.meth") for a method on class `ctype` or a
        project-local base."""
        seen = set()
        work = [ctype]
        while work:
            cur = work.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            cinfo = self.classes.get(cur)
            if cinfo is None:
                continue
            if name in cinfo.methods:
                return (cinfo.rel, f"{cinfo.name}.{name}")
            work.extend(cinfo.bases)
        return None

    # -- value typing inside one function ----------------------------------

    def local_env(self, rel: str, finfo) -> dict:
        """name -> candidate types for params and simple locals."""
        env = dict(self._param_types(finfo.node, rel))
        cinfo = self.classes.get((rel, finfo.cls)) if finfo.cls else None
        if cinfo is not None:
            env.setdefault("self", frozenset({(cinfo.rel, cinfo.name)}))
        for node in own_nodes(finfo.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if not isinstance(t, ast.Name):
                    continue
                types = self.expr_types(node.value, rel, env, cinfo)
                if types:
                    env[t.id] = env.get(t.id, frozenset()) | types
        return env

    def expr_types(self, expr, rel: str, env: dict, cinfo) -> frozenset:
        """Candidate class types of a value expression (best effort)."""
        if isinstance(expr, ast.Name):
            if expr.id in env:
                return env[expr.id]
            got = self.resolve_symbol(expr.id, rel)
            if got and got[0] == "value":
                return got[1]
            return self._module_vars.get(rel, {}).get(expr.id, frozenset())
        if isinstance(expr, ast.Call):
            return self._type_of_ctor(expr.func, rel)
        if isinstance(expr, ast.Attribute):
            base = self.expr_types(expr.value, rel, env, cinfo)
            if (
                not base
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and cinfo is not None
            ):
                base = frozenset({(cinfo.rel, cinfo.name)})
            out = frozenset()
            for bt in base:
                binfo = self.classes.get(bt)
                if binfo:
                    out |= binfo.attr_types.get(expr.attr, frozenset())
            return out
        return frozenset()

    # -- edges -------------------------------------------------------------

    def _build_edges(self) -> None:
        for rel, graph in self.graphs.items():
            for qual, finfo in graph.functions.items():
                node_id = (rel, qual)
                out = self.edges.setdefault(node_id, set())
                # nested defs inherit the parent's scope
                for oq, oinfo in graph.functions.items():
                    if oinfo.parent == qual:
                        out.add((rel, oq))
                env = None  # built lazily: most functions are call-light
                for node in own_nodes(finfo.node):
                    if not isinstance(node, ast.Call):
                        continue
                    if env is None:
                        env = self.local_env(rel, finfo)
                    out |= self.call_targets(rel, finfo, node, env)

    def call_targets(self, rel: str, finfo, call: ast.Call, env=None) -> set:
        """Node ids one ast.Call may dispatch to. Supersedes the
        intra-module resolution in :class:`ModuleGraph` (same bare-name
        and ``self.method`` rules) and adds the cross-module cases."""
        out: set = set()
        f = call.func
        graph = self.graphs[rel]
        cinfo = self.classes.get((rel, finfo.cls)) if finfo.cls else None
        if isinstance(f, ast.Name):
            # nested function in an enclosing FUNCTION scope wins, then
            # module level / imports — never a sibling method (needs
            # `self.`), mirroring ModuleGraph._resolve_calls
            scope = finfo.qualname
            while scope and scope != finfo.cls:
                cand = f"{scope}.{f.id}"
                if cand in graph.functions:
                    out.add((rel, cand))
                    return out
                scope = scope.rpartition(".")[0]
            got = self.resolve_symbol(f.id, rel)
            if got is None:
                return out
            if got[0] == "function":
                out.add(got[1])
            elif got[0] == "class":
                init = self.lookup_method((got[1].rel, got[1].name), "__init__")
                if init:
                    out.add(init)
            return out
        if not isinstance(f, ast.Attribute):
            return out
        if isinstance(f.value, ast.Name):
            if f.value.id == "self" and finfo.cls:
                hit = self.lookup_method((rel, finfo.cls), f.attr)
                if hit:
                    out.add(hit)
                return out
            got = self.resolve_symbol(f.value.id, rel)
            if got and got[0] == "module":
                target = got[1]
                tgraph = self.graphs.get(target)
                if tgraph and f.attr in tgraph._module_level:
                    out.add((target, f.attr))
                elif (target, f.attr) in self.classes:
                    init = self.lookup_method((target, f.attr), "__init__")
                    if init:
                        out.add(init)
                return out
        # value.method(...): type the receiver
        if env is None:
            env = self.local_env(rel, finfo)
        types = self.expr_types(f.value, rel, env, cinfo)
        for t in sorted(types):
            hit = self.lookup_method(t, f.attr)
            if hit:
                out.add(hit)
        return out

    # -- reachability helpers ----------------------------------------------

    def function(self, node_id: tuple):
        graph = self.graphs.get(node_id[0])
        return graph.functions.get(node_id[1]) if graph else None

    def all_nodes(self):
        for rel, graph in self.graphs.items():
            for qual in graph.functions:
                yield (rel, qual)

    def _barrier(self, node_id: tuple) -> bool:
        rel, qual = node_id
        m = self.modules.get(rel)
        info = self.function(node_id)
        if m is None or info is None:
            return False
        if m.is_cold(info.node):
            return True
        return self.ctx.is_sanctioned(m.rel, qual)

    def global_scopes(self) -> tuple[set, set, dict]:
        """(device, hot, via) over the PROJECT graph. `via[node]` is the
        predecessor on one shortest root path — for explainable findings
        ("reached from hot root X via Y")."""
        device_roots, hot_roots = set(), set()
        for rel, graph in self.graphs.items():
            device_roots |= {(rel, q) for q in graph.device_roots(self.ctx)}
            hot_roots |= {(rel, q) for q in graph._hot_roots}
        via: dict = {}
        device = self._bfs(device_roots, via)
        hot = self._bfs(hot_roots, via)
        return device, hot, via

    def _bfs(self, roots: set, via: dict) -> set:
        seen: set = set()
        work = sorted(r for r in roots if not self._barrier(r))
        while work:
            cur = work.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in sorted(self.edges.get(cur, ())):
                if nxt not in seen and not self._barrier(nxt):
                    via.setdefault(nxt, cur)
                    work.append(nxt)
        return seen

    def intra_scopes(self, rel: str) -> tuple[set, set]:
        return self._intra_scopes.get(rel, (set(), set()))

    def reaches(self, targets: set) -> set:
        """All nodes from which some node in `targets` is reachable
        (including the targets themselves) — reverse closure."""
        rev: dict[tuple, set] = {}
        for src, outs in self.edges.items():
            for dst in outs:
                rev.setdefault(dst, set()).add(src)
        seen = set()
        work = sorted(targets)
        while work:
            cur = work.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            work.extend(sorted(rev.get(cur, set()) - seen))
        return seen

    def root_chain(self, node_id: tuple, via: dict, limit: int = 6) -> list:
        """Root-to-node qualname chain for messages."""
        chain = [node_id]
        while node_id in via and len(chain) < limit:
            node_id = via[node_id]
            chain.append(node_id)
        chain.reverse()
        return chain


def _lock_kind(func: ast.expr) -> str | None:
    """threading.Lock / threading.RLock / threading.Condition ctor?"""
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.value.id == "threading" and func.attr in _LOCK_FACTORIES:
            return func.attr
    if isinstance(func, ast.Name) and func.id in _LOCK_FACTORIES:
        return func.id
    return None


class ProjectPass:
    """Base for passes that need the whole project: one run per
    analysis invocation, findings anchored to individual modules."""

    rule = "KTPU998"
    title = ""

    def run_project(
        self, project: ProjectGraph, ctx: AnalysisContext
    ) -> list:
        raise NotImplementedError


def build_project(modules, ctx: AnalysisContext) -> ProjectGraph:
    return ProjectGraph(modules, ctx)
