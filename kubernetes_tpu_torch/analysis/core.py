"""Pass framework for the host-sync / lock-discipline analyzer of the
port (``kubernetes_tpu_torch``).

Self-contained stdlib-only AST analysis (no third-party linter
dependencies). A :class:`SourceModule` pairs the parsed tree
with the comment stream (``ast`` drops comments, so annotations like
``# ktpu: hot`` are recovered from ``tokenize``); passes walk the tree
and emit :class:`Finding`\\ s; the runner applies inline suppressions
(``# ktpu: ignore[RULE]: reason``) afterwards so suppressed findings
stay visible in ``--json`` output for auditing.

Annotation grammar (shared by all passes; see analysis/README.md):

- ``# ktpu: ignore[RULE]: reason``  — suppress RULE on this line or the
  line below. The reason is REQUIRED; a reasonless ignore is itself a
  finding (KTPU000).
- ``# ktpu: hot``         — register the function below/beside as a
  hot-path root for TPU001 (host-sync) scope propagation.
- ``# ktpu: cold``        — mark an error/diagnosis path: stops hot/device
  scope propagation into this function.
- ``# ktpu: holds(expr)`` — the function below/beside runs with
  ``self.<expr>`` held by every caller (LOCK001, LOCK002).
- ``# ktpu: guarded-by(expr)`` — trailing an attribute assignment in
  ``__init__``: registers the attribute as guarded by ``self.<expr>``.
- ``# ktpu: replicated`` — trailing an attribute assignment in
  ``__init__``: the attribute is hub-replicated state; FENCE001
  requires every method touching it to run a fence check first.
- ``# ktpu: fence-check`` — the function below/beside IS the role/
  epoch fence check; reaching it (directly or through helpers)
  satisfies FENCE001.
- ``# ktpu: fence-exempt(reason)`` — the function below/beside
  deliberately skips the fence (replication path, harness bypass…).
  The reason is REQUIRED; a reasonless exemption is a finding.
- ``# ktpu: fenced-by-caller`` — private helper whose callers have
  already run the fence checks (the ``_locked`` suffix convention).

Copied from ``kubernetes_tpu/analysis/core.py``; paths key on the
``kubernetes_tpu_torch`` package, and the context carries the port's
device roots (registry.DEVICE_ROOTS) in place of ``jax.jit`` roots.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

# the package whose files the analyzer keys paths on
PACKAGE = "kubernetes_tpu_torch"

# ignore is a directive and must lead the comment; the function/attribute
# marks may trail prose ("... always holds it: ktpu: holds(cluster.lock)")
_IGNORE_RE = re.compile(
    r"#\s*ktpu:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*:?\s*(.*)"
)
_HOT_RE = re.compile(r"#.*\bktpu:\s*hot\b")
_COLD_RE = re.compile(r"#.*\bktpu:\s*cold\b")
_HOLDS_RE = re.compile(r"#.*\bktpu:\s*holds\(([^)]+)\)")
_GUARDED_RE = re.compile(r"#.*\bktpu:\s*guarded-by\(([^)]+)\)")
_REPLICATED_RE = re.compile(r"#.*\bktpu:\s*replicated\b")
_FENCE_CHECK_RE = re.compile(r"#.*\bktpu:\s*fence-check\b")
_FENCE_EXEMPT_RE = re.compile(r"#.*\bktpu:\s*fence-exempt\(([^)]*)\)")
_FENCED_BY_CALLER_RE = re.compile(r"#.*\bktpu:\s*fenced-by-caller\b")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    suppress_reason: str = ""

    def render(self) -> str:
        tag = " [suppressed: %s]" % self.suppress_reason if self.suppressed else ""
        hint = " (hint: %s)" % self.hint if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{hint}{tag}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclass
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str
    used: bool = False


@dataclass
class SourceModule:
    """One parsed file plus its recovered comment/annotation stream."""

    path: str  # as given on the command line / API
    rel: str  # package-relative posix path ("kubernetes_tpu_torch/scheduler.py")
    source: str
    tree: ast.Module
    comments: dict[int, str] = field(default_factory=dict)  # line -> text
    suppressions: list[Suppression] = field(default_factory=list)

    @classmethod
    def parse(cls, path: str | Path, source: str | None = None) -> "SourceModule":
        p = Path(path)
        if source is None:
            source = p.read_text()
        tree = ast.parse(source, filename=str(p))
        mod = cls(path=str(p), rel=_rel_path(p), source=source, tree=tree)
        mod._collect_comments()
        return mod

    def _collect_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    line = tok.start[0]
                    # multiple comments per line are impossible; keep last
                    self.comments[line] = tok.string
        except tokenize.TokenizeError:  # pragma: no cover - parse succeeded
            pass
        for line, text in self.comments.items():
            m = _IGNORE_RE.search(text)
            if m:
                rules = tuple(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                self.suppressions.append(
                    Suppression(line=line, rules=rules, reason=m.group(2).strip())
                )

    # -- annotation lookups ------------------------------------------------

    def _mark_lines(self, node: ast.AST) -> list[int]:
        """Lines where a function-level mark may sit: the def line, the
        line above it, and the line above the first decorator."""
        lines = [node.lineno, node.lineno - 1]
        deco = getattr(node, "decorator_list", None)
        if deco:
            lines.append(deco[0].lineno - 1)
        return lines

    def _match_mark(self, node: ast.AST, regex: re.Pattern) -> re.Match | None:
        for line in self._mark_lines(node):
            text = self.comments.get(line)
            if text:
                m = regex.search(text)
                if m:
                    return m
        return None

    def is_hot(self, func: ast.AST) -> bool:
        return self._match_mark(func, _HOT_RE) is not None

    def is_cold(self, func: ast.AST) -> bool:
        return self._match_mark(func, _COLD_RE) is not None

    def holds_lock(self, func: ast.AST) -> str | None:
        m = self._match_mark(func, _HOLDS_RE)
        return m.group(1).strip() if m else None

    def guarded_by(self, stmt: ast.stmt) -> str | None:
        """guarded-by mark trailing (or directly above) a statement."""
        end = getattr(stmt, "end_lineno", stmt.lineno)
        for line in range(stmt.lineno - 1, end + 1):
            text = self.comments.get(line)
            if text:
                m = _GUARDED_RE.search(text)
                if m:
                    return m.group(1).strip()
        return None

    def replicated_mark(self, stmt: ast.stmt) -> bool:
        """``replicated`` mark trailing (or directly above) a statement.
        The line-above form only counts on a comment-ONLY line — a mark
        trailing the PREVIOUS statement must not bleed onto this one."""
        end = getattr(stmt, "end_lineno", stmt.lineno)
        for line in range(stmt.lineno - 1, end + 1):
            text = self.comments.get(line)
            if text and _REPLICATED_RE.search(text):
                if line >= stmt.lineno:
                    return True
                src = self.source.splitlines()[line - 1]
                if src.lstrip().startswith("#"):
                    return True
        return False

    def is_fence_check(self, func: ast.AST) -> bool:
        return self._match_mark(func, _FENCE_CHECK_RE) is not None

    def fence_exempt(self, func: ast.AST) -> str | None:
        """The exemption reason, '' when the mark is present but empty
        (itself a finding), None when unmarked."""
        m = self._match_mark(func, _FENCE_EXEMPT_RE)
        return m.group(1).strip() if m else None

    def is_fenced_by_caller(self, func: ast.AST) -> bool:
        return self._match_mark(func, _FENCED_BY_CALLER_RE) is not None


def _rel_path(p: Path) -> str:
    """Path relative to the directory CONTAINING the kubernetes_tpu_torch
    package, when the file lives inside one; else the bare filename (the
    fixture-test case)."""
    parts = p.resolve().parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i:])
    return p.name


class Pass:
    """Base class: one rule, one AST walk."""

    rule = "KTPU999"
    title = ""

    def run(self, module: SourceModule, ctx: "AnalysisContext") -> list[Finding]:
        raise NotImplementedError


@dataclass
class AnalysisContext:
    """Cross-file configuration shared by all passes (defaults in
    registry.py; fixture tests inject overrides)."""

    # (rel-path suffix, dotted qualname) pairs where host sync is sanctioned
    sanctioned_sync: frozenset = frozenset()
    # (rel-path suffix, dotted qualname) pairs of the device scope's roots:
    # host functions that issue the card's launches (the port's
    # counterparts of the JAX package's jax.jit roots)
    device_roots: frozenset = frozenset()
    # rel-path prefixes where TPU003 dtype discipline applies
    dtype_paths: tuple = ()
    # rel-path prefixes where MET001 scans metric usage
    metric_scan_paths: tuple = ()
    # metric attribute -> prometheus name (None => resolve from package)
    metric_attrs: dict | None = None
    # exception class names that must never be swallowed by a retry
    # loop (RETRY001) — semantic rejections, not transport faults
    non_retryable_errors: tuple = ("AdmitConflict",)
    # rel-path suffix of the metrics registry module (MET002)
    metrics_module_suffix: str = f"{PACKAGE}/metrics/__init__.py"
    # METRICS.md content override for fixture tests (None => read the
    # file next to the registry module)
    metrics_doc_text: str | None = None

    def is_sanctioned(self, rel: str, qualname: str) -> bool:
        return _listed(self.sanctioned_sync, rel, qualname)

    def is_device_root(self, rel: str, qualname: str) -> bool:
        return _listed(self.device_roots, rel, qualname)


def _listed(pairs, rel: str, qualname: str) -> bool:
    return any(qn == qualname and rel.endswith(sfx) for sfx, qn in pairs)


def apply_suppressions(module: SourceModule, findings: list[Finding]) -> None:
    """Mark findings suppressed by a matching ``ktpu: ignore`` on the
    finding's line or the line above it."""
    by_line: dict[int, list[Suppression]] = {}
    for s in module.suppressions:
        by_line.setdefault(s.line, []).append(s)
    for f in findings:
        for line in (f.line, f.line - 1):
            for s in by_line.get(line, ()):
                if f.rule in s.rules and s.reason:
                    f.suppressed = True
                    f.suppress_reason = s.reason
                    s.used = True
                    break
            if f.suppressed:
                break


def suppression_findings(module: SourceModule) -> list[Finding]:
    """KTPU000: every suppression must carry a reason."""
    out = []
    for s in module.suppressions:
        if not s.reason:
            out.append(
                Finding(
                    rule="KTPU000",
                    path=module.path,
                    line=s.line,
                    message=(
                        "suppression for %s has no reason"
                        % ",".join(s.rules)
                    ),
                    hint="write '# ktpu: ignore[%s]: <why this is safe>'"
                    % ",".join(s.rules),
                )
            )
    return out
