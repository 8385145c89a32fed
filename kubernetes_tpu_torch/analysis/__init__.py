"""kubernetes_tpu_torch.analysis — host-sync & lock-discipline analyzer.

A self-contained AST static analyzer (stdlib only) of the port's own
source. Two engine tiers:

- per-module passes: accidental host<->card syncs in the device scope
  (the host functions that issue the card's launches) and on the solve
  hot path (TPU001/TPU002), dtype discipline in ops/ and solver/
  (TPU003), lexical lock discipline (LOCK001), metric-name drift
  (MET001);
- project passes over the cross-module symbol table and
  call graph (:mod:`.project`): lock-order deadlock detection
  (LOCK002), epoch/role fence discipline (FENCE001), retry discipline
  (RETRY001), cross-module host-sync escape (TPU004), and two-way
  metrics-doc drift (MET002).

Usage::

    python -m kubernetes_tpu_torch.analysis [--json] [--sarif out] [paths...]
    findings = analysis.run_paths(["kubernetes_tpu_torch/"])

Annotations and rule semantics: analysis/README.md. The in-process
pytest gate is tests/test_torch_analysis.py; the suppression-debt
ratchet baseline lives in analysis/suppression_baseline.json.

Copied from ``kubernetes_tpu/analysis/__init__.py``.
"""

from __future__ import annotations

from pathlib import Path

from .core import (
    AnalysisContext,
    Finding,
    Pass,
    SourceModule,
    apply_suppressions,
    suppression_findings,
)
from .passes import ALL_PASSES, ALL_PROJECT_PASSES
from .project import ProjectGraph, ProjectPass, build_project
from .registry import default_context

__all__ = [
    "ALL_PASSES",
    "ALL_PROJECT_PASSES",
    "AnalysisContext",
    "Finding",
    "Pass",
    "ProjectGraph",
    "ProjectPass",
    "SourceModule",
    "analyze_module",
    "analyze_project",
    "analyze_source",
    "analyze_sources",
    "build_project",
    "default_context",
    "load_modules",
    "run_paths",
]

_SORT_KEY = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731


def analyze_module(
    module: SourceModule,
    ctx: AnalysisContext | None = None,
    passes=None,
) -> list[Finding]:
    """Run the per-module pass set over one parsed module, apply
    suppressions, and enforce the reason requirement (KTPU000)."""
    ctx = ctx or default_context()
    findings: list[Finding] = []
    for cls in passes or ALL_PASSES:
        findings.extend(cls().run(module, ctx))
    apply_suppressions(module, findings)
    findings.extend(suppression_findings(module))
    findings.sort(key=_SORT_KEY)
    return findings


def analyze_source(
    source: str,
    filename: str = "snippet.py",
    ctx: AnalysisContext | None = None,
    passes=None,
) -> list[Finding]:
    """Fixture-test entry point: analyze an in-memory snippet with the
    per-module passes."""
    return analyze_module(
        SourceModule.parse(filename, source=source), ctx=ctx, passes=passes
    )


def analyze_project(
    modules,
    ctx: AnalysisContext | None = None,
    passes=None,
    project_passes=None,
) -> list[Finding]:
    """The full engine: per-module passes on each module, project
    passes once over the cross-module graph, suppressions applied to
    everything by line, one globally stable-sorted finding list."""
    ctx = ctx or default_context()
    modules = list(modules)
    per_module: dict[str, list[Finding]] = {m.path: [] for m in modules}
    stray: list[Finding] = []  # non-module paths (e.g. the metrics doc)

    for module in modules:
        for cls in passes if passes is not None else ALL_PASSES:
            per_module[module.path].extend(cls().run(module, ctx))

    project = build_project(modules, ctx)
    use = (
        project_passes if project_passes is not None else ALL_PROJECT_PASSES
    )
    for cls in use:
        for f in cls().run_project(project, ctx):
            if f.path in per_module:
                per_module[f.path].append(f)
            else:
                stray.append(f)

    findings: list[Finding] = []
    for module in modules:
        batch = per_module[module.path]
        apply_suppressions(module, batch)
        batch.extend(suppression_findings(module))
        findings.extend(batch)
    findings.extend(stray)
    findings.sort(key=_SORT_KEY)
    return findings


def analyze_sources(
    sources: dict,
    ctx: AnalysisContext | None = None,
    passes=(),
    project_passes=None,
) -> list[Finding]:
    """Fixture-test entry point for PROJECT rules: a dict of
    {filename: source} forming one in-memory project. Per-module passes
    default to OFF so project-rule fixtures stay single-purpose."""
    modules = [
        SourceModule.parse(name, source=src)
        for name, src in sorted(sources.items())
    ]
    return analyze_project(
        modules, ctx=ctx, passes=passes, project_passes=project_passes
    )


def collect_files(paths) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.is_file() and p.suffix == ".py":
            files.append(p)
        else:
            # a typo'd path silently scanning nothing would leave a CI
            # gate permanently green — fail loudly
            raise FileNotFoundError(
                f"{p}: not a directory or .py file — nothing to analyze"
            )
    return files


def load_modules(paths=None) -> tuple[list[SourceModule], list[Finding]]:
    """Parse the analyzed set (default: the kubernetes_tpu_torch package this
    module ships in); unparsable files become KTPU001 findings."""
    if not paths:
        paths = [Path(__file__).resolve().parents[1]]
    modules: list[SourceModule] = []
    broken: list[Finding] = []
    for f in collect_files(paths):
        try:
            modules.append(SourceModule.parse(f))
        except SyntaxError as e:
            broken.append(
                Finding(
                    rule="KTPU001",
                    path=str(f),
                    line=e.lineno or 0,
                    message=f"syntax error: {e.msg}",
                )
            )
    return modules, broken


def run_paths(
    paths=None,
    ctx: AnalysisContext | None = None,
    passes=None,
    project_passes=None,
) -> list[Finding]:
    """Analyze files/directories (default: the kubernetes_tpu_torch package).
    Returns ALL findings; callers filter on ``suppressed`` for gating."""
    modules, broken = load_modules(paths)
    findings = analyze_project(
        modules, ctx=ctx, passes=passes, project_passes=project_passes
    )
    findings.extend(broken)
    findings.sort(key=_SORT_KEY)
    return findings
