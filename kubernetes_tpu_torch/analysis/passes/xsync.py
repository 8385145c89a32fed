"""TPU004 — cross-module host-sync escape analysis.

TPU001's scope is intra-module by design: a ``# ktpu: hot`` function
calling ``helper()`` in the SAME file propagates hotness, but a call
into another module does not — so a hot apply-path function calling a
cross-module helper that waits for the card was invisible. TPU004
re-runs the scope BFS over the PROJECT call graph (imports, methods on
typed attributes, constructors — see :mod:`..project`) and flags the
*definite* sync primitives of TPU001 (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.synchronize()``) in the functions the
PROJECT graph adds (functions already in their module's own scope are
TPU001's findings; reporting them twice would double every fix).

``np.asarray``-style transfers are deliberately NOT extended across
modules: the cross-module closure reaches large stretches of
host-resident bookkeeping where numpy-on-host is legitimate, and the
false-positive flood would drown the rule. Explicit card reads have
no such ambiguity.

Cold marks and the sanctioned sync whitelist barrier the BFS exactly
as in TPU001. Findings carry the root chain (``hot root A -> B -> C``)
so the report explains WHY a function is in scope.

Counterpart of ``kubernetes_tpu/analysis/passes/xsync.py``.
"""

from __future__ import annotations

import ast

from ..callgraph import own_nodes
from ..core import AnalysisContext, Finding
from ..project import ProjectGraph, ProjectPass
from .hostsync import sync_method


class CrossModuleSyncPass(ProjectPass):
    rule = "TPU004"
    title = "cross-module host-sync escape analysis"

    def run_project(
        self, project: ProjectGraph, ctx: AnalysisContext
    ) -> list:
        device, hot, via = project.global_scopes()
        findings: list[Finding] = []
        for node_id in sorted(device | hot):
            rel, qual = node_id
            finfo = project.function(node_id)
            m = project.modules.get(rel)
            if finfo is None or m is None:
                continue
            intra_device, intra_hot = project.intra_scopes(rel)
            if qual in intra_device or qual in intra_hot:
                continue
            for node in own_nodes(finfo.node):
                if not isinstance(node, ast.Call):
                    continue
                meth = sync_method(node)
                if meth is None:
                    continue
                chain = project.root_chain(node_id, via)
                route = " -> ".join(q for (_r, q) in chain)
                kind = "hot" if node_id in hot else "device"
                findings.append(
                    Finding(
                        rule=self.rule,
                        path=m.path,
                        line=node.lineno,
                        message=(
                            f".{meth}() forces a host sync in "
                            f"'{qual}', reached from a {kind} root via "
                            f"{route}"
                        ),
                        hint=(
                            "move the read behind the sanctioned "
                            "deferred-read boundary, mark the function "
                            "'# ktpu: cold' if it is off the hot path, "
                            "or batch the scalar out with the deferred "
                            "assignments"
                        ),
                    )
                )
        return findings
