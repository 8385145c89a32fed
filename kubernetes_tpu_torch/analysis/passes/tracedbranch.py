"""TPU002 — Python control flow on card values.

In the device scope and on the hot path, a Python ``if`` / ``while`` /
``assert`` whose test is a torch expression calls ``bool()`` on a tensor:
an implicit ``.item()`` that waits for the card on every call — the per
step round trip the eager solve loop exists to avoid. Branching on host
Python values is fine and common, so this pass only flags tests that
syntactically contain a ``torch.``-rooted expression (``torch.any(x)``,
``x == torch.tensor(...)``) or a tensor reduction method (``.any()``,
``.all()``); name-typed data flow is out of scope (documented precision
bound, analysis/README.md). A bare attribute of ``torch`` (``x.dtype ==
torch.int64``, ``torch.cuda``) and the host predicates
``torch.is_tensor`` / ``torch.cuda.is_available`` are metadata, not
card values, and are not flagged.

Counterpart of ``kubernetes_tpu/analysis/passes/tracedbranch.py``, which
flags ``jnp.`` / ``lax.`` expressions in ``if`` / ``while``.
"""

from __future__ import annotations

import ast

from ..callgraph import own_nodes, scoped_graph
from ..core import Finding, Pass

_REDUCTIONS = {"any", "all"}
_HOST_PREDICATES = {"is_tensor", "is_available", "is_floating_point"}


def _torch_rooted(node: ast.expr) -> bool:
    """A call whose callee is an attribute chain rooted at ``torch``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "torch"


def card_valued(expr: ast.expr) -> bool:
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        if f.attr in _REDUCTIONS:
            return True
        if _torch_rooted(f) and f.attr not in _HOST_PREDICATES:
            return True
    return False


class TracedBranchPass(Pass):
    rule = "TPU002"
    title = "Python branch on a card value"

    def run(self, module, ctx):
        graph, device, hot = scoped_graph(module, ctx)
        findings: list[Finding] = []
        for qual in sorted(device | hot):
            info = graph.functions.get(qual)
            if info is None:
                continue
            where = "device-scope" if qual in device else "hot-path"
            for node in own_nodes(info.node):
                if not isinstance(node, (ast.If, ast.While, ast.Assert)):
                    continue
                if not card_valued(node.test):
                    continue
                kind = {ast.If: "if", ast.While: "while"}.get(
                    type(node), "assert"
                )
                findings.append(
                    Finding(
                        self.rule, module.path, node.lineno,
                        f"Python '{kind}' on a torch expression in {where} "
                        f"function '{qual}' syncs per call",
                        hint="use torch.where / masks on the card (or "
                        "hoist the decision to a host value)",
                    )
                )
        return findings
