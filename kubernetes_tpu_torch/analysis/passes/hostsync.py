"""TPU001 — host sync in the device scope or on the hot path.

The port runs eagerly: the host issues every launch of a solve, so one
accidental read of a card value inside the solve loop (``.item()``,
``.tolist()``, a copy to the CPU, an implicit ``bool()``) stalls the host
until the card has drained its queue, on every step. The batched solve
only wins while the host keeps queueing work ahead of the card.

Scope (see callgraph.ModuleGraph): the device roots of
registry.DEVICE_ROOTS (the host functions that issue the card's
launches) and everything reachable from them intra-module (*device
scope*), plus functions registered hot via ``# ktpu: hot`` and their
reachable set (*hot scope*). The sanctioned deferred-read points in
registry.SANCTIONED_SYNC_POINTS are exempt and stop propagation.

Flagged primitives:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` (both scopes) —
  a copy of a card value to the host, which waits for the card;
- ``.synchronize()`` (both scopes) — ``torch.cuda.synchronize()``, or an
  event's or a stream's: an explicit wait for the card;
- ``np.asarray`` / ``np.array`` / ``numpy.*`` (both scopes) — a forced
  card->host transfer when the argument is a card tensor;
- ``float()`` / ``int()`` / ``bool()`` on non-literal arguments (device
  scope only) — an implicit ``.item()`` on a tensor. Host-side hot code
  coerces numpy scalars legitimately, so hot scope skips this sub-rule;
  device reads there must still route through the sanctioned points.
  The argument ``x.shape[i]``, ``x.size(...)``, ``x.numel()``,
  ``x.dim()`` or ``len(x)`` is host metadata and is not flagged.

Counterpart of ``kubernetes_tpu/analysis/passes/hostsync.py``, whose
primitives are JAX's (``block_until_ready``, tracer coercions).
"""

from __future__ import annotations

import ast

from ..callgraph import own_nodes, scoped_graph
from ..core import Finding, Pass

_NP_BASES = {"np", "numpy", "onp"}
_NP_FUNCS = {"asarray", "array"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_COERCIONS = {"float", "int", "bool"}
# tensor methods that read host-side metadata, never the card
_METADATA_METHODS = {"size", "numel", "dim", "element_size"}


def _is_np_transfer(call: ast.Call) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr in _NP_FUNCS
        and isinstance(f.value, ast.Name)
        and f.value.id in _NP_BASES
    )


def sync_method(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
        return f.attr
    return None


def _is_metadata(expr: ast.expr) -> bool:
    """``x.shape``, ``x.shape[i]``, ``x.size(...)``, ``x.numel()``,
    ``x.dim()``, ``len(x)``: values the host holds without the card."""
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute):
        return expr.attr in ("shape", "ndim")
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name):
            return f.id == "len"
        if isinstance(f, ast.Attribute):
            return f.attr in _METADATA_METHODS
    return False


def _is_coercion(call: ast.Call) -> str | None:
    f = call.func
    if (
        isinstance(f, ast.Name)
        and f.id in _COERCIONS
        and call.args
        and not all(
            isinstance(a, ast.Constant) or _is_metadata(a) for a in call.args
        )
    ):
        return f.id
    return None


class HostSyncPass(Pass):
    rule = "TPU001"
    title = "host sync in device scope or hot path"

    def run(self, module, ctx):
        graph, device, hot = scoped_graph(module, ctx)
        findings: list[Finding] = []
        for qual in sorted(device | hot):
            info = graph.functions.get(qual)
            if info is None:
                continue
            in_device = qual in device
            where = "device-scope" if in_device else "hot-path"
            for node in own_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                if _is_np_transfer(node):
                    findings.append(
                        Finding(
                            self.rule, module.path, node.lineno,
                            f"numpy transfer ({ast.unparse(node.func)}) in "
                            f"{where} function '{qual}' forces a "
                            "card->host sync",
                            hint="keep the value on the card (torch), or "
                            "read it through a sanctioned deferred-read "
                            "point",
                        )
                    )
                    continue
                meth = sync_method(node)
                if meth is not None:
                    findings.append(
                        Finding(
                            self.rule, module.path, node.lineno,
                            f".{meth}() in {where} function '{qual}' "
                            "waits for the card",
                            hint="defer the read past the overlapped host "
                            "work, or move it off the hot path",
                        )
                    )
                    continue
                if in_device:
                    co = _is_coercion(node)
                    if co is not None:
                        findings.append(
                            Finding(
                                self.rule, module.path, node.lineno,
                                f"{co}() coercion in device-scope function "
                                f"'{qual}' reads a card value when its "
                                "argument is a tensor",
                                hint="keep the value a tensor (torch.where, "
                                "masks); coerce only host values",
                            )
                        )
        return findings
