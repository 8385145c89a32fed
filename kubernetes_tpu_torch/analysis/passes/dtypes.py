"""TPU003 — dtype discipline in solver/ops tensor constructors.

``torch.tensor([0.5])`` / ``torch.zeros(n)`` / ``torch.arange(n)``
without an explicit dtype take torch's defaults: a float becomes float32
and an int int64, whatever the value. The JAX package runs with x64 on,
so a float that it keeps in float64 silently rounds to float32 in the
port and breaks bit parity (a score floored one unit lower, a different
pick). Under ``ops/`` and ``solver/`` every constructor
(``tensor``, ``zeros``, ``ones``, ``full``, ``empty``, ``arange``) names
its ``dtype=``; a float literal without one is called out specifically.
``torch.zeros_like`` / ``.to`` are inherently typed and out of scope of
the constructor check.

A second clause polices NARROW FLATTENED INDICES:
``(a * n + b).to(torch.int32)`` (or ``.int()``, or numpy's
``.astype(np.int32)``) — a product of index-like values narrowed to a
sub-64-bit integer in the same expression. At pod·node scale (5.2e10)
such a product wraps int32 silently; the flattening must happen in int64
(or the operands must be provably clamped first, in which case the
narrowing belongs on a separate named value with the bound in a comment,
which also moves it out of this purely syntactic check's reach).

Counterpart of ``kubernetes_tpu/analysis/passes/dtypes.py``, which
checks ``jnp`` constructors and ``.astype``.
"""

from __future__ import annotations

import ast

from ..core import Finding, Pass

_CONSTRUCTORS = {"tensor", "zeros", "ones", "full", "empty", "arange"}
_NARROW_INT_DTYPES = {"int32", "int16", "int8", "uint8"}
# methods that narrow their receiver to 32 bits or fewer
_NARROW_METHODS = {"int", "short", "char", "byte"}


def _has_float_literal(expr: ast.expr) -> bool:
    return any(
        isinstance(n, ast.Constant) and isinstance(n.value, float)
        for n in ast.walk(expr)
    )


def _is_narrow_int_dtype(expr: ast.expr) -> bool:
    """torch.int32 / np.int32 (and narrower) attribute references."""
    return (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id in ("torch", "np", "numpy")
        and expr.attr in _NARROW_INT_DTYPES
    )


def _has_mult(expr: ast.expr) -> bool:
    return any(
        isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)
        for n in ast.walk(expr)
    )


def _looks_float(expr: ast.expr) -> bool:
    """Float-arithmetic receivers (score normalization narrowed to its
    documented 0..100 range) are not index flattening: a float literal
    or a true division anywhere in the expression marks them."""
    if _has_float_literal(expr):
        return True
    return any(
        isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div)
        for n in ast.walk(expr)
    )


def _narrowing(call: ast.Call) -> bool:
    """``.to(<narrow>)`` / ``.to(dtype=<narrow>)`` / ``.astype(<narrow>)``
    or a narrowing method (``.int()``)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr in _NARROW_METHODS:
        return not call.args and not call.keywords
    if f.attr not in ("to", "astype"):
        return False
    dtypes = list(call.args[:1]) + [
        kw.value for kw in call.keywords if kw.arg == "dtype"
    ]
    return any(_is_narrow_int_dtype(d) for d in dtypes)


class DtypeDisciplinePass(Pass):
    rule = "TPU003"
    title = "missing explicit dtype"

    def run(self, module, ctx):
        if not any(module.rel.startswith(p) for p in ctx.dtype_paths):
            return []
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (
                _narrowing(node)
                and _has_mult(f.value)
                and not _looks_float(f.value)
            ):
                findings.append(
                    Finding(
                        self.rule, module.path, node.lineno,
                        "flattened-index product narrowed to a "
                        "sub-64-bit integer in one expression (the "
                        "product can wrap before the cast)",
                        hint="flatten in int64 (.to(torch.int64) on "
                        "the operands) or clamp into a named value "
                        "whose bound a comment states, then narrow",
                    )
                )
                continue
            if not (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "torch"
                and f.attr in _CONSTRUCTORS
            ):
                continue
            if any(kw.arg == "dtype" for kw in node.keywords):
                continue
            detail = (
                "a bare float literal becomes float32"
                if any(_has_float_literal(a) for a in node.args)
                else "dtype falls to torch's default"
            )
            findings.append(
                Finding(
                    self.rule, module.path, node.lineno,
                    f"torch.{f.attr}(...) without explicit dtype ({detail})",
                    hint="pass dtype= (e.g. torch.int64/torch.bool) so "
                    "the port keeps the JAX package's x64 types",
                )
            )
        return findings
