"""Label selectors: parse + host-side evaluation.

Reference semantics:
- staging/src/k8s.io/apimachinery/pkg/labels/selector.go#Requirement.Matches
- staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go#LabelSelector
  (matchLabels AND matchExpressions, all requirements ANDed)
- NodeSelectorRequirement operators (In/NotIn/Exists/DoesNotExist/Gt/Lt) from
  staging/src/k8s.io/api/core/v1/types.go#NodeSelectorOperator, evaluated in
  k8s.io/component-helpers/scheduling/corev1/nodeaffinity/nodeaffinity.go.

Matching rules (same as reference):
- In:            key present and value in values
- NotIn:         key absent OR value not in values
- Exists:        key present
- DoesNotExist:  key absent
- Gt / Lt:       key present, label value parses as integer, int(label) >/< int(values[0])

An empty LabelSelector ({}) matches everything; a nil selector matches nothing
(callers encode that by passing None).

These evaluate host-side; the tensorizer (kubernetes_tpu/tensorize) compiles
the same requirements into bitset index programs for on-device evaluation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, Mapping

# Gt/Lt label values must parse like Go's strconv.ParseInt: ASCII digits with
# optional sign — no underscores, no unicode digits (int() is too lenient).
_GO_INT_RE = re.compile(r"^[+-]?[0-9]+$")


def _parse_go_int(s: str) -> int | None:
    if not _GO_INT_RE.match(s):
        return None
    v = int(s)
    # strconv.ParseInt(..., 10, 64) fails with ErrRange outside int64
    if v > (1 << 63) - 1 or v < -(1 << 63):
        return None
    return v

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

# metav1.LabelSelector only admits these (apimachinery#LabelSelectorAsSelector
# returns an error for anything else); NodeSelectorRequirement additionally
# admits Gt/Lt (core/v1#NodeSelectorOperator).
_LABEL_SELECTOR_OPS = {IN, NOT_IN, EXISTS, DOES_NOT_EXIST}
_NODE_SELECTOR_OPS = {IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT}


@dataclass(frozen=True)
class Requirement:
    """One selector requirement: key <op> values."""

    key: str
    operator: str
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        present = self.key in labels
        if self.operator == IN:
            return present and labels[self.key] in self.values
        if self.operator == NOT_IN:
            return (not present) or labels[self.key] not in self.values
        if self.operator == EXISTS:
            return present
        if self.operator == DOES_NOT_EXIST:
            return not present
        if self.operator in (GT, LT):
            if not present or len(self.values) != 1:
                return False
            lhs = _parse_go_int(labels[self.key])
            rhs = _parse_go_int(self.values[0])
            if lhs is None or rhs is None:
                return False
            return lhs > rhs if self.operator == GT else lhs < rhs
        raise ValueError(f"unknown selector operator {self.operator!r}")


@dataclass(frozen=True)
class Selector:
    """AND of requirements. ``Selector(())`` matches everything.

    ``match_labels`` records which leading requirements came from a
    LabelSelector's matchLabels map so serialization reproduces the original
    wire shape (they are ALSO present in ``requirements`` as In-requirements;
    evaluation uses only ``requirements``).
    """

    requirements: tuple[Requirement, ...] = ()
    match_labels: tuple[tuple[str, str], ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        return all(r.matches(labels) for r in self.requirements)

    @property
    def empty(self) -> bool:
        return not self.requirements


def selector_from_label_selector(obj: Mapping | None) -> Selector | None:
    """Build a Selector from a metav1.LabelSelector-shaped dict.

    Returns None for a nil selector (matches nothing), Selector(()) for the
    empty selector (matches everything) — mirroring
    apimachinery#LabelSelectorAsSelector.
    """
    if obj is None:
        return None
    reqs: list[Requirement] = []
    ml = tuple(sorted((obj.get("matchLabels") or {}).items()))
    for k, v in ml:
        reqs.append(Requirement(k, IN, (v,)))
    for expr in obj.get("matchExpressions") or ():
        op = expr.get("operator")
        if op not in _LABEL_SELECTOR_OPS:
            raise ValueError(f"invalid matchExpressions operator {op!r}")
        reqs.append(
            Requirement(expr["key"], op, tuple(expr.get("values") or ()))
        )
    return Selector(tuple(reqs), match_labels=ml)


def selector_from_node_selector_requirements(exprs) -> Selector:
    """Build a Selector from NodeSelectorRequirement dicts (Gt/Lt allowed)."""
    reqs: list[Requirement] = []
    for expr in exprs or ():
        op = expr.get("operator")
        if op not in _NODE_SELECTOR_OPS:
            raise ValueError(f"invalid nodeSelector operator {op!r}")
        reqs.append(Requirement(expr["key"], op, tuple(expr.get("values") or ())))
    return Selector(tuple(reqs))


def requirements_from_match_labels(match_labels: Mapping[str, str]) -> tuple[Requirement, ...]:
    return tuple(Requirement(k, IN, (v,)) for k, v in sorted(match_labels.items()))


def selector_from_match_labels(match_labels: Mapping[str, str]) -> Selector:
    """Selector equivalent to a pure matchLabels LabelSelector (wire shape
    preserved on serialization)."""
    ml = tuple(sorted(match_labels.items()))
    return Selector(requirements_from_match_labels(match_labels), match_labels=ml)


def label_selector_to_dict(sel: Selector | None) -> dict | None:
    """Inverse of selector_from_label_selector, for wire round-trips."""
    if sel is None:
        return None
    out: dict = {}
    n_ml = len(sel.match_labels)
    if n_ml:
        out["matchLabels"] = dict(sel.match_labels)
    exprs = [
        {"key": r.key, "operator": r.operator, "values": list(r.values)}
        for r in sel.requirements[n_ml:]
    ]
    if exprs:
        out["matchExpressions"] = exprs
    return out


def matches_any(selectors: Iterable[Selector], labels: Mapping[str, str]) -> bool:
    return any(s.matches(labels) for s in selectors)
