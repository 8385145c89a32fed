"""Scalar oracle for PodTopologySpread (Filter + Score).

Transcription of pkg/scheduler/framework/plugins/podtopologyspread/
{common,filtering,scoring}.go (SURVEY.md §3.2). Because the reference mount
is empty, formulas follow upstream from domain knowledge; the testable
invariant is kernel ≡ this oracle. Key semantics:

Filter (whenUnsatisfiable=DoNotSchedule constraints):
- effective selector = labelSelector + matchLabelKeys (values taken from the
  incoming pod's own labels, ANDed in as In-requirements).
- counting eligibility (common.go#calPreFilterState): a node is counted iff
  it carries ALL hard-constraint topology keys, passes the pod's
  nodeSelector/required node affinity when nodeAffinityPolicy=Honor
  (default), and its NoSchedule/NoExecute taints are tolerated when
  nodeTaintsPolicy=Honor (default Ignore).
- matchNum(v) = #existing pods (same namespace) matching the selector on
  counted nodes with topology value v.
- minMatchNum = min over registered domains (filtering.go#minMatchNum);
  empty -> +inf (constraint passes); minDomains > #domains -> 0.
- node fails a constraint iff it lacks the key
  (UnschedulableAndUnresolvable) or matchNum(v)+selfMatch-minMatchNum >
  maxSkew, selfMatch = selector matches the incoming pod's own labels.

Score (ScheduleAnyway constraints; scoring.go):
- counting eligibility: node has ALL soft keys + nodeAffinityPolicy (Honor)
  + nodeTaintsPolicy (default Ignore).
- per feasible node: Σ_c scoreForCount = cnt_c·log(size_c+2) + (maxSkew-1),
  where cnt_c = domain count for the node's value (hostname topology: count
  on the node itself), size_c = #registered domains (hostname: #feasible
  nodes). Nodes missing any soft key are "ignored" (score 0).
- NormalizeScore: ignored -> 0; maxScore==0 -> MaxNodeScore; else
  100*(max+min-score)/max (ints after math.Round of the float sum).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

from ...api.labels import IN, Requirement, Selector
from ...api.objects import Node, Pod, TopologySpreadConstraint
from .plugins import taint_toleration_filter
from .plugins import node_affinity_filter

MAX_NODE_SCORE = 100
HOSTNAME_KEY = "kubernetes.io/hostname"


@dataclass(frozen=True)
class EffectiveConstraint:
    topology_key: str
    max_skew: int
    selector: Selector | None  # None matches nothing
    min_domains: int | None
    node_affinity_policy: str  # Honor | Ignore
    node_taints_policy: str  # Honor | Ignore


# defaults.go#systemDefaultConstraints: soft zone/hostname spreading applied
# when defaultingType=System and the pod declares no constraints of its own
SYSTEM_DEFAULT_CONSTRAINTS = (
    ("topology.kubernetes.io/zone", 3),
    ("kubernetes.io/hostname", 5),
)


def default_selector(pod: Pod, services) -> Selector | None:
    """helper/spread.go#DefaultSelector restricted to Services (RS/SS owner
    lookup is [CONTEXT]): union of matchLabels of every service selecting
    the pod; None when no service matches (upstream: empty selector =>
    buildDefaultConstraints returns nothing)."""
    merged: dict = {}
    found = False
    for svc in services or ():
        if svc.selects(pod):
            merged.update(svc.selector)
            found = True
    if not found:
        return None
    from ...api.labels import selector_from_match_labels

    return selector_from_match_labels(merged)


def default_selector_key(pod: Pod, services) -> tuple | None:
    """Canonical identity of the pod's service-derived default selector —
    pods with different keys must not share a scheduling class (their
    System default constraints differ). None = no service selects the pod."""
    merged: dict = {}
    found = False
    for svc in services or ():
        if svc.selects(pod):
            merged.update(svc.selector)
            found = True
    if not found:
        return None
    return (pod.namespace, tuple(sorted(merged.items())))


def system_default_constraints(pod: Pod, services) -> list[EffectiveConstraint]:
    """common.go#buildDefaultConstraints for defaultingType=System: two soft
    constraints (zone maxSkew 3, hostname maxSkew 5) with the service-derived
    selector; empty when the pod has its own constraints or no service
    selects it."""
    if pod.topology_spread_constraints:
        return []
    sel = default_selector(pod, services)
    if sel is None:
        return []
    return [
        EffectiveConstraint(
            topology_key=key,
            max_skew=skew,
            selector=sel,
            min_domains=None,
            node_affinity_policy="Honor",
            node_taints_policy="Ignore",
        )
        for key, skew in SYSTEM_DEFAULT_CONSTRAINTS
    ]


def effective_constraints(
    pod: Pod, hard: bool, defaults: Sequence[EffectiveConstraint] = ()
) -> list[EffectiveConstraint]:
    """``defaults`` (from system_default_constraints) apply only when the
    pod declares no constraints; system defaults are ScheduleAnyway, so the
    hard path never sees them."""
    if not pod.topology_spread_constraints:
        return [] if hard else list(defaults)
    want = "DoNotSchedule" if hard else "ScheduleAnyway"
    out = []
    for c in pod.topology_spread_constraints:
        if c.when_unsatisfiable != want:
            continue
        sel = c.label_selector
        if c.match_label_keys and sel is not None:
            extra = tuple(
                Requirement(k, IN, (pod.labels[k],))
                for k in c.match_label_keys
                if k in pod.labels
            )
            sel = Selector(sel.requirements + extra, sel.match_labels)
        out.append(
            EffectiveConstraint(
                topology_key=c.topology_key,
                max_skew=c.max_skew,
                selector=sel,
                min_domains=c.min_domains,
                node_affinity_policy=c.node_affinity_policy,
                node_taints_policy=c.node_taints_policy,
            )
        )
    return out


def _sel_matches(sel: Selector | None, labels: Mapping[str, str]) -> bool:
    return sel is not None and sel.matches(labels)


def _node_counted(
    pod: Pod,
    node: Node,
    constraints: Sequence[EffectiveConstraint],
) -> bool:
    """common.go#calPreFilterState node eligibility for domain counting."""
    if any(c.topology_key not in node.labels for c in constraints):
        return False
    # policies are per-constraint in the API but upstream evaluates them
    # per-node against the pod once (all default constraints share policies);
    # honor a policy if ANY constraint requests it
    if any(c.node_affinity_policy == "Honor" for c in constraints):
        if not node_affinity_filter(pod, node):
            return False
    if any(c.node_taints_policy == "Honor" for c in constraints):
        if not taint_toleration_filter(pod, node):
            return False
    return True


def _domain_counts(
    pod: Pod,
    constraint: EffectiveConstraint,
    counted_nodes: Sequence[tuple[Node, Sequence[Pod]]],
) -> dict[str, int]:
    """topology value -> #matching existing pods over counted nodes."""
    counts: dict[str, int] = {}
    for node, pods in counted_nodes:
        v = node.labels.get(constraint.topology_key)
        if v is None:
            continue
        counts.setdefault(v, 0)
        for p in pods:
            if p.namespace == pod.namespace and _sel_matches(
                constraint.selector, p.labels
            ):
                counts[v] += 1
    return counts


@dataclass
class SpreadFilterState:
    """Pod-level precomputation (filtering.go#preFilterState): domain counts,
    global minimum, and selfMatch per hard constraint — built ONCE per pod,
    then checked per candidate node in O(#constraints)."""

    constraints: list[EffectiveConstraint]
    counts: list[dict[str, int]]  # per constraint: domain value -> matchNum
    min_match: list[int | None]  # None = empty domain set (passes)
    self_match: list[int]

    def check(self, node: Node) -> bool:
        for c, counts, mn, sm in zip(
            self.constraints, self.counts, self.min_match, self.self_match
        ):
            v = node.labels.get(c.topology_key)
            if v is None:
                return False  # UnschedulableAndUnresolvable
            if mn is None:
                continue
            if counts.get(v, 0) + sm - mn > c.max_skew:
                return False
        return True


def build_filter_state(
    pod: Pod, all_nodes: Sequence[tuple[Node, Sequence[Pod]]]
) -> SpreadFilterState | None:
    """None = pod has no hard constraints (PreFilter Skip)."""
    constraints = effective_constraints(pod, hard=True)
    if not constraints:
        return None
    counted = [
        (n, ps) for n, ps in all_nodes if _node_counted(pod, n, constraints)
    ]
    counts_l: list[dict[str, int]] = []
    min_l: list[int | None] = []
    self_l: list[int] = []
    for c in constraints:
        counts = _domain_counts(pod, c, counted)
        if counts:
            min_match: int | None = min(counts.values())
        else:
            min_match = None  # empty critical paths -> constraint passes
        if c.min_domains is not None and len(counts) < c.min_domains:
            min_match = 0
        counts_l.append(counts)
        min_l.append(min_match)
        self_l.append(1 if _sel_matches(c.selector, pod.labels) else 0)
    return SpreadFilterState(constraints, counts_l, min_l, self_l)


def spread_filter(
    pod: Pod,
    node: Node,
    all_nodes: Sequence[tuple[Node, Sequence[Pod]]],
) -> bool:
    """Filter for one candidate node. all_nodes: (node, pods-on-node)."""
    state = build_filter_state(pod, all_nodes)
    return state is None or state.check(node)


def spread_scores(
    pod: Pod,
    feasible: Sequence[tuple[Node, Sequence[Pod]]],
    all_nodes: Sequence[tuple[Node, Sequence[Pod]]],
    defaults: Sequence[EffectiveConstraint] = (),
) -> list[int]:
    """Normalized 0-100 PodTopologySpread score for each feasible node."""
    constraints = effective_constraints(pod, hard=False, defaults=defaults)
    if not constraints:
        return [0 for _ in feasible]
    counted = [
        (n, ps) for n, ps in all_nodes if _node_counted(pod, n, constraints)
    ]
    per_c_counts = [_domain_counts(pod, c, counted) for c in constraints]

    raw: list[int | None] = []  # None = ignored node
    for node, pods in feasible:
        if any(c.topology_key not in node.labels for c in constraints):
            raw.append(None)
            continue
        score = 0.0
        for c, counts in zip(constraints, per_c_counts):
            v = node.labels[c.topology_key]
            if c.topology_key == HOSTNAME_KEY:
                cnt = sum(
                    1
                    for p in pods
                    if p.namespace == pod.namespace
                    and _sel_matches(c.selector, p.labels)
                )
                size = len(feasible)
            else:
                cnt = counts.get(v, 0)
                size = len(counts)
            score += cnt * math.log(size + 2) + (c.max_skew - 1)
        raw.append(int(round(score)))

    considered = [s for s in raw if s is not None]
    if not considered:
        return [0 for _ in raw]
    mx, mn = max(considered), min(considered)
    out = []
    for s in raw:
        if s is None:
            out.append(0)
        elif mx == 0:
            out.append(MAX_NODE_SCORE)
        else:
            out.append(MAX_NODE_SCORE * (mx + mn - s) // mx)
    return out
