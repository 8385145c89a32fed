"""Scalar oracle for preemption (defaultpreemption PostFilter).

Transcription of pkg/scheduler/framework/preemption/preemption.go#Evaluator
+ plugins/defaultpreemption/default_preemption.go (SURVEY.md §3.1, §8.5):

- SelectVictimsOnNode: clone node state, remove ALL pods with priority <
  incoming; if the pod still doesn't fit -> node is not a candidate. Then
  try to reprieve victims: PDB-violating candidates first, then
  non-violating, each bucket in MoreImportantPod order (priority desc,
  earlier start first); a reprieved pod is re-added if the incoming pod
  still fits alongside it. Whatever cannot be reprieved is the victim set.
- filterPodsWithPDBViolation: a candidate violates if any matching PDB has
  no disruptions left (counters decrement as non-violating candidates are
  classified).
- pickOneNodeForPreemption lexicographic: fewest PDB violations -> lowest
  highest-victim-priority -> smallest priority sum -> fewest victims ->
  latest start among highest-priority victims -> first node in list order.

Two dry-run depths:
- select_victims_on_node: fit-only (NodeResourcesFit + pod count) — the
  cheap pre-screen matching the device kernel in solver/preemption.py.
- select_victims_on_node_full: the reference semantics — every candidacy
  and reprieve decision re-runs the FULL Filter pipeline
  (RunFilterPluginsWithNominatedPods per re-add), so pods blocked by
  NodePorts/PodTopologySpread/InterPodAffinity can preempt, and victims
  are never evicted for a pod that still could not schedule. Remaining
  divergence: the CSI volume-limit filter evaluates against the live
  volume context (victim evictions do not free attachment slots in the
  hypothesis), matching the [BOUNDARY] depth of volumebinding.

Copied from ``kubernetes_tpu/ops/oracle/preemption.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from ...api.objects import Node, Pod, PodDisruptionBudget

__all__ = [
    "PodDisruptionBudget",
    "more_important",
    "sort_more_important",
    "classify_pdb_violations",
    "NodeVictims",
    "select_victims_on_node",
    "select_victims_on_node_full",
    "pick_one_node",
]

PREEMPT_NEVER = "Never"


def more_important(p1: Pod, p2: Pod) -> bool:
    """util.MoreImportantPod: higher priority first; tie -> earlier start
    (longer-running) first."""
    if p1.effective_priority != p2.effective_priority:
        return p1.effective_priority > p2.effective_priority
    return p1.start_time < p2.start_time


def sort_more_important(pods: Sequence[Pod]) -> list[Pod]:
    return sorted(
        pods, key=lambda p: (-p.effective_priority, p.start_time, p.key)
    )


def classify_pdb_violations(
    candidates: Sequence[Pod], pdbs: Sequence[PodDisruptionBudget]
) -> tuple[list[Pod], list[Pod]]:
    """filterPodsWithPDBViolation: (violating, non_violating); counters
    decrement as non-violating candidates claim allowance."""
    allowed = [p.disruptions_allowed for p in pdbs]
    violating: list[Pod] = []
    non_violating: list[Pod] = []
    for pod in candidates:
        matching = [i for i, pdb in enumerate(pdbs) if pdb.matches(pod)]
        if any(allowed[i] <= 0 for i in matching):
            violating.append(pod)
        else:
            for i in matching:
                allowed[i] -= 1
            non_violating.append(pod)
    return violating, non_violating


@dataclass
class NodeVictims:
    victims: list[Pod]
    num_violating: int


def select_victims_on_node(
    pod: Pod,
    node_alloc: Mapping[str, int],
    max_pods: int,
    pods_on_node: Sequence[Pod],
    pdbs: Sequence[PodDisruptionBudget] = (),
) -> NodeVictims | None:
    """Fit-only dry run. Returns None if even evicting every lower-priority
    pod cannot make room."""
    prio = pod.effective_priority
    keep = [q for q in pods_on_node if q.effective_priority >= prio]
    potential = [q for q in pods_on_node if q.effective_priority < prio]

    def fits(current: Sequence[Pod]) -> bool:
        used: dict[str, int] = {}
        for q in current:
            for k, v in q.resource_request().items():
                used[k] = used.get(k, 0) + v
        for k, v in pod.resource_request().items():
            if v and used.get(k, 0) + v > node_alloc.get(k, 0):
                return False
        return len(current) + 1 <= max_pods

    if not fits(keep):
        return None

    violating, non_violating = classify_pdb_violations(
        sort_more_important(potential), pdbs
    )
    current = list(keep)
    victims: list[Pod] = []
    num_violating = 0
    for bucket, counts in ((violating, True), (non_violating, False)):
        for q in sort_more_important(bucket):
            if fits(current + [q]):
                current.append(q)  # reprieved
            else:
                victims.append(q)
                if counts:
                    num_violating += 1
    return NodeVictims(victims=victims, num_violating=num_violating)


def select_victims_on_node_full(
    pod: Pod,
    cand_idx: int,
    oracle,  # FullOracle over the current cluster truth
    pdbs: Sequence[PodDisruptionBudget] = (),
) -> NodeVictims | None:
    """preemption.go#SelectVictimsOnNode with the full Filter pipeline.

    Clone the candidate's state minus ALL lower-priority pods; if the
    incoming pod still fails any Filter plugin there, the node is not a
    candidate. Then reprieve victims (PDB-violating bucket first, then
    non-violating, MoreImportantPod order) — each re-add keeps the pod only
    if the full filters still pass, exactly the reference's per-re-add
    RunFilterPluginsWithNominatedPods.

    The spread/interpod PreFilter states are pod-level precomputations over
    the WHOLE cluster; they are rebuilt only for re-adds that can actually
    perturb them (the re-added pod matches a spread selector, owns required
    anti-affinity that selects the incoming pod, or matches one of the
    incoming pod's terms) — everything else reuses the current states.
    """
    from .interpod import (
        _required_aff_terms,
        _required_anti_terms,
        build_interpod_state,
        term_matches_pod,
    )
    from .noderesources import NodeState
    from .profile import OracleNode
    from .spread import build_filter_state, effective_constraints

    on = oracle.nodes[cand_idx]
    prio = pod.effective_priority
    keep = [q for q in on.pods if q.effective_priority >= prio]
    lower = [q for q in on.pods if q.effective_priority < prio]

    def build_states(current: list[Pod]):
        all_nodes = [
            (m.node, current if j == cand_idx else m.pods)
            for j, m in enumerate(oracle.nodes)
        ]
        return (
            build_filter_state(pod, all_nodes),
            build_interpod_state(pod, all_nodes),
        )

    def test(current: list[Pod], states) -> bool:
        node_test = OracleNode(
            node=on.node,
            res=NodeState(
                name=on.node.name,
                allocatable=dict(on.node.allocatable),
                max_pods=on.node.allowed_pod_number,
                schedulable=not on.node.unschedulable,
            ),
        )
        for q in current:
            node_test.add_pod(q)
        sp_state, ip_state = states
        return oracle.filter_one(pod, node_test, sp_state, ip_state)

    spread_cs = effective_constraints(pod, hard=True)
    anti_t = _required_anti_terms(pod)
    aff_t = _required_aff_terms(pod)

    def affects_states(q: Pod) -> bool:
        if spread_cs and q.namespace == pod.namespace and any(
            c.selector is not None and c.selector.matches(q.labels)
            for c in spread_cs
        ):
            return True
        if any(
            term_matches_pod(t, q, pod) for t in _required_anti_terms(q)
        ):
            return True
        return any(term_matches_pod(t, pod, q) for t in anti_t + aff_t)

    states = build_states(keep)
    if not test(keep, states):
        return None

    violating, non_violating = classify_pdb_violations(
        sort_more_important(lower), pdbs
    )
    current = list(keep)
    victims: list[Pod] = []
    num_violating = 0
    for bucket, counts in ((violating, True), (non_violating, False)):
        for q in sort_more_important(bucket):
            trial = current + [q]
            trial_states = build_states(trial) if affects_states(q) else states
            if test(trial, trial_states):
                current = trial
                states = trial_states
            else:
                victims.append(q)
                if counts:
                    num_violating += 1
    return NodeVictims(victims=victims, num_violating=num_violating)


def pick_one_node(
    candidates: Mapping[str, NodeVictims], node_order: Sequence[str]
) -> str | None:
    """pickOneNodeForPreemption lexicographic ordering."""
    if not candidates:
        return None

    def key(name: str):
        nv = candidates[name]
        if not nv.victims:
            # a no-victim candidate wins immediately upstream
            return (0, -(1 << 62), 0, 0, float("-inf"))
        max_prio = max(q.effective_priority for q in nv.victims)
        sum_prio = sum(q.effective_priority for q in nv.victims)
        latest_start_of_top = max(
            q.start_time
            for q in nv.victims
            if q.effective_priority == max_prio
        )
        return (
            nv.num_violating,
            max_prio,
            sum_prio,
            len(nv.victims),
            -latest_start_of_top,
        )

    ordered = [n for n in node_order if n in candidates]
    return min(ordered, key=key)
