"""Sequential oracle scheduler: the reference's scheduleOne loop in plain
Python, used to (a) produce ground-truth assignments and (b) validate solver
output under any tie-break policy.

Mirrors pkg/scheduler/schedule_one.go#schedulePod with the default
NodeResourcesFit(LeastAllocated) + BalancedAllocation scoring profile: filter
all nodes, score feasible ones, pick max. The reference picks uniformly among
max-score ties (selectHost); parity therefore means "the solver's pick is a
member of the oracle's tie set at that step, given identical history"
(SURVEY.md §8.8). validate_assignments replays the solver's own choices so
downstream state stays identical while each choice is checked against the
tie set.

Copied from ``kubernetes_tpu/ops/oracle/scheduler.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ...api.objects import Node, Pod
from .noderesources import (
    NodeState,
    balanced_allocation_score,
    fit_filter,
    least_allocated_score,
)


def make_node_states(
    nodes: Sequence[Node], pods_by_node: dict[str, list[Pod]] | None = None
) -> list[NodeState]:
    out = []
    for n in nodes:
        st = NodeState(
            name=n.name,
            allocatable=dict(n.allocatable),
            max_pods=n.allowed_pod_number,
            schedulable=not n.unschedulable,
        )
        for p in (pods_by_node or {}).get(n.name, []):
            st.add_pod(p)
        out.append(st)
    return out


def score_one(pod: Pod, node: NodeState) -> int:
    return least_allocated_score(pod, node) + balanced_allocation_score(pod, node)


def feasible_and_ties(
    pod: Pod, nodes: Sequence[NodeState]
) -> tuple[list[int], list[int]]:
    """Returns (feasible node indices, tie-set = argmax-score indices)."""
    feasible = [
        i
        for i, st in enumerate(nodes)
        if st.schedulable and not fit_filter(pod, st)
    ]
    if not feasible:
        return [], []
    scores = {i: score_one(pod, nodes[i]) for i in feasible}
    best = max(scores.values())
    ties = [i for i in feasible if scores[i] == best]
    return feasible, ties


@dataclass
class OracleResult:
    assignments: list[int]  # chosen node index per pod, -1 = unschedulable
    tie_sets: list[list[int]]


def schedule(
    pods: Sequence[Pod], nodes: list[NodeState], tie_break: str = "first"
) -> OracleResult:
    """Run the full sequential loop, choosing the first (lowest-index) tie.
    Note: with tie_break='first' this is deterministic ground truth for the
    solver's 'first' mode."""
    assert tie_break == "first"
    assignments: list[int] = []
    tie_sets: list[list[int]] = []
    for pod in pods:
        _, ties = feasible_and_ties(pod, nodes)
        if not ties:
            assignments.append(-1)
            tie_sets.append([])
            continue
        pick = ties[0]
        nodes[pick].add_pod(pod)
        assignments.append(pick)
        tie_sets.append(ties)
    return OracleResult(assignments, tie_sets)


def validate_assignments(
    pods: Sequence[Pod], nodes: list[NodeState], assignments: Sequence[int]
) -> list[str]:
    """Replay the solver's choices, checking each against the oracle tie set.
    Returns a list of violation messages (empty = parity holds)."""
    errors: list[str] = []
    for step, (pod, pick) in enumerate(zip(pods, assignments)):
        _, ties = feasible_and_ties(pod, nodes)
        if pick == -1:
            if ties:
                errors.append(
                    f"step {step} pod {pod.key}: solver says unschedulable but "
                    f"oracle tie set is {ties}"
                )
            continue
        if pick not in ties:
            errors.append(
                f"step {step} pod {pod.key}: pick {pick} not in oracle tie set "
                f"{ties[:10]}{'...' if len(ties) > 10 else ''}"
            )
            # follow the solver anyway to localize subsequent divergence
        nodes[pick].add_pod(pod)
    return errors
