"""NumPy/scalar oracle for the noderesources plugins — a direct transcription
of the reference semantics, used as ground truth by parity tests
(SURVEY.md §8.6: "the sanitizer that matters here").

Reference:
- Filter: pkg/scheduler/framework/plugins/noderesources/fit.go#fitsRequest
- LeastAllocated: noderesources/least_allocated.go#leastResourceScorer
  (integer arithmetic: (alloc-req)*100/alloc with truncating int64 division)
- MostAllocated: noderesources/most_allocated.go
- BalancedAllocation: noderesources/balanced_allocation.go
  #balancedResourceScorer (float64; |f0-f1|/2 for exactly 2 resources,
  population std otherwise; final int64 truncation)

The oracle works on plain dicts/objects — deliberately the dumbest possible
implementation, never vectorized, so it can't share bugs with the kernels.

Copied from ``kubernetes_tpu/ops/oracle/noderesources.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from ...api.objects import RESOURCE_CPU, RESOURCE_MEMORY, Pod

MAX_NODE_SCORE = 100

# Default scoring resources/weights: noderesources/fit.go defaultResources
DEFAULT_RESOURCES = ({"name": RESOURCE_CPU, "weight": 1}, {"name": RESOURCE_MEMORY, "weight": 1})


@dataclass
class NodeState:
    """Scalar mirror of NodeInfo for the oracle scheduler."""

    name: str
    allocatable: dict[str, int]
    max_pods: int
    used: dict[str, int] = field(default_factory=dict)
    nonzero_used_cpu: int = 0
    nonzero_used_mem: int = 0
    pod_count: int = 0
    schedulable: bool = True

    def add_pod(self, pod: Pod) -> None:
        for k, v in pod.resource_request().items():
            self.used[k] = self.used.get(k, 0) + v
        nz_cpu, nz_mem = pod.non_zero_request()
        self.nonzero_used_cpu += nz_cpu
        self.nonzero_used_mem += nz_mem
        self.pod_count += 1


def fit_filter(pod: Pod, node: NodeState) -> list[str]:
    """Returns the list of insufficient resources (empty = fits).
    fit.go#fitsRequest."""
    failures: list[str] = []
    if node.pod_count + 1 > node.max_pods:
        failures.append("pods")
    req = pod.resource_request()
    # fast path in the reference: a pod requesting nothing only needs the
    # pod-count check
    for r, v in sorted(req.items()):
        if v == 0:
            continue
        if node.used.get(r, 0) + v > node.allocatable.get(r, 0):
            failures.append(r)
    return failures


def _allocatable_and_requested(pod: Pod, node: NodeState, resource: str) -> tuple[int, int]:
    """resource_allocation.go#calculateResourceAllocatableRequest: scoring
    uses NonZeroRequested for cpu/memory, plain Requested for extended."""
    nz_cpu, nz_mem = pod.non_zero_request()
    if resource == RESOURCE_CPU:
        return node.allocatable.get(resource, 0), node.nonzero_used_cpu + nz_cpu
    if resource == RESOURCE_MEMORY:
        return node.allocatable.get(resource, 0), node.nonzero_used_mem + nz_mem
    return (
        node.allocatable.get(resource, 0),
        node.used.get(resource, 0) + pod.resource_request().get(resource, 0),
    )


def least_allocated_score(
    pod: Pod, node: NodeState, resources: Sequence[Mapping] = DEFAULT_RESOURCES
) -> int:
    """least_allocated.go#leastResourceScorer — all-int64 arithmetic."""
    node_score = 0
    weight_sum = 0
    for res in resources:
        alloc, requested = _allocatable_and_requested(pod, node, res["name"])
        if alloc == 0:
            score = 0
        elif requested > alloc:
            score = 0
        else:
            score = (alloc - requested) * MAX_NODE_SCORE // alloc
        node_score += score * res["weight"]
        weight_sum += res["weight"]
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


def most_allocated_score(
    pod: Pod, node: NodeState, resources: Sequence[Mapping] = DEFAULT_RESOURCES
) -> int:
    """most_allocated.go#mostResourceScorer."""
    node_score = 0
    weight_sum = 0
    for res in resources:
        alloc, requested = _allocatable_and_requested(pod, node, res["name"])
        if alloc == 0 or requested > alloc:
            score = 0
        else:
            score = requested * MAX_NODE_SCORE // alloc
        node_score += score * res["weight"]
        weight_sum += res["weight"]
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


def requested_to_capacity_ratio_score(
    pod: Pod,
    node: NodeState,
    shape: Sequence[tuple[int, int]],
    resources: Sequence[Mapping] = DEFAULT_RESOURCES,
) -> int:
    """requested_to_capacity_ratio.go: piecewise-linear over utilization.

    shape: [(utilization_0..100, score_0..10)] ascending; scores scaled by
    10 to MaxNodeScore internally (maxUtilization=100, maxScore via
    helper.BuildBrokerFunction equivalent).
    """
    node_score = 0
    weight_sum = 0
    for res in resources:
        alloc, requested = _allocatable_and_requested(pod, node, res["name"])
        if alloc == 0:
            score = 0
        else:
            if requested > alloc:
                utilization = 100
            else:
                utilization = requested * 100 // alloc
            score = _piecewise(shape, utilization) * (MAX_NODE_SCORE // 10)
        node_score += score * res["weight"]
        weight_sum += res["weight"]
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


def _trunc_div(a: int, b: int) -> int:
    """Go int64 division truncates toward zero; Python // floors. They differ
    exactly when the quotient is negative and inexact."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _piecewise(shape: Sequence[tuple[int, int]], x: int) -> int:
    """helper/shape_score.go#buildBrokerFunction: linear interpolation between
    shape points, Go-truncating integer math (decreasing segments produce
    negative numerators — floor division would score one point low)."""
    if x < shape[0][0]:
        return shape[0][1]
    for i in range(1, len(shape)):
        if x < shape[i][0]:
            x0, y0 = shape[i - 1]
            x1, y1 = shape[i]
            return y0 + _trunc_div((y1 - y0) * (x - x0), x1 - x0)
    return shape[-1][1]


def balanced_allocation_score(
    pod: Pod,
    node: NodeState,
    resources: Sequence[str] = (RESOURCE_CPU, RESOURCE_MEMORY),
) -> int:
    """balanced_allocation.go#balancedResourceScorer — float64 math."""
    fractions: list[float] = []
    for r in resources:
        alloc, requested = _allocatable_and_requested(pod, node, r)
        if alloc == 0:
            fraction = 1.0  # guard: balanced_allocation skips nodes w/o resource
        else:
            fraction = requested / alloc
        if fraction > 1.0:
            fraction = 1.0
        fractions.append(fraction)
    if len(fractions) == 2:
        std = abs(fractions[0] - fractions[1]) / 2.0
    elif len(fractions) > 2:
        mean = sum(fractions) / len(fractions)
        var = sum((f - mean) ** 2 for f in fractions) / len(fractions)
        std = math.sqrt(var)
    else:
        std = 0.0
    return int((1.0 - std) * MAX_NODE_SCORE)
