"""Scheduling Framework plugin interfaces — the in-process, extension-
point-shaped API of SURVEY §8.2, mirroring
pkg/scheduler/framework/interface.go so plugin code and plugin tests read
like their upstream counterparts:

- `Status` / `StatusCode` (interface.go#Status, #Code): Success,
  Unschedulable, UnschedulableAndUnresolvable, Wait, Skip, Error;
- `CycleState` (framework/cycle_state.go): per-pod keyed scratch with
  read/write/clone;
- plugin protocols named for their extension points (PreFilterPlugin,
  FilterPlugin, ScorePlugin) with the upstream method shapes.

Two consumption paths:
1. `framework.runtime.Framework` runs the points host-side over API
   objects — the fixture upstream plugin tests build with
   runtime.NewFramework.
2. Out-of-tree plugins plug into the TPU solve itself via
   SchedulerConfig.out_of_tree_plugins: because the device pipeline is
   class-vectorized, a custom plugin's Filter/Score run host-side once
   per (pod scheduling class, node) and fold into the per-class static
   mask / score tables the fused kernel already consumes — the TPU-shaped
   equivalent of registering an in-process Go plugin. Contract for
   solver-path plugins: depend only on node state plus the pod fields in
   the scheduling-class identity — labels, annotations, and the in-tree
   spec fields (selectors, affinity, tolerations, requests, ports,
   spread) — never on other pending pods or on per-pod uniqueness like
   the name (two pods identical in those fields share one verdict by
   construction).

Copied from ``kubernetes_tpu/framework/interface.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Mapping

from ..api.objects import Node, Pod

MAX_NODE_SCORE = 100  # interface.go#MaxNodeScore
MIN_NODE_SCORE = 0


class StatusCode(enum.IntEnum):
    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


@dataclass(frozen=True)
class Status:
    code: StatusCode = StatusCode.SUCCESS
    reasons: tuple[str, ...] = ()

    @staticmethod
    def success() -> "Status":
        return Status()

    @staticmethod
    def unschedulable(*reasons: str) -> "Status":
        return Status(StatusCode.UNSCHEDULABLE, tuple(reasons))

    @staticmethod
    def error(*reasons: str) -> "Status":
        return Status(StatusCode.ERROR, tuple(reasons))

    @property
    def is_success(self) -> bool:
        return self.code == StatusCode.SUCCESS

    @property
    def is_rejection(self) -> bool:
        return self.code in (
            StatusCode.UNSCHEDULABLE,
            StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE,
        )


class CycleState:
    """Per-scheduling-cycle keyed scratch (cycle_state.go#CycleState)."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}

    def read(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(key)  # cycle_state.go#ErrNotFound
        return self._data[key]

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        c._data = dict(self._data)
        return c


class Plugin:
    """Base: every plugin has a Name (interface.go#Plugin)."""

    def name(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class PreFilterResult:
    """interface.go#PreFilterResult: a set of node names the pod could
    possibly schedule on — every other node is skipped by the Filter
    stage (folded into the static class mask on the solver path).
    ``node_names=None`` means all nodes (AllNodes())."""

    node_names: frozenset | None = None

    def all_nodes(self) -> bool:
        return self.node_names is None


class PreFilterPlugin(Plugin):
    def pre_filter(
        self, state: CycleState, pod: Pod
    ) -> "Status | tuple[Status, PreFilterResult | None]":
        """interface.go#PreFilterPlugin.PreFilter. May return a bare
        Status (common case) or (Status, PreFilterResult) to narrow the
        candidate node set."""
        return Status.success()


def run_pre_filter(
    plugin: PreFilterPlugin, state: CycleState, pod: Pod
) -> tuple[Status, "PreFilterResult | None"]:
    """Normalize the two allowed pre_filter return shapes."""
    out = plugin.pre_filter(state, pod)
    if isinstance(out, tuple):
        return out
    return out, None


class PreEnqueuePlugin(Plugin):
    """interface.go#PreEnqueuePlugin: gates a pod's entry into the active
    queue (the schedulinggates plugin's point). A non-success status
    parks the pod as gated until a pod update re-evaluates it."""

    def pre_enqueue(self, pod: Pod) -> Status:
        raise NotImplementedError


class QueueSortPlugin(Plugin):
    """interface.go#QueueSortPlugin: total order on the active queue.
    Replaces the default PrioritySort when registered (the reference
    allows exactly one queue-sort plugin)."""

    def less(self, info1, info2) -> bool:
        """True if info1 should pop before info2. Arguments are
        state.queue.QueuedPodInfo (pod, timestamp, attempts...)."""
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    """interface.go#PostFilterPlugin: runs when no node fit the pod
    (defaultpreemption's point). Returning (node_name, success) nominates
    the pod onto that node; plugins run in registration order after the
    in-tree default preemption, stopping at the first success/error."""

    def post_filter(
        self, state: CycleState, pod: Pod, filtered_nodes: Mapping[str, str]
    ) -> "tuple[str | None, Status]":
        """``filtered_nodes``: node name -> rejection reason for this
        cycle. Returns (nominated node name or None, status)."""
        raise NotImplementedError


class ReservePlugin(Plugin):
    """interface.go#ReservePlugin: Reserve runs after a node is chosen
    and the pod is assumed; Unreserve rolls back on any later failure
    (reverse registration order), and must be idempotent."""

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        return None


class PermitPlugin(Plugin):
    """interface.go#PermitPlugin: approve / reject / delay binding.
    Returns (Status, timeout_seconds): SUCCESS approves, WAIT parks the
    pod in the WaitingPods map until every waiting plugin allows it or
    the timeout rejects it (runtime/waiting_pods_map.go)."""

    def permit(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> tuple[Status, float]:
        raise NotImplementedError


class PreBindPlugin(Plugin):
    """interface.go#PreBindPlugin: last gate before the bind API call
    (volumebinding's BindPodVolumes point); failure unreserves."""

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        return Status.success()


class PostBindPlugin(Plugin):
    """interface.go#PostBindPlugin: informational, after a successful
    bind."""

    def post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        return None


class FilterPlugin(Plugin):
    def filter(
        self, state: CycleState, pod: Pod, node: Node,
        placed: tuple[Pod, ...] = (),
    ) -> Status:
        """interface.go#FilterPlugin.Filter. ``placed`` carries the node's
        resident pods (the NodeInfo view) for host-side runs; solver-path
        plugins should ignore it (class-vectorized folding evaluates
        against node state only)."""
        raise NotImplementedError

    def weight(self) -> int:  # parity with ScorePlugin for registries
        return 0


class ScorePlugin(Plugin):
    def score(self, state: CycleState, pod: Pod, node: Node) -> int:
        """interface.go#ScorePlugin.Score: 0..MAX_NODE_SCORE."""
        raise NotImplementedError

    def normalize_score(
        self, state: CycleState, pod: Pod, scores: Mapping[str, int]
    ) -> dict[str, int] | None:
        """Optional ScoreExtensions#NormalizeScore: node name -> score.
        Return None to keep raw scores."""
        return None

    def weight(self) -> int:
        return 1


@dataclass
class Registry:
    """plugins by extension point (runtime/registry.go shape)."""

    pre_enqueue: list[PreEnqueuePlugin] = field(default_factory=list)
    queue_sort: list[QueueSortPlugin] = field(default_factory=list)
    pre_filter: list[PreFilterPlugin] = field(default_factory=list)
    filter: list[FilterPlugin] = field(default_factory=list)
    post_filter: list[PostFilterPlugin] = field(default_factory=list)
    score: list[ScorePlugin] = field(default_factory=list)
    reserve: list[ReservePlugin] = field(default_factory=list)
    permit: list[PermitPlugin] = field(default_factory=list)
    pre_bind: list[PreBindPlugin] = field(default_factory=list)
    post_bind: list[PostBindPlugin] = field(default_factory=list)

    @staticmethod
    def classify(plugins) -> "Registry":
        """Sort a flat plugin sequence into extension-point lists by the
        protocols each implements (one object may serve several points,
        like upstream multi-point plugins)."""
        r = Registry()
        for p in plugins:
            if isinstance(p, PreEnqueuePlugin):
                r.pre_enqueue.append(p)
            if isinstance(p, QueueSortPlugin):
                r.queue_sort.append(p)
            if isinstance(p, PreFilterPlugin):
                r.pre_filter.append(p)
            if isinstance(p, FilterPlugin):
                r.filter.append(p)
            if isinstance(p, PostFilterPlugin):
                r.post_filter.append(p)
            if isinstance(p, ScorePlugin):
                r.score.append(p)
            if isinstance(p, ReservePlugin):
                r.reserve.append(p)
            if isinstance(p, PermitPlugin):
                r.permit.append(p)
            if isinstance(p, PreBindPlugin):
                r.pre_bind.append(p)
            if isinstance(p, PostBindPlugin):
                r.post_bind.append(p)
        if len(r.queue_sort) > 1:
            # profile.go: exactly one queue-sort plugin per profile
            raise ValueError(
                "at most one QueueSortPlugin may be registered; got "
                + ", ".join(p.name() for p in r.queue_sort)
            )
        return r
