"""Framework runtime — the host-side extension-point runner
(pkg/scheduler/framework/runtime/framework.go#frameworkImpl), built so
plugin tests read like upstream's (runtime.NewFramework over a snapshot
of nodes, then RunFilterPlugins / RunScorePlugins per pod).

The in-tree plugin pipeline itself lives in the fused device kernels (the
whole point of this framework); this runtime wraps the scalar ORACLE
pipeline for the in-tree set and runs out-of-tree Python plugins around
it, so it is both the upstream-shaped test fixture and the semantics
reference for SchedulerConfig.out_of_tree_plugins.

Copied from ``kubernetes_tpu/framework/runtime.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from ..api.objects import Node, Pod
from .interface import (
    MAX_NODE_SCORE,
    CycleState,
    FilterPlugin,
    Registry,
    ScorePlugin,
    Status,
    StatusCode,
    run_pre_filter,
)


class WaitingPod:
    """runtime/waiting_pods_map.go#waitingPod: a pod parked at the Permit
    point. Each waiting Permit plugin holds its own timeout; the pod is
    rejected when the earliest one expires, allowed when every pending
    plugin calls allow(). allow/reject only record the verdict — the
    scheduler applies it (finishes or rolls back the binding) on its next
    cycle, the batched analog of the binding goroutine's WaitOnPermit."""

    def __init__(
        self, pod: Pod, node_name: str,
        plugin_timeouts: Mapping[str, float], now: float,
    ) -> None:
        self.pod = pod
        self.node_name = node_name
        self.deadlines = {
            name: now + timeout for name, timeout in plugin_timeouts.items()
        }
        self.pending = set(self.deadlines)
        self.rejected_by: str | None = None
        self.reject_message = ""

    def get_pending_plugins(self) -> list[str]:
        return sorted(self.pending)

    def allow(self, plugin_name: str) -> None:
        self.pending.discard(plugin_name)

    def reject(self, plugin_name: str, msg: str = "") -> None:
        self.rejected_by = plugin_name
        self.reject_message = msg

    @property
    def allowed(self) -> bool:
        return not self.pending and self.rejected_by is None

    def expired(self, now: float) -> "str | None":
        """Name of the first timed-out pending plugin, or None."""
        for name in sorted(self.pending):
            if now >= self.deadlines[name]:
                return name
        return None


@dataclass
class Framework:
    """runtime.NewFramework analog: nodes (+ resident pods) in, extension
    points runnable per pod. ``with_default_plugins`` includes the whole
    in-tree pipeline via the scalar oracle."""

    nodes: Sequence[Node]
    pods_by_node: Mapping[str, Sequence[Pod]] = field(default_factory=dict)
    registry: Registry = field(default_factory=Registry)
    with_default_plugins: bool = True

    def __post_init__(self) -> None:
        self._oracle = None
        if self.with_default_plugins:
            from ..ops.oracle.profile import FullOracle, make_oracle_nodes

            self._oracle = FullOracle(
                make_oracle_nodes(
                    list(self.nodes),
                    {k: list(v) for k, v in self.pods_by_node.items()},
                )
            )

    # -- extension points (framework.go#Run*Plugins) --

    def run_pre_filter_plugins(self, state: CycleState, pod: Pod) -> Status:
        """framework.go#RunPreFilterPlugins: statuses short-circuit;
        PreFilterResult allowlists intersect, stored in the cycle state
        under "PreFilterResult" (run_all consumes it)."""
        allow = None
        for p in self.registry.pre_filter:
            st, result = run_pre_filter(p, state, pod)
            if not st.is_success:
                return st
            if result is not None and not result.all_nodes():
                allow = (
                    result.node_names
                    if allow is None
                    else allow & result.node_names
                )
        if allow is not None:
            state.write("PreFilterResult", frozenset(allow))
        return Status.success()

    def run_filter_plugins(
        self, state: CycleState, pod: Pod, node: Node
    ) -> Status:
        """All Filter plugins for one (pod, node): in-tree pipeline first
        (when enabled), then out-of-tree plugins in registration order."""
        if self._oracle is not None:
            idx = self._node_index(node.name)
            if idx is None or not self._oracle.filter_one(
                pod, self._oracle.nodes[idx]
            ):
                return Status.unschedulable("in-tree filters")
        placed = tuple(self.pods_by_node.get(node.name, ()))
        for p in self.registry.filter:
            st = p.filter(state, pod, node, placed)
            if not st.is_success:
                return st
        return Status.success()

    def run_score_plugins(
        self, state: CycleState, pod: Pod, nodes: Sequence[Node]
    ) -> dict[str, int]:
        """Score + NormalizeScore + weight over ``nodes``
        (framework.go#RunScorePlugins' three passes), summed with the
        in-tree totals when defaults are enabled."""
        totals: dict[str, int] = {n.name: 0 for n in nodes}
        if self._oracle is not None:
            idxs = [self._node_index(n.name) for n in nodes]
            feasible = [i for i in idxs if i is not None]
            in_tree = self._oracle.score_totals(pod, feasible)
            for n, i in zip(nodes, idxs):
                if i is not None and i in in_tree:
                    totals[n.name] += in_tree[i]
        for p in self.registry.score:
            raw = {n.name: int(p.score(state, pod, n)) for n in nodes}
            norm = p.normalize_score(state, pod, raw)
            if norm is not None:
                raw = dict(norm)
            w = p.weight()
            for name, s in raw.items():
                if not 0 <= s <= MAX_NODE_SCORE:
                    raise ValueError(
                        f"plugin {p.name()} score {s} outside "
                        f"[0, {MAX_NODE_SCORE}] for node {name}"
                    )  # framework.go rejects out-of-range scores
                totals[name] += w * s
        return totals

    def run_all(
        self, pod: Pod
    ) -> tuple[list[Node], dict[str, int], Status]:
        """PreFilter -> Filter over all nodes -> Score over the feasible
        set: the schedulePod shape, for tests."""
        state = CycleState()
        st = self.run_pre_filter_plugins(state, pod)
        if not st.is_success:
            return [], {}, st
        try:
            allow = state.read("PreFilterResult")
        except KeyError:
            allow = None
        feasible = [
            n
            for n in self.nodes
            if (allow is None or n.name in allow)
            and self.run_filter_plugins(state, pod, n).is_success
        ]
        if not feasible:
            return [], {}, Status(StatusCode.UNSCHEDULABLE)
        return feasible, self.run_score_plugins(state, pod, feasible), Status.success()

    def _node_index(self, name: str):
        for i, n in enumerate(self.nodes):
            if n.name == name:
                return i
        return None


def fold_out_of_tree(
    plugins: Sequence[FilterPlugin | ScorePlugin],
    reps: Sequence[Pod],
    slot_nodes: Sequence[Node | None],
    mask,
    extra_score,
) -> None:
    """Fold out-of-tree plugins into the per-class device tables
    (SchedulerConfig.out_of_tree_plugins consumption): for every
    (scheduling-class representative, node slot), Filter rejections clear
    ``mask[c, slot]`` and Scores — after the plugin's NormalizeScore pass
    and the upstream 0..MAX_NODE_SCORE range check — accumulate weighted
    into ``extra_score[c, slot]``: the class-vectorized equivalent of
    registering the plugin in-process. Mutates the numpy tables in place.

    Semantics match Framework.run_*_plugins per scheduling CLASS: each
    class gets a fresh CycleState seeded by the PreFilter point, so
    plugins using the standard PreFilter-precompute pattern work. A
    Filter returning ERROR aborts the batch (raised), exactly as the
    reference aborts the scheduling cycle — an outage must not silently
    read as Unschedulable."""
    from .interface import PreFilterPlugin

    for c, rep in enumerate(reps):
        state = CycleState()  # per scheduling class == per cycle here
        rejected = False
        nodes = [
            (slot, node)
            for slot, node in enumerate(slot_nodes)
            if node is not None
        ]
        for p in plugins:
            if isinstance(p, PreFilterPlugin):
                st, result = run_pre_filter(p, state, rep)
                if st.code == StatusCode.ERROR:
                    raise RuntimeError(
                        f"plugin {p.name()} PreFilter error: {st.reasons}"
                    )
                if st.is_rejection:
                    # PreFilter rejection fails the pod on every node
                    # (schedule_one.go#schedulePod's early return)
                    mask[c, :] = False
                    rejected = True
                    break
                if result is not None and not result.all_nodes():
                    # PreFilterResult node-name allowlist -> static mask
                    for slot, node in nodes:
                        if node.name not in result.node_names:
                            mask[c, slot] = False
        if rejected:
            continue
        for p in plugins:
            if isinstance(p, FilterPlugin):
                for slot, node in nodes:
                    if not mask[c, slot]:
                        continue
                    st = p.filter(state, rep, node)
                    if st.code == StatusCode.ERROR:
                        raise RuntimeError(
                            f"plugin {p.name()} Filter error on "
                            f"{node.name}: {st.reasons}"
                        )
                    if not st.is_success:
                        mask[c, slot] = False
            if isinstance(p, ScorePlugin):
                raw = {
                    node.name: int(p.score(state, rep, node))
                    for slot, node in nodes
                    if mask[c, slot]
                }
                norm = p.normalize_score(state, rep, raw)
                if norm is not None:
                    raw = dict(norm)
                w = p.weight()
                for slot, node in nodes:
                    if node.name not in raw:
                        continue
                    s = raw[node.name]
                    if not 0 <= s <= MAX_NODE_SCORE:
                        raise ValueError(
                            f"plugin {p.name()} score {s} outside "
                            f"[0, {MAX_NODE_SCORE}] for node {node.name}"
                        )
                    extra_score[c, slot] += w * s
