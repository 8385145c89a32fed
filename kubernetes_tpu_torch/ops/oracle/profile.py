"""Full default-profile oracle scheduler: the reference's scheduleOne loop
with the complete default plugin pipeline, in plain Python.

This extends oracle/scheduler.py (Fit+Balanced only) with the remaining
static plugins. Mirrors:
- schedule_one.go#schedulePod: Filter all nodes -> Score feasible ->
  NormalizeScore per plugin -> x weight -> sum -> selectHost (uniform among
  max ties; the oracle reports the tie SET, per SURVEY.md §8.8 parity rules)
- default plugin weights from apis/config/v1/default_plugins.go:
  TaintToleration 3, NodeAffinity 2, PodTopologySpread 2, InterPodAffinity 2,
  NodeResourcesFit 1, NodeResourcesBalancedAllocation 1, ImageLocality 1.

Copied from ``kubernetes_tpu/ops/oracle/profile.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ...api.objects import Node, Pod
from . import interpod as oip
from . import plugins as opl
from . import spread as osp
from .noderesources import (
    NodeState,
    balanced_allocation_score,
    fit_filter,
    least_allocated_score,
    most_allocated_score,
    requested_to_capacity_ratio_score,
)


@dataclass(frozen=True)
class ProfileWeights:
    """Score-plugin weights (default profile)."""

    fit: int = 1
    balanced: int = 1
    taint: int = 3
    node_affinity: int = 2
    image: int = 1
    spread: int = 2
    interpod: int = 2
    # InterPodAffinityArgs.hardPodAffinityWeight (default 1)
    hard_pod_affinity: int = 1
    # NodeResourcesFitArgs.scoringStrategy.type
    scoring_strategy: str = "LeastAllocated"
    # scoringStrategy.resources: ((name, weight), ...); default cpu/mem 1/1
    fit_resources: tuple = (("cpu", 1), ("memory", 1))
    # RequestedToCapacityRatio shape: ((utilization, score), ...)
    rtc_shape: tuple = ()


@dataclass
class OracleNode:
    """NodeInfo mirror for the full pipeline: resources + node object +
    placed pods (for ports; later affinity/spread)."""

    node: Node
    res: NodeState
    pods: list[Pod] = field(default_factory=list)
    used_ports: list[tuple[str, str, int]] = field(default_factory=list)

    def add_pod(self, pod: Pod) -> None:
        self.res.add_pod(pod)
        self.pods.append(pod)
        self.used_ports.extend(pod.host_ports())


def make_oracle_nodes(
    nodes: Sequence[Node], pods_by_node: dict[str, list[Pod]] | None = None
) -> list[OracleNode]:
    out = []
    for n in nodes:
        on = OracleNode(
            node=n,
            res=NodeState(
                name=n.name,
                allocatable=dict(n.allocatable),
                max_pods=n.allowed_pod_number,
                schedulable=not n.unschedulable,
            ),
        )
        for p in (pods_by_node or {}).get(n.name, []):
            on.add_pod(p)
        out.append(on)
    return out


class FullOracle:
    """Sequential ground-truth scheduler over the full static plugin set.
    ``volume_ctx`` (ops.oracle.volumes.VolumeContext) enables the volume
    plugin family's filters."""

    def __init__(
        self,
        nodes: list[OracleNode],
        weights: ProfileWeights | None = None,
        volume_ctx=None,
        services=(),
        spread_defaulting: str = "System",
        disabled: frozenset = frozenset(),
    ):
        self.nodes = nodes
        self.weights = weights or ProfileWeights()
        self.volume_ctx = volume_ctx
        self.services = list(services)
        self.spread_defaulting = spread_defaulting
        # plugins.filter.disabled for the profile — honored so config-driven
        # callers (preemption refinement) agree with the solver pipeline
        self.disabled = frozenset(disabled)
        self._refresh_image_states()

    def _spread_defaults(self, pod: Pod):
        if self.spread_defaulting != "System" or not self.services:
            return ()
        return osp.system_default_constraints(pod, self.services)

    def _refresh_image_states(self) -> None:
        node_objs = [on.node for on in self.nodes]
        self.image_states = opl.build_image_states(node_objs)
        self.total_nodes = len(node_objs)

    def _all_nodes_with_pods(self) -> list[tuple[Node, list[Pod]]]:
        return [(on.node, on.pods) for on in self.nodes]

    _UNSET = object()

    def filter_one(
        self,
        pod: Pod,
        on: OracleNode,
        spread_state=_UNSET,
        interpod_state=_UNSET,
    ) -> bool:
        """All Filter plugins (delegates to filter_reason so the plugin
        sequence exists exactly once). ``spread_state``/``interpod_state``
        are the per-pod PreFilter precomputations (spread: None = pod has
        no hard constraints); omitting them rebuilds per call — fine for
        single-node probes, hot paths prebuild via feasible_and_ties."""
        return (
            self.filter_reason(pod, on, spread_state, interpod_state)
            is None
        )

    def filter_reason(
        self,
        pod: Pod,
        on: OracleNode,
        spread_state=_UNSET,
        interpod_state=_UNSET,
    ) -> tuple[str, ...] | None:
        """First failing Filter plugin's reference-shaped diagnosis for
        this node (None = feasible) — the per-node Status reasons
        RunFilterPlugins would record. Usually one string; NodeResourcesFit
        reports every insufficient resource (its Status carries all of
        them upstream, and FitError counts each)."""
        if spread_state is FullOracle._UNSET:
            spread_state = osp.build_filter_state(pod, self._all_nodes_with_pods())
        if interpod_state is FullOracle._UNSET:
            interpod_state = oip.build_interpod_state(
                pod, self._all_nodes_with_pods()
            )
        from . import volumes as ovol
        from ...tensorize.plugins import VOLUME_PLUGINS

        dis = self.disabled
        if "NodeName" not in dis and not opl.node_name_filter(pod, on.node):
            return ("node(s) didn't match the requested node name",)
        if "NodeUnschedulable" not in dis and not opl.node_unschedulable_filter(
            pod, on.node
        ):
            return ("node(s) were unschedulable",)
        if "TaintToleration" not in dis and not opl.taint_toleration_filter(
            pod, on.node
        ):
            return ("node(s) had untolerated taint(s)",)
        if "NodeAffinity" not in dis and not opl.node_affinity_filter(
            pod, on.node
        ):
            return ("node(s) didn't match Pod's node affinity/selector",)
        if "NodePorts" not in dis and not opl.node_ports_filter(
            pod, on.used_ports
        ):
            return ("node(s) didn't have free ports for the requested pod ports",)
        if "NodeResourcesFit" not in dis:
            failures = fit_filter(pod, on.res)
            if failures:
                return tuple(
                    "Too many pods" if r == "pods" else f"Insufficient {r}"
                    for r in failures
                )
        if (
            "PodTopologySpread" not in dis
            and spread_state is not None
            and not spread_state.check(on.node)
        ):
            return ("node(s) didn't match pod topology spread constraints",)
        if "InterPodAffinity" not in dis and not interpod_state.check(on.node):
            return ("node(s) didn't match pod affinity/anti-affinity rules",)
        if (
            self.volume_ctx is not None
            and pod.pvc_names
            and not (VOLUME_PLUGINS & dis)
            and not ovol.volume_filter(pod, on.node, self.volume_ctx)
        ):
            return ("node(s) had volume node affinity/limit conflict",)
        return None

    def fit_error(self, pod: Pod, extra=None) -> str:
        """The aggregated unschedulable message the reference's FitError
        renders (schedule_one.go#FitError.Error [U]): '0/N nodes are
        available: {count} {reason}, ...' with reasons sorted.

        ``extra(on) -> str | None`` contributes reasons from filters the
        scalar replay doesn't model (DRA claim feasibility, folded
        out-of-tree plugins); it is consulted for nodes every scalar
        filter accepts."""
        from collections import Counter

        spread_state = osp.build_filter_state(
            pod, self._all_nodes_with_pods()
        )
        interpod_state = oip.build_interpod_state(
            pod, self._all_nodes_with_pods()
        )
        reasons: Counter = Counter()
        for on in self.nodes:
            why = self.filter_reason(pod, on, spread_state, interpod_state)
            if why is None and extra is not None:
                e = extra(on)
                why = (e,) if e is not None else None
            if why is not None:
                for w in why:
                    reasons[w] += 1
        if not reasons:
            return f"0/{len(self.nodes)} nodes are available"
        detail = ", ".join(
            f"{cnt} {why}" for why, cnt in sorted(reasons.items())
        )
        return f"0/{len(self.nodes)} nodes are available: {detail}."

    def score_totals(self, pod: Pod, feasible: list[int]) -> dict[int, int]:
        """Weighted, per-plugin-normalized totals over the feasible set
        (RunScorePlugins + NormalizeScore + weights)."""
        w = self.weights
        taint_raw = [
            opl.taint_toleration_score(pod, self.nodes[i].node) for i in feasible
        ]
        na_raw = [
            opl.node_affinity_score(pod, self.nodes[i].node) for i in feasible
        ]
        taint_norm = opl.default_normalize_score(taint_raw, reverse=True)
        na_norm = opl.default_normalize_score(na_raw, reverse=False)
        spread_norm = osp.spread_scores(
            pod,
            [(self.nodes[i].node, self.nodes[i].pods) for i in feasible],
            self._all_nodes_with_pods(),
            defaults=self._spread_defaults(pod),
        )
        interpod_norm = oip.interpod_scores(
            pod,
            [self.nodes[i].node for i in feasible],
            self._all_nodes_with_pods(),
            w.hard_pod_affinity,
        )

        resources = [
            {"name": n, "weight": wt} for n, wt in w.fit_resources
        ]
        if w.scoring_strategy == "RequestedToCapacityRatio" and w.rtc_shape:
            shape = [tuple(p) for p in w.rtc_shape]

            def fit_scorer(pod, res):
                return requested_to_capacity_ratio_score(
                    pod, res, shape, resources
                )

        elif w.scoring_strategy == "MostAllocated":
            def fit_scorer(pod, res):
                return most_allocated_score(pod, res, resources)

        else:
            def fit_scorer(pod, res):
                return least_allocated_score(pod, res, resources)

        totals: dict[int, int] = {}
        for j, i in enumerate(feasible):
            on = self.nodes[i]
            t = w.fit * fit_scorer(pod, on.res)
            t += w.balanced * balanced_allocation_score(pod, on.res)
            t += w.taint * taint_norm[j]
            t += w.node_affinity * na_norm[j]
            t += w.image * opl.image_locality_score(
                pod, on.node, self.image_states, self.total_nodes
            )
            t += w.spread * spread_norm[j]
            t += w.interpod * interpod_norm[j]
            totals[i] = t
        return totals

    def feasible_set(self, pod: Pod) -> list[int]:
        all_nodes = self._all_nodes_with_pods()
        spread_state = osp.build_filter_state(pod, all_nodes)
        interpod_state = oip.build_interpod_state(pod, all_nodes)
        return [
            i
            for i, on in enumerate(self.nodes)
            if self.filter_one(pod, on, spread_state, interpod_state)
        ]

    def feasible_and_ties(self, pod: Pod) -> tuple[list[int], list[int]]:
        feasible = self.feasible_set(pod)
        if not feasible:
            return [], []
        totals = self.score_totals(pod, feasible)
        best = max(totals.values())
        ties = [i for i in feasible if totals[i] == best]
        return feasible, ties

    def schedule(self, pods: Sequence[Pod]) -> tuple[list[int], list[list[int]]]:
        """tie_break='first' deterministic run; returns (assignments, tie_sets)."""
        assignments: list[int] = []
        tie_sets: list[list[int]] = []
        for pod in pods:
            _, ties = self.feasible_and_ties(pod)
            if not ties:
                assignments.append(-1)
                tie_sets.append([])
                continue
            pick = ties[0]
            self.nodes[pick].add_pod(pod)
            assignments.append(pick)
            tie_sets.append(ties)
        return assignments, tie_sets

    def validate_assignments(
        self, pods: Sequence[Pod], assignments: Sequence[int],
        names: Sequence[str] | None = None,
        sample: "set[int] | None" = None,
    ) -> list[str]:
        """Replay solver choices, checking each against the oracle tie set.
        ``names``: solver's node name per assignment (to map index spaces);
        defaults to self.nodes order. ``sample``: step indices to verify
        (every step is still REPLAYED so state stays exact; only the
        expensive tie-set computation is skipped elsewhere) — the
        large-scale parity gate's knob (SURVEY §8.6: sampled asserts)."""
        index_of = {on.node.name: i for i, on in enumerate(self.nodes)}
        errors: list[str] = []
        for step, (pod, pick) in enumerate(zip(pods, assignments)):
            if sample is not None and step not in sample:
                if pick >= 0:
                    oi = index_of[names[step]] if names is not None else pick
                    self.nodes[oi].add_pod(pod)
                continue
            _, ties = self.feasible_and_ties(pod)
            if pick == -1:
                if ties:
                    errors.append(
                        f"step {step} pod {pod.key}: solver unschedulable but "
                        f"oracle ties {ties[:10]}"
                    )
                continue
            oi = index_of[names[step]] if names is not None else pick
            if oi not in ties:
                errors.append(
                    f"step {step} pod {pod.key}: pick {oi} not in tie set "
                    f"{ties[:10]}{'...' if len(ties) > 10 else ''}"
                )
            self.nodes[oi].add_pod(pod)
        return errors

    def validate_feasible(
        self, pods: Sequence[Pod], assignments: Sequence[int],
        names: Sequence[str] | None = None,
    ) -> list[str]:
        """Feasibility-only replay for GLOBAL planners (the convex-
        relaxation mega-planner, ISSUE 19): every placed pick must be
        in the oracle's FEASIBLE set at that step given identical
        history — no resource/pod-count overcommit, every filter
        honored — but not necessarily in the argmax tie set. A global
        plan trades per-step greedy optimality for global packing;
        tie-set parity (``validate_assignments``) is the sequential
        solvers' contract, not the planner's. Unplaced pods are not
        flagged — under-placement is an objective-quality question the
        bench/sim ratio floors own, not a validity violation."""
        index_of = {on.node.name: i for i, on in enumerate(self.nodes)}
        errors: list[str] = []
        for step, (pod, pick) in enumerate(zip(pods, assignments)):
            if pick < 0:
                continue
            feasible = self.feasible_set(pod)
            oi = index_of[names[step]] if names is not None else pick
            if oi not in feasible:
                errors.append(
                    f"step {step} pod {pod.key}: pick {oi} not in "
                    f"feasible set {feasible[:10]}"
                    f"{'...' if len(feasible) > 10 else ''}"
                )
            # follow the plan anyway to localize subsequent divergence
            self.nodes[oi].add_pod(pod)
        return errors
