"""Fixture-builder DSL for tests, modeled on
pkg/scheduler/testing/wrappers.go#MakePod / #MakeNode.

Upstream tests read like::

    st.MakePod().Name("p").Req(map[...]{cpu: "100m"}).NodeAffinityIn(...).Obj()

Ours::

    MakePod().name("p").req({"cpu": "100m"}).node_affinity_in("k", ["v"]).obj()
"""

from __future__ import annotations

from typing import Mapping, Sequence

from .labels import (
    IN,
    NOT_IN,
    Requirement,
    Selector,
    selector_from_match_labels,
)
from .objects import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    Node,
    NodeAffinity,
    NodeSelectorTerm,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from .quantity import canonical_requests


class MakePod:
    def __init__(self) -> None:
        self._pod = Pod()
        self._containers: list[Container] = []
        self._init_containers: list[Container] = []

    # -- metadata --
    def name(self, n: str) -> "MakePod":
        self._pod.name = n
        return self

    def namespace(self, ns: str) -> "MakePod":
        self._pod.namespace = ns
        return self

    def uid(self, u: str) -> "MakePod":
        self._pod.uid = u
        return self

    def label(self, k: str, v: str) -> "MakePod":
        self._pod.labels[k] = v
        return self

    def labels(self, m: Mapping[str, str]) -> "MakePod":
        self._pod.labels.update(m)
        return self

    def annotation(self, k: str, v: str) -> "MakePod":
        self._pod.annotations[k] = v
        return self

    # -- spec --
    def node(self, n: str) -> "MakePod":
        self._pod.node_name = n
        return self

    def scheduler_name(self, n: str) -> "MakePod":
        self._pod.scheduler_name = n
        return self

    def priority(self, p: int) -> "MakePod":
        self._pod.priority = p
        return self

    def preemption_policy(self, p: str) -> "MakePod":
        self._pod.preemption_policy = p
        return self

    def scheduling_gates(self, gates: Sequence[str]) -> "MakePod":
        self._pod.scheduling_gates = tuple(gates)
        return self

    def node_selector(self, sel: Mapping[str, str]) -> "MakePod":
        self._pod.node_selector.update(sel)
        return self

    def req(self, requests: Mapping[str, str | int]) -> "MakePod":
        """Add a container with the given resource requests (wrappers.go#Req)."""
        self._containers.append(
            Container(
                name=f"con{len(self._containers)}",
                requests=canonical_requests(dict(requests)),
            )
        )
        return self

    def init_req(
        self, requests: Mapping[str, str | int], restart_policy: str = ""
    ) -> "MakePod":
        self._init_containers.append(
            Container(
                name=f"init{len(self._init_containers)}",
                requests=canonical_requests(dict(requests)),
                restart_policy=restart_policy,
            )
        )
        return self

    def container_image(self, image: str, requests: Mapping[str, str | int] | None = None) -> "MakePod":
        self._containers.append(
            Container(
                name=f"con{len(self._containers)}",
                requests=canonical_requests(dict(requests or {})),
                images=(image,),
            )
        )
        return self

    def host_port(self, port: int, protocol: str = "TCP", host_ip: str = "") -> "MakePod":
        self._containers.append(
            Container(
                name=f"con{len(self._containers)}",
                ports=(ContainerPort(host_port=port, protocol=protocol, host_ip=host_ip),),
            )
        )
        return self

    def overhead(self, requests: Mapping[str, str | int]) -> "MakePod":
        self._pod.overhead = canonical_requests(dict(requests))
        return self

    def toleration(
        self, key: str = "", value: str = "", operator: str = "Equal", effect: str = ""
    ) -> "MakePod":
        self._pod.tolerations = self._pod.tolerations + (
            Toleration(key=key, operator=operator, value=value, effect=effect),
        )
        return self

    def _node_affinity(self) -> NodeAffinity:
        aff = self._pod.affinity or Affinity()
        na = aff.node_affinity or NodeAffinity()
        return na

    def _set_node_affinity(self, na: NodeAffinity) -> None:
        aff = self._pod.affinity or Affinity()
        self._pod.affinity = Affinity(
            node_affinity=na,
            pod_affinity=aff.pod_affinity,
            pod_anti_affinity=aff.pod_anti_affinity,
        )

    def node_affinity_in(self, key: str, vals: Sequence[str]) -> "MakePod":
        """Required node affinity: key In vals (wrappers.go#NodeAffinityIn)."""

        na = self._node_affinity()
        term = NodeSelectorTerm(
            match_expressions=Selector((Requirement(key, IN, tuple(vals)),)),
            empty=False,
        )
        self._set_node_affinity(
            NodeAffinity(required=(na.required or ()) + (term,), preferred=na.preferred)
        )
        return self

    def node_affinity_not_in(self, key: str, vals: Sequence[str]) -> "MakePod":

        na = self._node_affinity()
        term = NodeSelectorTerm(
            match_expressions=Selector((Requirement(key, NOT_IN, tuple(vals)),)),
            empty=False,
        )
        self._set_node_affinity(
            NodeAffinity(required=(na.required or ()) + (term,), preferred=na.preferred)
        )
        return self

    def preferred_node_affinity(self, weight: int, key: str, vals: Sequence[str]) -> "MakePod":

        na = self._node_affinity()
        term = PreferredSchedulingTerm(
            weight=weight,
            preference=NodeSelectorTerm(
                match_expressions=Selector((Requirement(key, IN, tuple(vals)),)),
                empty=False,
            ),
        )
        self._set_node_affinity(
            NodeAffinity(required=na.required, preferred=na.preferred + (term,))
        )
        return self

    def _pod_affinity_parts(self) -> tuple[PodAffinity, PodAffinity]:
        aff = self._pod.affinity or Affinity()
        return (aff.pod_affinity or PodAffinity(), aff.pod_anti_affinity or PodAffinity())

    def _set_pod_affinity(self, pa: PodAffinity, anti: PodAffinity) -> None:
        aff = self._pod.affinity or Affinity()
        self._pod.affinity = Affinity(
            node_affinity=aff.node_affinity,
            pod_affinity=pa if (pa.required or pa.preferred) else None,
            pod_anti_affinity=anti if (anti.required or anti.preferred) else None,
        )

    def pod_affinity(
        self, topology_key: str, match_labels: Mapping[str, str], anti: bool = False
    ) -> "MakePod":
        """Required pod (anti-)affinity with a matchLabels selector
        (wrappers.go#PodAffinityExists-style helpers)."""

        term = PodAffinityTerm(
            label_selector=selector_from_match_labels(dict(match_labels)),
            topology_key=topology_key,
        )
        pa, paa = self._pod_affinity_parts()
        if anti:
            paa = PodAffinity(required=paa.required + (term,), preferred=paa.preferred)
        else:
            pa = PodAffinity(required=pa.required + (term,), preferred=pa.preferred)
        self._set_pod_affinity(pa, paa)
        return self

    def pod_anti_affinity(self, topology_key: str, match_labels: Mapping[str, str]) -> "MakePod":
        return self.pod_affinity(topology_key, match_labels, anti=True)

    def preferred_pod_affinity(
        self,
        weight: int,
        topology_key: str,
        match_labels: Mapping[str, str],
        anti: bool = False,
    ) -> "MakePod":

        wterm = WeightedPodAffinityTerm(
            weight=weight,
            term=PodAffinityTerm(
                label_selector=selector_from_match_labels(dict(match_labels)),
                topology_key=topology_key,
            ),
        )
        pa, paa = self._pod_affinity_parts()
        if anti:
            paa = PodAffinity(required=paa.required, preferred=paa.preferred + (wterm,))
        else:
            pa = PodAffinity(required=pa.required, preferred=pa.preferred + (wterm,))
        self._set_pod_affinity(pa, paa)
        return self

    def spread_constraint(
        self,
        max_skew: int,
        topology_key: str,
        when_unsatisfiable: str = "DoNotSchedule",
        match_labels: Mapping[str, str] | None = None,
        min_domains: int | None = None,
    ) -> "MakePod":

        sel = (
            selector_from_match_labels(dict(match_labels))
            if match_labels is not None
            else None
        )
        self._pod.topology_spread_constraints = self._pod.topology_spread_constraints + (
            TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=sel,
                min_domains=min_domains,
            ),
        )
        return self

    def pvc(self, claim_name: str) -> "MakePod":
        self._pod.pvc_names = self._pod.pvc_names + (claim_name,)
        return self

    def resource_claim(self, claim_name: str) -> "MakePod":
        """spec.resourceClaims[].resourceClaimName reference (DRA)."""
        self._pod.resource_claim_names = self._pod.resource_claim_names + (
            claim_name,
        )
        return self

    def nominated_node_name(self, n: str) -> "MakePod":
        self._pod.nominated_node_name = n
        return self

    def start_time(self, t: float) -> "MakePod":
        self._pod.start_time = t
        return self

    def obj(self) -> Pod:
        self._pod.containers = tuple(self._containers) or (Container(name="con0"),)
        self._pod.init_containers = tuple(self._init_containers)
        return self._pod


class MakeNode:
    def __init__(self) -> None:
        self._node = Node()

    def name(self, n: str) -> "MakeNode":
        self._node.name = n
        if "kubernetes.io/hostname" not in self._node.labels:
            self._node.labels["kubernetes.io/hostname"] = n
        return self

    def label(self, k: str, v: str) -> "MakeNode":
        self._node.labels[k] = v
        return self

    def capacity(self, res: Mapping[str, str | int]) -> "MakeNode":
        """Sets both capacity and allocatable (wrappers.go#Capacity)."""
        c = canonical_requests(dict(res))
        self._node.capacity = dict(c)
        self._node.allocatable = dict(c)
        return self

    def allocatable(self, res: Mapping[str, str | int]) -> "MakeNode":
        self._node.allocatable = canonical_requests(dict(res))
        return self

    def taint(self, key: str, value: str = "", effect: str = "NoSchedule") -> "MakeNode":
        self._node.taints = self._node.taints + (Taint(key, value, effect),)
        return self

    def unschedulable(self, v: bool = True) -> "MakeNode":
        self._node.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "MakeNode":
        self._node.images = self._node.images + (
            ContainerImage(names=(name,), size_bytes=size_bytes),
        )
        return self

    def obj(self) -> Node:
        return self._node
