"""Pod / Node API objects — the subset of core/v1 the scheduler consumes.

Reference semantics:
- staging/src/k8s.io/api/core/v1/types.go#Pod, #PodSpec, #Node, #NodeStatus,
  #Affinity, #Toleration, #Taint, #TopologySpreadConstraint
- pkg/scheduler/framework/types.go#computePodResourceRequest /
  util/pod/resources (sum containers, max initContainers, + overhead)
- pkg/scheduler/util/non_zero.go#GetNonzeroRequests (100 mCPU / 200 MB
  defaults for zero-request pods, used only for scoring)

Objects parse from / serialize to the real v1 JSON wire shapes so the
extender webhook server (kubernetes_tpu/server) speaks byte-compatible
payloads. Resource quantities are canonicalized to int64 on parse
(cpu -> milli, memory/storage -> bytes) per kubernetes_tpu/api/quantity.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

from .labels import (
    Selector,
    label_selector_to_dict,
    selector_from_label_selector,
    selector_from_node_selector_requirements,
)
from .quantity import canonical_requests, format_canonical

# Non-zero scoring defaults: pkg/scheduler/util/non_zero.go
DEFAULT_MILLI_CPU_REQUEST = 100  # 0.1 core
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024  # 200 MiB

RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# Taint effects: core/v1/types.go#TaintEffect
TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"


def _pod_requests(
    containers: list[dict[str, int]],
    init_containers: list[tuple[dict[str, int], bool]],
) -> dict[str, int]:
    """The PodRequests aggregation from k8s.io/component-helpers
    resource/helpers.go#PodRequests (order-sensitive sidecar semantics):

    - main requests = sum over containers, plus every restartable
      (sidecar) init container;
    - each non-sidecar init container's *effective* request is its own
      request plus the sidecar requests accumulated before it in declaration
      order (those sidecars are already running when it executes);
    - result = elementwise max(main, max over effective init requests).

    Overhead is added by the caller.
    """
    req: dict[str, int] = {}
    for c in containers:
        for k, v in c.items():
            req[k] = req.get(k, 0) + v
    sidecar_prefix: dict[str, int] = {}
    init_max: dict[str, int] = {}
    for c, is_sidecar in init_containers:
        if is_sidecar:
            for k, v in c.items():
                req[k] = req.get(k, 0) + v
                sidecar_prefix[k] = sidecar_prefix.get(k, 0) + v
            effective = dict(sidecar_prefix)
        else:
            effective = dict(sidecar_prefix)
            for k, v in c.items():
                effective[k] = effective.get(k, 0) + v
        for k, v in effective.items():
            if v > init_max.get(k, 0):
                init_max[k] = v
    for k, v in init_max.items():
        if v > req.get(k, 0):
            req[k] = v
    return req


# ---------------------------------------------------------------------------
# Leaf types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContainerPort:
    """core/v1#ContainerPort — only host ports matter to scheduling."""

    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"
    container_port: int = 0

    @staticmethod
    def from_dict(d: Mapping) -> "ContainerPort":
        return ContainerPort(
            host_port=int(d.get("hostPort") or 0),
            host_ip=d.get("hostIP") or "",
            protocol=d.get("protocol") or "TCP",
            container_port=int(d.get("containerPort") or 0),
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.container_port:
            out["containerPort"] = self.container_port
        if self.host_port:
            out["hostPort"] = self.host_port
        if self.host_ip:
            out["hostIP"] = self.host_ip
        if self.protocol != "TCP":
            out["protocol"] = self.protocol
        return out


@dataclass(frozen=True)
class Container:
    name: str = ""
    requests: Mapping[str, int] = field(default_factory=dict)  # canonical ints
    limits: Mapping[str, int] = field(default_factory=dict)
    ports: tuple[ContainerPort, ...] = ()
    images: tuple[str, ...] = ()  # image name(s) for ImageLocality
    restart_policy: str = ""  # "Always" on an initContainer => sidecar

    @staticmethod
    def from_dict(d: Mapping) -> "Container":
        res = d.get("resources") or {}
        image = d.get("image")
        return Container(
            name=d.get("name") or "",
            requests=canonical_requests(res.get("requests")),
            limits=canonical_requests(res.get("limits")),
            ports=tuple(ContainerPort.from_dict(p) for p in d.get("ports") or ()),
            images=(image,) if image else (),
            restart_policy=d.get("restartPolicy") or "",
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"name": self.name}
        if self.images:
            out["image"] = self.images[0]
        res: dict[str, Any] = {}
        if self.requests:
            res["requests"] = {
                k: format_canonical(k, v) for k, v in self.requests.items()
            }
        if self.limits:
            res["limits"] = {k: format_canonical(k, v) for k, v in self.limits.items()}
        if res:
            out["resources"] = res
        if self.ports:
            out["ports"] = [p.to_dict() for p in self.ports]
        if self.restart_policy:
            out["restartPolicy"] = self.restart_policy
        return out


@dataclass(frozen=True)
class Toleration:
    """core/v1#Toleration; match semantics in
    k8s.io/api/core/v1/toleration.go#ToleratesTaint."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty = all effects
    toleration_seconds: int | None = None

    def tolerates(self, taint: "Taint") -> bool:
        # toleration.go#ToleratesTaint: empty effect matches all effects;
        # empty key matches all keys (no restriction); then the operator
        # decides — Equal/"" compares values, Exists always matches.
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        if self.operator in ("Equal", ""):
            return self.value == taint.value
        return False

    @staticmethod
    def from_dict(d: Mapping) -> "Toleration":
        return Toleration(
            key=d.get("key") or "",
            operator=d.get("operator") or "Equal",
            value=d.get("value") or "",
            effect=d.get("effect") or "",
            toleration_seconds=d.get("tolerationSeconds"),
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.key:
            out["key"] = self.key
        if self.operator != "Equal":
            out["operator"] = self.operator
        if self.value:
            out["value"] = self.value
        if self.effect:
            out["effect"] = self.effect
        if self.toleration_seconds is not None:
            out["tolerationSeconds"] = self.toleration_seconds
        return out


@dataclass(frozen=True)
class Taint:
    key: str = ""
    value: str = ""
    effect: str = ""

    @staticmethod
    def from_dict(d: Mapping) -> "Taint":
        return Taint(d.get("key") or "", d.get("value") or "", d.get("effect") or "")

    def to_dict(self) -> dict:
        return {"key": self.key, "value": self.value, "effect": self.effect}


@dataclass(frozen=True)
class NodeSelectorTerm:
    """OR-term: AND of matchExpressions and matchFields."""

    match_expressions: Selector = field(default_factory=Selector)
    match_fields: Selector = field(default_factory=Selector)
    # A term with no expressions and no fields matches NOTHING
    # (nodeaffinity.go#nodeSelectorTermsMatch) — track emptiness explicitly.
    empty: bool = True

    @staticmethod
    def from_dict(d: Mapping) -> "NodeSelectorTerm":
        exprs = selector_from_node_selector_requirements(d.get("matchExpressions"))
        fields_ = selector_from_node_selector_requirements(d.get("matchFields"))
        return NodeSelectorTerm(
            match_expressions=exprs,
            match_fields=fields_,
            empty=not (d.get("matchExpressions") or d.get("matchFields")),
        )

    def matches(self, node_labels: Mapping[str, str], node_fields: Mapping[str, str]) -> bool:
        if self.empty:
            return False
        return self.match_expressions.matches(node_labels) and self.match_fields.matches(
            node_fields
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        d = label_selector_to_dict(self.match_expressions)
        if d and d.get("matchExpressions"):
            out["matchExpressions"] = d["matchExpressions"]
        f = label_selector_to_dict(self.match_fields)
        if f and f.get("matchExpressions"):
            out["matchFields"] = f["matchExpressions"]
        return out


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm

    @staticmethod
    def from_dict(d: Mapping) -> "PreferredSchedulingTerm":
        return PreferredSchedulingTerm(
            weight=int(d.get("weight") or 0),
            preference=NodeSelectorTerm.from_dict(d.get("preference") or {}),
        )

    def to_dict(self) -> dict:
        return {"weight": self.weight, "preference": self.preference.to_dict()}


@dataclass(frozen=True)
class NodeAffinity:
    """requiredDuringSchedulingIgnoredDuringExecution is an OR of terms."""

    required: tuple[NodeSelectorTerm, ...] | None = None  # None = no requirement
    preferred: tuple[PreferredSchedulingTerm, ...] = ()

    @staticmethod
    def from_dict(d: Mapping) -> "NodeAffinity":
        req = d.get("requiredDuringSchedulingIgnoredDuringExecution")
        required = None
        if req is not None:
            required = tuple(
                NodeSelectorTerm.from_dict(t) for t in req.get("nodeSelectorTerms") or ()
            )
        preferred = tuple(
            PreferredSchedulingTerm.from_dict(t)
            for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or ()
        )
        return NodeAffinity(required=required, preferred=preferred)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.required is not None:
            out["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [t.to_dict() for t in self.required]
            }
        if self.preferred:
            out["preferredDuringSchedulingIgnoredDuringExecution"] = [
                t.to_dict() for t in self.preferred
            ]
        return out


@dataclass(frozen=True)
class PodAffinityTerm:
    """core/v1#PodAffinityTerm. label_selector=None matches no pods."""

    label_selector: Selector | None = None
    topology_key: str = ""
    namespaces: tuple[str, ...] = ()  # empty => pod's own namespace
    namespace_selector: Selector | None = None
    match_label_keys: tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: Mapping) -> "PodAffinityTerm":
        return PodAffinityTerm(
            label_selector=selector_from_label_selector(d.get("labelSelector")),
            topology_key=d.get("topologyKey") or "",
            namespaces=tuple(d.get("namespaces") or ()),
            namespace_selector=selector_from_label_selector(d.get("namespaceSelector")),
            match_label_keys=tuple(d.get("matchLabelKeys") or ()),
        )

    def matches_namespace(self, pod_namespace: str, target_ns: str,
                          target_ns_labels: Mapping[str, str] | None = None) -> bool:
        """Which namespaces the term selects, per
        framework/types.go#AffinityTerm.Matches."""
        if self.namespaces:
            if target_ns in self.namespaces:
                return True
        elif self.namespace_selector is None:
            # no namespaces and no selector => pod's own namespace
            return target_ns == pod_namespace
        if self.namespace_selector is not None:
            return self.namespace_selector.matches(target_ns_labels or {})
        return False

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"topologyKey": self.topology_key}
        if self.label_selector is not None:
            out["labelSelector"] = label_selector_to_dict(self.label_selector)
        if self.namespaces:
            out["namespaces"] = list(self.namespaces)
        if self.namespace_selector is not None:
            out["namespaceSelector"] = label_selector_to_dict(self.namespace_selector)
        if self.match_label_keys:
            out["matchLabelKeys"] = list(self.match_label_keys)
        return out


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm

    @staticmethod
    def from_dict(d: Mapping) -> "WeightedPodAffinityTerm":
        return WeightedPodAffinityTerm(
            weight=int(d.get("weight") or 0),
            term=PodAffinityTerm.from_dict(d.get("podAffinityTerm") or {}),
        )

    def to_dict(self) -> dict:
        return {"weight": self.weight, "podAffinityTerm": self.term.to_dict()}


@dataclass(frozen=True)
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()

    @staticmethod
    def from_dict(d: Mapping) -> "PodAffinity":
        return PodAffinity(
            required=tuple(
                PodAffinityTerm.from_dict(t)
                for t in d.get("requiredDuringSchedulingIgnoredDuringExecution") or ()
            ),
            preferred=tuple(
                WeightedPodAffinityTerm.from_dict(t)
                for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or ()
            ),
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.required:
            out["requiredDuringSchedulingIgnoredDuringExecution"] = [
                t.to_dict() for t in self.required
            ]
        if self.preferred:
            out["preferredDuringSchedulingIgnoredDuringExecution"] = [
                t.to_dict() for t in self.preferred
            ]
        return out


@dataclass(frozen=True)
class Affinity:
    node_affinity: NodeAffinity | None = None
    pod_affinity: PodAffinity | None = None
    pod_anti_affinity: PodAffinity | None = None

    @staticmethod
    def from_dict(d: Mapping | None) -> "Affinity | None":
        if not d:
            return None
        na = d.get("nodeAffinity")
        pa = d.get("podAffinity")
        paa = d.get("podAntiAffinity")
        return Affinity(
            node_affinity=NodeAffinity.from_dict(na) if na else None,
            pod_affinity=PodAffinity.from_dict(pa) if pa else None,
            pod_anti_affinity=PodAffinity.from_dict(paa) if paa else None,
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.node_affinity:
            out["nodeAffinity"] = self.node_affinity.to_dict()
        if self.pod_affinity:
            out["podAffinity"] = self.pod_affinity.to_dict()
        if self.pod_anti_affinity:
            out["podAntiAffinity"] = self.pod_anti_affinity.to_dict()
        return out


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Selector | None = None
    min_domains: int | None = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"  # Honor | Ignore
    match_label_keys: tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: Mapping) -> "TopologySpreadConstraint":
        return TopologySpreadConstraint(
            max_skew=int(d.get("maxSkew") or 1),
            topology_key=d.get("topologyKey") or "",
            when_unsatisfiable=d.get("whenUnsatisfiable") or "DoNotSchedule",
            label_selector=selector_from_label_selector(d.get("labelSelector")),
            min_domains=d.get("minDomains"),
            node_affinity_policy=d.get("nodeAffinityPolicy") or "Honor",
            node_taints_policy=d.get("nodeTaintsPolicy") or "Ignore",
            match_label_keys=tuple(d.get("matchLabelKeys") or ()),
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "maxSkew": self.max_skew,
            "topologyKey": self.topology_key,
            "whenUnsatisfiable": self.when_unsatisfiable,
        }
        if self.label_selector is not None:
            out["labelSelector"] = label_selector_to_dict(self.label_selector)
        if self.min_domains is not None:
            out["minDomains"] = self.min_domains
        if self.node_affinity_policy != "Honor":
            out["nodeAffinityPolicy"] = self.node_affinity_policy
        if self.node_taints_policy != "Ignore":
            out["nodeTaintsPolicy"] = self.node_taints_policy
        if self.match_label_keys:
            out["matchLabelKeys"] = list(self.match_label_keys)
        return out


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class Pod:
    """Treat as immutable once scheduling sees it: resource accessors memoize
    (``_resource_request``/``_non_zero_request``), so mutating containers/
    overhead afterwards would serve stale totals. The state layer replaces Pod
    objects instead of mutating them (only queue/binding bookkeeping fields —
    node_name, nominated_node_name, resource_version — are ever written)."""

    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)

    # spec
    node_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    priority: int | None = None
    priority_class_name: str = ""
    preemption_policy: str = ""  # "" => PreemptLowerPriority
    scheduling_gates: tuple[str, ...] = ()
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Affinity | None = None
    tolerations: tuple[Toleration, ...] = ()
    topology_spread_constraints: tuple[TopologySpreadConstraint, ...] = ()
    containers: tuple[Container, ...] = ()
    init_containers: tuple[Container, ...] = ()
    overhead: dict[str, int] = field(default_factory=dict)  # canonical ints
    host_network: bool = False
    # PVC names referenced by spec.volumes[].persistentVolumeClaim.claimName
    pvc_names: tuple[str, ...] = ()
    # ResourceClaim names referenced by spec.resourceClaims[].
    # resourceClaimName (DRA). Entries that carry only a
    # resourceClaimTemplateName (the claim is generated by a controller we
    # don't run) are kept in claim_template_names — the DRA path reports
    # such pods unschedulable with a clear reason, and to_dict preserves
    # the references. [BOUNDARY] per SURVEY §3.2 dynamicresources row.
    resource_claim_names: tuple[str, ...] = ()
    claim_template_names: tuple[str, ...] = ()

    # status
    phase: str = "Pending"
    nominated_node_name: str = ""
    # queue bookkeeping (not wire fields)
    creation_timestamp: float = 0.0
    resource_version: int = 0
    start_time: float = 0.0  # for preemption victim ordering

    # ---- derived, cached ----
    _resource_request: dict[str, int] | None = field(
        default=None, repr=False, compare=False
    )
    _non_zero_request: tuple[int, int] | None = field(
        default=None, repr=False, compare=False
    )

    @property
    def effective_priority(self) -> int:
        return self.priority if self.priority is not None else 0

    @property
    def claim_templates_unresolved(self) -> bool:
        """True when the pod references a ResourceClaim template whose
        generated claim we cannot resolve (DRA reports it unschedulable)."""
        return bool(self.claim_template_names)

    def resource_request(self) -> dict[str, int]:
        """computePodResourceRequest: sum(containers) elementwise-max'd with
        each initContainer, sidecars (restartPolicy=Always initContainers)
        added to the running sum, plus pod overhead.

        Ref: pkg/scheduler/framework/plugins/noderesources/fit.go
        #computePodResourceRequest and k8s.io/component-helpers resource.
        """
        if self._resource_request is not None:
            return self._resource_request
        req = _pod_requests(
            [dict(c.requests) for c in self.containers],
            [(dict(c.requests), c.restart_policy == "Always") for c in self.init_containers],
        )
        for k, v in self.overhead.items():
            req[k] = req.get(k, 0) + v
        self._resource_request = req
        return req

    def non_zero_request(self) -> tuple[int, int]:
        """(milliCPU, memoryBytes) with scoring defaults applied.

        Ref: pkg/scheduler/util/non_zero.go#GetNonzeroRequests — defaults are
        applied per *container* whose request for that resource is zero.
        """
        if self._non_zero_request is not None:
            return self._non_zero_request

        def defaulted(c: Container) -> dict[str, int]:
            return {
                RESOURCE_CPU: c.requests.get(RESOURCE_CPU, 0) or DEFAULT_MILLI_CPU_REQUEST,
                RESOURCE_MEMORY: c.requests.get(RESOURCE_MEMORY, 0) or DEFAULT_MEMORY_REQUEST,
            }

        req = _pod_requests(
            [defaulted(c) for c in self.containers],
            [(defaulted(c), c.restart_policy == "Always") for c in self.init_containers],
        )
        cpu = req.get(RESOURCE_CPU, 0) + self.overhead.get(RESOURCE_CPU, 0)
        mem = req.get(RESOURCE_MEMORY, 0) + self.overhead.get(RESOURCE_MEMORY, 0)
        self._non_zero_request = (cpu, mem)
        return self._non_zero_request

    def host_ports(self) -> tuple[tuple[str, str, int], ...]:
        """(hostIP, protocol, hostPort) triples requested by this pod.
        Ref: plugins/nodeports/node_ports.go#getContainerPorts."""
        out = []
        for c in self.containers:
            for p in c.ports:
                if p.host_port > 0:
                    out.append((p.host_ip or "0.0.0.0", p.protocol, p.host_port))
        return tuple(out)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "Pod":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        aff = Affinity.from_dict(spec.get("affinity"))
        return Pod(
            name=meta.get("name") or "",
            namespace=meta.get("namespace") or "default",
            uid=meta.get("uid") or "",
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
            node_name=spec.get("nodeName") or "",
            scheduler_name=spec.get("schedulerName") or DEFAULT_SCHEDULER_NAME,
            priority=spec.get("priority"),
            priority_class_name=spec.get("priorityClassName") or "",
            preemption_policy=spec.get("preemptionPolicy") or "",
            scheduling_gates=tuple(
                g.get("name", "") for g in spec.get("schedulingGates") or ()
            ),
            node_selector=dict(spec.get("nodeSelector") or {}),
            affinity=aff,
            tolerations=tuple(Toleration.from_dict(t) for t in spec.get("tolerations") or ()),
            topology_spread_constraints=tuple(
                TopologySpreadConstraint.from_dict(t)
                for t in spec.get("topologySpreadConstraints") or ()
            ),
            containers=tuple(Container.from_dict(c) for c in spec.get("containers") or ()),
            init_containers=tuple(
                Container.from_dict(c) for c in spec.get("initContainers") or ()
            ),
            overhead=canonical_requests(spec.get("overhead")),
            host_network=bool(spec.get("hostNetwork") or False),
            pvc_names=tuple(
                v["persistentVolumeClaim"]["claimName"]
                for v in spec.get("volumes") or ()
                if v.get("persistentVolumeClaim", {}).get("claimName")
            ),
            resource_claim_names=tuple(
                rc["resourceClaimName"]
                for rc in spec.get("resourceClaims") or ()
                if rc.get("resourceClaimName")
            ),
            claim_template_names=tuple(
                rc["resourceClaimTemplateName"]
                for rc in spec.get("resourceClaims") or ()
                if rc.get("resourceClaimTemplateName")
                and not rc.get("resourceClaimName")
            ),
            phase=status.get("phase") or "Pending",
            nominated_node_name=status.get("nominatedNodeName") or "",
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        spec: dict[str, Any] = {}
        if self.node_name:
            spec["nodeName"] = self.node_name
        if self.scheduler_name != DEFAULT_SCHEDULER_NAME:
            spec["schedulerName"] = self.scheduler_name
        if self.priority is not None:
            spec["priority"] = self.priority
        if self.priority_class_name:
            spec["priorityClassName"] = self.priority_class_name
        if self.preemption_policy:
            spec["preemptionPolicy"] = self.preemption_policy
        if self.scheduling_gates:
            spec["schedulingGates"] = [{"name": g} for g in self.scheduling_gates]
        if self.node_selector:
            spec["nodeSelector"] = dict(self.node_selector)
        if self.affinity:
            spec["affinity"] = self.affinity.to_dict()
        if self.tolerations:
            spec["tolerations"] = [t.to_dict() for t in self.tolerations]
        if self.topology_spread_constraints:
            spec["topologySpreadConstraints"] = [
                t.to_dict() for t in self.topology_spread_constraints
            ]
        spec["containers"] = [c.to_dict() for c in self.containers]
        if self.init_containers:
            spec["initContainers"] = [c.to_dict() for c in self.init_containers]
        if self.overhead:
            spec["overhead"] = {
                k: format_canonical(k, v) for k, v in self.overhead.items()
            }
        if self.host_network:
            spec["hostNetwork"] = True
        if self.pvc_names:
            spec["volumes"] = [
                {
                    "name": f"vol{i}",
                    "persistentVolumeClaim": {"claimName": c},
                }
                for i, c in enumerate(self.pvc_names)
            ]
        if self.resource_claim_names or self.claim_template_names:
            spec["resourceClaims"] = [
                {"name": f"claim{i}", "resourceClaimName": c}
                for i, c in enumerate(self.resource_claim_names)
            ] + [
                {"name": f"claimtpl{i}", "resourceClaimTemplateName": t}
                for i, t in enumerate(self.claim_template_names)
            ]
        status: dict[str, Any] = {"phase": self.phase}
        if self.nominated_node_name:
            status["nominatedNodeName"] = self.nominated_node_name
        meta: dict[str, Any] = {"name": self.name, "namespace": self.namespace}
        if self.uid:
            meta["uid"] = self.uid
        if self.labels:
            meta["labels"] = dict(self.labels)
        if self.annotations:
            meta["annotations"] = dict(self.annotations)
        if self.resource_version:
            meta["resourceVersion"] = str(self.resource_version)
        return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec, "status": status}


# ---------------------------------------------------------------------------
# PersistentVolume / PersistentVolumeClaim — the slice the volume plugins
# read ([BOUNDARY], SURVEY.md §3.2: static F-stage checks; dynamic
# provisioning and the PV controller are out of scope)
# ---------------------------------------------------------------------------

ACCESS_RWO = "ReadWriteOnce"

ZONE_LABELS = ("topology.kubernetes.io/zone", "failure-domain.beta.kubernetes.io/zone")


@dataclass
class PersistentVolume:
    """core/v1#PersistentVolume: capacity, zone labels, node affinity, the
    CSI driver name (for nodevolumelimits counting), access modes."""

    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    capacity_bytes: int = 0
    access_modes: tuple[str, ...] = (ACCESS_RWO,)
    storage_class: str = ""
    csi_driver: str = ""
    claim_ref: str = ""  # ns/name of the bound PVC ("" = available)
    node_affinity: "NodeAffinity | None" = None  # required terms only
    resource_version: int = 0

    def matches_node(self, node: "Node") -> bool:
        """volume_zone.go + the PV nodeAffinity check in volumebinding:
        zone labels (if present) and spec.nodeAffinity must match."""
        for zl in ZONE_LABELS:
            want = self.labels.get(zl)
            if want is not None:
                # zone label values may be a __-separated set (GCE legacy)
                if node.labels.get(zl) not in want.split("__"):
                    return False
        if self.node_affinity is not None and self.node_affinity.required is not None:
            fields = node.field_labels()
            if not any(
                t.matches(node.labels, fields) for t in self.node_affinity.required
            ):
                return False
        return True

    @staticmethod
    def from_dict(d: Mapping) -> "PersistentVolume":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        cap = canonical_requests((spec.get("capacity") or {}))
        csi = spec.get("csi") or {}
        na = spec.get("nodeAffinity") or {}
        required = na.get("required")
        node_affinity = None
        if required is not None:
            node_affinity = NodeAffinity.from_dict(
                {"requiredDuringSchedulingIgnoredDuringExecution": required}
            )
        claim = spec.get("claimRef") or {}
        claim_ref = (
            f"{claim.get('namespace', 'default')}/{claim['name']}"
            if claim.get("name")
            else ""
        )
        return PersistentVolume(
            name=meta.get("name") or "",
            labels=dict(meta.get("labels") or {}),
            capacity_bytes=cap.get("storage", 0),
            access_modes=tuple(spec.get("accessModes") or (ACCESS_RWO,)),
            storage_class=spec.get("storageClassName") or "",
            csi_driver=csi.get("driver") or "",
            claim_ref=claim_ref,
            node_affinity=node_affinity,
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        spec: dict[str, Any] = {
            "capacity": {"storage": format_canonical("storage", self.capacity_bytes)},
            "accessModes": list(self.access_modes),
        }
        if self.storage_class:
            spec["storageClassName"] = self.storage_class
        if self.csi_driver:
            spec["csi"] = {"driver": self.csi_driver}
        if self.claim_ref:
            ns, name = self.claim_ref.split("/", 1)
            spec["claimRef"] = {"namespace": ns, "name": name}
        if self.node_affinity is not None:
            na = self.node_affinity.to_dict()
            req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
            if req:
                spec["nodeAffinity"] = {"required": req}
        meta: dict[str, Any] = {"name": self.name}
        if self.labels:
            meta["labels"] = dict(self.labels)
        return {
            "apiVersion": "v1",
            "kind": "PersistentVolume",
            "metadata": meta,
            "spec": spec,
        }


@dataclass
class PersistentVolumeClaim:
    """core/v1#PersistentVolumeClaim: the scheduler reads the bound volume
    name, requested size, class, and the binding mode of its class
    (WaitForFirstConsumer => defer to scheduling)."""

    name: str = ""
    namespace: str = "default"
    volume_name: str = ""  # bound PV ("" = unbound)
    storage_class: str = ""
    request_bytes: int = 0
    access_modes: tuple[str, ...] = (ACCESS_RWO,)
    # StorageClass.volumeBindingMode collapsed onto the claim [BOUNDARY]
    wait_for_first_consumer: bool = False
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "PersistentVolumeClaim":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        req = canonical_requests(
            ((spec.get("resources") or {}).get("requests") or {})
        )
        return PersistentVolumeClaim(
            name=meta.get("name") or "",
            namespace=meta.get("namespace") or "default",
            volume_name=spec.get("volumeName") or "",
            storage_class=spec.get("storageClassName") or "",
            request_bytes=req.get("storage", 0),
            access_modes=tuple(spec.get("accessModes") or (ACCESS_RWO,)),
            wait_for_first_consumer=bool(
                (d.get("metadata") or {})
                .get("annotations", {})
                .get("volume.kubernetes.io/wait-for-first-consumer")
            )
            or bool(spec.get("waitForFirstConsumer")),
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        spec: dict[str, Any] = {"accessModes": list(self.access_modes)}
        if self.volume_name:
            spec["volumeName"] = self.volume_name
        if self.storage_class:
            spec["storageClassName"] = self.storage_class
        if self.request_bytes:
            spec["resources"] = {
                "requests": {
                    "storage": format_canonical("storage", self.request_bytes)
                }
            }
        if self.wait_for_first_consumer:
            spec["waitForFirstConsumer"] = True
        return {
            "apiVersion": "v1",
            "kind": "PersistentVolumeClaim",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": spec,
        }


# ---------------------------------------------------------------------------
# PodDisruptionBudget (policy/v1) — the slice preemption reads
# ---------------------------------------------------------------------------


@dataclass
class Service:
    """[BOUNDARY] minimal core/v1 Service: name/namespace + spec.selector
    (plain label equality map). Consumed by PodTopologySpread's
    defaultingType=System path, where helper.DefaultSelector unions the
    selectors of services matching the pod (helper/spread.go#DefaultSelector;
    ReplicaSet/StatefulSet owner lookup is [CONTEXT] — documented out)."""

    name: str = ""
    namespace: str = "default"
    selector: dict = field(default_factory=dict)
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def selects(self, pod: "Pod") -> bool:
        return (
            pod.namespace == self.namespace
            and bool(self.selector)
            and all(pod.labels.get(k) == v for k, v in self.selector.items())
        )

    @staticmethod
    def from_dict(d: Mapping) -> "Service":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        return Service(
            name=meta.get("name") or "",
            namespace=meta.get("namespace") or "default",
            selector=dict(spec.get("selector") or {}),
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        return {
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "resourceVersion": str(self.resource_version),
            },
            "spec": {"selector": dict(self.selector)},
        }


@dataclass
class PodDisruptionBudget:
    """[BOUNDARY] minimal PDB: preemption dry-run reads selector matching
    and status.disruptionsAllowed (policy/v1#PodDisruptionBudget,
    preemption.go#filterPodsWithPDBViolation). The controller deriving
    disruptionsAllowed from minAvailable/maxUnavailable is out of scope —
    callers set the allowance directly (tests mirror how integration tests
    seed PDB status)."""

    name: str = ""
    namespace: str = "default"
    selector: Selector | None = None
    disruptions_allowed: int = 0
    min_available: int | str | None = None  # parsed but not enforced
    max_unavailable: int | str | None = None
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def matches(self, pod: "Pod") -> bool:
        return (
            pod.namespace == self.namespace
            and self.selector is not None
            and self.selector.matches(pod.labels)
        )

    @staticmethod
    def from_dict(d: Mapping) -> "PodDisruptionBudget":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return PodDisruptionBudget(
            name=meta.get("name") or "",
            namespace=meta.get("namespace") or "default",
            selector=selector_from_label_selector(spec.get("selector")),
            disruptions_allowed=int(status.get("disruptionsAllowed") or 0),
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        spec: dict[str, Any] = {}
        if self.selector is not None:
            spec["selector"] = label_selector_to_dict(self.selector)
        if self.min_available is not None:
            spec["minAvailable"] = self.min_available
        if self.max_unavailable is not None:
            spec["maxUnavailable"] = self.max_unavailable
        return {
            "apiVersion": "policy/v1",
            "kind": "PodDisruptionBudget",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": spec,
            "status": {"disruptionsAllowed": self.disruptions_allowed},
        }


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContainerImage:
    names: tuple[str, ...] = ()
    size_bytes: int = 0

    @staticmethod
    def from_dict(d: Mapping) -> "ContainerImage":
        return ContainerImage(
            names=tuple(d.get("names") or ()), size_bytes=int(d.get("sizeBytes") or 0)
        )

    def to_dict(self) -> dict:
        return {"names": list(self.names), "sizeBytes": self.size_bytes}


@dataclass
class Node:
    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    unschedulable: bool = False
    taints: tuple[Taint, ...] = ()
    allocatable: dict[str, int] = field(default_factory=dict)  # canonical ints
    capacity: dict[str, int] = field(default_factory=dict)
    images: tuple[ContainerImage, ...] = ()
    resource_version: int = 0

    @property
    def allowed_pod_number(self) -> int:
        return self.allocatable.get(RESOURCE_PODS, 0)

    def field_labels(self) -> dict[str, str]:
        """matchFields vocabulary — only metadata.name is supported upstream
        (nodeaffinity.go)."""
        return {"metadata.name": self.name}

    @staticmethod
    def from_dict(d: Mapping) -> "Node":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return Node(
            name=meta.get("name") or "",
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
            unschedulable=bool(spec.get("unschedulable") or False),
            taints=tuple(Taint.from_dict(t) for t in spec.get("taints") or ()),
            allocatable=canonical_requests(status.get("allocatable")),
            capacity=canonical_requests(status.get("capacity")),
            images=tuple(ContainerImage.from_dict(i) for i in status.get("images") or ()),
            resource_version=int(meta.get("resourceVersion") or 0),
        )

    def to_dict(self) -> dict:
        meta: dict[str, Any] = {"name": self.name}
        if self.labels:
            meta["labels"] = dict(self.labels)
        if self.annotations:
            meta["annotations"] = dict(self.annotations)
        if self.resource_version:
            meta["resourceVersion"] = str(self.resource_version)
        spec: dict[str, Any] = {}
        if self.unschedulable:
            spec["unschedulable"] = True
        if self.taints:
            spec["taints"] = [t.to_dict() for t in self.taints]
        status: dict[str, Any] = {}
        if self.allocatable:
            status["allocatable"] = {
                k: format_canonical(k, v) for k, v in self.allocatable.items()
            }
        if self.capacity:
            status["capacity"] = {
                k: format_canonical(k, v) for k, v in self.capacity.items()
            }
        if self.images:
            status["images"] = [i.to_dict() for i in self.images]
        return {"apiVersion": "v1", "kind": "Node", "metadata": meta, "spec": spec, "status": status}
