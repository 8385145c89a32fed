"""In-memory cluster-state service — the [BOUNDARY] stand-in for
apiserver + etcd (SURVEY.md §8.3).

What it emulates (and what the scheduler actually exercises of the real
thing):
- typed Pod/Node storage with a single monotonically-increasing
  resourceVersion stream (etcd revision equivalent);
- optimistic concurrency: updates carrying a stale resourceVersion are
  rejected with Conflict, like apiserver's 409s;
- watch streams: subscribers receive ADDED/MODIFIED/DELETED events in
  commit order, like client-go Reflector/informers (delivery is synchronous
  in-process — the informer layer of SURVEY §3.3 collapses to an event bus);
- the **pods/{name}/binding subresource**
  (pkg/registry/core/pod/storage/storage.go#BindingREST.Create): atomically
  sets spec.nodeName on a still-unbound pod; rejects if the pod is gone,
  already bound, or the target node doesn't exist — the reject paths the
  scheduler's assume/forget protocol must survive;
- fault injection hooks (bind_fault) so tests can simulate conflicts and
  node disappearance mid-cycle (SURVEY §6.3).

Copied from ``kubernetes_tpu/state/cluster.py``.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable, Literal

from ..api.objects import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
)

EventType = Literal["ADDED", "MODIFIED", "DELETED"]


class ApiError(Exception):
    def __init__(self, reason: str, message: str = "", fenced: bool = False):
        # Conflict | NotFound | AlreadyExists | Invalid | TooManyRequests
        # (429: the eviction subresource's PDB-exhausted rejection)
        self.reason = reason
        # True when a Conflict came from the fencing-token check: the
        # caller's fence token is revoked/superseded (it is a zombie).
        # A typed flag, not a message-prefix contract, so rewording the
        # message cannot silently break the scheduler's classification.
        self.fenced = fenced
        super().__init__(f"{reason}: {message}")


@dataclass
class Event:
    type: EventType
    kind: str  # "Pod" | "Node" | "Event"
    obj: object  # Pod | Node | EventRecord
    resource_version: int


Watcher = Callable[[Event], None]


@dataclass
class EventRecord:
    """events.k8s.io/v1 Event analog (the scheduler's operator-facing
    history: staging/src/k8s.io/api/events/v1/types.go#Event). The
    broadcaster's correlator dedup collapses repeats of the same
    (regarding, reason, note) into one record with a bumped count, like
    the reference's EventAggregator."""

    namespace: str
    regarding_kind: str  # "Pod" | "Node"
    regarding_namespace: str
    regarding_name: str
    reason: str  # Scheduled | FailedScheduling | Preempted | Nominated...
    note: str
    type: str = "Normal"  # Normal | Warning
    action: str = "Scheduling"
    reporting_controller: str = "kubernetes-tpu-scheduler"
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    name: str = ""  # generated: <regarding>.<seq>
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def to_dict(self) -> dict:
        """events.k8s.io/v1 wire shape."""
        return {
            "apiVersion": "events.k8s.io/v1",
            "kind": "Event",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "resourceVersion": str(self.resource_version),
            },
            "regarding": {
                "kind": self.regarding_kind,
                "namespace": self.regarding_namespace,
                "name": self.regarding_name,
            },
            "reason": self.reason,
            "note": self.note,
            "type": self.type,
            "action": self.action,
            "reportingController": self.reporting_controller,
            "deprecatedCount": self.count,
            "deprecatedFirstTimestamp": self.first_timestamp,
            "deprecatedLastTimestamp": self.last_timestamp,
        }


class ClusterState:
    """In-memory store guarded by one RLock (``self.lock``), the analog of
    the reference's mutex-guarded cache (SURVEY §6.2). The serve path
    mutates it from three threads (aiohttp event loop ingest, the scheduler
    drain executor, gRPC workers); every public method takes the lock, and
    watch callbacks fire under it so subscriber state (queue/cache) updates
    are serialized with the writes that caused them. The Scheduler holds
    the same lock across a whole schedule_batch, which makes its
    pop -> solve -> bind cycle atomic with respect to ingest."""

    def __init__(self, clock=None) -> None:
        from ..utils.clock import Clock

        self.lock = threading.RLock()
        # event timestamps (TTL sweeps, first/lastTimestamp) come off an
        # injectable clock so the sim's virtual timeline covers the state
        # service too; callers that pass explicit timestamps (the
        # scheduler's recorder) are unaffected
        self.clock = clock or Clock()
        self._rv = 0
        self._pods: dict[str, Pod] = {}  # key = ns/name
        self._nodes: dict[str, Node] = {}
        self._pdbs: dict[str, PodDisruptionBudget] = {}
        self._pvs: dict[str, PersistentVolume] = {}
        self._pvcs: dict[str, PersistentVolumeClaim] = {}
        self._services: dict[str, object] = {}
        # DRA (resource.k8s.io subset, api/dra.py): keyed by name (slices,
        # classes are cluster-scoped) / ns-name (claims). dra_generation
        # bumps on every DRA-object write so the allocator's base-context
        # cache invalidates exactly when the inventory/claims change.
        self._resource_slices: dict[str, object] = {}
        self._device_classes: dict[str, object] = {}
        self._resource_claims: dict[str, object] = {}
        self.dra_generation = 0
        # coordination.k8s.io Leases (leader election)
        self._leases: dict[str, object] = {}
        self._events: dict[str, EventRecord] = {}
        self._events_by_agg: dict[tuple, EventRecord] = {}
        self._event_seq = 0
        self.event_ttl = 3600.0  # reference --event-ttl default
        self._events_sweep_at = 256  # next TTL size-sweep threshold
        self._events_last_sweep = 0.0
        # (watcher, optional event filter) pairs — see subscribe()
        self._watchers: list[tuple[Watcher, Callable[[Event], bool] | None]] = []
        # fault injection: called with (pod, node_name) before a bind commits;
        # raise ApiError to simulate apiserver-side rejection
        self.bind_fault: Callable[[Pod, str], None] | None = None
        # fencing tokens (the classic lease-epoch pattern, server-side):
        # role -> the currently valid token. grant_fence bumps and hands
        # out a fresh token; revoke_fence bumps WITHOUT handing it out,
        # so every outstanding token for the role goes stale. A bind
        # carrying a stale token is rejected with Conflict — the commit
        # path's zombie fence (a scheduler incarnation that lost its
        # lease or was superseded can never land a bind).
        self._fences: dict[str, int] = {}
        self._fence_holders: dict[str, str] = {}
        # role -> rejected-commit count (the sim's zombie invariant
        # asserts 100% of a fenced incarnation's commits land here)
        self.fence_rejections: dict[str, int] = {}

    # -- watch plumbing --

    def subscribe(self, w: Watcher, filter: Callable[[Event], bool] | None = None) -> None:
        """Register a watcher, optionally behind a server-side event
        filter — the analog of an apiserver field-selector watch. The
        fleet tier subscribes each scheduler replica with its
        shard-filter predicate (fleet/runtime.py#event_filter) so a
        replica's informer stream — and therefore its cache — covers
        exactly the nodes and pods its shard owns. Filters run under
        the cluster lock in commit order, like the watchers they
        guard."""
        self._watchers.append((w, filter))

    def unsubscribe(self, w: Watcher) -> None:
        """Remove a watcher (bound methods compare equal by func +
        instance, so ``unsubscribe(obj.handler)`` works). The sim's
        fault harness uses this to interpose a delayed/duplicating
        delivery bus between the state service and the scheduler."""
        for i, (cb, _flt) in enumerate(self._watchers):
            if cb == w:
                del self._watchers[i]
                return
        raise ApiError("NotFound", "watcher not subscribed")

    def _emit(self, etype: EventType, kind: str, obj: Pod | Node) -> None:
        """Deliver one event to every subscriber. Delivery is ISOLATED:
        an exception in one subscriber's filter or callback is caught
        and counted (scheduler_watch_delivery_error_total) so it can
        neither prevent delivery to the remaining subscribers nor
        corrupt the event sequence (the rv was committed before any
        delivery started). The mutation that emitted the event has
        already landed — swallowing a subscriber's crash here is the
        informer-relay contract, not data loss."""
        from .. import metrics

        ev = Event(etype, kind, obj, self._rv)
        for w, flt in list(self._watchers):
            try:
                if flt is None or flt(ev):
                    w(ev)
            except Exception:
                metrics.watch_delivery_error_total.inc()
                import logging

                logging.getLogger("kubernetes_tpu_torch.cluster").exception(
                    "watch subscriber raised during %s %s delivery "
                    "(rv %d); remaining subscribers still served",
                    etype, kind, self._rv,
                )

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    @property
    def resource_version(self) -> int:
        return self._rv

    # -- pods --

    def create_pod(self, pod: Pod) -> Pod:
        if pod.key in self._pods:
            raise ApiError("AlreadyExists", pod.key)
        pod.resource_version = self._next_rv()
        self._pods[pod.key] = pod
        self._emit("ADDED", "Pod", pod)
        return pod

    def get_pod(self, namespace: str, name: str) -> Pod:
        key = f"{namespace}/{name}"
        try:
            return self._pods[key]
        except KeyError:
            raise ApiError("NotFound", key) from None

    def update_pod(self, pod: Pod, expect_rv: int | None = None) -> Pod:
        cur = self.get_pod(pod.namespace, pod.name)
        if expect_rv is not None and cur.resource_version != expect_rv:
            raise ApiError("Conflict", f"{pod.key} rv {cur.resource_version} != {expect_rv}")
        pod.resource_version = self._next_rv()
        self._pods[pod.key] = pod
        self._emit("MODIFIED", "Pod", pod)
        return pod

    def patch_pod_status(
        self, namespace: str, name: str, *, nominated_node_name: str | None = None,
        phase: str | None = None
    ) -> Pod:
        pod = self.get_pod(namespace, name)
        if nominated_node_name is not None:
            pod.nominated_node_name = nominated_node_name
        if phase is not None:
            pod.phase = phase
        pod.resource_version = self._next_rv()
        self._emit("MODIFIED", "Pod", pod)
        return pod

    def delete_pod(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        pod = self._pods.pop(key, None)
        if pod is None:
            raise ApiError("NotFound", key)
        self._next_rv()
        self._emit("DELETED", "Pod", pod)
        # DRA deallocating-controller stand-in ([BOUNDARY]): a deleted pod
        # leaves every claim's reservedFor; a claim nobody reserves loses
        # its allocation, freeing the devices (the resourceclaim
        # controller's deallocation, collapsed into the state service)
        if pod.resource_claim_names:
            for cname in pod.resource_claim_names:
                c = self._resource_claims.get(f"{namespace}/{cname}")
                if c is None or key not in c.reserved_for:
                    continue
                c.reserved_for = tuple(
                    k for k in c.reserved_for if k != key
                )
                if not c.reserved_for:
                    c.allocated_node = ""
                    c.results = ()
                c.resource_version = self._next_rv()
                self.dra_generation += 1
                self._emit("MODIFIED", "ResourceClaim", c)

    def list_pods(self) -> list[Pod]:
        return list(self._pods.values())

    # -- fencing tokens (commit-path zombie fence) --

    def grant_fence(self, role: str, holder: str = "") -> int:
        """Issue a fresh fencing token for ``role`` (a lease identity:
        the scheduler's leader lease, a fleet replica's per-shard
        lease). Granting invalidates every previously issued token for
        the role — a new incarnation taking over automatically fences
        its predecessor. Models the lease epoch committed at the
        apiserver; callers pass the token back on bind()."""
        token = self._fences.get(role, 0) + 1
        self._fences[role] = token
        self._fence_holders[role] = holder
        return token

    def revoke_fence(self, role: str) -> None:
        """Invalidate the role's current token WITHOUT granting a new
        one: every outstanding holder is fenced until someone re-grants
        (re-acquires the lease). The fleet calls this when a peer's
        lease goes stale — the membership change is committed HERE, at
        the authority, so a partitioned zombie that can still reach the
        state service finds its commits rejected."""
        self._fences[role] = self._fences.get(role, 0) + 1
        self._fence_holders[role] = ""

    def fence_valid(self, role: str, token: int) -> bool:
        return self._fences.get(role) == token

    def bind(
        self,
        namespace: str,
        name: str,
        node_name: str,
        fence: "tuple[str, int] | None" = None,
    ) -> None:
        """POST pods/{name}/binding — the commit point of a scheduling
        cycle. ``fence`` = (role, token) from grant_fence: a stale
        token is rejected with Conflict before anything else is
        examined — a fenced (lease-lost, partitioned, or superseded)
        incarnation can never land a commit, no matter what its stale
        cache believes about ownership."""
        if fence is not None:
            role, token = fence
            if not self.fence_valid(role, token):
                self.fence_rejections[role] = (
                    self.fence_rejections.get(role, 0) + 1
                )
                raise ApiError(
                    "Conflict",
                    f"fenced: token {token} for role {role!r} is no "
                    f"longer valid (current "
                    f"{self._fences.get(role)}); the incarnation lost "
                    "its lease or was superseded",
                    fenced=True,
                )
        pod = self.get_pod(namespace, name)
        if pod.node_name:
            raise ApiError("Conflict", f"{pod.key} already bound to {pod.node_name}")
        if node_name not in self._nodes:
            raise ApiError("NotFound", f"node {node_name}")
        if self.bind_fault is not None:
            self.bind_fault(pod, node_name)
        pod.node_name = node_name
        pod.resource_version = self._next_rv()
        self._emit("MODIFIED", "Pod", pod)

    def bind_gang(
        self,
        bindings: "list[tuple[str, str, str]]",
        fence: "tuple[str, int] | None" = None,
    ) -> None:
        """All-or-nothing bind of a pod group: ``bindings`` is a list
        of (namespace, name, node_name). EVERY precondition — the
        fencing token (checked once, the whole gang shares one commit
        epoch), each pod's existence and unbound state, each target
        node's existence, and the injected ``bind_fault`` hook per
        pair — is validated BEFORE the first mutation, so a rejection
        anywhere leaves the store byte-identical and no partial gang
        can ever land. Models one transactional apiserver request (the
        co-scheduler's PodGroup bind); the watch bus sees the same
        per-pod MODIFIED events a sequence of single binds would
        emit, in binding order."""
        if fence is not None:
            role, token = fence
            if not self.fence_valid(role, token):
                self.fence_rejections[role] = (
                    self.fence_rejections.get(role, 0) + 1
                )
                raise ApiError(
                    "Conflict",
                    f"fenced: token {token} for role {role!r} is no "
                    f"longer valid (current "
                    f"{self._fences.get(role)}); the incarnation lost "
                    "its lease or was superseded",
                    fenced=True,
                )
        pods = []
        for namespace, name, node_name in bindings:
            pod = self.get_pod(namespace, name)
            if pod.node_name:
                raise ApiError(
                    "Conflict",
                    f"{pod.key} already bound to {pod.node_name}",
                )
            if node_name not in self._nodes:
                raise ApiError("NotFound", f"node {node_name}")
            if self.bind_fault is not None:
                self.bind_fault(pod, node_name)
            pods.append((pod, node_name))
        # validation passed for the WHOLE gang: commit atomically
        for pod, node_name in pods:
            pod.node_name = node_name
            pod.resource_version = self._next_rv()
            self._emit("MODIFIED", "Pod", pod)

    def evict(
        self,
        namespace: str,
        name: str,
        *,
        expect_rv: int | None = None,
        fence: "tuple[str, int] | None" = None,
        nominated_node: str = "",
    ) -> Pod:
        """POST pods/{name}/eviction — the policy/v1 Eviction
        subresource analog, the API the continuous rebalancer
        (kubernetes_tpu/rebalance) moves pods through.

        Order of checks mirrors the reference registry
        (pkg/registry/core/pod/storage/eviction.go): the fencing token
        first (a zombie rebalancer incarnation can never move
        anything), then existence, then optimistic concurrency
        (``expect_rv`` → Conflict, like an eviction carrying a
        preconditions.resourceVersion), then the PodDisruptionBudget
        gate — a matching PDB with ``disruptionsAllowed == 0`` rejects
        with 429 TooManyRequests and the eviction does NOT happen.
        A granted eviction decrements every matching PDB's allowance
        immediately (the reference's registry does the same; the
        disruption controller replenishing it is out of scope) and
        emits an events.k8s.io record.

        [BOUNDARY] divergence, deliberate: the reference eviction
        DELETES the pod and a workload controller recreates a
        replacement that then schedules fresh. This store has no
        controllers, so delete + recreate collapse into one step — the
        pod returns to Pending (nodeName cleared) under its own
        identity, optionally carrying ``nominated_node`` as the
        status.nominatedNodeName hint the recreated pod would get from
        the rebalancer's target assignment. On the watch bus the
        collapse is visible as the SAME pair every subscriber already
        handles: a DELETED event (nodeName still set — assigned-pod
        delete: caches release occupancy, shard filters route it to the
        node's owner) followed by an ADDED event (unbound — queues
        re-admit it, routed to the pod's owner). Pod identity surviving
        the eviction is what keeps the decision journal's per-pod
        history continuous across a migration."""
        if fence is not None:
            role, token = fence
            if not self.fence_valid(role, token):
                self.fence_rejections[role] = (
                    self.fence_rejections.get(role, 0) + 1
                )
                raise ApiError(
                    "Conflict",
                    f"fenced: token {token} for role {role!r} is no "
                    f"longer valid (current {self._fences.get(role)}); "
                    "the incarnation lost its lease or was superseded",
                    fenced=True,
                )
        pod = self.get_pod(namespace, name)
        if not pod.node_name:
            raise ApiError(
                "Invalid", f"{pod.key} is not bound; nothing to evict"
            )
        if expect_rv is not None and pod.resource_version != expect_rv:
            raise ApiError(
                "Conflict",
                f"{pod.key} rv {pod.resource_version} != {expect_rv}",
            )
        matching = [
            pdb for pdb in self._pdbs.values() if pdb.matches(pod)
        ]
        for pdb in matching:
            if pdb.disruptions_allowed <= 0:
                raise ApiError(
                    "TooManyRequests",
                    f"cannot evict {pod.key}: PDB {pdb.key} has "
                    "disruptionsAllowed == 0",
                )
        for pdb in matching:
            pdb.disruptions_allowed -= 1
        source = pod.node_name
        self.record_event(
            pod, "Evicted",
            f"evicted from {source} by the rebalancer"
            + (f"; nominated toward {nominated_node}" if nominated_node else ""),
            action="Eviction",
        )
        # the delete half: nodeName still set, so every subscriber's
        # assigned-pod-delete path (cache release, occupancy fences,
        # fleet row withdraw, waking parked pods) runs unchanged. The
        # DELETED carries a SNAPSHOT of the pod — events hold their
        # object by reference, and a buffered consumer (the sim's
        # delayed watch bus) must still read the bound state at pump
        # time, after the recreate half below has mutated the live pod
        import dataclasses

        self._next_rv()
        self._emit("DELETED", "Pod", dataclasses.replace(pod))
        pod.node_name = ""
        pod.phase = "Pending"
        if nominated_node:
            pod.nominated_node_name = nominated_node
        pod.resource_version = self._next_rv()
        # the recreate half: an unbound ADDED re-admits the pod through
        # the ordinary queue-add routing (with the nomination indexed)
        self._emit("ADDED", "Pod", pod)
        # DRA deallocating-controller stand-in, same as delete_pod: an
        # evicted pod leaves every claim's reservedFor; a claim nobody
        # reserves loses its allocation, freeing the devices (the
        # recreated pod re-allocates at its next scheduling)
        if pod.resource_claim_names:
            for cname in pod.resource_claim_names:
                c = self._resource_claims.get(f"{namespace}/{cname}")
                if c is None or pod.key not in c.reserved_for:
                    continue
                c.reserved_for = tuple(
                    k for k in c.reserved_for if k != pod.key
                )
                if not c.reserved_for:
                    c.allocated_node = ""
                    c.results = ()
                c.resource_version = self._next_rv()
                self.dra_generation += 1
                self._emit("MODIFIED", "ResourceClaim", c)
        return pod

    # -- nodes --

    def create_node(self, node: Node) -> Node:
        if node.name in self._nodes:
            raise ApiError("AlreadyExists", node.name)
        node.resource_version = self._next_rv()
        self._nodes[node.name] = node
        self._emit("ADDED", "Node", node)
        return node

    def get_node(self, name: str) -> Node:
        try:
            return self._nodes[name]
        except KeyError:
            raise ApiError("NotFound", name) from None

    def update_node(self, node: Node, expect_rv: int | None = None) -> Node:
        cur = self.get_node(node.name)
        if expect_rv is not None and cur.resource_version != expect_rv:
            raise ApiError("Conflict", f"{node.name} rv {cur.resource_version} != {expect_rv}")
        node.resource_version = self._next_rv()
        self._nodes[node.name] = node
        self._emit("MODIFIED", "Node", node)
        return node

    def delete_node(self, name: str) -> None:
        node = self._nodes.pop(name, None)
        if node is None:
            raise ApiError("NotFound", name)
        self._next_rv()
        self._emit("DELETED", "Node", node)

    def list_nodes(self) -> list[Node]:
        return list(self._nodes.values())

    # -- PodDisruptionBudgets (policy/v1 slice preemption reads) --

    def create_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        if pdb.key in self._pdbs:
            raise ApiError("AlreadyExists", pdb.key)
        pdb.resource_version = self._next_rv()
        self._pdbs[pdb.key] = pdb
        return pdb

    def delete_pdb(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        if self._pdbs.pop(key, None) is None:
            raise ApiError("NotFound", key)
        self._next_rv()

    def list_pdbs(self) -> list[PodDisruptionBudget]:
        return list(self._pdbs.values())

    # -- Services (PodTopologySpread System-defaulting input) --

    def create_service(self, svc) -> object:
        if svc.key in self._services:
            raise ApiError("AlreadyExists", svc.key)
        svc.resource_version = self._next_rv()
        self._services[svc.key] = svc
        return svc

    def delete_service(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        if self._services.pop(key, None) is None:
            raise ApiError("NotFound", key)
        self._next_rv()

    def list_services(self) -> list:
        return list(self._services.values())

    # -- PersistentVolumes / Claims (volume plugin inputs) --

    def create_pv(self, pv: PersistentVolume) -> PersistentVolume:
        if pv.name in self._pvs:
            raise ApiError("AlreadyExists", pv.name)
        pv.resource_version = self._next_rv()
        self._pvs[pv.name] = pv
        return pv

    def list_pvs(self) -> list[PersistentVolume]:
        return list(self._pvs.values())

    def update_pv(self, pv: PersistentVolume) -> PersistentVolume:
        if pv.name not in self._pvs:
            raise ApiError("NotFound", pv.name)
        pv.resource_version = self._next_rv()
        self._pvs[pv.name] = pv
        return pv

    def create_pvc(self, pvc: PersistentVolumeClaim) -> PersistentVolumeClaim:
        if pvc.key in self._pvcs:
            raise ApiError("AlreadyExists", pvc.key)
        pvc.resource_version = self._next_rv()
        self._pvcs[pvc.key] = pvc
        return pvc

    def list_pvcs(self) -> list[PersistentVolumeClaim]:
        return list(self._pvcs.values())

    def update_pvc(self, pvc: PersistentVolumeClaim) -> PersistentVolumeClaim:
        if pvc.key not in self._pvcs:
            raise ApiError("NotFound", pvc.key)
        pvc.resource_version = self._next_rv()
        self._pvcs[pvc.key] = pvc
        return pvc

    # -- DRA: ResourceSlices / DeviceClasses / ResourceClaims --

    def create_resource_slice(self, s) -> object:
        if s.name in self._resource_slices:
            raise ApiError("AlreadyExists", s.name)
        s.resource_version = self._next_rv()
        self.dra_generation += 1
        self._resource_slices[s.name] = s
        self._emit("ADDED", "ResourceSlice", s)
        return s

    def delete_resource_slice(self, name: str) -> None:
        s = self._resource_slices.pop(name, None)
        if s is None:
            raise ApiError("NotFound", name)
        self._next_rv()
        self.dra_generation += 1
        self._emit("DELETED", "ResourceSlice", s)

    def list_resource_slices(self) -> list:
        return list(self._resource_slices.values())

    def create_device_class(self, dc) -> object:
        if dc.name in self._device_classes:
            raise ApiError("AlreadyExists", dc.name)
        dc.resource_version = self._next_rv()
        self.dra_generation += 1
        self._device_classes[dc.name] = dc
        self._emit("ADDED", "DeviceClass", dc)
        return dc

    def delete_device_class(self, name: str) -> None:
        dc = self._device_classes.pop(name, None)
        if dc is None:
            raise ApiError("NotFound", name)
        self._next_rv()
        self.dra_generation += 1
        self._emit("DELETED", "DeviceClass", dc)

    def list_device_classes(self) -> list:
        return list(self._device_classes.values())

    def create_resource_claim(self, c) -> object:
        if c.key in self._resource_claims:
            raise ApiError("AlreadyExists", c.key)
        c.resource_version = self._next_rv()
        self.dra_generation += 1
        self._resource_claims[c.key] = c
        self._emit("ADDED", "ResourceClaim", c)
        return c

    def get_resource_claim(self, namespace: str, name: str) -> object:
        key = f"{namespace}/{name}"
        try:
            return self._resource_claims[key]
        except KeyError:
            raise ApiError("NotFound", key) from None

    def update_resource_claim(self, c, expect_rv: int | None = None) -> object:
        cur = self._resource_claims.get(c.key)
        if cur is None:
            raise ApiError("NotFound", c.key)
        if expect_rv is not None and cur.resource_version != expect_rv:
            raise ApiError(
                "Conflict",
                f"{c.key} rv {cur.resource_version} != {expect_rv}",
            )
        c.resource_version = self._next_rv()
        self.dra_generation += 1
        self._resource_claims[c.key] = c
        self._emit("MODIFIED", "ResourceClaim", c)
        return c

    def delete_resource_claim(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        c = self._resource_claims.pop(key, None)
        if c is None:
            raise ApiError("NotFound", key)
        self._next_rv()
        self.dra_generation += 1
        self._emit("DELETED", "ResourceClaim", c)

    def list_resource_claims(self) -> list:
        return list(self._resource_claims.values())

    # -- Leases (coordination.k8s.io/v1 subset; leader election) --

    def create_lease(self, lease) -> object:
        import dataclasses

        if lease.key in self._leases:
            raise ApiError("AlreadyExists", lease.key)
        lease.resource_version = self._next_rv()
        self._leases[lease.key] = dataclasses.replace(lease)
        return lease

    def get_lease(self, namespace: str, name: str) -> object:
        """Returns a SNAPSHOT copy: electors mutate their read before the
        compare-and-swap update, and handing out the live object would
        let a losing challenger corrupt the store (the rv check must be
        the only write path)."""
        import dataclasses

        key = f"{namespace}/{name}"
        try:
            return dataclasses.replace(self._leases[key])
        except KeyError:
            raise ApiError("NotFound", key) from None

    def update_lease(self, lease, expect_rv: int | None = None) -> object:
        import dataclasses

        cur = self._leases.get(lease.key)
        if cur is None:
            raise ApiError("NotFound", lease.key)
        if expect_rv is not None and cur.resource_version != expect_rv:
            raise ApiError(
                "Conflict",
                f"{lease.key} rv {cur.resource_version} != {expect_rv}",
            )
        lease.resource_version = self._next_rv()
        self._leases[lease.key] = dataclasses.replace(lease)
        return lease

    def list_leases(self) -> list:
        import dataclasses

        return [dataclasses.replace(le) for le in self._leases.values()]

    # -- bulk helpers for benchmarks --

    def create_nodes(self, nodes: Iterable[Node]) -> None:
        for n in nodes:
            self.create_node(n)

    def create_pods(self, pods: Iterable[Pod]) -> None:
        for p in pods:
            self.create_pod(p)

    # -- events (events.k8s.io/v1 subset; SURVEY §6.5 events row) --

    def record_event(
        self,
        regarding: "Pod | Node",
        reason: str,
        note: str,
        type_: str = "Normal",
        action: str = "Scheduling",
        timestamp: float | None = None,
    ) -> EventRecord:
        """EventBroadcaster + correlator analog: repeats of the same
        (regarding, reason, note) bump count/lastTimestamp on the existing
        record (EventAggregator's dedup key, minus source — one scheduler
        here); new tuples create a record. Emits on the watch bus with
        kind="Event" either way."""
        ts = self.clock.now() if timestamp is None else timestamp
        # reference apiserver gives Events a TTL (1h default) instead of
        # durable storage. Pruning must not trust insertion order: a
        # count-bumped old record keeps a FRESH last_timestamp at the
        # head, so a head-stop sweep would block forever (review-caught).
        # Instead run a full sweep whenever the store doubles past the
        # last sweep's size — amortized O(1) per record, bounded memory —
        # OR when a full TTL has elapsed since the last sweep, so small
        # stores (below the size threshold) still expire records at most
        # one TTL late.
        if len(self._events) >= self._events_sweep_at or (
            self._events and ts - self._events_last_sweep > self.event_ttl
        ):
            self._events_last_sweep = ts
            cutoff = ts - self.event_ttl
            for rec in [
                r
                for r in self._events.values()
                if r.last_timestamp < cutoff
            ]:
                del self._events[rec.key]
                self._events_by_agg.pop(
                    (
                        rec.regarding_kind, rec.namespace,
                        rec.regarding_name, rec.reason, rec.note,
                    ),
                    None,
                )
            self._events_sweep_at = max(256, 2 * len(self._events))
        ns = getattr(regarding, "namespace", "") or "default"
        kind = "Pod" if isinstance(regarding, Pod) else "Node"
        agg_key = (kind, ns, regarding.name, reason, note)
        rec = self._events_by_agg.get(agg_key)
        if rec is not None:
            rec.count += 1
            rec.last_timestamp = ts
            rec.resource_version = self._next_rv()
            self._emit("MODIFIED", "Event", rec)
            return rec
        self._event_seq += 1
        rec = EventRecord(
            namespace=ns,
            regarding_kind=kind,
            regarding_namespace=ns if kind == "Pod" else "",
            regarding_name=regarding.name,
            reason=reason,
            note=note,
            type=type_,
            action=action,
            first_timestamp=ts,
            last_timestamp=ts,
            name=f"{regarding.name}.{self._event_seq:x}",
            resource_version=self._next_rv(),
        )
        self._events[rec.key] = rec
        self._events_by_agg[agg_key] = rec
        self._emit("ADDED", "Event", rec)
        return rec

    def list_events(
        self,
        namespace: str | None = None,
        regarding_name: str | None = None,
    ) -> list[EventRecord]:
        """List in creation order, optionally field-selected the way
        kubectl describe does (involvedObject.name=...)."""
        out = []
        for rec in self._events.values():
            if namespace is not None and rec.namespace != namespace:
                continue
            if (
                regarding_name is not None
                and rec.regarding_name != regarding_name
            ):
                continue
            out.append(rec)
        return out


def _locked(fn):
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)

    return wrapper


# Guard every public method with the instance RLock (reentrant: e.g. the
# scheduler's preemption path calls delete_pod while holding the lock
# across schedule_batch).
for _name, _fn in list(vars(ClusterState).items()):
    if _name.startswith("_") or not callable(_fn):
        continue
    setattr(ClusterState, _name, _locked(_fn))
del _name, _fn
