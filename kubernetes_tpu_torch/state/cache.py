"""Scheduler cache: the host shadow of cluster state that scheduling reads.

Reference semantics (pkg/scheduler/backend/cache/cache.go#cacheImpl):
- truth = scheduled pods (observed via watch) + **assumed** pods (optimistic
  placements made before the API bind lands, so the next pod's cycle sees
  them — the mechanism that makes overlapping bind goroutines safe);
- AssumePod / ForgetPod / FinishBinding(+TTL expiry): an assumed pod whose
  bind confirmation never arrives expires after ``assume_ttl`` and its
  resources are released (crash/requeue safety, SURVEY §6.3);
- per-node **generation** counters: every mutation bumps the node's
  generation from a global monotonic counter; snapshot updates copy only
  nodes whose generation is newer than the snapshot's (cache.go#UpdateSnapshot
  incremental O(changed) contract — here it becomes a dirty-column scatter
  into the device tensors, state/snapshot.py).

HostNodeInfo mirrors framework/types.go#NodeInfo's running sums (Requested /
NonZeroRequested / pod count) so column refreshes are O(K), not O(pods).

Copied from ``kubernetes_tpu/state/cache.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.objects import Node, Pod
from ..utils.clock import Clock


class CacheError(Exception):
    pass


@dataclass
class HostNodeInfo:
    node: Node | None  # None => node deleted but assumed/bound pods remain
    generation: int
    pods: dict[str, Pod] = field(default_factory=dict)
    used: dict[str, int] = field(default_factory=dict)
    nonzero_cpu: int = 0
    nonzero_mem: int = 0
    pods_with_affinity: int = 0
    pods_with_required_anti_affinity: int = 0

    def add_pod(self, pod: Pod) -> None:
        self.pods[pod.key] = pod
        for k, v in pod.resource_request().items():
            self.used[k] = self.used.get(k, 0) + v
        nz_cpu, nz_mem = pod.non_zero_request()
        self.nonzero_cpu += nz_cpu
        self.nonzero_mem += nz_mem
        aff = pod.affinity
        if aff and (aff.pod_affinity or aff.pod_anti_affinity):
            self.pods_with_affinity += 1
        if aff and aff.pod_anti_affinity and aff.pod_anti_affinity.required:
            self.pods_with_required_anti_affinity += 1

    def remove_pod(self, pod_key: str) -> Pod:
        pod = self.pods.pop(pod_key)
        for k, v in pod.resource_request().items():
            self.used[k] = self.used.get(k, 0) - v
        nz_cpu, nz_mem = pod.non_zero_request()
        self.nonzero_cpu -= nz_cpu
        self.nonzero_mem -= nz_mem
        aff = pod.affinity
        if aff and (aff.pod_affinity or aff.pod_anti_affinity):
            self.pods_with_affinity -= 1
        if aff and aff.pod_anti_affinity and aff.pod_anti_affinity.required:
            self.pods_with_required_anti_affinity -= 1
        return pod


@dataclass
class _AssumedInfo:
    node_name: str
    binding_finished: bool = False
    deadline: float | None = None  # set by FinishBinding
    assumed_at: float = 0.0  # when the assume landed (unfinished reap)


class SchedulerCache:
    def __init__(self, clock: Clock | None = None, assume_ttl: float = 30.0):
        self._clock = clock or Clock()
        self._ttl = assume_ttl
        self._generation = 0
        self.nodes: dict[str, HostNodeInfo] = {}
        self._assumed: dict[str, _AssumedInfo] = {}
        # where each cached pod currently lives (node name), incl. assumed
        self._pod_node: dict[str, str] = {}

    # -- generation --

    def _bump(self, info: HostNodeInfo) -> None:
        self._generation += 1
        info.generation = self._generation

    @property
    def generation(self) -> int:
        return self._generation

    # -- assume / forget / confirm (schedule_one.go#assume + cache protocol) --

    def assume_pod(self, pod: Pod, node_name: str) -> None:
        if pod.key in self._pod_node:
            raise CacheError(f"pod {pod.key} already assumed/added")
        info = self.nodes.get(node_name)
        if info is None or info.node is None:
            raise CacheError(f"assume on unknown node {node_name}")
        info.add_pod(pod)
        self._bump(info)
        self._pod_node[pod.key] = node_name
        self._assumed[pod.key] = _AssumedInfo(
            node_name, assumed_at=self._clock.now()
        )

    def forget_pod(self, pod_key: str) -> None:
        """Bind failed: release the optimistic placement."""
        assumed = self._assumed.pop(pod_key, None)
        if assumed is None:
            raise CacheError(f"pod {pod_key} not assumed")
        self._remove_from_node(pod_key)

    def finish_binding(self, pod_key: str) -> None:
        a = self._assumed.get(pod_key)
        if a is not None:
            a.binding_finished = True
            a.deadline = self._clock.now() + self._ttl

    def is_assumed(self, pod_key: str) -> bool:
        return pod_key in self._assumed

    def cleanup_expired(self, protected: frozenset = frozenset()) -> list[str]:
        """Expire assumed pods whose bind confirmation never arrived
        (cache.go#cleanupAssumedPods). Returns expired pod keys.

        Two populations expire:

        - **finished** assumes (FinishBinding ran) past their deadline —
          the bind landed but the confirming watch event never arrived;
        - **unfinished** assumes older than the TTL — the binding cycle
          died between assume and finish (a crashed commit thread, an
          unwound exception path): without this arm the leaked assume
          holds phantom occupancy forever (pre-PR-8 gap: this reap both
          didn't cover them and was never even called by the
          scheduler). ``protected`` exempts pods legitimately parked
          assumed-unfinished across cycles — the Permit WaitingPods map
          — whose rollback deadline is the permit timeout, not the
          assume TTL."""
        now = self._clock.now()
        expired = [
            k
            for k, a in self._assumed.items()
            if (
                a.binding_finished
                and a.deadline is not None
                and a.deadline <= now
            )
            or (
                not a.binding_finished
                and k not in protected
                and now - a.assumed_at > self._ttl
            )
        ]
        for k in expired:
            self._assumed.pop(k)
            self._remove_from_node(k)
        return expired

    # -- watch-event handlers (eventhandlers.go semantics) --

    def add_pod(self, pod: Pod) -> None:
        """An assigned pod appeared (or bind confirmation arrived)."""
        key = pod.key
        if key in self._assumed:
            assumed_node = self._assumed[key].node_name
            self._assumed.pop(key)
            if assumed_node != pod.node_name:
                # scheduled somewhere else than we assumed: move it
                self._remove_from_node(key)
                self._add_to_node(pod)
            else:
                # confirm: swap the stored object for the API one (same sums)
                info = self.nodes[pod.node_name]
                info.pods[key] = pod
                self._bump(info)
        elif key in self._pod_node:
            raise CacheError(f"pod {key} added twice")
        else:
            self._add_to_node(pod)

    def pod_node(self, pod_key: str) -> str | None:
        """Node the cache currently holds this assigned pod on (None if
        unknown) — lets event handlers compare the cached object against
        an incoming update without reaching into node internals."""
        return self._pod_node.get(pod_key)

    def update_pod(self, pod: Pod) -> None:
        old_node = self._pod_node.get(pod.key)
        if old_node is None:
            self.add_pod(pod)
            return
        self._remove_from_node(pod.key)
        self._add_to_node(pod)

    def remove_pod(self, pod_key: str) -> None:
        self._assumed.pop(pod_key, None)
        if pod_key in self._pod_node:
            self._remove_from_node(pod_key)

    def _add_to_node(self, pod: Pod) -> None:
        name = pod.node_name
        info = self.nodes.get(name)
        if info is None:
            # pod observed before its node (reference tolerates this with an
            # imaginary node entry that materializes when the node arrives)
            info = HostNodeInfo(node=None, generation=0)
            self.nodes[name] = info
        info.add_pod(pod)
        self._bump(info)
        self._pod_node[pod.key] = name

    def _remove_from_node(self, pod_key: str) -> None:
        name = self._pod_node.pop(pod_key)
        info = self.nodes[name]
        info.remove_pod(pod_key)
        self._bump(info)
        if info.node is None and not info.pods:
            del self.nodes[name]

    def add_node(self, node: Node) -> None:
        info = self.nodes.get(node.name)
        if info is None:
            info = HostNodeInfo(node=node, generation=0)
            self.nodes[node.name] = info
        else:
            info.node = node
        self._bump(info)

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        info = self.nodes.get(name)
        if info is None:
            return
        if info.pods:
            info.node = None  # keep resource bookkeeping for remaining pods
            self._bump(info)
        else:
            del self.nodes[name]
