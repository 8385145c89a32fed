"""Cross-shard reconciliation: the pre-commit recheck that makes
sharded solving safe for constraints whose scope crosses the node
partition.

The device solve enforces every constraint *within* a shard (its
snapshot holds only owned nodes). Two constraint families can still be
violated *between* shards:

- **PodTopologySpread** — domain counts are global: a zone's (or, for
  hostname-keyed constraints, a node's) matching-pod count includes
  pods placed by every replica, and the ``maxSkew`` bound compares
  against the global minimum domain — including peer domains this
  replica owns no node of;
- **required inter-pod anti-affinity with a non-hostname topology
  key** — a zone-scoped anti term can match a pod a peer placed in the
  same zone. (Hostname-keyed anti terms cannot cross shards: node
  ownership is disjoint, so co-residence is always intra-shard.)

``admit`` re-checks exactly these against (a) this replica's own cache
— which already counts the batch's earlier assumes — and (b) the peer
rows from the occupancy exchange. A conflicting placement is rejected
host-side and the pod retries through the ordinary
unschedulable-requeue machinery (the fleet's Conflict-on-stale
analog): no global lock, no fleet-wide barrier.

Deliberate scope (documented, mirrored in README):

- domain eligibility is not re-filtered by the pod's node affinity —
  an extra empty domain can only *lower* the observed minimum, so the
  recheck errs conservative (rejects, retries later), never unsafe;
- the symmetric direction of zone-scoped anti-affinity (an already
  placed pod whose anti term matches the incoming pod) is not checked
  across shards: peer rows carry labels, not terms. Hostname-keyed
  terms — the overwhelmingly common case, and the only kind the sim
  generates — are unaffected.

Copied from ``kubernetes_tpu/fleet/reconciler.py``.
"""

from __future__ import annotations

from typing import Iterable

from ..api.objects import Pod
from .occupancy import PeerView, PodRow

HOSTNAME_KEY = "kubernetes.io/hostname"
ZONE_KEY = "topology.kubernetes.io/zone"


def _sel_matches(selector, labels: dict) -> bool:
    from ..ops.oracle import spread as osp

    return osp._sel_matches(selector, labels)


def _domain_of(topology_key: str, node_name: str, zone: str) -> str | None:
    """Map a placement's (node, zone) to its domain value under one
    topology key. Only the two well-known keys cross the wire (rows
    carry node + zone); anything else is unknowable here."""
    if topology_key == HOSTNAME_KEY:
        return node_name
    if topology_key == ZONE_KEY:
        return zone or None
    return None


class CrossShardReconciler:
    def __init__(self, self_id: str) -> None:
        self.self_id = self_id

    # -- helpers over the two occupancy sources --

    @staticmethod
    def _local_placements(cache) -> Iterable[tuple[Pod, str, str]]:
        """(pod, node, zone) for every placed/assumed pod in the
        shard-scoped cache."""
        for name in sorted(cache.nodes):
            info = cache.nodes[name]
            if info.node is None:
                continue
            zone = info.node.labels.get(ZONE_KEY, "")
            for key in sorted(info.pods):
                yield info.pods[key], name, zone

    def _spread_conflict(
        self, pod: Pod, node_name: str, node_zone: str, cache, peers: PeerView
    ) -> str | None:
        constraints = [
            c
            for c in pod.topology_spread_constraints
            if c.when_unsatisfiable == "DoNotSchedule"
            and c.topology_key in (HOSTNAME_KEY, ZONE_KEY)
        ]
        if not constraints:
            return None
        # materialize both occupancy sources once per admit
        local = list(self._local_placements(cache))
        for c in constraints:
            target = _domain_of(c.topology_key, node_name, node_zone)
            if target is None:
                continue
            counts: dict[str, int] = {}
            # domain inventory: my nodes + peer node rows
            for name in sorted(cache.nodes):
                info = cache.nodes[name]
                if info.node is None:
                    continue
                d = _domain_of(
                    c.topology_key, name,
                    info.node.labels.get(ZONE_KEY, ""),
                )
                if d is not None:
                    counts.setdefault(d, 0)
            for nr in peers.node_rows:
                d = _domain_of(c.topology_key, nr.node, nr.zone)
                if d is not None:
                    counts.setdefault(d, 0)
            if target not in counts:
                counts[target] = 0
            # matching-pod counts: my cache + peer pod rows
            for q, qnode, qzone in local:
                if q.namespace != pod.namespace:
                    continue
                if not _sel_matches(c.label_selector, q.labels):
                    continue
                d = _domain_of(c.topology_key, qnode, qzone)
                if d is not None and d in counts:
                    counts[d] += 1
            for row in peers.pod_rows:
                if row.namespace != pod.namespace:
                    continue
                if not _sel_matches(c.label_selector, dict(row.labels)):
                    continue
                d = _domain_of(c.topology_key, row.node, row.zone)
                if d is not None and d in counts:
                    counts[d] += 1
            global_min = min(counts.values())
            if counts[target] + 1 - global_min > c.max_skew:
                return (
                    "cross-shard topology spread would exceed maxSkew="
                    f"{c.max_skew} for {c.topology_key}={target} "
                    f"(count {counts[target]} vs fleet minimum {global_min})"
                )
        return None

    def _anti_conflict(
        self, pod: Pod, node_zone: str, peers: PeerView
    ) -> str | None:
        anti = pod.affinity.pod_anti_affinity if pod.affinity else None
        if anti is None or not anti.required:
            return None
        for term in anti.required:
            if term.topology_key == HOSTNAME_KEY:
                continue  # intra-shard by construction (disjoint nodes)
            if term.topology_key != ZONE_KEY or term.label_selector is None:
                continue
            for row in peers.pod_rows:
                if row.zone != node_zone or not node_zone:
                    continue
                if not term.matches_namespace(pod.namespace, row.namespace):
                    continue
                if term.label_selector.matches(dict(row.labels)):
                    return (
                        "cross-shard anti-affinity: peer pod "
                        f"{row.pod} in zone {node_zone} matches a "
                        "required anti term"
                    )
        return None

    def admit(
        self, pod: Pod, node_name: str, node_zone: str, cache, peers: PeerView
    ) -> str | None:
        """None = the placement holds fleet-wide; otherwise a reason
        string (the pod requeues and retries)."""
        why = self._spread_conflict(pod, node_name, node_zone, cache, peers)
        if why is not None:
            return why
        return self._anti_conflict(pod, node_zone, peers)
