"""Consistent node-partition ring for the fleet tier: a deterministic,
zone-affine, balance-capped assignment of cluster nodes to scheduler
replicas.

Requirements:

- **deterministic** — the partition is a pure function of (node set,
  configured replica universe, alive subset): blake2b-keyed hashing and
  sorted iteration everywhere, no dependence on insertion order or
  PYTHONHASHSEED, so every replica computes the identical partition
  independently with no coordination;
- **zone-keyed affinity** — nodes sharing a topology zone share one
  replica-preference chain and are laid out contiguously in the
  canonical order, so a zone lands on as few replicas as balance
  allows (cross-shard ``PodTopologySpread`` domains — the constraint
  family the reconciliation round exists for — are minimized at the
  partitioning layer);
- **balanced** — no replica owns more than ``ceil(K / N_alive)``
  nodes, so a replica's shard (and therefore its per-batch solve cost)
  is bounded by construction, and losing one replica orphans at most a
  1/N-ish slice of the cluster (blast-radius isolation);
- **bounded remap** — one replica joining or leaving remaps at most
  ``ceil(K / N)`` nodes (tests/test_fleet_ring.py).

The bound is structural, not probabilistic. A membership change in a
lease-based fleet is an *availability* change against a configured
universe (a replica's per-shard lease expires, or a restarted replica
re-acquires it), so the partition is two-layered:

1. **base partition** — a greedy capacity-capped rendezvous fill of
   all nodes over the full configured universe, in canonical zone
   order. Fixed for a fixed universe: it never moves at runtime.
2. **orphan redistribution** — nodes whose base owner is dead are
   re-dealt over the alive replicas (zone-keyed rendezvous chains,
   capacity ``ceil(K / N_alive)``). Alive replicas always keep their
   base nodes (base load ``<= ceil(K / N_universe) <=`` any alive cap),
   so a single leave moves exactly the leaver's owned nodes and a
   single rejoin moves exactly the nodes that had been redistributed —
   both ``<= ceil(K / N)``.

Growing the universe itself (scale-out from N to N+1 *configured*
replicas) recomputes the base partition and is a deploy-time
repartition, not a runtime membership event; the remap bound applies
to runtime join/leave only.

Copied from ``kubernetes_tpu/fleet/ring.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterable, Mapping

ZONE_LABEL = "topology.kubernetes.io/zone"


def _h(*parts: str) -> int:
    """Stable 64-bit hash of joined parts (PYTHONHASHSEED-immune)."""
    d = hashlib.blake2b(
        "\x1f".join(parts).encode(), digest_size=8
    ).digest()
    return int.from_bytes(d, "little")


@dataclass(frozen=True)
class RingNode:
    """One placeable node as the ring sees it: name + zone key (empty
    when the node carries no zone label — such nodes get per-node
    preference chains instead of a shared zone chain)."""

    name: str
    zone: str = ""


class HashRing:
    """The fleet's node partitioner. Stateless: ``assign`` recomputes
    the full partition from (universe, alive) membership; callers diff
    the result against their previous view to find the (bounded)
    remap set."""

    def __init__(
        self, universe: Iterable[str], alive: Iterable[str] | None = None
    ) -> None:
        self.universe = tuple(sorted(set(universe)))
        if not self.universe:
            raise ValueError("ring needs at least one configured replica")
        self.alive = (
            self.universe
            if alive is None
            else tuple(sorted(set(alive) & set(self.universe)))
        )
        if not self.alive:
            raise ValueError("ring needs at least one alive replica")

    def with_alive(self, alive: Iterable[str]) -> "HashRing":
        return HashRing(self.universe, alive)

    # -- preference chains --

    @staticmethod
    def _prefs(key: str, replicas: tuple[str, ...]) -> list[str]:
        """Rendezvous ranking of ``replicas`` for one zone (or zoneless
        node) key: highest blake2b(key, replica) wins. Stable under
        membership change: restricting the replica set drops entries
        from the chain without reordering the rest."""
        return sorted(replicas, key=lambda r: (-_h(key, r), r))

    @staticmethod
    def _chain_key(node: RingNode) -> str:
        return node.zone if node.zone else f"\x00node\x1f{node.name}"

    @staticmethod
    def canonical_order(nodes: Iterable[RingNode]) -> list[RingNode]:
        """Zone-contiguous canonical order: zones sort by hash (so the
        fill order is uncorrelated with zone naming), nodes within a
        zone by hash-then-name. Every replica iterates nodes in exactly
        this order, which is what makes the greedy capped fill a pure
        function of membership."""
        return sorted(
            nodes,
            key=lambda n: (
                _h("zone", n.zone), n.zone, _h("node", n.name), n.name,
            ),
        )

    def _fill(
        self,
        ordered: list[RingNode],
        replicas: tuple[str, ...],
        cap: int,
        load: dict[str, int],
        out: dict[str, str],
    ) -> None:
        """Greedy capacity-capped rendezvous fill of ``ordered`` over
        ``replicas``: each node goes to the first replica in its
        zone-keyed preference chain with remaining capacity."""
        pref_cache: dict[str, list[str]] = {}
        for node in ordered:
            key = self._chain_key(node)
            prefs = pref_cache.get(key)
            if prefs is None:
                prefs = self._prefs(key, replicas)
                pref_cache[key] = prefs
            for r in prefs:
                if load[r] < cap:
                    load[r] += 1
                    out[node.name] = r
                    break

    # -- the partition --

    def assign(self, nodes: Iterable[RingNode]) -> dict[str, str]:
        """node name -> alive replica id for the full node set."""
        ordered = self.canonical_order(nodes)
        k = len(ordered)
        if k == 0:
            return {}
        # layer 1: the base partition over the full universe (cap
        # ceil(K / N_universe)); total capacity >= K, the fill always
        # succeeds
        base: dict[str, str] = {}
        base_load = {r: 0 for r in self.universe}
        self._fill(
            ordered, self.universe, -(-k // len(self.universe)),
            base_load, base,
        )
        if self.alive == self.universe:
            return base
        # layer 2: redistribute orphans (nodes whose base owner is
        # dead) over the alive set. Alive base assignments are kept
        # verbatim — base load <= ceil(K/N_universe) <= alive cap, so
        # they can never be displaced — which is exactly what bounds a
        # single leave/rejoin to the departed replica's own share.
        alive = set(self.alive)
        cap = -(-k // len(self.alive))
        out: dict[str, str] = {}
        load = {r: 0 for r in self.alive}
        orphans: list[RingNode] = []
        for node in ordered:
            owner = base[node.name]
            if owner in alive:
                out[node.name] = owner
                load[owner] += 1
            else:
                orphans.append(node)
        self._fill(orphans, self.alive, cap, load, out)
        # a pathological chain restriction could leave an orphan's
        # whole chain at cap when zones are few and lopsided; total
        # capacity still covers K, so sweep into any remaining room
        for node in orphans:
            if node.name not in out:
                r = min(
                    (r for r in self.alive if load[r] < cap),
                    key=lambda r: (-_h(self._chain_key(node), r), r),
                )
                load[r] += 1
                out[node.name] = r
        return out

    def owner(self, assignment: Mapping[str, str], name: str) -> str | None:
        return assignment.get(name)

    # -- pod routing (the queue partition) --

    def route(self, pod_key: str) -> str:
        """Unbound-pod routing: rendezvous over the pod key and the
        ALIVE set, no capacity cap (pods are transient queue entries,
        not owned state). Every replica computes the same route, so
        exactly one alive replica enqueues each pending pod."""
        return max(self.alive, key=lambda r: (_h("pod", pod_key, r), r))


def ring_nodes_from(nodes: Iterable) -> list[RingNode]:
    """Adapt api.objects.Node instances (anything with ``name`` and
    ``labels``) to RingNodes, zone-keyed on the well-known label."""
    return [
        RingNode(name=n.name, zone=n.labels.get(ZONE_LABEL, ""))
        for n in nodes
    ]
