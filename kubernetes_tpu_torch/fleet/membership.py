"""Fleet membership: which configured replicas are alive.

The fleet's membership model is availability against a **configured
universe** (``--fleet-replicas`` at deploy time), which is what makes
the ring's remap bound structural (fleet/ring.py): a replica joining or
leaving at runtime is a lease event, not a repartition.

Liveness rides the per-shard leases the LeaderElector satellite added
(utils/leaderelection.py ``shard=``): replica ``i`` holds
``<lease>-shard-<i>``; a peer is alive while its shard lease is held
and fresh. ``refresh_from_leases`` is the production poll; the sim
drives ``set_alive`` directly (deterministic membership transitions).
Every view change bumps ``version`` so callers know to resync their
shard-scoped caches.

Copied from ``kubernetes_tpu/fleet/membership.py``.
"""

from __future__ import annotations

from typing import Iterable

from ..state.cluster import ApiError, ClusterState


def shard_index(universe: tuple[str, ...], replica: str) -> int:
    """A replica's shard number = its rank in the sorted universe (the
    suffix of its per-shard lease name)."""
    return universe.index(replica)


class FleetMembership:
    def __init__(self, universe: Iterable[str], self_id: str) -> None:
        self.universe = tuple(sorted(set(universe)))
        if self_id not in self.universe:
            raise ValueError(
                f"replica {self_id!r} is not in the configured universe "
                f"{self.universe}"
            )
        self.self_id = self_id
        self._alive = set(self.universe)
        self.version = 0

    def alive(self) -> tuple[str, ...]:
        return tuple(sorted(self._alive))

    def is_alive(self, replica: str) -> bool:
        return replica in self._alive

    def set_alive(self, replicas: Iterable[str]) -> bool:
        """Replace the alive view; self is always a member (a replica
        that has lost its own lease exits instead of demoting itself
        here). Returns True (and bumps version) when the view
        changed."""
        new = (set(replicas) & set(self.universe)) | {self.self_id}
        if new == self._alive:
            return False
        self._alive = new
        self.version += 1
        return True

    def mark_dead(self, replica: str) -> bool:
        if replica == self.self_id:
            return False
        return self.set_alive(self._alive - {replica})

    def mark_alive(self, replica: str) -> bool:
        return self.set_alive(self._alive | {replica})

    def refresh_from_leases(
        self,
        cluster: ClusterState,
        base_name: str,
        now: float,
        namespace: str = "kube-system",
    ) -> bool:
        """Production liveness poll: peer ``r`` (shard ``i``) is alive
        while lease ``<base>-shard-<i>`` is held by ``r`` and its
        ``renewTime + leaseDurationSeconds`` has not passed — the same
        takeover criterion LeaderElector applies. A missing lease means
        the replica never started: dead."""
        alive = {self.self_id}
        for i, replica in enumerate(self.universe):
            if replica == self.self_id:
                continue
            try:
                lease = cluster.get_lease(
                    namespace, f"{base_name}-shard-{i}"
                )
            except ApiError:
                continue
            if (
                lease.holder_identity == replica
                and now < lease.renew_time + lease.lease_duration_seconds
            ):
                alive.add(replica)
        return self.set_alive(alive)
