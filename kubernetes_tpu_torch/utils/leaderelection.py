"""Lease-based leader election — the client-go
tools/leaderelection analog (SURVEY §3.3: active/passive HA; losing the
lease exits the process).

Mirrors leaderelection.go#tryAcquireOrRenew over a coordination.k8s.io/v1
Lease subset stored in the cluster state service with optimistic
concurrency: the holder renews ``renewTime`` every ``retry_period``;
challengers take over only when ``renewTime + lease_duration`` has
passed; a holder that cannot renew within ``renew_deadline`` reports
leadership lost (the reference's OnStoppedLeading → process exit).

Copied from ``kubernetes_tpu/utils/leaderelection.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..state.cluster import ApiError, ClusterState
from .clock import Clock


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease subset (spec fields the elector
    uses)."""

    name: str
    namespace: str = "kube-system"
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def to_dict(self) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "resourceVersion": str(self.resource_version),
            },
            "spec": {
                "holderIdentity": self.holder_identity,
                "leaseDurationSeconds": int(self.lease_duration_seconds),
                "acquireTime": self.acquire_time,
                "renewTime": self.renew_time,
            },
        }


@dataclass
class LeaderElector:
    cluster: ClusterState
    identity: str
    name: str = "kubernetes-tpu-scheduler"
    namespace: str = "kube-system"
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    clock: Clock = field(default_factory=Clock)
    is_leader: bool = False
    # fleet mode (the fleet/ package): per-shard lease identity.
    # Replica i of an active-active fleet elects on its OWN lease
    # ``<name>-shard-<i>`` instead of contending with its peers on one
    # global lease — N replicas hold N leases concurrently, and a
    # shard lease going stale is exactly the membership signal
    # FleetMembership.refresh_from_leases reads. None = the classic
    # single active/passive lease.
    shard: int | None = None

    def __post_init__(self) -> None:
        """leaderelection.go#LeaderElectionConfig validation: the
        protocol is only sound when leaseDuration > renewDeadline >
        retryPeriod (all positive) — a renew deadline at or beyond the
        lease duration lets a challenger take over while the holder
        still believes it leads, and a retry period at or beyond the
        renew deadline guarantees missing the deadline on one lost
        renewal."""
        if self.retry_period <= 0:
            raise ValueError(
                f"retry_period must be positive, got {self.retry_period}"
            )
        if self.renew_deadline <= self.retry_period:
            raise ValueError(
                "renew_deadline must exceed retry_period "
                f"({self.renew_deadline} <= {self.retry_period})"
            )
        if self.lease_duration <= self.renew_deadline:
            raise ValueError(
                "lease_duration must exceed renew_deadline "
                f"({self.lease_duration} <= {self.renew_deadline})"
            )
        if self.shard is not None:
            if self.shard < 0:
                raise ValueError(
                    f"shard must be non-negative, got {self.shard}"
                )
            self.name = f"{self.name}-shard-{self.shard}"

    @property
    def _key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def try_acquire_or_renew(self) -> bool:
        """One tryAcquireOrRenew step: True iff this identity holds the
        lease afterwards. Optimistic-concurrency conflicts report False
        (the caller retries next period, like the reference)."""
        now = self.clock.now()
        try:
            lease = self.cluster.get_lease(self.namespace, self.name)
        except ApiError:
            lease = Lease(
                name=self.name,
                namespace=self.namespace,
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration,
                acquire_time=now,
                renew_time=now,
            )
            try:
                self.cluster.create_lease(lease)
            except ApiError:
                self.is_leader = False
                return False  # lost the creation race
            self.is_leader = True
            return True
        if (
            lease.holder_identity
            and lease.holder_identity != self.identity
            and now < lease.renew_time + lease.lease_duration_seconds
        ):
            self.is_leader = False
            return False  # held by a live leader
        expect = lease.resource_version
        if lease.holder_identity != self.identity:
            lease.acquire_time = now
        lease.holder_identity = self.identity
        lease.lease_duration_seconds = self.lease_duration
        lease.renew_time = now
        try:
            self.cluster.update_lease(lease, expect_rv=expect)
        except ApiError:
            self.is_leader = False
            return False  # someone else won the update race
        self.is_leader = True
        return True

    def run(
        self,
        stop: threading.Event,
        on_started_leading=None,
        on_stopped_leading=None,
    ) -> None:
        """RunOrDie's loop shape: block acquiring, call
        ``on_started_leading`` once, renew every retry_period; when a
        renewal hasn't succeeded within renew_deadline (or the lease was
        taken), call ``on_stopped_leading`` and return — the caller is
        expected to exit, like the reference."""
        while not stop.is_set():
            if self.try_acquire_or_renew():
                break
            if stop.wait(self.retry_period):
                return
        if stop.is_set():
            return
        if on_started_leading is not None:
            on_started_leading()
        # one timebase for the whole protocol: the injected clock stamps
        # lease renewals AND measures the renew deadline, so holder
        # self-demotion and challenger takeover can't drift apart (and
        # the loss path is drivable with a fake clock)
        last_renew = self.clock.now()
        while not stop.is_set():
            if stop.wait(self.retry_period):
                return
            if self.try_acquire_or_renew():
                last_renew = self.clock.now()
            elif self.clock.now() - last_renew > self.renew_deadline:
                self.is_leader = False
                if on_stopped_leading is not None:
                    on_stopped_leading()
                return
