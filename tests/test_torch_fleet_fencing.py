"""Commit-path fencing tokens + occupancy-staleness bounds +
watch-delivery isolation (partition-safety layer).

The fencing-token pattern: every scheduler incarnation binds under a
(role, token) pair granted at the state service; revoking or
re-granting the role fences every outstanding holder — a zombie
(lease-lost, partitioned, or superseded) incarnation's commits reject
with Conflict no matter what its stale cache believes."""

import json

from kubernetes_tpu_torch.api.wrappers import MakeNode, MakePod
from kubernetes_tpu_torch.fleet import FleetConfig, OccupancyExchange
from kubernetes_tpu_torch.fleet.occupancy import (
    ExchangeUnreachable,
    NodeRow,
    PodRow,
)
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ApiError, ClusterState
from kubernetes_tpu_torch.utils.clock import FakeClock

import pytest


def _node(name="n", cpu="4"):
    return (
        MakeNode()
        .name(name)
        .capacity({"cpu": cpu, "memory": "8Gi", "pods": "10"})
        .obj()
    )


def _cfg(**kw):
    kw.setdefault("solver", ExactSolverConfig(tie_break="first"))
    return SchedulerConfig(**kw)


# -- ClusterState fencing tokens --


class TestFenceTokens:
    def test_grant_and_bind(self):
        cs = ClusterState()
        cs.create_node(_node())
        cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
        token = cs.grant_fence("sched", holder="inc-1")
        cs.bind("default", "p", "n", fence=("sched", token))
        assert cs.get_pod("default", "p").node_name == "n"

    def test_revoked_token_rejected_with_conflict(self):
        cs = ClusterState()
        cs.create_node(_node())
        cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
        token = cs.grant_fence("sched")
        cs.revoke_fence("sched")
        with pytest.raises(ApiError) as exc:
            cs.bind("default", "p", "n", fence=("sched", token))
        assert exc.value.reason == "Conflict"
        assert "fenced" in str(exc.value)
        assert cs.get_pod("default", "p").node_name == ""  # never landed
        assert cs.fence_rejections["sched"] == 1

    def test_regrant_supersedes_old_holder(self):
        cs = ClusterState()
        cs.create_node(_node())
        cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
        old = cs.grant_fence("sched", holder="inc-1")
        new = cs.grant_fence("sched", holder="inc-2")
        with pytest.raises(ApiError):
            cs.bind("default", "p", "n", fence=("sched", old))
        cs.bind("default", "p", "n", fence=("sched", new))
        assert cs.get_pod("default", "p").node_name == "n"

    def test_fence_checked_before_anything_else(self):
        """A fenced bind rejects even for a deleted pod / missing node:
        the authority refuses the zombie outright."""
        cs = ClusterState()
        token = cs.grant_fence("sched")
        cs.revoke_fence("sched")
        with pytest.raises(ApiError) as exc:
            cs.bind("default", "ghost", "nowhere", fence=("sched", token))
        assert "fenced" in str(exc.value)


# -- Scheduler-level fencing --


class TestSchedulerFencing:
    def test_superseded_incarnation_cannot_bind(self):
        """A new incarnation acquiring the same fence role structurally
        fences the old one: its approved binds all fail with Conflict,
        the metric ticks, and the pods requeue instead of double-
        binding."""
        from kubernetes_tpu_torch import metrics

        clock = FakeClock()
        cs = ClusterState()
        cs.create_node(_node(cpu="8"))
        s1 = Scheduler(cs, _cfg(fence_role="sched"), clock=clock, device="cpu")
        before = metrics.commit_fenced_total._value.get()

        # incarnation 2 takes over the role: s1 is now a zombie
        cs.unsubscribe(s1._on_event)  # (keep s1 driveable standalone)
        s2 = Scheduler(
            cs, _cfg(fence_role="sched", incarnation=2), clock=clock, device="cpu"
        )
        cs.unsubscribe(s2._on_event)
        cs.subscribe(s1._on_event)  # the zombie still watches

        cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
        r = s1.schedule_batch()
        assert r.scheduled == []
        assert [k for k, _ in r.bind_failures] == ["default/p"]
        assert cs.get_pod("default", "p").node_name == ""
        assert s1._fenced_commits == 1
        assert metrics.commit_fenced_total._value.get() == before + 1
        # the pod requeued (backoff) — not lost
        assert len(s1.queue) == 1

    def test_reacquire_fence_restores_commits(self):
        clock = FakeClock()
        cs = ClusterState()
        cs.create_node(_node())
        s1 = Scheduler(cs, _cfg(fence_role="sched"), clock=clock, device="cpu")
        cs.revoke_fence("sched")
        cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
        r = s1.schedule_batch()
        assert r.scheduled == [] and s1._fenced_commits == 1
        s1.reacquire_fence()
        # the fenced pod parked unschedulable: the 5-minute leftover
        # flush is its guaranteed retry path (no waking cluster event)
        clock.advance(301.0)
        r = s1.schedule_batch()
        assert dict(r.scheduled).get("default/p") == "n"

    def test_no_fence_role_means_no_fencing(self):
        cs = ClusterState()
        cs.create_node(_node())
        s = Scheduler(cs, _cfg(), clock=FakeClock(), device="cpu")
        assert s._fence_role is None
        cs.create_pod(MakePod().name("p").req({"cpu": "1"}).obj())
        assert dict(s.schedule_batch().scheduled).get("default/p") == "n"


# -- watch-bus delivery isolation --


class TestWatchDeliveryIsolation:
    def test_bad_subscriber_does_not_block_delivery(self):
        from kubernetes_tpu_torch import metrics

        cs = ClusterState()
        seen_first, seen_last = [], []

        def bad(ev):
            raise RuntimeError("subscriber bug")

        cs.subscribe(lambda ev: seen_first.append(ev))
        cs.subscribe(bad)
        cs.subscribe(lambda ev: seen_last.append(ev))
        before = metrics.watch_delivery_error_total._value.get()
        cs.create_node(_node())
        # the mutation landed, both healthy subscribers got the event,
        # the error was counted, and the event seq stayed intact
        assert cs.get_node("n").name == "n"
        assert len(seen_first) == 1 and len(seen_last) == 1
        assert seen_first[0].resource_version == seen_last[0].resource_version
        assert metrics.watch_delivery_error_total._value.get() == before + 1

    def test_bad_filter_is_isolated_too(self):
        cs = ClusterState()
        seen = []

        def bad_filter(ev):
            raise RuntimeError("filter bug")

        cs.subscribe(lambda ev: None, filter=bad_filter)
        cs.subscribe(lambda ev: seen.append(ev))
        cs.create_node(_node())
        assert len(seen) == 1


# -- occupancy-staleness bounds (fleet conservative admission) --


def _fleet_pair(clock, max_row_age_s=5.0):
    """Two fleet replicas on one cluster + one hub (the sim's wiring,
    miniature)."""
    cs = ClusterState(clock=clock)
    hub = OccupancyExchange(clock=clock)
    for i in range(4):
        node = (
            MakeNode()
            .name(f"n{i}")
            .capacity({"cpu": "8", "memory": "16Gi", "pods": "10"})
            .label("topology.kubernetes.io/zone", f"z{i % 2}")
            .obj()
        )
        cs.create_node(node)
    scheds = {}
    for rid in ("r0", "r1"):
        scheds[rid] = Scheduler(
            cs,
            _cfg(
                obs=None,
                fleet=FleetConfig(
                    replica=rid,
                    replicas=("r0", "r1"),
                    exchange=hub,
                    max_row_age_s=max_row_age_s,
                ),
            ),
            clock=clock,
            device="cpu",
        )
    return cs, hub, scheds


class TestStalenessBounds:
    def test_partitioned_replica_turns_conservative_for_risky_pods(self):
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock, max_row_age_s=5.0)
        s0 = scheds["r0"]
        # cut r0 off from the hub and age past the bound
        hub.set_partitioned("r0", True)
        clock.advance(10.0)
        spread = (
            MakePod()
            .name("risky")
            .label("app", "s")
            .req({"cpu": "1"})
            .spread_constraint(
                1, "topology.kubernetes.io/zone", "DoNotSchedule",
                {"app": "s"},
            )
            .obj()
        )
        owned = next(
            n for n in ("n0", "n1", "n2", "n3") if s0.fleet.owns_node(n)
        )
        with cs.lock:
            why = s0.fleet.admit(spread, owned, s0.cache)
        assert why is not None and "stale" in why
        assert s0.fleet.stale_rejections == 1

    def test_plain_pods_unaffected_by_staleness(self):
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock, max_row_age_s=5.0)
        s0 = scheds["r0"]
        hub.set_partitioned("r0", True)
        clock.advance(10.0)
        plain = MakePod().name("plain").req({"cpu": "1"}).obj()
        owned = next(
            n for n in ("n0", "n1", "n2", "n3") if s0.fleet.owns_node(n)
        )
        with cs.lock:
            assert s0.fleet.admit(plain, owned, s0.cache) is None

    def test_silent_peer_ages_the_view(self):
        """A PEER partitioned from the hub stops publishing: the
        healthy replica's view of it ages out and ITS admission turns
        conservative — the overcommit risk is symmetric."""
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock, max_row_age_s=5.0)
        s0 = scheds["r0"]
        hub.set_partitioned("r1", True)  # r0 still reaches the hub
        clock.advance(10.0)
        spread = (
            MakePod()
            .name("risky")
            .label("app", "s")
            .req({"cpu": "1"})
            .spread_constraint(
                1, "topology.kubernetes.io/zone", "DoNotSchedule",
                {"app": "s"},
            )
            .obj()
        )
        owned = next(
            n for n in ("n0", "n1", "n2", "n3") if s0.fleet.owns_node(n)
        )
        with cs.lock:
            why = s0.fleet.admit(spread, owned, s0.cache)
        assert why is not None and "stale" in why

    def test_fresh_view_admits_normally(self):
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock, max_row_age_s=5.0)
        s0 = scheds["r0"]
        clock.advance(10.0)
        # both replicas republish (fresh contact)
        with cs.lock:
            for s in scheds.values():
                s.fleet.publish_inventory()
        spread = (
            MakePod()
            .name("risky")
            .label("app", "s")
            .req({"cpu": "1"})
            .spread_constraint(
                1, "topology.kubernetes.io/zone", "DoNotSchedule",
                {"app": "s"},
            )
            .obj()
        )
        owned = next(
            n for n in ("n0", "n1", "n2", "n3") if s0.fleet.owns_node(n)
        )
        with cs.lock:
            assert s0.fleet.admit(spread, owned, s0.cache) is None

    def test_drain_progress_refreshes_liveness_mid_lease(self):
        """a replica mid-drain-lease may write
        NOTHING to the hub except per-chunk progress reports for long
        stretches — no row traffic, no republish. Those reports must
        refresh its publish stamp, or the lease holder ages past
        max_row_age_s and flips every peer's constrained admission
        conservative for the whole drain (the companion failure mode
        is test_silent_peer_ages_the_view above)."""
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock, max_row_age_s=5.0)
        s0 = scheds["r0"]
        # r1 holds a drain lease and only ever reports chunk progress
        hub.drain_init("r1", {"r1": ["default/d0", "default/d1"]}, [])
        hub.drain_claim("r1")
        for _ in range(4):
            clock.advance(3.0)  # 12s total: far past the 5s bound
            hub.drain_progress("r1", [])  # empty chunk still touches
        with cs.lock:
            s0.fleet.publish_inventory()  # r0's own stamp is fresh
        spread = (
            MakePod()
            .name("risky")
            .label("app", "s")
            .req({"cpu": "1"})
            .spread_constraint(
                1, "topology.kubernetes.io/zone", "DoNotSchedule",
                {"app": "s"},
            )
            .obj()
        )
        owned = next(
            n for n in ("n0", "n1", "n2", "n3") if s0.fleet.owns_node(n)
        )
        with cs.lock:
            assert s0.fleet.admit(spread, owned, s0.cache) is None
        assert s0.fleet.stale_rejections == 0

    def test_partitioned_stage_marks_dirty_and_resync_republishes(self):
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock)
        s0 = scheds["r0"]
        hub.set_partitioned("r0", True)
        pod = MakePod().name("p").label("app", "x").req({"cpu": "1"}).obj()
        owned = next(
            n for n in ("n0", "n1", "n2", "n3") if s0.fleet.owns_node(n)
        )
        with cs.lock:
            s0.fleet.stage(pod, owned, s0.cache)
        assert s0.fleet._exchange_dirty
        hub.set_partitioned("r0", False)
        s0.fleet.maybe_resync(s0)
        assert not s0.fleet._exchange_dirty

    def test_peer_death_revokes_its_fence(self):
        clock = FakeClock()
        cs, hub, scheds = _fleet_pair(clock)
        s0, s1 = scheds["r0"], scheds["r1"]
        role1 = s1.fleet.lease_name
        token1 = s1._fence_token
        assert cs.fence_valid(role1, token1)
        # r0 observes r1's lease stale: membership flip revokes r1's
        # commit fence at the state service
        s0.fleet.set_alive(["r0"])
        assert not cs.fence_valid(role1, token1)


# -- exchange partition seam --


class TestExchangePartitionSeam:
    def test_partitioned_ops_raise(self):
        hub = OccupancyExchange(clock=FakeClock())
        hub.set_partitioned("r0", True)
        with pytest.raises(ExchangeUnreachable):
            hub.peers_view("r0")
        with pytest.raises(ExchangeUnreachable):
            hub.publish_nodes("r0", [NodeRow(node="n")])
        with pytest.raises(ExchangeUnreachable):
            hub.peers_version("r0")
        # other replicas unaffected
        hub.publish_nodes("r1", [NodeRow(node="m")])
        assert hub.peers_view("r1") is not None

    def test_peer_ages_track_publish_times(self):
        clock = FakeClock()
        hub = OccupancyExchange(clock=clock)
        hub.publish_nodes("r0", [NodeRow(node="n")])
        hub.publish_nodes("r1", [NodeRow(node="m")])
        clock.advance(7.0)
        hub.publish_nodes("r1", [NodeRow(node="m")])
        view = hub.peers_view("r1")
        assert dict(view.peer_ages)["r0"] == 7.0
        view0 = hub.peers_view("r0")
        assert dict(view0.peer_ages)["r1"] == 0.0
