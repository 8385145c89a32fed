"""Occupancy hub high availability: replicated hub state
(op log + snapshot catch-up), epoch-fenced failover (HubLease grants,
HubDeposed rejections, client-side monotone epoch verification), the
endpoint-failover client, and the idempotent write-behind flush path
that closes the double-apply hazard."""

import pytest

from kubernetes_tpu_torch.fleet import (
    AdmitConflict,
    ExchangeUnreachable,
    HubDeposed,
    HubLease,
    LocalHubClient,
    NodeRow,
    OccupancyExchange,
    PENDING,
    PodRow,
    RemoteOccupancyExchange,
    SqliteHubLease,
    StandbyReplicator,
)
from kubernetes_tpu_torch.utils.clock import FakeClock


def _row(pod="default/p", node="n1", zone="z0", labels=(("app", "x"),)):
    return PodRow(
        pod=pod, node=node, zone=zone, namespace="default",
        labels=labels, state=PENDING,
    )


def _ha_pair(clock=None, lease_s=2.0, lease=None, **hub_kw):
    """Primary (epoch 1) + standby under one lease on a FakeClock."""
    clock = clock or FakeClock()
    if lease is None:
        lease = HubLease(clock=clock, duration_s=lease_s)
    primary = OccupancyExchange(
        clock=clock, hub_id="hub-a", lease=lease, **hub_kw
    )
    assert primary.try_promote() == 1
    standby = OccupancyExchange(
        clock=clock, hub_id="hub-b", lease=lease, **hub_kw
    )
    return clock, lease, primary, standby


# -- HubLease ----------------------------------------------------------------


@pytest.fixture(params=["memory", "sqlite"])
def make_lease(request, tmp_path):
    """Lease-store factory covering both backends: the in-memory
    HubLease and the file-backed SqliteHubLease must
    be contract-interchangeable, so the fencing/failover tests in
    this module run against each."""
    if request.param == "memory":
        return lambda clock, lease_s=2.0: HubLease(
            clock=clock, duration_s=lease_s
        )
    return lambda clock, lease_s=2.0: SqliteHubLease(
        str(tmp_path / "hub_lease.db"), clock=clock, duration_s=lease_s
    )


class TestHubLease:
    def test_grant_renew_and_expiry_takeover(self, make_lease):
        clock = FakeClock()
        lease = make_lease(clock)
        assert lease.try_acquire("a") == 1
        assert lease.try_acquire("b") is None  # live lease: no takeover
        clock.advance(1.0)
        assert lease.renew("a") is True
        clock.advance(1.5)  # 1.5 since renew: still valid
        assert lease.valid("a") and not lease.valid("b")
        clock.advance(1.0)  # 2.5 since renew: expired
        assert lease.renew("a") is False  # expired holder can't renew
        assert lease.try_acquire("b") == 2  # takeover bumps the epoch

    def test_same_holder_reacquire_keeps_epoch(self, make_lease):
        """The steady-state maintenance path: an incumbent re-acquiring
        (even after its own expiry, unclaimed) renews WITHOUT bumping
        the epoch — otherwise every idle stretch would read as a
        failover."""
        clock = FakeClock()
        lease = make_lease(clock)
        assert lease.try_acquire("a") == 1
        clock.advance(5.0)
        assert lease.try_acquire("a") == 1
        assert lease.epoch == 1


# -- replication (op log + snapshot) ----------------------------------------


class TestReplication:
    def test_oplog_catchup_mirrors_state_and_version(self):
        clock, _lease, primary, standby = _ha_pair()
        rep = StandbyReplicator(standby, LocalHubClient(primary))
        primary.publish_nodes("r0", [NodeRow("n1", "z0")])
        primary.stage("r0", _row())
        primary.commit("r0", "default/p")
        primary.hand_off("r1", "default/h", 2, trace="t-1")
        primary.set_degraded("r0", True)
        primary.ship_journal("r0", ['{"a":1}'])
        rep.poll()
        assert standby.version == primary.version  # CAS continuity
        assert standby.opseq == primary.opseq
        assert rep.lag == 0
        assert standby.replica_rows("r0") == primary.replica_rows("r0")
        assert standby.pending_handoff_keys() == {"default/h"}
        # degraded flags are a role-fenced replica-facing read: the
        # standby mirror is asserted through the debug surface
        assert standby.debug_state()["degraded"] == ["r0"]
        assert standby.journal_lines() == ['{"a":1}']

    def test_claim_and_withdraw_replicate(self):
        clock, _lease, primary, standby = _ha_pair()
        rep = StandbyReplicator(standby, LocalHubClient(primary))
        primary.stage("r0", _row())
        primary.hand_off("r1", "default/h", 1)
        rep.poll()
        assert standby.pending_handoff_keys() == {"default/h"}
        primary.claim_handoffs("r1")
        primary.withdraw("r0", "default/p")
        rep.poll()
        assert standby.pending_handoff_keys() == set()
        assert standby.replica_rows("r0")[1] == ()

    def test_snapshot_join_when_log_window_moved(self):
        """A standby further behind than the retained op-log window
        re-joins via snapshot (and the lag gauge covers both paths)."""
        clock, _lease, primary, standby = _ha_pair(oplog_capacity=4)
        rep = StandbyReplicator(standby, LocalHubClient(primary))
        for i in range(12):  # 12 ops through a 4-entry window
            primary.stage("r0", _row(pod=f"default/p{i}"))
        rep.poll()
        assert rep.snapshots_installed == 1
        assert standby.version == primary.version
        assert len(standby.replica_rows("r0")[1]) == 12
        # incremental from here on
        primary.stage("r0", _row(pod="default/p99"))
        rep.poll()
        assert rep.snapshots_installed == 1  # no second snapshot
        assert standby.opseq == primary.opseq

    def test_retire_and_fence_state_replicate(self):
        """The promoted standby must enforce the same hub write fence
        the primary did — revoked-replica state rides the log."""
        clock, _lease, primary, standby = _ha_pair()
        rep = StandbyReplicator(standby, LocalHubClient(primary))
        primary.stage("r0", _row())
        primary.retire("r0")
        rep.poll()
        clock.advance(3.0)
        assert standby.try_promote() == 2
        with pytest.raises(AdmitConflict) as ei:
            standby.stage("r0", _row(pod="default/q"))
        assert ei.value.fenced is True
        assert standby.replica_rows("r0")[1] == ()


# -- epoch fencing ------------------------------------------------------------


class TestEpochFencing:
    def test_standby_rejects_replica_surface(self, make_lease):
        clock = FakeClock()
        _clock, _lease, _primary, standby = _ha_pair(
            clock=clock, lease=make_lease(clock)
        )
        with pytest.raises(HubDeposed):
            standby.peers_view("r0")
        with pytest.raises(HubDeposed):
            standby.stage("r0", _row())

    def test_deposed_primary_fences_writes_serves_status(
        self, make_lease
    ):
        """The partitioned-old-primary contract: after a takeover its
        replica-facing writes reject typed (and are counted — the
        chaos smoke's stale-primary proof) while the debug/read
        surface keeps serving the post-mortem."""
        clock = FakeClock()
        clock, _lease, primary, standby = _ha_pair(
            clock=clock, lease=make_lease(clock)
        )
        primary.stage("r0", _row())
        clock.advance(3.0)  # primary's lease expires unrenewed
        assert standby.try_promote() == 2
        with pytest.raises(HubDeposed):
            primary.stage("r0", _row(pod="default/q"))
        assert primary.deposed_write_rejections == 1
        assert primary.hub_status()["role"] == "deposed"
        assert primary.journal_lines() == []  # reads still serve
        # a read of the replica-facing surface is equally fenced (a
        # zombie replica must not keep resetting its staleness clock
        # against a dead hub's frozen rows) but not counted as a write
        with pytest.raises(HubDeposed):
            primary.peers_view("r0")
        assert primary.deposed_write_rejections == 1

    def test_heartbeat_self_deposes_on_lost_lease(self, make_lease):
        clock = FakeClock()
        clock, _lease, primary, standby = _ha_pair(
            clock=clock, lease=make_lease(clock)
        )
        clock.advance(3.0)
        assert standby.try_promote() == 2
        assert primary.heartbeat() is False
        assert primary.role == "deposed"

    def test_hub_deposed_maps_to_permission_denied_on_wire(self):
        """Wire half: PERMISSION_DENIED is the HubDeposed status — a
        code no other hub rejection uses, so the failover client can
        rotate on it without ambiguity."""
        import grpc

        from kubernetes_tpu_torch.server.bulk import (
            BulkClient,
            BulkCore,
            make_grpc_server,
        )
        from kubernetes_tpu_torch.state.cluster import ClusterState

        _clock, _lease, _primary, standby = _ha_pair()
        core = BulkCore(ClusterState(), exchange=standby, device="cpu")
        server, port = make_grpc_server(core, port=0)
        server.start()
        client = BulkClient(f"127.0.0.1:{port}", retries=0)
        try:
            with pytest.raises(grpc.RpcError) as ei:
                client.hub_op("peers_version", replica="r0")
            assert (
                ei.value.code() == grpc.StatusCode.PERMISSION_DENIED
            )
        finally:
            client.close()
            server.stop(grace=None)

    def test_every_reply_carries_the_epoch(self):
        from kubernetes_tpu_torch.fleet import dispatch_hub_op

        hub = OccupancyExchange()  # standalone: permanently epoch 1
        for op in ("version", "peers_view", "hub_status"):
            assert dispatch_hub_op(hub, op, {"replica": "r0"})[
                "epoch"
            ] == 1


# -- idempotent flush (the double-apply hazard, fixed) -----------------------


class TestIdempotentFlush:
    def _remote(self, hub, replica="r0", clock=None):
        return RemoteOccupancyExchange(
            "", replica, clients=[LocalHubClient(hub)],
            clock=clock or FakeClock(), flush_client_id=f"{replica}-t",
        )

    def test_reply_loss_after_apply_does_not_double_apply(self):
        """THE regression (satellite #1): UNAVAILABLE raised AFTER the
        server-side apply used to re-land the whole buffer on retry —
        double-staged rows and double-appended journal lines. The
        sealed (client, seq) key now dedups the retry whole."""
        hub = OccupancyExchange()
        remote = self._remote(hub)
        remote.stage("r0", _row(pod="default/a"))
        remote.ship_journal("r0", ['{"line":1}'])
        hub.set_flush_fault(1)  # next apply_ops applies, reply lost
        with pytest.raises(ExchangeUnreachable):
            remote.flush()
        # server applied: the state is already there
        assert [r.pod for r in hub.replica_rows("r0")[1]] == ["default/a"]
        assert hub.journal_lines() == ['{"line":1}']
        assert remote._pending_flush() == 2  # retained client-side
        remote.flush()  # the retry — must dedup, not double-apply
        assert hub.flush_dedup_hits == 1
        assert [r.pod for r in hub.replica_rows("r0")[1]] == ["default/a"]
        assert hub.journal_lines() == ['{"line":1}']  # no double line
        assert remote._pending_flush() == 0

    def test_new_mutations_after_lost_reply_land_once_each(self):
        """Mutations buffered AFTER the lost-reply flush seal into a
        NEW batch under the next seq: the retry dedups only the old
        batch, the new one applies."""
        hub = OccupancyExchange()
        remote = self._remote(hub)
        remote.stage("r0", _row(pod="default/a"))
        hub.set_flush_fault(1)
        with pytest.raises(ExchangeUnreachable):
            remote.flush()
        remote.stage("r0", _row(pod="default/b"))
        remote.flush()
        assert hub.flush_dedup_hits == 1
        assert [r.pod for r in hub.replica_rows("r0")[1]] == [
            "default/a", "default/b",
        ]

    def test_dedup_watermark_survives_failover(self):
        """The retry of a lost-reply flush can land on the PROMOTED
        standby — the watermark replicated, so it still dedups."""
        clock, _lease, primary, standby = _ha_pair()
        rep = StandbyReplicator(standby, LocalHubClient(primary))
        remote = RemoteOccupancyExchange(
            "", "r0",
            clients=[LocalHubClient(primary), LocalHubClient(standby)],
            clock=clock, flush_client_id="r0-t",
        )
        remote.stage("r0", _row(pod="default/a"))
        remote.ship_journal("r0", ['{"line":1}'])
        primary.set_flush_fault(1)
        with pytest.raises(ExchangeUnreachable):
            remote.flush()
        rep.poll()  # the applied flush (and its watermark) replicate
        primary.set_down(True)
        clock.advance(3.0)
        assert standby.try_promote() == 2
        remote.flush()  # retried against the standby: deduped there
        assert standby.flush_dedup_hits == 1
        assert standby.journal_lines() == ['{"line":1}']
        assert [r.pod for r in standby.replica_rows("r0")[1]] == [
            "default/a"
        ]

    def test_restarted_client_is_not_mistaken_for_a_retry(self):
        """flush_client scopes the seq stream: a fresh incarnation
        starting back at seq 0 must not be dedup-dropped against the
        dead incarnation's watermark."""
        hub = OccupancyExchange()
        old = self._remote(hub)
        old.stage("r0", _row(pod="default/a"))
        old.flush()
        fresh = RemoteOccupancyExchange(
            "", "r0", clients=[LocalHubClient(hub)], clock=FakeClock(),
            flush_client_id="r0-incarnation-2",
        )
        fresh.stage("r0", _row(pod="default/b"))
        fresh.flush()  # seq 0 again, different client id: applies
        assert hub.flush_dedup_hits == 0
        assert len(hub.replica_rows("r0")[1]) == 2


# -- the endpoint-failover client --------------------------------------------


class TestFailoverClient:
    def test_rotates_to_standby_and_flags_failover(self):
        clock, _lease, primary, standby = _ha_pair()
        rep = StandbyReplicator(standby, LocalHubClient(primary))
        remote = RemoteOccupancyExchange(
            "", "r0",
            clients=[LocalHubClient(primary), LocalHubClient(standby)],
            clock=clock, flush_client_id="r0-t",
        )
        remote.publish_nodes("r0", [NodeRow("n1", "z0")])
        rep.poll()
        assert remote.consume_failover() is False
        primary.set_down(True)
        # blackout: the standby is not promoted yet — every endpoint
        # rejects, surfaced as the unreachable the conservative
        # machinery expects
        with pytest.raises(ExchangeUnreachable):
            remote.peers_version("r0")
        clock.advance(3.0)
        assert standby.try_promote() == 2
        assert remote.peers_version("r0") == standby.version
        # the epoch advance was recorded exactly once, for the forced
        # wholesale-republish resync
        assert remote.failovers == 1
        assert remote.consume_failover() is True
        assert remote.consume_failover() is False

    def test_stale_epoch_reply_is_ignored(self):
        """A deposed primary that still answers (reads, or a lease
        check raced) is structurally ignored once a higher epoch was
        verified — the client-side half of the fence."""
        clock, _lease, primary, standby = _ha_pair()
        clock.advance(3.0)
        assert standby.try_promote() == 2

        class StaleEpochClient:
            """Answers like a pre-takeover primary that never noticed
            (the pathological case the monotone check exists for)."""

            def hub_op(self, op, **meta):
                return {"version": 0, "epoch": 1}

            def close(self):
                pass

        remote = RemoteOccupancyExchange(
            "", "r0",
            clients=[StaleEpochClient(), LocalHubClient(standby)],
            clock=clock, flush_client_id="r0-t",
        )
        # first contact lands on the stale client (epoch 1) — accepted
        # only until a higher epoch is seen
        remote.peers_version("r0")
        remote._active = 1
        assert remote.peers_version("r0") == standby.version  # epoch 2
        remote._active = 0  # force the stale endpoint first again
        assert remote.peers_version("r0") == standby.version
        assert remote._active == 1  # rotated off the stale answer

    def test_admit_conflict_never_rotates(self):
        """Semantic rejections surface immediately — a lost CAS race
        must not be retried against another endpoint (it would re-land
        the write the CAS rejected)."""
        clock, _lease, primary, standby = _ha_pair()
        calls = {"standby": 0}
        standby_client = LocalHubClient(standby)
        real = standby_client.hub_op

        def counting(op, **meta):
            calls["standby"] += 1
            return real(op, **meta)

        standby_client.hub_op = counting
        remote = RemoteOccupancyExchange(
            "", "r0",
            clients=[LocalHubClient(primary), standby_client],
            clock=clock, flush_client_id="r0-t",
        )
        primary.stage("r1", _row(pod="default/w"))  # moves the version
        with pytest.raises(AdmitConflict):
            remote.compare_and_stage("r0", _row(), 0)
        assert calls["standby"] == 0

    def test_failover_jitter_is_bounded_virtual_time(self):
        """Satellite #2's client-side twin: rotation waits are full
        jitter on the injectable clock — bounded by the doubling cap,
        non-negative, and virtual (no real sleep)."""
        clock = FakeClock()
        hub = OccupancyExchange()  # healthy second endpoint

        class DeadClient:
            def hub_op(self, op, **meta):
                raise ConnectionError("down")

            def close(self):
                pass

        remote = RemoteOccupancyExchange(
            "", "r0", clients=[DeadClient(), LocalHubClient(hub)],
            clock=clock, flush_client_id="r0-t",
        )
        t0 = clock.now()
        remote.peers_version("r0")
        waited = clock.now() - t0
        assert 0.0 <= waited < RemoteOccupancyExchange._FAILOVER_BACKOFF_S
        assert remote._active == 1

    def test_target_string_accepts_comma_list(self):
        remote = RemoteOccupancyExchange(
            "127.0.0.1:1,127.0.0.1:2", "r0", clock=FakeClock()
        )
        try:
            assert remote._targets == ["127.0.0.1:1", "127.0.0.1:2"]
            with pytest.raises(ExchangeUnreachable):
                remote.peers_version("r0")  # both dead: unreachable
        finally:
            remote.close()


class TestReviewHardening:
    def test_deposed_hub_cannot_repromote_until_caught_up(
        self, make_lease
    ):
        """a deposed old primary re-acquiring an
        expired lease at a HIGHER epoch while serving PRE-deposition
        state would regress the version counter behind an epoch the
        clients' monotone check must accept. Promotion stays refused
        until replication reaches lag 0 against the successor (or the
        operator overrides with allow_stale for the disaster case)."""
        clock = FakeClock()
        clock, _lease, a, b = _ha_pair(
            clock=clock, lease=make_lease(clock)
        )
        a.stage("r0", _row())
        StandbyReplicator(b, LocalHubClient(a)).poll()
        clock.advance(3.0)
        assert b.try_promote() == 2
        b.stage("r0", _row(pod="default/q"))  # B-era state A lacks
        assert a.heartbeat() is False  # A discovers its deposition
        clock.advance(3.0)  # B's lease expires unrenewed too
        assert a.try_promote() is None  # stale: refused
        rep = StandbyReplicator(a, LocalHubClient(b))
        rep.poll()  # catch up from the successor
        # a deposed hub re-joins via FULL SNAPSHOT (its own history
        # may have diverged; the successor's state REPLACES it)
        assert rep.snapshots_installed == 1
        assert a.version == b.version
        assert a.try_promote() == 3  # caught up: eligible again
        assert len(a.replica_rows("r0")[1]) == 2  # B-era row present

    def test_allow_stale_is_the_disaster_override(self, make_lease):
        clock = FakeClock()
        clock, _lease, a, b = _ha_pair(
            clock=clock, lease=make_lease(clock)
        )
        clock.advance(3.0)
        assert b.try_promote() == 2
        assert a.heartbeat() is False
        clock.advance(3.0)
        b.set_down(True)  # the successor is gone: nothing to catch
        # up from — the operator chooses stale state over no hub
        assert a.try_promote() is None
        assert a.try_promote(allow_stale=True) == 3

    def test_down_hub_answers_nothing_debug_state_bypasses(self):
        """degraded_replicas / journal_lines /
        pending_handoff_keys leaked through the set_down seam — a
        'killed' hub kept answering reads, so the blackout never
        exercised the degraded-read failure path a real process kill
        produces. debug_state is the harness's deliberate bypass."""
        hub = OccupancyExchange()
        hub.ship_journal("r0", ['{"a":1}'])
        hub.hand_off("r1", "default/h", 1)
        hub.set_down(True)
        for op in (
            lambda: hub.degraded_replicas(),
            lambda: hub.journal_lines(),
            lambda: hub.pending_handoff_keys(),
            lambda: hub.version,
        ):
            with pytest.raises(ExchangeUnreachable):
                op()
        state = hub.debug_state()
        assert state["pending_handoffs"] == {"default/h"}
        assert state["journal"] == ['{"a":1}']

    def test_failover_counter_ignores_renewals(self):
        """try_promote doubles as the serving loop's
        lease renewal — counting every same-holder re-grant made
        scheduler_hub_failover_total grow once per tick forever after
        the first failover."""
        from kubernetes_tpu_torch import metrics

        clock, _lease, a, b = _ha_pair()
        clock.advance(3.0)
        before = metrics.hub_failover_total._value.get()
        assert b.try_promote() == 2  # the actual takeover
        for _ in range(5):
            clock.advance(1.0)
            assert b.try_promote() == 2  # renewals
        assert metrics.hub_failover_total._value.get() == before + 1

    def test_transient_self_expiry_without_standby_self_heals(
        self, make_lease
    ):
        """a lease expiring transiently (GC pause) with
        NO successor taking over must not wedge the only hub behind
        the needs_catchup gate — there is no successor timeline to
        diverge from, so the same-epoch re-grant heals without
        operator action."""
        clock = FakeClock()
        clock, _lease, a, _b = _ha_pair(
            clock=clock, lease=make_lease(clock)
        )
        a.stage("r0", _row())
        clock.advance(5.0)  # lease long expired; nobody acquired
        with pytest.raises(HubDeposed):
            a.stage("r0", _row(pod="default/q"))  # self-deposes
        assert a.role == "deposed" and a.needs_catchup
        assert a.try_promote() == 1  # same epoch: no takeover happened
        assert a.role == "primary" and not a.needs_catchup
        a.stage("r0", _row(pod="default/q"))  # serving again

    def test_replicator_normalizes_transport_errors(self):
        """a BulkClient source surfaces raw
        grpc.RpcError; poll()'s documented contract is
        ExchangeUnreachable."""
        from kubernetes_tpu_torch.server.bulk import BulkClient

        standby = OccupancyExchange()
        rep = StandbyReplicator(
            standby, BulkClient("127.0.0.1:1", retries=0)
        )
        with pytest.raises(ExchangeUnreachable):
            rep.poll()

    def test_deposed_hub_degraded_flags_are_fenced(self):
        """degraded_replicas orders the fleet-wide
        handoff chain — a deposed hub's frozen flags must reject like
        peers_view, not silently serve stale routing state."""
        clock, _lease, a, b = _ha_pair()
        a.set_degraded("r0", True)
        clock.advance(3.0)
        assert b.try_promote() == 2
        with pytest.raises(HubDeposed):
            a.degraded_replicas()

    def test_deferred_retire_reissued_after_heal(self):
        """a retire() deferred by a mid-blackout
        unreachable hub was never retried — the dead peer's frozen
        publish stamp would age every survivor's staleness bound
        forever. maybe_resync re-issues it at the first reachable
        poll."""
        from kubernetes_tpu_torch.fleet import FleetConfig
        from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
        from kubernetes_tpu_torch.state.cluster import ClusterState

        clock = FakeClock()
        cluster = ClusterState(clock=clock)
        hub = OccupancyExchange(clock=clock)
        sched = Scheduler(
            cluster,
            SchedulerConfig(
                fleet=FleetConfig(
                    replica="r0", replicas=("r0", "r1"), exchange=hub
                )
            ),
            clock=clock,
            device="cpu",
        )
        hub.stage("r1", _row(pod="default/peer"))
        hub.set_down(True)
        # the membership transition observes r1 dead while the hub is
        # dark: the retire defers instead of crashing
        sched.fleet.set_alive(["r0"])
        assert "r1" in sched.fleet._pending_retires
        hub.set_down(False)
        sched.fleet.maybe_resync(sched)
        assert sched.fleet._pending_retires == set()
        assert hub.replica_rows("r1")[1] == ()  # rows retired
        assert "r1" not in hub._published_at  # stamp cleared


# -- config + debug surface ---------------------------------------------------


def test_config_hub_address_comma_list():
    from kubernetes_tpu_torch.config.types import load

    cfg = load(
        {
            "fleet": {
                "replica": "r0",
                "hubAddress": "10.0.0.1:50051, 10.0.0.2:50051",
            }
        }
    )
    assert cfg.fleet.hub_address == "10.0.0.1:50051, 10.0.0.2:50051"
    with pytest.raises(ValueError):
        load({"fleet": {"replica": "r0", "hubAddress": "10.0.0.1:1,"}})
    with pytest.raises(ValueError):
        load({"fleet": {"replica": "r0", "hubAddress": "nocolon"}})


def test_scheduler_hub_status_debug_body():
    """Scheduler.hub_status is the GET /debug/hub body: role, epoch,
    cursors, plus the client-side view; None off-fleet."""
    from kubernetes_tpu_torch.fleet import FleetConfig
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.state.cluster import ClusterState

    clock = FakeClock()
    cluster = ClusterState(clock=clock)
    solo = Scheduler(cluster, SchedulerConfig(), clock=clock, device="cpu")
    assert solo.hub_status() is None
    hub = OccupancyExchange(clock=clock)
    sched = Scheduler(
        cluster,
        SchedulerConfig(
            fleet=FleetConfig(replica="r0", exchange=hub)
        ),
        clock=clock,
        device="cpu",
    )
    status = sched.hub_status()
    assert status["role"] == "primary" and status["epoch"] == 1
    assert status["client"]["endpoints"] == ["in-process"]


# -- known-bad fixtures: every check_hub_failover clause ----------------------


class TestHubFailoverInvariantFixtures:
    GOOD = dict(
        promotions=1, epoch=2, deposed_write_rejections=1,
        flush_dedup_hits=1, stale_rejections=1, hub_journal_missing=0,
        old_primary_reads_ok=True,
    )

    def _run(self, **overrides):
        from kubernetes_tpu_torch.sim.invariants import check_hub_failover

        violations = []
        check_hub_failover(0, violations, **{**self.GOOD, **overrides})
        return violations

    def test_clean_run_passes(self):
        assert self._run() == []

    @pytest.mark.parametrize(
        "overrides",
        [
            {"promotions": 0},
            {"promotions": 2},
            {"epoch": 3},
            {"deposed_write_rejections": 0},
            {"flush_dedup_hits": 0},
            {"stale_rejections": 0},
            {"hub_journal_missing": 3},
            {"old_primary_reads_ok": False},
        ],
    )
    def test_each_clause_fires(self, overrides):
        violations = self._run(**overrides)
        assert violations, f"clause never fired for {overrides}"
        assert all(v.invariant == "hub_failover" for v in violations)

    def test_dedup_clause_scoped_to_expectation(self):
        assert self._run(flush_dedup_hits=0, expect_dedup=False) == []


# -- sim acceptance -----------------------------------------------------------


def test_hub_failover_sim_heals_without_operator_action():
    """a primary-hub kill mid-drive heals on its
    own — standby promotes at epoch 2, replicas re-attach, zero rows /
    handoffs / journal lines lost, zero double-applied flushes, the
    stale primary's writes 100% rejected — asserted by the run's
    invariants (constraint/overcommit/lost-pod/journal run every
    cycle; hub_failover clauses at the end)."""
    from kubernetes_tpu_torch.sim.fleet import run_fleet_sim

    res = run_fleet_sim("hub_failover", seed=0, cycles=12, device="cpu")
    assert res.violations == []
    assert res.settled
    ha = res.summary["hub_ha"]
    assert ha["promotions"] == 1 and ha["epoch"] == 2
    assert ha["deposed_write_rejections"] >= 1
    assert ha["flush_dedup_hits"] >= 1
    assert ha["hub_journal_missing"] == 0
    assert ha["old_primary_reads_ok"] is True
    assert res.summary["stale_rejections"] >= 1  # blackout engaged


def test_hub_failover_sim_deterministic():
    from kubernetes_tpu_torch.sim.fleet import run_fleet_sim

    a = run_fleet_sim("hub_failover", seed=3, cycles=12, device="cpu")
    b = run_fleet_sim("hub_failover", seed=3, cycles=12, device="cpu")
    assert a.journal_digests == b.journal_digests
    assert a.hub_journal_lines == b.hub_journal_lines
