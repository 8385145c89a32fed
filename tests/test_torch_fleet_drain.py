"""Fleet backlog drain: the pure drain-lease ledger
(fleet/drain.py), its hub hosting + op-log/snapshot replication and
return-on-retire seam, the file-backed SqliteHubLease, the per-domain
CAS scope (leg c), the fleet HBM budget split, and the end-to-end
fleet-of-N sim drive with a mid-drain replica kill."""

import pytest

from kubernetes_tpu_torch.fleet import (
    AdmitConflict,
    LocalHubClient,
    NodeRow,
    OccupancyExchange,
    PENDING,
    PodRow,
    SqliteHubLease,
    StandbyReplicator,
    dispatch_hub_op,
    drain,
)
from kubernetes_tpu_torch.solver.budget import split_fleet_budget
from kubernetes_tpu_torch.utils.clock import FakeClock

KEYS = [f"default/p{i:02d}" for i in range(8)]


def _plan(nodes):
    """keys[i] planned onto nodes[i] (None = left unplaced)."""
    return dict(zip(KEYS, nodes))


ASSIGN = {"n0": "r0", "n1": "r0", "n2": "r1", "n3": "r1"}


# -- partition_backlog -------------------------------------------------------


class TestPartitionBacklog:
    def test_partitions_by_planned_node_owner_in_plan_order(self):
        planned = _plan(["n0", "n2", "n1", "n3", "n0", "n2", "n1", "n3"])
        parts, residual = drain.partition_backlog(KEYS, planned, ASSIGN)
        assert parts == {
            "r0": [KEYS[0], KEYS[2], KEYS[4], KEYS[6]],
            "r1": [KEYS[1], KEYS[3], KEYS[5], KEYS[7]],
        }
        assert residual == []

    def test_unplanned_and_unowned_nodes_fall_residual(self):
        planned = _plan(["n0", None, "n9", "n2", None, "n0", "n2", "n9"])
        parts, residual = drain.partition_backlog(KEYS, planned, ASSIGN)
        assert parts == {
            "r0": [KEYS[0], KEYS[5]],
            "r1": [KEYS[3], KEYS[6]],
        }
        # plan order preserved inside the residual too
        assert residual == [KEYS[1], KEYS[2], KEYS[4], KEYS[7]]

    def test_cross_shard_constraint_overrides_ownership(self):
        planned = _plan(["n0"] * 8)
        parts, residual = drain.partition_backlog(
            KEYS, planned, ASSIGN,
            cross_shard=lambda k: k == KEYS[3],
        )
        assert KEYS[3] in residual
        assert KEYS[3] not in parts["r0"]

    def test_gang_drains_whole_at_first_members_owner(self):
        # members planned across BOTH shards: the gang follows its
        # first planned member (splitting it would deadlock the
        # all-or-nothing barrier across two drain leases)
        planned = _plan(["n0", "n2", "n2", "n0", "n0", "n0", "n0", "n0"])
        gangs = {KEYS[1]: "g1", KEYS[2]: "g1", KEYS[3]: "g1"}
        parts, residual = drain.partition_backlog(
            KEYS, planned, ASSIGN,
            gang_of=lambda k: gangs.get(k, ""),
        )
        assert residual == []
        assert parts["r1"] == [KEYS[1], KEYS[2], KEYS[3]]

    def test_gang_with_residual_member_goes_whole_residual(self):
        planned = _plan(["n0", "n2", None, "n2", "n0", "n0", "n0", "n0"])
        gangs = {KEYS[1]: "g1", KEYS[2]: "g1", KEYS[3]: "g1"}
        parts, residual = drain.partition_backlog(
            KEYS, planned, ASSIGN,
            gang_of=lambda k: gangs.get(k, ""),
        )
        assert residual == [KEYS[1], KEYS[2], KEYS[3]]
        assert "r1" not in parts

    def test_deterministic(self):
        planned = _plan(["n0", "n2", None, "n3", "n1", None, "n2", "n0"])
        a = drain.partition_backlog(KEYS, planned, ASSIGN)
        b = drain.partition_backlog(KEYS, planned, ASSIGN)
        assert a == b


# -- the lease ledger state machine ------------------------------------------


def _two_shard_state(residual=()):
    parts, _ = drain.partition_backlog(
        KEYS[:6],
        _plan(["n0", "n2", "n1", "n3", "n0", "n2"]),
        ASSIGN,
    )
    return drain.new_state(parts, list(residual))


class TestLedger:
    def test_claim_grants_own_partition_once(self):
        st = _two_shard_state()
        lease, reassigned = drain.claim(st, "r0")
        assert not reassigned
        assert lease["kind"] == "partition"
        assert lease["keys"] == [KEYS[0], KEYS[2], KEYS[4]]
        # idempotent re-serve (a claim RPC retried after a lost reply)
        again, _ = drain.claim(st, "r0")
        assert again == lease
        # after completion the base partition is NEVER regranted
        assert drain.complete(st, "r0", lease["id"])
        assert drain.claim(st, "r0") == (None, False)

    def test_progress_scoped_to_lease_and_recorded_once(self):
        st = _two_shard_state()
        lease, _ = drain.claim(st, "r0")
        # keys outside the lease (r1's partition, non-backlog riders)
        # are ignored; duplicates count once
        n = drain.progress(
            st, "r0", [KEYS[0], KEYS[0], KEYS[1], "default/other"]
        )
        assert n == 1
        assert drain.progress(st, "r0", [KEYS[0]]) == 0
        # a replica with no granted lease records nothing
        assert drain.progress(st, "r1", [KEYS[1]]) == 0

    def test_complete_requires_own_granted_lease(self):
        st = _two_shard_state()
        lease, _ = drain.claim(st, "r0")
        assert not drain.complete(st, "r1", lease["id"])  # not yours
        assert not drain.complete(st, "r0", "L99")  # no such lease
        assert drain.complete(st, "r0", lease["id"])
        assert not drain.complete(st, "r0", lease["id"])  # not granted

    def test_return_leases_orphans_outstanding_and_unclaimed_base(self):
        st = _two_shard_state()
        lease, _ = drain.claim(st, "r1")
        drain.progress(st, "r1", [lease["keys"][0]])
        # r1 dies mid-lease; r0 never claimed its base partition
        assert drain.return_leases(st, "r1") == 2
        assert drain.return_leases(st, "r0") == 3
        s = drain.status(st)
        assert s["orphans"] == 5 and s["granted"] == 0
        # neither dead replica's base partition is ever regranted
        assert st["claimed"]["r0"] == ""

    def test_reassignment_adopts_orphans_exactly_once(self):
        st = _two_shard_state()
        lease, _ = drain.claim(st, "r1")
        done_key, *outstanding = lease["keys"]
        drain.progress(st, "r1", [done_key])
        drain.return_leases(st, "r1")
        adopted, reassigned = drain.claim(st, "r0")
        # r0 gets its OWN partition first (claim order), orphans next
        assert adopted["kind"] == "partition"
        drain.complete(st, "r0", adopted["id"])
        adopted, reassigned = drain.claim(st, "r0")
        assert reassigned and adopted["kind"] == "orphan"
        assert adopted["keys"] == outstanding  # done key NOT re-drained
        assert st["reassigned"] == 1
        # the zombie's late progress report lands on a RETURNED lease:
        # ignored, so the orphan claimant can't be double-counted
        assert drain.progress(st, "r1", outstanding) == 0

    def test_residual_serialized_behind_all_shard_leases(self):
        st = _two_shard_state(residual=[KEYS[6], KEYS[7]])
        l0, _ = drain.claim(st, "r0")
        # r1 hasn't claimed: no residual yet (r0's next claim is None)
        drain.complete(st, "r0", l0["id"])
        assert drain.claim(st, "r0") == (None, False)
        l1, _ = drain.claim(st, "r1")
        # r1's shard lease still granted: residual stays gated
        assert drain.claim(st, "r0") == (None, False)
        drain.complete(st, "r1", l1["id"])
        res, _ = drain.claim(st, "r0")
        assert res["kind"] == "residual"
        assert res["keys"] == [KEYS[6], KEYS[7]]
        # granted exactly once, to ONE claimant
        assert drain.claim(st, "r1") == (None, False)

    def test_outstanding_keys_and_status_counts(self):
        st = _two_shard_state(residual=[KEYS[6]])
        lease, _ = drain.claim(st, "r0")
        drain.progress(st, "r0", [KEYS[0]])
        out = drain.outstanding_keys(st)
        assert KEYS[0] not in out and KEYS[6] in out
        s = drain.status(st)
        assert s["pods"] == 7 and s["done"] == 1
        assert s["outstanding"] == 6 and not s["complete"]


# -- hub hosting: fencing, replication, return-on-retire ---------------------


def _hub_with_drain(**hub_kw):
    hub = OccupancyExchange(**hub_kw)  # standalone: permanently primary
    parts, residual = (
        {"r0": [KEYS[0], KEYS[1]], "r1": [KEYS[2], KEYS[3]]},
        [KEYS[4]],
    )
    hub.drain_init("r0", parts, residual, membership_version=7)
    return hub


class TestHubDrainOps:
    def test_init_claim_progress_complete_roundtrip(self):
        hub = _hub_with_drain()
        st = hub.drain_status()
        assert st["active"] and st["pods"] == 5 and st["residual"] == 1
        lease = hub.drain_claim("r0")
        assert lease["keys"] == [KEYS[0], KEYS[1]]
        assert hub.drain_progress("r0", [KEYS[0], KEYS[1]]) == 2
        assert hub.drain_complete("r0", lease["id"])
        assert hub.drain_status()["done"] == 2

    def test_second_init_rejected_until_ledger_drains_dry(self):
        hub = _hub_with_drain()
        with pytest.raises(AdmitConflict):
            hub.drain_init("r0", {"r0": ["default/x"]}, [])
        # drain everything dry, then a new global plan may land
        for rid in ("r0", "r1"):
            lease = hub.drain_claim(rid)
            hub.drain_progress(rid, lease["keys"])
            hub.drain_complete(rid, lease["id"])
        res = hub.drain_claim("r0")
        hub.drain_progress("r0", res["keys"])
        hub.drain_complete("r0", res["id"])
        assert hub.drain_status()["complete"]
        assert hub.drain_init("r0", {"r0": ["default/x"]}, [])["pods"] == 1

    def test_retire_returns_lease_for_reassignment(self):
        from kubernetes_tpu_torch import metrics

        hub = _hub_with_drain()
        lease = hub.drain_claim("r1")
        hub.drain_progress("r1", [lease["keys"][0]])
        before = (
            metrics.fleet_drain_lease_reassignments_total._value.get()
        )
        hub.retire("r1")
        st = hub.drain_status()
        assert st["orphans"] == 1 and st["granted"] == 0
        # the zombie's post-retire drain writes are fenced like rows
        with pytest.raises(AdmitConflict):
            hub.drain_progress("r1", [lease["keys"][1]])
        adopted = hub.drain_claim("r0")
        assert adopted["kind"] == "partition"
        hub.drain_complete("r0", adopted["id"])
        adopted = hub.drain_claim("r0")
        assert adopted["kind"] == "orphan"
        assert adopted["keys"] == [lease["keys"][1]]
        assert (
            metrics.fleet_drain_lease_reassignments_total._value.get()
            == before + 1
        )

    def test_ledger_replicates_incrementally_and_via_snapshot(self):
        hub = _hub_with_drain()
        standby = OccupancyExchange(hub_id="hub-b")
        standby._role = "standby"
        rep = StandbyReplicator(standby, LocalHubClient(hub))
        lease = hub.drain_claim("r0")
        hub.drain_progress("r0", [KEYS[0]])
        hub.retire("r1")
        hub.drain_complete("r0", lease["id"])
        rep.poll()
        # bit-identical ledger through the incremental "drain" op
        # replay (no 512k-key state shipped wholesale)
        assert standby._drain == hub._drain
        # the fence-exempt read surfaces serve from the standby too:
        # 'how far did the drain get' is a post-failover question
        assert (
            standby.drain_outstanding_keys()
            == hub.drain_outstanding_keys()
        )
        # a standby further behind than the SOURCE's retained op-log
        # window re-joins via snapshot — the ledger rides it
        small = _hub_with_drain(oplog_capacity=2)
        lease = small.drain_claim("r0")
        small.drain_progress("r0", [KEYS[0]])
        small.drain_complete("r0", lease["id"])
        late = OccupancyExchange(hub_id="hub-c")
        late._role = "standby"
        rep2 = StandbyReplicator(late, LocalHubClient(small))
        rep2.poll()
        assert rep2.snapshots_installed == 1
        assert late._drain == small._drain

    def test_drain_status_inactive_without_ledger(self):
        hub = OccupancyExchange()
        assert hub.drain_status() == {"active": False}
        assert hub.drain_outstanding_keys() == []
        assert hub.drain_claim("r0") is None
        assert hub.drain_progress("r0", [KEYS[0]]) == 0
        assert not hub.drain_complete("r0", "L1")

    def test_drain_ops_ride_the_hub_op_dispatch(self):
        hub = _hub_with_drain()
        out = dispatch_hub_op(hub, "drain_status", {"replica": "r0"})
        assert out["status"]["pods"] == 5
        out = dispatch_hub_op(hub, "drain_claim", {"replica": "r0"})
        lid = out["lease"]["id"]
        out = dispatch_hub_op(
            hub, "drain_progress",
            {"replica": "r0", "keys": [KEYS[0]]},
        )
        assert out["done"] == 1
        out = dispatch_hub_op(
            hub, "drain_complete", {"replica": "r0", "lease": lid},
        )
        assert out["ok"] is True


# -- SqliteHubLease (leg b): the contract tests run against both
# backends in tests/test_hub_ha.py; here, what only sqlite has -------------


class TestSqliteHubLease:
    def test_state_survives_reopen(self, tmp_path):
        path = str(tmp_path / "lease.db")
        clock = FakeClock()
        lease = SqliteHubLease(path, clock=clock, duration_s=2.0)
        assert lease.try_acquire("a") == 1
        clock.advance(3.0)
        assert lease.try_acquire("b") == 2  # takeover bumped the epoch
        # a hub process restart re-opens the SAME file: holder and
        # epoch are durable, so a restarted incumbent renews at its
        # epoch instead of reading as a fresh failover
        reopened = SqliteHubLease(path, clock=clock, duration_s=2.0)
        assert reopened.epoch == 2 and reopened.holder == "b"
        assert reopened.try_acquire("b") == 2
        assert reopened.valid("b")

    def test_release_is_durable_and_keeps_epoch(self, tmp_path):
        path = str(tmp_path / "lease.db")
        clock = FakeClock()
        lease = SqliteHubLease(path, clock=clock, duration_s=2.0)
        assert lease.try_acquire("a") == 1
        lease.release("a")
        reopened = SqliteHubLease(path, clock=clock, duration_s=2.0)
        assert not reopened.valid("a")
        # an explicit release expires WITHOUT rewinding the epoch: the
        # successor's grant still fences the old holder's writes
        assert reopened.try_acquire("b") == 2

    def test_epoch_grant_feeds_hub_promotion(self, tmp_path):
        clock = FakeClock()
        lease = SqliteHubLease(
            str(tmp_path / "lease.db"), clock=clock, duration_s=2.0
        )
        hub = OccupancyExchange(
            clock=clock, hub_id="hub-a", lease=lease
        )
        assert hub.try_promote() == 1
        hub.stage(
            "r0",
            PodRow(
                pod="default/p", node="n1", zone="z0",
                namespace="default", labels=(), state=PENDING,
            ),
        )
        assert hub.hub_epoch == 1


# -- per-domain CAS versioning (leg c) ---------------------------------------


def _spread_row(pod="default/p", zone="z0", labels=(("app", "x"),)):
    return PodRow(
        pod=pod, node="n1", zone=zone, namespace="default",
        labels=labels, state=PENDING,
    )


class TestDomainScopedCas:
    def _hub(self):
        hub = OccupancyExchange()
        hub.publish_nodes("r0", [NodeRow("n0", "z0"), NodeRow("n1", "z0")])
        hub.publish_nodes("r1", [NodeRow("n2", "z1")])
        return hub, hub.version

    def test_label_free_other_zone_row_is_not_a_conflict(self):
        hub, v = self._hub()
        hub.stage("r1", _spread_row(pod="default/q", zone="z1", labels=()))
        # the hub-wide CAS charges the admit a re-fetch round for an
        # interleaving that provably cannot touch its admission …
        with pytest.raises(AdmitConflict):
            hub.compare_and_stage("r0", _spread_row(), v)
        # … the domain-scoped CAS does not
        assert hub.compare_and_stage(
            "r0", _spread_row(), v, domain_scope=True
        ) > 0

    def test_same_zone_row_still_conflicts(self):
        hub, v = self._hub()
        hub.stage("r1", _spread_row(pod="default/q", zone="z0", labels=()))
        with pytest.raises(AdmitConflict):
            hub.compare_and_stage(
                "r0", _spread_row(), v, domain_scope=True
            )

    def test_label_bearing_row_conflicts_every_domain(self):
        hub, v = self._hub()
        # a label-bearing row can match ANY selector: hub-wide floor
        hub.stage("r1", _spread_row(pod="default/q", zone="z1"))
        with pytest.raises(AdmitConflict):
            hub.compare_and_stage(
                "r0", _spread_row(), v, domain_scope=True
            )

    def test_membership_mutation_conflicts_every_domain(self):
        hub, v = self._hub()
        hub.retire("r1")  # shard inventory changed under the view
        with pytest.raises(AdmitConflict):
            hub.compare_and_stage(
                "r0", _spread_row(), v, domain_scope=True
            )

    def test_drain_ledger_mutations_do_not_conflict(self):
        hub, v = self._hub()
        hub.drain_init("r0", {"r0": [KEYS[0]]}, [])
        hub.drain_claim("r0")
        hub.drain_progress("r0", [KEYS[0]])
        assert hub.version > v  # the ledger DID move the hub version
        # … but ledger traffic can't interfere with row admission, so
        # a drain in flight doesn't tax every constrained admit with
        # re-fetch rounds (the leg-c measurement's point)
        assert hub.compare_and_stage(
            "r0", _spread_row(), v, domain_scope=True
        ) > 0
        with pytest.raises(AdmitConflict):
            hub.compare_and_stage("r0", _spread_row(pod="default/q"), v)


# -- fleet HBM budget split --------------------------------------------------


def test_split_fleet_budget_even_with_low_index_remainder():
    assert split_fleet_budget(100, 1) == 100
    assert split_fleet_budget(100, 4) == 25
    assert split_fleet_budget(10, 3, replica_index=0) == 4
    assert split_fleet_budget(10, 3, replica_index=1) == 3
    assert split_fleet_budget(10, 3, replica_index=2) == 3
    # shares cover the total exactly
    assert sum(split_fleet_budget(10, 3, replica_index=i) for i in range(3)) == 10
    assert split_fleet_budget(2, 8) == 1  # never zero


# -- the fleet-of-N sim drive (mid-drain kill, exactly-once) -----------------


def test_fleet_backlog_drain_sim_survives_mid_drain_kill():
    from kubernetes_tpu_torch.sim.fleet import run_fleet_sim

    res = run_fleet_sim("fleet_backlog_drain", seed=0, cycles=12, device="cpu")
    assert res.summary["violations"] == 0
    fd = res.summary["fleet_drain"]
    assert fd["pods"] > 0 and fd["partitions"] >= 2
    assert fd["residual"] > 0  # the serialized cohort engaged
    assert fd["leases_reassigned"] >= 1  # the kill returned a lease
    assert fd["lost"] == 0 and fd["double_bind"] == 0
    res2 = run_fleet_sim("fleet_backlog_drain", seed=0, cycles=12, device="cpu")
    assert res2.journal_digests == res.journal_digests
