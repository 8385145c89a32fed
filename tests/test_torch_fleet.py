"""Fleet tier (kubernetes_tpu/fleet): occupancy exchange, cross-shard
reconciliation, membership, per-shard leases, BulkClient retry
hygiene, and the Scheduler's fleet dispatch mode end to end (two
replicas sharding one live ClusterState)."""

import pytest

from kubernetes_tpu_torch.fleet import (
    COMMITTED,
    FleetConfig,
    FleetMembership,
    NodeRow,
    OccupancyExchange,
    PodRow,
    decode_rows,
    encode_rows,
)
from kubernetes_tpu_torch.fleet.reconciler import CrossShardReconciler
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.sim.generators import make_node, make_pod
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.utils.clock import FakeClock

ZONE = "topology.kubernetes.io/zone"


# -- occupancy exchange --


def test_exchange_stage_commit_withdraw_versions():
    ex = OccupancyExchange()
    v0 = ex.version
    row = PodRow(
        pod="default/p1", node="n1", zone="z0", namespace="default",
        labels=(("app", "x"),),
    )
    ex.stage("r0", row)
    assert ex.version > v0
    view = ex.peers_view("r1")
    assert view.pod_rows == (row,)
    assert ex.peers_view("r0").pod_rows == ()  # own rows excluded
    ex.commit("r0", "default/p1")
    assert ex.peers_view("r1").pod_rows[0].state == COMMITTED
    v1 = ex.version
    ex.commit("r0", "default/p1")  # idempotent: no version bump
    assert ex.version == v1
    ex.withdraw("r0", "default/p1")
    assert ex.peers_view("r1").pod_rows == ()
    ex.withdraw("r0", "default/p1")  # idempotent


def test_exchange_retire_drops_all_rows_and_handoffs():
    ex = OccupancyExchange()
    ex.publish_nodes("r1", [NodeRow("n1", "z0")])
    ex.stage(
        "r1",
        PodRow(
            pod="default/p", node="n1", zone="z0", namespace="default",
            labels=(("a", "b"),),
        ),
    )
    ex.hand_off("r1", "default/q", 1)
    ex.retire("r1")
    view = ex.peers_view("r0")
    assert view.node_rows == () and view.pod_rows == ()
    assert ex.pending_handoff_keys() == set()


def test_exchange_handoff_claim_deterministic():
    ex = OccupancyExchange()
    ex.hand_off("r1", "default/b", 1)
    ex.hand_off("r1", "default/a", 2)
    assert ex.pending_handoff_keys() == {"default/a", "default/b"}
    claimed = ex.claim_handoffs("r1")
    # sorted; each claim carries the journey trace the handoff shipped
    assert claimed == [("default/a", 2, ""), ("default/b", 1, "")]
    assert ex.claim_handoffs("r1") == []
    assert ex.pending_handoff_keys() == set()


def test_occupancy_rows_wire_roundtrip():
    """encode_rows/decode_rows: the tensorcodec-framed occupancy
    payload (the ExchangeOccupancy RPC's message) survives a round
    trip byte-exactly in content."""
    nodes = [NodeRow("n1", "z0"), NodeRow("n2", "")]
    pods = [
        PodRow(
            pod="default/p1", node="n1", zone="z0", namespace="default",
            labels=(("app", "x"), ("tier", "web")), state=COMMITTED,
        ),
        PodRow(
            pod="ns2/p2", node="n2", zone="", namespace="ns2",
            labels=(), state="pending",
        ),
    ]
    data = encode_rows("r0", 7, nodes, pods)
    replica, version, nodes2, pods2 = decode_rows(data)
    assert replica == "r0" and version == 7
    assert nodes2 == nodes
    assert pods2 == pods


def test_bulk_core_exchange_occupancy_roundtrip():
    """The bulk service method (no socket): publish r0's rows, get
    back the other replicas' merged view."""
    from kubernetes_tpu_torch.server.bulk import BulkCore

    ex = OccupancyExchange()
    ex.publish_nodes("r1", [NodeRow("n9", "z9")])
    core = BulkCore(ClusterState(), exchange=ex, device="cpu")
    reply = core.exchange_occupancy(
        encode_rows("r0", 0, [NodeRow("n1", "z0")], [])
    )
    _, version, nodes, pods = decode_rows(reply)
    assert [n.node for n in nodes] == ["n9"]  # peers only
    assert version == ex.version
    # r0's inventory landed on the hub
    assert [n.node for n in ex.peers_view("r1").node_rows] == ["n1"]


# -- membership + per-shard leases --


def test_membership_transitions_bump_version():
    m = FleetMembership(("r0", "r1", "r2"), "r0")
    assert m.alive() == ("r0", "r1", "r2")
    v = m.version
    assert m.mark_dead("r1")
    assert m.version == v + 1 and m.alive() == ("r0", "r2")
    assert not m.mark_dead("r1")  # already dead: no change
    assert m.mark_alive("r1")
    assert m.alive() == ("r0", "r1", "r2")
    # self can never be marked dead
    assert not m.mark_dead("r0")
    with pytest.raises(ValueError):
        FleetMembership(("a", "b"), "ghost")


def test_membership_from_per_shard_leases():
    """Production liveness: peers are alive while their per-shard
    lease (<base>-shard-<i>, utils/leaderelection.py shard=) is held
    and fresh."""
    from kubernetes_tpu_torch.utils.leaderelection import LeaderElector

    cs = ClusterState()
    clock = FakeClock()
    universe = ("r0", "r1")
    # r1 (shard index 1 in the sorted universe) elects on ITS lease
    e1 = LeaderElector(
        cs, identity="r1", name="ktpu", shard=1, clock=clock,
    )
    assert e1.try_acquire_or_renew()
    m = FleetMembership(universe, "r0")
    assert m.refresh_from_leases(cs, "ktpu", clock.now()) is False
    assert m.alive() == ("r0", "r1")  # fresh lease: alive
    # lease expires: r1 drops out of the view
    clock.advance(30.0)
    assert m.refresh_from_leases(cs, "ktpu", clock.now()) is True
    assert m.alive() == ("r0",)
    # r1 comes back
    assert e1.try_acquire_or_renew()
    assert m.refresh_from_leases(cs, "ktpu", clock.now()) is True
    assert m.alive() == ("r0", "r1")


def test_per_shard_leases_do_not_contend():
    """Two fleet replicas on DIFFERENT shards both hold leadership
    concurrently; two on the SAME shard contend classically."""
    from kubernetes_tpu_torch.utils.leaderelection import LeaderElector

    cs = ClusterState()
    clock = FakeClock()
    a = LeaderElector(cs, identity="r0", name="ktpu", shard=0, clock=clock)
    b = LeaderElector(cs, identity="r1", name="ktpu", shard=1, clock=clock)
    assert a.name == "ktpu-shard-0" and b.name == "ktpu-shard-1"
    assert a.try_acquire_or_renew() and b.try_acquire_or_renew()
    assert a.is_leader and b.is_leader  # N leases, N leaders
    # same shard: classic active/passive contention
    b2 = LeaderElector(cs, identity="r2", name="ktpu", shard=1, clock=clock)
    assert not b2.try_acquire_or_renew()


def test_shard_lease_validation():
    from kubernetes_tpu_torch.utils.leaderelection import LeaderElector

    cs = ClusterState()
    with pytest.raises(ValueError, match="shard must be non-negative"):
        LeaderElector(cs, identity="x", shard=-1)
    # timing validation still precedes (ordering preserved)
    with pytest.raises(ValueError, match="retry_period must be positive"):
        LeaderElector(cs, identity="x", shard=0, retry_period=0.0)


# -- cross-shard reconciler --


class _FakeCache:
    """Minimal cache shape for the reconciler: nodes dict of
    HostNodeInfo-alikes."""

    class _Info:
        def __init__(self, node, pods):
            self.node = node
            self.pods = pods

    def __init__(self, placements):
        # placements: list of (node_name, zone, [pods])
        self.nodes = {}
        for name, zone, pods in placements:
            node = make_node(name, "8", "32Gi", labels={ZONE: zone})
            self.nodes[name] = self._Info(
                node, {p.key: p for p in pods}
            )


def _peer_view(node_rows=(), pod_rows=()):
    from kubernetes_tpu_torch.fleet.occupancy import PeerView

    return PeerView(0, tuple(node_rows), tuple(pod_rows))


def test_reconciler_rejects_cross_shard_skew():
    """My shard holds z0 only; the peer's z1 is empty — placing a 2nd
    spread pod in z0 would exceed maxSkew=1 against the fleet
    minimum."""
    rec = CrossShardReconciler("r0")
    placed = make_pod("placed", "1", shape="spread")
    cache = _FakeCache([("n0", "z0", [placed])])
    peers = _peer_view(node_rows=[NodeRow("n9", "z1")])
    pod = make_pod("incoming", "1", shape="spread")
    why = rec.admit(pod, "n0", "z0", cache, peers)
    assert why is not None and "maxSkew" in why
    # with a matching peer pod in z1 the counts balance: admitted
    peers2 = _peer_view(
        node_rows=[NodeRow("n9", "z1")],
        pod_rows=[
            PodRow(
                pod="default/peer", node="n9", zone="z1",
                namespace="default", labels=(("app", "spread"),),
            )
        ],
    )
    assert rec.admit(pod, "n0", "z0", cache, peers2) is None


def test_reconciler_counts_peer_pending_rows():
    """A peer's PENDING (assumed, not yet bound) row counts — that is
    the entire point of exchanging before commit."""
    rec = CrossShardReconciler("r0")
    cache = _FakeCache([("n0", "z0", [])])
    pod = make_pod("incoming", "1", shape="spread")
    # peer staged 2 pending matches in z1; my z0 has 0: placing in z0
    # keeps skew <= 1 -> admitted
    rows = [
        PodRow(
            pod=f"default/pp{i}", node="n9", zone="z1",
            namespace="default", labels=(("app", "spread"),),
            state="pending",
        )
        for i in range(2)
    ]
    peers = _peer_view(node_rows=[NodeRow("n9", "z1")], pod_rows=rows)
    assert rec.admit(pod, "n0", "z0", cache, peers) is None


def test_reconciler_zone_anti_affinity_against_peer():
    from kubernetes_tpu_torch.api.wrappers import MakePod

    rec = CrossShardReconciler("r0")
    cache = _FakeCache([("n0", "z0", [])])
    pod = (
        MakePod().name("incoming").req({"cpu": "1"})
        .label("app", "anti")
        .pod_anti_affinity(ZONE, {"app": "anti"})
        .obj()
    )
    peers = _peer_view(
        pod_rows=[
            PodRow(
                pod="default/peer", node="n9", zone="z0",
                namespace="default", labels=(("app", "anti"),),
            )
        ]
    )
    why = rec.admit(pod, "n0", "z0", cache, peers)
    assert why is not None and "anti" in why
    # a peer in ANOTHER zone does not conflict
    peers2 = _peer_view(
        pod_rows=[
            PodRow(
                pod="default/peer", node="n9", zone="z1",
                namespace="default", labels=(("app", "anti"),),
            )
        ]
    )
    assert rec.admit(pod, "n0", "z0", cache, peers2) is None


# -- fleet scheduler end to end --


def _mk_fleet(n_nodes=8, zones=2, universe=("r0", "r1"), clock=None):
    clock = clock or FakeClock()
    cluster = ClusterState(clock=clock)
    for i in range(n_nodes):
        cluster.create_node(
            make_node(
                f"n{i}", "8", "32Gi", labels={ZONE: f"z{i % zones}"}
            )
        )
    ex = OccupancyExchange()
    scheds = [
        Scheduler(
            cluster,
            SchedulerConfig(
                batch_size=16,
                mesh_devices=1,
                solver=ExactSolverConfig(tie_break="first"),
                fleet=FleetConfig(
                    replica=rid, replicas=universe, exchange=ex
                ),
            ),
            clock=clock,
            device="cpu",
        )
        for rid in universe
    ]
    return cluster, scheds, ex, clock


def _drive_all(scheds, clock, rounds=10):
    bound = []
    for _ in range(rounds):
        for s in scheds:
            for r in s.run_until_settled():
                bound.extend(r.scheduled)
        clock.advance(11.0)
    return bound


def test_fleet_shards_are_disjoint_and_cover():
    cluster, scheds, _, _ = _mk_fleet()
    shards = [set(s.cache.nodes) for s in scheds]
    assert shards[0].isdisjoint(shards[1])
    assert shards[0] | shards[1] == {f"n{i}" for i in range(8)}


def test_fleet_binds_all_plain_pods_on_owned_nodes():
    cluster, scheds, _, clock = _mk_fleet()
    for i in range(20):
        cluster.create_pod(make_pod(f"p{i:02}", "500m"))
    bound = _drive_all(scheds, clock, rounds=4)
    assert len(bound) == 20
    # each bind landed on a node exactly ONE replica caches (disjoint
    # shards: the no-global-overcommit precondition)
    for pod_key, node in dict(bound).items():
        owners = [s for s in scheds if node in s.cache.nodes]
        assert len(owners) == 1


def test_fleet_spread_converges_via_handoff():
    """6 zone-spread pods over 2 zones split across 2 shards: the
    statically mis-routed tail is handed off through the exchange and
    the fleet lands a perfect 3/3 — the single-scheduler outcome."""
    cluster, scheds, ex, clock = _mk_fleet()
    for i in range(6):
        cluster.create_pod(make_pod(f"s{i}", "250m", shape="spread"))
    bound = _drive_all(scheds, clock, rounds=10)
    assert len(bound) == 6
    zones = {}
    for p in cluster.list_pods():
        z = f"z{int(p.node_name[1:]) % 2}"
        zones[z] = zones.get(z, 0) + 1
    assert zones == {"z0": 3, "z1": 3}
    from kubernetes_tpu_torch.sim.invariants import (
        check_capacity,
        check_constraints,
    )

    viol: list = []
    check_capacity(cluster, 0, viol)
    check_constraints(cluster, 0, viol)
    assert viol == []


def test_fleet_journal_records_carry_replica_tag():
    cluster, scheds, _, clock = _mk_fleet()
    from kubernetes_tpu_torch.obs import ObsConfig

    # rebuild one replica with the journal on
    sched = Scheduler(
        cluster,
        SchedulerConfig(
            batch_size=16,
            mesh_devices=1,
            solver=ExactSolverConfig(tie_break="first"),
            obs=ObsConfig(journal=True),
            fleet=FleetConfig(replica="r9", replicas=("r9",)),
        ),
        clock=clock,
        device="cpu",
    )
    cluster.create_pod(make_pod("tagme", "500m"))
    sched.run_until_settled()
    import json

    recs = [json.loads(line) for line in sched.journal.lines]
    assert recs and all(r.get("replica") == "r9" for r in recs)


def test_fleet_replica_loss_adopts_orphans():
    """Kill r1: r0's membership flip re-owns the whole cluster and
    adopts r1's queued pods; everything still binds."""
    cluster, scheds, ex, clock = _mk_fleet()
    r0, r1 = scheds
    for i in range(12):
        cluster.create_pod(make_pod(f"p{i:02}", "500m"))
    # r1 dies before ever scheduling: unsubscribe + retire, like the
    # fleet sim's crash model
    cluster.unsubscribe(r1._on_event)
    ex.retire("r1")
    r0.fleet.set_alive(["r0"])
    bound = []
    for _ in range(4):
        for r in r0.run_until_settled():
            bound.extend(r.scheduled)
        clock.advance(11.0)
    assert len(bound) == 12
    assert len(r0.cache.nodes) == 8  # the whole cluster re-owned


def test_resync_rebuilds_pod_rows_from_truth():
    """A node changing shard owner takes its pods' DELETE events to
    the NEW owner's filter — the old owner must not keep ghost
    occupancy rows for pods it no longer owns."""
    cluster, scheds, ex, clock = _mk_fleet()
    r0, r1 = scheds
    for i in range(8):
        pod = make_pod(f"p{i:02}", "500m")
        pod.labels["cohort"] = "web"  # label-bearing: rows on the wire
        cluster.create_pod(pod)
    _drive_all(scheds, clock, rounds=3)
    # r1 dies: r0 adopts its shard; r0's rebuilt rows must cover every
    # labeled bound pod in the cluster and nothing else
    cluster.unsubscribe(r1._on_event)
    ex.retire("r1")
    r0.fleet.set_alive(["r0"])
    r0.run_until_settled()  # triggers maybe_resync
    _nodes, rows = ex.replica_rows("r0")
    live = {
        p.key
        for p in cluster.list_pods()
        if p.node_name and p.labels
    }
    assert {r.pod for r in rows} == live
    # delete a pod: r0 (now the owner) withdraws its row
    victim = sorted(live)[0]
    ns, name = victim.split("/", 1)
    cluster.delete_pod(ns, name)
    _nodes, rows2 = ex.replica_rows("r0")
    assert victim not in {r.pod for r in rows2}


def test_lease_membership_polling_detects_peer_death():
    """FleetConfig.lease_membership: a peer's stale shard lease flips
    membership at the next cycle and the survivor re-owns the
    cluster."""
    from kubernetes_tpu_torch.utils.leaderelection import LeaderElector

    clock = FakeClock()
    cluster = ClusterState(clock=clock)
    for i in range(4):
        cluster.create_node(
            make_node(f"n{i}", "8", "32Gi", labels={ZONE: f"z{i % 2}"})
        )
    universe = ("r0", "r1")
    # r1 holds its shard lease (shard 1 of the sorted universe)
    e1 = LeaderElector(
        cluster, identity="r1", name="ktpu", shard=1, clock=clock
    )
    assert e1.try_acquire_or_renew()
    r0 = Scheduler(
        cluster,
        SchedulerConfig(
            batch_size=16,
            mesh_devices=1,
            solver=ExactSolverConfig(tie_break="first"),
            fleet=FleetConfig(
                replica="r0", replicas=universe, lease="ktpu",
                lease_membership=True, lease_poll_s=1.0,
            ),
        ),
        clock=clock,
        device="cpu",
    )
    assert len(r0.cache.nodes) == 2  # half the cluster while r1 lives
    # r1's lease expires; the next scheduling cycle polls and re-owns
    clock.advance(30.0)
    r0.schedule_batch()
    assert r0.fleet.membership.alive() == ("r0",)
    assert len(r0.cache.nodes) == 4


def test_fleet_ownership_fence_rejects_foreign_node():
    """admit() is the no-global-overcommit fence: a placement on a
    node outside the replica's current partition is rejected even
    when the cache is stale."""
    cluster, scheds, _, _ = _mk_fleet()
    r0 = scheds[0]
    foreign = next(
        f"n{i}" for i in range(8) if f"n{i}" not in r0.cache.nodes
    )
    pod = make_pod("x", "500m")
    why = r0.fleet.admit(pod, foreign, r0.cache)
    assert why is not None and "no longer owned" in why


# -- BulkClient retry hygiene --


class _FakeRpcError(Exception):
    def __init__(self, code_name):
        self._code_name = code_name

    def code(self):
        class _C:
            pass

        c = _C()
        c.name = self._code_name
        return c


def _mk_client(monkeypatch):
    """BulkClient without a socket: stub grpc + channel plumbing."""
    import kubernetes_tpu_torch.server.bulk as bulk

    class _FakeGrpc:
        RpcError = _FakeRpcError

        @staticmethod
        def insecure_channel(target):
            class _Ch:
                def unary_unary(self, *_a, **_k):
                    return lambda payload, timeout=None: b""

                def close(self):
                    pass

            return _Ch()

    import sys

    monkeypatch.setitem(sys.modules, "grpc", _FakeGrpc)
    return bulk.BulkClient(
        "127.0.0.1:1", retries=3, backoff_base_s=0.01, clock=FakeClock()
    )


def test_bulk_client_retries_transient_then_succeeds(monkeypatch):
    from kubernetes_tpu_torch import metrics

    client = _mk_client(monkeypatch)
    calls = {"n": 0}

    def flaky(payload, timeout=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise _FakeRpcError("UNAVAILABLE")
        return b"ok"

    before = metrics.bulk_retry_total.labels("Solve")._value.get()
    assert client._call("Solve", flaky, b"x") == b"ok"
    assert calls["n"] == 3
    assert client._clock.now() > 0  # backoff slept on the clock
    after = metrics.bulk_retry_total.labels("Solve")._value.get()
    assert after - before == 2


def test_bulk_client_gives_up_after_budget(monkeypatch):
    client = _mk_client(monkeypatch)

    def always_down(payload, timeout=None):
        raise _FakeRpcError("UNAVAILABLE")

    with pytest.raises(_FakeRpcError):
        client._call("Evaluate", always_down, b"x")


def test_bulk_client_does_not_retry_non_transient(monkeypatch):
    client = _mk_client(monkeypatch)
    calls = {"n": 0}

    def fatal(payload, timeout=None):
        calls["n"] += 1
        raise _FakeRpcError("INVALID_ARGUMENT")

    with pytest.raises(_FakeRpcError):
        client._call("Solve", fatal, b"x")
    assert calls["n"] == 1


def test_bulk_client_commit_solve_never_retries(monkeypatch):
    """A committing Solve mutates state: a lost reply must surface,
    not double-create via retry."""
    client = _mk_client(monkeypatch)
    calls = {"n": 0}

    def flaky(payload, timeout=None):
        calls["n"] += 1
        raise _FakeRpcError("UNAVAILABLE")

    client._solve = flaky
    with pytest.raises(_FakeRpcError):
        client.solve([100], [200], names=["p"], commit=True)
    assert calls["n"] == 1


def test_bulk_client_deadline_passed_through(monkeypatch):
    client = _mk_client(monkeypatch)
    seen = {}

    def record(payload, timeout=None):
        seen["timeout"] = timeout
        return b""

    client._call("SyncNodes", record, b"x")
    assert seen["timeout"] == client.deadline_s
