"""Device-tier fleet scale-out: the cross-process occupancy
hub — fenced compare-and-stage atomic admit, the HubOp gRPC transport
(RemoteOccupancyExchange), per-replica mesh slices, and the two-process
race the CAS exists to decide."""

import multiprocessing

import pytest
import torch

from kubernetes_tpu_torch.fleet import (
    AdmitConflict,
    ExchangeUnreachable,
    FleetConfig,
    NodeRow,
    OccupancyExchange,
    PENDING,
    PodRow,
    RemoteOccupancyExchange,
)
from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.server.bulk import BulkClient, BulkCore, make_grpc_server
from kubernetes_tpu_torch.sim.generators import make_node, make_pod
from kubernetes_tpu_torch.solver.exact import ExactSolverConfig
from kubernetes_tpu_torch.state.cluster import ClusterState
from kubernetes_tpu_torch.utils.clock import FakeClock

ZONE = "topology.kubernetes.io/zone"


def _row(pod="default/p", node="n1", zone="z0", labels=(("app", "x"),)):
    return PodRow(
        pod=pod, node=node, zone=zone, namespace="default",
        labels=labels, state=PENDING,
    )


# -- hub-side fenced compare-and-stage ---------------------------------------


class TestCompareAndStage:
    def test_cas_lands_at_expected_version(self):
        ex = OccupancyExchange()
        v = ex.version
        new = ex.compare_and_stage("r0", _row(), v)
        assert new == v + 1
        assert ex.peers_view("r1").pod_rows == (_row(),)

    def test_cas_rejects_moved_version_typed(self):
        """Two replicas admitted against the same view: the hub
        serializes their CAS calls — the first lands, the second gets
        a typed (non-fenced) AdmitConflict carrying the moved
        version."""
        ex = OccupancyExchange()
        v = ex.version
        ex.compare_and_stage("r0", _row(pod="default/a"), v)
        with pytest.raises(AdmitConflict) as ei:
            ex.compare_and_stage("r1", _row(pod="default/b"), v)
        assert ei.value.fenced is False
        assert ei.value.version == v + 1
        # only the winner's row is on the hub
        assert [r.pod for r in ex.peers_view("rx").pod_rows] == [
            "default/a"
        ]

    def test_cas_any_mutation_moves_the_version(self):
        """A plain stage (or withdraw, handoff, ...) between view and
        CAS also conflicts — the loser's view may hide that row."""
        ex = OccupancyExchange()
        v = ex.version
        ex.stage("r2", _row(pod="default/plain"))
        with pytest.raises(AdmitConflict):
            ex.compare_and_stage("r0", _row(), v)

    def test_retire_fences_hub_writes_until_reregistration(self):
        """The fencing-token discipline at the hub: retire revokes
        write privilege — stage/CAS/commit/set_degraded/hand_off all
        reject typed fenced — and a wholesale republish (the healed
        incarnation's forced resync) re-registers."""
        ex = OccupancyExchange()
        ex.stage("r0", _row())
        ex.retire("r0")
        for op in (
            lambda: ex.stage("r0", _row()),
            lambda: ex.compare_and_stage("r0", _row(), ex.version),
            lambda: ex.commit("r0", "default/p"),
            lambda: ex.withdraw("r0", "default/p"),
            lambda: ex.set_degraded("r0", True),
            lambda: ex.hand_off("r1", "default/p", 1, from_replica="r0"),
        ):
            with pytest.raises(AdmitConflict) as ei:
                op()
            assert ei.value.fenced is True
        # reads stay open (a zombie reading is harmless)
        ex.peers_view("r0")
        # wholesale republish = re-registration
        ex.replace_pod_rows("r0", [_row()])
        ex.stage("r0", _row(pod="default/q"))
        ex.withdraw("r0", "default/q")


# -- FleetRuntime CAS admit: the in-process race -----------------------------


def _mk_fleet(n_nodes=8, zones=2, universe=("r0", "r1"), exchange=None):
    clock = FakeClock()
    cluster = ClusterState(clock=clock)
    for i in range(n_nodes):
        cluster.create_node(
            make_node(f"n{i}", "8", "32Gi", labels={ZONE: f"z{i % zones}"})
        )
    ex = exchange if exchange is not None else OccupancyExchange()
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


def test_admit_cas_loser_rechecks_and_rejects():
    """The racing interleave, reproduced deterministically: r0's
    host-side recheck passes, then — before its CAS lands — a peer
    stages a conflicting spread row. The CAS must reject, the re-check
    against the fresh rows must now see the peer's row, and the admit
    must return a rejection reason (the pod requeues)."""
    from kubernetes_tpu_torch import metrics

    cluster, scheds, ex, clock = _mk_fleet()
    r0 = scheds[0]
    # a hard zone-spread pod routed to r0's shard
    pod = make_pod("race", "250m", shape="spread")
    cluster.create_pod(pod)
    node = sorted(r0.cache.nodes)[0]
    zone = r0.cache.nodes[node].node.labels[ZONE]
    peer_zone = "z1" if zone == "z0" else "z0"
    real_cas = ex.compare_and_stage
    fired = {"n": 0}

    def interleaved(replica, row, expected_version, **kw):
        if not fired["n"]:
            fired["n"] += 1
            # the peer wins the race: maxSkew=1 means r0's placement
            # in `zone` on top of a peer row in the SAME zone (with the
            # other zone empty) would skew 2-0
            ex.stage(
                "r1",
                PodRow(
                    pod="default/peer", node="n9", zone=zone,
                    namespace="default", labels=(("app", "spread"),),
                ),
            )
        return real_cas(replica, row, expected_version, **kw)

    ex.compare_and_stage = interleaved
    before = metrics.fleet_admit_cas_conflict_total.labels(
        "version"
    )._value.get()
    why = r0.fleet.admit(pod, node, r0.cache)
    ex.compare_and_stage = real_cas
    assert why is not None and "spread" in why
    assert fired["n"] == 1
    assert (
        metrics.fleet_admit_cas_conflict_total.labels(
            "version"
        )._value.get()
        == before + 1
    )
    assert r0.fleet.cas_conflicts == 1
    # only the peer's row landed — exactly one winner
    assert [r.pod for r in ex.peers_view("rx").pod_rows] == [
        "default/peer"
    ]
    _ = peer_zone  # zone bookkeeping above documents the skew shape


def test_admit_cas_retries_through_benign_version_churn():
    """A version bump that does NOT change the constraint picture (a
    label-bearing row in a namespace the selector never matches) costs
    one CAS round trip and then lands — contention is a retry, not a
    rejection."""
    cluster, scheds, ex, clock = _mk_fleet()
    r0 = scheds[0]
    pod = make_pod("ok", "250m", shape="spread")
    cluster.create_pod(pod)
    node = sorted(r0.cache.nodes)[0]
    real_cas = ex.compare_and_stage
    fired = {"n": 0}

    def benign(replica, row, expected_version, **kw):
        if not fired["n"]:
            fired["n"] += 1
            ex.stage(
                "r1",
                PodRow(
                    pod="other/unrelated", node="n9", zone="z0",
                    namespace="other", labels=(("tier", "db"),),
                ),
            )
        return real_cas(replica, row, expected_version, **kw)

    ex.compare_and_stage = benign
    why = r0.fleet.admit(pod, node, r0.cache)
    ex.compare_and_stage = real_cas
    assert why is None
    assert fired["n"] == 1 and r0.fleet.cas_conflicts == 1
    # the row landed under CAS and the apply-phase stage() must not
    # re-send it
    assert pod.key in r0.fleet._cas_staged
    r0.fleet.stage(pod, node, r0.cache)
    assert pod.key not in r0.fleet._cas_staged
    staged = [
        r.pod for r in ex.peers_view("rx").pod_rows if r.pod == pod.key
    ]
    assert staged == [pod.key]


def test_fleet_race_exactly_one_winner_end_to_end():
    """Two replicas, one last hard-spread slot: drive both schedulers
    and assert the fleet lands a legal outcome — the CAS admits are
    what keep the losing replica from double-placing into the same
    zone when both solved against the same peer view."""
    cluster, scheds, ex, clock = _mk_fleet()
    for i in range(6):
        cluster.create_pod(make_pod(f"s{i}", "250m", shape="spread"))
    bound = []
    for _ in range(10):
        for s in scheds:
            for r in s.run_until_settled():
                bound.extend(r.scheduled)
        clock.advance(11.0)
    assert len(bound) == 6
    zones: dict = {}
    for p in cluster.list_pods():
        z = f"z{int(p.node_name[1:]) % 2}"
        zones[z] = zones.get(z, 0) + 1
    assert zones == {"z0": 3, "z1": 3}


# -- RemoteOccupancyExchange: the wire adapter -------------------------------


@pytest.fixture()
def hub_server():
    hub = OccupancyExchange()
    core = BulkCore(ClusterState(), exchange=hub, device="cpu")
    server, port = make_grpc_server(core, port=0)
    server.start()
    yield hub, f"127.0.0.1:{port}"
    server.stop(grace=None)


def test_remote_exchange_mirrors_in_process_semantics(hub_server):
    """The same op sequence against the in-process hub and through the
    wire produces identical views, versions, and conflicts."""
    hub, addr = hub_server
    local = OccupancyExchange()
    remote0 = RemoteOccupancyExchange(addr, "r0")
    remote1 = RemoteOccupancyExchange(addr, "r1")
    try:
        for ex0, ex1 in ((local, local), (remote0, remote1)):
            ex0.publish_nodes("r0", [NodeRow("n1", "z0")])
            v = ex0.peers_version("r0")
            ex0.compare_and_stage("r0", _row(), v)
            with pytest.raises(AdmitConflict):
                ex1.compare_and_stage("r1", _row(pod="default/q"), v)
            ex0.commit("r0", "default/p")
            ex1.hand_off(
                "r0", "default/h", 1, from_replica="r1",
                trace="r1-1:2:default/h",
            )
            assert ex0.claim_handoffs("r0") == [
                ("default/h", 1, "r1-1:2:default/h")
            ]
            ex1.set_degraded("r1", True)
            assert ex0.degraded_replicas() == frozenset({"r1"})
        lv = local.peers_view("r1")
        rv = remote1.peers_view("r1")
        assert lv.version == rv.version
        assert lv.node_rows == rv.node_rows
        assert lv.pod_rows == rv.pod_rows
        assert [r for r, _a in lv.peer_ages] == [
            r for r, _a in rv.peer_ages
        ]
    finally:
        remote0.close()
        remote1.close()


def test_remote_exchange_partition_maps_to_unreachable(hub_server):
    """The sim's partition seam crosses the wire as UNAVAILABLE and
    surfaces as ExchangeUnreachable — the staleness machinery
    needs exactly that type. Buffered stage rows survive the
    partition client-side and land at the first reachable flush."""
    hub, addr = hub_server
    remote = RemoteOccupancyExchange(addr, "r1")
    try:
        remote.publish_nodes("r1", [])
        hub.set_partitioned("r1", True)
        remote.stage("r1", _row())  # buffers client-side, no raise yet
        with pytest.raises(ExchangeUnreachable):
            remote.peers_view("r1")  # flush-before-read surfaces it
        # retained for retry (sealed under its flush_seq), not lost
        assert remote._pending_flush() == 1
        hub.set_partitioned("r1", False)
        remote.peers_view("r1")  # flush succeeds on heal
        assert remote._pending_flush() == 0
        assert [r.pod for r in hub.peers_view("rx").pod_rows] == [
            "default/p"
        ]
    finally:
        remote.close()


def test_remote_exchange_server_down_is_unreachable():
    remote = RemoteOccupancyExchange("127.0.0.1:1", "r0")
    try:
        with pytest.raises(ExchangeUnreachable):
            remote.peers_version("r0")
    finally:
        remote.close()


def test_remote_exchange_fence_maps_typed(hub_server):
    """A fenced CAS surfaces typed over the wire; a fenced write-
    behind flush silently DROPS its buffer (a retired replica's rows
    must not land — its healed incarnation re-registers wholesale)."""
    hub, addr = hub_server
    remote = RemoteOccupancyExchange(addr, "r0")
    try:
        remote.stage("r0", _row())
        remote.peers_version("r0")  # flush
        hub.retire("r0")
        with pytest.raises(AdmitConflict) as ei:
            remote.compare_and_stage(
                "r0", _row(pod="default/q"), hub.version
            )
        assert ei.value.fenced is True
        remote.stage("r0", _row(pod="default/z"))  # buffers
        remote.peers_version("r0")  # flush: fenced -> dropped, no raise
        assert not remote._buffer
        assert hub.peers_view("rx").pod_rows == ()  # nothing landed
        # the observed fence is sticky and surfaces TYPED at the next
        # mutation, so FleetRuntime flags the re-registering resync
        # exactly like the in-process path
        with pytest.raises(AdmitConflict) as ei2:
            remote.stage("r0", _row(pod="default/zz"))
        assert ei2.value.fenced is True
        remote.replace_pod_rows("r0", [_row()])  # re-registration
        remote.stage("r0", _row(pod="default/q"))
        remote.peers_version("r0")
        assert len(hub.peers_view("rx").pod_rows) == 2
    finally:
        remote.close()


def test_remote_exchange_write_behind_buffer(hub_server):
    """Plain stage/commit/withdraw buffer client-side and land as ONE
    apply_ops RPC at the next read — per-row unary RPCs were a
    measured ~4x throughput loss on the ladder #8 fleet arm — while
    the CAS path always flushes first so admission ordering holds."""
    hub, addr = hub_server
    remote = RemoteOccupancyExchange(addr, "r0")
    calls: list = []
    real = remote._client.hub_op
    remote._client.hub_op = lambda op, **m: (
        calls.append(op),
        real(op, **m),
    )[1]
    try:
        v0 = hub.version
        remote.stage("r0", _row(pod="default/a"))
        remote.stage("r0", _row(pod="default/b"))
        remote.commit("r0", "default/a")
        remote.withdraw("r0", "default/b")
        assert hub.version == v0  # nothing on the wire yet
        assert calls == []
        view_from_peer = remote.peers_view("r1")  # flush + read
        rows = {r.pod: r.state for r in view_from_peer.pod_rows}
        assert rows == {"default/a": "committed"}  # b staged+withdrawn
        # the whole 4-mutation buffer was ONE apply_ops RPC
        assert calls == ["apply_ops", "peers_view"]
    finally:
        remote.close()


def test_bulk_client_never_retries_cas_conflict(hub_server):
    """Satellite: a hub CAS conflict is a SEMANTIC rejection — it must
    surface immediately, never retry like UNAVAILABLE (the
    committing-Solve rule). A retried lost race would re-land the
    write the compare-and-stage exists to reject."""
    import grpc

    from kubernetes_tpu_torch import metrics
    from kubernetes_tpu_torch.fleet.occupancy import pod_row_to_list

    hub, addr = hub_server
    sleeps = []

    class SpyClock:
        def sleep(self, s):
            sleeps.append(s)

        def now(self):
            return 0.0

    client = BulkClient(addr, retries=3, clock=SpyClock())
    try:
        v = hub.version
        hub.stage("r1", _row(pod="default/winner"))  # moves the version
        before = metrics.bulk_retry_total.labels("HubOp")._value.get()
        with pytest.raises(grpc.RpcError) as ei:
            client.hub_op(
                "cas_stage", replica="r0",
                row=pod_row_to_list(_row()), expect=v,
            )
        assert ei.value.code() == grpc.StatusCode.ABORTED
        assert sleeps == []  # zero backoff sleeps = zero retries
        assert (
            metrics.bulk_retry_total.labels("HubOp")._value.get()
            == before
        )
        # fenced rejections are equally non-retryable
        hub.retire("r0")
        with pytest.raises(grpc.RpcError) as ei:
            client.hub_op(
                "stage", replica="r0", row=pod_row_to_list(_row())
            )
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert sleeps == []
    finally:
        client.close()


def test_bulk_client_retries_transient_hub_op(monkeypatch):
    """The flip side: UNAVAILABLE from a flaky channel still retries
    with FULL-JITTER backoff (hub ops get the same transient hygiene
    as every bulk RPC when the caller opts into retries): each wait is
    uniform over [0, base * 2^attempt) so N clients losing the same
    server never re-arrive in lockstep."""
    import random

    import grpc

    class FakeErr(grpc.RpcError):
        def code(self):
            return grpc.StatusCode.UNAVAILABLE

    sleeps = []

    class SpyClock:
        def sleep(self, s):
            sleeps.append(s)

        def now(self):
            return 0.0

    client = BulkClient.__new__(BulkClient)
    client._grpc = grpc
    client.retries = 2
    client.deadline_s = 1.0
    client.backoff_base_s = 0.01
    client._clock = SpyClock()
    client._backoff_rng = random.Random(0)
    calls = {"n": 0}

    from kubernetes_tpu_torch.server import tensorcodec

    def flaky(payload, timeout):
        calls["n"] += 1
        if calls["n"] < 3:
            raise FakeErr()
        return tensorcodec.encode({"version": 7})

    client._hub_op = flaky
    assert client.hub_op("version") == {"version": 7}
    assert calls["n"] == 3 and len(sleeps) == 2
    # full jitter: draws land inside the doubling caps and match the
    # injected stream exactly (deterministic given the seeded rng)
    rng = random.Random(0)
    assert sleeps == [rng.uniform(0.0, 0.01), rng.uniform(0.0, 0.02)]
    assert 0.0 <= sleeps[0] < 0.01 and 0.0 <= sleeps[1] < 0.02


# -- the two-process race (acceptance) ---------------------------------------


def _race_worker(addr, rid, barrier, out_q):
    # deliberately light imports: the race worker needs only the hub
    # client surface, not jax
    from kubernetes_tpu_torch.fleet import (
        AdmitConflict,
        PodRow,
        RemoteOccupancyExchange,
    )

    remote = RemoteOccupancyExchange(addr, rid)
    try:
        # both processes admit against the SAME view version, exactly
        # the racing-replicas interleave
        view = remote.peers_view(rid)
        barrier.wait(timeout=30)
        row = PodRow(
            pod=f"default/{rid}", node=f"{rid}-node", zone="z0",
            namespace="default", labels=(("app", "spread"),),
        )
        try:
            remote.compare_and_stage(rid, row, view.version)
            out_q.put((rid, "won", None))
        except AdmitConflict as e:
            out_q.put((rid, "conflict", bool(e.fenced)))
    finally:
        remote.close()


def test_two_process_race_exactly_one_winner():
    """two OS processes race a hard-spread
    placement through the real gRPC hub — both pass their host-side
    check against the same view; the hub's fenced compare-and-swap
    lets exactly ONE land and hands the loser a typed conflict (the
    loser's scheduler requeues it through the ordinary machinery)."""
    hub = OccupancyExchange()
    core = BulkCore(ClusterState(), exchange=hub, device="cpu")
    server, port = make_grpc_server(core, port=0)
    server.start()
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    out_q = ctx.Queue()
    procs = [
        ctx.Process(
            target=_race_worker,
            args=(f"127.0.0.1:{port}", rid, barrier, out_q),
        )
        for rid in ("r0", "r1")
    ]
    try:
        for p in procs:
            p.start()
        results = [out_q.get(timeout=60) for _ in procs]
        outcomes = sorted(o for _rid, o, _f in results)
        assert outcomes == ["conflict", "won"], results
        # the loser's conflict was the version race, not a fence
        fenced = [f for _rid, o, f in results if o == "conflict"]
        assert fenced == [False]
        # exactly one pending row landed at the hub
        rows = hub.peers_view("observer").pod_rows
        winner = [rid for rid, o, _f in results if o == "won"][0]
        assert [r.pod for r in rows] == [f"default/{winner}"]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        server.stop(grace=None)


# -- gRPC-hub fleet sim equivalence ------------------------------------------


def test_fleet_sim_grpc_hub_clean_and_deterministic():
    """The whole fleet drive through the wire-backed hub settles clean
    under every invariant (overcommit/constraints/journal/lost-pod)
    and is byte-deterministic run-to-run: RPC wall time never enters
    the virtual clock. (It is deliberately NOT byte-compared against
    the in-process drive — the client's write-behind buffer re-times
    hub version bumps, which re-times conflict-parked wakeups; the
    cross-transport contract is the invariants.)"""
    from kubernetes_tpu_torch.sim.fleet import run_fleet_sim

    wired = run_fleet_sim(
        "fleet_mixed", seed=3, cycles=6, replicas=2, grpc_hub=True, device="cpu"
    )
    again = run_fleet_sim(
        "fleet_mixed", seed=3, cycles=6, replicas=2, grpc_hub=True, device="cpu"
    )
    assert wired.ok and again.ok
    assert wired.summary["hub"] == "grpc"
    assert wired.journal_digests == again.journal_digests
    assert wired.bindings == again.bindings
    # the drive actually exercised the wire-side fleet machinery
    assert sum(wired.summary["binds_by_replica"].values()) > 0


# -- per-replica mesh slices ------------------------------------------------


def test_fleet_replica_with_a_mesh_slice_raises_naming_item_11():
    """A fleet replica's exclusive mesh slice resolves with the JAX
    package's arithmetic: a 0/2 slice of one visible device raises its
    ValueError at construction (no disjoint share for each replica), and
    with two visible devices the replica gets a 1-way mesh pinned to the
    first and schedules on it."""
    from kubernetes_tpu_torch.parallel import sharding

    cluster = ClusterState()
    with pytest.raises(ValueError, match="needs at least 2 visible devices"):
        Scheduler(
            cluster,
            SchedulerConfig(
                fleet=FleetConfig(
                    replica="r0", replicas=("r0", "r1"),
                    exchange=OccupancyExchange(),
                ),
                mesh_slice=(0, 2),
            ),
            device="cpu",
        )
    sharding.force_device_count(2, "cpu")
    try:
        sched = Scheduler(
            cluster,
            SchedulerConfig(
                fleet=FleetConfig(
                    replica="r0", replicas=("r0",), exchange=OccupancyExchange(),
                ),
                mesh_slice=(0, 2),
            ),
            device="cpu",
        )
    finally:
        sharding.force_device_count(None)
    assert sched.mesh.size == 1 and sched.mesh.devices == (torch.device("cpu"),)
    assert sched.resilience.ladder[0] == "mesh"
    for i in range(4):
        cluster.create_node(make_node(f"n{i}", "8", "32Gi", labels={ZONE: f"z{i % 2}"}))
    for i in range(6):
        cluster.create_pod(make_pod(f"p{i}", "250m", shape="spread"))
    sched.run_until_settled()
    assert all(p.node_name for p in cluster.list_pods())
