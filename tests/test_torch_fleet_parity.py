"""The port's fleet against the JAX package's, on the same seeded inputs.

Each case runs one drive twice, once over each package's modules (the
port's with ``device="cpu"``), and holds the two results equal: the ring's
node owners and its remaps when the membership changes, the membership
flips, the drain ledger's partitions, grants, claims and returns, the
occupancy rows' wire bytes (encoded by one package, decoded by the other,
both ways), ``dispatch_hub_op``'s replies, the hub's HA failover (epochs,
``HubDeposed``, the SQLite lease on a temporary file), a two-replica
fleet's bindings and journals in ``tie_break="first"`` mode, and
``fleet_drain_backlog``'s drained pods and leases. Sizes are small: 6–24
nodes, 2–3 replicas.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu
import kubernetes_tpu_torch

SEEDS = (0, 1, 2)


def _pkg(root):
    """The fleet-facing modules of one package."""
    import importlib

    name = root.__name__
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        name=name,
        fleet=mod("fleet"),
        ring=mod("fleet.ring"),
        membership=mod("fleet.membership"),
        drain=mod("fleet.drain"),
        occupancy=mod("fleet.occupancy"),
        ha=mod("fleet.ha"),
        leasestore=mod("fleet.leasestore"),
        scheduler=mod("scheduler"),
        exact=mod("solver.exact"),
        cluster=mod("state.cluster"),
        clock=mod("utils.clock"),
        gen=mod("sim.generators"),
        obs=mod("obs"),
        budget=mod("solver.budget"),
    )


PORT = _pkg(kubernetes_tpu_torch)
JAX = _pkg(kubernetes_tpu)


def both(drive, *args):
    """``drive(P, *args)`` over each package; the two results must be
    equal, and the port's is returned."""
    ours = drive(PORT, *args)
    theirs = drive(JAX, *args)
    assert ours == theirs
    return ours


def _nodes(P, n, zones, seed):
    rng = random.Random(seed)
    return [
        P.gen.make_node(f"n{i:02d}", rng.choice(("4", "8")), "16Gi",
                        labels={P.gen.ZONE_KEY: f"z{i % zones}"})
        for i in range(n)
    ]


# -- the ring and the membership ---------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_owners_and_remaps_equal(seed):
    def drive(P, seed):
        universe = ("r0", "r1", "r2")
        ring = P.ring.HashRing(universe)
        nodes = P.ring.ring_nodes_from(_nodes(P, 6 + 6 * seed, 3, seed))
        full = ring.assign(nodes)
        routes = {f"default/p{i}": ring.route(f"default/p{i}") for i in range(24)}
        # a replica dies: the survivors' ring re-owns its nodes
        survivors = ring.with_alive(("r0", "r2"))
        remapped = survivors.assign(nodes)
        moved = sorted(n for n in full if full[n] != remapped[n])
        return full, routes, remapped, moved, P.ring._h("a", "b")

    full, _routes, remapped, moved, _ = both(drive, seed)
    assert set(full.values()) <= {"r0", "r1", "r2"}
    assert set(remapped.values()) <= {"r0", "r2"}
    # only the dead replica's nodes move
    assert all(full[n] == "r1" for n in moved)


def test_membership_flips_equal():
    def drive(P):
        m = P.membership.FleetMembership(("r2", "r0", "r1"), "r0")
        out = [m.universe, m.alive(), m.version]
        out.append(m.mark_dead("r1"))
        out += [m.alive(), m.version, m.is_alive("r1")]
        out.append(m.mark_dead("r1"))  # already dead: no flip
        out.append(m.mark_dead("r0"))  # self never dies here
        out.append(m.mark_alive("r1"))
        out.append(m.set_alive(("r2",)))  # self stays a member
        out += [m.alive(), m.version]
        out.append([P.membership.shard_index(("r0", "r1", "r2"), r) for r in ("r0", "r1", "r2")])
        return out

    both(drive)


# -- the drain ledger ---------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_drain_ledger_grants_claims_and_returns_equal(seed):
    def drive(P, seed):
        rng = random.Random(seed)
        nodes = [f"n{i}" for i in range(12)]
        assignment = {n: f"r{i % 3}" for i, n in enumerate(nodes)}
        keys = [f"default/p{i:03d}" for i in range(40)]
        planned = {k: (rng.choice(nodes) if rng.random() < 0.9 else None) for k in keys}
        gangs = {k: (f"g{i // 4}" if i % 10 < 4 else "") for i, k in enumerate(keys)}
        cross = {k: rng.random() < 0.1 for k in keys}
        parts, residual = P.drain.partition_backlog(
            keys, planned, assignment, gang_of=gangs.get, cross_shard=cross.get)
        state = P.drain.new_state(parts, residual, epoch=1, membership_version=3)
        log = [parts, residual]
        leases = {}
        for r in ("r0", "r1", "r2"):
            lease, reassigned = P.drain.claim(state, r)
            leases[r] = lease
            log.append((lease, reassigned))
        # r0 drains half its lease; r1 dies holding its lease
        half = list(leases["r0"]["keys"])[: len(leases["r0"]["keys"]) // 2]
        log.append(P.drain.progress(state, "r0", half))
        log.append(P.drain.return_leases(state, "r1"))
        log.append(P.drain.outstanding_keys(state))
        # survivors re-claim r1's remainder, then everyone completes
        for r in ("r2", "r0", "r2", "r0"):
            lease, reassigned = P.drain.claim(state, r)
            log.append((lease, reassigned))
            if lease:
                log.append(P.drain.progress(state, r, lease["keys"]))
                log.append(P.drain.complete(state, r, lease["id"]))
        log.append(P.drain.progress(state, "r0", leases["r0"]["keys"]))
        log.append(P.drain.complete(state, "r0", leases["r0"]["id"]))
        log.append(P.drain.complete(state, "r2", leases["r2"]["id"]))
        log.append(P.drain.status(state))
        log.append(state)
        return log

    log = both(drive, seed)
    assert log[-1]["reassigned"] >= 1


# -- the occupancy rows on the wire -------------------------------------------


def _rows(P, seed):
    rng = random.Random(seed)
    nodes = [P.occupancy.NodeRow(f"n{i}", f"z{i % 3}") for i in range(rng.randint(6, 24))]
    pods = [
        P.occupancy.PodRow(
            pod=f"default/p{i}", node=f"n{rng.randrange(len(nodes))}",
            zone=f"z{rng.randrange(3)}", namespace="default",
            labels=tuple(sorted({("app", rng.choice(("web", "db"))), ("tier", str(i % 2))})),
            state=rng.choice((P.occupancy.PENDING, P.occupancy.COMMITTED)),
        )
        for i in range(rng.randint(0, 30))
    ]
    return nodes, pods


@pytest.mark.parametrize("seed", SEEDS)
def test_occupancy_rows_cross_the_packages_byte_for_byte(seed):
    """Rows encoded by one package decode in the other to the same rows,
    and re-encode to the same bytes, both ways."""
    blobs = {}
    for P in (PORT, JAX):
        nodes, pods = _rows(P, seed)
        blobs[P.name] = P.occupancy.encode_rows("r1", 7 + seed, nodes, pods)
    assert blobs[PORT.name] == blobs[JAX.name]
    for src, dst in ((PORT, JAX), (JAX, PORT)):
        replica, version, nodes, pods = dst.occupancy.decode_rows(blobs[src.name])
        assert (replica, version) == ("r1", 7 + seed)
        assert dst.occupancy.encode_rows(replica, version, nodes, pods) == blobs[src.name]
        ref_nodes, ref_pods = _rows(dst, seed)
        assert list(nodes) == list(ref_nodes) and list(pods) == list(ref_pods)


# -- the hub's op table -------------------------------------------------------


def test_dispatch_hub_op_replies_equal():
    """One hub session through ``dispatch_hub_op``, the op table both
    transports share, with the drain ledger and the typed rejections:
    every reply (or exception type and message) equal."""

    def drive(P):
        clock = P.clock.FakeClock()
        hub = P.occupancy.OccupancyExchange(clock)
        row = lambda pod, node, state="pending": [  # noqa: E731
            pod, node, "z0", "default", [["app", "web"]], state]
        ops = [
            ("publish_nodes", {"replica": "r0", "nodes": [["n0", "z0"], ["n1", "z1"]]}),
            ("publish_nodes", {"replica": "r1", "nodes": [["n2", "z0"]]}),
            ("peers_version", {"replica": "r0"}),
            ("cas_stage", {"replica": "r0", "row": row("default/a", "n0"), "expect": 0}),
            ("cas_stage", {"replica": "r1", "row": row("default/b", "n2"), "expect": 0}),
            ("stage", {"replica": "r1", "row": row("default/c", "n2")}),
            ("commit", {"replica": "r1", "pod": "default/c"}),
            ("apply_ops", {"replica": "r0", "flush_seq": 1, "flush_client": "c0",
                           "ops": [["stage", row("default/d", "n1")], ["commit", "default/d"]]}),
            ("apply_ops", {"replica": "r0", "flush_seq": 1, "flush_client": "c0",
                           "ops": [["stage", row("default/d", "n1")]]}),
            ("peers_view", {"replica": "r1"}),
            ("drain_init", {"replica": "r0", "partitions": {"r0": ["default/x"], "r1": ["default/y"]},
                            "residual": ["default/z"], "membership_version": 1}),
            ("drain_claim", {"replica": "r1"}),
            ("drain_progress", {"replica": "r1", "keys": ["default/y"]}),
            ("drain_status", {}),
            ("retire", {"replica": "r1"}),
            ("stage", {"replica": "r1", "row": row("default/e", "n2")}),
            ("drain_claim", {"replica": "r0"}),
            ("hub_status", {}),
            ("no_such_op", {}),
        ]
        out = []
        for op, meta in ops:
            clock.advance(0.5)
            try:
                out.append(P.occupancy.dispatch_hub_op(hub, op, meta))
            except Exception as e:  # the typed rejections are part of the contract
                out.append((type(e).__name__, str(e)))
        return out

    replies = both(drive)
    assert replies[4][0] == "AdmitConflict"  # the lost version race
    assert replies[15][0] == "AdmitConflict"  # a retired replica is fenced
    assert replies[-1][0] == "ValueError"


# -- hub HA -------------------------------------------------------------------


@pytest.mark.parametrize("store", ["memory", "sqlite"])
def test_hub_failover_equal(store, tmp_path):
    """Primary and standby under one lease (in memory, or SQLite on a
    temporary file): the standby catches up through the op log, takes the
    lease when the primary stops renewing, and the deposed primary answers
    ``HubDeposed``; epochs only grow."""

    def drive(P, path):
        clock = P.clock.FakeClock()
        lease = (P.ha.HubLease(clock=clock, duration_s=2.0) if path is None
                 else P.leasestore.SqliteHubLease(path, clock=clock, duration_s=2.0))
        primary = P.occupancy.OccupancyExchange(clock=clock, hub_id="hub-a", lease=lease)
        standby = P.occupancy.OccupancyExchange(clock=clock, hub_id="hub-b", lease=lease)
        log = [primary.try_promote(), standby.try_promote()]
        rep = P.ha.StandbyReplicator(standby, P.ha.LocalHubClient(primary))
        primary.publish_nodes("r0", [P.occupancy.NodeRow("n1", "z0")])
        primary.stage("r0", P.occupancy.PodRow(
            pod="default/p", node="n1", zone="z0", namespace="default",
            labels=(("app", "x"),), state=P.occupancy.PENDING))
        primary.commit("r0", "default/p")
        log.append(rep.poll())
        log += [standby.version == primary.version, standby.replica_rows("r0")]
        clock.advance(3.0)  # the primary missed its renewals
        log.append(standby.try_promote())
        log += [primary.hub_epoch, standby.hub_epoch]
        try:
            primary.stage("r0", P.occupancy.PodRow(
                pod="default/q", node="n1", zone="z0", namespace="default",
                labels=(), state=P.occupancy.PENDING))
            log.append("landed")
        except P.occupancy.HubDeposed as e:
            log.append(("HubDeposed", e.epoch, e.role))
        log.append(P.occupancy.dispatch_hub_op(standby, "peers_view", {"replica": "r1"}))
        log.append(lease.epoch)
        return log

    paths = {}
    if store == "sqlite":
        paths = {PORT.name: str(tmp_path / "port.db"), JAX.name: str(tmp_path / "jax.db")}
    ours = drive(PORT, paths.get(PORT.name))
    theirs = drive(JAX, paths.get(JAX.name))
    # replica rows are each package's own dataclasses: compare as tuples
    norm = lambda log: [tuple(map(tuple, x)) if i == 4 else x for i, x in enumerate(log)]  # noqa: E731
    assert repr(norm(ours)) .replace("kubernetes_tpu_torch", "kubernetes_tpu") == repr(norm(theirs))
    assert ours[0] == 1 and ours[1] is None and ours[5] == 2
    assert ours[6] < ours[7] and ours[8][0] == "HubDeposed"


# -- two replicas, "first" mode -----------------------------------------------


def _fleet(P, n_nodes, universe, seed, *, hub=None, pods=32,
           kinds=("plain", "spread", "anti", "plain")):
    clock = P.clock.FakeClock()
    cs = P.cluster.ClusterState()
    for node in _nodes(P, n_nodes, 3, seed):
        cs.create_node(node)
    hub = hub or P.occupancy.OccupancyExchange(clock)
    kw = {"device": "cpu"} if P is PORT else {}
    scheds = [
        P.scheduler.Scheduler(
            cs,
            P.scheduler.SchedulerConfig(
                batch_size=16, mesh_devices=1,
                solver=P.exact.ExactSolverConfig(tie_break="first", balanced_fdtype="float64"),
                obs=P.obs.ObsConfig(journal=True),
                fleet=P.fleet.FleetConfig(replica=rid, replicas=universe, exchange=hub),
            ),
            clock=clock, **kw,
        )
        for rid in universe
    ]
    rng = random.Random(seed)
    for i in range(pods):
        kind = rng.choice(kinds)
        cs.create_pod(P.gen.make_pod(f"p{i:03d}", rng.choice(("250m", "500m")), shape=kind))
    return cs, clock, scheds, hub


def _drive(cs, clock, scheds, rounds=12):
    for _ in range(rounds):
        for s in scheds:
            s.run_until_settled()
        clock.advance(11.0)
        for s in scheds:
            with cs.lock:
                s.queue.move_all_to_active_or_backoff()
    return {p.key: p.node_name for p in cs.list_pods()}


@pytest.mark.parametrize("seed", SEEDS)
def test_two_replica_fleet_binds_as_the_jax_fleet(seed):
    def drive(P, seed):
        cs, clock, scheds, _hub = _fleet(P, 12, ("r0", "r1"), seed)
        bindings = _drive(cs, clock, scheds)
        journals = [list(s.journal.lines) for s in scheds]
        return bindings, journals

    bindings, _ = both(drive, seed)
    assert sum(1 for n in bindings.values() if n) >= 16


def test_fleet_drain_backlog_equal():
    """The fleet backlog drain: one global relax plan, the ledger at the
    hub, 2 replicas loop ``fleet_drain_backlog``: drained pods, leases and
    bindings equal, nothing lost or bound twice."""

    def drive(P):
        # plain pods that all fit: every lease completes (the spread
        # residual's cross-shard path is the fleet_backlog_drain profile's,
        # held in tests/test_torch_sim.py)
        cs, clock, scheds, hub = _fleet(P, 12, ("r0", "r1"), 0, pods=48, kinds=("plain",))
        kw = {"device": "cpu"} if P is PORT else {}
        planner = P.scheduler.Scheduler(
            cs, P.scheduler.SchedulerConfig(
                batch_size=16, mesh_devices=1,
                solver=P.exact.ExactSolverConfig(tie_break="first", balanced_fdtype="float64")),
            clock=clock, **kw)
        plan = planner.relax_plan_backlog()
        keys = list(plan)
        # the coordinator: partition by planned-node owner (spread pods
        # to the serialized residual) and install the ledger at the hub
        status = scheds[0].fleet.drain_init_from_plan(plan, keys)
        outs = [status]
        for _ in range(6):
            for s in scheds:
                out = s.fleet_drain_backlog(chunk_pods=16, budget_bytes=1 << 30,
                                            plan_keys=set(keys))
                outs.append((out["replica"], out["drained"], out["leases"], out["budget_bytes"]))
            # pods a replica handed off (a residual spread pod its shard
            # cannot host) land through the peer's ordinary loop, as the
            # fleet sim drives it when no lease is claimable
            _drive(cs, clock, scheds, rounds=1)
        bound = {p.key: p.node_name for p in cs.list_pods() if p.node_name}
        return outs, bound, hub.drain_status()

    outs, bound, status = both(drive)
    assert status["complete"] and status["done"] == 48
    assert len(bound) == 48 == sum(d for _r, d, _l, _b in outs[1:])
    assert {b for _r, _d, _l, b in outs[1:]} == {
        PORT.budget.split_fleet_budget(1 << 30, 2, replica_index=i) for i in (0, 1)}


def test_config_hub_address_replicas_bind_as_the_jax_fleet():
    """``fleet.hubAddress`` in a KubeSchedulerConfiguration: each package's
    two replicas reach their own package's hub over localhost gRPC
    (``RemoteOccupancyExchange``) and bind the same pods to the same nodes
    in "first" mode."""

    def drive(P):
        import importlib

        bulk = importlib.import_module(f"{P.name}.server.bulk")
        ct = importlib.import_module(f"{P.name}.config.types")
        kw = {"device": "cpu"} if P is PORT else {}
        clock = P.clock.FakeClock()
        cs = P.cluster.ClusterState()
        for node in _nodes(P, 9, 3, 0):
            cs.create_node(node)
        hub = P.occupancy.OccupancyExchange(clock)
        server, port = bulk.make_grpc_server(
            bulk.BulkCore(P.cluster.ClusterState(), exchange=hub, **kw))
        server.start()
        try:
            scheds = []
            for rid in ("r0", "r1"):
                sc = ct.scheduler_config(ct.load({
                    "tpuSolver": {"tieBreak": "first", "balancedFdtype": "float64",
                                  "batchSize": 16},
                    "fleet": {"replica": rid, "replicas": ["r0", "r1"],
                              "hubAddress": f"127.0.0.1:{port}"},
                }))
                scheds.append(P.scheduler.Scheduler(cs, sc, clock=clock, **kw))
            rng = random.Random(0)
            for i in range(24):
                cs.create_pod(P.gen.make_pod(f"p{i:03d}", "500m",
                                             shape=rng.choice(("plain", "anti"))))
            bindings = _drive(cs, clock, scheds, rounds=6)
            for s in scheds:
                s.fleet.exchange.close()
            rows = [(r.node, r.zone) for rid in ("r0", "r1") for r in hub.replica_rows(rid)[0]]
            return bindings, sorted(rows)
        finally:
            server.stop(grace=None)

    bindings, rows = both(drive)
    # every plain pod binds; hostname anti-affinity caps its pods at one a node
    assert sum(1 for n in bindings.values() if n) >= 16
    assert len(rows) == 9  # every node published by exactly one replica
