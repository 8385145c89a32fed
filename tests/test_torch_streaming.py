"""The port's run_streaming against the JAX package's on the CPU.

The scenarios of ``tests/test_streaming_shapes.py`` but its two sim tests
(``sustained_stream`` and the dispatcher override run through
``run_sim``, which waits for the sim: ROADMAP queue 1 item 8). Each is
built once in the JAX package's ``ClusterState`` and carried across
(``_torch_sched_pair.Pair``); both schedulers run on a ``FakeClock`` in
``tie_break="first"`` with float64 balanced scores and must give the same
BatchResults in order, bindings, nominations and counter deltas
(attempts, modes, slot discards, fallbacks, discards, sub-batches). The
JAX tests' own claims (streaming == sync, journal equivalence, chaining
engaged, exactly one slot discarded) are checked on the port too.
"""

import dataclasses
import gc
from collections import Counter

import numpy as np
import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.obs import ObsConfig as RefObsConfig
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch import metrics as port_metrics
from kubernetes_tpu_torch.obs import ObsConfig

from _torch_sched_pair import PARITY, Pair, settle_flight

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def mk_cluster(n_nodes=6, cpu="8"):
    cs = ClusterState()
    for i in range(n_nodes):
        cs.create_node(
            MakeNode().name(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi", "pods": "110"})
            .label(ZONE, f"z{i % 3}").label(HOST, f"n{i}").obj()
        )
    return cs


def shape_pod(i, kind):
    b = MakePod().name(f"{kind}{i:03}").req({"cpu": "100m", "memory": "256Mi"})
    if kind == "spread":
        b = b.label("app", "spread").spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"})
    elif kind == "anti":
        b = b.label("app", "anti").pod_anti_affinity(HOST, {"app": "anti"})
    elif kind == "ports":
        b = b.host_port(8000 + i % 3)
    return b.obj()


def bindings(cs):
    return sorted((p.name, p.node_name) for p in cs.list_pods())


def mk_pair(cs, batch=8, group=4, depth=4, journal=False, **cfg):
    obs = {}
    if journal:
        obs = dict(obs=ObsConfig(journal=True), ref_config={"obs": RefObsConfig(journal=True)})
    return Pair(cs, solver=dict(PARITY, group_size=group), batch_size=batch,
                stream_depth=depth, **obs, **cfg)


def shaped(kind, n_pods, n_nodes=6, **kw):
    cs = mk_cluster(n_nodes)
    for i in range(n_pods):
        cs.create_pod(shape_pod(i, kind))
    return mk_pair(cs, **kw)


def outcomes(journal):
    return {k: (r.get("outcome"), r.get("node")) for k, r in journal.last_outcomes().items()}


def _equivalence(kind, n_pods=24, n_nodes=6, batch=8):
    sync = shaped(kind, n_pods, n_nodes, batch=batch, journal=True)
    sync.run("settled")
    pair = shaped(kind, n_pods, n_nodes, batch=batch, journal=True)
    before = port_metrics.pipeline_mode_total.labels("stream")._value.get()
    pair.run("streaming")
    pair.assert_equal()
    assert port_metrics.pipeline_mode_total.labels("stream")._value.get() > before
    assert bindings(pair.cluster) == bindings(sync.cluster), kind
    assert outcomes(pair.port.journal) == outcomes(sync.port.journal)
    assert outcomes(pair.port.journal) == outcomes(pair.ref.journal)
    chained = pair.port.solver.dispatch_counts.get("stream_chained", 0)
    assert chained == pair.ref.solver.dispatch_counts.get("stream_chained", 0)
    return pair, chained


def test_plain_streaming_matches_sync_and_chains():
    _, chained = _equivalence("plain")
    assert chained > 0


def test_ports_streaming_matches_sync():
    pair, chained = _equivalence("ports")
    assert chained > 0
    seen = set()
    for p in pair.cluster.list_pods():
        for port in p.host_ports() if p.node_name else ():
            assert (p.node_name, port) not in seen
            seen.add((p.node_name, port))


def test_spread_streaming_matches_sync():
    pair, chained = _equivalence("spread")
    assert chained > 0
    node_zone = {n.name: n.labels[ZONE] for n in pair.cluster.list_nodes()}
    zones = Counter(node_zone[p.node_name] for p in pair.cluster.list_pods() if p.node_name)
    assert max(zones.values()) - min(zones.values()) <= 1


def test_anti_streaming_matches_sync():
    pair, chained = _equivalence("anti", n_pods=12, n_nodes=12, batch=4)
    assert chained > 0
    nodes = [p.node_name for p in pair.cluster.list_pods() if p.node_name]
    assert len(set(nodes)) == len(nodes) == 12


def test_dra_streaming_matches_sync():
    from kubernetes_tpu.api.dra import Device, DeviceClass, DeviceRequest, ResourceClaim, ResourceSlice
    from kubernetes_tpu.utils.featuregate import FeatureGates as RefGates
    from kubernetes_tpu_torch.utils.featuregate import FeatureGates

    def mk():
        cs = ClusterState()
        for i in range(3):
            cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj())
            cs.create_resource_slice(
                ResourceSlice(name=f"slice-n{i}", node_name=f"n{i}", driver="gpu.example.com",
                              devices=(Device(name="gpu-0"), Device(name="gpu-1")))
            )
        cs.create_device_class(DeviceClass(name="gpu", driver="gpu.example.com"))
        for i in range(4):
            cs.create_resource_claim(
                ResourceClaim(name=f"c{i}", namespace="default",
                              requests=(DeviceRequest(name="r0", device_class_name="gpu"),))
            )
        for i in range(4):
            cs.create_pod(MakePod().name(f"p{i}").req({"cpu": "1"}).resource_claim(f"c{i}").obj())
        gate = "DynamicResourceAllocation=true"
        return Pair(cs, solver=dict(PARITY, group_size=1), batch_size=2,
                    feature_gates=FeatureGates.parse(gate),
                    ref_config={"feature_gates": RefGates.parse(gate)})

    sync = mk()
    sync.run("settled")
    pair = mk()
    pair.run("streaming")
    pair.assert_equal()
    assert bindings(pair.cluster) == bindings(sync.cluster)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_multi_profile_streaming_matches_sync():
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefCfg
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig

    def mk():
        cs = mk_cluster(4)
        for i in range(6):
            cs.create_pod(MakePod().name(f"a{i}").req({"cpu": "500m"}).obj())
            cs.create_pod(MakePod().name(f"b{i}").scheduler_name("alt").req({"cpu": "500m"}).obj())
        sv = dict(PARITY, group_size=4)
        names = ("default-scheduler", "alt")
        return Pair(cs, solver=sv, batch_size=8,
                    profiles={n: ExactSolverConfig(**sv) for n in names},
                    ref_config={"profiles": {n: RefCfg(**sv) for n in names}})

    sync = mk()
    sync.run("settled")
    pair = mk()
    pair.run("streaming")
    pair.assert_equal()
    assert bindings(pair.cluster) == bindings(sync.cluster)


def test_chain_survives_ring_fill():
    sync = shaped("spread", 40, batch=4, journal=True)
    sync.run("settled")
    pair = shaped("spread", 40, batch=4, depth=2, journal=True)
    pair.run("streaming")
    pair.assert_equal()
    chained = pair.port.solver.dispatch_counts.get("stream_chained", 0)
    assert chained >= 8
    assert chained == pair.ref.solver.dispatch_counts.get("stream_chained", 0)
    assert bindings(pair.cluster) == bindings(sync.cluster)


def one_shot(pair, fire):
    """A post-dispatch hook on each side that lands ``fire(cluster)``
    while that side's first dispatched slot is in flight."""
    for s, cs in pair.sides():
        state = {"fired": False}

        def hook(flight, state=state, cs=cs):
            if not state["fired"]:
                state["fired"] = True
                settle_flight(flight)
                fire(cs)

        s._post_dispatch_hook = hook


def with_old(kind, label, n_pods, n_nodes=6):
    cs = mk_cluster(n_nodes)
    cs.create_pod(MakePod().name("old").label("app", label).req({"cpu": "1"}).obj())
    cs.bind("default", "old", "n0")
    for i in range(n_pods):
        cs.create_pod(shape_pod(i, kind))
    return mk_pair(cs, batch=4)


def test_occupancy_event_kills_exactly_one_stream_slot():
    pair = with_old("spread", "spread", 8)

    def fire(cs):
        cs.update_pod(dataclasses.replace(cs.get_pod("default", "old"), labels={"app": "other"}))

    one_shot(pair, fire)
    slot0 = port_metrics.stream_slot_discard_total._value.get()
    disc0 = port_metrics.solves_discarded_total._value.get()
    pair.run("streaming")
    pair.assert_equal()
    assert port_metrics.stream_slot_discard_total._value.get() - slot0 == 1
    assert port_metrics.solves_discarded_total._value.get() - disc0 >= 1
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_plain_slot_survives_occupancy_events():
    pair = with_old("plain", "x", 8, n_nodes=3)
    one_shot(pair, lambda cs: cs.delete_pod("default", "old"))
    slot0 = port_metrics.stream_slot_discard_total._value.get()
    _, port = pair.run("streaming")
    pair.assert_equal()
    assert port_metrics.stream_slot_discard_total._value.get() - slot0 == 0
    assert sum(len(r.scheduled) for r in port) == 8


def test_conflict_event_discards_chained_successors_together():
    pair = shaped("plain", 8, n_nodes=4, batch=4, depth=4)
    for s, cs in pair.sides():
        fired = {"n": 0}

        def hook(flight, fired=fired, cs=cs):
            settle_flight(flight)
            fired["n"] += 1
            if fired["n"] == 2:  # both slots dispatched, neither applied
                node = cs.get_node("n3")
                alloc = dict(node.allocatable)
                alloc["cpu"] = max(alloc.get("cpu", 0) - 1000, 1000)
                cs.update_node(dataclasses.replace(node, allocatable=alloc))

        s._post_dispatch_hook = hook
    slot0 = port_metrics.stream_slot_discard_total._value.get()
    pair.run("streaming")
    pair.assert_equal()
    assert port_metrics.stream_slot_discard_total._value.get() - slot0 == 2
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_stale_slot_discarded_after_assigned_pod_delete():
    """A bound pod of the shape is deleted while the first slot is in the
    ring: that slot discards and the run still binds every pod, equal to
    the JAX package."""
    pair = with_old("anti", "anti", 5)
    one_shot(pair, lambda cs: cs.delete_pod("default", "old"))
    slot0 = port_metrics.stream_slot_discard_total._value.get()
    pair.run("streaming")
    pair.assert_equal()
    assert port_metrics.stream_slot_discard_total._value.get() - slot0 == 1
    nodes = [p.node_name for p in pair.cluster.list_pods() if p.node_name]
    assert len(nodes) == 5 and len(set(nodes)) == 5


def _staging_case(pkg):
    """test_port_staging_reuses_across_unchanged_batches on one package:
    the port tensors of each build, and the staging's hit/miss counts."""
    import importlib

    wr = importlib.import_module(f"{pkg}.api.wrappers")
    pl = importlib.import_module(f"{pkg}.tensorize.plugins")
    schema = importlib.import_module(f"{pkg}.tensorize.schema")
    Snapshot = importlib.import_module(f"{pkg}.state.snapshot").Snapshot
    SchedulerCache = importlib.import_module(f"{pkg}.state.cache").SchedulerCache
    Clock = importlib.import_module(f"{pkg}.utils.clock").Clock

    def pod(i):
        return wr.MakePod().name(f"ports{i:03}").req({"cpu": "100m", "memory": "256Mi"}).host_port(8000 + i % 3).obj()

    cache = SchedulerCache(Clock())
    for i in range(2):
        cache.add_node(wr.MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
    placed = wr.MakePod().name("old").req({"cpu": "1"}).host_port(9000).obj()
    placed.node_name = "n0"
    cache.add_pod(placed)
    snap = Snapshot()
    batch = snap.update(cache)
    slot_nodes = [cache.nodes[n].node if n else None for n in snap.names]
    by_slot = {
        slot: list(cache.nodes[n].pods.values())
        for slot, n in enumerate(snap.names) if n and cache.nodes[n].pods
    }
    staging = pl.PortStaging()
    key = (cache.generation, batch.padded)
    out = []
    for lo in (0, 3):
        pods = [pod(i + lo) for i in range(3)]
        pb = schema.build_pod_batch(pods, batch.vocab)
        out.append(pl.build_port_tensors(pods, pb, slot_nodes, by_slot, batch.padded,
                                         staging=staging, staging_key=key))
        out.append(pl.build_port_tensors(pods, pb, slot_nodes, by_slot, batch.padded))
    counts = [(staging.hits, staging.misses)]
    cache.add_pod(wr.MakePod().name("new").req({"cpu": "1"}).host_port(9100).obj())
    out.append(pl.build_port_tensors(pods, pb, slot_nodes, by_slot, batch.padded, staging=staging,
                                     staging_key=(cache.generation, batch.padded)))
    counts.append((staging.hits, staging.misses))
    return out, counts


def test_port_staging_reuses_across_unchanged_batches():
    ref, ref_counts = _staging_case("kubernetes_tpu")
    port, counts = _staging_case("kubernetes_tpu_torch")
    assert counts == ref_counts == [(1, 1), (1, 2)]
    for r, p in zip(ref, port):
        assert p.vocab == r.vocab
        np.testing.assert_array_equal(p.used, r.used)
        np.testing.assert_array_equal(p.pod_conflict, r.pod_conflict)
    staged, fresh = port[2], port[3]
    for entry in fresh.vocab:  # the staged occupancy equals a fresh build
        np.testing.assert_array_equal(fresh.used[fresh.vocab.index(entry)],
                                      staged.used[staged.vocab.index(entry)])


def test_streaming_uses_port_staging():
    pair = shaped("ports", 12, batch=4)
    pair.run("streaming")
    pair.assert_equal()
    assert pair.port._port_staging.hits > 0
    assert pair.port._port_staging.hits == pair.ref._port_staging.hits


def test_completion_thread_exits_when_scheduler_collected():
    """The completion thread's static target holds no reference to its
    Scheduler; collecting the Scheduler (and the cluster whose watch
    subscription holds it) wakes the thread and it exits."""
    from kubernetes_tpu_torch import convert
    from kubernetes_tpu_torch.api.wrappers import MakePod as PMakePod
    from kubernetes_tpu_torch.scheduler import Scheduler, SchedulerConfig

    cs = convert.cluster_state(mk_cluster(2))
    s = Scheduler(cs, SchedulerConfig(batch_size=4), device="cpu")
    cs.create_pod(PMakePod().name("p0").req({"cpu": "100m"}).obj())
    s.run_streaming()
    assert cs.get_pod("default", "p0").node_name
    t = s._completion_thread
    assert t is not None and t.is_alive()
    del s, cs
    gc.collect()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("loop", ["pipelined", "streaming"])
def test_default_random_config_invariants_and_tie_set(loop):
    """The production default config ("random", group 64): through each
    loop the port binds every pod where the JAX package's does (its
    threefry stream, bit for bit), every feasible pod binds, the
    invariants hold, and every pick replays into the oracle's tie set in
    bind order."""
    from kubernetes_tpu_torch.ops.oracle.profile import FullOracle, make_oracle_nodes
    from test_torch_scheduler import _check_invariants, _mixed_pod
    from test_torch_scheduler import mk_cluster as zoned_cluster

    cs = zoned_cluster(16, zones=3)
    for i in range(120):
        cs.create_pod(_mixed_pod(i) if i % 3 else
                      MakePod().name(f"m{i:03}").req({"cpu": "250m", "memory": "512Mi"}).obj())
    pair = Pair(cs, solver=dict(seed=3), batch_size=32)
    port_cs = pair.cluster
    nodes = port_cs.list_nodes()
    pods = {p.key: p for p in port_cs.list_pods()}
    _, results = pair.run(loop)
    pair.assert_equal()
    order = [x for r in results for x in r.scheduled]
    lb = [p for p in pods.values() if p.labels.get("app") == "lb"]
    assert len(order) == len(pods) - max(len(lb) - len(nodes), 0)
    _check_invariants(port_cs)
    errors = FullOracle(make_oracle_nodes(nodes)).validate_assignments(
        [pods[k] for k, _ in order], [0] * len(order), names=[n for _, n in order]
    )
    assert not errors, "\n".join(errors[:5])


# -- random mode: the JAX package's threefry stream, bit for bit ---------------


def _random_solvers(group, seed):
    from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
    from kubernetes_tpu_torch import convert
    from kubernetes_tpu_torch.solver.exact import ExactSolver

    cfg = RefConfig(tie_break="random", seed=seed, balanced_fdtype="float64", group_size=group)
    return ExactSolver(convert.solver_config(cfg)), RefSolver(cfg)


def test_random_mode_session_heal_split_and_stream_carry_equal_the_jax_package():
    """tie_break="random" through one grouped solver of each package:
    session solves with a heal after an external binding, a batch as two
    chained sub-batches (each its own ``fold_in`` stream), and a batch that keeps
    the stream carry and the next one that starts from it. Every batch
    equals the JAX package's bit for bit, dispatch counts included, and
    the draws matter: "first" mode places the first batch elsewhere."""
    from kubernetes_tpu_torch import convert
    from test_torch_session import Cluster, _gather, _pods, _stream_batch, standalone

    cluster = Cluster()
    group = 16
    port, ref = _random_solvers(group, seed=5)

    def session(pods, **kw):
        got = port.solve(*convert.solve_inputs(*cluster.tensorize(pods)),
                         col_versions=cluster.versions.copy(), device="cpu", **kw)
        want = ref.solve(*cluster.tensorize(pods), col_versions=cluster.versions.copy(), **kw)
        if kw.get("defer_read"):
            got, want = _gather(got), _gather(want)
        np.testing.assert_array_equal(got, want)
        return got

    pods = _pods(0, 64)
    got = session(pods)
    assert (got != standalone(cluster, pods, group)).any()
    cluster.apply(pods, got)
    cluster.external(4, "ext-0")  # dirties a column: the next solve heals it
    pods = _pods(1, 64)
    cluster.apply(pods, session(pods))
    pods = _pods(2, 64)
    cluster.apply(pods, session(pods, defer_read=True, split=2))
    kinds = ("spread", "plain")
    pods = _pods(3, 64, kinds)
    got, r_got, _ = _stream_batch(cluster, port, ref, pods, stream_carry_out=True, split=2)
    np.testing.assert_array_equal(got, r_got)
    cluster.apply(pods, got)
    port.note_stream_applied(cluster.versions.copy())
    ref.note_stream_applied(cluster.versions.copy())
    pods = _pods(4, 64, kinds)
    got, r_got, _ = _stream_batch(cluster, port, ref, pods, chain_occupancy=True,
                                  stream_carry_out=True, allow_heal=False)
    np.testing.assert_array_equal(got, r_got)
    assert dict(port.dispatch_counts) == dict(ref.dispatch_counts)
    assert port.dispatch_counts["stream_chained"] == 1
    assert port.dispatch_counts["chained_subbatches"] >= 4

