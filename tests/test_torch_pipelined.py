"""The port's run_pipelined against the JAX package's on the CPU.

The scenarios of ``tests/test_pipelined.py`` and
``tests/test_pipelined_shapes.py``, each built once in the JAX package's
``ClusterState`` and carried across (``_torch_sched_pair.Pair``). Both
schedulers run on a ``FakeClock`` with ``tie_break="first"`` and
``balanced_fdtype="float64"`` (the JAX one with ``mesh_devices=1``) and
must give the same BatchResults in order, bindings, nominations and
deltas of the attempt, pipeline-mode, slot-discard, fallback, discard and
sub-batch counters. Each JAX test's own claims (pipelined == sync, the
fence discards, the mode taken) are checked on the port as well.
"""

import numpy as np
import pytest

from kubernetes_tpu.api.wrappers import MakeNode, MakePod
from kubernetes_tpu.state.cluster import ClusterState
from kubernetes_tpu_torch import metrics as port_metrics
from kubernetes_tpu_torch.api.wrappers import MakeNode as PMakeNode

from _torch_sched_pair import PARITY, Pair, settle_flight

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def solver(group):
    return dict(PARITY, group_size=group)


def bindings(cs):
    return sorted((p.name, p.node_name) for p in cs.list_pods())


def finish(pair, loop="settled"):
    """Drain both with ``loop`` and hold the final comparison."""
    pair.run(loop)
    pair.assert_equal()


# -- tests/test_pipelined.py ------------------------------------------------


def build(n_nodes, cpu="8", batch=64, group=16, n_pods=0, pod_cpu="500m", zones=False):
    cs = ClusterState()
    for i in range(n_nodes):
        b = (
            MakeNode().name(f"n{i:03}")
            .capacity({"cpu": cpu, "memory": "32Gi", "pods": "110"})
            .label(HOST, f"n{i:03}")
        )
        if zones:
            b = b.label(ZONE, f"z{i % 3}")
        cs.create_node(b.obj())
    for i in range(n_pods):
        cs.create_pod(MakePod().name(f"p{i:04}").req({"cpu": pod_cpu, "memory": "1Gi"}).obj())
    return cs


def pair_of(cs, batch=64, group=16, **cfg):
    return Pair(cs, solver=solver(group), batch_size=batch, **cfg)


def test_pipelined_matches_sync_bindings():
    sync = pair_of(build(50, n_pods=300))
    sync.run("settled")
    pair = pair_of(build(50, n_pods=300))
    ref, port = pair.run("pipelined")
    pair.assert_equal()
    assert bindings(pair.cluster) == bindings(sync.cluster)
    assert sum(len(r.scheduled) for r in port) == 300
    assert len(port) >= 5


def test_pipelined_overfill_marks_unschedulable():
    pair = pair_of(build(4, n_pods=100))
    _, port = pair.run("pipelined")
    pair.assert_equal()
    assert sum(len(r.scheduled) for r in port) == 64
    assert sum(len(r.unschedulable) for r in port) == 36
    per_node = {}
    for p in pair.cluster.list_pods():
        if p.node_name:
            per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    assert all(v <= 16 for v in per_node.values())


def node_of(cpu, name="n000"):
    return (
        MakeNode().name(name).capacity({"cpu": cpu, "memory": "32Gi", "pods": "110"})
        .label(HOST, name).obj()
    )


def test_fence_discards_stale_solve_and_resolves_correctly():
    pair = pair_of(build(1, n_pods=10, pod_cpu="1"))
    d0 = port_metrics.solves_discarded_total._value.get()
    rf, pf = pair.flights()
    pair.update_node(node_of("3"))  # allocatable shrinks mid-flight
    _, res = pair.apply(rf, pf)
    assert not res.scheduled and not res.unschedulable
    assert port_metrics.solves_discarded_total._value.get() == d0 + 1
    assert pair.port._session_stale
    assert len(pair.port.queue) == 10
    assert all(i.attempts == 0 for i in pair.port.queue._info.values())
    finish(pair)
    assert len([p for p in pair.cluster.list_pods() if p.node_name]) == 3
    assert not pair.port._session_stale


def test_fence_ignores_irrelevant_events():
    pair = pair_of(build(2, n_pods=4))
    rf, pf = pair.flights()
    pair.update_node(node_of("8"))  # no allocatable/label/taint change
    _, res = pair.apply(rf, pf)
    assert len(res.scheduled) == 4
    assert not pair.port._session_stale
    pair.assert_equal()


def test_pipelined_external_delete_is_conservative_then_heals():
    cs = build(1, cpu="4")
    for i in range(3):
        cs.create_pod(MakePod().name(f"old{i}").req({"cpu": "1"}).obj())
        cs.bind("default", f"old{i}", "n000")
    for i in range(4):
        cs.create_pod(MakePod().name(f"new{i}").req({"cpu": "1"}).obj())
    pair = pair_of(cs, batch=2)
    rf, pf = pair.flights()
    pair.delete_pod("default", "old0")  # frees 1 cpu; does not bump the fence
    _, res = pair.apply(rf, pf)
    assert len(res.scheduled) == 1 and len(res.unschedulable) == 1
    finish(pair)
    placed = [p for p in pair.cluster.list_pods() if p.node_name and p.name.startswith("new")]
    assert len(placed) == 2


def _node_batch(n, used0=0, alloc=0):
    from kubernetes_tpu_torch.tensorize.schema import NodeBatch, ResourceVocab, pad_to

    vocab = ResourceVocab(("cpu", "memory", "ephemeral-storage"))
    npad = pad_to(n)
    live = np.arange(npad) < n
    used = np.zeros((3, npad), np.int64)
    used[0, 0] = used0
    return NodeBatch(
        vocab=vocab, names=[f"n{i}" for i in range(n)], num_nodes=n, padded=npad,
        allocatable=np.full((3, npad), alloc, np.int64), used=used,
        nonzero_used=used[:2].copy(), pod_count=np.zeros(npad, np.int32),
        max_pods=np.where(live, 110, 0).astype(np.int32), valid=live,
        schedulable=live.copy(),
    )


def test_session_drain_required_on_shape_change():
    import torch

    from kubernetes_tpu_torch.solver.session import SessionDrainRequired, _DeviceSession

    cpu = torch.device("cpu")
    sess = _DeviceSession()
    small = _node_batch(4)
    sess.sync(small, np.zeros(small.padded, np.int64), cpu)
    big = _node_batch(small.padded + 1)  # crosses the padding bucket
    with pytest.raises(SessionDrainRequired):
        sess.sync(big, np.zeros(big.padded, np.int64), cpu, allow_heal=False)
    sess.sync(big, np.zeros(big.padded, np.int64), cpu, allow_heal=True)
    assert sess.padded == big.padded


def test_deferred_heal_skips_and_later_heals():
    import torch

    from kubernetes_tpu_torch.solver.session import _DeviceSession

    cpu = torch.device("cpu")
    sess = _DeviceSession()
    vers = np.zeros(_node_batch(4).padded, np.int64)
    sess.sync(_node_batch(4, 0, 100), vers, cpu)
    assert int(sess.persist["i64"][0, 0]) == 0
    vers2 = vers.copy()
    vers2[0] = 1  # column 0 dirtied
    sess.sync(_node_batch(4, 7, 100), vers2, cpu, allow_heal=False)
    assert int(sess.persist["i64"][0, 0]) == 0  # deferred
    assert int(sess.seen_versions[0]) == 0
    sess.sync(_node_batch(4, 7, 100), vers2, cpu, allow_heal=True)
    assert int(sess.persist["i64"][0, 0]) == 7
    assert int(sess.seen_versions[0]) == 1


def spread_pod(i, prefix="s"):
    return (
        MakePod().name(f"{prefix}{i:03}").label("app", "w").req({"cpu": "100m"})
        .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "w"}).obj()
    )


def test_pipelined_nonplain_batch_matches_sync():
    def mk():
        cs = build(6, zones=True)
        for i in range(30):
            cs.create_pod(spread_pod(i))
        return pair_of(cs, batch=16, group=8)

    sync = mk()
    sync.run("settled")
    pair = mk()
    finish(pair, "pipelined")
    assert bindings(pair.cluster) == bindings(sync.cluster)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_pipelined_mixed_plain_and_nonplain():
    cs = build(8)
    for i in range(16):
        cs.create_pod(MakePod().name(f"plain{i:02}").req({"cpu": "100m"}).obj())
    for i in range(8):
        cs.create_pod(
            MakePod().name(f"anti{i}").label("app", "a").req({"cpu": "100m"})
            .pod_anti_affinity(HOST, {"app": "a"}).obj()
        )
    pair = pair_of(cs, batch=8, group=4)
    finish(pair, "pipelined")
    placed = [p for p in pair.cluster.list_pods() if p.node_name]
    assert len(placed) == 24
    anti = [p.node_name for p in placed if p.name.startswith("anti")]
    assert len(set(anti)) == 8


def test_fence_recheck_under_lock():
    from kubernetes_tpu_torch.scheduler import BatchResult

    pair = pair_of(build(2, n_pods=4))
    rf, pf = pair.flights()
    for s, _ in pair.sides():
        s._conflict_seq += 1
    res = BatchResult()
    assert pair.port._apply_group(pf, res, [], fence=pf.prep.fence) is False
    assert not res.scheduled
    assert len(pair.port.queue) == 0  # still held in _in_flight
    _, r2 = pair.apply(rf, pf)
    assert not r2.scheduled and len(pair.port.queue) == 4
    finish(pair)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_discard_skips_externally_bound_and_deleted_pods():
    pair = pair_of(build(2, n_pods=4))
    rf, pf = pair.flights()
    pair.bind("default", "p0000", "n001")
    pair.delete_pod("default", "p0001")
    _, res = pair.apply(rf, pf)
    assert not res.scheduled
    assert sorted(pair.port.queue._info) == ["default/p0002", "default/p0003"]
    finish(pair)
    placed = {p.name for p in pair.cluster.list_pods() if p.node_name}
    assert placed == {"p0000", "p0002", "p0003"}


def test_discard_storm_backstop_makes_progress():
    """A capacity-growing node update in every dispatch→apply window
    discards every fenced solve; the livelock backstop lands the batches
    through one synchronous cycle."""
    pair = pair_of(build(2, n_pods=12), batch=4)
    f0 = port_metrics.pipeline_fallback_total._value.get()
    for (s, cs), make in zip(pair.sides(), (MakeNode, PMakeNode)):
        real = s._dispatch_group
        cpu = [16]

        def churny(prep, defer, allow_heal=True, real=real, cs=cs, make=make, cpu=cpu):
            flight = real(prep, defer, allow_heal)
            settle_flight(flight)
            cpu[0] += 1
            node = cs.get_node("n000")
            grown = (
                make().name("n000")
                .capacity({"cpu": str(cpu[0]), "memory": "32Gi", "pods": "110"})
                .label(HOST, "n000").obj()
            )
            grown.resource_version = node.resource_version
            cs.update_node(grown)
            return flight

        s._dispatch_group = churny
    _, port = pair.run("pipelined", max_batches=200)
    pair.assert_equal()
    assert sum(len(r.scheduled) for r in port) == 12
    assert all(p.node_name for p in pair.cluster.list_pods())
    assert port_metrics.pipeline_fallback_total._value.get() > f0


def test_apply_exception_marks_session_stale_and_heals():
    from kubernetes_tpu.solver.exact import DeferredAssignments as RefDeferred
    from kubernetes_tpu_torch.solver.session import DeferredAssignments

    pair = pair_of(build(2, n_pods=6))
    rf, pf = pair.flights()
    for f, base in ((rf, RefDeferred), (pf, DeferredAssignments)):
        class Boom(base):
            def __init__(self):  # no device handle; the read itself dies
                pass

            def get(self):
                raise RuntimeError("device read failed")

        f.handle = Boom()
    read0 = port_metrics.batch_failure_total.labels("read")._value.get()
    _, res = pair.apply(rf, pf)
    s = pair.port
    assert not res.scheduled
    assert s._session_stale
    assert len(s.queue) == 6
    assert not s._in_flight
    assert port_metrics.batch_failure_total.labels("read")._value.get() == read0 + 1
    assert s.resilience.should_sync()
    finish(pair)
    assert all(p.node_name for p in pair.cluster.list_pods())
    assert not s._session_stale
    assert not s.resilience.should_sync()


def test_requeue_popped_uncharges_attempt():
    pair = pair_of(build(1, n_pods=1))
    for s, _ in pair.sides():
        with s.cluster.lock:
            infos = s.queue.pop_batch(8)
        assert infos[0].attempts == 1
        s.queue.requeue_popped(infos[0])
        assert len(s.queue) == 1
        with s.cluster.lock:
            again = s.queue.pop_batch(8)
        assert again[0].attempts == 1


# -- tests/test_pipelined_shapes.py ----------------------------------------


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


def shaped(kind, n_pods, n_nodes=6, batch=16, group=8, split=0, **cfg):
    cs = mk_cluster(n_nodes)
    for i in range(n_pods):
        cs.create_pod(shape_pod(i, kind))
    return Pair(cs, solver=solver(group), batch_size=batch, pipeline_split=split, **cfg)


def modes():
    return {
        m: port_metrics.pipeline_mode_total.labels(m)._value.get()
        for m in ("overlap", "carry", "sync")
    }


@pytest.mark.parametrize("kind", ["ports", "spread", "anti"])
def test_hard_shapes_take_carry_mode_not_sync(kind):
    pair = shaped(kind, 20, split=2)
    before = modes()
    sub0 = port_metrics.pipeline_subbatches_total._value.get()
    _, port = pair.run("pipelined")
    pair.assert_equal()
    after = modes()
    assert after["carry"] > before["carry"]
    assert after["sync"] == before["sync"]
    assert after["overlap"] == before["overlap"]
    assert port_metrics.pipeline_subbatches_total._value.get() > sub0
    assert sum(len(r.scheduled) + len(r.unschedulable) for r in port) >= 20
    assert sum(len(r.scheduled) for r in port) > 0


def test_plain_batches_still_overlap():
    pair = shaped("plain", 20)
    before = modes()
    finish(pair, "pipelined")
    after = modes()
    assert after["overlap"] > before["overlap"]
    assert after["carry"] == before["carry"]


def _equivalence(kind, n_pods=30, split=0, n_nodes=6):
    sync = shaped(kind, n_pods, n_nodes)
    sync.run("settled")
    pair = shaped(kind, n_pods, n_nodes, split=split)
    finish(pair, "pipelined")
    assert bindings(pair.cluster) == bindings(sync.cluster), kind
    return pair.cluster


def test_ports_pipelined_matches_sync():
    cs = _equivalence("ports", split=2)
    seen = set()
    for p in cs.list_pods():
        if p.node_name:
            for port in p.host_ports():
                assert (p.node_name, port) not in seen
                seen.add((p.node_name, port))


def test_spread_pipelined_matches_sync():
    from collections import Counter

    cs = _equivalence("spread", split=2)
    node_zone = {n.name: n.labels[ZONE] for n in cs.list_nodes()}
    zones = Counter(node_zone[p.node_name] for p in cs.list_pods() if p.node_name)
    assert max(zones.values()) - min(zones.values()) <= 1


def test_interpod_pipelined_matches_sync():
    cs = _equivalence("anti", n_pods=6, split=2)
    nodes = [p.node_name for p in cs.list_pods() if p.node_name]
    assert len(set(nodes)) == len(nodes)


@pytest.mark.parametrize("kind", ["plain", "spread"])
def test_split_chain_matches_unsplit(kind):
    one = shaped(kind, 32, split=1)
    one.run("pipelined")
    four = shaped(kind, 32, split=4)
    sub0 = port_metrics.pipeline_subbatches_total._value.get()
    finish(four, "pipelined")
    assert bindings(one.cluster) == bindings(four.cluster)
    assert port_metrics.pipeline_subbatches_total._value.get() > sub0


def two_profiles(group=4):
    from kubernetes_tpu.solver.exact import ExactSolverConfig as RefCfg
    from kubernetes_tpu_torch.solver.exact import ExactSolverConfig

    port = {n: ExactSolverConfig(**solver(group)) for n in ("default-scheduler", "alt")}
    ref = {n: RefCfg(**solver(group)) for n in ("default-scheduler", "alt")}
    return port, ref


def test_multi_profile_pipelined_matches_sync():
    def mk():
        cs = mk_cluster(4)
        for i in range(6):
            cs.create_pod(MakePod().name(f"a{i}").req({"cpu": "500m"}).obj())
            cs.create_pod(MakePod().name(f"b{i}").scheduler_name("alt").req({"cpu": "500m"}).obj())
        port, ref = two_profiles()
        return Pair(cs, solver=solver(4), batch_size=8, profiles=port,
                    ref_config={"profiles": ref})

    sync = mk()
    sync.run("settled")
    pair = mk()
    before = modes()
    finish(pair, "pipelined")
    assert bindings(pair.cluster) == bindings(sync.cluster)
    assert modes()["carry"] > before["carry"]


def test_multi_profile_cross_profile_batches_do_not_overcommit():
    def mk():
        cs = ClusterState()
        for i in range(2):
            cs.create_node(
                MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "110"})
                .label(HOST, f"n{i}").obj()
            )
        for i in range(8):
            cs.create_pod(MakePod().name(f"x{i}").req({"cpu": "1"}).obj())
        for i in range(8):
            cs.create_pod(MakePod().name(f"y{i}").scheduler_name("alt").req({"cpu": "1"}).obj())
        port, ref = two_profiles()
        return Pair(cs, solver=solver(4), batch_size=8, profiles=port,
                    ref_config={"profiles": ref})

    sync = mk()
    sync.run("settled")
    pair = mk()
    finish(pair, "pipelined")
    assert bindings(pair.cluster) == bindings(sync.cluster)
    per_node = {}
    for p in pair.cluster.list_pods():
        assert p.node_name
        per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    assert all(v <= 8 for v in per_node.values())


def test_out_of_tree_filter_pipelines_as_prefold():
    from kubernetes_tpu.framework.interface import FilterPlugin as RefFilter
    from kubernetes_tpu.framework.interface import Status as RefStatus
    from kubernetes_tpu_torch.framework.interface import FilterPlugin, Status

    def veto(base, status):
        class VetoN0(base):
            def name(self):
                return "veto-n0"

            def filter(self, state, pod, node, placed=()):
                return status.unschedulable("no n0") if node.name == "n0" else status.success()

        return VetoN0()

    def mk():
        cs = mk_cluster(4)
        for i in range(12):
            cs.create_pod(MakePod().name(f"p{i:02}").req({"cpu": "500m"}).obj())
        return Pair(cs, solver=solver(4), batch_size=8,
                    out_of_tree_plugins=(veto(FilterPlugin, Status),),
                    ref_config={"out_of_tree_plugins": (veto(RefFilter, RefStatus),)})

    sync = mk()
    sync.run("settled")
    pair = mk()
    before = modes()
    finish(pair, "pipelined")
    assert bindings(pair.cluster) == bindings(sync.cluster)
    assert modes()["overlap"] > before["overlap"]
    assert not any(p.node_name == "n0" for p in pair.cluster.list_pods())


def discards(pair, rf, pf, discarded=True):
    d0 = port_metrics.solves_discarded_total._value.get()
    _, res = pair.apply(rf, pf)
    n = port_metrics.solves_discarded_total._value.get() - d0
    if discarded:
        assert n == 1 and not res.scheduled
    else:
        assert n == 0
    return res


def test_ports_flight_discards_on_assigned_pod_delete():
    cs = mk_cluster(2)
    cs.create_pod(MakePod().name("old").req({"cpu": "1"}).host_port(8000).obj())
    cs.bind("default", "old", "n0")
    for i in range(2):
        cs.create_pod(shape_pod(i * 3, "ports"))  # both want port 8000
    pair = Pair(cs, solver=solver(8), batch_size=4)
    rf, pf = pair.flights(fold=True)
    assert pf.prep.occ_sensitive
    pair.delete_pod("default", "old")
    discards(pair, rf, pf)
    finish(pair)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_spread_flight_discards_on_assigned_pod_label_change():
    cs = mk_cluster()
    cs.create_pod(MakePod().name("old").label("app", "spread").req({"cpu": "1"}).obj())
    cs.bind("default", "old", "n0")
    for i in range(4):
        cs.create_pod(shape_pod(i, "spread"))
    pair = Pair(cs, solver=solver(8), batch_size=16)
    rf, pf = pair.flights(fold=True)
    assert pf.prep.occ_sensitive
    pair.relabel_pod("default", "old", {"app": "other"})
    discards(pair, rf, pf)
    finish(pair)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_interpod_flight_discards_on_assigned_pod_delete():
    cs = mk_cluster()
    cs.create_pod(MakePod().name("old").label("app", "anti").req({"cpu": "1"}).obj())
    cs.bind("default", "old", "n0")
    for i in range(3):
        cs.create_pod(shape_pod(i, "anti"))
    pair = Pair(cs, solver=solver(8), batch_size=16)
    rf, pf = pair.flights(fold=True)
    assert pf.prep.occ_sensitive
    pair.delete_pod("default", "old")
    discards(pair, rf, pf)
    finish(pair)
    nodes = [p.node_name for p in pair.cluster.list_pods() if p.node_name]
    assert len(set(nodes)) == len(nodes)


def test_dra_flight_discards_on_external_claim_write():
    from kubernetes_tpu.api.dra import Device, DeviceClass, DeviceRequest, ResourceClaim, ResourceSlice
    from kubernetes_tpu.utils.featuregate import FeatureGates as RefGates
    from kubernetes_tpu_torch.utils.featuregate import FeatureGates

    cs = ClusterState()
    for i in range(2):
        cs.create_node(MakeNode().name(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "20"}).obj())
        cs.create_resource_slice(
            ResourceSlice(name=f"slice-n{i}", node_name=f"n{i}", driver="gpu.example.com",
                          devices=(Device(name="gpu-0"),))
        )
    cs.create_device_class(DeviceClass(name="gpu", driver="gpu.example.com"))
    for name in ("c0", "other"):
        cs.create_resource_claim(
            ResourceClaim(name=name, namespace="default",
                          requests=(DeviceRequest(name="r0", device_class_name="gpu"),))
        )
    gate = "DynamicResourceAllocation=true"
    pair = Pair(cs, solver=solver(1), batch_size=4, feature_gates=FeatureGates.parse(gate),
                ref_config={"feature_gates": RefGates.parse(gate)})
    pair.create_pod(MakePod().name("p0").req({"cpu": "1"}).resource_claim("c0").obj())
    rf, pf = pair.flights(fold=True)
    assert pf.prep.occ_sensitive
    for c in (pair.ref_cluster, pair.cluster):  # an external claim write
        c.update_resource_claim(c.get_resource_claim("default", "other"))
    discards(pair, rf, pf)
    finish(pair)
    assert pair.cluster.get_pod("default", "p0").node_name


def test_plain_flight_survives_occupancy_events():
    cs = mk_cluster(2)
    cs.create_pod(MakePod().name("old").label("app", "x").req({"cpu": "1"}).obj())
    cs.bind("default", "old", "n0")
    for i in range(3):
        cs.create_pod(shape_pod(i, "plain"))
    pair = Pair(cs, solver=solver(8), batch_size=4)
    rf, pf = pair.flights(fold=True)
    assert not pf.prep.occ_sensitive
    pair.relabel_pod("default", "old", {"app": "y"})
    pair.delete_pod("default", "old")
    res = discards(pair, rf, pf, discarded=False)
    assert len(res.scheduled) == 3
    pair.assert_equal()


def test_mid_chain_occupancy_event_discards_remaining_subflights():
    cs = mk_cluster()
    cs.create_pod(MakePod().name("old").label("app", "spread").req({"cpu": "1"}).obj())
    cs.bind("default", "old", "n0")
    for i in range(16):
        cs.create_pod(shape_pod(i, "spread"))
    pair = Pair(cs, solver=solver(8), batch_size=16, pipeline_split=4)
    rfs, pfs = pair.flights(split=4)
    assert isinstance(pfs, list) and len(pfs) >= 2 and len(pfs) == len(rfs)
    _, r0 = pair.apply(rfs[0], pfs[0])
    assert r0.scheduled
    pair.delete_pod("default", "old")
    d0 = port_metrics.solves_discarded_total._value.get()
    for rf, pf in zip(rfs[1:], pfs[1:]):
        pair.apply(rf, pf)
    assert port_metrics.solves_discarded_total._value.get() - d0 == len(pfs) - 1
    finish(pair)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_stale_flight_discarded_after_assigned_pod_delete():
    """The fence at the loop level: while run_pipelined holds a carry-mode
    flight, an assigned pod of its shape is deleted; the flight discards
    and its pods bind on the retry, equal to the JAX package."""
    cs = mk_cluster()
    cs.create_pod(MakePod().name("old").label("app", "anti").req({"cpu": "1"}).obj())
    cs.bind("default", "old", "n0")
    for i in range(6):
        cs.create_pod(shape_pod(i, "anti"))
    pair = Pair(cs, solver=solver(8), batch_size=4)
    fired = []
    for s, c in pair.sides():
        def hook(flight, c=c, s=s):
            if not fired.count(s):
                fired.append(s)
                settle_flight(flight)
                c.delete_pod("default", "old")

        s._post_dispatch_hook = hook
    d0 = port_metrics.solves_discarded_total._value.get()
    finish(pair, "pipelined")
    assert port_metrics.solves_discarded_total._value.get() - d0 >= 1
    nodes = [p.node_name for p in pair.cluster.list_pods() if p.node_name]
    assert len(nodes) == 6 and len(set(nodes)) == 6


def test_reacquire_fence_discards_in_flight_solve():
    """Re-acquiring the commit fence forces a resync: both fences bump, so
    a flight dispatched before it is discarded, and its pods bind on the
    retry under the new token."""
    pair = pair_of(build(2, n_pods=4), fence_role="sched")
    rf, pf = pair.flights()
    seqs = [(s._conflict_seq, s._occupancy_seq) for s, _ in pair.sides()]
    for s, _ in pair.sides():
        s.reacquire_fence()
    assert [(s._conflict_seq, s._occupancy_seq) for s, _ in pair.sides()] == [
        (c + 1, o + 1) for c, o in seqs
    ]
    d0 = port_metrics.solves_discarded_total._value.get()
    _, res = pair.apply(rf, pf)
    assert not res.scheduled
    assert port_metrics.solves_discarded_total._value.get() == d0 + 1
    finish(pair)
    assert all(p.node_name for p in pair.cluster.list_pods())


def test_expired_assume_cleanup_bumps_both_fences():
    """An assumed pod whose bind confirmation never arrives expires at the
    next pop: its occupancy is released, so in-flight solves that counted
    it go stale (both fences bump) and the pod re-enters the queue."""
    pair = pair_of(build(2, n_pods=1))
    for s, cs in pair.sides():
        pod = cs.get_pod("default", "p0000")
        with cs.lock:
            s.queue.pop_batch(1)
            s.cache.assume_pod(pod, "n000")
            s.cache.finish_binding(pod.key)
    pair.advance(60.0)  # past the 30 s assume TTL
    seqs = []
    for s, cs in pair.sides():
        before = (s._conflict_seq, s._occupancy_seq)
        with cs.lock:
            s._reap_expired_assumes()
        seqs.append(((s._conflict_seq, s._occupancy_seq), before, len(s.queue)))
    assert seqs[0] == seqs[1]
    (after, before, queued) = seqs[1]
    assert after == (before[0] + 1, before[1] + 1) and queued == 1
    finish(pair)
    assert pair.cluster.get_pod("default", "p0000").node_name
